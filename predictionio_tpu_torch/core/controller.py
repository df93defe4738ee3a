"""DASE controller API — DataSource, Preparator, Algorithm, Serving.

Counterpart of ``predictionio_tpu/core/controller.py``. Queries and
predictions travel as JSON-like dicts; the :class:`ComputeContext`
parameter sits where the reference passes its Spark context.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Any, Generic, Sequence, TypeVar

from predictionio_tpu_torch.parallel.mesh import ComputeContext

TD = TypeVar("TD")  # training data
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")    # model
Q = TypeVar("Q")    # query
P = TypeVar("P")    # prediction
A = TypeVar("A")    # actual
EI = TypeVar("EI")  # evaluation info


class Params:
    """Marker base for controller params; subclasses are dataclasses."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


class ParamsError(ValueError):
    pass


def params_from_json(cls: type, data: dict[str, Any] | None) -> Params:
    """JSON dict → params dataclass. Unknown keys are rejected; missing
    keys fall back to field defaults; missing non-default keys raise."""
    data = dict(data or {})
    if not dataclasses.is_dataclass(cls):
        if data:
            raise ParamsError(
                f"{cls.__name__} takes no params but got {sorted(data)}"
            )
        return cls()
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ParamsError(
            f"unknown params for {cls.__name__}: {sorted(unknown)} "
            f"(accepted: {sorted(names)})"
        )
    try:
        return cls(**data)
    except TypeError as e:
        raise ParamsError(f"bad params for {cls.__name__}: {e}") from e


def params_to_json(params: Params) -> dict[str, Any]:
    if dataclasses.is_dataclass(params):
        return dataclasses.asdict(params)
    return {}


class SanityCheck(abc.ABC):
    """Data objects may self-validate after each pipeline stage."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...


class _Controller:
    """Shared constructor protocol: ``cls(params)``."""

    params_class: type = EmptyParams

    def __init__(self, params: Params | None = None):
        if params is None or (
            type(params) is EmptyParams
            and self.params_class is not EmptyParams
        ):
            # an EmptyParams placeholder means "use the declared defaults"
            params = self.params_class()
        self.params = params


class DataSource(_Controller, Generic[TD, EI, Q, A], abc.ABC):
    """Reads training / evaluation data from the event store."""

    @abc.abstractmethod
    def read_training(self, ctx: ComputeContext) -> TD: ...

    def read_eval(
        self, ctx: ComputeContext
    ) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
        """k evaluation folds, ``(trainingData, evalInfo, [(query,
        actual)])``, for ``Engine.eval``; a data source that does not
        override this cannot be evaluated."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unsupported for this data source."
        )


class Preparator(_Controller, Generic[TD, PD], abc.ABC):
    @abc.abstractmethod
    def prepare(self, ctx: ComputeContext, training_data: TD) -> PD: ...


class IdentityPreparator(Preparator[TD, TD]):
    """Pass the training data through unchanged."""

    def prepare(self, ctx: ComputeContext, training_data: TD) -> TD:
        return training_data


class PersistenceMode(enum.Enum):
    """AUTO: the framework pickles the host form of the model into the
    model store. MANUAL: the algorithm saves and loads itself. RETRAIN:
    not persisted; deploy re-trains."""

    AUTO = "auto"
    MANUAL = "manual"
    RETRAIN = "retrain"


class Algorithm(_Controller, Generic[PD, M, Q, P], abc.ABC):
    """Train on prepared data; answer queries."""

    persistence_mode: PersistenceMode = PersistenceMode.AUTO
    #: optional StepTimer injected by the workflow runtime
    timer = None

    @abc.abstractmethod
    def train(self, ctx: ComputeContext, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M, queries: Sequence[Q]) -> list[P]:
        """Bulk predict. Default loops; algorithms override."""
        return [self.predict(model, q) for q in queries]

    # -- two-phase serving hooks (pipelined micro-batching) --------------
    def batch_predict_launch(self, model: M, queries: Sequence[Q]) -> Any:
        """Enqueue the device work for ``queries`` and return an opaque
        handle WITHOUT waiting for the card (kernels launch on the
        current stream and return at once). Pairs with
        :meth:`batch_predict_collect`; the micro-batcher uses the pair
        to enqueue batch N+1 while batch N is still being collected."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement two-phase predict"
        )

    def batch_predict_collect(
        self, model: M, handle: Any, queries: Sequence[Q]
    ) -> list[P]:
        """Wait for a :meth:`batch_predict_launch` handle's results and
        materialize one prediction per query, in order."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement two-phase predict"
        )

    def stage_model(self, ctx: ComputeContext, model: M) -> M:
        """Deploy-time hook: place model state on ``ctx.device`` ONCE so
        serving never re-uploads it per request. Default: identity."""
        return model

    # -- persistence hooks (MANUAL mode) ---------------------------------
    def save_model(self, instance_id: str, model: M) -> None:
        raise NotImplementedError(
            f"{type(self).__name__}.save_model required for MANUAL persistence"
        )

    def load_model(self, instance_id: str, ctx: ComputeContext) -> M:
        raise NotImplementedError(
            f"{type(self).__name__}.load_model required for MANUAL persistence"
        )

    def prepare_model_for_host(self, model: M) -> Any:
        """AUTO-mode hook: the host-serializable form of the model.
        Default: identity — persistence moves tensors to numpy itself."""
        return model


class Serving(_Controller, Generic[Q, P], abc.ABC):
    """Combine per-algorithm predictions."""

    def supplement(self, query: Q) -> Q:
        """Enrich the query before prediction."""
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...


class FirstServing(Serving[Q, P]):
    """First algorithm wins."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]


class AverageServing(Serving[Q, Any]):
    """Numeric mean of the algorithms' predictions."""

    def serve(self, query: Q, predictions: Sequence[Any]) -> Any:
        return sum(predictions) / len(predictions)
