"""HelloWorld template: the smallest engine.

Counterpart of ``predictionio_tpu/models/helloworld.py``. Training data
is (day, temperature) pairs, from "report" events on entity type "day"
carrying a ``temperature`` property or from a ``day,temperature`` CSV;
the model is the mean temperature per day, summed on the device in a
fixed order (no atomics); a query ``{"day": "Mon"}`` answers ``{"temperature":
<mean>}`` (``None`` for an unknown day).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
    register_engine,
)
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclasses.dataclass(frozen=True)
class HelloDataSourceParams(Params):
    app_name: str = ""       # "report" events of this app, or
    filepath: str = ""       # "day,temperature" CSV lines from a file
    event_name: str = "report"
    day_entity_type: str = "day"


@dataclasses.dataclass
class HelloTrainingData:
    days: np.ndarray          # [N] str
    temperatures: np.ndarray  # [N] float32


class HelloDataSource(DataSource):
    params_class = HelloDataSourceParams

    def read_training(self, ctx: ComputeContext) -> HelloTrainingData:
        p = self.params
        days, temps = [], []
        if p.filepath:
            with open(p.filepath) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    day, temp = line.split(",")
                    days.append(day.strip())
                    temps.append(float(temp))
        else:
            for event in EventStore().find(
                p.app_name,
                entity_type=p.day_entity_type,
                event_names=[p.event_name],
            ):
                days.append(event.entity_id)
                temps.append(float(event.properties.get("temperature")))
        if not days:
            raise ValueError("no temperature data found")
        return HelloTrainingData(
            days=np.asarray(days),
            temperatures=np.asarray(temps, np.float32),
        )


@dataclasses.dataclass
class HelloModel:
    day_map: BiMap
    means: np.ndarray  # [n_days] float32


def segment_mean(codes: torch.Tensor, values: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Mean of ``values`` per segment id in ``codes`` (``n`` segments; an
    empty one is 0) on the values' device. The layout is planned on the
    host: each segment's values, in input order, fill a row of an ``[n,
    m]`` matrix padded with zeros (``m`` the largest segment), and the
    rows are summed by one reduction of fixed shape, with no atomics, so
    the sums are the same each run."""
    host = codes.cpu().numpy().astype(np.int64)
    order = np.argsort(host, kind="stable")
    count = np.bincount(host, minlength=n)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    col = np.arange(len(host)) - start[host[order]]
    width = max(int(count.max()) if len(count) else 0, 1)
    slot = np.full(n * width, len(host), np.int64)  # the zero pad
    slot[host[order] * width + col] = order
    padded = torch.cat([values, values.new_zeros(1)]).index_select(
        0, torch.from_numpy(slot).to(values.device)).view(n, width)
    total = padded.sum(dim=1)
    cnt = torch.as_tensor(count, dtype=values.dtype, device=values.device)
    return total / torch.clamp(cnt, min=1.0)


class HelloAlgorithm(Algorithm):

    def train(self, ctx: ComputeContext, pd: HelloTrainingData) -> HelloModel:
        day_map, codes = BiMap.string_int_with_codes(pd.days)
        means = segment_mean(
            torch.as_tensor(codes.astype(np.int64), device=ctx.device),
            torch.as_tensor(pd.temperatures, device=ctx.device),
            len(day_map),
        )
        return HelloModel(day_map=day_map, means=means.cpu().numpy())

    def predict(self, model: HelloModel, query: dict) -> dict:
        idx = model.day_map.get(str(query.get("day", "")), None)
        if idx is None:
            return {"temperature": None}
        return {"temperature": float(model.means[idx])}


def helloworld_engine() -> Engine:
    return Engine(
        HelloDataSource,
        IdentityPreparator,
        {"hello": HelloAlgorithm},
        FirstServing,
    )


register_engine("helloworld", helloworld_engine)
