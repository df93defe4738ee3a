"""MANUAL persistence in the port, mirroring ``tests/test_persistent_model.py``.

The port's array state is its own (``state/arrays.npz``; the JAX package
writes orbax), so the packages do not share MANUAL model files: these
tests hold the port to the JAX package's behaviour, not its files.

* Round trips of dataclass, dict and bare-array models, overwrite, and
  tensor fields (they come back as tensors of their dtype, bf16
  included, on the device the loader names).
* The directory layout, ``$PIO_FS_BASEDIR/pmodels/<AlgoClass>/<id>/``,
  the same in both packages, and the full train → persist → deploy
  cycle through the mixin with no retrain.
* Every damaged-directory shape raises the same typed error the JAX
  package raises, and the skeleton names only allowed classes.
* The same model saved by each package loads back equal in each.
"""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from predictionio_tpu.core import persistent_model as jpm
from predictionio_tpu_torch.core import Engine, EngineParams
from predictionio_tpu_torch.core.controller import (
    Algorithm,
    DataSource,
    IdentityPreparator,
    Params,
    PersistenceMode,
    Serving,
)
from predictionio_tpu_torch.core.persistent_model import (
    LocalFileSystemPersistentModel,
    PersistentModelError,
    PersistentModelMissing,
    load_persistent_model,
    save_persistent_model,
)
from predictionio_tpu_torch.core.workflow import load_deployment, run_train
from predictionio_tpu_torch.data.storage import Storage, set_storage
from predictionio_tpu_torch.parallel.mesh import ComputeContext


@dataclasses.dataclass
class ToyModel:
    weights: np.ndarray
    bias: np.ndarray
    vocab: list
    scale: float


def _toy(value=1.0):
    return ToyModel(weights=np.full((2, 2), value, np.float32),
                    bias=np.zeros(2, np.float32), vocab=["v"], scale=1.0)


class TestSplitRoundTrip:
    def test_dataclass_model(self, tmp_path):
        model = ToyModel(
            weights=np.arange(12, dtype=np.float32).reshape(3, 4),
            bias=np.ones(4, np.float32), vocab=["a", "b"], scale=2.5)
        d = str(tmp_path / "m1")
        save_persistent_model(d, model)
        out = load_persistent_model(d, classes=(ToyModel,))
        np.testing.assert_array_equal(out.weights, model.weights)
        np.testing.assert_array_equal(out.bias, model.bias)
        assert (out.vocab, out.scale) == (["a", "b"], 2.5)

    def test_dict_model(self, tmp_path):
        model = {"w": np.zeros((2, 2), np.float32), "names": ("x", "y")}
        d = str(tmp_path / "m2")
        save_persistent_model(d, model)
        out = load_persistent_model(d)
        np.testing.assert_array_equal(out["w"], model["w"])
        assert out["names"] == ("x", "y")

    def test_bare_array_model(self, tmp_path):
        arr = np.linspace(0, 1, 7, dtype=np.float32)
        d = str(tmp_path / "m3")
        save_persistent_model(d, arr)
        np.testing.assert_array_equal(load_persistent_model(d), arr)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int32])
    def test_tensor_fields_come_back_as_tensors(self, tmp_path, dtype):
        t = (torch.arange(24, dtype=torch.float32).reshape(4, 6) / 3).to(dtype)
        d = str(tmp_path / "m4")
        save_persistent_model(d, {"factors": t, "host": np.ones(3),
                                  "n": 4})
        out = load_persistent_model(d, device="cpu")
        assert isinstance(out["factors"], torch.Tensor)
        assert out["factors"].dtype == dtype
        assert torch.equal(out["factors"], t)
        assert isinstance(out["host"], np.ndarray) and out["n"] == 4

    def test_overwrite_replaces(self, tmp_path):
        d = str(tmp_path / "m5")
        save_persistent_model(d, {"w": np.zeros(2, np.float32)})
        save_persistent_model(d, {"w": np.ones(3, np.float32)})
        np.testing.assert_array_equal(load_persistent_model(d)["w"],
                                      np.ones(3))

    def test_missing_model_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_persistent_model(str(tmp_path / "nope"))

    def test_each_package_reads_its_own_save_alike(self, tmp_path):
        model = {"w": np.arange(6, dtype=np.float32), "tag": "x"}
        jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
        jpm.save_persistent_model(jd, model)
        save_persistent_model(pd, model)
        want, got = jpm.load_persistent_model(jd), load_persistent_model(pd)
        np.testing.assert_array_equal(got["w"], want["w"])
        assert got["tag"] == want["tag"]
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
            "aux.pkl", "state"]


# -- the mixin, end to end --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdParams(Params):
    id: int = 0


class ManualDataSource(DataSource):
    params_class = IdParams

    def read_training(self, ctx):
        return self.params.id


class ManualAlgorithm(LocalFileSystemPersistentModel, Algorithm):
    params_class = IdParams
    train_calls = 0

    def train(self, ctx, pd):
        type(self).train_calls += 1
        return ToyModel(weights=torch.full((2, 2), float(pd),
                                           device=ctx.device).numpy(),
                        bias=np.zeros(2, np.float32), vocab=["v"], scale=1.0)

    def predict(self, model, query):
        return float(model.weights[0, 0]) + query


class TensorAlgorithm(ManualAlgorithm):
    def train(self, ctx, pd):
        type(self).train_calls += 1
        return {"factors": torch.full((3, 2), float(pd), device=ctx.device)}

    def predict(self, model, query):
        return float(model["factors"][0, 0]) + query


class PassServing(Serving):
    def serve(self, query, predictions):
        return predictions[0]


@pytest.fixture()
def memory_port_storage():
    storage = Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    set_storage(storage)
    yield storage
    set_storage(None)


@pytest.mark.parametrize("algo_cls", [ManualAlgorithm, TensorAlgorithm])
def test_train_persist_deploy(algo_cls, memory_port_storage, tmp_path,
                              monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    ctx = ComputeContext.create(device="cpu")
    engine = Engine(ManualDataSource, IdentityPreparator, algo_cls,
                    PassServing)
    params = EngineParams(data_source=("", IdParams(id=7)),
                          algorithms=[("", IdParams(id=7))])
    assert algo_cls().persistence_mode is PersistenceMode.MANUAL
    algo_cls.train_calls = 0
    iid = run_train(engine, params, engine_id="manual-e", ctx=ctx,
                    storage=memory_port_storage)
    assert algo_cls.train_calls == 1
    # the JAX package's layout
    directory = tmp_path / "pmodels" / algo_cls.__name__ / iid
    assert (directory / "aux.pkl").is_file()
    assert jpm.LocalFileSystemPersistentModel.persistent_model_dir(
        algo_cls(), iid) == str(directory)
    _inst, algos, models, serving = load_deployment(
        engine, params, engine_id="manual-e", ctx=ctx,
        storage=memory_port_storage)
    assert algo_cls.train_calls == 1  # loaded, not retrained
    assert serving.serve(1, [algos[0].predict(models[0], 1)]) == 8.0
    if algo_cls is TensorAlgorithm:
        assert models[0]["factors"].device == ctx.device


# -- damaged directories ------------------------------------------------------------


class TestRestoreFailurePaths:
    def _save(self, tmp_path):
        d = str(tmp_path / "model")
        save_persistent_model(d, _toy())
        return d

    def test_missing_model_is_typed_and_filenotfound(self, tmp_path):
        with pytest.raises(PersistentModelMissing):
            load_persistent_model(str(tmp_path / "never-saved"))
        assert issubclass(PersistentModelMissing, FileNotFoundError)
        assert issubclass(PersistentModelMissing, PersistentModelError)

    def test_missing_state_dir_raises_typed(self, tmp_path):
        d = self._save(tmp_path)
        shutil.rmtree(f"{d}/state")
        with pytest.raises(PersistentModelError, match="partial"):
            load_persistent_model(d, classes=(ToyModel,))

    def test_garbage_state_raises_typed(self, tmp_path):
        d = self._save(tmp_path)
        shutil.rmtree(f"{d}/state")
        os.makedirs(f"{d}/state")
        with open(f"{d}/state/not-a-checkpoint", "w") as f:
            f.write("garbage")
        with pytest.raises(PersistentModelError, match="unreadable"):
            load_persistent_model(d, classes=(ToyModel,))

    def test_truncated_arrays_raise_typed(self, tmp_path):
        d = self._save(tmp_path)
        path = f"{d}/state/arrays.npz"
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        with pytest.raises(PersistentModelError):
            load_persistent_model(d, classes=(ToyModel,))

    def test_corrupt_aux_pickle_raises_typed(self, tmp_path):
        d = self._save(tmp_path)
        with open(f"{d}/aux.pkl", "wb") as f:
            f.write(b"\x80\x05corrupt")
        with pytest.raises(PersistentModelError, match="unreadable"):
            load_persistent_model(d, classes=(ToyModel,))

    def test_state_missing_declared_key_raises_typed(self, tmp_path):
        d = self._save(tmp_path)
        with open(f"{d}/aux.pkl", "rb") as f:
            aux = pickle.load(f)
        aux["array_keys"] = aux["array_keys"] + ["phantom_field"]
        with open(f"{d}/aux.pkl", "wb") as f:
            pickle.dump(aux, f)
        with pytest.raises(PersistentModelError, match="phantom_field"):
            load_persistent_model(d, classes=(ToyModel,))

    def test_unknown_tensor_dtype_raises_typed(self, tmp_path):
        d = str(tmp_path / "t")
        save_persistent_model(d, {"factors": torch.ones(2, 2)})
        with open(f"{d}/aux.pkl", "rb") as f:
            aux = pickle.load(f)
        aux["tensors"]["factors"] = "manual_seed"
        with open(f"{d}/aux.pkl", "wb") as f:
            pickle.dump(aux, f)
        with pytest.raises(PersistentModelError, match="dtype"):
            load_persistent_model(d)

    def test_skeleton_names_only_allowed_classes(self, tmp_path):
        """A skeleton naming a class the caller did not allow is refused,
        as a damaged one."""
        d = self._save(tmp_path)
        with pytest.raises(PersistentModelError, match="not an allowed"):
            load_persistent_model(d)
