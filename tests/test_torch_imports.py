"""The port stands alone, and on the CPU takes only plain versions.

* Every module of ``predictionio_tpu_torch`` imports in a process where
  ``jax`` and the package ``predictionio_tpu`` (but not
  ``predictionio_tpu_torch``, which shares its prefix) cannot be
  imported, and no port source (nor ``chip_smoke.py``) imports either.
* the fleet's modules (the router, the autoscaler, federation, the
  workers module) import where ``torch`` cannot be imported either, and
  so does ``cli.main router --help``: a router process never pays the
  torch import, and the replicas own the card;
* ``ComputeContext.create()`` raises without CUDA instead of dropping to
  the CPU; ``device="cpu"`` is the explicit opt-in. The continuous
  trainer takes the same context and raises the same way.
* A CPU tensor takes the plain version and never builds or launches the
  kernel; a tensor on any other non-CUDA device is refused.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import predictionio_tpu_torch
import predictionio_tpu_torch.version
from predictionio_tpu_torch.ops import _build, fused_topk
from predictionio_tpu_torch.parallel.mesh import ComputeContext

PKG = pathlib.Path(predictionio_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


_BLOCKER = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "predictionio_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu"):
        del sys.modules[name]
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(
    m.split(".")[0] in ("jax", "predictionio_tpu") for m in sys.modules
)
print("imported", len(sys.argv) - 1)
"""


def test_every_module_imports_with_jax_and_reference_blocked():
    mods = _modules()
    for mod in ("serving.engine_server", "core.evaluation", "core.fasteval",
                "core.crossvalidation", "data.aggregation", "data.view",
                "utils.npzio", "models.similarproduct", "models.ecommerce",
                "models.complementarypurchase", "models.classification",
                "models.textclassification", "models.helloworld",
                "models.regression", "models.leadscoring",
                "ops.naive_bayes", "ops.markov", "ops.vectorizer",
                "core.persistent_model", "obs", "obs.context",
                "obs.registry", "obs.tracing", "obs.timeline",
                "obs.device", "training", "training.trainer", "version",
                "cli", "cli.main", "cli.commands", "cli.daemon",
                "data.eventfile", "serving.config", "serving.workers",
                "serving.dashboard", "serving.admin",
                "serving.admission", "serving.resilience", "obs.slo",
                "serving.querycache", "serving.canary",
                "serving.batching", "serving.http",
                "serving.modelpool", "serving.plugins",
                "serving.event_server", "serving.router",
                "serving.autoscaler", "obs.federation",
                "data.storage.pgwire", "data.storage.postgres",
                "data.storage.minipg", "data.storage.mywire",
                "data.storage.mysql", "data.storage.minimysql",
                "data.storage.httpstore", "serving.store_server",
                "client", "parallel", "parallel.mesh",
                "parallel.partition", "parallel.distributed"):
        assert f"predictionio_tpu_torch.{mod}" in mods
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *mods],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(mods)}" in out.stdout


_CONSOLE = _BLOCKER.split("import importlib\nfor mod")[0] + r"""
import runpy
sys.argv = ["pio-tpu-torch"] + sys.argv[1:]
try:
    runpy.run_module("predictionio_tpu_torch.cli.main", run_name="__main__")
finally:
    assert not any(
        m.split(".")[0] in ("jax", "predictionio_tpu") for m in sys.modules
    )
"""


@pytest.mark.parametrize("argv, rc, out", [
    (["version"], 0, predictionio_tpu_torch.version.__version__ + "\n"),
    (["app", "list"], 0, ""),
])
def test_console_runs_with_jax_and_reference_blocked(tmp_path, argv, rc,
                                                     out):
    """``python -m predictionio_tpu_torch.cli.main`` in a process where
    neither ``jax`` nor ``predictionio_tpu`` can be imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PIO_FS_BASEDIR=str(tmp_path))
    for k in list(env):
        if k.startswith("PIO_STORAGE_"):
            del env[k]
    got = subprocess.run(
        [sys.executable, "-c", _CONSOLE, *argv],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path,
    )
    assert got.returncode == rc, got.stderr[-3000:]
    assert got.stdout == out


_NO_TORCH = _BLOCKER.replace('("jax", "jaxlib", "predictionio_tpu")',
                             '("jax", "jaxlib", "predictionio_tpu", "torch")')


@pytest.mark.parametrize("argv", [
    ["-c", "import importlib; [importlib.import_module(m) for m in ("
     "'predictionio_tpu_torch.serving.router', "
     "'predictionio_tpu_torch.serving.autoscaler', "
     "'predictionio_tpu_torch.obs.federation', "
     "'predictionio_tpu_torch.serving.workers')]"],
    ["-m", "predictionio_tpu_torch.cli.main", "router", "--help"],
])
def test_fleet_runs_with_torch_blocked(tmp_path, argv):
    """The router, the autoscaler, federation and the workers module,
    and the console's ``router --help``, in a process where ``torch``
    (and ``jax`` and ``predictionio_tpu``) cannot be imported."""
    assert '"torch")' in _NO_TORCH
    prelude = _NO_TORCH.split("import importlib\nfor mod")[0]
    if argv[0] == "-c":
        code = prelude + argv[1] + "\nprint('imported')"
    else:
        code = prelude + (
            "import runpy\nsys.argv = ['pio-tpu-torch'] + "
            f"{argv[2:]!r}\n"
            "runpy.run_module('predictionio_tpu_torch.cli.main', "
            "run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(ROOT), PIO_FS_BASEDIR=str(tmp_path))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    if argv[0] == "-c":
        assert got.stdout == "imported\n"
    else:
        assert "--spawn-replica" in got.stdout
        assert "--fleet-gate" in got.stdout

def test_no_source_names_jax_or_the_reference_package():
    bad = re.compile(
        r"^\s*(import\s+jax|from\s+jax\b)|predictionio_tpu\.", re.M
    )
    sources = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        str(p) for p in sources if bad.search(p.read_text())
    ]
    assert offenders == []


def test_compute_context_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputeContext.create()
    ctx = ComputeContext.create(device="cpu")
    assert ctx.device == torch.device("cpu")
    assert (ctx.n_devices, ctx.model_parallelism) == (1, 1)
    assert ctx.shard_rows([[1.0], [2.0]]).shape == (2, 1)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU path must never build the kernel")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    q = torch.randn(3, 8)
    items = torch.randn(100, 8)
    got = fused_topk.fused_top_k_dot(q, items, 5)
    want = fused_topk.fused_top_k_dot_reference(q, items, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.LAUNCHES == before


def test_new_routes_take_the_plain_version_on_cpu(monkeypatch):
    """The similar-product cosine and an evaluation-sized batch (B above
    the kernel's widest query tile) never build or launch on the CPU."""
    import numpy as np

    from predictionio_tpu_torch.ops import quantize, similarity

    def no_build(name):
        raise AssertionError("the CPU path must never build the kernel")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    items = torch.randn(300, 16)
    for table in (items, quantize.quantize_factors(items, "int8"),
                  quantize.quantize_factors(items, "bf16")):
        s, i = similarity.gather_mean_top_k_cosine(
            table, np.array([4, 9, -1, -1]), 12)
        assert s.shape == i.shape == (1, 12) and s.device.type == "cpu"
    users = torch.randn(200, 16)
    s, i = similarity.gather_top_k_dot(users, np.arange(200) % 150, items,
                                       16)
    assert s.shape == (200, 16)
    assert _build.LAUNCHES == before


def test_other_devices_are_refused():
    q = torch.empty(3, 8, device="meta")
    items = torch.empty(100, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_topk.fused_top_k_dot(q, items, 5)
    from predictionio_tpu_torch.ops import similarity

    with pytest.raises(ValueError, match="cuda or cpu"):
        similarity.gather_mean_top_k_cosine(items, [1, 2], 5)


@pytest.mark.parametrize("name", ["fused_topk", "alspack", "eventlog"])
def test_build_is_keyed_by_source_and_lazy(tmp_path, monkeypatch, name):
    """One loader for both kinds of source. A kernel (``csrc/*.cu``)
    keys its library under ``build/kernels/`` by a hash, types its entry
    points, and builds nothing on the CPU. A ``native/*.cc`` compiles
    into ``build/native/`` (the JAX package's loader owns ``native/``),
    once, with the compiler's report beside it and its functions typed;
    a failed build raises with the compiler's output and leaves no
    temporary file."""
    from predictionio_tpu_torch.ops import als

    path = _build.library_path(name)
    if name == "fused_topk":
        assert _build.source_path(name) == PKG / "csrc" / "fused_topk.cu"
        assert path.parent == ROOT / "build" / "kernels"
        assert path.name.startswith("libfused_topk_")
        assert path.suffix == ".so"
        assert name not in _build._loaded  # nothing built on the CPU
        for fn, (restype, argtypes) in _build.SIGNATURES[name].items():
            assert fn.startswith("pio_topk_pass")
            assert restype is _build.ctypes.c_int
            assert argtypes[-1] is _build.ctypes.c_void_p  # the stream
        return
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith(f"libpio_{name}_")
    assert _build.source_path(name) == ROOT / "native" / f"{name}.cc"
    monkeypatch.delenv("PIO_NO_NATIVE", raising=False)
    built = tmp_path / "build"
    monkeypatch.setattr(_build, "NATIVE_BUILD", built)
    monkeypatch.setattr(_build, "_loaded", {})
    outputs = []
    real_run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        outputs.append(pathlib.Path(cmd[cmd.index("-o") + 1]))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(_build.subprocess, "run", recording_run)
    lib = _build.library(name)
    for fn, (restype, argtypes) in _build.SIGNATURES[name].items():
        assert getattr(lib, fn).restype is restype
        assert list(getattr(lib, fn).argtypes) == argtypes
    assert outputs and all(p.parent == built for p in outputs)
    so = _build.library_path(name)
    assert sorted(p.name for p in built.iterdir()) == [
        so.with_suffix(".log").name, so.name]
    assert _build.library(name) is lib and len(outputs) == 1
    if name == "alspack":
        assert als._load_alspack() is lib
        monkeypatch.setenv("PIO_NO_NATIVE", "1")
        assert als._load_alspack() is None
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "GXX", ("g++", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        _build.library(name)
    assert not [p for p in built.iterdir() if p.suffix == ".tmp"]


def test_training_refuses_to_fall_back(monkeypatch):
    """With no context, training takes the CUDA device and raises
    without one; it never trains on the CPU unasked."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.eventframe import Interactions
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        RecTrainingData,
        recommendation_engine,
    )
    from predictionio_tpu_torch.utils.bimap import BiMap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pd = RecTrainingData(Interactions(
        entity_map=BiMap(["u0", "u1"]), target_map=BiMap(["i0"]),
        rows=np.array([0, 1], np.int32), cols=np.array([0, 0], np.int32),
        values=np.ones(2, np.float32), times=np.zeros(2),
    ))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALSAlgorithm().train(None, pd)
    storage = Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    engine = recommendation_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(engine, engine.params_from_variant({}), "rec",
                  storage=storage)
    assert storage.get_meta_data_engine_instances().get_all() == []
    model = ALSAlgorithm().train(ComputeContext.create(device="cpu"), pd)
    assert model.item_factors.shape == (1, 32)


def test_trainer_refuses_to_fall_back(monkeypatch, tmp_path):
    """Without a context the continuous trainer takes the CUDA device and
    raises without one, before it reads its state."""
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.training import (
        ContinuousTrainer,
        TrainerConfig,
        Watermark,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage.get_meta_data_apps().insert(App(0, "a"))
    engine = recommendation_engine()
    config = TrainerConfig(app_name="a", checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousTrainer(engine, engine.params_from_variant({}), "rec",
                          config, storage=storage)
    assert not os.path.exists(config.resolved_state_path())
    trainer = ContinuousTrainer(
        engine, engine.params_from_variant({}), "rec", config,
        storage=storage, ctx=ComputeContext.create(device="cpu"))
    assert trainer.decide(Watermark()) == "full"  # cold: never trained


def test_a_loaded_library_never_waits_behind_another_build(monkeypatch):
    """``_build.library`` holds one lock per library across its build:
    while library ``slow`` is compiling, an already-built library loads
    at once, a second caller of ``slow`` waits for the first build, and
    ``slow`` is built once."""
    import threading
    import time
    import types

    release = threading.Event()
    building = threading.Event()
    built = []

    def build(name):
        built.append(name)
        if name == "slow":
            building.set()
            assert release.wait(30)
        return _build.KERNEL_BUILD / f"lib{name}.so"

    class Lib:
        def __init__(self, path):
            self.path = path
            self.fns = {}

        def __getattr__(self, fn):
            return self.fns.setdefault(fn, types.SimpleNamespace())

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_build, "SIGNATURES", {
        "slow": {"f": (_build.ctypes.c_int, [_build.ctypes.c_int])},
        "ready": {"g": (None, [_build.ctypes.c_void_p])}})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_build_locks", {})
    got = {}
    first = threading.Thread(
        target=lambda: got.setdefault("first", _build.library("slow")))
    second = threading.Thread(
        target=lambda: got.setdefault("second", _build.library("slow")))
    first.start()
    assert building.wait(30)
    second.start()
    start = time.monotonic()
    lib = _build.library("ready")  # must not wait for slow's build
    assert time.monotonic() - start < 5
    assert lib.g.argtypes == [_build.ctypes.c_void_p]
    assert lib.g.restype is None
    assert "slow" not in _build._loaded and second.is_alive()
    release.set()
    first.join(30)
    second.join(30)
    assert got["first"] is got["second"] is _build._loaded["slow"]
    assert got["first"].f.restype is _build.ctypes.c_int
    assert sorted(built) == ["ready", "slow"]
