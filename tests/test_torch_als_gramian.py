"""ALS's half-step statistics off the card: ``_slab_stats`` on a CPU
tensor takes the plain version and launches nothing; the kernel
wrapper's checks (the rank limit, types, shapes, devices, row layouts)
refuse what ``csrc/als_gramian.cu`` does not take before any library is
loaded; the C signature the loader declares is the one the CUDA source
defines; and the ``slots`` and calls the ``als/gather_gramian`` range
counts an epoch are what ``build_bucketed`` packs, on a small problem
and at the MovieLens-20M degrees of the benchmark's configuration. The
kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.obs import get_registry, tracing
from predictionio_tpu_torch.ops import _build, als
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "predictionio_tpu_torch" / "csrc" / "als_gramian.cu"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "int": ctypes.c_int}


def _slab(r: int, w: int, n_y: int, k: int, seed: int = 0):
    """A slab as ``_fill_flat`` lays one out: row i's ratings first, then
    padding; row 0 all padding, row 1 one slot, row 2 full."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, w + 1, r)
    n[:3] = (0, 1, w)[:r]
    valid = (np.arange(w)[None, :] < n[:, None]).astype(np.float32)
    idx = (rng.integers(0, n_y, (r, w)) * valid).astype(np.int32)
    weights = (rng.integers(1, 6, (r, w)) * valid).astype(np.float32)
    y = (rng.standard_normal((n_y, k)) / k ** .5).astype(np.float32)
    return (torch.from_numpy(y), torch.from_numpy(idx),
            torch.from_numpy(weights), torch.from_numpy(valid))


@pytest.mark.parametrize("compute", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
@pytest.mark.parametrize("k", [1, 7, 33])
def test_cpu_stats_are_the_plain_version_and_launch_nothing(k, implicit,
                                                            compute):
    y, idx, weights, valid = _slab(9, 64, 50, k)
    if compute is not None:
        y = y.to(compute)
    before = _build.LAUNCHES["als_gramian"]
    got = als._slab_stats(y, idx, weights, valid, implicit, 2.0, compute)
    assert _build.LAUNCHES["als_gramian"] == before
    want = als._slab_stats_plain(y, idx, weights, valid, implicit, 2.0,
                                 compute)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[2], valid.sum(dim=1))
    assert not got[0][0].any() and not got[1][0].any()  # all padding


def test_other_devices_are_refused():
    y = torch.empty(5, 4, device="meta")
    idx = torch.empty(3, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        als._slab_stats(y, idx, torch.empty(3, 8, device="meta"),
                        torch.empty(3, 8, device="meta"), True, 1.0)


def _refused_inputs(case: str):
    y, idx, weights, valid = _slab(4, 16, 10, 4)
    compute = None
    if case == "rank-0":
        y = torch.zeros(10, 0)
    elif case == "rank-129":
        y = torch.zeros(10, als.SOLVE_MAX_K + 1)
    elif case == "idx-int64":
        idx = idx.long()
    elif case == "y-float64":
        y = y.double()
    elif case == "y-float16":
        y = y.half()
    elif case == "weights-float64":
        weights = weights.double()
    elif case == "weights-shape":
        weights = weights[:, :8]
    elif case == "valid-shape":
        valid = valid[:3]
    elif case == "idx-1d":
        idx = idx.reshape(-1)
    elif case == "mixed-devices":
        idx = torch.empty(idx.shape, dtype=torch.int32, device="meta")
    elif case == "strided-rows":
        weights = torch.zeros(4, 32)[:, ::2]
    elif case == "compute-float16":
        compute = torch.float16
    return y, idx, weights, valid, compute


@pytest.mark.parametrize("case", [
    "rank-0", "rank-129", "idx-int64", "y-float64", "y-float16",
    "weights-float64", "weights-shape", "valid-shape", "idx-1d",
    "mixed-devices", "strided-rows", "compute-float16"])
def test_what_the_kernel_does_not_take_is_refused_before_a_build(
        case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "library", no_build)
    y, idx, weights, valid, compute = _refused_inputs(case)
    before = _build.LAUNCHES["als_gramian"]
    with pytest.raises(ValueError, match="_slab_stats"):
        als._slab_stats_kernel(y, idx, weights, valid, True, 1.0, compute)
    assert _build.LAUNCHES["als_gramian"] == before


def test_the_loader_declares_the_sources_c_signature():
    src = SOURCE.read_text()
    (params,) = re.findall(r"int pio_als_gramian\(([^)]*)\)", src)
    want = []
    for param in params.split(","):
        ctype = re.sub(r"\s+", " ", param.strip()).rsplit(" ", 1)[0]
        want.append(C_TYPES[ctype.replace(" *", "*")])
    assert _build.SIGNATURES["als_gramian"]["pio_als_gramian"] == (
        ctypes.c_int, want)
    assert "als_gramian" not in _build._loaded  # nothing built on the CPU


def _slots_counter() -> float:
    data = get_registry().to_dict().get("pio_als_gramian_slots_total")
    return sum(s["value"] for s in data["samples"]) if data else 0.0


@pytest.mark.parametrize("packing", [dict(block_len=4, s_max=2),
                                     dict(block_len=8, s_max=4,
                                          max_slab_slots=256)],
                         ids=["heavy", "split"])
def test_slots_and_calls_an_epoch_are_the_packings(packing):
    """``als/gather_gramian``'s ``slots`` is every slab and heavy group's
    ``R·W``, summed on the host from the shapes; its calls, one a slab
    and one a heavy group, each side, each epoch; the registry counter
    rises by the slots."""
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.integers(0, 60, 900), np.zeros(50, np.int64)])
    cols = np.concatenate([rng.integers(0, 35, 900), np.arange(50) % 35])
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    packs = (als.build_bucketed(rows, cols, vals, 60, **packing),
             als.build_bucketed(cols, rows, vals, 35, **packing))
    assert all(p.heavy for p in packs), "the data must give heavy rows"
    before = _slots_counter()
    tracer = tracing.Tracer()
    with tracer.trace("train"):
        als.train_als(ComputeContext.create(device="cpu"), rows, cols, vals,
                      60, 35, rank=4, iterations=2, reg=0.1, **packing)
    (rec,) = tracer.to_dict()["traces"]
    (root,) = [s for s in rec["spans"] if s["name"] == "train"]
    got = root["attributes"]["als.ranges"]["als/gather_gramian"]
    assert got["slots"] == 2 * sum(p.padded_nnz for p in packs)
    assert got["calls"] == 2 * sum(len(p.slabs) + len(p.heavy)
                                   for p in packs)
    assert _slots_counter() - before == got["slots"]


def test_ml20m_epoch_is_32_calls_over_51603264_slots():
    """At the benchmark configuration's degrees (``portbench/harness/
    generate.degrees``, the published heads and totals) and
    ``train_als``'s default packing, an epoch makes 32 ``_slab_stats``
    calls (15 user slabs, 2 user heavy groups, 5 item slabs, 10 item
    heavy groups) over 51,603,264 slots. Only the degrees matter to the
    packing's shapes, so each row's ratings all name column 0."""
    from portbench.harness import generate

    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "rec-ml20m-r32.json").read_text())
    calls, slots = {}, 0
    for side, n in (("users", cfg["n_users"]), ("items", cfg["n_items"])):
        deg = generate.degrees(cfg["degrees"][side], n,
                               cfg["n_interactions"], "cpu").numpy()
        rows = np.repeat(np.arange(n, dtype=np.int32), deg)
        packed = als.build_bucketed(rows, np.zeros_like(rows),
                                    np.ones(len(rows), np.float32), n)
        calls[side] = (len(packed.slabs), len(packed.heavy))
        slots += packed.padded_nnz
        del rows, packed
    assert calls == {"users": (15, 2), "items": (5, 10)}
    assert sum(map(sum, calls.values())) == 32
    assert slots == 51_603_264
