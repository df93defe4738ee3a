"""ALS's batched solve off the card: ``_solve`` on a CPU tensor takes the
plain version and launches nothing; the kernel wrapper's checks (the
rank limit, types, devices, the per-system layouts it takes, among them
a heavy slot's view of its packed row) refuse what ``csrc/als_solve.cu``
does not take before any library is loaded; and the C signature the
loader declares is the one the CUDA source defines. The kernel itself is
held to the plain version on the card (``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build, als

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "predictionio_tpu_torch" / "csrc" / "als_solve.cu"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "int": ctypes.c_int}


def _systems(r: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((r, 3 * k + 10, k)).astype(np.float32) / k ** .5
    a = torch.from_numpy(np.einsum("rwi,rwj->rij", y, y).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32))
    yy = rng.standard_normal((8 * k, k)).astype(np.float32) / k ** .5
    yty = torch.from_numpy(yy.T @ yy)
    cnt = torch.from_numpy(rng.integers(0, 30, r).astype(np.float32))
    return a, b, cnt, yty


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
@pytest.mark.parametrize("k", [1, 8, 33])
def test_cpu_solve_is_the_plain_version_and_launches_nothing(k, implicit):
    a, b, cnt, yty = _systems(50, k)
    before = _build.LAUNCHES["als_solve"]
    got = als._solve(a, b, cnt, yty, 0.05, implicit)
    assert _build.LAUNCHES["als_solve"] == before
    assert torch.equal(got, als._solve_plain(a, b, cnt, yty, 0.05, implicit))
    reg = (yty.double() + 0.05 * torch.eye(k, dtype=torch.float64)
           if implicit else
           (0.05 * cnt.double().clamp(min=1.0))[:, None, None]
           * torch.eye(k, dtype=torch.float64))
    want = torch.linalg.solve(a.double() + reg, b.double())
    err = (got.double() - want).norm(dim=1) / want.norm(dim=1)
    assert float(err.max()) <= 1e-5


def test_other_devices_are_refused():
    a = torch.empty(3, 4, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        als._solve(a, torch.empty(3, 4, device="meta"),
                   torch.empty(3, device="meta"), None, 0.1, False)


@pytest.mark.parametrize("k", [0, als.SOLVE_MAX_K + 1])
def test_ranks_outside_the_kernel_are_refused_before_a_build(k, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "library", no_build)
    a, b, cnt = torch.zeros(2, k, k), torch.zeros(2, k), torch.zeros(2)
    with pytest.raises(ValueError, match=f"1..{als.SOLVE_MAX_K}"):
        als._solve_kernel(a, b, cnt, torch.zeros(k, k), 0.1, True)


def test_a_heavy_slots_view_is_taken_as_it_lies():
    """``_heavy_stats`` hands over views of one packed ``[S, k*k + k + 1]``
    row per slot: each system contiguous, one stride between them."""
    k, n = 5, 7
    acc = torch.zeros((n, k * k + k + 1))
    a = acc[:, :k * k].reshape(n, k, k)
    b, cnt = acc[:, k * k:k * k + k], acc[:, -1]
    assert _build.lead_stride(a, "_solve", "a") == k * k + k + 1
    assert _build.lead_stride(b, "_solve", "b") == k * k + k + 1
    assert _build.lead_stride(cnt, "_solve", "cnt") == k * k + k + 1
    whole = torch.zeros((n, k, k))
    assert _build.lead_stride(whole, "_solve", "a") == k * k


@pytest.mark.parametrize("case", ["transposed", "float64", "shape",
                                  "device", "strided-rows"])
def test_layouts_the_kernel_does_not_take_are_refused(case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "library", no_build)
    k, n = 4, 3
    a, b, cnt = torch.zeros((n, k, k)), torch.zeros((n, k)), torch.zeros(n)
    if case == "transposed":
        a = a.transpose(1, 2)
    elif case == "float64":
        a = a.double()
    elif case == "shape":
        a = torch.zeros((n, k, k + 1))
    elif case == "device":  # a's device is the launch's: b is elsewhere
        b = torch.zeros((n, k), device="meta")
    else:
        a = torch.zeros((n, k, 2 * k))[:, :, ::2]
    with pytest.raises(ValueError, match="_solve"):
        als._solve_kernel(a, b, cnt, torch.zeros(k, k), 0.1, True)


def test_the_loader_declares_the_sources_c_signature():
    src = SOURCE.read_text()
    (params,) = re.findall(r"int pio_als_solve\(([^)]*)\)", src)
    want = []
    for param in params.split(","):
        ctype = re.sub(r"\s+", " ", param.strip()).rsplit(" ", 1)[0]
        want.append(C_TYPES[ctype.replace(" *", "*")])
    assert _build.SIGNATURES["als_solve"]["pio_als_solve"] == (
        ctypes.c_int, want)
    assert "als_solve" not in _build._loaded  # nothing built on the CPU


@pytest.mark.parametrize("case", ["transposed", "shape", "float64"])
def test_a_yty_the_kernel_does_not_take_is_refused(case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "library", no_build)
    k = 4
    yty = {"transposed": torch.zeros(k, 2 * k)[:, :k].T,
           "shape": torch.zeros(k, k + 1),
           "float64": torch.zeros(k, k, dtype=torch.float64)}[case]
    a, b, cnt = torch.zeros(2, k, k), torch.zeros(2, k), torch.zeros(2)
    with pytest.raises(ValueError, match="yty"):
        als._solve_kernel(a, b, cnt, yty, 0.1, True)
