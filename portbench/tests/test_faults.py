"""A whole run, past the harness's look for a chip, with the timed path
broken underneath: ``correct`` has to come out false for each fault that
these cells can have. (They run on one card and exchange nothing
between chips, so that fault has no place here.)"""

import time

import pytest
import torch

from portbench import run as bench
from predictionio_tpu_torch.ops import als


def run_tiny(cell, trace=False):
    return bench.run_cell(cell, 2 ** 31 + 99, 0.3, trace,
                          torch.device("cpu"), time.perf_counter())


def state_unchanged(monkeypatch):
    monkeypatch.setattr(als, "make_train_step",
                        lambda su, si: lambda x, y, lam, n: (x, y))


def half_left_out(monkeypatch):
    real = als._slab_stats

    def half(y, idx, weights, valid, *a, **k):
        keep = torch.ones_like(valid)
        keep[:, valid.shape[1] // 2:] = 0
        return real(y, idx, weights * keep, valid * keep, *a, **k)

    monkeypatch.setattr(als, "_slab_stats", half)


def answer_altered(monkeypatch):
    real = als._solve

    def altered(*a, **k):
        x = real(*a, **k).clone()
        x[0] *= 1.001
        return x

    monkeypatch.setattr(als, "_solve", altered)


def test_sound_run_is_correct(tiny_cell):
    out = run_tiny(tiny_cell)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_ratings_per_s", "setup_s"}


def test_traced_run_is_correct(tiny_cell):
    out = run_tiny(tiny_cell, trace=True)
    assert out["correct"]
    assert "pack_s" in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
def test_fault_is_caught(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
