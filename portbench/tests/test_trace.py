"""The trace reader on a hand-made chrome trace (microseconds)."""

import pytest

from portbench.harness import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 100),
    ev("user_annotation", "als/gather_gramian", 1, 10),
    ev("cpu_op", "aten::bmm", 2, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
    ev("user_annotation", "als/solve", 20, 10),
    ev("cpu_op", "aten::linalg_cholesky_ex", 21, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=2),
    ev("cpu_op", "aten::add", 40, 3),
    ev("cuda_runtime", "cudaLaunchKernel", 41, 1, corr=3),
    # device: kernel 1 at 10-40, kernel 2 at 35-50 (overlaps), kernel 3
    # at 70-80, a copy past the window's end is clipped at 100
    ev("kernel", "gemm", 10, 30, tid=7, corr=1),
    ev("kernel", "potrf", 35, 15, tid=7, corr=2),
    ev("kernel", "add", 70, 10, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy DtoH", 95, 20, tid=7),
    ev("kernel", "before the window", -30, 10, tid=7),
]


def test_summary():
    t = trace.summarize(EVENTS, steps=2)
    assert t.steps == 2 and t.n_device_ops == 4
    assert t.window_s == pytest.approx(100e-6)
    # busy: 10-50, 70-80, 95-100
    assert t.busy_s == pytest.approx(55e-6)
    assert t.device_s == pytest.approx((30 + 15 + 10 + 5) * 1e-6)
    assert t.by_range == pytest.approx({"als/gather_gramian": 30e-6,
                                        "als/solve": 15e-6})
    assert t.device_ops[0] == ["gemm", pytest.approx(30e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps == pytest.approx({
        "before als/gather_gramian: aten::bmm": 10e-6,
        "before aten::add": 20e-6,
        "before no host operator": 15e-6,
    })


def test_no_window_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:], steps=1)
