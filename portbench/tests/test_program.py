"""The program's own account of a traced run (:mod:`harness.program`):
each reader on a run given an account, and on one without; and on the
card, a short program window that counts stream drains."""

from types import SimpleNamespace

import pytest
import torch

from portbench.harness import program, spec
from portbench.harness.record import Run
from portbench.harness.trace import Trace

RANGES = {"als/gather_gramian": {"host_s": 0.2, "calls": 90, "drains": 4},
          "als/heavy_add": {"host_s": 0.05, "calls": 8, "drains": 0},
          "als/solve": {"host_s": 3.0, "calls": 98, "drains": 96}}
#: reader -> what it reads from an account of 60 epochs and RANGES
WANT = {"als.solve_host_ms": 50.0, "als.stats_host_ms": 250 / 60,
        "als.stream_drains": 100 / 60, "als.pack_s": 1.25}


def _run(traced: bool = True) -> Run:
    trace = Trace(steps=60, window_s=5.0, busy_s=3.0, device_s=3.5,
                  n_device_ops=100, by_range={}, device_ops=[],
                  idle_gaps=[]) if traced else None
    return Run(config=spec.load_cell("als-ml20m").config, device_kind="x",
               setup_s=9.0, spans={"pack": 1.2}, steps=600, window_s=51.0,
               work={}, peaks=None, trace=trace, memory_peak_bytes=0,
               checks={}, attempted=0, failed=0)


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_read_the_account(name):
    run = _run()
    run.program = {"epochs": 60, "window_s": 5.1, "pack_s": 1.25,
                   "ranges": RANGES}
    reader = spec.load_module("metrics", name)
    assert reader.read(run) == pytest.approx(WANT[name])
    run.program = None
    assert reader.read(run) is None
    # an account from a program that keeps no counters or spans
    run.program = {"epochs": 60, "window_s": 5.1, "pack_s": None,
                   "ranges": None}
    assert reader.read(run) is None


@pytest.mark.parametrize("traced", [True, False])
def test_no_account_without_a_card_or_a_trace(traced, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = _run(traced)
    assert program.account(run) is None and run.program is None
    for name in WANT:
        assert spec.load_module("metrics", name).read(run) is None


def test_drains_are_not_counted_off_the_card():
    run = _run()
    run.program = {"epochs": 2, "window_s": 1.0, "pack_s": 0.1, "ranges": {
        k: {"host_s": 0.1, "calls": 3} for k in RANGES}}
    assert spec.load_module("metrics", "als.stream_drains").read(run) is None
    assert spec.load_module("metrics", "als.solve_host_ms").read(run) \
        == pytest.approx(50.0)


@pytest.mark.parametrize("cells", [1, 2], ids=["one-cell", "two-cells"])
def test_the_traffic_comes_from_the_one_cell_of_the_config(cells,
                                                           monkeypatch):
    """A run knows its configuration, not its cell: one cell of that
    configuration gives its traffic; two, whose runs cannot be told
    apart, fail loudly."""
    config = {"n_users": 3}
    names = [f"c{i}" for i in range(cells)] + ["other"]
    monkeypatch.setattr(spec, "read_json", lambda path: {
        "workloads": [{"name": n} for n in names]})
    monkeypatch.setattr(spec, "load_cell", lambda name: SimpleNamespace(
        config={"n_users": 4} if name == "other" else config,
        traffic={"driver": "als_epochs", "cell": name}))
    if cells == 1:
        assert program._traffic(config) == {"driver": "als_epochs",
                                            "cell": "c0"}
        assert program._traffic({"n_users": 5}) is None
    else:
        with pytest.raises(spec.SpecError, match="c0.*c1"):
            program._traffic(config)


@pytest.mark.gpu
def test_a_program_window_on_the_card_counts_drains(tiny_cell, cuda_device):
    got = program.window(tiny_cell.config, tiny_cell.traffic, 3, cuda_device)
    run = _run()
    run.program = got
    assert got["pack_s"] > 0 and got["window_s"] > 0
    assert {k: v["calls"] > 0 for k, v in got["ranges"].items()} == \
        dict.fromkeys(("als/gather_gramian", "als/heavy_add", "als/solve"),
                      True)
    assert spec.load_module("metrics", "als.stream_drains").read(run) > 0
    assert spec.load_module("metrics", "als.solve_host_ms").read(run) > 0
