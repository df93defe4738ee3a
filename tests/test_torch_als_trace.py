"""ALS's tracing from inside: the stage spans, the per-range counters of
an open trace, the one epoch loop with or without a timer, half-step
times from CUDA events read after the fact, and spans placed on the
``torch.profiler`` file's time base.

CPU tests; the CUDA-event path of ``StepTimer`` runs here against a
stand-in for ``torch.cuda.Event`` and the stream, whose clock is the
host's."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.obs import get_registry, tracing
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils import profiling

N_USERS, N_ITEMS, RANK = 40, 30, 4
#: small blocks, so both sides have heavy rows and several slabs
PACKING = dict(block_len=4, s_max=2)
RANGES = ("als/gather_gramian", "als/heavy_add", "als/solve")


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(11)
    rows = np.concatenate([rng.integers(0, N_USERS, 500),
                           np.zeros(40, np.int64)])
    cols = np.concatenate([rng.integers(0, N_ITEMS, 500),
                           np.arange(40) % N_ITEMS])
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    return rows, cols, vals


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


def _train(ctx, coo, **kw):
    rows, cols, vals = coo
    return als.train_als(ctx, rows, cols, vals, N_USERS, N_ITEMS, rank=RANK,
                         iterations=3, reg=0.1, **PACKING, **kw)


def _counters() -> dict:
    out = {}
    for family, data in get_registry().to_dict().items():
        if family.startswith(("pio_als_range_", "pio_als_stream_",
                              "pio_als_solve_", "pio_als_gramian_")):
            for sample in data["samples"]:
                out[(family, sample["labels"].get("range"))] = \
                    sample["value"]
    return out


def _packs(coo) -> tuple:
    rows, cols, vals = coo
    return (als.build_bucketed(rows, cols, vals, N_USERS, **PACKING),
            als.build_bucketed(cols, rows, vals, N_ITEMS, **PACKING))


def _expected_calls(coo, iterations: int) -> dict:
    """Range entries a one-device run makes: per half-step, one gather
    and one solve a slab, one gather and one add a heavy group, one
    solve of the heavy slots."""
    calls = dict.fromkeys(RANGES, 0)
    for packed in _packs(coo):
        assert packed.heavy, "the data must give heavy rows"
        calls["als/gather_gramian"] += len(packed.slabs) + len(packed.heavy)
        calls["als/heavy_add"] += len(packed.heavy)
        calls["als/solve"] += len(packed.slabs) + 1
    return {k: v * iterations for k, v in calls.items()}


def _expected_systems(coo, iterations: int) -> int:
    """Systems a one-device run solves: every stats row of both sides
    (each slab's rows, then the heavy slots), each epoch."""
    return iterations * sum(p.n_stat_rows for p in _packs(coo))


def _expected_slots(coo, iterations: int) -> int:
    """Slab slots a one-device run sums: every slot of both sides' slabs
    and heavy groups, each epoch."""
    return iterations * sum(p.padded_nnz for p in _packs(coo))


def test_open_trace_records_stages_and_range_counts(coo, cpu):
    before = _counters()
    tracer = tracing.Tracer()
    with tracer.trace("train"):
        traced = _train(cpu, coo)
    (rec,) = tracer.to_dict()["traces"]
    names = [s["name"] for s in rec["spans"]]
    assert sorted(names) == sorted(
        ["train"] + ["als/pack"] * 2 + ["als/stage"] * 2 + ["als/fetch"])
    spans = {s["name"]: s for s in rec["spans"]}
    root = spans["train"]
    pack = [s for s in rec["spans"] if s["name"] == "als/pack"]
    assert [(p["attributes"]["rows"], p["attributes"]["nnz"])
            for p in pack] == [(N_USERS, len(coo[0])), (N_ITEMS, len(coo[0]))]
    assert all(p["attributes"]["heavy_rows"] > 0 for p in pack)
    assert all(s["parentId"] == root["spanId"] for s in rec["spans"]
               if s is not root)
    ranges = root["attributes"]["als.ranges"]
    want = _expected_calls(coo, 3)
    assert {k: v["calls"] for k, v in ranges.items()} == want
    # nothing counts as a drain off a CUDA device; the solve counts the
    # systems it solved, the gather-Gramian the slab slots it summed
    counted = {"als/solve": {"systems"}, "als/gather_gramian": {"slots"}}
    assert all(set(v) == {"host_s", "calls"} | counted.get(name, set())
               and v["host_s"] >= 0 for name, v in ranges.items())
    assert ranges["als/solve"]["systems"] == _expected_systems(coo, 3)
    assert ranges["als/gather_gramian"]["slots"] == _expected_slots(coo, 3)
    after = _counters()
    for name in want:
        key = ("pio_als_range_host_seconds_total", name)
        assert after[key] - before.get(key, 0) == pytest.approx(
            ranges[name]["host_s"], abs=1e-5)
    assert not any(k[0] == "pio_als_stream_drains_total" for k in after)
    key = ("pio_als_solve_systems_total", None)
    assert after[key] - before.get(key, 0) == _expected_systems(coo, 3)
    key = ("pio_als_gramian_slots_total", None)
    assert after[key] - before.get(key, 0) == _expected_slots(coo, 3)

    untraced = _train(cpu, coo)
    np.testing.assert_array_equal(untraced.user_factors, traced.user_factors)
    np.testing.assert_array_equal(untraced.item_factors, traced.item_factors)


@pytest.mark.parametrize("iterations", [1, 2])
def test_solve_counts_its_systems_an_epoch(coo, cpu, iterations):
    """``als/solve``'s ``systems`` is the rows its calls took, summed on
    the host from the shapes: per epoch, each side's slab rows and heavy
    slots, in as many calls as the packing has slabs (plus one for each
    side's heavy slots); the registry counter rises by the same."""
    before = _counters()
    solved = []
    real = als._solve_plain

    def plain(a, *args):
        solved.append(a.shape[0])
        return real(a, *args)

    tracer = tracing.Tracer()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(als, "_solve_plain", plain)
        with tracer.trace("train"):
            rows, cols, vals = coo
            als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS,
                          rank=RANK, iterations=iterations, reg=0.1,
                          **PACKING)
    (rec,) = tracer.to_dict()["traces"]
    (root,) = [s for s in rec["spans"] if s["name"] == "train"]
    got = root["attributes"]["als.ranges"]["als/solve"]
    want = _expected_systems(coo, iterations)
    assert got["systems"] == sum(solved) == want
    assert got["calls"] == len(solved) == \
        _expected_calls(coo, iterations)["als/solve"]
    key = ("pio_als_solve_systems_total", None)
    assert _counters()[key] - before.get(key, 0) == want


def test_no_trace_records_nothing(coo, cpu, monkeypatch):
    traced_tracer = tracing.Tracer()
    with traced_tracer.trace("train"):
        traced = _train(cpu, coo)

    def refuse(*a, **k):
        raise AssertionError("a CUDA event or stream query off-trace")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    made = []
    monkeypatch.setattr(als, "_CountedRange",
                        lambda *a: made.append(a) or refuse())
    before = _counters()
    quiet = _train(cpu, coo)
    assert _counters() == before and not made
    np.testing.assert_array_equal(quiet.user_factors, traced.user_factors)
    np.testing.assert_array_equal(quiet.item_factors, traced.item_factors)


def test_timer_runs_the_one_loop_and_waits_only_to_fetch(coo, cpu,
                                                         monkeypatch):
    """A timed run enqueues what an untimed one does: the only host waits
    are the closing fetch's (``als/fetch``), and the factors are equal
    bit for bit."""
    waits = []

    def note(kind, real):
        def wrapped(*a, **k):
            cur = tracing.current_span()
            waits.append((kind, cur.name if cur is not None else None))
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(profiling, "sync", note("sync", profiling.sync))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        note("synchronize", torch.cuda.synchronize))
    monkeypatch.setattr(torch.Tensor, "cpu", note("cpu", torch.Tensor.cpu))
    monkeypatch.setattr(torch.Tensor, "item", note("item", torch.Tensor.item))
    tracer = tracing.Tracer()
    timer = profiling.StepTimer()
    with tracer.trace("train"):
        timed = _train(cpu, coo, timer=timer)
    assert waits and {where for _kind, where in waits} == {"als/fetch"}
    assert timer.summary()["als/user_solve"]["count"] == 3
    assert timer.summary()["als/item_solve"]["count"] == 3
    (rec,) = tracer.to_dict()["traces"]
    names = [s["name"] for s in rec["spans"]]
    assert names.count("als/user_solve") == 3
    monkeypatch.undo()
    plain = _train(cpu, coo)
    np.testing.assert_array_equal(timed.user_factors, plain.user_factors)
    np.testing.assert_array_equal(timed.item_factors, plain.item_factors)


class _FakeStream:
    """A CUDA stream stand-in: empty when ``empty`` says so."""

    def __init__(self, empty: bool):
        self.empty = empty
        self.synchronized = 0

    def query(self) -> bool:
        return self.empty

    def synchronize(self) -> None:
        self.synchronized += 1


class _FakeEvent:
    """A timing event stamped from the host's ``perf_counter``."""

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        self.t = None

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3

    def synchronize(self) -> None:
        assert self.t is not None


@pytest.mark.parametrize("empty", [True, False],
                         ids=["anchored-at-a-drain", "anchored-at-resolve"])
def test_device_steps_wait_for_nothing_and_resolve_later(monkeypatch, empty):
    stream = _FakeStream(empty)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    timer = profiling.StepTimer()
    solved = []

    def half(name):
        def solve(y, lam):
            time.sleep(0.002)
            solved.append((name, tracing.current_span().name))
            return y + 1
        return solve

    step = als.make_train_step(half("u"), half("i"), timer)
    tracer = tracing.Tracer()
    with tracer.trace("train") as root:
        with profiling.steps_on(torch.device("cuda", 0)):
            t0 = tracing.now()
            step(torch.zeros(2), torch.zeros(2), 0.1, 2)
            t1 = tracing.now()
        assert not timer.records and stream.synchronized == 0
        # the half-step's span is current over it, as on the host clock
        assert solved == [("u", "als/user_solve"), ("i", "als/item_solve")] * 2
        timer.resolve()
    assert stream.synchronized == (0 if empty else 1)
    assert [len(timer.records[n]) for n in ("als/user_solve",
                                            "als/item_solve")] == [2, 2]
    assert all(0.002 <= s < 0.5 for xs in timer.records.values() for s in xs)
    (rec,) = tracer.to_dict()["traces"]
    spans = [s for s in rec["spans"] if s["name"] != "train"]
    assert [s["name"] for s in sorted(spans, key=lambda s: s["start"])] == [
        "als/user_solve", "als/item_solve"] * 2
    for s in spans:
        assert s["parentId"] == root.span_id
        # placed through the anchor on the tracer's clock
        assert t0 - 1e-3 <= s["start"] <= t1
        assert s["start"] + s["durationMs"] / 1e3 <= t1 + 1e-3


def test_spans_overlay_the_profiler_file(tmp_path):
    """Every span and ``record_function`` opened by one statement lie
    within 50 µs of each other in the merged profiler file, beyond the
    host time the statement took between the span's clock read and the
    range's entry (measured in the block: the profiler stamps the range
    inside its entry, after the span, so that time cannot be told from a
    clock error); the spans are a process of their own there, and the
    returned span file is on the same time base. One unpaired range
    first takes the profiler's cold path (about 100 µs on its first
    entry)."""
    tracer = tracing.Tracer()
    pairs = 20
    entered = {}
    with profiling.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        with tracer.trace("window"):
            for i in range(pairs):
                rf = torch.profiler.record_function(f"pair{i}")
                with tracer.child(tracing.current_span(), f"pair{i}") as sp, rf:
                    entered[f"pair{i}"] = (tracing.now() - sp.start) * 1e6
                    time.sleep(0.001)
    placed = prof.overlay(tracer.chrome_trace())
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("ph") == "X"
            and isinstance(e.get("pid"), int) and e["pid"] >= prof.PID_BASE}
    theirs = {e["name"]: e for e in events if e.get("cat")
              == "user_annotation" and e["name"].startswith("pair")}
    assert set(ours) == {"window"} | {f"pair{i}" for i in range(pairs)}
    assert [e for e in events if e.get("ph") == "M"
            and e.get("pid") == ours["window"]["pid"]]
    diffs = {n: theirs[n]["ts"] - ours[n]["ts"] for n in theirs}
    assert len(diffs) == pairs
    assert all(-50 <= d <= entered[n] + 50 for n, d in diffs.items()), (
        diffs, entered)
    span_file = {e["name"]: e["ts"] for e in placed["traceEvents"]
                 if e["ph"] == "X"}
    assert all(span_file[n] == ours[n]["ts"] for n in ours)


# -- on the card -------------------------------------------------------------

CARD_USERS, CARD_ITEMS, CARD_EVENTS = 4000, 1500, 120_000
#: room for the time bases: how far a half-step's device span may start
#: before the host records its start event, or after its first kernel
CARD_ALIGN_US = 100.0


def _rate_storage(model_dir):
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage

    storage = Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(model_dir),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_id = storage.get_meta_data_apps().insert(App(0, "card"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(5)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": int(r)})
        for u, i, r in zip(
            rng.integers(0, CARD_USERS, CARD_EVENTS),
            np.minimum(rng.zipf(1.3, CARD_EVENTS), CARD_ITEMS) - 1,
            rng.integers(1, 6, CARD_EVENTS))
    ], app_id)
    return storage


def _half_step_bounds(events: list) -> list:
    """``(record, first)`` for each timed half-step, in µs of the
    profiler file: the host's call recording its start event, and the
    device start of its first device operation. The half-steps are the
    stretches of launches between two of ``StepTimer``'s event records
    (records inside an ``als/*`` range are the solver's own)."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("als/")]
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            corr = e.get("args", {}).get("correlation")
            device[corr] = min(device.get(corr, e["ts"]), e["ts"])
    runtime = sorted((e for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                     key=lambda e: e["ts"])
    out, record, first = [], None, None
    for e in runtime:
        if "EventRecord" in e["name"] and not any(
                lo <= e["ts"] <= hi for lo, hi in ranges):
            if record is not None and first is not None:
                out.append((record, first))
            record, first = e["ts"], None
        elif record is not None and first is None:
            first = device.get(e.get("args", {}).get("correlation"))
    return out


@pytest.mark.gpu
def test_card_half_step_spans_meet_their_first_kernels(tmp_path,
                                                      monkeypatch):
    """A 3-epoch ``run_train`` with ``PIO_TRACE_DIR`` on the card, after a
    small warm-up run in the process. In the merged profiler file each
    half-step's device span starts no earlier than :data:`CARD_ALIGN_US`
    before the host's call recording its start event, and no later than
    :data:`CARD_ALIGN_US` after the start of its first kernel: the bounds
    causality sets, with that much room for the two files' time bases.
    It does not bound how long after the span the first kernel starts
    (the host's launch path with the stream empty). The span file lies
    on the profiler file's base, and ``pio_train_step_seconds`` has the
    six half-steps. The distances are printed (``pytest -s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )

    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("PIO_TRACE_DIR", str(trace_dir))
    storage = _rate_storage(tmp_path / "models")
    card = ComputeContext.create(device=torch.device("cuda", 0))
    rng = np.random.default_rng(0)
    als.train_als(card, rng.integers(0, 50, 500), rng.integers(0, 40, 500),
                  np.ones(500, np.float32), 50, 40, rank=32, iterations=1)
    engine = recommendation_engine()
    params = engine.params_from_variant({
        "datasource": {"params": {"app_name": "card"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 32, "num_iterations": 3}}]})
    before = get_registry().to_dict().get("pio_train_step_seconds", {})
    set_storage(storage)
    try:
        iid = run_train(engine, params, "rec", storage=storage, ctx=card)
    finally:
        set_storage(None)
    (prof_name,) = [p for p in os.listdir(trace_dir)
                    if p.startswith("torch_")]
    events = json.loads((trace_dir / prof_name).read_text())["traceEvents"]
    halves = sorted((e for e in events if e.get("ph") == "X"
                     and isinstance(e.get("pid"), int)
                     and e["pid"] >= profiling.ProfilerTrace.PID_BASE
                     and e["name"] in ("als/user_solve", "als/item_solve")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in halves] == [
        "als/user_solve", "als/item_solve"] * 3
    bounds = _half_step_bounds(events)
    assert len(bounds) == len(halves), (bounds, halves)
    out = {"device": torch.cuda.get_device_name(0),
           "span_after_record_us": [e["ts"] - r
                                    for (r, _k), e in zip(bounds, halves)],
           "first_kernel_after_span_us": [
               k - e["ts"] for (_r, k), e in zip(bounds, halves)],
           "half_step_ms": [e["dur"] / 1e3 for e in halves]}
    print("als trace card check:", json.dumps(out))
    # the card runs the start event after the host records it, and the
    # half-step's first kernel after the event: a shift of the spans
    # past the window between the two fails one of these
    assert all(g >= -CARD_ALIGN_US for g in out["span_after_record_us"]), out
    assert all(g >= -CARD_ALIGN_US
               for g in out["first_kernel_after_span_us"]), out
    spans = json.loads((trace_dir / f"pio_train_{iid}.trace.json")
                       .read_text())["traceEvents"]
    placed = sorted(e["ts"] for e in spans if e.get("ph") == "X"
                    and e["name"] in ("als/user_solve", "als/item_solve"))
    assert placed == [e["ts"] for e in halves]
    after = get_registry().to_dict()["pio_train_step_seconds"]["samples"]
    counts = {s["labels"]["step"]: s["count"] for s in after}
    old = {s["labels"]["step"]: s["count"]
           for s in before.get("samples", [])}
    assert [counts[n] - old.get(n, 0) for n in (
        "als/user_solve", "als/item_solve")] == [3, 3]
