"""Reading the device's timeline from a ``torch.profiler`` trace.

:func:`capture` runs a callable under the profiler inside a range named
:data:`WINDOW` that ends after a synchronize, writes the chrome trace to
a temporary file, and :func:`summarize` reduces it:

* device operations (kernels, copies, fills) clipped to the window; the
  union of their intervals is the busy time;
* each kernel is tied to its launch by the trace's correlation id, and
  the launch to the host ranges open around it (``record_function``
  ranges such as ``als/solve``, and the innermost host operator);
* device seconds by range, the ten costliest operations by name, and
  the idle gaps named by what the host was launching when each ended.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

WINDOW = "portbench/traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Trace:
    steps: int                    # steps (epochs) inside the window
    window_s: float               # the window on the trace's clock
    busy_s: float                 # union of device operations
    device_s: float               # sum of device operations' durations
    n_device_ops: int
    by_range: dict                # range name -> device seconds
    device_ops: list              # [[name, seconds]], at most 10
    idle_gaps: list               # [[host activity, seconds]], at most 10


def capture(body, steps: int, device) -> Trace:
    """Run ``body()`` (``steps`` steps, enqueued) under the profiler and
    reduce its trace. The chrome trace goes to the temporary directory
    (``TMPDIR``) and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            body()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, steps)


def _chains(intervals: list, queries: list) -> dict:
    """For each ``(t, key)`` of ``queries``, the labels of the properly
    nested ``(start, end, label)`` intervals open at ``t``, outermost
    first."""
    intervals = sorted(intervals, key=lambda e: (e[0], -e[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] <= intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [label for _s, _e, label in stack]
    return out


def range_ms(run, name: str) -> float | None:
    """Device milliseconds an epoch of the operations launched inside
    the host range ``name`` in ``run``'s traced window; None without a
    trace or without that range."""
    tr = run.trace
    if tr is None or not tr.steps or name not in tr.by_range:
        return None
    return tr.by_range[name] / tr.steps * 1e3


def _top(totals: dict, n: int = 10) -> list:
    return [[name, s] for name, s in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events: list, steps: int) -> Trace:
    """Reduce chrome-trace ``events`` (microseconds) to a :class:`Trace`
    of the :data:`WINDOW` range."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host = collections.defaultdict(list)
    launches = {}
    ops = []
    for e in xs:
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in HOST_CATS and e.get("name") != WINDOW:
            host[e.get("tid")].append(
                (ts, ts + dur, (cat, str(e.get("name")))))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                ops.append((s, t, str(e.get("name")),
                            (e.get("args") or {}).get("correlation")))
    ops.sort()

    # the host ranges and operator around each device operation's launch
    queries = collections.defaultdict(list)
    for n, (_s, _t, _name, corr) in enumerate(ops):
        if corr in launches:
            tid, ts = launches[corr]
            queries[tid].append((ts, n))
    context = {}
    for tid, qs in queries.items():
        context.update(_chains(host[tid], qs))

    def where(n: int) -> tuple[str | None, str]:
        chain = context.get(n, [])
        ranges = [name for cat, name in chain if cat == "user_annotation"]
        opnames = [name for cat, name in chain if cat == "cpu_op"]
        return (ranges[-1] if ranges else None,
                opnames[-1] if opnames else "no host operator")

    by_range = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    gaps = collections.defaultdict(float)
    busy = 0.0
    device_s = 0.0
    cur = w0
    for n, (s, t, name, _corr) in enumerate(ops):
        rng, opname = where(n)
        dur = (t - s) / 1e6
        device_s += dur
        by_name[name] += dur
        if rng is not None:
            by_range[rng] += dur
        if s > cur:
            label = f"{rng}: {opname}" if rng else opname
            gaps[f"before {label}"] += (s - cur) / 1e6
        busy += max(0.0, t - max(s, cur)) / 1e6
        cur = max(cur, t)
    if w1 > cur:
        gaps["after the last device operation (the closing sync)"] += \
            (w1 - cur) / 1e6
    return Trace(
        steps=steps,
        window_s=(w1 - w0) / 1e6,
        busy_s=busy,
        device_s=device_s,
        n_device_ops=len(ops),
        by_range=dict(by_range),
        device_ops=_top(by_name),
        idle_gaps=_top(gaps),
    )

