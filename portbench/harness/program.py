"""The program's own account of a ``--trace 1`` run of an ALS cell: its
``als/pack`` spans and its per-range counters (host seconds, calls and
stream drains in ``als/gather_gramian``, ``als/heavy_add`` and
``als/solve``), read from open traces of the port's tracer.

The set-up, measured window and profiler window of
``drivers/als_epochs.py`` run with no trace open, so what they measure
and what the profiler sees are untouched by this account. The first
reader of a program metric in a traced run calls :func:`window` once:
the cell's set-up again (the interactions drawn from :data:`SEED`, then
``als_epochs.compose``) under one program trace, the warm-up epochs,
then the *program window*, as many epochs as the profiler window held,
under a second trace, ended by one synchronize. A program that records
neither span nor counter leaves those values None, and its metrics
unread.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

from portbench.harness import generate, spec

#: the program window's interactions: every seed gives the same degrees
#: (:mod:`harness.generate`), hence the same packing and range calls
SEED = 2 ** 31 + 20


def window(config: dict, traffic: dict, epochs: int, device,
           seed: int = SEED) -> dict:
    """Set-up and ``epochs`` epochs of ``drivers/als_epochs.py``'s loop
    under program traces: ``epochs``, the program window's host seconds
    (``window_s``), the ``als/pack`` spans' seconds (``pack_s``, None
    when there are none) and the window trace's ``als.ranges`` (range
    -> ``host_s``, ``calls``, ``drains``; None when the program keeps no
    counters)."""
    from predictionio_tpu_torch.obs import tracing
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    driver = spec.load_module("drivers", traffic["driver"])
    tracer = tracing.Tracer()
    gen = generate.generator(seed, device)
    data = generate.interactions(config, gen, traffic, device)
    ctx = ComputeContext.create(device=device)
    with tracer.trace("portbench/setup"):
        step, nu_pad, ni_pad = driver.compose(ctx, *data, config, {})
    lam = float(config["reg"])
    y = driver.initial_items(ni_pad, config, gen, device)
    x = torch.zeros((nu_pad, y.shape[1]), dtype=y.dtype, device=device)
    for _ in range(int(traffic["warmup_steps"])):
        x, y = step(x, y, lam, 1)
    driver._sync(device)
    t0 = time.perf_counter()
    with tracer.trace("portbench/program_window"):
        for _ in range(epochs):
            x, y = step(x, y, lam, 1)
        driver._sync(device)
    seconds = time.perf_counter() - t0
    del step, ctx, x, y, data
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    setup, program = tracer.to_dict()["traces"]
    pack = [s["durationMs"] for s in setup["spans"] if s["name"] == "als/pack"]
    (root,) = [s for s in program["spans"]
               if s["spanId"] == program["rootSpanId"]]
    return {"epochs": epochs, "window_s": seconds,
            "pack_s": sum(pack) / 1e3 if pack else None,
            "ranges": root["attributes"].get("als.ranges")}


def _traffic(config: dict) -> dict | None:
    """The traffic of the cell of ``BENCHMARK.json`` that runs ``config``
    through ``als_epochs`` (a run knows its configuration, not its
    cell); a :class:`~harness.spec.SpecError` when two cells do, whose
    runs this cannot tell apart."""
    bench = spec.read_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    found = {}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        if cell.config == config and cell.traffic["driver"] == "als_epochs":
            found[w["name"]] = cell.traffic
    if len(found) > 1:
        raise spec.SpecError(
            f"cells {sorted(found)} run one configuration: the program "
            "window cannot tell which traffic a run has (run it from "
            "drivers/als_epochs.py, which knows its cell)")
    return next(iter(found.values()), None)


def account(run) -> dict | None:
    """``run.program``: made by :func:`window` at the first call for a
    traced run on a CUDA card, as many epochs as its profiler window, on
    the process's current CUDA device (the one ``run.py`` hands the
    driver); None for any other run. A run given a ``program`` keeps
    it."""
    if "program" not in vars(run):
        run.program = None
        traffic = None
        if (run.trace is not None and run.trace.steps
                and torch.cuda.is_available()):
            traffic = _traffic(run.config)
        if traffic is not None:
            run.program = window(
                run.config, traffic, run.trace.steps,
                torch.device("cuda", torch.cuda.current_device()))
            print(f"portbench: program window {run.trace.steps} epochs in "
                  f"{run.program['window_s']!r} s; measured window "
                  f"{run.steps} in {run.window_s!r} s; als/pack "
                  f"{run.program['pack_s']!r} s; ranges "
                  f"{run.program['ranges']}", file=sys.stderr)
    return run.program


def per_epoch(run, field: str, ranges, scale: float = 1.0):
    """``field`` (``host_s``, ``calls`` or ``drains``) summed over the
    ``ranges`` the program window entered, an epoch, times ``scale``;
    None where the program counted no such field."""
    acc = account(run)
    counted = (acc or {}).get("ranges") or {}
    values = [counted[r][field] for r in ranges
              if field in counted.get(r, {})]
    if not values:
        return None
    return scale * sum(values) / acc["epochs"]


def pack_s(run):
    """Seconds of the set-up's ``als/pack`` spans, both sides."""
    acc = account(run)
    return None if acc is None else acc["pack_s"]
