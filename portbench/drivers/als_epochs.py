"""Window driver ``als_epochs``: the port's one-device ALS epoch loop.

Set-up draws the interactions on the device from the seed
(:mod:`harness.generate`), then calls the port as ``ops.als.train_als`` does when one device in one
process trains: ``ComputeContext.create``, ``load_cuda_linalg``,
``build_bucketed`` for each side, ``make_solve_side`` for each side,
``make_train_step``; then item factors drawn on the device by the same
generator, and ``warmup_steps`` epochs, synchronised.

The window enqueues epochs back to back with no host wait, as
``train_als`` does, and ends at the first epoch boundary past
``seconds`` with one synchronize. With ``trace``, as many more epochs
run under the profiler as ``trace_seconds`` of the window held.

Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference (:mod:`reference.als_ref`)
judges both half-steps of the first epoch, which starts from the
benchmark's own item factors, and of the last epoch run: every row of
both sides, from slabs and from heavy sub-row sums alike, against its
float64 normal equations built from the factors that half-step was
given.
"""

from __future__ import annotations

import gc
import inspect
import math
import time

import numpy as np
import torch

from portbench.harness import generate, peaks, work
from portbench.harness import trace as tracing
from portbench.harness.record import Run
from portbench.reference import als_ref

DTYPES = {"float32": torch.float32}


def packing_defaults() -> dict:
    """``train_als``'s own packing arguments, read from its signature so
    the composition stays what it does."""
    from predictionio_tpu_torch.ops import als

    params = inspect.signature(als.train_als).parameters
    return {k: params[k].default
            for k in ("block_len", "s_max", "max_slab_slots")}


def compose(ctx, rows, cols, vals, config: dict, spans: dict):
    """The epoch loop ``train_als`` builds on one device in one process:
    ``(step, users_padded, items_padded)``; ``spans`` gets the host
    seconds of ``pack`` (both sides' ``build_bucketed``) and ``stage``
    (both ``make_solve_side``)."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.parallel.mesh import load_cuda_linalg

    if ctx.n_devices != 1 or distributed.is_initialized():
        raise ValueError("als_epochs drives the one-device path")
    for dev in ctx.local_devices:
        load_cuda_linalg(dev)
    kw = dict(packing_defaults(), row_multiple=ctx.data_parallelism)
    t = time.perf_counter()
    users = als.build_bucketed(rows, cols, vals, int(config["n_users"]),
                               **kw)
    items = als.build_bucketed(cols, rows, vals, int(config["n_items"]),
                               **kw)
    spans["pack"] = time.perf_counter() - t
    t = time.perf_counter()
    args = (bool(config["implicit"]), float(config["alpha"]),
            config["dtype"])
    solve_u = als.make_solve_side(ctx, users, *args)
    solve_i = als.make_solve_side(ctx, items, *args)
    spans["stage"] = time.perf_counter() - t
    return (als.make_train_step(solve_u, solve_i), users.n_rows_padded,
            items.n_rows_padded)


def initial_items(n_padded: int, config: dict, gen, device):
    """Item factors before the first epoch, as ``train_als`` draws them
    (normal, scaled by ``1/sqrt(rank)``, phantom rows zero), but drawn
    on ``device`` by the run's generator ``gen``."""
    k = int(config["rank"])
    y = torch.zeros((n_padded, k), dtype=DTYPES[config["dtype"]],
                    device=device)
    y[:int(config["n_items"])] = torch.randn(
        (int(config["n_items"]), k), generator=gen, device=device,
        dtype=y.dtype) * (1.0 / math.sqrt(k))
    return y


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(config: dict, data, epochs: list, limits: dict, device) -> tuple:
    """Every row of both half-steps of each ``(y_in, x, y)`` in
    ``epochs`` against the reference: ``(checks, attempted, failed)``
    with ``checks[name] = [value, limit]``."""
    rows, cols, vals = data
    nu, ni = int(config["n_users"]), int(config["n_items"])
    common = dict(reg=float(config["reg"]), alpha=float(config["alpha"]),
                  implicit=bool(config["implicit"]), device=device)
    res = {"res_users": [], "res_items": []}
    for y_in, x, y in epochs:
        u = als_ref.side_residuals(x, y_in[:ni], rows, cols, vals, nu,
                                   **common)
        i = als_ref.side_residuals(y, x[:nu], cols, rows, vals, ni,
                                   **common)
        res["res_users"].append(u["residual"].numpy())
        res["res_items"].append(i["residual"].numpy())
    checks, attempted, failed = {}, 0, 0
    for name, parts in res.items():
        r = np.concatenate(parts)
        r = r[~np.isnan(r)]  # rows with no interactions: none generated
        checks[name] = [float(r.max()), float(limits[name])]
        attempted += r.size
        failed += int(np.count_nonzero(~(r <= limits[name])))
    return checks, attempted, failed


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, allow_tf32: bool = False) -> Run:
    """One run of ``cell``; ``t_start`` is the process's start on the
    ``time.perf_counter`` clock. ``allow_tf32`` is for the control
    alone: the configurations state float32 with TF32 off."""
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    config, traffic = cell.config, cell.traffic
    spans = {}
    t = time.perf_counter()
    gen = generate.generator(seed, device)
    data = generate.interactions(config, gen, traffic, device)
    spans["generate"] = time.perf_counter() - t
    if device.type == "cuda":
        # the peak is the program's, not the generator's temporaries (and
        # not an earlier run's, where a process runs several seeds)
        torch.cuda.reset_peak_memory_stats(device)
    ctx = ComputeContext.create(device=device)
    step, nu_pad, ni_pad = compose(ctx, *data, config, spans)
    lam = float(config["reg"])
    y = initial_items(ni_pad, config, gen, device)
    x = torch.zeros((nu_pad, y.shape[1]), dtype=y.dtype, device=device)
    first = None
    for _ in range(int(traffic["warmup_steps"])):
        y_in = y
        x, y = step(x, y, lam, 1)
        if first is None:  # judged: it starts from the benchmark's factors
            first = (y_in, x, y)
    if first is None:
        raise ValueError("als_epochs needs warmup_steps >= 1")
    _sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = 0
    while True:
        y_in = y
        x, y = step(x, y, lam, 1)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0

    summary = None
    if trace:
        state = {"x": x, "y": y}
        n_traced = max(1, math.ceil(float(traffic["trace_seconds"]) * steps
                                    / window_s))

        def body():
            for _ in range(n_traced):
                state["y_in"] = state["y"]
                state["x"], state["y"] = step(state["x"], state["y"], lam,
                                              1)

        summary = tracing.capture(body, n_traced, device)
        y_in, x, y = state["y_in"], state["x"], state["y"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    del step, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, attempted, failed = judge(config, data, [first, (y_in, x, y)],
                                      cell.limits, device)
    spans["judge"] = time.perf_counter() - t
    return Run(
        config=config, device_kind=kind, setup_s=setup_s,
        spans=spans, steps=steps, window_s=window_s,
        work=work.als_epoch(config), peaks=peaks.lookup(kind),
        trace=summary, memory_peak_bytes=int(peak), checks=checks,
        attempted=attempted, failed=failed,
    )
