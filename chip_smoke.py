#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card, nvcc
and PyTorch built for CUDA. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the fused score + top-k kernel library from
   ``predictionio_tpu_torch/csrc`` and prints the build seconds and the
   compiler's register/spill report;
3. holds the kernel in all three forms (float32, bfloat16, int8 + scale)
   against its plain PyTorch version on the card, over batch sizes (each
   side of every query-tile width), catalog sizes (one ragged), ``num``
   values (the kernel's per-round cap and one above it), ``[I]`` and
   ``[B, I]`` masks, the served shape (num 16, ``[I]`` mask), an
   over-masked row, NaN rows and planted exact ties;
4. serves the recommendation template at full width — rank 32, 49,152
   users, 1,048,576 items, random factors from the seed — through the
   port's own entry points: publish a generation into a local model
   store, ``create_engine_server``, HTTP queries (single, concurrent and
   one batch request), once with float32 factors and once each with
   ``quantize="int8"`` and ``"bf16"``; every answer is checked against
   the plain version on the card, int8 recall@10 against the float32
   ranking must reach 0.99, and every kernel form must have been
   launched by this run;
5. times the kernel (device time from the profiler, pass 1 and pass 2
   apart; the wall time of a call, CUDA events, beside it), its plain
   version and the ``torch.topk(q @ items.T, num)`` yardstick at
   B = 1, 8, 64, 256, with pass 1's plan (query tile, item tile, list
   slots, splits, shared bytes), and the per-request latency over HTTP;
6. trains ALS at the MovieLens-20M shape (bench.py's ``ml20m``: 138,493
   users × 26,744 items, 20M interactions from its generator, seed 42),
   rank 32, implicit, 5 epochs, once in float32 and once with bf16
   gathers: prints the packing seconds (native and numpy, whose arrays
   must be identical), the epoch time (median of epochs 2-5, CUDA
   events), each half-step's device split from the profiler (gather +
   Gramian, Cholesky solve, heavy ``index_add_``), the peak device
   memory and the epoch's bound; holds every heavy item row, 1,024
   sampled items and (after one more user half-step) 1,024 sampled users
   to a relative residual of 1e-4 against their normal equations
   rebuilt in float64 on the host;
7. drives the DASE path end to end: 200,000 ``rate`` events (20,000
   users × 5,000 items, the same generator) into a memory event store,
   then (``train_and_serve``) the port's ``run_train`` on
   ``recommendation_engine()`` with the default ``ALSParams`` into a
   local model store, ``create_engine_server`` on that generation, and
   HTTP queries, every answer checked against the plain top-k on the
   trained factors; prints the read, prepare, train and persist seconds;
8. drives the event server and its stores: sqlite metadata with a
   generated access key and a second key limited to ``view``, the port's
   ``create_event_server``, and the same 200,000 events as 4,000
   ``POST /batch/events.json`` requests of 50 from 8 keep-alive client
   threads into the native event log (every event 201), the probes (no
   key 401, limited key 403, 51 events 400, a latest-5 find, a delete
   then 404), ``EventStore.interactions`` through the log's native scan
   (its triples equal to the generator's), then ``train_and_serve``;
   once more with the events in sqlite (the zero-config wiring, read
   through the frame path) on the first 50,000 events; prints events/s,
   batch-request p50/p99, the read seconds of both stores beside phase
   7's memory read, and the train answers;
9. evaluates on phase 7's store: ``run_evaluation`` over the
   recommendation example's grid (eval_k 3, ``ALSParams(rank in {8, 16,
   32}, num_iterations=5)``, a ``PrecisionAtK(10)`` defined here), the
   engine wrapped in ``FastEvalEngine``; checks the instance ends
   EVALCOMPLETED with best.json written, the event store scanned once,
   every fold's batch answers equal to the plain top-k on that fold's
   trained factors on the card, and the float32 kernel launched; prints
   each candidate's precision, each fold's batch and its bucket, the
   kernel at the eval shape (bucket × 5,000 items × each rank, the num
   bucket) beside its bound, its plain version and
   ``torch.topk(q @ items.T)``, and the evaluation's seconds;
10. serves the similar-product template at its own width
   (``examples/similarproduct/engine.json``: rank 16, a "view" and a
   "like" ALS): 200,000 ``view`` and 40,000 ``like`` events and one
   ``$set`` of 1-3 of 20 categories per item into a memory store,
   ``run_train``, ``create_engine_server``, 128 ``/queries.json``
   baskets of 1-8 items (categories, whiteList, blackList, one of
   unknown items), each answer held against a plain combination on the
   card (per algorithm: mean, normalize, the plain top-k, the filters;
   then summed per item; the kernel's list, held against the plain
   top-k by the tie rule, settles ties at the pool's edge); then ``gather_mean_top_k_cosine`` on int8 and
   bf16 tables of the trained factors against the plain version; prints
   the read, train and persist seconds, the request p50, the launches
   and the catalog normalization's time beside the kernel's;
11. prints one ``{"kernels": [...]}`` line (launches summed over phases
   4 and 7-10) and, last, the device line.

Any failed check raises, and the script exits non-zero without the last
line. Without CUDA, or without the repository beside it, it exits 1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import datetime as dt
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the served shapes: ALSParams.rank, bench.py's user count, the catalog
#: size the TPU kernel was designed for
RANK = 32
N_USERS = 49_152
N_ITEMS = 1_048_576
RAGGED_ITEMS = 1_000_003
FORMS = ("f32", "bf16", "int8")
#: kernel vs plain version: the kernel sums the k products in order with
#: fp32 FMA, cuBLAS in another order; for unit-scale factors at k = 32
#: the two differ by a few ulps of the terms' sum
ATOL, RTOL = 1e-4, 1e-5
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: batches timed in phase 5 (the kernels line reports B = 64)
TIME_BATCHES = (1, 8, 64, 256)
CUDA_SOURCE = "predictionio_tpu_torch/csrc/fused_topk.cu"
TPU_KERNEL = "predictionio_tpu/ops/pallas_topk.py:213"
#: training at bench.py's "ml20m" shape (users, items, interactions)
ML20M = (138_493, 26_744, 20_000_000)
TRAIN_EPOCHS = 5
TRAIN_REG, TRAIN_ALPHA = 0.01, 1.0
#: a row's solve against its normal equations rebuilt in float64; true
#: fp32 products and sums stay near 1e-6, TF32 products near 1e-3
RESIDUAL_TOL = 1e-4
RESIDUAL_SAMPLE = 1024
#: the DASE phase: users, items, rate events
DASE = (20_000, 5_000, 200_000)
#: the ingest phase: events a batch request, client threads, and the
#: events of the sqlite run (the first of the same stream)
INGEST_BATCH = 50
INGEST_THREADS = 8
SQLITE_EVENTS = 50_000
#: names of the profiler ranges ops/als.py opens
ALS_RANGES = ("als/gather_gramian", "als/solve", "als/heavy_add")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs -----------------------------------------------------------------


def make_table(n_items: int, k: int, device, seed: int) -> dict:
    """A float32 item table on ``device`` with planted trouble: 17 exactly
    equal rows spread across the catalog with a large norm (they tie at
    the top for about half the queries), and two NaN rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    items = torch.randn(n_items, k, generator=g, device=device)
    ties = torch.arange(17, device=device) * (n_items // 17)
    items[ties] = items[ties[0]] * 3.0
    nan_rows = torch.tensor([123, n_items - 5], device=device)
    items[nan_rows] = float("nan")
    return {"f32": items, "ties": ties, "nan_rows": nan_rows}


def form_of(table: dict, form: str):
    """(items, scale) for one kernel form of ``table``."""
    from predictionio_tpu_torch.ops.quantize import quantize_factors

    items = table["f32"]
    if form == "f32":
        return items, None
    if form == "bf16":
        return items.to(torch.bfloat16), None
    qf = quantize_factors(items, "int8")
    scale = qf.scale.clone()
    # a NaN row cannot survive int8; a corrupt scale stands in for it
    scale[table["nan_rows"]] = float("nan")
    return qf.data, scale


def make_mask(kind: str, batch: int, n_items: int, device, seed: int):
    if kind == "none":
        return None
    g = torch.Generator(device=device).manual_seed(seed + 1)
    if kind == "item":
        return torch.rand(n_items, generator=g, device=device) < 0.1
    mask = torch.rand(batch, n_items, generator=g, device=device) < 0.1
    mask[0] = True
    mask[0, :3] = False  # over-masked: only 3 rankable items in row 0
    return mask


# -- comparison -------------------------------------------------------------


def compare(q, items, scale, mask, num, got, want) -> dict:
    """Hold a top-k answer against the plain version's. Scores must agree
    within ATOL + RTOL*|s|; -inf slots must match and hold index 0; where
    the indices differ, the answer's item must score (plain arithmetic)
    within the same tolerance of the plain version's score at that slot
    and be rankable, and no row may repeat an item."""
    ks, ki = got
    ps, pi = want
    assert ks.shape == ps.shape == ki.shape == pi.shape, (
        ks.shape, ps.shape, ki.shape, pi.shape
    )
    neg_k, neg_p = torch.isneginf(ks), torch.isneginf(ps)
    assert torch.equal(neg_k, neg_p), "unfilled slots differ"
    assert not torch.isnan(ks).any(), "NaN score returned"
    assert (ki[neg_k] == 0).all(), "an unfilled slot holds a nonzero index"
    fin = ~neg_p
    err = (ks - ps).abs()[fin]
    max_err = float(err.max()) if err.numel() else 0.0
    bad = err > ATOL + RTOL * ps.abs()[fin]
    assert not bad.any(), f"scores differ by up to {max_err}"
    diff = (ki != pi) & fin
    n_diff = int(diff.sum())
    if n_diff:
        rows, cols = torch.nonzero(diff, as_tuple=True)
        picked = ki[rows, cols].long()
        rescored = (q[rows].double() * items[picked].double()).sum(1)
        if scale is not None:
            rescored = rescored * scale[picked].double()
        tol = ATOL + RTOL * ps[rows, cols].double().abs()
        gap = (rescored - ps[rows, cols].double()).abs()
        assert (gap <= tol).all(), (
            f"{n_diff} index mismatch(es), not all ties: largest score "
            f"gap {float(gap.max())}"
        )
        if mask is not None:
            m = mask[picked] if mask.dim() == 1 else mask[rows, picked]
            assert not m.any(), "a masked item was returned"
    for row, frow in zip(ki.cpu(), fin.cpu()):
        vals = row[frow].tolist()
        assert len(set(vals)) == len(vals), "an item repeats in a row"
    return {"max_abs_err": max_err, "tied_mismatches": n_diff}


# -- phase 3: kernel vs plain version ----------------------------------------


def kernel_cases(n_items: int, ragged: int, cap: int):
    """(form, B, I, num, mask kind) tuples covering the contract."""
    cases = []
    for form in FORMS:
        # every query-tile width, and each side of the 32- and 64-query tiles
        for b in (1, 2, 3, 7, 16, 31, 32, 33, 64, 65, 128, 256):
            cases.append((form, b, n_items, 10, "none"))
        for num in (1, 20, 128, cap, cap + 476):
            cases.append((form, 7, ragged, num, "item"))
        cases.append((form, 64, n_items, 16, "item"))  # the served shape
        cases.append((form, 64, ragged, 10, "batch"))
        cases.append((form, 256, n_items, 128, "item"))
    cases.append(("f32", 33, n_items, cap, "none"))
    cases.append(("f32", 1, n_items, cap + 476, "none"))
    return cases


def check_kernels(device, n_items: int, ragged: int, k: int, seed: int,
                  cap: int) -> dict:
    """Every kernel form against its plain version; returns the largest
    score error per form."""
    from predictionio_tpu_torch.ops import fused_topk

    tables = {
        n: make_table(n, k, device, seed + n) for n in {n_items, ragged}
    }
    worst = {form: 0.0 for form in FORMS}
    for form, b, n, num, mask_kind in kernel_cases(n_items, ragged, cap):
        table = tables[n]
        items, scale = form_of(table, form)
        g = torch.Generator(device=device).manual_seed(seed + b + num)
        q = torch.randn(b, k, generator=g, device=device)
        mask = make_mask(mask_kind, b, n, device, seed + b)
        got = fused_topk.fused_top_k_dot(q, items, num, mask, scale)
        if device.type == "cuda":
            torch.cuda.synchronize()
        want = fused_topk.fused_top_k_dot_reference(q, items, num, mask,
                                                    scale)
        res = compare(q, items.float(), scale, mask, min(num, n), got, want)
        if device.type == "cuda":
            torch.cuda.synchronize()
        worst[form] = max(worst[form], res["max_abs_err"])
        log(f"kernel {form:4s} B={b:<3d} I={n:<8d} num={num:<5d} "
            f"mask={mask_kind:5s} ok max_abs_err={res['max_abs_err']:.3g} "
            f"tied_mismatches={res['tied_mismatches']}")
    return worst


# -- phase 4: the served main path --------------------------------------------


def make_model(n_users: int, n_items: int, k: int, seed: int):
    """Random ALS factors from the seed. Item rows get log-normal norms
    (sigma 1): trained factor norms follow item popularity, which is
    heavy-tailed."""
    from predictionio_tpu_torch.convert import als_model_from_numpy

    rng = np.random.default_rng(seed)
    users = rng.standard_normal((n_users, k), dtype=np.float32)
    items = rng.standard_normal((n_items, k), dtype=np.float32)
    items *= np.exp(rng.standard_normal((n_items, 1))).astype(np.float32)
    return als_model_from_numpy(
        users, items,
        np.char.add("u", np.arange(n_users).astype(str)),
        np.char.add("i", np.arange(n_items).astype(str)),
    )


def publish(model, store_dir: str):
    """Publish ``model`` as a COMPLETED generation into a memory
    instance store and a local-filesystem model store under
    ``store_dir``; returns the Storage."""
    from predictionio_tpu_torch.core.persistence import (
        publish_generation,
        serialize_models,
    )
    from predictionio_tpu_torch.data.storage import EngineInstance, Storage
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm

    storage = Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": store_dir,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    now = dt.datetime.now(dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="chip-smoke", engine_version="1",
        engine_variant="default", engine_factory="recommendation",
    ))
    blob = serialize_models(iid, [ALSAlgorithm()], [model])
    publish_generation(storage.get_model_data_models(), iid, blob)
    return storage, len(blob)


def _post(base: str, path: str, body) -> tuple[object, float]:
    t0 = time.perf_counter()
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def query_plan(n_users: int, n_items: int, seed: int):
    """(sequential singles, concurrent singles, one batch request)."""
    rng = np.random.default_rng(seed + 7)
    users = [f"u{u}" for u in rng.integers(0, n_users, 200)]
    seq = [{"user": u, "num": 10} for u in users[:16]]
    nums = [1, 5, 10, 20, 50, 128]
    conc = [
        {"user": u, "num": nums[i % len(nums)]}
        for i, u in enumerate(users[16:46])
    ]
    conc.append({"user": "nobody", "num": 10})  # unknown user
    conc.append({"user": users[46], "num": min(2000, n_items)})
    batch = [{"user": u, "num": 10} for u in users[100:200]]
    return seq, conc, batch


def serve_and_check(storage, model, table_f32, quantize: str, device,
                    seed: int, n_users: int) -> dict:
    """One server run: start, warm, query over HTTP, check every answer
    against the plain version on the same table, shut down."""
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.ops.quantize import recall_at_k
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )

    form = quantize or "f32"
    n_items = len(model.item_map)
    engine = recommendation_engine()
    params = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}
    )
    t0 = time.perf_counter()
    es, http = create_engine_server(
        engine, params, "chip-smoke", host="127.0.0.1", port=0,
        storage=storage, ctx=ComputeContext.create(device=device),
        max_batch=64, max_wait_ms=2.0, quantize=quantize or None,
    )
    http.start()
    startup_s = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{http.port}"
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            status = json.loads(resp.read())
        assert status["warmed"] is True, status
        after_warmup = fused_topk.LAUNCHES[form]
        seq, conc, batch = query_plan(n_users, n_items, seed)
        answers, lat = [], []
        for q in seq:
            out, s = _post(base, "/queries.json", q)
            answers.append((q, out))
            lat.append(s)
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(_post, base, "/queries.json", q)
                    for q in conc]
            answers += [(q, f.result()[0]) for q, f in zip(conc, futs)]
        out, batch_s = _post(base, "/batch/queries.json", batch)
        assert all(r["status"] == 200 for r in out), out[:3]
        answers += [(q, r["prediction"]) for q, r in zip(batch, out)]
        launched = fused_topk.LAUNCHES[form] - after_warmup
        assert launched > 0, f"{form}: no kernel launch while serving"
    finally:
        es.close()

    # the tables as the server holds them, rebuilt the same way: a
    # quantized deploy quantizes the user table too, and serving
    # dequantizes the gathered user rows
    staged_items = table_f32
    scale = None
    users = torch.as_tensor(model.user_factors).to(device)
    if quantize:
        from predictionio_tpu_torch.ops.quantize import (
            dequantize,
            quantize_factors,
        )

        qf = quantize_factors(table_f32, quantize)
        staged_items, scale = qf.data, qf.scale
        users = dequantize(quantize_factors(users, quantize))
    n_checked, n_ties, max_err = 0, 0, 0.0
    ref10, got10 = [], []
    for q, ans in answers:
        uid = model.user_map.get(q["user"], -1)
        if uid < 0:
            assert ans == {"itemScores": []}, ans
            continue
        n = min(q["num"], n_items)
        got_i = torch.tensor(
            [[int(e["item"][1:]) for e in ans["itemScores"]]],
            dtype=torch.int32, device=device,
        )
        got_s = torch.tensor(
            [[e["score"] for e in ans["itemScores"]]], device=device
        )
        qv = users[uid:uid + 1]
        want = fused_topk.fused_top_k_dot_reference(
            qv, staged_items, n, None, scale
        )
        res = compare(qv, staged_items.float(), scale, None, n,
                      (got_s, got_i), want)
        n_checked += 1
        n_ties += res["tied_mismatches"]
        max_err = max(max_err, res["max_abs_err"])
        if n >= 10:
            ref = fused_topk.fused_top_k_dot_reference(
                qv, table_f32, 10)[1]
            ref10.append(ref.cpu().numpy()[0])
            got10.append(got_i.cpu().numpy()[0, :10])
    recall = recall_at_k(np.stack(ref10), np.stack(got10))
    if quantize == "int8":
        assert recall >= 0.99, f"int8 recall@10 {recall} < 0.99"
    lat_ms = sorted(s * 1e3 for s in lat)
    return {
        "form": form,
        "startup_s": startup_s,
        "answers_checked": n_checked,
        "tied_mismatches": n_ties,
        "max_abs_err": max_err,
        "recall_at_10": recall,
        "served_launches": launched,
        "p50_ms": lat_ms[len(lat_ms) // 2],
        "batch_request_ms": batch_s * 1e3,
        "queries": len(answers),
    }


# -- phase 5: timings ---------------------------------------------------------


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, name_part: str) -> float:
    """Device time per call of the CUDA kernels whose name holds
    ``name_part``, summed over a profiled run of ``reps`` calls (no host
    gaps counted). A session that records none of them is run once more
    (in a run after phase 9's evaluation the first session came back
    without pass 1); 0.0 when neither records any device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total_us = 0.0
    for _attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if name_part in evt.key:
                total_us += getattr(evt, "device_time_total",
                                    getattr(evt, "cuda_time_total", 0.0))
        if total_us > 0:
            break
    return total_us / 1e3 / reps


def bound(batch: int, n_items: int, k: int, num: int, items, scale):
    """Least time the card could take: each input read once, each output
    written once, over HBM bandwidth; 2*B*I*k fp32 operations (+B*I for
    the scale) over the fp32 peak. The larger of the two bounds it."""
    nbytes = (
        items.numel() * items.element_size() + batch * k * 4
        + batch * num * 8 + (n_items * 4 if scale is not None else 0)
    )
    flops = 2 * batch * n_items * k + (batch * n_items if scale is not None
                                       else 0)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_forms(table_f32, device, seed: int) -> dict:
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.ops.quantize import quantize_factors

    n_items, k = table_f32.shape
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for form in FORMS:
        if form == "f32":
            items, scale = table_f32, None
        else:
            qf = quantize_factors(table_f32, form)
            items, scale = qf.data, qf.scale
        for b in TIME_BATCHES:
            g = torch.Generator(device=device).manual_seed(seed + b)
            q = torch.randn(b, k, generator=g, device=device)
            num = 10
            def kernel():
                return fused_topk.fused_top_k_dot(q, items, num, None, scale)

            plan = fused_topk.plan_pass1(b, n_items, num, k,
                                         items.element_size(), n_sms)
            call_ms = time_ms(kernel, reps=20)
            pass1_ms = device_ms(kernel, reps=10, name_part="topk_pass1")
            pass2_ms = device_ms(kernel, reps=10, name_part="topk_pass2")
            dev_ms = pass1_ms + pass2_ms
            # the kernel's own time; a call's wall time adds the host's
            # launch work, which dominates when the kernel is short
            ms = dev_ms if dev_ms > 0 else call_ms
            plain_ms = time_ms(lambda: fused_topk.fused_top_k_dot_reference(
                q, items, num, None, scale), reps=5, warmup=1)
            if form == "f32":
                lib = lambda: torch.topk(q @ items.T, num)  # noqa: E731
            elif scale is None:
                lib = lambda: torch.topk(q @ items.float().T, num)  # noqa: E731
            else:
                lib = lambda: torch.topk(  # noqa: E731
                    (q @ items.float().T) * scale, num)
            library_ms = time_ms(lib, reps=5, warmup=1)
            bound_ms, bound_by = bound(b, n_items, k, num, items, scale)
            out[(form, b)] = {
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            log(f"time {form:4s} B={b:<3d} I={n_items} num={num} "
                f"kernel_ms={ms:.4f} pass1_ms={pass1_ms:.4f} "
                f"pass2_ms={pass2_ms:.4f} call_ms={call_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_share={bound_ms / ms:.3f} "
                f"plan=qt{plan.qt}/it{plan.item_tile}/R{plan.region}/"
                f"stages{plan.stages}/"
                f"splits{plan.splits}/smem{plan.smem}")
    return out


# -- phase 6: ALS training at full width ---------------------------------------


def make_interactions(n_users: int, n_items: int, nnz: int, seed: int = 42):
    """bench.py's generator (``make_data``): uniform users, power-law
    (zipf 1.3) item popularity, ratings 1..5; duplicates are kept."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.3, nnz) % n_items
    rows = rng.integers(0, n_users, nnz).astype(np.int32)
    cols = pop.astype(np.int32)
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    return rows, cols, vals


def pack_sides(rows, cols, vals, n_users: int, n_items: int) -> dict:
    """Both sides packed natively and with numpy (timed apart); the two
    paths must give identical arrays."""
    from predictionio_tpu_torch.ops import als

    assert als._load_alspack() is not None, "native alspack did not build"
    out = {}
    for path in ("native", "numpy"):
        if path == "numpy":
            os.environ["PIO_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            users = als.build_bucketed(rows, cols, vals, n_users)
            items = als.build_bucketed(cols, rows, vals, n_items)
            out[f"{path}_s"] = time.perf_counter() - t0
        finally:
            os.environ.pop("PIO_NO_NATIVE", None)
        out[path] = (users, items)
    for a, b in zip(out["native"], out["numpy"]):
        assert np.array_equal(a.inv_perm, b.inv_perm)
        for sa, sb in zip(a.slabs + a.heavy, b.slabs + b.heavy):
            for field in ("idx", "weights", "valid"):
                assert np.array_equal(getattr(sa, field),
                                      getattr(sb, field)), field
    return out


def _rows_by(keys: np.ndarray, n: int):
    order = np.argsort(keys, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n))])
    return order, starts


def _rounded(x: np.ndarray, compute) -> np.ndarray:
    """float64 copy of ``x`` as the card sees it: rounded to ``compute``
    first when the gathers run in it."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if compute is not None:
        t = t.to(compute)
    return t.double().numpy()


def max_residual(x_card: np.ndarray, ids: np.ndarray, opposite: np.ndarray,
                 other: np.ndarray, vals: np.ndarray, grouped,
                 compute) -> tuple[float, float]:
    """Largest and median ``‖A x − b‖ / ‖b‖`` over rows ``ids``, with each
    row's implicit normal equations ``A = YᵀY + Σ αw·y·yᵀ + λI``,
    ``b = Σ (1+αw)·y`` rebuilt in float64 from the interactions and the
    opposite factors ``opposite`` (rounded as the card rounded them)."""
    order, starts = grouped
    y = _rounded(opposite, compute)
    w = _rounded(vals, compute)
    gram = y.T @ y
    k = y.shape[1]
    eye = np.eye(k)
    res = []
    for r in ids:
        sel = order[starts[r]:starts[r + 1]]
        a = gram + TRAIN_REG * eye
        b = np.zeros(k)
        for lo in range(0, len(sel), 1 << 20):
            part = sel[lo:lo + (1 << 20)]
            yg = y[other[part]]
            ww = w[part]
            a += (yg * (TRAIN_ALPHA * ww)[:, None]).T @ yg
            b += ((1.0 + TRAIN_ALPHA * ww)[:, None] * yg).sum(axis=0)
        x = x_card[r].astype(np.float64)
        res.append(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
    return float(np.max(res)), float(np.median(res))


def profile_half_step(solve, y, lam) -> dict:
    """One half-step: its time (CUDA events), then its device time by the
    ranges ops/als.py opens and the sum of all its kernels (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    split = {"ms": time_ms(lambda: solve(y, lam), reps=3, warmup=1)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(y, lam)
        torch.cuda.synchronize()
    split.update({name: 0.0 for name in ALS_RANGES})
    kernels_us = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
        if evt.key in ALS_RANGES:
            split[evt.key] = max(split[evt.key], dev_us / 1e3)
        elif str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels_us += dev_us  # a kernel, not a host op or a range
    split["kernels_ms"] = kernels_us / 1e3
    return split


def epoch_bound(packed_u, packed_i, n_users: int, n_items: int,
                k: int, elem: int) -> dict:
    """Least time of one epoch on the card: each slab array (index,
    weight, valid: 12 bytes a slot) and each factor matrix read once and
    each solved matrix written once, over HBM bandwidth; the Gramian and
    right-hand-side products of every padded slot (2k² + 2k) and the
    Cholesky solves (k³/3 + 2k² a row) over the fp32 peak. Beside it the
    bytes of the gathered rows themselves (a slot's factor row, which
    the L2 can serve: both factor matrices fit in it)."""
    slots = packed_u.padded_nnz + packed_i.padded_nnz
    nbytes = slots * 12 + 2 * (n_users + n_items) * k * elem
    flops = slots * (2 * k * k + 2 * k) + (n_users + n_items) * (
        k ** 3 / 3 + 2 * k * k)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "padded_slots": slots,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
        "gather_bytes": slots * k * elem,
        "gather_ms_at_peak": slots * k * elem / PEAK_BYTES_S * 1e3,
    }


def train_full_width(device, data, packs, compute: str, seed: int) -> dict:
    """One ALS run through ``train_als`` at full width, its residual
    checks, then the epoch timed and profiled on the same geometry."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    rows, cols, vals = data
    n_users, n_items, _ = ML20M
    ctx = ComputeContext.create(device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f = als.train_als(ctx, rows, cols, vals, n_users, n_items, rank=RANK,
                      iterations=TRAIN_EPOCHS, reg=TRAIN_REG,
                      alpha=TRAIN_ALPHA, implicit=True,
                      compute_dtype=compute)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_bytes
    for name, m in (("user", f.user_factors), ("item", f.item_factors)):
        assert m.shape[1] == RANK and np.isfinite(m).all(), (compute, name)

    packed_u, packed_i = packs["native"]
    cdt = als._resolve_compute(compute)
    solve_u = als.make_solve_side(ctx, packed_u, True, TRAIN_ALPHA, compute)
    solve_i = als.make_solve_side(ctx, packed_i, True, TRAIN_ALPHA, compute)
    items_dev = torch.from_numpy(f.item_factors).to(device)
    users_next = solve_u(items_dev, TRAIN_REG).cpu().numpy()

    # residuals: every heavy item, sampled items, sampled users
    rng = np.random.default_rng(seed + 3)
    by_item = _rows_by(cols, n_items)
    deg = np.diff(by_item[1])
    heavy = np.nonzero(deg > 16 * 64)[0]  # s_max blocks of block_len
    # rows with no interactions solve to zero against b = 0: no residual
    light = np.nonzero((deg > 0) & (deg <= 16 * 64))[0]
    sampled = rng.choice(light, min(RESIDUAL_SAMPLE, len(light)),
                         replace=False)
    t0 = time.perf_counter()
    heavy_max, heavy_med = max_residual(
        f.item_factors, heavy, f.user_factors, rows, vals, by_item, cdt)
    item_max, item_med = max_residual(
        f.item_factors, sampled, f.user_factors, rows, vals, by_item, cdt)
    by_user = _rows_by(rows, n_users)
    users = rng.choice(np.nonzero(np.diff(by_user[1]))[0],
                       RESIDUAL_SAMPLE, replace=False)
    user_max, user_med = max_residual(
        users_next, users, f.item_factors, cols, vals, by_user, cdt)
    check_s = time.perf_counter() - t0
    for what, r in (("heavy items", heavy_max), ("items", item_max),
                    ("users", user_max)):
        assert r <= RESIDUAL_TOL, f"{compute}: {what} residual {r:.3g}"

    # the epoch, timed apart (CUDA events, no wait between epochs)
    step = als.make_train_step(solve_u, solve_i)
    x = torch.zeros((packed_u.n_rows_padded, RANK), device=device)
    y = items_dev.clone()
    torch.cuda.synchronize()
    epoch_ms = []
    for _ in range(TRAIN_EPOCHS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        x, y = step(x, y, TRAIN_REG, 1)
        stop.record()
        epoch_ms.append((start, stop))
    torch.cuda.synchronize()
    epoch_ms = [a.elapsed_time(b) for a, b in epoch_ms]
    split_u = profile_half_step(solve_u, y, TRAIN_REG)
    split_i = profile_half_step(solve_i, x, TRAIN_REG)
    bound = epoch_bound(packed_u, packed_i, n_users, n_items, RANK,
                        2 if cdt is torch.bfloat16 else 4)
    median = float(np.median(epoch_ms[1:]))
    return {
        "compute": compute,
        "train_als_s": train_s,
        "epoch_ms": epoch_ms,
        "epoch_ms_median_2_5": median,
        "peak_bytes": peak,
        "user_half_step": split_u,
        "item_half_step": split_i,
        "bound": bound,
        "bound_share": bound["bound_ms"] / median,
        "heavy_items": int(len(heavy)),
        "residual_max": {"heavy_items": heavy_max, "items": item_max,
                         "users": user_max},
        "residual_median": {"heavy_items": heavy_med, "items": item_med,
                            "users": user_med},
        "residual_check_s": check_s,
    }


def train_phase(device, seed: int) -> dict:
    n_users, n_items, nnz = ML20M
    t0 = time.perf_counter()
    data = make_interactions(n_users, n_items, nnz, seed=42)
    gen_s = time.perf_counter() - t0
    packs = pack_sides(*data, n_users, n_items)
    log(f"train data: {nnz} interactions in {gen_s:.2f} s; pack native "
        f"{packs['native_s']:.3f} s, numpy {packs['numpy_s']:.3f} s "
        f"(identical); padded slots user "
        f"{packs['native'][0].padded_nnz} item "
        f"{packs['native'][1].padded_nnz}, heavy sub-row groups "
        f"{len(packs['native'][1].heavy)}")
    out = {"pack_native_s": packs["native_s"],
           "pack_numpy_s": packs["numpy_s"]}
    for compute in ("float32", "bfloat16"):
        run = train_full_width(device, data, packs, compute, seed)
        log("train " + json.dumps(run))
        out[compute] = run
    return out


# -- phase 7: the DASE path end to end ------------------------------------------


def train_and_serve(device, storage, app_name: str, engine_id: str,
                    seed: int) -> dict:
    """The port's ``run_train`` on the app's events → ``create_engine_server``
    on the published generation → 165 HTTP queries for users it trained
    (64 singles on 8 threads, one unknown user, one batch of 100), each
    answer held
    against the plain top-k on the trained factors. The kernel's launch
    counts are set to 0 before the server starts and read after it
    stops."""
    from predictionio_tpu_torch.core.persistence import (
        deserialize_models,
        load_generation,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )

    engine = recommendation_engine()
    params = engine.params_from_variant({
        "datasource": {"params": {"app_name": app_name}},
        "algorithms": [{"name": "als", "params": {}}],
    })
    ctx = ComputeContext.create(device=device)
    # the data source reads through the process-default storage
    set_storage(storage)
    try:
        t0 = time.perf_counter()
        iid = run_train(engine, params, engine_id, ctx=ctx, storage=storage)
        run_train_s = time.perf_counter() - t0
    finally:
        set_storage(None)
    instance = storage.get_meta_data_engine_instances().get(iid)
    assert instance.status == "COMPLETED", instance.status
    assert instance.mesh_conf["platform"] == device.type, instance.mesh_conf
    timing = json.loads(instance.env["timing"])
    (model,) = [m for _tag, m in deserialize_models(
        load_generation(storage.get_model_data_models(), iid))]
    n_trained = len(model.item_map)
    assert model.item_factors.shape == (n_trained, RANK)
    assert np.isfinite(model.item_factors).all()
    assert np.isfinite(model.user_factors).all()

    fused_topk.reset_launch_counts()
    es, http = create_engine_server(
        engine, params, engine_id, host="127.0.0.1", port=0,
        storage=storage, ctx=ctx, max_batch=64, max_wait_ms=2.0,
    )
    http.start()
    try:
        base = f"http://127.0.0.1:{http.port}"
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            status = json.loads(resp.read())
        assert status["engineInstanceId"] == iid, status
        rng = np.random.default_rng(seed + 11)
        users = rng.choice(model.user_map.keys(), 164).tolist()
        nums = [1, 5, 10, 20, 50, 128]
        singles = [{"user": u, "num": nums[i % len(nums)]}
                   for i, u in enumerate(users[:64])]
        singles.append({"user": "nobody", "num": 10})
        answers = []
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(_post, base, "/queries.json", q)
                    for q in singles]
            answers += [(q, f.result()[0]) for q, f in zip(singles, futs)]
        batch = [{"user": u, "num": 10} for u in users[64:]]
        out, _ = _post(base, "/batch/queries.json", batch)
        assert all(r["status"] == 200 for r in out), out[:3]
        answers += [(q, r["prediction"]) for q, r in zip(batch, out)]
    finally:
        es.close()
    launches = dict(fused_topk.LAUNCHES)
    assert launches["f32"] > 0, "the trained model served without the kernel"

    user_f = torch.as_tensor(model.user_factors).to(device)
    item_f = torch.as_tensor(model.item_factors).to(device)
    n_checked, n_ties, max_err = 0, 0, 0.0
    for q, ans in answers:
        uid = model.user_map.get(q["user"], -1)
        if uid < 0:
            assert ans == {"itemScores": []}, ans
            continue
        n = min(q["num"], n_trained)
        assert len(ans["itemScores"]) == n, (q, len(ans["itemScores"]))
        got_i = torch.tensor(
            [[model.item_map(e["item"]) for e in ans["itemScores"]]],
            dtype=torch.int32, device=device,
        )
        got_s = torch.tensor([[e["score"] for e in ans["itemScores"]]],
                             device=device)
        qv = user_f[uid:uid + 1]
        want = fused_topk.fused_top_k_dot_reference(qv, item_f, n)
        res = compare(qv, item_f, None, None, n, (got_s, got_i), want)
        n_checked += 1
        n_ties += res["tied_mismatches"]
        max_err = max(max_err, res["max_abs_err"])
    assert n_checked == 164, n_checked
    return {
        "run_train_s": run_train_s,
        "read_s": timing["train/read"]["total_s"],
        "prepare_s": timing["train/prepare"]["total_s"],
        "train_s": timing["train/algorithm"]["total_s"],
        "persist_s": timing["train/persist"]["total_s"],
        "users_trained": len(model.user_map),
        "items_trained": n_trained,
        "answers_checked": n_checked,
        "tied_mismatches": n_ties,
        "max_abs_err": max_err,
        "launches": launches,
    }


def dase_phase(device, store_dir: str, seed: int) -> dict:
    """Events into a memory event store, then :func:`train_and_serve`;
    returns the phase's numbers and the store (phase 9 evaluates on it)."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage

    n_users, n_items, n_events = DASE
    rows, cols, vals = make_interactions(n_users, n_items, n_events, seed=42)
    storage = Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": store_dir,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_id = storage.get_meta_data_apps().insert(App(0, "chip-smoke"))
    events = storage.get_events()
    events.init(app_id)
    t0 = time.perf_counter()
    events.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": float(r)})
        for u, i, r in zip(rows.tolist(), cols.tolist(), vals.tolist())
    ], app_id)
    insert_s = time.perf_counter() - t0
    out = {"events": n_events, "insert_s": insert_s}
    out.update(train_and_serve(device, storage, "chip-smoke",
                               "chip-smoke-dase", seed))
    return out, storage


# -- phase 8: the event server and its stores ----------------------------------


def _http_call(conn, method: str, path: str, body=None):
    """One request on a keep-alive ``http.client`` connection."""
    data = body if body is None or isinstance(body, bytes) else (
        json.dumps(body).encode())
    headers = {"Content-Type": "application/json"} if data else {}
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b"null")


def ingest_phase(device, tmpdir: str, backend: str, n_events: int,
                 seed: int) -> dict:
    """``rate`` events over HTTP into the port's event server, on sqlite
    metadata and an ``eventlog`` or ``sqlite`` event store; the probes;
    the training read through ``EventStore.interactions``, held against
    the generator's triples; then :func:`train_and_serve`."""
    import http.client

    from predictionio_tpu_torch.data.storage import (
        AccessKey,
        AccessKeysBackend,
        App,
        Storage,
    )
    from predictionio_tpu_torch.data.storage.eventlog import EventLogEvents
    from predictionio_tpu_torch.data.store import EventStore
    from predictionio_tpu_torch.serving.event_server import (
        create_event_server,
    )

    n_users, n_items, _ = DASE
    rows, cols, vals = (a[:n_events] for a in make_interactions(
        n_users, n_items, DASE[2], seed=42))
    storage = Storage(env={
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(tmpdir, "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(tmpdir, "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(tmpdir, "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE":
            "LOG" if backend == "eventlog" else "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_name = "chip-smoke-ingest"
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    keys = storage.get_meta_data_access_keys()
    key = keys.insert(AccessKey(AccessKeysBackend.generate_key(), app_id))
    limited = keys.insert(AccessKey("", app_id, ("view",)))
    storage.get_events().init(app_id)
    bodies = [
        json.dumps([
            {"event": "rate", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{i}",
             "properties": {"rating": r}}
            for u, i, r in zip(rows[lo:lo + INGEST_BATCH].tolist(),
                               cols[lo:lo + INGEST_BATCH].tolist(),
                               vals[lo:lo + INGEST_BATCH].tolist())
        ]).encode()
        for lo in range(0, n_events, INGEST_BATCH)
    ]

    server = create_event_server(host="127.0.0.1", port=0, storage=storage,
                                 stats=True)
    server.start()
    try:
        def client(part: int):
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=120)
            out = []
            try:
                for b in range(part, len(bodies), INGEST_THREADS):
                    t0 = time.perf_counter()
                    status, res = _http_call(
                        conn, "POST", f"/batch/events.json?accessKey={key}",
                        bodies[b])
                    out.append((b, time.perf_counter() - t0, status, res))
            finally:
                conn.close()
            return out

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(INGEST_THREADS) as pool:
            parts = [f.result() for f in
                     [pool.submit(client, p) for p in range(INGEST_THREADS)]]
        ingest_s = time.perf_counter() - t0
        results = sorted(r for part in parts for r in part)
        assert len(results) == len(bodies)
        for _b, _s, status, res in results:
            assert status == 200, (status, res)
            assert [r["status"] for r in res] == [201] * len(res), res[:3]
        first_id = results[0][3][0]["eventId"]
        lat_ms = np.array([s for _b, s, _st, _r in results]) * 1e3

        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        try:
            one = [{"event": "rate", "entityType": "user", "entityId": "x",
                    "targetEntityType": "item", "targetEntityId": "y"}]
            probes = {
                "missing_key": _http_call(conn, "POST", "/events.json",
                                          one[0])[0],
                "limited_key": _http_call(
                    conn, "POST", f"/events.json?accessKey={limited}",
                    one[0])[0],
                "batch_of_51": _http_call(
                    conn, "POST", f"/batch/events.json?accessKey={key}",
                    one * 51)[0],
            }
            status, latest = _http_call(
                conn, "GET", f"/events.json?accessKey={key}&limit=5"
                "&reversed=true")
            probes["find_latest_5"] = status
            assert len(latest) == 5, latest
            path = f"/events/{first_id}.json?accessKey={key}"
            probes["get"] = _http_call(conn, "GET", path)[0]
            probes["delete"] = _http_call(conn, "DELETE", path)[0]
            probes["get_deleted"] = _http_call(conn, "GET", path)[0]
            status, stats = _http_call(conn, "GET",
                                       f"/stats.json?accessKey={key}")
        finally:
            conn.close()
    finally:
        server.shutdown()
    assert probes == {"missing_key": 401, "limited_key": 403,
                      "batch_of_51": 400, "find_latest_5": 200, "get": 200,
                      "delete": 200, "get_deleted": 404}, probes
    assert status == 200 and stats["statusCount"]["201"] == n_events, stats

    # the training read: the log's native scan, or sqlite's frame path
    events_backend = storage.get_events()
    assert isinstance(events_backend, EventLogEvents) == (
        backend == "eventlog"), type(events_backend)
    assert hasattr(events_backend, "interactions") == (backend == "eventlog")
    t0 = time.perf_counter()
    inter = EventStore(storage).interactions(app_name, value_key="rating")
    read_s = time.perf_counter() - t0
    got = np.stack([
        np.char.lstrip(inter.entity_map.decode(inter.rows), "u").astype(
            np.int64),
        np.char.lstrip(inter.target_map.decode(inter.cols), "i").astype(
            np.int64),
        inter.values.astype(np.int64),
    ])
    # the deleted event was the first batch's first
    want = np.stack([rows[1:], cols[1:], vals[1:]]).astype(np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got[:, np.lexsort(got[::-1])],
                          want[:, np.lexsort(want[::-1])]), "triples differ"

    out = {
        "backend": backend,
        "events": n_events,
        "batch_requests": len(bodies),
        "ingest_s": ingest_s,
        "events_per_s": n_events / ingest_s,
        "batch_p50_ms": float(np.percentile(lat_ms, 50)),
        "batch_p99_ms": float(np.percentile(lat_ms, 99)),
        "interactions_read_s": read_s,
        "probes": probes,
    }
    out.update(train_and_serve(device, storage, app_name,
                               f"chip-smoke-ingest-{backend}", seed))
    return out


# -- phase 9: evaluation ---------------------------------------------------

#: the recommendation example's grid (examples/recommendation/evaluation.py)
EVAL_K, EVAL_RANKS, EVAL_ITERATIONS = 3, (8, 16, 32), 5


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def check_batch(device, model, queries, answers) -> dict:
    """Hold one fold's batch answers against the plain top-k on the card
    on the fold's trained factors, a group for each answer length."""
    from predictionio_tpu_torch.ops import fused_topk

    n_items = len(model.item_map)
    groups: dict[int, list] = {}
    for q, ans in zip(queries, answers):
        uid = model.user_map.get(q["user"], -1)
        assert uid >= 0, q  # every fold keeps the full user map
        n = min(q["num"], n_items)
        assert len(ans["itemScores"]) == n, (q, len(ans["itemScores"]))
        groups.setdefault(n, []).append((uid, ans))
    n_ties, max_err = 0, 0.0
    for n, rows in groups.items():
        uids = torch.tensor([u for u, _a in rows], device=device)
        got_i = torch.tensor(
            [[model.item_map(e["item"]) for e in a["itemScores"]]
             for _u, a in rows], dtype=torch.int32, device=device)
        got_s = torch.tensor([[e["score"] for e in a["itemScores"]]
                              for _u, a in rows], device=device)
        qv = model.user_factors[uids]
        want = fused_topk.fused_top_k_dot_reference(
            qv, model.item_factors, n)
        res = compare(qv, model.item_factors, None, None, n,
                      (got_s, got_i), want)
        n_ties += res["tied_mismatches"]
        max_err = max(max_err, res["max_abs_err"])
    return {"answers_checked": len(queries), "tied_mismatches": n_ties,
            "max_abs_err": max_err}


def time_eval_shape(device, model, queries) -> dict:
    """The kernel at one fold's batch shape (the users padded to the
    batch bucket, the catalog, the num bucket), as ``batch_predict``
    launches it, beside its bound, its plain version and
    ``torch.topk(q @ items.T)``."""
    from predictionio_tpu_torch.ops import fused_topk

    n_items = len(model.item_map)
    idx = [model.user_map(q["user"]) for q in queries]
    bucket = _pow2(len(idx))
    idx = torch.tensor(idx + [0] * (bucket - len(idx)), device=device)
    num = min(_pow2(min(max(q["num"] for q in queries), n_items)), n_items)
    q = model.user_factors[idx].contiguous()
    items = model.item_factors
    k = items.shape[1]

    def kernel():
        return fused_topk.fused_top_k_dot(q, items, num)

    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = fused_topk.plan_pass1(bucket, n_items, num, k, 4, n_sms)
    assert plan.splits == 1, plan
    # CUDA events around back-to-back calls: at this batch a call's
    # launches queue behind the running kernel, so the device sets the
    # time. The profiler's pass split is printed beside it: run after
    # the evaluation it has missed some of pass 1's launches (0.31 ms
    # of a 0.89 ms call at rank 32), so it is not the kernel's time here.
    ms = time_ms(kernel, reps=20)
    pass1_ms = device_ms(kernel, reps=5, name_part="topk_pass1")
    pass2_ms = device_ms(kernel, reps=5, name_part="topk_pass2")
    plain_ms = time_ms(lambda: fused_topk.fused_top_k_dot_reference(
        q, items, num), reps=2, warmup=1)
    library_ms = time_ms(lambda: torch.topk(q @ items.T, num), reps=5,
                         warmup=1)
    bound_ms, bound_by = bound(bucket, n_items, k, num, items, None)
    return {"rank": k, "batch": len(queries), "bucket": bucket,
            "items": n_items, "num": num, "ms": ms, "pass1_ms": pass1_ms,
            "pass2_ms": pass2_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "plan": dataclasses.asdict(plan)}


def eval_phase(device, storage, app_name: str, out_dir: str) -> dict:
    """``run_evaluation`` over the example's grid on the app's events,
    through a ``FastEvalEngine`` whose caches then give every fold's
    staged model and batch answers to check."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.evaluation import (
        AverageMetric,
        Evaluation,
    )
    from predictionio_tpu_torch.core.fasteval import FastEvalEngine
    from predictionio_tpu_torch.core.workflow import run_evaluation
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.models.recommendation import (
        ALSParams,
        RecDataSourceParams,
        RecPreparatorParams,
        recommendation_engine,
    )
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    class PrecisionAtK(AverageMetric):
        """The example's metric: the share of the top k recommendations
        that are held-out items."""

        def __init__(self, k: int = 10):
            self.k = k

        def calculate_point(self, eval_info, query, prediction, actual):
            top = [s["item"] for s in prediction["itemScores"][: self.k]]
            if not top:
                return 0.0
            return len(set(top) & set(actual)) / float(self.k)

    grid = [
        EngineParams(
            data_source=("", RecDataSourceParams(app_name=app_name,
                                                 eval_k=EVAL_K)),
            preparator=("", RecPreparatorParams()),
            algorithms=[("als", ALSParams(rank=rank,
                                          num_iterations=EVAL_ITERATIONS))],
        )
        for rank in EVAL_RANKS
    ]
    engine = FastEvalEngine.from_engine(recommendation_engine())
    best_path = os.path.join(out_dir, "best.json")
    evaluation = Evaluation(engine=engine, metric=PrecisionAtK(10),
                            engine_params_list=grid, output_path=best_path)
    events = storage.get_events()
    scans = []
    real_find = events.find

    def counting_find(*args, **kwargs):
        scans.append(1)
        return real_find(*args, **kwargs)

    events.find = counting_find
    fused_topk.reset_launch_counts()
    set_storage(storage)
    try:
        t0 = time.perf_counter()
        iid, result = run_evaluation(
            evaluation, ctx=ComputeContext.create(device=device),
            storage=storage)
        eval_s = time.perf_counter() - t0
    finally:
        set_storage(None)
        del events.find
    launches = dict(fused_topk.LAUNCHES)
    instance = storage.get_meta_data_evaluation_instances().get(iid)
    assert instance.status == "EVALCOMPLETED", instance.status
    with open(best_path) as f:
        best = json.load(f)
    assert best["algorithms"][0]["params"]["rank"] == EVAL_RANKS[
        result.best_idx], best
    assert len(scans) == 1, f"the event store was scanned {len(scans)} times"
    assert launches["f32"] == EVAL_K * len(EVAL_RANKS), launches

    folds = engine._data_source_cache[("ds", grid[0].data_source)].result()
    fold_rows, timings = [], []
    for params in grid:
        algo_pair = tuple(params.algorithms)[0]
        for fold, (_td, info, qa) in enumerate(folds):
            _algo, model = engine._algorithms_cache[(
                "algo", params.data_source, params.preparator, algo_pair,
                fold)].result()
            answers = engine._predict_cache[(
                "pred", params.data_source, params.preparator, algo_pair,
                params.serving, fold)].result()
            assert model.item_factors.device == device
            queries = [q for q, _a in qa]
            row = {"rank": algo_pair[1].rank, "fold": info["fold"],
                   "batch": len(queries), "bucket": _pow2(len(queries)),
                   "num_bucket": min(_pow2(max(q["num"] for q in queries)),
                                     len(model.item_map))}
            row.update(check_batch(device, model, queries, answers))
            fold_rows.append(row)
            if fold == 0:
                timings.append(time_eval_shape(device, model, queries))
    return {
        "instance": iid,
        "eval_s": eval_s,
        "precision": {str(p.algorithms[0][1].rank): s.score
                      for p, s in result.engine_params_scores},
        "best_rank": EVAL_RANKS[result.best_idx],
        "cache_hits": dict(engine.cache_hits),
        "event_store_scans": len(scans),
        "folds": fold_rows,
        "timings": timings,
        "launches": launches,
    }


# -- phase 10: the similar-product template ---------------------------------

#: (event name, events, generator seed) of the phase's two signals
SIMILAR_SIGNALS = (("view", 200_000, 43), ("like", 40_000, 44))
N_CATEGORIES = 20
SIMILAR_REQUESTS = 128


def similar_queries(item_ids, seed: int) -> list:
    """Baskets of 1-8 known items, num 10 or 20; a third carry 1-2
    categories, some a whiteList or a blackList; the last names only
    unknown items."""
    rng = np.random.default_rng(seed + 46)
    out = []
    for j in range(SIMILAR_REQUESTS - 1):
        q = {"items": rng.choice(item_ids, int(rng.integers(1, 9)),
                                 replace=False).tolist(),
             "num": int(rng.choice([10, 20]))}
        if j % 3 == 0:
            q["categories"] = [f"c{c}" for c in rng.choice(
                N_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        if j % 5 == 1:
            q["whiteList"] = rng.choice(item_ids, len(item_ids) // 12,
                                        replace=False).tolist()
        if j % 7 == 2:
            q["blackList"] = rng.choice(item_ids, len(item_ids) // 100,
                                        replace=False).tolist()
        out.append(q)
    out.append({"items": ["unknown-a", "unknown-b"], "num": 10})
    return out


def plain_similar(query, staged) -> tuple[dict, int]:
    """The served answer's plain combination on the card: per algorithm
    the basket's mean row, both sides normalized, the plain top-k over
    the candidate pool, the filters; then the scores summed per item.

    The filters keep items from deep in the pool, so an item that ties
    another at the pool's last slot (trained factors put many cosines
    within a few ulps of each other) decides which survive. The kernel
    is deterministic: its list for the basket, replayed on the staged
    model as served, is held against the plain top-k by the tie rule,
    and its order settles those ties; every score summed is the plain
    one. Returns every item's summed score and the tied swaps."""
    from predictionio_tpu_torch.ops.fused_topk import (
        fused_top_k_dot_reference,
    )
    from predictionio_tpu_torch.ops.similarity import (
        gather_mean_top_k_cosine,
        l2_normalize,
    )

    num = query["num"]
    cats = set(query.get("categories") or [])
    white = set(query.get("whiteList") or [])
    black = set(query.get("blackList") or []) | set(query["items"])
    combined: dict[str, float] = {}
    ties = 0
    for model in staged:
        n_items = len(model.item_map)
        idx = [i for i in (model.item_map.get(it, -1)
                           for it in query["items"]) if i >= 0]
        if not idx:
            continue
        pool = min(_pow2(num + len(idx)), n_items)
        table = model.item_factors[:n_items]
        qn = l2_normalize(table[torch.tensor(idx, device=table.device)].mean(
            0, keepdim=True))
        tn = l2_normalize(table)
        want = fused_top_k_dot_reference(qn, tn, pool)
        basket = np.full(_pow2(len(idx)), -1, np.int32)
        basket[:len(idx)] = idx
        got = gather_mean_top_k_cosine(model.item_factors, basket, pool,
                                       mask=model.item_phantom_mask)
        ties += compare(qn, tn, None, None, pool, got, want)[
            "tied_mismatches"]
        cand = got[1][0].long()
        scores = (qn * tn[cand]).sum(1)
        kept = 0
        for score, ci in zip(scores.tolist(), cand.tolist()):
            item = model.item_map.inverse(ci)
            if item in black or (white and item not in white):
                continue
            if cats and not cats & set(model.item_categories.get(item, [])):
                continue
            combined[item] = combined.get(item, 0.0) + score
            kept += 1
            if kept >= num:
                break
    return combined, ties


def check_similar(answer, combined, num) -> int:
    """The served list against the plain combination: the same length,
    scores slot by slot within ATOL + RTOL*|s|, and an item that differs
    from the plain one at its slot only where the two tie. Returns the
    tied swaps."""
    want = sorted(combined.items(), key=lambda kv: kv[1], reverse=True)
    want = want[:num]
    got = answer["itemScores"]
    assert len(got) == len(want), (got, want)
    swaps = 0
    for g, (w_item, w_score) in zip(got, want):
        tol = ATOL + RTOL * abs(w_score)
        assert abs(g["score"] - w_score) <= tol, (g, w_item, w_score)
        if g["item"] != w_item:
            assert g["item"] in combined, g
            assert abs(combined[g["item"]] - w_score) <= tol, (g, w_item)
            swaps += 1
    return swaps


def check_quantized_cosine(table, queries, item_map, device) -> dict:
    """``gather_mean_top_k_cosine`` on int8 and bf16 tables of trained
    factors against the plain version on the same tables."""
    from predictionio_tpu_torch.ops import fused_topk, quantize
    from predictionio_tpu_torch.ops.similarity import (
        gather_mean_top_k_cosine,
        l2_normalize,
    )

    out = {}
    for mode in ("int8", "bf16"):
        qf = quantize.quantize_factors(table, mode)
        normed = quantize.normalized(qf)
        worst, ties = 0.0, 0
        for query in queries[:32]:
            idx = [item_map(it) for it in query["items"]]
            basket = np.full(_pow2(len(idx)), -1, np.int32)
            basket[:len(idx)] = idx
            k = min(_pow2(query["num"] + len(idx)), len(item_map))
            got = gather_mean_top_k_cosine(qf, basket, k)
            torch.cuda.synchronize()
            qv = l2_normalize(quantize.gather_rows(qf, idx).mean(
                0, keepdim=True))
            want = fused_topk.fused_top_k_dot_reference(
                qv, normed.data, k, None, normed.scale)
            res = compare(qv, normed.data.float(), normed.scale, None, k,
                          got, want)
            worst = max(worst, res["max_abs_err"])
            ties += res["tied_mismatches"]
        out[mode] = {"max_abs_err": worst, "tied_mismatches": ties}
    return out


def similar_phase(device, store_dir: str, seed: int) -> dict:
    """The similar-product template from events to served answers."""
    from predictionio_tpu_torch.core.persistence import (
        deserialize_models,
        load_generation,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage, set_storage
    from predictionio_tpu_torch.models.similarproduct import (
        similarproduct_engine,
    )
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.ops.similarity import (
        gather_mean_top_k_cosine,
        l2_normalize,
    )
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )

    with open(os.path.join(ROOT, "examples", "similarproduct",
                           "engine.json")) as f:
        variant = json.load(f)
    app_name = variant["datasource"]["params"]["app_name"]
    n_users, n_items, _ = DASE
    storage = Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": store_dir,
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(seed + 45)
    batch = []
    for name, n, data_seed in SIMILAR_SIGNALS:
        rows, cols, _vals = make_interactions(n_users, n_items, n,
                                              seed=data_seed)
        batch += [Event(event=name, entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}")
                  for u, i in zip(rows.tolist(), cols.tolist())]
    batch += [
        Event(event="$set", entity_type="item", entity_id=f"i{i}",
              properties={"categories": [f"c{c}" for c in rng.choice(
                  N_CATEGORIES, int(rng.integers(1, 4)), replace=False)]})
        for i in range(n_items)
    ]
    t0 = time.perf_counter()
    events.insert_batch(batch, app_id)
    insert_s = time.perf_counter() - t0

    engine = similarproduct_engine()
    params = engine.params_from_variant(variant)
    assert [(p.event_name, p.rank) for _n, p in params.algorithms] == [
        ("view", 16), ("like", 16)], params.algorithms
    ctx = ComputeContext.create(device=device)
    set_storage(storage)
    try:
        t0 = time.perf_counter()
        iid = run_train(engine, params, "chip-smoke-similar", ctx=ctx,
                        storage=storage)
        run_train_s = time.perf_counter() - t0
    finally:
        set_storage(None)
    instance = storage.get_meta_data_engine_instances().get(iid)
    assert instance.status == "COMPLETED", instance.status
    timing = json.loads(instance.env["timing"])
    models = [m for _t, m in deserialize_models(
        load_generation(storage.get_model_data_models(), iid))]
    assert len(models) == 2
    view, like = models
    assert view.item_map.keys().tolist() == like.item_map.keys().tolist()
    assert view.item_categories == like.item_categories
    assert len(view.item_categories) == n_items
    for m in models:
        assert m.item_factors.shape == (len(m.item_map), 16)
        assert np.isfinite(m.item_factors).all()

    queries = similar_queries(view.item_map.keys(), seed)
    fused_topk.reset_launch_counts()
    es, http = create_engine_server(
        engine, params, "chip-smoke-similar", host="127.0.0.1", port=0,
        storage=storage, ctx=ctx, max_batch=64, max_wait_ms=2.0,
    )
    http.start()
    try:
        base = f"http://127.0.0.1:{http.port}"
        answers, lat = [], []
        for q in queries:
            out, s = _post(base, "/queries.json", q)
            answers.append(out)
            lat.append(s)
    finally:
        es.close()
    launches = dict(fused_topk.LAUNCHES)
    # one launch an algorithm for every query naming a known item
    assert launches["f32"] == 2 * (len(queries) - 1), launches

    staged = [algo.stage_model(ctx, m)
              for algo, m in zip(engine.make_algorithms(params), models)]
    tables = [m.item_factors[:len(m.item_map)] for m in staged]
    swaps, pool_ties, empty = 0, 0, 0
    for q, ans in zip(queries, answers):
        try:
            combined, ties = plain_similar(q, staged)
            pool_ties += ties
            if not combined:
                assert ans == {"itemScores": []}, ans
                empty += 1
                continue
            swaps += check_similar(ans, combined, q["num"])
        except AssertionError as e:
            raise AssertionError(f"query {q}: {e}") from e
    assert answers[-1] == {"itemScores": []}
    quantized = check_quantized_cosine(tables[0], queries, view.item_map,
                                       device)

    # the catalog's normalization (a torch pass before each launch)
    # beside the kernel at one query's shape
    basket = np.full(8, -1, np.int32)
    basket[:5] = np.arange(5)  # five items, padded to eight
    norm_ms = time_ms(lambda: l2_normalize(tables[0]), reps=50)
    qv = l2_normalize(tables[0][:1])
    normed = l2_normalize(tables[0])

    def kernel():
        return fused_topk.fused_top_k_dot(qv, normed, 32)

    kernel_ms = (device_ms(kernel, reps=20, name_part="topk_pass1")
                 + device_ms(kernel, reps=20, name_part="topk_pass2"))
    query_ms = time_ms(lambda: gather_mean_top_k_cosine(
        tables[0], basket, 32), reps=20)
    lat_ms = sorted(s * 1e3 for s in lat)
    return {
        "events": sum(n for _name, n, _s in SIMILAR_SIGNALS),
        "items": n_items,
        "insert_s": insert_s,
        "run_train_s": run_train_s,
        "read_s": timing["train/read"]["total_s"],
        "train_s": timing["train/algorithm"]["total_s"],
        "persist_s": timing["train/persist"]["total_s"],
        "requests": len(queries),
        "answers_checked": len(queries) - empty,
        "tied_swaps": swaps,
        "pool_tied_swaps": pool_ties,
        "p50_ms": lat_ms[len(lat_ms) // 2],
        "launches": launches,
        "quantized": quantized,
        "normalize_ms": norm_ms,
        "kernel_ms_b1": kernel_ms,
        "cosine_call_ms": query_ms,
    }


# -- main ---------------------------------------------------------------------


def log_ingest(ingest: dict, dase: dict) -> None:
    for backend, run in ingest.items():
        log(f"ingest {backend}: {run['events']} events in "
            f"{run['batch_requests']} batch requests, "
            f"{run['events_per_s']:.0f} events/s, batch p50 "
            f"{run['batch_p50_ms']:.2f} ms p99 {run['batch_p99_ms']:.2f} ms")
    log(f"interactions read: eventlog native scan "
        f"{ingest['eventlog']['interactions_read_s']:.3f} s "
        f"({DASE[2]} events), sqlite frame path "
        f"{ingest['sqlite']['interactions_read_s']:.3f} s "
        f"({SQLITE_EVENTS} events), memory frame path (phase 7) "
        f"{dase['read_s']:.3f} s ({DASE[2]} events)")
    for backend, run in ingest.items():
        log(f"ingest {backend} train: read {run['read_s']:.3f} s, prepare "
            f"{run['prepare_s']:.3f} s, train {run['train_s']:.3f} s, "
            f"persist {run['persist_s']:.3f} s; answers checked "
            f"{run['answers_checked']}, tied swaps {run['tied_mismatches']}, "
            f"max score error {run['max_abs_err']:.3g}, f32 launches "
            f"{run['launches']['f32']}")


def nvidia_smi_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from predictionio_tpu_torch.ops import _build, fused_topk
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library("fused_topk")
    log(f"build fused_topk: {time.perf_counter() - t0:.2f} s")
    report = _build.library_path("fused_topk").with_suffix(".log")
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    worst = check_kernels(device, N_ITEMS, RAGGED_ITEMS, RANK, args.seed,
                          fused_topk.NUM_CAP)
    log(f"phase kernels: ok ({time.perf_counter() - t_start:.1f} s)")

    model = make_model(N_USERS, N_ITEMS, RANK, args.seed)
    table_f32 = torch.as_tensor(model.item_factors).to(device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as store:
        storage, blob_bytes = publish(model, store)
        log(f"published generation: {blob_bytes} bytes")
        fused_topk.reset_launch_counts()
        runs = [
            serve_and_check(storage, model, table_f32, quantize, device,
                            args.seed, N_USERS)
            for quantize in ("", "int8", "bf16")
        ]
        launches = dict(fused_topk.LAUNCHES)
    for run in runs:
        log("serve " + json.dumps(run))
    for form in FORMS:
        assert launches[form] > 0, f"{form}: never launched on the main path"
    log(f"main path launches: {json.dumps(launches)}")
    log(f"phase main path: ok ({time.perf_counter() - t_start:.1f} s)")

    times = time_forms(table_f32, device, args.seed)
    for run in runs:
        log(f"http {run['form']}: p50_ms={run['p50_ms']:.3f} "
            f"batch_request_ms={run['batch_request_ms']:.3f} "
            f"startup_s={run['startup_s']:.2f}")
    del model, table_f32
    log(f"phase timings: ok ({time.perf_counter() - t_start:.1f} s)")

    train_phase(device, args.seed)
    log(f"phase train: ok ({time.perf_counter() - t_start:.1f} s)")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-dase-") as store:
        dase, dase_storage = dase_phase(device, store, args.seed)
        log("dase " + json.dumps(dase))
        log(f"phase dase: ok ({time.perf_counter() - t_start:.1f} s)")
        # phase 8 runs while phase 7's store stays open: phase 9
        # evaluates on it
        ingest = {}
        for backend, n in (("eventlog", DASE[2]), ("sqlite", SQLITE_EVENTS)):
            with tempfile.TemporaryDirectory(prefix="chip-smoke-ingest-") as d:
                ingest[backend] = ingest_phase(device, d, backend, n,
                                               args.seed)
            log("ingest " + json.dumps(ingest[backend]))
        log_ingest(ingest, dase)
        log(f"phase ingest: ok ({time.perf_counter() - t_start:.1f} s)")
        evaluation = eval_phase(device, dase_storage, "chip-smoke", store)
        del dase_storage
    log("eval " + json.dumps(evaluation))
    log(f"eval precision@10 by rank: {json.dumps(evaluation['precision'])}; "
        f"best rank {evaluation['best_rank']}; {evaluation['eval_s']:.2f} s; "
        f"event store scans {evaluation['event_store_scans']}; f32 launches "
        f"{evaluation['launches']['f32']}")
    for row in evaluation["folds"]:
        log(f"eval fold: rank {row['rank']} fold {row['fold']} batch "
            f"{row['batch']} bucket {row['bucket']} num bucket "
            f"{row['num_bucket']}: {row['answers_checked']} answers equal "
            f"to the plain top-k, tied swaps {row['tied_mismatches']}, max "
            f"score error {row['max_abs_err']:.3g}")
    for t in evaluation["timings"]:
        log(f"time eval f32 B={t['bucket']} I={t['items']} k={t['rank']} "
            f"num={t['num']} kernel_ms={t['ms']:.4f} "
            f"(profiler: pass1_ms={t['pass1_ms']:.4f} "
            f"pass2_ms={t['pass2_ms']:.4f}) bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} "
            f"bound_share={t['bound_share']:.3f}")
    log(f"phase eval: ok ({time.perf_counter() - t_start:.1f} s)")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-similar-") as store:
        similar = similar_phase(device, store, args.seed)
    log("similar " + json.dumps(similar))
    log(f"similar: {similar['events']} events + {similar['items']} $set in "
        f"{similar['insert_s']:.2f} s; read {similar['read_s']:.3f} s, train "
        f"{similar['train_s']:.3f} s (two ALS), persist "
        f"{similar['persist_s']:.3f} s; {similar['requests']} requests, p50 "
        f"{similar['p50_ms']:.3f} ms, {similar['answers_checked']} answers "
        f"equal to the plain combination (tied swaps "
        f"{similar['tied_swaps']}, in the pools "
        f"{similar['pool_tied_swaps']}); f32 launches "
        f"{similar['launches']['f32']}; catalog normalize "
        f"{similar['normalize_ms']:.4f} ms beside the kernel's "
        f"{similar['kernel_ms_b1']:.4f} ms (B=1, num 32), one cosine call "
        f"{similar['cosine_call_ms']:.4f} ms")
    log(f"phase similar: ok ({time.perf_counter() - t_start:.1f} s)")

    # every main-path run's launches: phase 4, 7, 8 (both stores), 9, 10
    for run in (dase, *ingest.values(), evaluation, similar):
        for form in FORMS:
            launches[form] += run["launches"].get(form, 0)
    log(f"launches over phases 4 and 7-10: {json.dumps(launches)}")

    kernels = []
    for form in FORMS:
        t = times[(form, 64)]
        kernels.append({
            "name": f"fused_topk_{form}",
            "route": "cuda",
            "source": CUDA_SOURCE,
            "replaces": TPU_KERNEL,
            "launches": launches[form],
            "max_abs_err": worst[form],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
