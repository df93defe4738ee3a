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
   over-masked row and a NaN query row (their -inf slots must name the
   plain version's items: the lowest unrankable ones, ascending), NaN
   rows and planted exact ties;
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
11. drives every other engine template the JAX package registers, each
   at its ``examples/*/engine.json`` from events through ``run_train``
   to ``create_engine_server`` and HTTP queries: ``ecommerce`` (20,000
   users x 5,000 items, 200,000 views and 20,000 buys into sqlite, item
   categories, an ``unavailableItems`` set replaced halfway through 128
   requests; each answer held against the plain top-k of the user's
   staged row with the rules read from the store at that moment; the
   kernel timed at B = 1, num 64 beside its bound, plain version and
   ``torch.topk``), ``complementarypurchase`` (100,000 buys in baskets;
   the card's co-occurrence table against an exact host count, its
   complement lists against the port's CPU scoring, 64 basket queries),
   ``classification`` (20,000 users), ``textclassification`` (10,000
   documents, 4,096 hashed features), ``regression`` (10,000 x 10, three
   SGD step sizes averaged), ``leadscoring`` (10,000 leads, 500 Adam
   steps) and ``helloworld``, each trained on the card and on the CPU
   and held within 1e-5 relative, 256 requests each; then the e2 Markov
   chain over 5,000 states, card against CPU, and a MANUAL model with a
   CUDA tensor field saved and loaded back onto the card;
12. runs the continuous trainer on the deployment the JAX package's
   trainer smoke rehearses (sqlite metadata, the native event log,
   localfs models; phase 7's 200,000 events; ``recommendation_engine()``
   with the default ``ALSParams``, a checkpoint every iteration): a child
   process (``chip_smoke.py --trainer-child``) runs ``poll_once`` with
   ``PIO_TRAIN_CHAOS`` stretching its epochs and is killed with SIGKILL
   once its checkpoint holds iteration 2; a second child resumes
   (``resumedFromIteration`` at least the iteration seen at the kill),
   ends COMPLETED and deletes the checkpoint; the same training
   uninterrupted in this process gives the largest relative difference
   (reported only) and the training and profiler traces in
   ``PIO_TRACE_DIR``; the resumed generation is served and 64 answers are
   held against the plain top-k; 50 new users and 10 new items are
   ingested over HTTP, ``poll_once`` folds them in (the child
   generation's manifest names the parent and the watermark, every
   folded row within a relative residual of 1e-4 of its normal equations
   in float64), ``POST /reload`` swaps the server and every new user's
   answer equals the plain top-k on the child's factors; prints the time
   to the fresh model and its split; ``run_forever`` polls twice with the
   device sampler; the event server's ``/metrics`` and
   ``/debug/traces.json`` must hold the ingest count, the fold-in, the
   checkpoints, the step histogram, the device memory gauge and the
   ``store/insert_batch`` spans;
13. prints one ``{"kernels": [...]}`` line (launches summed over phases
   4 and 7-12) and, last, the device line.

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
    if kind in ("none", "nan-query"):
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
    within ATOL + RTOL*|s|; -inf slots must match and hold the plain
    version's indices (the lowest unrankable items, ascending, as
    ``lax.top_k`` lists them); where
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
    assert torch.equal(ki[neg_k], pi[neg_p]), (
        "an unfilled slot names another item than the plain version's")
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
        # a NaN query row: every slot -inf, items 0, 1, 2, ... in order
        cases.append((form, 3, ragged, 64, "nan-query"))
    cases.append(("f32", 33, n_items, cap, "none"))
    cases.append(("f32", 1, n_items, cap + 476, "none"))
    cases.append(("f32", 3, n_items, cap + 476, "nan-query"))
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
        if mask_kind == "nan-query":
            q[b // 2] = float("nan")
        mask = make_mask(mask_kind, b, n, device, seed + b)
        got = fused_topk.fused_top_k_dot(q, items, num, mask, scale)
        if device.type == "cuda":
            torch.cuda.synchronize()
        want = fused_topk.fused_top_k_dot_reference(q, items, num, mask,
                                                    scale)
        res = compare(q, items.float(), scale, mask, min(num, n), got, want)
        if mask_kind == "nan-query":
            assert got[1][b // 2].tolist() == list(range(min(num, n)))
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

    n_checked, n_ties, max_err = check_answers(answers, model, device)
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


def check_answers(answers, model, device) -> tuple[int, int, float]:
    """Hold each ``(query, answer)`` of a recommendation server against
    the plain top-k on ``model``'s factors (an unknown user must get an
    empty list); returns (answers checked, tied swaps, max score error)."""
    from predictionio_tpu_torch.ops import fused_topk

    n_items = len(model.item_map)
    user_f = torch.as_tensor(model.user_factors).to(device)
    item_f = torch.as_tensor(model.item_factors).to(device)
    n_checked, n_ties, max_err = 0, 0, 0.0
    for q, ans in answers:
        uid = model.user_map.get(q["user"], -1)
        if uid < 0:
            assert ans == {"itemScores": []}, ans
            continue
        n = min(q["num"], n_items)
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
    return n_checked, n_ties, max_err


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


# -- phase 11: the other engine templates ------------------------------------

#: ecommerce: users, items, (signal, events, generator seed), then the
#: requests and the size of each unavailableItems set
ECOMM = (20_000, 5_000, (("view", 200_000, 45), ("buy", 20_000, 46)))
ECOMM_REQUESTS = 128
ECOMM_UNAVAILABLE = 50
ECOMM_TIME_NUM = 64  # the top-k size of a num-10/20 request, pow2(4·num)
#: complementarypurchase: users, items, buy events, generator seed
CP_SHAPE = (20_000, 5_000, 100_000, 47)
CP_QUERIES = 64
#: entities / documents / rows x features / leads / report weeks
CLF_ENTITIES = 20_000
TEXT_DOCS = 10_000
REG_SHAPE = (10_000, 10)
LEADS = 10_000
HELLO_WEEKS = 4
TEMPLATE_QUERIES = 256
#: Markov states and transitions
MARKOV = (5_000, 400_000)
#: relative (and absolute) tolerance of card against CPU for the
#: templates' float32 products, steps and logs
TEMPLATE_RTOL, TEMPLATE_ATOL = 1e-5, 1e-6
T_BASE = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _engine_json(name: str) -> dict:
    with open(os.path.join(ROOT, "examples", name, "engine.json")) as f:
        return json.load(f)


def _template_storage(kind: str, tmpdir: str, app_name: str):
    """A store for one template: memory or sqlite events and metadata,
    models on the local filesystem under ``tmpdir``; returns (Storage,
    app id)."""
    from predictionio_tpu_torch.data.storage import App, Storage

    if kind == "sqlite":
        env = {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
               "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(tmpdir,
                                                            "pio.sqlite"),
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL"}
    else:
        env = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM"}
    env.update({"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(tmpdir, "models"),
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"})
    storage = Storage(env=env)
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    storage.get_events().init(app_id)
    return storage, app_id


def _insert(storage, app_id, events) -> float:
    t0 = time.perf_counter()
    storage.get_events().insert_batch(events, app_id)
    return time.perf_counter() - t0


def _train_template(engine, params, engine_id, ctx, storage):
    """``run_train`` through the process-default storage (the data
    sources read it); returns (the published models, timing)."""
    from predictionio_tpu_torch.core.persistence import (
        deserialize_models,
        load_generation,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage import set_storage

    set_storage(storage)
    try:
        t0 = time.perf_counter()
        iid = run_train(engine, params, engine_id, ctx=ctx, storage=storage)
        run_train_s = time.perf_counter() - t0
    finally:
        set_storage(None)
    instance = storage.get_meta_data_engine_instances().get(iid)
    assert instance.status == "COMPLETED", instance.status
    assert instance.mesh_conf["platform"] == ctx.device.type
    timing = json.loads(instance.env["timing"])
    models = [m for _t, m in deserialize_models(
        load_generation(storage.get_model_data_models(), iid))]
    return models, {
        "run_train_s": run_train_s,
        "read_s": timing["train/read"]["total_s"],
        "train_s": timing["train/algorithm"]["total_s"],
        "persist_s": timing["train/persist"]["total_s"],
    }


class _Served:
    """``create_engine_server`` on the newest generation, with the store
    as the process default while it serves (serve-time rules read it)."""

    def __init__(self, engine, params, engine_id, ctx, storage):
        from predictionio_tpu_torch.serving.engine_server import (
            create_engine_server,
        )

        self._storage = storage
        self.es, self.http = create_engine_server(
            engine, params, engine_id, host="127.0.0.1", port=0,
            storage=storage, ctx=ctx, max_batch=64, max_wait_ms=2.0,
        )
        self.latencies: list[float] = []

    def __enter__(self):
        from predictionio_tpu_torch.data.storage import set_storage

        set_storage(self._storage)
        self.http.start()
        self.base = f"http://127.0.0.1:{self.http.port}"
        return self

    def query(self, body):
        out, s = _post(self.base, "/queries.json", body)
        self.latencies.append(s)
        return out

    def p50_ms(self) -> float:
        lat = sorted(s * 1e3 for s in self.latencies)
        return lat[len(lat) // 2]

    def __exit__(self, *exc):
        from predictionio_tpu_torch.data.storage import set_storage

        self.es.close()
        set_storage(None)


def _close(got, want, what: str) -> float:
    """Largest relative error of ``got`` against ``want`` (tensors or
    arrays); fails above TEMPLATE_RTOL (TEMPLATE_ATOL near zero)."""
    got = torch.as_tensor(np.asarray(got.cpu() if isinstance(
        got, torch.Tensor) else got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want.cpu() if isinstance(
        want, torch.Tensor) else want), dtype=torch.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.numel():
        return 0.0
    gap = (got - want).abs()
    assert bool((gap <= TEMPLATE_ATOL + TEMPLATE_RTOL * want.abs()).all()), (
        f"{what}: card and CPU differ by up to {float(gap.max())}")
    return float((gap / want.abs().clamp(min=TEMPLATE_ATOL)).max())


def _rules_now(storage, app_id, user: str) -> tuple[set, set]:
    """(items the user viewed or bought, the latest unavailable set),
    read from the store directly, as the rules stand now."""
    events = storage.get_events()
    seen = {e.target_entity_id for e in events.find(
        app_id, entity_type="user", entity_id=user,
        event_names=["view", "buy"]) if e.target_entity_id}
    latest = list(events.find(
        app_id, entity_type="constraint", entity_id="unavailableItems",
        event_names=["$set"], limit=1, reversed=True))
    unavailable = ({str(i) for i in latest[0].properties.get("items")}
                   if latest else set())
    return seen, unavailable


def _ecomm_queries(user_ids, item_ids, seed: int) -> list:
    """128 requests, num 10 or 20: a quarter carry 1-2 categories, some
    a whiteList or a blackList, 8 name unknown users."""
    rng = np.random.default_rng(seed + 48)
    out = []
    for j in range(ECOMM_REQUESTS):
        q = {"user": str(rng.choice(user_ids)) if j % 16 else f"nobody{j}",
             "num": int(rng.choice([10, 20]))}
        if j % 4 == 1:
            q["categories"] = [f"c{c}" for c in rng.choice(
                N_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        if j % 6 == 2:
            q["whiteList"] = rng.choice(item_ids, len(item_ids) // 4,
                                        replace=False).tolist()
        if j % 7 == 3:
            q["blackList"] = rng.choice(item_ids, len(item_ids) // 50,
                                        replace=False).tolist()
        out.append(q)
    return out


def _ecomm_expected(q, cand, scores, seen, unavailable, model) -> list:
    """The rules applied to a candidate list, as (item, score) pairs."""
    cats = set(q.get("categories") or [])
    white = set(q.get("whiteList") or [])
    black = set(q.get("blackList") or [])
    out = []
    for ci, score in zip(cand, scores):
        item = model.item_map.inverse(int(ci))
        if item in seen or item in unavailable or item in black:
            continue
        if white and item not in white:
            continue
        if cats and not cats & set(model.item_categories.get(item, [])):
            continue
        out.append((item, float(score)))
        if len(out) >= q["num"]:
            break
    return out


def ecommerce_phase(device, tmpdir: str, seed: int) -> dict:
    """The e-commerce template at its example's width from events to 128
    HTTP answers, each held against the plain top-k of the user's staged
    row at the same k with the rules read from the store at that moment
    (a second unavailableItems $set lands halfway)."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.models.ecommerce import ecommerce_engine
    from predictionio_tpu_torch.ops import fused_topk, similarity
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    variant = _engine_json("ecommerce")
    app_name = variant["datasource"]["params"]["app_name"]
    n_users, n_items, signals = ECOMM
    storage, app_id = _template_storage("sqlite", tmpdir, app_name)
    rng = np.random.default_rng(seed + 49)
    batch, t = [], 0
    for name, n, data_seed in signals:
        rows, cols, _vals = make_interactions(n_users, n_items, n,
                                              seed=data_seed)
        batch += [Event(event=name, entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        event_time=T_BASE + dt.timedelta(seconds=t + j))
                  for j, (u, i) in enumerate(zip(rows.tolist(),
                                                 cols.tolist()))]
        t += n
    batch += [
        Event(event="$set", entity_type="item", entity_id=f"i{i}",
              properties={"categories": [f"c{c}" for c in rng.choice(
                  N_CATEGORIES, int(rng.integers(1, 4)), replace=False)]},
              event_time=T_BASE)
        for i in range(n_items)
    ]
    popular = np.argsort(-np.bincount(
        make_interactions(n_users, n_items, signals[0][1],
                          seed=signals[0][2])[1], minlength=n_items),
        kind="stable")
    first = [f"i{i}" for i in popular[:ECOMM_UNAVAILABLE]]
    second = [f"i{i}" for i in popular[ECOMM_UNAVAILABLE:
                                       2 * ECOMM_UNAVAILABLE]]

    def constraint(items, hours):
        return Event(event="$set", entity_type="constraint",
                     entity_id="unavailableItems",
                     properties={"items": items},
                     event_time=T_BASE + dt.timedelta(days=30, hours=hours))

    batch.append(constraint(first, 0))
    insert_s = _insert(storage, app_id, batch)

    engine = ecommerce_engine()
    params = engine.params_from_variant(variant)
    (_n, p), = params.algorithms
    assert (p.rank, p.num_iterations, p.lambda_, p.alpha, p.unseen_only) == (
        16, 10, 0.01, 1.0, True), p
    ctx = ComputeContext.create(device=device)
    (model,), times = _train_template(engine, params, "chip-ecomm", ctx,
                                      storage)
    assert model.item_factors.shape == (len(model.item_map), 16)
    assert np.isfinite(model.user_factors).all()
    queries = _ecomm_queries(model.user_map.keys(), model.item_map.keys(),
                             seed)
    fused_topk.reset_launch_counts()
    served = []
    with _Served(engine, params, "chip-ecomm", ctx, storage) as srv:
        for j, q in enumerate(queries):
            if j == len(queries) // 2:
                storage.get_events().insert(constraint(second, 1), app_id)
            ans = srv.query(q)
            served.append((q, ans, _rules_now(storage, app_id, q["user"])))
        p50 = srv.p50_ms()
    launches = dict(fused_topk.LAUNCHES)
    known = sum(q["user"] in model.user_map for q in queries)
    assert launches["f32"] == known, (launches, known)

    # each answer against the plain top-k on the staged model, with the
    # rules as they stood; the kernel's list for the user, replayed (it
    # is deterministic), is held to the plain one by the tie rule and
    # settles ties at the candidate pool's edge
    algo = engine.make_algorithms(params)[0]
    staged = algo.stage_model(ctx, model)
    n_real = len(model.item_map)
    table = staged.item_factors
    ties, changed, checked, worst = 0, 0, 0, 0.0
    for j, (q, ans, (seen, unavailable)) in enumerate(served):
        assert unavailable == set(first if j < len(queries) // 2
                                  else second), j
        uid = model.user_map.get(q["user"], -1)
        if uid >= 0:
            k = min(_pow2(4 * q["num"]), n_real)
            qv = staged.user_factors[uid:uid + 1]
            want = fused_topk.fused_top_k_dot_reference(
                qv, table, k, staged.item_phantom_mask)
            got = similarity.gather_top_k_dot(
                staged.user_factors, np.asarray([uid], np.int32), table, k,
                mask=staged.item_phantom_mask)
            res = compare(qv, table, None, staged.item_phantom_mask, k, got,
                          want)
            ties += res["tied_mismatches"]
            cand = got[1][0].long()
            scores = (qv * table[cand]).sum(1).tolist()
            cand = cand.tolist()
        else:
            order = np.argsort(-model.popularity)
            cand = order[:min(4 * q["num"], n_real)]
            scores = model.popularity[cand].tolist()
        expected = _ecomm_expected(q, cand, scores, seen, unavailable, model)
        got_items = [(e["item"], e["score"]) for e in ans["itemScores"]]
        assert [i for i, _ in got_items] == [i for i, _ in expected], (
            f"query {j}: {got_items[:5]} != {expected[:5]}")
        for (_i, gs), (_w, ws) in zip(got_items, expected):
            assert abs(gs - ws) <= ATOL + RTOL * abs(ws), (j, gs, ws)
            worst = max(worst, abs(gs - ws))
        if j >= len(queries) // 2:
            before = _ecomm_expected(q, cand, scores, seen, set(first),
                                     model)
            changed += before != expected
        checked += 1
    assert changed > 0, "the second unavailableItems set changed nothing"

    # the kernel at the served shape: B = 1, the whole catalog, num 64
    qv = staged.user_factors[:1]

    def kernel():
        return fused_topk.fused_top_k_dot(qv, table, ECOMM_TIME_NUM,
                                          staged.item_phantom_mask)

    ms = (device_ms(kernel, reps=50, name_part="topk_pass1")
          + device_ms(kernel, reps=50, name_part="topk_pass2"))
    call_ms = time_ms(kernel, reps=50)
    plain_ms = time_ms(lambda: fused_topk.fused_top_k_dot_reference(
        qv, table, ECOMM_TIME_NUM, staged.item_phantom_mask), reps=20)
    library_ms = time_ms(lambda: torch.topk(qv @ table.T, ECOMM_TIME_NUM),
                         reps=20)
    bound_ms, bound_by = bound(1, table.shape[0], table.shape[1],
                               ECOMM_TIME_NUM, table, None)
    return {
        "events": len(batch) + 1, "insert_s": insert_s, **times,
        "users": len(model.user_map), "items": n_real,
        "requests": len(queries), "answers_checked": checked,
        "known_users": known, "changed_by_second_set": changed,
        "tied_swaps_in_pools": ties, "max_abs_err": worst, "p50_ms": p50,
        "launches": launches,
        "timing": {"batch": 1, "items": table.shape[0],
                   "k": table.shape[1], "num": ECOMM_TIME_NUM,
                   "ms": ms if ms > 0 else call_ms, "call_ms": call_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by},
    }


def _cp_events(seed: int):
    """100,000 buys of the phase 7 generator; each user's buys fall in
    sessions of 2-6 a minute apart, sessions two hours apart, so the
    3,600 s window makes baskets of about 2-6."""
    from predictionio_tpu_torch.data.event import Event

    n_users, n_items, n, data_seed = CP_SHAPE
    rows, cols, _vals = make_interactions(n_users, n_items, n,
                                          seed=data_seed)
    rng = np.random.default_rng(seed + data_seed)
    order = np.argsort(rows, kind="stable")
    rank = np.empty(n, np.int64)
    starts = np.searchsorted(rows[order], np.arange(n_users))
    rank[order] = np.arange(n) - starts[rows[order]]
    size = rng.integers(2, 7, n_users)[rows]
    secs = rows * 10**6 + rank // size * 7200 + rank % size * 60
    return [Event(event="buy", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  event_time=T_BASE + dt.timedelta(seconds=int(s)))
            for u, i, s in zip(rows.tolist(), cols.tolist(), secs.tolist())]


def cp_phase(device, tmpdir: str, seed: int) -> dict:
    """Complementary purchase: C on the card against an exact host count,
    the complement lists against the port's CPU scoring of that count,
    and 64 basket queries over HTTP against the CPU model's answers."""
    from predictionio_tpu_torch.models import complementarypurchase as cp
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    variant = _engine_json("complementarypurchase")
    app_name = variant["datasource"]["params"]["app_name"]
    storage, app_id = _template_storage("memory", tmpdir, app_name)
    insert_s = _insert(storage, app_id, _cp_events(seed))
    engine = cp.complementarypurchase_engine()
    params = engine.params_from_variant(variant)
    (_n, p), = params.algorithms
    ctx = ComputeContext.create(device=device)
    (model,), times = _train_template(engine, params, "chip-cp", ctx,
                                      storage)
    # the same baskets through the data source, C on the card and on the
    # host (exact pair counts), then the port's CPU scoring
    from predictionio_tpu_torch.data.storage import set_storage

    set_storage(storage)
    try:
        td = engine.make_data_source(params).read_training(ctx)
    finally:
        set_storage(None)
    n_items = len(td.item_map)
    sizes = np.asarray([len(b) for b in td.baskets])
    t0 = time.perf_counter()
    C_card = cp.cooccurrence(td.baskets, n_items, p.chunk, device)
    torch.cuda.synchronize()
    cooc_ms = (time.perf_counter() - t0) * 1e3
    C_host = np.zeros((n_items, n_items), np.float32)
    for b in td.baskets:
        ii, jj = np.meshgrid(b, b, indexing="ij")
        np.add.at(C_host, (ii.ravel(), jj.ravel()), 1.0)
    assert np.array_equal(C_card.cpu().numpy(), C_host), "C differs"
    s_cpu, i_cpu = cp.score_top_k(torch.from_numpy(C_host), len(td.baskets),
                                  p.metric, p.min_support, p.top_k)
    s_cpu = s_cpu.numpy()
    i_cpu = np.where(s_cpu > 0, i_cpu.numpy(), -1).astype(np.int32)
    assert np.array_equal(model.topk_items, i_cpu), "complement lists differ"
    worst = _close(model.topk_scores, s_cpu, "complement scores")
    cpu_model = cp.CPModel(item_map=td.item_map, topk_items=i_cpu,
                           topk_scores=s_cpu)
    rng = np.random.default_rng(seed + 50)
    ids = td.item_map.keys()
    queries = [{"items": rng.choice(ids, int(rng.integers(1, 5)),
                                    replace=False).tolist(),
                "num": int(rng.choice([5, 10, 20]))}
               for _ in range(CP_QUERIES - 1)] + [{"items": ["nope"],
                                                   "num": 5}]
    with _Served(engine, params, "chip-cp", ctx, storage) as srv:
        answers = [srv.query(q) for q in queries]
        p50 = srv.p50_ms()
    nonempty = 0
    for q, ans in zip(queries, answers):
        want = cp.CPAlgorithm().predict(cpu_model, q)
        assert [e["item"] for e in ans["itemScores"]] == [
            e["item"] for e in want["itemScores"]], q
        _close([e["score"] for e in ans["itemScores"]],
               [e["score"] for e in want["itemScores"]], "basket scores")
        nonempty += bool(ans["itemScores"])
    assert nonempty > CP_QUERIES // 2, nonempty
    return {"events": CP_SHAPE[2], "insert_s": insert_s, **times,
            "baskets": len(td.baskets), "basket_p50": float(
                np.median(sizes)), "items": n_items,
            "cooccurrence_ms": cooc_ms, "max_rel_err": worst,
            "queries": len(queries), "answered": nonempty, "p50_ms": p50}


def _clf_events(seed: int):
    """The classification example's shape: two plans, three attributes
    around a per-plan base, here over 20,000 users."""
    from predictionio_tpu_torch.data.event import Event

    rng = np.random.default_rng(seed + 51)
    noise = rng.random((CLF_ENTITIES, 3))
    out = []
    for i in range(CLF_ENTITIES):
        base = (8.0, 1.0, 1.0) if i % 2 == 0 else (1.0, 1.0, 8.0)
        out.append(Event(event="$set", entity_type="user", entity_id=f"u{i}",
                         properties={"attr0": base[0] + noise[i, 0],
                                     "attr1": base[1] + noise[i, 1],
                                     "attr2": base[2] + noise[i, 2],
                                     "plan": str(i % 2)}))
    return out


TOPICS = (
    ("win free prize money claim offer click now today exclusive "
     "limited instantly cash bonus"),
    ("meeting agenda review report quarterly tuesday planning notes "
     "attached schedule team budget"),
    ("match goal score team season coach league win player final "
     "stadium fans"),
    ("recipe bake flour oven sugar butter dinner taste salt pan cook "
     "bread"),
)


def _docs(n: int, seed: int) -> list[tuple[str, str]]:
    """(label, text) pairs over four topics: 8-20 words, most from the
    label's topic, the rest from any; some capitalized."""
    rng = np.random.default_rng(seed)
    vocab = [t.split() for t in TOPICS]
    every = [w for t in vocab for w in t]
    out = []
    for i in range(n):
        label = i % len(TOPICS)
        words = [str(rng.choice(vocab[label])) if rng.random() < 0.7
                 else str(rng.choice(every))
                 for _ in range(int(rng.integers(8, 21)))]
        out.append((f"topic{label}",
                    " ".join(w.title() if rng.random() < 0.1 else w
                             for w in words) + "."))
    return out


def _nb_checks(models_card, models_cpu, xq, what) -> float:
    """log scores of the card's and the CPU's tables on ``xq``."""
    from predictionio_tpu_torch.ops import naive_bayes as nb

    worst = _close(models_card.pi, models_cpu.pi, f"{what} pi")
    worst = max(worst, _close(models_card.theta, models_cpu.theta,
                              f"{what} theta"))
    card = nb.log_scores(models_card, xq.to(models_card.theta.device))
    cpu = nb.log_scores(models_cpu, xq.cpu())
    return max(worst, _close(card, cpu, f"{what} log scores"))


def classifier_phase(device, tmpdir: str, seed: int, name: str) -> dict:
    """classification (20,000 users' $set attributes) or
    textclassification (10,000 documents, 4 labels, 4096 hashed
    features): trained by ``run_train`` on the card and, from the same
    prepared data, on the CPU; tables and log scores within tolerance,
    256 HTTP answers equal to the CPU model's labels."""
    from predictionio_tpu_torch.core.registry import resolve_engine_factory
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    variant = _engine_json(name)
    app_name = variant["datasource"]["params"]["app_name"]
    storage, app_id = _template_storage("memory", tmpdir, app_name)
    rng = np.random.default_rng(seed + 52)
    if name == "classification":
        events = _clf_events(seed)
        queries = [{"features": (rng.random(3) * 9).tolist()}
                   for _ in range(TEMPLATE_QUERIES)]
    else:
        docs = _docs(TEXT_DOCS, seed + 53)
        events = [Event(event="$set", entity_type="document",
                        entity_id=f"d{i}",
                        properties={"text": text, "label": label})
                  for i, (label, text) in enumerate(docs)]
        queries = [{"text": text} for _l, text in _docs(TEMPLATE_QUERIES,
                                                         seed + 54)]
    insert_s = _insert(storage, app_id, events)
    engine = resolve_engine_factory(name)()
    params = engine.params_from_variant(variant)
    ctx = ComputeContext.create(device=device)
    cpu = ComputeContext.create(device="cpu")
    (model,), times = _train_template(engine, params, f"chip-{name}", ctx,
                                      storage)
    set_storage(storage)
    try:
        td = engine.make_data_source(params).read_training(cpu)
    finally:
        set_storage(None)
    prep = engine.make_preparator(params).prepare(cpu, td)
    algo = engine.make_algorithms(params)[0]
    cpu_model = algo.train(cpu, prep)
    staged = algo.stage_model(ctx, model)
    nb_card = getattr(staged, "nb", None) or staged.nb_model
    nb_cpu = getattr(cpu_model, "nb", None) or cpu_model.nb_model
    assert nb_card.theta.device.type == device.type
    worst = _nb_checks(nb_card, nb_cpu, prep.x[:TEMPLATE_QUERIES], name)
    with _Served(engine, params, f"chip-{name}", ctx, storage) as srv:
        answers = [srv.query(q) for q in queries]
        p50 = srv.p50_ms()
    want = algo.batch_predict(cpu_model, queries)
    assert [a["label"] for a in answers] == [w["label"] for w in want]
    if name == "textclassification":
        for a, w in zip(answers, want):
            _close([a["scores"][k] for k in sorted(w["scores"])],
                   [w["scores"][k] for k in sorted(w["scores"])],
                   "text scores")
    return {"events": len(events), "insert_s": insert_s, **times,
            "rows": int(prep.x.shape[0]), "features": int(prep.x.shape[1]),
            "classes": len(td.label_map) if hasattr(td, "label_map")
            else len(set(td.labels)),
            "max_rel_err": worst, "queries": len(queries),
            "labels": sorted({a["label"] for a in answers}), "p50_ms": p50}


def _reg_events(seed: int):
    """The regression example's shape: label = x·w + 3 + noise, here
    10,000 points of 10 features."""
    from predictionio_tpu_torch.data.event import Event

    n, d = REG_SHAPE
    rng = np.random.default_rng(seed + 55)
    true_w = rng.standard_normal(d)
    x = rng.uniform(-1, 1, (n, d))
    y = x @ true_w + 3.0 + rng.normal(0, 0.05, n)
    return [Event(event="point", entity_type="point", entity_id=f"p{i}",
                  properties={"label": float(y[i]),
                              "features": x[i].tolist()})
            for i in range(n)]


def _lead_events(seed: int):
    """The leadscoring example's shape over 10,000 leads: converted
    leads engage more, with overlapping noise."""
    from predictionio_tpu_torch.data.event import Event

    rng = np.random.default_rng(seed + 56)
    out = []
    for i in range(LEADS):
        converted = bool(rng.random() < 0.5)
        base = 8.0 if converted else 2.0
        out.append(Event(event="$set", entity_type="user", entity_id=f"u{i}",
                         properties={
                             "sessions": float(base + rng.normal(0, 3.0)),
                             "pages": float(base * 3 + rng.normal(0, 9.0)),
                             "minutes": float(base * 5 + rng.normal(0, 15.0)),
                             "converted": converted}))
    return out


def _hello_events(seed: int):
    from predictionio_tpu_torch.data.event import Event

    rng = np.random.default_rng(seed + 57)
    base = {"Mon": 75, "Tue": 80, "Wed": 70, "Thu": 65, "Fri": 68}
    return [Event(event="report", entity_type="day", entity_id=day,
                  properties={"temperature": float(t + rng.uniform(-3, 3))})
            for _w in range(HELLO_WEEKS) for day, t in base.items()]


def numeric_phase(device, tmpdir: str, seed: int, name: str) -> dict:
    """regression (the example's three SGD step sizes, AverageServing),
    leadscoring (500 Adam steps) or helloworld: trained by ``run_train``
    on the card and on the CPU from the same read; weights, means and
    answers within tolerance, leadscoring's final loss within 1e-5."""
    from predictionio_tpu_torch.core.registry import resolve_engine_factory
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.models import leadscoring
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    variant = _engine_json(name)
    app_name = variant["datasource"]["params"]["app_name"]
    storage, app_id = _template_storage("memory", tmpdir, app_name)
    events = {"regression": _reg_events, "leadscoring": _lead_events,
              "helloworld": _hello_events}[name](seed)
    insert_s = _insert(storage, app_id, events)
    engine = resolve_engine_factory(name)()
    params = engine.params_from_variant(variant)
    ctx = ComputeContext.create(device=device)
    cpu = ComputeContext.create(device="cpu")
    models, times = _train_template(engine, params, f"chip-{name}", ctx,
                                    storage)
    set_storage(storage)
    try:
        td = engine.make_data_source(params).read_training(cpu)
    finally:
        set_storage(None)
    prep = engine.make_preparator(params).prepare(cpu, td)
    algos = engine.make_algorithms(params)
    rng = np.random.default_rng(seed + 58)
    out = {"events": len(events), "insert_s": insert_s, **times}
    worst = 0.0
    if name == "regression":
        queries = [{"features": rng.uniform(-1, 1, REG_SHAPE[1]).tolist()}
                   for _ in range(TEMPLATE_QUERIES)]
        cpu_models = [a.train(cpu, prep) for a in algos]
        for m, c in zip(models, cpu_models):
            worst = max(worst, _close(np.append(m.weights, m.intercept),
                                      np.append(c.weights, c.intercept),
                                      "regression weights"))
        want = [engine.make_serving(params).serve(
            q, [a.predict(c, q) for a, c in zip(algos, cpu_models)])
            for q in queries]
    elif name == "leadscoring":
        queries = [{"features": [float(rng.uniform(0, 12)),
                                 float(rng.uniform(0, 36)),
                                 float(rng.uniform(0, 60))]}
                   for _ in range(TEMPLATE_QUERIES)]
        (algo,) = algos
        p = algo.params
        card_x = prep.x.to(device)
        w_card, b_card = leadscoring.fit_logistic(
            card_x, prep.y.to(device), prep.mask.to(device),
            p.learning_rate, p.steps, p.l2)
        w_cpu, b_cpu = leadscoring.fit_logistic(
            prep.x, prep.y, prep.mask, p.learning_rate, p.steps, p.l2)
        (m,) = models
        _close(m.w, w_card, "run_train's lead weights against a refit")
        worst = _close(np.append(w_card.cpu(), float(b_card)),
                       np.append(w_cpu, float(b_cpu)), "lead weights")
        loss_card = float(leadscoring.lead_loss(
            w_card, b_card, card_x, prep.y.to(device),
            prep.mask.to(device), p.l2))
        loss_cpu = float(leadscoring.lead_loss(
            w_cpu, b_cpu, prep.x, prep.y, prep.mask, p.l2))
        assert abs(loss_card - loss_cpu) <= 1e-5, (loss_card, loss_cpu)
        out.update(loss_card=loss_card, loss_cpu=loss_cpu)
        t0 = time.perf_counter()
        leadscoring.fit_logistic(card_x, prep.y.to(device),
                                 prep.mask.to(device), p.learning_rate,
                                 p.steps, p.l2)
        torch.cuda.synchronize()
        out["adam_fit_s"] = time.perf_counter() - t0
        cpu_model = algo.train(cpu, prep)
        want = algo.batch_predict(cpu_model, queries)
    else:
        days = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sun")  # Sun unknown
        queries = [{"day": days[j % len(days)]}
                   for j in range(TEMPLATE_QUERIES)]
        (algo,) = algos
        cpu_model = algo.train(cpu, prep)
        worst = _close(models[0].means, cpu_model.means, "hello means")
        want = [algo.predict(cpu_model, q) for q in queries]
    with _Served(engine, params, f"chip-{name}", ctx, storage) as srv:
        answers = [srv.query(q) for q in queries]
        out["p50_ms"] = srv.p50_ms()
    for a, w in zip(answers, want):
        if name == "regression":
            _close([a], [w], "regression answers")
        elif name == "leadscoring":
            assert a["converted"] == w["converted"], (a, w)
            _close([a["score"]], [w["score"]], "lead scores")
        else:
            assert (a["temperature"] is None) == (w["temperature"] is None)
            if w["temperature"] is not None:
                _close([a["temperature"]], [w["temperature"]], "hello")
    out.update(max_rel_err=worst, queries=len(queries))
    return out


def e2_phase(device, tmpdir: str, seed: int) -> dict:
    """``train_markov_chain`` over 5,000 states on the card against the
    CPU (indices equal, probabilities within tolerance), and one MANUAL
    model with a CUDA tensor field saved and loaded back onto the card."""
    from predictionio_tpu_torch.core.persistent_model import (
        load_persistent_model,
        save_persistent_model,
    )
    from predictionio_tpu_torch.ops import markov

    n_states, n = MARKOV
    rng = np.random.default_rng(seed + 59)
    frm = rng.integers(0, n_states, n)
    to = (rng.zipf(1.3, n) + frm) % n_states
    t0 = time.perf_counter()
    card = markov.train_markov_chain(frm, to, n_states, 10, device=device)
    torch.cuda.synchronize()
    markov_s = time.perf_counter() - t0
    cpu = markov.train_markov_chain(frm, to, n_states, 10, device="cpu")
    assert torch.equal(card.indices.cpu(), cpu.indices), "markov indices"
    worst = _close(card.probs, cpu.probs, "markov probs")
    ties = int((card.probs[:, 1:] == card.probs[:, :-1]).sum())
    assert markov.predict_next(card, 7) == markov.predict_next(cpu, 7)

    factors = torch.randn(4096, 32, device=device)
    model = {"factors": factors, "bias": np.arange(4, dtype=np.float32),
             "names": ("a", "b")}
    d = os.path.join(tmpdir, "pmodel")
    t0 = time.perf_counter()
    save_persistent_model(d, model)
    back = load_persistent_model(d, device=device)
    persist_s = time.perf_counter() - t0
    assert back["factors"].device == factors.device
    assert torch.equal(back["factors"], factors), "MANUAL round trip"
    assert np.array_equal(back["bias"], model["bias"])
    assert back["names"] == ("a", "b")
    return {"markov_states": n_states, "transitions": n,
            "markov_s": markov_s, "markov_max_rel_err": worst,
            "tied_neighbours": ties, "manual_round_trip_s": persist_s}


def templates_phase(device, seed: int) -> dict:
    """Phase 11: every other engine template the JAX package registers,
    each from events through ``run_train`` to HTTP answers on the card,
    then the e2 helpers and MANUAL persistence."""
    out = {}
    steps = [
        ("ecommerce", lambda d: ecommerce_phase(device, d, seed)),
        ("complementarypurchase", lambda d: cp_phase(device, d, seed)),
        ("classification",
         lambda d: classifier_phase(device, d, seed, "classification")),
        ("textclassification",
         lambda d: classifier_phase(device, d, seed, "textclassification")),
        ("regression", lambda d: numeric_phase(device, d, seed,
                                               "regression")),
        ("leadscoring", lambda d: numeric_phase(device, d, seed,
                                                "leadscoring")),
        ("helloworld", lambda d: numeric_phase(device, d, seed,
                                               "helloworld")),
        ("e2", lambda d: e2_phase(device, d, seed)),
    ]
    for name, step in steps:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{name}-") as d:
            out[name] = step(d)
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"template {name} " + json.dumps(out[name]))
    return out


# -- phase 12: the continuous trainer ---------------------------------------

TRAINER_APP = "chip-smoke-trainer"
TRAINER_ENGINE = "chip-smoke-trainer"
#: host sleep before each epoch of the first trainer child, so the kill
#: lands between checkpoints (PIO_TRAIN_CHAOS)
TRAINER_CHAOS_S = 0.4
KILL_AT_ITERATION = 2
FRESH_USERS, FRESH_ITEMS = 50, 10
FRESH_EVENTS = (5, 20)  # each new user's / item's events, inclusive
TRAINER_REQUESTS = 64


def trainer_env(workdir: str) -> dict:
    """sqlite metadata, the native event log and localfs models under
    ``workdir``: the deployment the JAX package's trainer smoke runs."""
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(workdir, "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(workdir, "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(workdir, "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


def trainer_parts(workdir: str):
    """(storage, engine, params, TrainerConfig) of phase 12's deployment:
    ``recommendation_engine()`` with the default ``ALSParams`` (rank 32,
    10 iterations), a checkpoint every iteration, fold-in from one event."""
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.training import TrainerConfig

    storage = Storage(env=trainer_env(workdir))
    engine = recommendation_engine()
    params = engine.params_from_variant({
        "datasource": {"params": {"app_name": TRAINER_APP}},
        "algorithms": [{"name": "als", "params": {}}],
    })
    config = TrainerConfig(
        app_name=TRAINER_APP, checkpoint_dir=os.path.join(workdir, "ckpt"),
        checkpoint_every=1, min_new_events=1, poll_interval_s=0.2,
    )
    return storage, engine, params, config


def trainer_child(workdir: str, device=None) -> int:
    """One ``poll_once`` of a fresh trainer process on ``workdir`` (run as
    ``chip_smoke.py --trainer-child DIR``, on the card); prints one JSON
    line: the action, the state file, the seconds and this process's
    trainer metrics."""
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.training import ContinuousTrainer

    t0 = time.perf_counter()
    device = device or torch.device("cuda", 0)
    storage, engine, params, config = trainer_parts(workdir)
    set_storage(storage)  # the data source reads the process default
    trainer = ContinuousTrainer(
        engine, params, TRAINER_ENGINE, config, storage=storage,
        ctx=ComputeContext.create(device=device),
    )
    action = trainer.poll_once()
    metrics = get_registry().to_dict()
    keep = ("pio_trainer_runs_total", "pio_train_checkpoints_total",
            "pio_train_step_seconds")
    print(json.dumps({
        "action": action,
        "state": trainer.state,
        "seconds": time.perf_counter() - t0,
        "metrics": {k: metrics[k]["samples"] for k in keep if k in metrics},
    }), flush=True)
    return 0


def _spawn_trainer(workdir: str, extra_env: dict, name: str):
    """A trainer child process; its output goes to files in ``workdir``
    (a pipe nobody reads could fill and stall it). Returns (process,
    stdout path, stderr path)."""
    env = dict(os.environ, PYTHONPATH=ROOT, **extra_env)
    out_path = os.path.join(workdir, f"{name}.out")
    err_path = os.path.join(workdir, f"{name}.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--trainer-child",
             workdir],
            env=env, stdout=out, stderr=err, cwd=ROOT,
        )
    return proc, out_path, err_path


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _counter(text: str, name: str, **labels) -> float:
    """Sum of a family's samples in Prometheus text whose labels include
    ``labels`` (0 when none)."""
    total = 0.0
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            head, value = line.rsplit(" ", 1)
            if head.split("{")[0] == name and all(w in head for w in want):
                total += float(value)
    return total


def _fresh_events(model, seed: int) -> tuple[list, dict, dict]:
    """New users rating known items, new items rated by known users: the
    event JSON bodies, each new user's and item's (other, rating) list."""
    rng = np.random.default_rng(seed + 12)
    known_items = model.item_map.keys()
    known_users = model.user_map.keys()
    lo, hi = FRESH_EVENTS
    bodies, by_user, by_item = [], {}, {}
    for u in range(FRESH_USERS):
        uid = f"fresh-u{u}"
        items = rng.choice(known_items, int(rng.integers(lo, hi + 1)))
        for item in items.tolist():
            r = float(rng.integers(1, 6))
            by_user.setdefault(uid, []).append((item, r))
            bodies.append((uid, item, r))
    for i in range(FRESH_ITEMS):
        iid = f"fresh-i{i}"
        users = rng.choice(known_users, int(rng.integers(lo, hi + 1)))
        for user in users.tolist():
            r = float(rng.integers(1, 6))
            by_item.setdefault(iid, []).append((user, r))
            bodies.append((user, iid, r))
    order = rng.permutation(len(bodies))
    events = [
        {"event": "rate", "entityType": "user", "entityId": bodies[j][0],
         "targetEntityType": "item", "targetEntityId": bodies[j][1],
         "properties": {"rating": bodies[j][2]}}
        for j in order.tolist()
    ]
    return events, by_user, by_item


def _fold_in_residual(folded, pairs_by_key, keys, opposite, opposite_map):
    """Largest relative residual of folded rows against their implicit
    normal equations rebuilt in float64 (phase 6's :func:`max_residual`),
    each row's interactions as ingested (duplicates add)."""
    rows, other, vals = [], [], []
    for r, key in enumerate(keys):
        for o, v in pairs_by_key[key]:
            rows.append(r)
            other.append(opposite_map(o))
            vals.append(v)
    rows = np.asarray(rows, np.int64)
    worst, _median = max_residual(
        folded, np.arange(len(keys)), opposite,
        np.asarray(other, np.int64), np.asarray(vals, np.float32),
        _rows_by(rows, len(keys)), None)
    return worst


def trainer_phase(device, workdir: str, seed: int) -> dict:
    """The continuous trainer on the card (the contract's phase 12): kill
    -9 resume of a checkpointed retrain in child processes, the resumed
    generation served, fold-in of new users and items ingested over
    HTTP, ``POST /reload`` and their answers, the telemetry surface."""
    import http.client
    import signal
    import threading

    from predictionio_tpu_torch.core.persistence import (
        deserialize_models,
        load_generation,
        load_manifest,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data import store as store_mod
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import (
        AccessKey,
        AccessKeysBackend,
        App,
        set_storage,
    )
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.ops import fused_topk
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )
    from predictionio_tpu_torch.serving.event_server import (
        create_event_server,
    )
    from predictionio_tpu_torch.training import ContinuousTrainer
    from predictionio_tpu_torch.training import trainer as trainer_mod

    out = {}
    storage, engine, params, config = trainer_parts(workdir)
    ctx = ComputeContext.create(device=device)
    app_id = storage.get_meta_data_apps().insert(App(0, TRAINER_APP))
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(AccessKeysBackend.generate_key(), app_id))
    events = storage.get_events()
    events.init(app_id)
    n_users, n_items, n_events = DASE
    rows, cols, vals = make_interactions(n_users, n_items, n_events, seed=42)
    t0 = time.perf_counter()
    step = 20_000
    for lo in range(0, n_events, step):
        events.insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": float(r)})
            for u, i, r in zip(rows[lo:lo + step].tolist(),
                               cols[lo:lo + step].tolist(),
                               vals[lo:lo + step].tolist())
        ], app_id)
    out["insert_s"] = time.perf_counter() - t0

    # 1. kill -9 resume: a stretched retrain is killed once its
    # checkpoint holds iteration >= 2, then a second process resumes it
    ckpt_dir = config.checkpoint_dir
    t0 = time.perf_counter()
    child, _out, err_path = _spawn_trainer(
        workdir, {"PIO_TRAIN_CHAOS": f"epoch_sleep:{TRAINER_CHAOS_S}"},
        "killed")
    seen = 0
    try:
        while True:
            seen = als_ops.peek_checkpoint_iteration(ckpt_dir)
            if seen >= KILL_AT_ITERATION:
                break
            if child.poll() is not None:
                raise AssertionError(
                    f"trainer child ended (rc {child.returncode}) before "
                    f"its checkpoint reached iteration {KILL_AT_ITERATION}:"
                    f" {_tail(err_path)}")
            if time.perf_counter() - t0 > 300:
                raise AssertionError("trainer child never checkpointed")
            time.sleep(0.01)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    assert child.returncode == -signal.SIGKILL, child.returncode
    out["killed_child_s"] = time.perf_counter() - t0
    out["killed_at_iteration"] = seen
    state = json.loads(open(config.resolved_state_path()).read())
    assert state["phase"] == "training", state

    trace_dir = os.path.join(workdir, "traces")
    t0 = time.perf_counter()
    child, out_path, err_path = _spawn_trainer(
        workdir, {"PIO_TRACE_DIR": trace_dir}, "resumed")
    try:
        child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    out["resumed_child_s"] = time.perf_counter() - t0
    assert child.returncode == 0, _tail(err_path)
    with open(out_path) as f:
        resumed = json.loads(f.read().strip().splitlines()[-1])
    assert resumed["action"] == "full", resumed
    r_state = resumed["state"]
    out["resumed_from_iteration"] = r_state["resumedFromIteration"]
    assert r_state["resumedFromIteration"] >= seen, (r_state, seen)
    assert r_state["phase"] == "idle" and r_state["fullTrains"] == 1
    assert not os.path.exists(als_ops.checkpoint_path(ckpt_dir)), (
        "the completed retrain left its checkpoint")
    parent_id = r_state["lastInstanceId"]
    instance = storage.get_meta_data_engine_instances().get(parent_id)
    assert instance.status == "COMPLETED", instance.status
    child_metrics = resumed["metrics"]
    full_done = sum(
        s["value"] for s in child_metrics["pio_trainer_runs_total"]
        if s["labels"] == {"kind": "full", "outcome": "completed"})
    assert full_done >= 1, child_metrics
    child_ckpts = child_metrics["pio_train_checkpoints_total"][0]["value"]
    assert child_ckpts >= 1, child_metrics
    out["resumed_child_checkpoints"] = child_ckpts
    child_trace = os.path.join(trace_dir, f"pio_train_{parent_id}.trace.json")
    names = {e["name"] for e in json.load(open(child_trace))["traceEvents"]}
    assert {"pio_train", "train/persist_model", "als/checkpoint"} <= names
    backend = storage.get_model_data_models()
    (model,) = [m for _t, m in deserialize_models(
        load_generation(backend, parent_id))]
    assert model.item_factors.shape == (len(model.item_map), RANK)

    # the same training uninterrupted, in this process, for comparison
    # (reported only: index_add_ on the card is not bit-deterministic)
    # and for the training trace and the profiler trace of this process
    os.environ["PIO_TRACE_DIR"] = trace_dir
    set_storage(storage)
    metrics_before = get_registry().render_prometheus()
    try:
        ref_id = run_train(
            engine, params, TRAINER_ENGINE + "-uninterrupted", ctx=ctx,
            storage=storage, checkpoint_dir=os.path.join(workdir, "ref"),
            checkpoint_every=1)
    finally:
        os.environ.pop("PIO_TRACE_DIR", None)
        set_storage(None)
    (ref,) = [m for _t, m in deserialize_models(
        load_generation(backend, ref_id))]
    assert list(ref.user_map.keys()) == list(model.user_map.keys())
    assert list(ref.item_map.keys()) == list(model.item_map.keys())
    out["resume_vs_uninterrupted_rel"] = max(
        float(np.abs(a - b).max() / np.abs(b).max())
        for a, b in ((model.user_factors, ref.user_factors),
                     (model.item_factors, ref.item_factors)))
    ref_trace = os.path.join(trace_dir, f"pio_train_{ref_id}.trace.json")
    names = {e["name"] for e in json.load(open(ref_trace))["traceEvents"]}
    assert {"pio_train", "train/persist_model", "als/checkpoint"} <= names, (
        names)
    profiles = [f for f in os.listdir(trace_dir) if f.startswith("torch_")]
    assert profiles, os.listdir(trace_dir)
    prof = json.load(open(os.path.join(trace_dir, profiles[0])))
    assert prof["traceEvents"], "the profiler trace is empty"
    out["profiler_trace_events"] = len(prof["traceEvents"])

    # 2. the resumed generation served; from here the kernel's launches
    # count for this phase
    fused_topk.reset_launch_counts()
    es, http_srv = create_engine_server(
        engine, params, TRAINER_ENGINE, host="127.0.0.1", port=0,
        storage=storage, ctx=ctx, max_batch=64, max_wait_ms=2.0,
    )
    http_srv.start()
    server = create_event_server(host="127.0.0.1", port=0, storage=storage)
    server.start()
    sampler_stop = threading.Event()
    try:
        base = f"http://127.0.0.1:{http_srv.port}"
        rng = np.random.default_rng(seed + 13)
        users = rng.choice(model.user_map.keys(), TRAINER_REQUESTS).tolist()
        queries = [{"user": u, "num": [1, 10, 20, 50][i % 4]}
                   for i, u in enumerate(users)]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(_post, base, "/queries.json", q)
                    for q in queries]
            answers = [(q, f.result()[0]) for q, f in zip(queries, futs)]
        n_checked, ties, err = check_answers(answers, model, device)
        assert n_checked == TRAINER_REQUESTS, n_checked
        out["resumed_answers_checked"] = n_checked
        out["resumed_tied_swaps"] = ties

        # 3. fold-in freshness over HTTP
        fresh, by_user, by_item = _fresh_events(model, seed)
        t_fresh = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        try:
            for lo in range(0, len(fresh), INGEST_BATCH):
                status, res = _http_call(
                    conn, "POST", f"/batch/events.json?accessKey={key}",
                    fresh[lo:lo + INGEST_BATCH])
                assert status == 200, (status, res)
                assert all(r["status"] == 201 for r in res), res[:3]
        finally:
            conn.close()
        split = {"ingest_s": time.perf_counter() - t_fresh}
        out["fresh_events"] = len(fresh)

        # time each step inside poll_once by wrapping what it calls
        wrapped = {}

        def timed(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    split[name] = split.get(name, 0.0) + (
                        time.perf_counter() - t)
            return run

        patches = [
            (trainer_mod, "read_watermark", "read_watermark_s"),
            (store_mod.EventStore, "interactions", "interactions_s"),
            (als_ops, "fold_in_users", "fold_in_users_s"),
            (trainer_mod, "publish_generation", "publish_s"),
        ]
        for owner, attr, name in patches:
            wrapped[(owner, attr)] = getattr(owner, attr)
            setattr(owner, attr, timed(name, getattr(owner, attr)))
        trainer = ContinuousTrainer(engine, params, TRAINER_ENGINE, config,
                                    storage=storage, ctx=ctx)
        try:
            t0 = time.perf_counter()
            action = trainer.poll_once()
            split["poll_once_s"] = time.perf_counter() - t0
        finally:
            for (owner, attr), fn in wrapped.items():
                setattr(owner, attr, fn)
        assert action == "fold_in", action
        child_id = trainer.state["lastInstanceId"]
        manifest = load_manifest(backend, child_id)
        assert manifest["parent"] == parent_id, manifest
        wm = trainer.state["trainedWatermark"]
        assert manifest["watermark"] == wm, (manifest, wm)
        assert wm["count"] == n_events + len(fresh), wm
        (folded,) = [m for _t, m in deserialize_models(
            load_generation(backend, child_id))]
        n_parent_items = len(model.item_map)
        assert len(folded.user_map) == len(model.user_map) + FRESH_USERS
        assert len(folded.item_map) == n_parent_items + FRESH_ITEMS
        new_users = [f"fresh-u{u}" for u in range(FRESH_USERS)]
        new_items = [f"fresh-i{i}" for i in range(FRESH_ITEMS)]
        u_rows = [folded.user_map(u) for u in new_users]
        i_rows = [folded.item_map(i) for i in new_items]
        out["fold_in_user_residual"] = _fold_in_residual(
            folded.user_factors[u_rows], by_user, new_users,
            model.item_factors, model.item_map)
        out["fold_in_item_residual"] = _fold_in_residual(
            folded.item_factors[i_rows], by_item, new_items,
            folded.user_factors, folded.user_map)
        assert out["fold_in_user_residual"] <= RESIDUAL_TOL, out
        assert out["fold_in_item_residual"] <= RESIDUAL_TOL, out

        t0 = time.perf_counter()
        reload, _ = _post(base, "/reload", {})
        split["reload_s"] = time.perf_counter() - t0
        assert reload == {"message": "reloaded",
                          "engineInstanceId": child_id}, reload
        with urllib.request.urlopen(base + "/", timeout=30) as resp:
            assert json.loads(resp.read())["engineInstanceId"] == child_id
        fresh_answers, t_first = [], None
        for u in new_users:
            q = {"user": u, "num": 10}
            ans, s = _post(base, "/queries.json", q)
            if t_first is None:
                t_first = time.perf_counter()
                split["query_s"] = s
            assert ans["itemScores"], (u, ans)
            fresh_answers.append((q, ans))
        out["time_to_fresh_s"] = t_first - t_fresh
        n_checked, ties, err = check_answers(fresh_answers, folded, device)
        assert n_checked == FRESH_USERS, n_checked
        out["fresh_answers_checked"] = n_checked
        out["fresh_tied_swaps"] = ties
        out["fresh_max_abs_err"] = err
        out["fresh_split"] = split

        # 4. the telemetry surface: a few polls of the daemon loop (its
        # device sampler), then the event server's scrape
        polls = []
        loop = ContinuousTrainer(engine, params, TRAINER_ENGINE, config,
                                 storage=storage, ctx=ctx)
        real_poll = loop.poll_once

        def counted_poll():
            polls.append(real_poll())
            if len(polls) >= 2:
                sampler_stop.set()
            return polls[-1]

        loop.poll_once = counted_poll
        runner = threading.Thread(target=loop.run_forever,
                                  args=(sampler_stop,))
        runner.start()
        runner.join(timeout=120)
        assert not runner.is_alive(), "run_forever did not stop"
        assert polls == ["idle", "idle"], polls
        ebase = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(ebase + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(ebase + "/debug/traces.json",
                                    timeout=30) as resp:
            traces = json.loads(resp.read())
    finally:
        sampler_stop.set()
        es.close()
        server.shutdown()
    launches = dict(fused_topk.LAUNCHES)
    assert launches["f32"] >= 1, "phase 12 served without the kernel"
    out["launches"] = launches

    def delta(name, **labels):
        return (_counter(text, name, **labels)
                - _counter(metrics_before, name, **labels))

    telemetry = {
        "events_ingested": delta("pio_events_ingested_total",
                                 app_id=app_id, status="201"),
        "fold_in_runs": delta("pio_trainer_runs_total", kind="fold_in",
                              outcome="completed"),
        "checkpoints": delta("pio_train_checkpoints_total"),
        "train_steps": delta("pio_train_step_seconds_count",
                             step="train/total"),
        "hbm_used_bytes": _counter(text, "pio_device_hbm_used_bytes"),
        "child_full_runs": full_done,
    }
    assert telemetry["events_ingested"] == len(fresh), telemetry
    assert telemetry["fold_in_runs"] == 1, telemetry
    assert telemetry["checkpoints"] >= 1, telemetry
    assert telemetry["train_steps"] >= 1, telemetry
    assert telemetry["hbm_used_bytes"] > 0, telemetry
    spans = [s["name"] for tr in traces["traces"] for s in tr["spans"]]
    telemetry["insert_batch_spans"] = spans.count("store/insert_batch")
    assert telemetry["insert_batch_spans"] >= 1, sorted(set(spans))
    out["telemetry"] = telemetry
    return out


def log_trainer(t: dict) -> None:
    s = t["fresh_split"]
    log(f"trainer: {DASE[2]} events inserted in {t['insert_s']:.2f} s; "
        f"child killed at checkpoint iteration {t['killed_at_iteration']} "
        f"after {t['killed_child_s']:.2f} s; resumed child "
        f"{t['resumed_child_s']:.2f} s from iteration "
        f"{t['resumed_from_iteration']} ({t['resumed_child_checkpoints']:.0f}"
        f" checkpoints); largest relative difference to an uninterrupted "
        f"run {t['resume_vs_uninterrupted_rel']:.3g}; "
        f"{t['resumed_answers_checked']} answers of the resumed generation "
        f"equal to the plain top-k (tied swaps {t['resumed_tied_swaps']})")
    log(f"trainer fold-in: {t['fresh_events']} events for {FRESH_USERS} new "
        f"users and {FRESH_ITEMS} new items; time to fresh model "
        f"{t['time_to_fresh_s']:.3f} s = ingest {s['ingest_s']:.3f} s + "
        f"poll_once {s['poll_once_s']:.3f} s (read_watermark "
        f"{s['read_watermark_s']:.3f} s, interactions "
        f"{s['interactions_s']:.3f} s, fold_in_users "
        f"{s['fold_in_users_s']:.3f} s, publish {s['publish_s']:.3f} s) + "
        f"reload {s['reload_s']:.3f} s + query {s['query_s']:.3f} s; "
        f"residual users {t['fold_in_user_residual']:.3g} items "
        f"{t['fold_in_item_residual']:.3g}; {t['fresh_answers_checked']} "
        f"fresh answers equal to the plain top-k (tied swaps "
        f"{t['fresh_tied_swaps']}); f32 launches {t['launches']['f32']}")
    log(f"trainer telemetry: {json.dumps(t['telemetry'])}")


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


def log_templates(t: dict) -> None:
    e = t["ecommerce"]
    log(f"ecommerce: {e['events']} events in {e['insert_s']:.2f} s; read "
        f"{e['read_s']:.3f} s, train {e['train_s']:.3f} s, persist "
        f"{e['persist_s']:.3f} s; {e['requests']} requests, p50 "
        f"{e['p50_ms']:.3f} ms, {e['answers_checked']} answers equal to the "
        f"host recomputation ({e['changed_by_second_set']} changed by the "
        f"second unavailableItems set, {e['tied_swaps_in_pools']} tied "
        f"swaps in the pools); f32 launches {e['launches']['f32']}")
    k = e["timing"]
    log(f"time ecommerce f32 B={k['batch']} I={k['items']} k={k['k']} "
        f"num={k['num']} kernel_ms={k['ms']:.4f} call_ms={k['call_ms']:.4f} "
        f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
        f"plain_ms={k['plain_ms']:.4f} library_ms={k['library_ms']:.4f} "
        f"bound_share={k['bound_ms'] / k['ms']:.3f}")
    for name, run in t.items():
        if name == "ecommerce":
            continue
        secs = ", ".join(f"{key} {run[key]:.3f} s" for key in (
            "insert_s", "read_s", "train_s", "persist_s", "adam_fit_s",
            "markov_s", "manual_round_trip_s") if key in run)
        p50 = f", request p50 {run['p50_ms']:.3f} ms" if "p50_ms" in run else ""
        log(f"{name}: {secs}{p50}; whole step {run['phase_s']:.2f} s")


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
    ap.add_argument("--trainer-child", metavar="DIR",
                    help="run one trainer poll on phase 12's deployment "
                    "in DIR (phase 12 starts these itself)")
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
    if args.trainer_child:
        return trainer_child(args.trainer_child)
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

    templates = templates_phase(device, args.seed)
    log_templates(templates)
    log(f"phase templates: ok ({time.perf_counter() - t_start:.1f} s)")

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trainer-") as d:
        trainer = trainer_phase(device, d, args.seed)
    trainer["phase_s"] = time.perf_counter() - t_phase
    log("trainer " + json.dumps(trainer))
    log_trainer(trainer)
    log(f"phase trainer: ok ({trainer['phase_s']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s)")

    # every main-path run's launches: phase 4, 7, 8 (both stores), 9, 10,
    # 11, 12
    for run in (dase, *ingest.values(), evaluation, similar,
                templates["ecommerce"], trainer):
        for form in FORMS:
            launches[form] += run["launches"].get(form, 0)
    log(f"launches over phases 4 and 7-12: {json.dumps(launches)}")

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
