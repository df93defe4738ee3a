"""Where a fresh process's start goes before it does any work.

    python -m predictionio_tpu_torch.utils.child_start [--reps 3]
        [--out build/child_start.json] [--device cuda]
        [--pycache DIR]

Run from the root of a checkout, after the fused top-k library is built
(``chip_smoke.py`` builds it). Each repetition starts fresh processes
and reads, from the parent's spawn:

* ``python -c pass``: the interpreter alone;
* a probe child that stamps the wall clock after each stage: ``import
  numpy``; ``import torch``; the port's modules a device verb of the
  console imports (the console, the workflow, the engine server, the
  recommendation template, ALS, the fused top-k wrapper); the CUDA
  context (``torch.zeros(1, device=...)`` and a synchronize); the kernel
  library (``ops._build.library("fused_topk")``, built already); the
  first cuBLAS product; the first cuSOLVER call
  (``parallel.mesh.load_cuda_linalg``); the exit;
* the console's ``version`` verb (no torch) and ``status`` verb (torch
  and a context) to their exit.

Then ``python -X importtime`` of the probe's imports, whose 25 largest
cumulative entries are written with the rest to ``--out``. With
``--pycache DIR``, the repetitions run again with the children's
bytecode kept in ``DIR`` (``PYTHONPYCACHEPREFIX``, and
``PYTHONDONTWRITEBYTECODE`` unset): one run fills it, then the same
readings. Prints one JSON object: each stage's median seconds over the
repetitions (and with the cache).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: the stages the probe stamps, in order
STAGES = ("numpy", "torch", "port_modules", "cuda_context",
          "kernel_library", "cublas", "cusolver", "exit")

PROBE = r"""
import json, sys, time
marks = {"start": time.time()}
import numpy
marks["numpy"] = time.time()
import torch
marks["torch"] = time.time()
import predictionio_tpu_torch.cli.main
import predictionio_tpu_torch.core.workflow
import predictionio_tpu_torch.serving.engine_server
import predictionio_tpu_torch.models.recommendation
import predictionio_tpu_torch.ops.als
import predictionio_tpu_torch.ops.fused_topk
marks["port_modules"] = time.time()
if sys.argv[1] != "imports":
    dev = torch.device(sys.argv[1])
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    marks["cuda_context"] = time.time()
    if dev.type == "cuda":
        from predictionio_tpu_torch.ops import _build
        _build.library("fused_topk")
    marks["kernel_library"] = time.time()
    a = torch.ones(64, 64, device=dev)
    (a @ a).sum().item()
    marks["cublas"] = time.time()
    from predictionio_tpu_torch.parallel.mesh import load_cuda_linalg
    load_cuda_linalg(dev)
    spd = a + 64 * torch.eye(64, device=dev)
    torch.linalg.cholesky_ex(spd)[0].sum().item()
    marks["cusolver"] = time.time()
marks["exit"] = time.time()
print(json.dumps(marks))
"""


def _run(argv: list, env: dict) -> tuple[float, str]:
    t0 = time.time()
    out = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode:
        raise RuntimeError(f"{argv[:4]} exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return t0, out.stdout


def _importtime(env: dict) -> list:
    """The 25 largest cumulative entries of ``-X importtime`` for the
    probe's imports: (seconds, module)."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-c", PROBE, "imports"],
        env=env, capture_output=True, text=True, timeout=600)
    rows = []
    for line in out.stderr.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[1].strip().isdigit():
            rows.append((int(parts[1]) / 1e6, parts[2].rstrip()))
    rows.sort(reverse=True)
    return rows[:25]


def measure(reps: int, device: str, env: dict | None = None) -> dict:
    env = env or dict(os.environ, PYTHONPATH=os.getcwd())
    runs = []
    for _ in range(reps):
        row = {}
        t0, _out = _run([sys.executable, "-c", "pass"], env)
        row["interpreter"] = time.time() - t0
        t0, out = _run([sys.executable, "-c", PROBE, device], env)
        marks = json.loads(out.strip().splitlines()[-1])
        row["probe_start"] = marks["start"] - t0
        prev = marks["start"]
        for stage in STAGES:
            if stage in marks:
                row[stage] = marks[stage] - prev
                prev = marks[stage]
        row["probe_total"] = time.time() - t0
        for verb in (["version"], ["status"]
                     + ([] if device.startswith("cuda") else
                        ["--device", device])):
            t0, _out = _run([sys.executable, "-m",
                             "predictionio_tpu_torch.cli.main", *verb], env)
            row[f"console_{verb[0]}"] = time.time() - t0
        runs.append(row)
    median = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return {"reps": runs, "median_s": median,
            "importtime_s": _importtime(env),
            "PYTHONDONTWRITEBYTECODE": env.get("PYTHONDONTWRITEBYTECODE"),
            "torch_bytecode_files": _torch_bytecode_files()}


def _torch_bytecode_files() -> int:
    """Bytecode files shipped beside torch's top-level sources."""
    import importlib.util

    cache = os.path.join(os.path.dirname(
        importlib.util.find_spec("torch").origin), "__pycache__")
    return len(os.listdir(cache)) if os.path.isdir(cache) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--pycache", default="")
    args = ap.parse_args(argv)
    result = measure(args.reps, args.device)
    summary = {"child_start_median_s": result["median_s"],
               "importtime_top5_s": result["importtime_s"][:5],
               "PYTHONDONTWRITEBYTECODE": result["PYTHONDONTWRITEBYTECODE"],
               "torch_bytecode_files": result["torch_bytecode_files"]}
    if args.pycache:
        env = dict(os.environ, PYTHONPATH=os.getcwd(),
                   PYTHONPYCACHEPREFIX=os.path.abspath(args.pycache))
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        t0, _out = _run([sys.executable, "-c", PROBE, "imports"], env)
        result["pycache_fill_s"] = time.time() - t0
        result["pycache"] = measure(args.reps, args.device, env)
        summary["pycache_fill_s"] = result["pycache_fill_s"]
        summary["with_pycache_median_s"] = result["pycache"]["median_s"]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
