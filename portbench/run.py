"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for (it exits 2, printing no result, with fewer). The cell
names its configuration and traffic; the traffic names the window driver
(``portbench/drivers/<driver>.py``), which sets up the port, measures
for ``S`` seconds and has the plain reference judge what the window
produced. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer ones, each read by ``portbench/metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), ``breakdown`` with ``--trace 1``, and
last ``checks``, each compared number with its limit; the same numbers
are the last lines of standard error. The run exits 1 with no result if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``predictionio_tpu`` is
loaded once the window has closed.

Python's bytecode and every cache a library could write go under
``build/portbench/`` in the checkout, at fixed paths, so only the first
run in a checkout compiles.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that may not be loaded in a run
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "predictionio_tpu"})
#: the program's environment knobs that would change the work measured
PROGRAM_KNOBS = ("PIO_ALS_MAX_SLAB_SLOTS", "PIO_ALS_COMPUTE_DTYPE",
                 "PIO_NO_NATIVE", "PIO_TRAIN_CHAOS")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time, in clock ticks since boot)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def fix_caches(root: str) -> None:
    """Bytecode, and the caches of torch's C++ extensions, Triton and
    the CUDA JIT, in fixed directories under ``root/build/portbench``;
    the program's knobs out of the environment."""
    cache = os.path.join(root, "build", "portbench")
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    for knob in PROGRAM_KNOBS:
        os.environ.pop(knob, None)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result object."""
    from portbench.harness import spec

    driver = spec.load_module("drivers", cell.traffic["driver"])
    run = driver.run(cell, seed, seconds, trace, device, t_start)
    print(f"window: {run.steps} steps in {run.window_s!r} s; set-up "
          f"{run.setup_s!r} s, spans {run.spans}", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m.name).read(run)
        if value is None:  # nothing to read in this cell's run
            print(f"portbench: {m.name} not read in {cell.name}",
                  file=sys.stderr)
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_kind, "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(v <= lim for v, lim in run.checks.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in run.checks.items()}
    return out


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    args = parse(argv)
    fix_caches(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
