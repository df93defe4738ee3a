"""The readings a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 1] [--config FILE] [--out FILE]

For each of ``--seeds`` the cell runs as the benchmark runs it (a short
window, no trace) and prints its compared numbers; for each of
``--control-seeds`` it runs again with the control switched on: the
program's own float32 products allowed to run in TF32 on the tensor
cores (``torch.backends.cuda.matmul.allow_tf32``), the nearest precision
below the float32 that the configurations state. A sound limit lies
above every sound run's number and below every control's. The
benchmark's own runs never switch the control on.

One JSON line a run on standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as bench  # noqa: E402


def main(argv=None) -> int:
    t_start = time.perf_counter() - bench.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--config", help="a configuration file run in the "
                   "place of the cell's (a test size)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench.fix_caches(bench.ROOT)
    from portbench.harness import spec
    import torch

    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    if args.config:
        cell = dataclasses.replace(cell, config=spec.read_json(args.config))
    driver = spec.load_module("drivers", cell.traffic["driver"])
    lines = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.perf_counter()
            run = driver.run(cell, seed, args.seconds, False, device,
                             t_start, allow_tf32=control)
            line = {"workload": cell.name, "config": cell.config["name"],
                    "seed": seed, "control": control,
                    "checks": run.checks, "attempted": run.attempted,
                    "failed": run.failed, "steps": run.steps,
                    "window_s": run.window_s, "spans": run.spans,
                    "memory_peak_bytes": run.memory_peak_bytes,
                    "run_s": time.perf_counter() - t,
                    "device": run.device_kind}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
