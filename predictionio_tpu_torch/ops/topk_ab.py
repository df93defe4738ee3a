"""Time the fused top-k kernel of two source trees on one card, in turns.

    python -m predictionio_tpu_torch.ops.topk_ab --other DIR [--order ABBA]

``DIR`` is a second checkout of the repository (for instance an earlier
commit unpacked with ``git archive`` into an ignored directory). Each
turn runs in a process of its own whose ``predictionio_tpu_torch`` is
that tree's, so each tree builds and times its own ``csrc/fused_topk.cu``;
``A`` is the tree this module lives in, ``B`` the other. Every turn
times the float32 kernel, with random inputs from one seed, at the
serving shapes (B = 1, 64, 256 over 1,048,576 items, k 32, num 10), the
evaluation shape (B = 32,768 over 4,925 items, k 32, num 16) and the
e-commerce shape (B = 1 over 5,000 items, k 16, num 64): the mean of 50
calls between CUDA events, and the device time of pass 1 plus pass 2
from the profiler. Prints one JSON line a turn, then the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (  # (name, batch, items, k, num)
    ("serve_b1", 1, 1_048_576, 32, 10),
    ("serve_b64", 64, 1_048_576, 32, 10),
    ("serve_b256", 256, 1_048_576, 32, 10),
    ("eval", 32_768, 4_925, 32, 16),
    ("ecommerce", 1, 5_000, 16, 64),
)

_TURN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from predictionio_tpu_torch.ops import fused_topk
assert fused_topk.__file__.startswith(sys.argv[1]), fused_topk.__file__
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
out = {"tree": sys.argv[1]}
for name, b, n, k, num in json.loads(sys.argv[2]):
    g = torch.Generator(device=dev).manual_seed(b + n + k)
    q = torch.randn(b, k, generator=g, device=dev)
    items = torch.randn(n, k, generator=g, device=dev)
    call = lambda: fused_topk.fused_top_k_dot(q, items, num)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        call()
    stop.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if "topk_pass" in e.key)
    out[name] = {"call_ms": start.elapsed_time(stop) / 50,
                 "device_ms": dev_us / 1e3 / 20}
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the second checkout (tree B)")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args()
    trees = {
        "A": os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "B": os.path.abspath(args.other),
    }
    for turn in args.order:
        proc = subprocess.run(
            [sys.executable, "-c", _TURN, trees[turn], json.dumps(SHAPES)],
            capture_output=True, text=True, timeout=1200,
        )
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(f"{turn} {proc.stdout.strip().splitlines()[-1]}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
