"""Where pass 1 of the fused top-k kernel spends its time, on the card.

    python -m predictionio_tpu_torch.ops.topk_profile [--items N] [--num N]

Builds ``csrc/fused_topk.cu`` twice (as served, and with
``-DPIO_TOPK_PROFILE``, which adds up each warp's clock cycles by phase of
a pass-1 step), then, for the float32, bfloat16 and int8 forms at
B = 1, 8, 64, 256 over a random rank-32 table, prints pass 1's plan, its
time per launch in both builds (CUDA events over 20 launches) and each
phase's share of the cycles. Needs a CUDA card and nvcc; exits 1
without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

PHASES = ("copy_wait", "barrier", "fold_flag", "copy_issue", "dot",
          "threshold", "append", "fold")
BATCHES = (1, 8, 64, 256)


def _build_profiled():
    """The kernel library built with the phase counters."""
    from predictionio_tpu_torch.ops import _build

    out = _build.compile_into(
        _build.KERNEL_BUILD / "libfused_topk_profile.so",
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DPIO_TOPK_PROFILE"],
        _build.source_path("fused_topk"))
    lib = _build.declare(ctypes.CDLL(str(out)), "fused_topk")
    lib.pio_topk_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.pio_topk_phase_cycles.restype = ctypes.c_int
    return lib


def _pass1(lib, plan, q, items, scale, num, partial, stream):
    from predictionio_tpu_torch.ops import fused_topk

    b, k = q.shape
    rc = lib.pio_topk_pass1(
        plan.qt, q.data_ptr(), items.data_ptr(),
        fused_topk._DTYPE_CODE[fused_topk._FORMS[items.dtype]],
        scale.data_ptr() if scale is not None else None, None, 0, None,
        partial.data_ptr(), b, items.shape[0], k, num, plan.region,
        plan.split_len, plan.splits, 1, stream,
    )
    if rc != 0:
        raise RuntimeError(f"pass 1 launch failed: CUDA error {rc}")


def _ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--items", type=int, default=1_048_576)
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from predictionio_tpu_torch.ops import _build, fused_topk
    from predictionio_tpu_torch.ops.quantize import quantize_factors

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    served = _build.library("fused_topk")
    profiled = _build_profiled()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    table = torch.randn(args.items, 32, generator=g, device=dev)
    forms = {"f32": (table, None)}
    for form in ("bf16", "int8"):
        qf = quantize_factors(table, form)
        forms[form] = (qf.data, qf.scale)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    for form, (items, scale) in forms.items():
        for b in BATCHES:
            q = torch.randn(b, 32, generator=g, device=dev)
            plan = fused_topk.plan_pass1(b, args.items, args.num, 32,
                                         items.element_size(), n_sms)
            partial = torch.empty((b, plan.splits, args.num),
                                  dtype=torch.int64, device=dev)

            def run(lib):
                return lambda: _pass1(lib, plan, q, items, scale, args.num,
                                      partial, stream)

            ms = _ms(run(served))
            ms_profiled = _ms(run(profiled))
            profiled.pio_topk_phase_cycles(cycles)  # zero the counters
            run(profiled)()
            torch.cuda.synchronize()
            profiled.pio_topk_phase_cycles(cycles)
            total = sum(cycles) or 1
            shares = " ".join(f"{name}={100 * c / total:.1f}%"
                              for name, c in zip(PHASES, cycles))
            print(f"{form:4s} B={b:<3d} plan=qt{plan.qt}/it{plan.item_tile}/"
                  f"R{plan.region}/stages{plan.stages}/splits{plan.splits} "
                  f"pass1_ms={ms:.4f} profiled_ms={ms_profiled:.4f} "
                  f"{shares}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
