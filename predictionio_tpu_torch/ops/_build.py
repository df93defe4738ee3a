"""The one path from the port's Python to its native code.

Two kinds of source, each compiled at first use into its own shared
library with a plain C interface and bound with ``ctypes``:

* ``native/<name>.cc`` (the packing fill pass and the event log, sources
  shared with the JAX package) by ``g++`` into
  ``build/native/libpio_<name>_<hash>.so``. Nothing is written under
  ``native/``, which the JAX package's loader owns;
* ``predictionio_tpu_torch/csrc/<name>.cu`` (the card's kernels) by
  ``nvcc`` for Hopper (``sm_90a``) into
  ``build/kernels/lib<name>_<hash>.so``.

The hash covers the source and the compiler's flags, so an edited source
builds anew and an unchanged one loads from disk. The compiler writes a
private temporary file that is ``os.replace``d into place, so a process
never loads a half-written library, and its report is kept beside the
library as ``<library>.log``. A failed build raises with the compiler's
output: nothing falls back. Nothing here runs at import (and torch is not
imported): the CPU tests import every module and never start a build.

The kernels' wrappers share the rest of the seam: one device rule
(:func:`on_card`), one launch step (:func:`launch`), one launch table
(:data:`LAUNCHES`, counted by :func:`count`) and one stride reader
(:func:`lead_stride`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Sequence
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
CSRC = Path(__file__).resolve().parent.parent / "csrc"
NATIVE_BUILD = _ROOT / "build" / "native"
KERNEL_BUILD = _ROOT / "build" / "kernels"
GXX = ("g++", "-O3", "-std=c++17", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c = ctypes
_VOIDP = _c.c_void_p
_INT = _c.c_int
_INT64 = _c.c_longlong
_FLOAT = _c.c_float
_U32 = _c.c_uint32
_P = _c.POINTER
#: per library, per C function: (restype, argtypes). The kernels take
#: every pointer and the stream as c_void_p (a pointer passed without
#: argtypes is cut to 32 bits) and return a CUDA error code.
SIGNATURES = {
    "alspack": {
        "pio_alspack_fill": (None, [
            _P(_c.c_int32), _P(_c.c_int32), _P(_FLOAT), _c.c_int64,
            _P(_c.c_int64), _P(_c.c_int64), _P(_c.c_int32), _P(_FLOAT),
            _P(_FLOAT),
        ]),
    },
    "eventlog": {
        "pio_log_open": (_VOIDP, [_c.c_char_p]),
        "pio_log_close": (_INT, [_VOIDP]),
        "pio_log_sync": (_INT, [_VOIDP]),  # 0 ok, -1 flush/fsync failed
        "pio_intern": (_U32, [_VOIDP, _c.c_char_p, _U32]),
        "pio_dict_reload": (_INT, [_VOIDP]),
        "pio_dict_size": (_c.c_uint64, [_VOIDP]),
        "pio_dict_get": (_U32, [_VOIDP, _U32, _c.c_char_p, _U32]),
        "pio_append": (_INT, [
            _VOIDP, _c.c_uint8, _c.c_double, _c.c_double, _U32, _U32, _U32,
            _c.c_int32, _c.c_int32, _c.c_char_p, _U32, _c.c_char_p, _U32,
        ]),
        "pio_scan": (_VOIDP, [
            _VOIDP, _c.c_double, _c.c_double, _P(_U32), _U32, _c.c_int64,
            _c.c_int64, _c.c_int64, _c.c_int64, _INT, _c.c_char_p, _U32,
        ]),
        "pio_result_n": (_c.c_uint64, [_VOIDP]),
        "pio_result_event_time": (_P(_c.c_double), [_VOIDP]),
        "pio_result_creation_time": (_P(_c.c_double), [_VOIDP]),
        "pio_result_event": (_P(_U32), [_VOIDP]),
        "pio_result_entity_type": (_P(_U32), [_VOIDP]),
        "pio_result_entity_id": (_P(_U32), [_VOIDP]),
        "pio_result_target_entity_type": (_P(_c.c_int32), [_VOIDP]),
        "pio_result_target_entity_id": (_P(_c.c_int32), [_VOIDP]),
        "pio_result_varlen": (_P(_c.c_uint8), [_VOIDP]),
        "pio_result_varlen_len": (_c.c_uint64, [_VOIDP]),
        "pio_result_free": (_INT, [_VOIDP]),
    },
    "fused_topk": {
        "pio_topk_pass1": (_INT, [
            _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _VOIDP,
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP,
        ]),
        "pio_topk_pass2": (_INT, [
            _VOIDP, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _INT, _INT,
            _VOIDP, _VOIDP,
        ]),
    },
    "als_solve": {
        "pio_als_solve": (_INT, [
            _VOIDP, _INT64, _VOIDP, _INT64, _VOIDP, _INT64, _VOIDP, _FLOAT,
            _INT, _VOIDP, _INT, _INT, _INT, _VOIDP,
        ]),
    },
    "als_gramian": {
        "pio_als_gramian": (_INT, [
            _VOIDP, _INT64, _INT64, _INT, _VOIDP, _INT64, _VOIDP, _INT64,
            _VOIDP, _INT64, _INT, _INT, _INT, _FLOAT, _INT, _INT, _VOIDP,
            _VOIDP, _VOIDP, _INT, _VOIDP,
        ]),
    },
    "als_heavy_add": {
        "pio_als_heavy_add": (_INT, [
            _VOIDP, _INT64, _VOIDP, _INT64, _VOIDP, _INT64, _INT, _INT,
            _VOIDP, _INT, _VOIDP, _INT, _VOIDP, _INT64, _INT, _VOIDP,
        ]),
    },
}

#: kernel launches: one per ALS launch (``als_gramian``, ``als_heavy_add``,
#: ``als_solve``) and one per ``fused_top_k_dot`` call on the card, per
#: item form (``fused_topk.f32``, ``.bf16``, ``.int8``); counted nowhere
#: else
LAUNCHES = dict.fromkeys(
    ("als_gramian", "als_heavy_add", "als_solve", "fused_topk.f32",
     "fused_topk.bf16", "fused_topk.int8"), 0)

_loaded: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}
_lock = threading.Lock()  # guards _build_locks and LAUNCHES, never a build


def source_path(name: str) -> Path:
    """``native/<name>.cc`` where it exists, else ``csrc/<name>.cu``."""
    cc = NATIVE_DIR / f"{name}.cc"
    return cc if cc.exists() else CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """The hashed library of ``name``'s current source."""
    src = source_path(name)
    if src.suffix == ".cc":
        flags, stem = GXX, NATIVE_BUILD / f"libpio_{name}"
    else:
        flags, stem = NVCC_FLAGS, KERNEL_BUILD / f"lib{name}"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return stem.with_name(f"{stem.name}_{digest}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build")


def compile_into(out: Path, compiler: Sequence[str], src: Path) -> Path:
    """Run ``compiler -o <tmp> src`` and rename the result to ``out``,
    with the command, its seconds and its report in ``out``'s ``.log``
    (for nvcc: registers, shared memory, spills). Safe across processes:
    each writes a private temporary file. Raises RuntimeError with the
    compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed for {src.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(
            f"{' '.join(cmd)}\n{time.perf_counter() - t0:.3f} s\n"
            f"{proc.stdout}{proc.stderr}"
        )
        os.replace(tmp, out)
    except OSError as e:
        raise RuntimeError(f"building {out.name} failed: {e}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def build(name: str) -> Path:
    """Compile ``name``'s source unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    src = source_path(name)
    compiler = GXX if src.suffix == ".cc" else (_nvcc(), *NVCC_FLAGS)
    return compile_into(out, compiler, src)


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib`` with every C function of library ``name`` typed."""
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, its functions
    typed. One build lock per library: a build (minutes of ``nvcc``)
    holds only its own, so a library already loaded, or another
    library's build, never waits behind it."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        # the thread we serialized behind may have loaded this library
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = declare(ctypes.CDLL(str(build(name))), name)
        return lib


def on_card(who: str, device: torch.device) -> bool:
    """The device rule: True on CUDA (the kernel), False on the CPU (the
    plain version); any other device raises ValueError."""
    if device.type == "cuda":
        return True
    if device.type != "cpu":
        raise ValueError(f"{who} runs on cuda or cpu, not {device}")
    return False


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call kernel entry point ``fn`` of library ``name`` with ``args``
    and, last, the current stream of ``device``; raises RuntimeError
    naming ``fn`` on a nonzero return."""
    import torch  # here, not at import: the event log loads without it

    rc = getattr(library(name), fn)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def count(key: str) -> None:
    """One more launch of ``key`` in :data:`LAUNCHES`."""
    with _lock:
        LAUNCHES[key] += 1


def lead_stride(t: torch.Tensor, who: str, name: str) -> int:
    """Elements from one leading item of ``t`` to the next, each item
    (the trailing dimensions) contiguous; read from the strides alone,
    with no tensor made."""
    shape, strides = t.shape, t.stride()
    want = 1
    for dim in range(len(shape) - 1, 0, -1):
        if shape[dim] > 1 and strides[dim] != want:
            raise ValueError(f"{who}: each item of {name} must be "
                             f"contiguous, got {list(shape)} strides "
                             f"{strides}")
        want *= shape[dim]
    return strides[0]
