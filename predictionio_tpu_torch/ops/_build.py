"""Build and load the port's CUDA kernels (a shared library bound with ctypes).

Every ``*.cu`` under ``predictionio_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library with a plain
C interface, at first use, into ``build/kernels/`` at the repository root.
The file name carries a hash of the source and the flags, so an edited
source builds anew and an unchanged one loads from disk. Nothing here runs
at import: the CPU tests import every module and never start a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_INT64 = ctypes.c_longlong
_FLOAT = ctypes.c_float
#: C signatures, per library: every pointer and the stream as c_void_p
#: (a pointer passed without argtypes is cut to 32 bits)
SIGNATURES = {
    "fused_topk": {
        "pio_topk_pass1": [
            _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _VOIDP,
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOIDP,
        ],
        "pio_topk_pass2": [
            _VOIDP, _INT, _INT, _INT, _INT, _VOIDP, _VOIDP, _INT, _INT,
            _VOIDP, _VOIDP,
        ],
    },
    "als_solve": {
        "pio_als_solve": [
            _VOIDP, _INT64, _VOIDP, _INT64, _VOIDP, _INT64, _VOIDP, _FLOAT,
            _INT, _VOIDP, _INT, _INT, _INT, _VOIDP,
        ],
    },
    "als_gramian": {
        "pio_als_gramian": [
            _VOIDP, _INT64, _INT64, _INT, _VOIDP, _INT64, _VOIDP, _INT64,
            _VOIDP, _INT64, _INT, _INT, _INT, _FLOAT, _INT, _INT, _VOIDP,
            _VOIDP, _VOIDP, _INT, _VOIDP,
        ],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}
_lock = threading.Lock()  # guards _loaded/_build_locks only


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


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; the
    compiler's report (registers, shared memory, spills) is kept beside
    the library as ``.log``. Safe across processes: each writes a
    private temporary file and renames it into place."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(
        f"{' '.join(cmd)}\n{time.perf_counter() - t0:.3f} s\n"
        f"{proc.stdout}{proc.stderr}"
    )
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every C
    function's argument and result types declared. One build lock per
    library: a build (minutes of ``nvcc``) holds only its own, so a
    library already loaded, or another library's build, never waits
    behind it."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        # double-check: the thread we serialized behind may have
        # finished this exact library
        with _lock:
            lib = _loaded.get(name)
            if lib is not None:
                return lib
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        with _lock:
            _loaded[name] = lib
        return lib
