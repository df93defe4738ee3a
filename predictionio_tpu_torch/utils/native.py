"""Build and load the repo's native C++ libraries (``native/*.cc``).

The port's own loader, in the place of ``predictionio_tpu/utils/native.py``
(which builds ``native/libpio_<name>.so`` and owns that directory). This
one never writes under ``native/``: ``g++ -O3 -std=c++17 -shared -fPIC``
compiles ``native/<name>.cc`` into
``build/native/libpio_<name>_<hash>.so``, the hash taken over the source
and the flags, so an edited source builds anew and a built library is
reused. The compiler writes a temporary file that is ``os.replace``d
into place, so a process never loads a half-written library. A failed
build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
GXX = ("g++", "-O3", "-std=c++17", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}
_lock = threading.Lock()  # guards the two dicts only, never a build


def source_path(name: str) -> Path:
    return NATIVE_DIR / f"{name}.cc"


def library_path(name: str) -> Path:
    """``build/native/libpio_<name>_<hash>.so`` for the current source."""
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(GXX).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libpio_{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cc`` unless its library exists; returns
    the library's path. Raises RuntimeError with the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [*GXX, "-o", str(tmp), str(source_path(name))],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"building libpio_{name} failed:\n{detail}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle to ``libpio_<name>``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        build_lock = _build_locks.setdefault(name, threading.Lock())
    with build_lock:
        with _lock:
            lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            with _lock:
                _loaded[name] = lib
        return lib
