"""Atomic npz persistence for the view cache.

A copy of ``predictionio_tpu/utils/npzio.py``.
"""

from __future__ import annotations

import os

import numpy as np


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez_compressed`` that lands at ``path`` via rename, so
    readers never observe a half-written file. Parent dirs are created.
    """
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savez_compressed(tmp, **arrays)
    # np.savez appends .npz to the tmp name
    os.replace(f"{tmp}.npz", path)
