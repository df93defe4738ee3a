"""The useful work of an ALS epoch, from the configuration's shapes alone.

Never read from the program's packs: padding, bucketing and sub-rows are
how the program does the work, not what the work is, so a change that
removes padding lowers the time and leaves these counts where they are.

Per half-step, with ``n`` rows solved, ``m`` opposite rows, ``k`` the
rank and ``nnz`` interactions:

* operations: each interaction adds ``c·y·yᵀ`` and ``c·y`` (``2k² +
  2k``); each row forms and solves its ``k × k`` system (Cholesky
  ``k³/3``, two triangular solves ``2k²``); ``YᵀY`` of the opposite
  factors (``2·m·k²``);
* bytes: each interaction's two ids and its value read once, the
  opposite factors read once, the solved factors written once.
"""

from __future__ import annotations

ELEM_BYTES = {"float32": 4}
ID_BYTES = 4  # int32 user and item ids


def half_step(n: int, m: int, nnz: int, k: int, elem: int) -> tuple:
    """``(operations, bytes)`` of solving ``n`` rows against ``m``."""
    flops = nnz * (2 * k * k + 2 * k) + n * (k ** 3 / 3 + 2 * k * k) \
        + 2 * m * k * k
    nbytes = nnz * (2 * ID_BYTES + elem) + m * k * elem + n * k * elem
    return flops, nbytes


def als_epoch(config: dict) -> dict:
    """One epoch (users, then items) of ``config``: its operations,
    bytes and ratings."""
    u, i = int(config["n_users"]), int(config["n_items"])
    nnz, k = int(config["n_interactions"]), int(config["rank"])
    elem = ELEM_BYTES[config["dtype"]]
    fu, bu = half_step(u, i, nnz, k, elem)
    fi, bi = half_step(i, u, nnz, k, elem)
    return {"flops": fu + fi, "bytes": bu + bi, "ratings": nnz}
