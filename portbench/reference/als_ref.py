"""The plain reference for an ALS half-step: normal equations in float64.

Imports torch alone: nothing of the program, nothing of JAX. It works
from the interactions the benchmark generated and from factors the
program produced, which it only judges: for every row ``r`` that a
half-step solved, it rebuilds

* implicit (Hu, Koren, Volinsky): ``A = YᵀY + λI + Σ α·v·y·yᵀ``,
  ``b = Σ (1 + α·v)·y``;
* explicit (weighted λ): ``A = Σ y·yᵀ + λ·max(n, 1)·I``, ``b = Σ v·y``;

over the row's interactions (duplicates counted, as generated), with
``y`` the opposite factors that the half-step was given, and reads the
row's relative residual ``‖A·x − b‖ / ‖b‖`` in float64.

The sums per row are taken over blocks of interactions sorted by row: a
running sum (``cumsum``) over the block, differenced at the ends of each
row's run, so a row with millions of interactions costs no more than
many rows with few. The difference loses about ``eps64 × block length``
of the block's magnitude, some 1e-11 relative: far below what is judged.
"""

from __future__ import annotations

import torch

#: interactions a block (its float64 temporaries are about 3·8·k²/2
#: bytes each: ~0.8 GB at k = 32)
ENTRY_BLOCK = 1 << 16
#: rows whose sums are held at once (8·(k(k+1)/2 + k + 1 + k²) bytes
#: each)
ROW_BLOCK = 1 << 17


def side_residuals(x, y, rows, cols, vals, n_rows: int, reg: float,
                   alpha: float, implicit: bool, device,
                   entry_block: int = ENTRY_BLOCK,
                   row_block: int = ROW_BLOCK) -> dict:
    """Judge ``x [≥ n_rows, k]`` (the solved side) against ``y [m, k]``
    (the factors it was solved from) over the interactions ``rows[e]``
    (the solved side's ids), ``cols[e]`` (the opposite side's), ``vals``.

    Returns ``{"residual": float64 [n_rows] host tensor}``, NaN for rows
    with no interactions."""
    f64 = torch.float64
    x = x[:n_rows].to(device, f64)
    y = y.to(device, f64)
    k = y.shape[1]
    r = torch.as_tensor(rows, device=device).long()
    order = torch.argsort(r, stable=True)
    r = r[order]
    c = torch.as_tensor(cols, device=device).long()[order]
    v = torch.as_tensor(vals, device=device).to(f64)[order]
    del order
    ptr = torch.zeros(n_rows + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.bincount(r, minlength=n_rows).cumsum(0)
    gram = y.T @ y if implicit else None
    eye = torch.eye(k, dtype=f64, device=device)
    iu, ju = torch.triu_indices(k, k, device=device)
    n_tri = iu.numel()
    residual = torch.empty(n_rows, dtype=f64, device=device)
    for r0 in range(0, n_rows, row_block):
        r1 = min(n_rows, r0 + row_block)
        acc = torch.zeros((r1 - r0, n_tri + k + 1), dtype=f64,
                          device=device)
        e0, e1 = int(ptr[r0]), int(ptr[r1])
        for s in range(e0, e1, entry_block):
            t = min(e1, s + entry_block)
            rr, yt, vv = r[s:t], y[c[s:t]].T, v[s:t]
            if implicit:
                aw, bw = alpha * vv, 1.0 + alpha * vv
            else:
                aw, bw = torch.ones_like(vv), vv
            # [k(k+1)/2 + k + 1, E]: the upper triangle of each y·yᵀ (A is
            # symmetric), then b's terms and a count; the scan runs along
            # the last, contiguous dimension (down the rows of [E, ·] it
            # would be one long dependent loop a column)
            parts = torch.cat([
                yt[iu] * (yt[ju] * aw),
                yt * bw,
                torch.ones((1, t - s), dtype=f64, device=device),
            ]).cumsum_(1)
            ends = torch.nonzero(rr[1:] != rr[:-1]).squeeze(1)
            ends = torch.cat([ends, ends.new_tensor([t - s - 1])])
            sums = parts[:, ends]
            sums[:, 1:] -= parts[:, ends[:-1]]
            acc.index_add_(0, rr[ends] - r0, sums.T)
            del parts, sums
        cnt = acc[:, -1]
        b = acc[:, n_tri:n_tri + k]
        a = torch.empty((r1 - r0, k, k), dtype=f64, device=device)
        a[:, iu, ju] = acc[:, :n_tri]
        a[:, ju, iu] = acc[:, :n_tri]
        if implicit:
            a += gram + reg * eye
        else:
            a += (reg * cnt.clamp(min=1.0))[:, None, None] * eye
        xb = x[r0:r1]
        res = torch.linalg.vector_norm(
            torch.bmm(a, xb.unsqueeze(-1)).squeeze(-1) - b, dim=1)
        # a non-finite solve reads as an infinite residual, never as NaN
        res = torch.nan_to_num(res / torch.linalg.vector_norm(b, dim=1),
                               nan=torch.inf)
        residual[r0:r1] = torch.where(cnt == 0, torch.nan, res)
        del acc, a, b
    return {"residual": residual.cpu()}
