"""The plain reference judges every row: it agrees with a dense float64
solve, and it fails a planted wrong row on either side, from a regular
slab and from heavy sub-row sums alike."""

import numpy as np
import pytest
import torch

from portbench.harness import generate, spec
from portbench.reference import als_ref
from predictionio_tpu_torch.parallel.mesh import ComputeContext

@pytest.fixture()
def solved(tiny_cell):
    return solve(tiny_cell.config, tiny_cell.traffic)


def solve(cfg, traffic):
    gen = generate.generator(99, "cpu")
    data = generate.interactions(cfg, gen, traffic, "cpu")
    k = cfg["rank"]
    ctx = ComputeContext.create(device="cpu")
    drv = spec.load_module("drivers", "als_epochs")
    step, nu_pad, ni_pad = drv.compose(ctx, *data, cfg, {})
    y0 = drv.initial_items(ni_pad, cfg, gen, torch.device("cpu"))
    x, y = step(torch.zeros((nu_pad, k)), y0, cfg["reg"], 1)
    return cfg, data, y0, x, y


def judge(cfg, data, y_in, x, y):
    rows, cols, vals = data
    kw = dict(reg=cfg["reg"], alpha=cfg["alpha"], implicit=cfg["implicit"],
              device="cpu")
    u = als_ref.side_residuals(x, y_in[:cfg["n_items"]], rows, cols, vals,
                               cfg["n_users"], **kw)
    i = als_ref.side_residuals(y, x[:cfg["n_users"]], cols, rows, vals,
                               cfg["n_items"], **kw)
    return u, i


def test_reference_matches_dense_solve(solved):
    cfg, (rows, cols, vals), y_in, x, _ = solved
    yy = y_in[:cfg["n_items"]].double().numpy()
    k, lam, alpha = cfg["rank"], cfg["reg"], cfg["alpha"]
    # small blocks, so rows and runs of interactions cross block ends
    residual = als_ref.side_residuals(
        x, y_in[:cfg["n_items"]], rows, cols, vals, cfg["n_users"],
        reg=lam, alpha=alpha, implicit=True, device="cpu",
        entry_block=1000, row_block=7)["residual"]
    deg = np.bincount(rows, minlength=cfg["n_users"])
    # the heaviest users, and every 50th: heavy and light rows
    picks = sorted(set(np.argsort(-deg)[:8].tolist())
                   | set(range(0, cfg["n_users"], 50)))
    for r in picks:
        sel = rows == r
        yg, w = yy[cols[sel]], vals[sel].astype(np.float64)
        a = yy.T @ yy + lam * np.eye(k) + (yg * (alpha * w)[:, None]).T @ yg
        b = ((1 + alpha * w)[:, None] * yg).sum(0)
        dense = np.linalg.solve(a, b)
        got = x[r].double().numpy()
        want = np.linalg.norm(a @ got - b) / np.linalg.norm(b)
        res = residual[r]
        assert abs(float(res) - want) <= 1e-9 * max(want, 1e-12) + 1e-15
        assert np.allclose(got, dense, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("implicit", [True, False])
def test_program_rows_pass(tiny_cell, implicit):
    cfg, data, y_in, x, y = solve(dict(tiny_cell.config, implicit=implicit),
                                  tiny_cell.traffic)
    u, i = judge(cfg, data, y_in, x, y)
    for side in (u, i):
        r = side["residual"].numpy()
        assert not np.isnan(r).any()  # every row has interactions
        assert r.max() < 1e-5


@pytest.mark.parametrize("side", ["users", "items"])
@pytest.mark.parametrize("kind", ["slab", "heavy"])
def test_planted_wrong_row_fails(tiny_cell, solved, side, kind):
    cfg, data, y_in, x, y = solved
    limit = tiny_cell.limits["res_" + side]
    rows = data[0] if side == "users" else data[1]
    n = cfg["n_users"] if side == "users" else cfg["n_items"]
    deg = np.bincount(rows, minlength=n)
    heavy = 16 * 64  # train_als's s_max blocks of block_len
    pick = np.nonzero(deg > heavy if kind == "heavy"
                      else (deg > 0) & (deg <= heavy))[0]
    assert len(pick), (side, kind)
    row = int(pick[len(pick) // 2])
    x, y = x.clone(), y.clone()
    target = x if side == "users" else y
    target[row] *= 1.001  # one answer altered by a tenth of a percent
    u, i = judge(cfg, data, y_in, x, y)
    res = (u if side == "users" else i)["residual"].numpy()
    assert res[row] > limit
    others = np.delete(res, row)
    assert np.nanmax(others) < 1e-5
