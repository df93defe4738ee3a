"""The interaction generator: repeatable by seed, every seed the same
degrees, the published heads and floors kept, no pair twice."""

import numpy as np
import pytest
import torch

from portbench.harness import generate, spec

TRAFFIC = {"value_min": 1, "value_max": 5}


@pytest.fixture()
def cfg(tiny_cell):
    return tiny_cell.config


def draw(cfg, seed):
    return generate.interactions(cfg, generate.generator(seed, "cpu"),
                                 TRAFFIC, "cpu")


def test_repeats_by_seed_and_seeds_differ(cfg):
    big = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits
    a, b, c = draw(cfg, big), draw(cfg, big), draw(cfg, big + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 7])
def test_every_seed_has_the_published_degrees_and_no_pair_twice(cfg, seed):
    rows, cols, vals = draw(cfg, seed)
    nu, ni = cfg["n_users"], cfg["n_items"]
    assert rows.dtype == np.int32 and cols.dtype == np.int32
    assert vals.dtype == np.float32
    assert set(np.unique(vals).tolist()) == {1.0, 2.0, 3.0, 4.0, 5.0}
    for ids, n, side in ((rows, nu, "users"), (cols, ni, "items")):
        got = np.sort(np.bincount(ids, minlength=n))[::-1]
        want = generate.degrees(cfg["degrees"][side], n,
                                cfg["n_interactions"], "cpu").numpy()
        assert np.array_equal(got, want), side
    pairs = rows.astype(np.int64) * ni + cols
    assert np.unique(pairs).size == pairs.size


@pytest.mark.parametrize("side", ["users", "items"])
def test_degrees_keep_the_head_floor_and_total(side):
    cfg = spec.read_json(spec.ROOT + "/portbench/configs/rec-ml20m-r32.json")
    stats = cfg["degrees"][side]
    n = cfg["n_users"] if side == "users" else cfg["n_items"]
    d = generate.degrees(stats, n, cfg["n_interactions"], "cpu")
    assert int(d.sum()) == cfg["n_interactions"]
    assert d[:len(stats["head"])].tolist() == stats["head"]
    assert int(d.min()) >= stats["min"]
    assert bool((d[:-1] >= d[1:]).all())
    # a tail, not a fold: no row past the head above the head's last
    assert int(d[len(stats["head"]):].max()) <= stats["head"][-1]


def test_a_law_that_cannot_hold_is_refused():
    with pytest.raises(ValueError):
        generate.degrees({"law": "lognormal", "min": 50, "head": [100]},
                         10, 2000, "cpu")


def test_seed_is_masked_not_refused():
    assert isinstance(generate.generator(-5, "cpu"), torch.Generator)
