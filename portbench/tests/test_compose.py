"""The harness's epoch loop is ``train_als``'s one-device path, bit for
bit: a change to that path shows up here."""

import numpy as np
import pytest
import torch

from portbench.harness import generate, spec
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel.mesh import ComputeContext

driver = spec.load_module("drivers", "als_epochs")


@pytest.mark.parametrize("epochs", [1, 3])
def test_composition_equals_train_als(tiny_cell, epochs):
    cfg = tiny_cell.config
    nu, ni, k = cfg["n_users"], cfg["n_items"], cfg["rank"]
    gen = generate.generator(2 ** 33 + 1, "cpu")
    rows, cols, vals = generate.interactions(cfg, gen, tiny_cell.traffic,
                                             "cpu")
    want = als.train_als(
        ComputeContext.create(device="cpu"), rows, cols, vals, nu, ni,
        rank=k, iterations=epochs, reg=cfg["reg"], alpha=cfg["alpha"],
        implicit=cfg["implicit"], seed=5)

    spans = {}
    step, nu_pad, ni_pad = driver.compose(
        ComputeContext.create(device="cpu"), rows, cols, vals, cfg, spans)
    y = torch.zeros((ni_pad, k))
    y[:ni] = torch.from_numpy(als._cold_init(ni, k, 5, torch.float32))
    x = torch.zeros((nu_pad, k))
    for _ in range(epochs):
        x, y = step(x, y, cfg["reg"], 1)
    assert np.array_equal(x[:nu].numpy(), want.user_factors)
    assert np.array_equal(y[:ni].numpy(), want.item_factors)
    assert set(spans) == {"pack", "stage"}


def test_composition_reads_train_als_defaults():
    assert driver.packing_defaults() == {"block_len": 64, "s_max": 16,
                                         "max_slab_slots": 0}
