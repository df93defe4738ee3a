"""The control on the card, at a size a test run holds: the program with
its float32 products let run in TF32 must come out not correct, and the
program as the configuration states it correct. At the cells' own size
the same control runs by ``portbench/readings.py``."""

import time

import pytest

from portbench.harness import spec

driver = spec.load_module("drivers", "als_epochs")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 3])
def test_tf32_control_fails_and_float32_passes(tiny_cell, cuda_device,
                                               seed):
    sound = driver.run(tiny_cell, seed, 0.2, False, cuda_device,
                       time.perf_counter())
    control = driver.run(tiny_cell, seed, 0.2, False, cuda_device,
                         time.perf_counter(), allow_tf32=True)
    assert all(v <= lim for v, lim in sound.checks.values()), sound.checks
    assert not all(v <= lim for v, lim in control.checks.values()), \
        control.checks
