"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests`` from the checkout's root; the ``gpu``-marked ones
skip without a CUDA card)."""

import dataclasses
import os

import pytest
import torch

from portbench.harness import spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture()
def tiny_cell():
    """``als-ml20m`` as BENCHMARK.json has it (traffic, metrics) at the
    test size of ``data/tiny.json``, with that size's limits: set, as
    the cell's are, from the program's largest residuals on an H100
    (res_users 4.85e-7, res_items 6.92e-7 over 13 seeds) and the TF32
    control's smallest (1.04e-4, 9.11e-5 over 13 seeds)."""
    cell = spec.load_cell("als-ml20m")
    return dataclasses.replace(
        cell, config=spec.read_json(os.path.join(DATA, "tiny.json")),
        limits=spec.read_json(os.path.join(DATA, "tiny_limits.json")))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)
