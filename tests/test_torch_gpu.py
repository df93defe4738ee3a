"""The fused top-k CUDA kernel against its plain version, on the card.

These tests need a CUDA card (the kernel has no CPU form) and skip
elsewhere; the file imports no JAX, so it also runs where only PyTorch
is installed: ``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest``
(the suite's conftest imports JAX).
Tolerance: scores within 1e-4 absolute + 1e-5 relative (the kernel sums
the k products in order, cuBLAS in another). Indices are equal except
where two items' plain scores tie within that tolerance, where the two
summation orders may rank them either way; planted exact ties must come
lower index first.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops.quantize import quantize_factors

FORMS = ("f32", "bf16", "int8")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(form, b, n, k, seed, device):
    """Queries, items in ``form``, scale, and an [I] mask, on ``device``,
    with NaN row 5 and exact ties at rows 1, 9000 and 19000."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    items = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    items[[1, 9_000, 19_000]] = items[1] * 6.0
    mask = torch.from_numpy(rng.random(n) < 0.1)
    scale = None
    if form == "int8":
        qf = quantize_factors(items, "int8")
        items, scale = qf.data, qf.scale.clone()
        scale[5] = float("nan")
    else:
        items[5] = float("nan")
        if form == "bf16":
            items = items.to(torch.bfloat16)
    return (q.to(device), items.to(device), mask.to(device),
            None if scale is None else scale.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("batch", [1, 2, 3, 7, 9, 32, 33, 64, 65])
@pytest.mark.parametrize("num", [1, 10, 20, 128, fused_topk.NUM_CAP + 100])
def test_kernel_matches_plain_version_on_card(cuda_device, form, batch,
                                               num):
    _check_against_plain(cuda_device, form, batch, 32, num)


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", [33, 256])
def test_kernel_matches_plain_version_at_row_widths(cuda_device, form, k):
    """k = 33: rows off the 16-byte grid take the plain-load copy; k = 256:
    the widest rows, streamed in several chunks along k."""
    _check_against_plain(cuda_device, form, 33, k, 10)


def _check_against_plain(cuda_device, form, batch, k, num):
    q, items, mask, scale = _inputs(form, batch, 20_011, k, num,
                                    cuda_device)
    before = fused_topk.LAUNCHES[form]
    ks, ki = fused_topk.fused_top_k_dot(q, items, num, mask, scale)
    torch.cuda.synchronize()
    assert fused_topk.LAUNCHES[form] == before + 1
    ps, pi = fused_topk.fused_top_k_dot_reference(q, items, num, mask,
                                                  scale)
    np.testing.assert_allclose(ks.cpu(), ps.cpu(), rtol=1e-5, atol=1e-4)
    rows, cols = torch.nonzero(ki != pi, as_tuple=True)
    # a differing index must score, in plain arithmetic, what the plain
    # version's item at that slot scores
    picked = ki[rows, cols].long()
    rescored = (q[rows].double() * items[picked].double()).sum(1)
    if scale is not None:
        rescored = rescored * scale[picked].double()
    want = ps[rows, cols].double()
    assert ((rescored - want).abs() <= 1e-4 + 1e-5 * want.abs()).all()
    assert not mask[picked].any()
    finite = ~torch.isneginf(ks)
    for row, keep in zip(ki.cpu(), finite.cpu()):
        assert len(set(row[keep].tolist())) == int(keep.sum())
    ties = [1, 9_000, 19_000]
    for row in ki.cpu().tolist():
        seen = [i for i in row if i in ties]
        assert seen == sorted(seen)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, items, mask, _ = _inputs("f32", 3, 20_011, 8, 0, cuda_device)
    with pytest.raises(ValueError):
        fused_topk.fused_top_k_dot(q.double(), items, 5)
    with pytest.raises(ValueError):
        fused_topk.fused_top_k_dot(q, items.T, 5)
    with pytest.raises(ValueError):
        fused_topk.fused_top_k_dot(q, items.cpu(), 5)
    with pytest.raises(ValueError):
        fused_topk.fused_top_k_dot(q, items, 5, mask[:10])
