"""Port kernels on the card: tests marked ``gpu`` skip without one.

They import neither JAX nor the reference (a card's machine may have
neither), so they run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` holds every kernel against its plain version at the
main paths' shapes; these are the quick checks of the EmbeddingBag
dispatch and launch counting.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _inputs(rng, B, K, D, dtype, R=200):
    table = torch.from_numpy(rng.normal(size=(R + 1, D)).astype(np.float32))
    table[R] = 0.0  # sentinel row
    idx = rng.integers(0, R + 1, size=(B, K)).astype(np.int32)
    idx[::4, 0] = -1  # out of range on both sides: clamped
    idx[1::4, -1] = 10_000
    return table.to(dtype).cuda(), torch.from_numpy(idx).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,D,dtype,mode", [
    (512, 1, 32, torch.float32, "sum"), (5, 7, 10, torch.bfloat16, "sum"),
    (64, 3, 1, torch.float32, "mean")])
def test_bag_kernel_equals_plain_on_the_card(rng, B, K, D, dtype, mode):
    _card()
    t, i = _inputs(rng, B, K, D, dtype)
    n = bag.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(t, i, mode)  # a CUDA tensor launches the kernel
    assert bag.LAUNCHES["embedding_bag"] == n + 1
    want = ops.embedding_bag(t, i, mode, impl="plain")
    assert bag.LAUNCHES["embedding_bag"] == n + 1
    if mode == "sum":  # both add the K rows in the same order
        assert torch.equal(got, want)
    else:  # torch on the card divides by K as a product with 1/K
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_bag_kernel_reads_a_feature_column_in_place(rng):
    """A (B, F, K) batch's column has a bag stride of F*K: read in place."""
    _card()
    t, _ = _inputs(rng, 1, 1, 8, torch.float32)
    sparse = torch.from_numpy(
        rng.integers(0, 201, size=(33, 5, 2)).astype(np.int32)).cuda()
    got = bag.embedding_bag_cuda(t, sparse[:, 3, :])
    assert torch.equal(got, bag.embedding_bag_plain(t, sparse[:, 3, :]))
