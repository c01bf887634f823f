"""The mask kernel's fused log-sum-exp, modelled on the CPU.

``kernels.vntk.row_lse_model`` follows the kernel's fold (``fill_and_lse``
in ``csrc/vntk.cu``): each worker's float4s, or its scalars, folded into an
online ``(m, s)`` pair from ``m = -FLT_MAX``, the pairs merged per warp and
then in warp order.  Its log-probs ``(x - m) - lse`` must agree with
``torch.log_softmax`` within 1e-5 and never be NaN, on the rows the kernel
has to get right: ``-inf`` entries, one finite value, bf16-rounded logits
up to 1e4, ``V % 4 != 0`` (the scalar path) and ``V`` below the worker
count.  One case runs the JAX reference's fused Pallas kernel in interpret
mode on a small trie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core.trie import build_flat_trie
from repro.kernels.vntk import vntk_fused_logsoftmax_pallas
from repro_torch.core.vntk import vntk_reference_scatter
from repro_torch.kernels.vntk import row_lse_model

from conftest import make_sids


def _logits(rng, nb, V, scale=4.0, neg_inf=0.0, bf16=True):
    """``(nb, V)`` float32 logits of the given scale, bf16-rounded like the
    model's, a ``neg_inf`` share of each row at -inf (one entry kept
    finite)."""
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * scale)
    if bf16:
        x = x.to(torch.bfloat16).float()
    if neg_inf:
        dead = torch.from_numpy(rng.random((nb, V)) < neg_inf)
        dead[:, rng.integers(0, V)] = False
        x[dead] = -float("inf")
    return x


def _check(x, threads, vec):
    m, lse = row_lse_model(x, threads, vec)
    got = (x - m[:, None]) - lse[:, None]
    assert not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, torch.log_softmax(x, -1), rtol=1e-5,
                               atol=1e-5)
    return got


@settings(max_examples=120, deadline=None)
@given(V=st.integers(1, 700), threads=st.sampled_from([64, 128, 256]),
       scale=st.sampled_from([1.0, 4.0, 30.0, 1e4]),
       neg_inf=st.sampled_from([0.0, 0.3, 0.97]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_model_equals_log_softmax(V, threads, scale, neg_inf, seed):
    x = _logits(np.random.default_rng(seed), 5, V, scale, neg_inf)
    _check(x, threads, vec=False)
    if V % 4 == 0:
        _check(x, threads, vec=True)


@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("case", [
    "-inf entries", "one finite", "bf16 1e4", "V % 4 != 0", "V < workers",
    "two batches", "ties"])
def test_model_edge_cases(threads, case):
    rng = np.random.default_rng(threads)
    V, kw = 2048, {}
    if case == "-inf entries":
        kw["neg_inf"] = 0.5
    elif case == "bf16 1e4":
        kw["scale"] = 1e4
    elif case == "V % 4 != 0":
        V = 2046
    elif case == "V < workers":
        V = 40
    elif case == "two batches":  # more float4s than one batch of loads
        V = 40_000
    x = _logits(rng, 6, V, **kw)
    if case == "one finite":
        x[:] = -float("inf")
        x[torch.arange(6), torch.from_numpy(rng.integers(0, V, 6))] = 3.0
    elif case == "ties":
        x = (x * 2).round() / 2
    got = _check(x, threads, vec=False)
    if V % 4 == 0:
        torch.testing.assert_close(_check(x, threads, vec=True), got,
                                   rtol=1e-5, atol=1e-5)
    if case == "one finite":
        assert bool(((got == 0) | (got == -float("inf"))).all())


def test_model_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="V % 4"):
        row_lse_model(x, 256, vec=True)
    with pytest.raises(ValueError, match="threads"):
        row_lse_model(torch.zeros(2, 8), 32, vec=True)


@pytest.mark.parametrize("level,vec", [(2, True), (3, False)])
def test_model_matches_vntk_fused_logsoftmax_pallas(rng, level, vec):
    """The JAX reference's fused mask kernel (interpret mode) on a small
    trie's sparse level: the model's log-probs scattered by the port's plain
    Alg. 2 equal its masked row within 1e-5, next states exactly."""
    vocab, length = 64, 4
    ft = build_flat_trie(make_sids(rng, 600, vocab, length, clustered=True),
                         vocab, dense_d=2)
    jtm = JaxTransitionMatrix.from_flat_trie(ft)
    bmax = int(jtm.level_bmax[level])
    nodes = rng.integers(ft.level_offsets[level], ft.level_offsets[level + 1],
                         12).astype(np.int32)
    nodes[::4] = 0  # the sink
    x = _logits(rng, 12, vocab, neg_inf=0.2)
    want = vntk_fused_logsoftmax_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(nodes), jtm.row_pointers,
        jtm.edges, bmax, vocab, interpret=True)
    m, lse = row_lse_model(x, 128, vec)
    lp = (x - m[:, None]) - lse[:, None]
    got = vntk_reference_scatter(
        lp, torch.from_numpy(nodes), torch.from_numpy(np.array(
            jtm.row_pointers)), torch.from_numpy(np.array(jtm.edges)),
        bmax, vocab)
    assert not bool(torch.isnan(got[0]).any())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
