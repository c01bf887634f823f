"""The warp route's closed-form top-C selection, modelled on the CPU.

``kernels.vntk.topk_ranks_closed_form`` follows the warp kernel's arithmetic
(ballots as sums, shuffles as indexing).  It must put out what the plain
selection (``core.vntk._topk_from_candidates``, a stable descending sort of
the candidates) does: scores and tokens bit for bit, and the same candidate
at each rank.  The edge cases are the ones the kernel has to get right: tie
runs, valid log-probs at exactly ``NEG_INF``, ``-FLT_MAX`` and ``-inf``,
rows at the sink, rows with more children than ``bmax``, and a vocabulary so
small that ``-FLT_MAX`` candidates reach the output.  One case runs the JAX
reference's Pallas kernel in interpret mode on a small trie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core.trie import build_flat_trie
from repro.kernels.vntk import vntk_topk_pallas
from repro_torch.core.vntk import NEG_INF, _topk_from_candidates
from repro_torch.kernels.vntk import topk_ranks_closed_form

from conftest import make_sids

MINF = float(np.finfo(np.float32).min)
POOLS = {  # log-prob values a case draws from
    "ties": [-0.5, -1.0, -1.5, -2.0],
    "neg_inf": [-0.5, -2.0, NEG_INF],
    "minf": [-0.5, NEG_INF, MINF],
    "-inf": [-1.0, NEG_INF, MINF, -np.inf],
}


def _rows(rng, nb, bmax, vocab, n_child=None, pool=None):
    """``nb`` CSR rows of sorted distinct tokens below ``vocab`` and their
    log-prob rows: ``(lp (nb, V), cols (nb, bmax), n_child (nb,))``."""
    if n_child is None:
        n_child = rng.integers(0, bmax + 7, nb)
        n_child[::5] = 0  # rows at the sink
    n_child = np.minimum(n_child, vocab)
    cols = np.zeros((nb, bmax), np.int64)
    for r, n in enumerate(n_child):
        toks = np.sort(rng.choice(vocab, size=n, replace=False))[:bmax]
        cols[r, :len(toks)] = toks
    if pool is None:
        lp = rng.normal(size=(nb, vocab)).astype(np.float32) - 3.0
    else:
        lp = rng.choice(np.asarray(pool, np.float32), size=(nb, vocab))
    return (torch.from_numpy(lp), torch.from_numpy(cols),
            torch.from_numpy(np.asarray(n_child, np.int64)))


def _check(lp, cols, n_child, bmax, width, vocab):
    """The closed form against the stable sort of the same candidates."""
    slot = torch.arange(bmax)
    valid = slot[None, :] < n_child[:, None]
    nxt = torch.where(valid, 1000 + slot, 0).to(torch.int32)
    want = _topk_from_candidates(lp, cols, nxt, valid, width, vocab)
    n_real = n_child.clamp(0, bmax)
    keys = lp.gather(1, cols.clamp(0, vocab - 1))
    sc, tok, src = topk_ranks_closed_form(keys, cols, n_real, bmax, width,
                                          vocab)
    got_next = torch.where(src < n_real[:, None], 1000 + src, 0).int()
    assert torch.equal(sc, want[0])
    assert torch.equal(tok, want[1])
    assert torch.equal(got_next, want[2])
    return sc, src


@settings(max_examples=150, deadline=None)
@given(bmax=st.integers(1, 32), width=st.sampled_from([8, 72]),
       extra=st.integers(0, 90), seed=st.integers(0, 2 ** 32 - 1),
       pool=st.sampled_from([None, *POOLS]))
def test_closed_form_equals_stable_sort(bmax, width, extra, seed, pool):
    rng = np.random.default_rng(seed)
    vocab = width + extra  # extra = 0: every candidate slot is needed
    _check(*_rows(rng, 9, bmax, vocab, pool=None if pool is None
                  else POOLS[pool]), bmax, width, vocab)


@pytest.mark.parametrize("width", [8, 72])
@pytest.mark.parametrize("case", [
    "sink", "n_child>bmax", "ties", "neg_inf", "minf", "-inf", "bmax=32"])
def test_closed_form_edge_cases(width, case):
    rng = np.random.default_rng(width)
    bmax, vocab, nb = 12, 160, 7
    kw = {}
    if case == "sink":
        kw["n_child"] = np.zeros(nb, np.int64)
    elif case == "n_child>bmax":
        kw["n_child"] = np.full(nb, bmax + 9)
    elif case == "bmax=32":
        bmax = 32
        kw["n_child"] = np.array([32, 31, 0, 40, 1, 32, 17])
    else:
        kw["pool"] = POOLS[case]
    lp, cols, n_child = _rows(rng, nb, bmax, vocab, **kw)
    if case == "-inf":  # every valid slot at -inf
        lp[:] = -np.inf
    _check(lp, cols, n_child, bmax, width, vocab)


@pytest.mark.parametrize("width", [8, 72])
def test_minf_candidates_reach_the_output(width):
    """V = width: the in-range candidates are exactly ``width``, so valid
    slots at ``-inf`` leave room for padding slots and out-of-range missing
    tokens, all at ``-FLT_MAX``, in slot-then-missing order."""
    rng = np.random.default_rng(1)
    bmax = 4
    lp, cols, n_child = _rows(rng, 6, bmax, width,
                              n_child=np.array([5, 0, 4, 2, 9, 1]))
    lp[:] = -np.inf
    sc, src = _check(lp, cols, n_child, bmax, width, width)
    written = sc == MINF
    assert bool(written.any())
    padding = written & (src < bmax)  # padding slots come before missing
    assert bool(padding.any()) and bool((written & (src >= bmax)).any())


def test_closed_form_rejects_wide_rows():
    lp, cols, n_child = _rows(np.random.default_rng(2), 2, 33, 64)
    with pytest.raises(ValueError, match="bmax"):
        topk_ranks_closed_form(lp.gather(1, cols), cols, n_child, 33, 8, 64)


@pytest.mark.parametrize("level,width", [(2, 64), (3, 8)])
def test_closed_form_matches_vntk_topk_pallas(rng, level, width):
    """The JAX reference's kernel (interpret mode) on a small trie's sparse
    level, with log-probs at NEG_INF and -FLT_MAX among them."""
    vocab, length = 64, 4
    ft = build_flat_trie(make_sids(rng, 600, vocab, length, clustered=True),
                         vocab, dense_d=2)
    jtm = JaxTransitionMatrix.from_flat_trie(ft)
    rp, edges = np.asarray(jtm.row_pointers), np.asarray(jtm.edges)
    bmax = int(jtm.level_bmax[level])
    assert 1 <= bmax <= 32
    nodes = rng.integers(ft.level_offsets[level], ft.level_offsets[level + 1],
                         12).astype(np.int32)
    nodes[::4] = 0  # the sink
    x = rng.normal(size=(12, vocab)).astype(np.float32)
    lp = np.asarray(torch.log_softmax(torch.from_numpy(x), -1))
    lp[:, 5::7], lp[:, 3::11] = NEG_INF, MINF
    want = vntk_topk_pallas(jnp.asarray(lp), jnp.asarray(nodes),
                            jtm.row_pointers, jtm.edges, bmax, vocab, width,
                            interpret=True)
    start = rp[nodes].astype(np.int64)
    n_real = np.clip(rp[nodes + 1] - start, 0, bmax)
    idx = np.minimum(start[:, None] + np.arange(bmax), edges.shape[0] - 1)
    cols = torch.from_numpy(edges[idx, 0].astype(np.int64))
    keys = torch.from_numpy(lp).gather(1, cols.clamp(0, vocab - 1))
    sc, tok, src = topk_ranks_closed_form(
        keys, cols, torch.from_numpy(n_real.astype(np.int64)), bmax, width,
        vocab)
    src = src.numpy()
    nxt = np.where(src < n_real[:, None], np.take_along_axis(
        edges[idx, 1], np.minimum(src, bmax - 1), 1), 0)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(nxt, np.asarray(want[2]))
