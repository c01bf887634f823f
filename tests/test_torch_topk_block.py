"""The block route's radix-select top-C, modelled on the CPU.

``kernels.vntk.topk_radix_select_model`` follows ``vntk_topk_kernel``
(the topk kernel's route for rows of more than 32 slots) step for step:
order keys, the padding and missing candidates in closed form, the radix
select over (order key, inverted slot) with its early stop, rounds of 256
winners ranked by counting.  It must put out what the plain selection
(``core.vntk._topk_from_candidates``, a stable descending sort) does, and
what the JAX reference's (``jax.lax.top_k``) does: scores and tokens bit
for bit and the same candidate at each rank, over bmax 33 to 4,096 and
widths 8, 72 and V.  The edge cases: tie runs, valid log-probs at
``NEG_INF``, ``-FLT_MAX``, ``-inf``, signed zeros and NaN, rows at the sink,
rows with more children than ``bmax``, and V = width, where ``-FLT_MAX``
candidates reach the output.  NaN ranks first everywhere but in the
reference's Pallas kernel.  -0 ties with +0 in the port and in the
reference's Pallas kernel, where ``jax.lax.top_k`` puts +0 first: the JAX
plain selection is given the keys with -0 read as +0.  Cases run the
reference's Pallas kernel in interpret mode on block-route rows, signed
zeros and ``-inf`` among them.  Mutants of the model (its order key, its
select, its missing tokens) must fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core.trie import build_flat_trie
from repro.core.vntk import _topk_from_candidates as jax_topk_plain
from repro.kernels.vntk import vntk_topk_pallas
from repro_torch.core.vntk import NEG_INF, _topk_from_candidates
from repro_torch.kernels import vntk as kv

from conftest import make_sids

MINF = float(np.finfo(np.float32).min)
jax_topk_from_candidates = jax.jit(jax_topk_plain, static_argnums=(4, 5))
POOLS = {  # log-prob values a case draws from
    "ties": [-0.5, -1.0, -1.5, -2.0],
    "neg_inf": [-0.5, -2.0, NEG_INF],
    "minf": [-0.5, NEG_INF, MINF],
    "-inf": [-1.0, NEG_INF, MINF, -np.inf],
    "zeros": [0.0, -0.0, -1.0],
    "nan": [np.nan, -1.0, -2.0, NEG_INF],
}


def _rows(rng, nb, bmax, vocab, n_child=None, pool=None):
    """``nb`` CSR rows of sorted distinct tokens below ``vocab`` and their
    log-prob rows: ``(lp (nb, V), cols (nb, bmax), n_child (nb,))``."""
    if n_child is None:
        n_child = rng.integers(0, bmax + 7, nb)
        n_child[::4] = 0  # rows at the sink
    n_child = np.minimum(n_child, vocab)
    cols = np.zeros((nb, bmax), np.int64)
    for r, n in enumerate(n_child):
        toks = np.sort(rng.choice(vocab, size=n, replace=False))[:bmax]
        cols[r, :len(toks)] = toks
    if pool is None:  # bf16-rounded logits tie, as the model's do
        lp = torch.from_numpy(rng.normal(size=(nb, vocab)).astype(np.float32)
                              * 4).bfloat16().float().log_softmax(-1)
    else:
        lp = torch.from_numpy(rng.choice(np.asarray(pool, np.float32),
                                         size=(nb, vocab)))
    return (lp, torch.from_numpy(cols),
            torch.from_numpy(np.asarray(n_child, np.int64)))


def _check(lp, cols, n_child, bmax, width, vocab, passes=None):
    """The model against the stable sort of the same candidates, the
    port's and the JAX reference's (-0 read as +0 there)."""
    slot = torch.arange(bmax)
    valid = slot[None, :] < n_child[:, None]
    nxt = torch.where(valid, 1000 + slot, 0).to(torch.int32)
    want = _topk_from_candidates(lp, cols, nxt, valid, width, vocab)
    jwant = jax_topk_from_candidates(
        jnp.asarray((lp + 0.0).numpy()), jnp.asarray(cols.int().numpy()),
        jnp.asarray(nxt.numpy()), jnp.asarray(valid.numpy()), width, vocab)
    n_real = n_child.clamp(0, bmax)
    keys = lp.gather(1, cols.clamp(0, vocab - 1))
    sc, tok, src = kv.topk_radix_select_model(keys, cols, n_real, bmax,
                                              width, vocab, passes)
    got_next = torch.where(src < n_real[:, None], 1000 + src, 0).int()
    for w in (want, [torch.from_numpy(np.asarray(a)) for a in jwant]):
        assert torch.equal(sc.isnan(), w[0].isnan())
        assert torch.equal(sc.nan_to_num(), w[0].nan_to_num())
        assert torch.equal(tok, w[1])
        assert torch.equal(got_next, w[2])
    return sc, src


@settings(max_examples=60, deadline=None)
@given(bmax=st.integers(33, 4096), width=st.sampled_from([8, 72, "V"]),
       extra=st.integers(0, 400), seed=st.integers(0, 2 ** 32 - 1),
       pool=st.sampled_from([None, *POOLS]))
def test_radix_select_equals_stable_sort(bmax, width, extra, seed, pool):
    rng = np.random.default_rng(seed)
    if width == "V":  # every candidate slot is needed; rounds past 256
        width = vocab = 33 + extra
    else:
        vocab = width + extra
    _check(*_rows(rng, 5, bmax, vocab, pool=None if pool is None
                  else POOLS[pool]), bmax, width, vocab)


@pytest.mark.parametrize("width", [8, 72, 300])
@pytest.mark.parametrize("case", [
    "sink", "n_child>bmax", "full root row", *POOLS])
def test_radix_select_edge_cases(width, case):
    rng = np.random.default_rng(width)
    bmax, vocab, nb = 300, 2048, 6
    kw = {}
    if case == "sink":
        kw["n_child"] = np.zeros(nb, np.int64)
    elif case == "n_child>bmax":
        kw["n_child"] = np.full(nb, bmax + 9)
    elif case == "full root row":  # every token, bmax past V (a store's)
        bmax, vocab = 3072, 2048
        kw["n_child"] = np.full(nb, vocab)
    else:
        kw["pool"] = POOLS[case]
    lp, cols, n_child = _rows(rng, nb, bmax, vocab, **kw)
    _check(lp, cols, n_child, bmax, width, vocab)


@pytest.mark.parametrize("width", [72, 300])
def test_minf_candidates_reach_the_output(width):
    """V = width: valid slots at ``-inf`` leave room for the padding slots
    and the out-of-range missing tokens, all at ``-FLT_MAX``, in
    slot-then-missing order."""
    rng = np.random.default_rng(1)
    bmax = 40
    lp, cols, n_child = _rows(rng, 6, bmax, width,
                              n_child=np.array([45, 0, 40, 2, 39, 1]))
    lp[:] = -np.inf
    sc, src = _check(lp, cols, n_child, bmax, width, width)
    written = sc == MINF
    assert bool((written & (src < bmax)).any())  # padding first
    assert bool((written & (src >= bmax)).any())


def test_early_stop_takes_few_passes():
    """A root row of 2,048 bf16-tied log-probs at C = 72 (the continuous
    engine's levels 0-1): the select stops before its last digit on most
    rows, and never passes the composite's 6 digits."""
    rng = np.random.default_rng(3)
    passes = []
    lp, cols, n_child = _rows(rng, 8, 3072, 2048, n_child=np.full(8, 2048))
    _check(lp, cols, n_child, 3072, 72, 2048, passes)
    assert max(passes) <= 6 and np.median(passes) < 6


def test_model_rejects_warp_rows():
    lp, cols, n_child = _rows(np.random.default_rng(2), 2, 32, 64)
    with pytest.raises(ValueError, match="bmax"):
        kv.topk_radix_select_model(lp.gather(1, cols), cols, n_child, 32, 8,
                                   64)


def _raw_order_key(keys):
    """A mutant: the float's bits as they are (negative keys reversed)."""
    return keys.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF


def _signed_zero_order_key(keys):
    """A mutant: -0 and +0 apart (the plain sort ties them)."""
    bits = keys.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(keys), 0xFFFFFFFF, u)


_SELECT = kv._radix_threshold
_MISSING = kv._missing_tokens
MUTANTS = {
    "_order_key": [_raw_order_key, _signed_zero_order_key],
    # one slot short of the round: the gathered count check or ranks fail
    "_radix_threshold": [lambda c, k, d, p: _SELECT(c, max(k - 1, 1), d, p)],
    # each owner's range starting at its own g_j
    "_missing_tokens": [lambda t, need: (lambda i, tok: (i, tok + 1))(
        *_MISSING(t, need))],
}


@pytest.mark.parametrize("name,k", [(n, k) for n, fns in MUTANTS.items()
                                    for k in range(len(fns))])
def test_mutants_of_the_model_fail(monkeypatch, name, k):
    monkeypatch.setattr(kv, name, MUTANTS[name][k])
    failed = 0
    for pool, width in (("zeros", 72), (None, 72), ("minf", 300),
                        ("neg_inf", 8)):
        rng = np.random.default_rng(7)
        lp, cols, n_child = _rows(rng, 6, 200, 300,
                                  pool=None if pool is None else POOLS[pool])
        try:
            _check(lp, cols, n_child, 200, width, 300)
        except AssertionError:
            failed += 1
    assert failed, f"the {name} mutant passed every case"


@pytest.mark.parametrize("level,bmax,width,pool", [
    (0, 64, 64, None), (1, 48, 8, None), (0, 64, 64, "zeros"),
    (0, 64, 64, "-inf"), (1, 48, 8, "zeros")])
def test_model_matches_vntk_topk_pallas(rng, level, bmax, width, pool):
    """The JAX reference's kernel (interpret mode) on a dense_d=0 trie: its
    root row (every token) and level-1 rows cut at 48 slots, with
    log-probs at NEG_INF and -FLT_MAX among them, or drawn from the signed
    zeros' pool or the ``-inf`` one (where the root row's out-of-range
    missing tokens, at -FLT_MAX, rank above its valid slots at -inf)."""
    vocab, length = 64, 3
    ft = build_flat_trie(make_sids(rng, 900, vocab, length), vocab,
                         dense_d=0)
    jtm = JaxTransitionMatrix.from_flat_trie(ft)
    rp, edges = np.asarray(jtm.row_pointers), np.asarray(jtm.edges)
    assert int(jtm.level_bmax[level]) <= bmax <= edges.shape[0]
    nodes = rng.integers(ft.level_offsets[level], ft.level_offsets[level + 1],
                         12).astype(np.int32)
    nodes[::4] = 0  # the sink
    if pool is None:
        x = rng.normal(size=(12, vocab)).astype(np.float32)
        lp = np.asarray(torch.log_softmax(torch.from_numpy(x), -1))
        lp[:, 5::7], lp[:, 3::11] = NEG_INF, MINF
    else:
        lp = rng.choice(np.asarray(POOLS[pool], np.float32), (12, vocab))
    want = vntk_topk_pallas(jnp.asarray(lp), jnp.asarray(nodes),
                            jtm.row_pointers, jtm.edges, bmax, vocab, width,
                            interpret=True)
    start = rp[nodes].astype(np.int64)
    n_real = np.clip(rp[nodes + 1] - start, 0, bmax)
    idx = np.minimum(start[:, None] + np.arange(bmax), edges.shape[0] - 1)
    cols = torch.from_numpy(edges[idx, 0].astype(np.int64))
    keys = torch.from_numpy(lp).gather(1, cols.clamp(0, vocab - 1))
    sc, tok, src = kv.topk_radix_select_model(
        keys, cols, torch.from_numpy(n_real.astype(np.int64)), bmax, width,
        vocab)
    src = src.numpy()
    nxt = np.where(src < n_real[:, None], np.take_along_axis(
        edges[idx, 1], np.minimum(src, bmax - 1), 1), 0)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(nxt, np.asarray(want[2]))
