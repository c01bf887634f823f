"""Port §5.2 baselines, the unconstrained step and ``core/constrained.py``
against the JAX reference on the same seeded numpy inputs.

The key packing, ``_lex_less``, ``_mix32`` and the hash are compared at edge
values (tokens up to 65535, lanes and hashes near 2^31 and 2^32); the PPV
tables and the bitmap byte for byte; every baseline's ``mask`` and
``mask_step`` at every step, PPV approximate on tie-heavy rows too; the
backends' errors, the policy factories and ``as_policy``; beam search under
each baseline (traces: tokens equal, scores within rtol 1e-6); and a
two-layer ``GenerativeRetriever`` with ``policy=None`` and with PPV exact
(SIDs equal, scores within 1e-4, as in ``tests/test_torch_retrieval.py``).
The baselines only gather and select, so their masked log-probs are equal;
the constrained step normalizes in each framework, so its scores agree
within rtol/atol 1e-6 (log-probs near 0 differ by an ulp of the
log-sum-exp, ~1e-7) or 1e-5 fused, where the kernel's plain version
computes its own log-sum-exp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.constraints import ConstraintStore as JaxConstraintStore
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core import baselines as jb
from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.constrained import (
    constrain_log_probs as jax_constrain_log_probs,
    constrained_decoding_step as jax_constrained_decoding_step,
)
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.models import transformer as jax_transformer
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.convert import (
    hash_bitmap_backend_from_numpy,
    params_from_jax,
    ppv_backend_from_numpy,
    store_from_numpy,
    transition_matrix_from_numpy,
)
from repro_torch.core import baselines as tb
from repro_torch.core.beam_search import beam_search
from repro_torch.core.constrained import (
    constrain_log_probs,
    constrained_decoding_step,
)
from repro_torch.decoding import (
    CpuTrieBackend,
    DecodePolicy,
    HashBitmapBackend,
    PPVBackend,
    StaticBackend,
    UnconstrainedBackend,
    as_policy,
)
from repro_torch.serving import GenerativeRetriever
from conftest import make_sids

EDGE32 = np.array([0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**31 + 1,
                   0x9E3779B9, 0x846CA68B, 2**32 - 2, 2**32 - 1],
                  dtype=np.uint32)
SHAPES = [(16, 4, 200), (32, 5, 500), (16, 8, 300)]  # (V, L, n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _i64(a):
    return _t(np.asarray(a).astype(np.int64))


def _prefixes(rng, sids, vocab, length, nb=12):
    """Half walked from the set, half random (mostly invalid)."""
    return np.concatenate([sids[rng.integers(0, sids.shape[0], nb // 2)],
                           make_sids(rng, nb - nb // 2, vocab, length)]
                          ).astype(np.int32)


def _edge_keys(rng, n=300):
    """(n, 4) uint32 keys whose lanes mix edge values and random ones."""
    keys = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    pick = rng.integers(0, len(EDGE32), size=(n, 4))
    use = rng.random((n, 4)) < 0.5
    return np.where(use, EDGE32[pick], keys).astype(np.uint32)


# ---------------------------------------------------------------------------
# packing, comparison and hashing at edge values
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length", range(1, 9))
@pytest.mark.parametrize("width", [3, 8])
def test_pack_keys_match_reference(rng, length, width):
    tokens = rng.integers(0, 65536, size=(40, width))
    tokens[:4] = 65535
    tokens[4:8] = 0
    tokens[8, :] = [65535, 0, 65535][: width] + [1] * (width - 3)
    want = jb._pack_keys_np(tokens, length)
    np.testing.assert_array_equal(
        np.asarray(jb._pack_keys_jnp(jnp.asarray(tokens, jnp.int32), length)),
        want)
    got = tb._pack_keys_torch(_i64(tokens), length)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tb._pack_keys_np(tokens, length), want)


def test_pack_keys_reject_long_sids():
    for fn, arr in ((tb._pack_keys_np, np.zeros((1, 9), np.int64)),
                    (tb._pack_keys_torch, torch.zeros(1, 9, dtype=torch.int64))):
        with pytest.raises(ValueError, match="L<=8"):
            fn(arr, 9)


def test_lex_less_matches_reference(rng):
    a = _edge_keys(rng)
    b = a.copy()
    lanes = rng.integers(0, 4, size=a.shape[0])  # differ from one lane on
    for i, lane in enumerate(lanes):
        b[i, lane:] = _edge_keys(rng, 1)[0, lane:]
    b[::7] = a[::7]  # equal keys: not less
    for x, y in ((a, b), (b, a)):
        want = np.asarray(jb._lex_less(jnp.asarray(x), jnp.asarray(y)))
        got = tb._lex_less(_i64(x), _i64(y)).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_mix32_and_mul32_at_edge_values(rng):
    x = np.concatenate([EDGE32, _edge_keys(rng).reshape(-1)])
    want = np.asarray(jb._mix32_jnp(jnp.asarray(x)))
    np.testing.assert_array_equal(jb._mix32_np(x), want)
    np.testing.assert_array_equal(tb._mix32_np(x), want)
    np.testing.assert_array_equal(tb._mix32_torch(_i64(x)).numpy(),
                                  want.astype(np.int64))
    for c in (0x7FEB352D, 0x846CA68B):
        with np.errstate(over="ignore"):
            prod = (x * np.uint32(c)).astype(np.int64)
        np.testing.assert_array_equal(tb._mul32(_i64(x), c).numpy(), prod)
    assert int(tb._mul32(torch.tensor([0xFFFFFFFF]), 0x846CA68B)) == 2073254261


@pytest.mark.parametrize("log2_bits", [12, 22, 27])
def test_hash_matches_reference(rng, log2_bits):
    sids = make_sids(rng, 50, 16, 4)
    ref = jb.HashBitmapBaseline(sids, 16, log2_bits=log2_bits)
    port = tb.HashBitmapBaseline(sids, 16, log2_bits=log2_bits, device="cpu")
    keys = _edge_keys(rng)
    for step in range(8):
        want = np.asarray(ref._hash_jnp(jnp.asarray(keys), step))
        np.testing.assert_array_equal(ref._hash_np(keys, step), want)
        np.testing.assert_array_equal(port._hash_np(keys, step), want)
        got = port._hash_torch(_i64(keys), step)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,length,n", SHAPES)
def test_ppv_tables_and_bitmap_equal_reference(rng, vocab, length, n):
    sids = make_sids(rng, n, vocab, length, clustered=True)
    sids = np.concatenate([sids, sids[:20]])  # duplicates, unsorted
    ref = jb.PPVBaseline(sids, vocab)
    port = tb.PPVBaseline(sids, vocab, device="cpu")
    assert (port.n, port.n_search_steps) == (ref.n, ref.n_search_steps)
    assert port.sids_sorted.dtype == torch.int32
    np.testing.assert_array_equal(port.sids_sorted.numpy(),
                                  np.asarray(ref.sids_sorted))
    np.testing.assert_array_equal(port.keys.numpy(),
                                  np.asarray(ref.keys).astype(np.int64))
    for bits in (12, 16):
        want = np.asarray(jb.HashBitmapBaseline(sids, vocab, log2_bits=bits)
                          .bitmap)
        got = tb.HashBitmapBaseline(sids, vocab, log2_bits=bits,
                                    device="cpu").bitmap
        assert got.dtype == torch.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_false_positive_rate_equals_reference(rng):
    sids = make_sids(rng, 500, 16, 4)
    want = jb.HashBitmapBaseline(sids, 16, log2_bits=12).false_positive_rate(
        sids, n_probe=4000)
    got = tb.HashBitmapBaseline(sids, 16, log2_bits=12, device="cpu"
                                ).false_positive_rate(sids, n_probe=4000)
    assert got == want and 0.0 < got < 0.9


# ---------------------------------------------------------------------------
# masks at every step
# ---------------------------------------------------------------------------
def _pairs(sids, vocab):
    """(name, reference baseline, port baseline)."""
    return [
        ("ppv_exact", jb.PPVBaseline(sids, vocab),
         tb.PPVBaseline(sids, vocab, device="cpu")),
        ("ppv_approx", jb.PPVBaseline(sids, vocab, exact=False, top_k=8),
         tb.PPVBaseline(sids, vocab, exact=False, top_k=8, device="cpu")),
        ("cpu_trie", jb.CpuTrieBaseline(sids, vocab),
         tb.CpuTrieBaseline(sids, vocab)),
        ("hash_bitmap", jb.HashBitmapBaseline(sids, vocab, log2_bits=10),
         tb.HashBitmapBaseline(sids, vocab, log2_bits=10, device="cpu")),
    ]


@pytest.mark.parametrize("vocab,length,n", SHAPES)
def test_masks_equal_reference_at_every_step(rng, vocab, length, n):
    sids = make_sids(rng, n, vocab, length, clustered=True)
    prefixes = _prefixes(rng, sids, vocab, length)
    for name, ref, port in _pairs(sids, vocab):
        for step in range(length):
            lp = rng.normal(size=(3, 4, vocab)).astype(np.float32)
            # tie-heavy rows (few distinct values): PPV approximate's top-k
            # then decides by index
            lp[1:] = rng.integers(-3, 2, size=(2, 4, vocab))
            pf = prefixes.reshape(3, 4, length)[..., :max(step, 1)]
            want_m, want_n = ref.mask_step(jnp.asarray(lp), jnp.asarray(pf),
                                           step)
            got_m, got_n = port.mask_step(_t(lp), _t(pf), step)
            label = f"{name} step {step}"
            np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m),
                                          err_msg=label)
            assert got_n.dtype == torch.int32, label
            np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n),
                                          err_msg=label)
            np.testing.assert_array_equal(
                port.mask(_t(lp), _t(pf), step).numpy(), got_m.numpy())


def test_unconstrained_mask_is_the_identity(rng):
    lp = _t(rng.normal(size=(4, 16)).astype(np.float32))
    assert tb.unconstrained_mask(lp, None, 0) is lp
    masked, nxt = UnconstrainedBackend().mask_step(lp, None, 3)
    assert masked is lp
    assert nxt.dtype == torch.int32 and bool((nxt == 1).all())


# ---------------------------------------------------------------------------
# backends, policy and errors
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(7)
    sids = make_sids(rng, 120, 16, 4, clustered=True)
    return dict(sids=sids, V=16, L=4, tm=JaxTransitionMatrix.from_sids(
        sids, 16, dense_d=2))


def _port_backends(sids, V):
    return [CpuTrieBackend(tb.CpuTrieBaseline(sids, V)),
            PPVBackend.from_sids(sids, V, device="cpu"),
            PPVBackend.from_sids(sids, V, exact=False, top_k=4, device="cpu"),
            HashBitmapBackend.from_sids(sids, V, log2_bits=12, device="cpu")]


def test_backend_flags_and_errors(small):
    V, L = small["V"], small["L"]
    lp = torch.zeros(2, V)
    pf = torch.zeros(2, L, dtype=torch.int32)
    for b in _port_backends(small["sids"], V):
        name = type(b).__name__
        assert (b.needs_prefix, b.supports_fused, b.supports_stacked,
                b.supports_topk, b.sid_length) == (True, False, False, False, L)
        with pytest.raises(ValueError, match="emitted-token history"):
            b.mask_step(lp, None, 0)
        with pytest.raises(ValueError, match=f"got {name}"):
            b.mask_step(lp, None, 0, prefix_tokens=pf,
                        constraint_ids=torch.zeros(2, dtype=torch.int32))
        for step in (-1, L):
            with pytest.raises(ValueError, match="outside"):
                b.mask_step(lp, None, step, prefix_tokens=pf)
    u = UnconstrainedBackend()
    assert (u.needs_prefix, u.sid_length, u.device) == (False, None, None)
    with pytest.raises(ValueError, match="UnconstrainedBackend"):
        u.mask_step(lp, None, 0, constraint_ids=torch.zeros(2))
    tm = transition_matrix_from_numpy(small["tm"], device="cpu")
    assert not StaticBackend(tm).needs_prefix


@pytest.mark.parametrize("cls", [tb.CpuTrieBaseline, tb.PPVBaseline,
                                 tb.HashBitmapBaseline])
def test_sids_longer_than_eight_are_refused(cls):
    kw = {} if cls is tb.CpuTrieBaseline else dict(device="cpu")
    with pytest.raises(ValueError, match="key-packing limit"):
        cls(np.zeros((3, 9), np.int64), 4, **kw)


def test_policy_factories_describe_and_as_policy(small):
    sids, V, L = small["sids"], small["V"], small["L"]
    ref = {
        "cpu_trie": JaxDecodePolicy.cpu_trie(sids, V),
        "ppv": JaxDecodePolicy.ppv(sids, V),
        "hash_bitmap": JaxDecodePolicy.hash_bitmap(sids, V, log2_bits=12),
        "unconstrained": JaxDecodePolicy.unconstrained(),
        "static": JaxDecodePolicy.static(small["tm"]),
    }
    tm = transition_matrix_from_numpy(small["tm"], device="cpu")
    port = {
        "cpu_trie": DecodePolicy.cpu_trie(sids, V),
        "ppv": DecodePolicy.ppv(sids, V, device="cpu"),
        "hash_bitmap": DecodePolicy.hash_bitmap(sids, V, log2_bits=12,
                                                device="cpu"),
        "unconstrained": DecodePolicy.unconstrained(),
        "static": DecodePolicy.static(tm),
    }
    for name, p in port.items():
        r = ref[name]
        assert (p.plan, p.sid_length, p.is_constrained, p.needs_prefix,
                p.requires_constraint_ids) == (
            r.plan, r.sid_length, r.is_constrained, r.needs_prefix,
            r.requires_constraint_ids), name
        want = r.describe().replace("[xla+", "[auto+")
        assert p.describe() == want, name
        assert (p.constraints is None) == (name != "static"), name
        assert not any(p.supports_topk_at(s) for s in range(L)) or \
            name == "static"
    assert port["static"].constraints is tm
    assert port["ppv"].device == torch.device("cpu")
    assert port["cpu_trie"].device is None
    assert port["unconstrained"].device is None

    none = as_policy(None)
    assert none.describe() == "L0:unconstrained" and not none.is_constrained
    cpu = tb.CpuTrieBaseline(sids, V)
    ppv = tb.PPVBaseline(sids, V, device="cpu")
    bmp = tb.HashBitmapBaseline(sids, V, log2_bits=12, device="cpu")
    for obj, label in ((cpu, "cputrie"), (ppv, "ppv"), (bmp, "hashbitmap")):
        p = as_policy(obj)
        assert p.describe() == f"L0-{L - 1}:{label}" and p.needs_prefix
    assert as_policy(cpu).backends[0].baseline is cpu
    assert as_policy(ppv).backends[0].keys is ppv.keys
    assert as_policy(bmp).backends[0].bitmap is bmp.bitmap
    backend = PPVBackend.from_baseline(ppv)
    assert as_policy(backend).backends == (backend,)
    assert as_policy(UnconstrainedBackend()).plan == (0,)
    mixed = DecodePolicy.per_level(
        [StaticBackend(tm, levels="dense"), backend], [0, 0, 1, 1])
    assert mixed.describe() == "L0-1:dense-bitpack L2-3:ppv"
    assert mixed.needs_prefix and mixed.constraints is tm
    with pytest.raises(TypeError, match="cannot build"):
        as_policy(object())
    for name in ("cpu_trie", "ppv", "hash_bitmap", "unconstrained"):
        with pytest.raises(TypeError, match="no swappable backend"):
            port[name].with_constraints(tm)


def test_policy_step_needs_prefix_tokens(small):
    p = DecodePolicy.ppv(small["sids"], small["V"], device="cpu")
    with pytest.raises(ValueError, match="PPVBackend needs prefix_tokens at "
                       "step 2"):
        p.step(torch.zeros(2, small["V"]), None, 2)
    with pytest.raises(ValueError, match="stacked ConstraintStore"):
        p.step(torch.zeros(2, small["V"]), None, 0,
               prefix_tokens=torch.zeros(2, 4, dtype=torch.int32),
               constraint_ids=torch.zeros(2, dtype=torch.int32))
    lp, nxt = DecodePolicy.unconstrained().step(torch.zeros(2, 16), None, 11)
    assert bool((nxt == 1).all())


def test_beam_search_needs_a_device_without_tables():
    table = torch.zeros(4, 16, 16)
    with pytest.raises(ValueError, match="no device tables"):
        beam_search(lambda c, last, s: (table[s][last.long()], c), None, 2, 3,
                    4, DecodePolicy.unconstrained())


# ---------------------------------------------------------------------------
# core/constrained.py
# ---------------------------------------------------------------------------
def test_constrained_step_matches_reference(rng):
    V, L = 16, 4
    sids = make_sids(rng, 150, V, L, clustered=True)
    decoy = make_sids(rng, 60, V, L)
    jtm = JaxTransitionMatrix.from_sids(sids, V, dense_d=2)
    jstore = JaxConstraintStore.from_matrices(
        [JaxTransitionMatrix.from_sids(decoy, V, dense_d=2), jtm])
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    store = store_from_numpy(jstore, device="cpu")
    nb = 10
    prefixes = _prefixes(rng, sids, V, L, nb)
    cids = (np.arange(nb) % 2).astype(np.int32)
    nodes = np.ones(nb, np.int32)
    snodes = np.ones(nb, np.int32)
    for step in range(L):
        logits = rng.normal(size=(nb, V)).astype(np.float32) * 3
        want = jax_constrained_decoding_step(jnp.asarray(logits),
                                             jnp.asarray(nodes), None, step)
        got = constrained_decoding_step(_t(logits), _t(nodes), None, step)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for fused in (False, True):
            tol = dict(rtol=1e-5, atol=1e-5) if fused else dict(rtol=1e-6,
                                                                 atol=1e-6)
            for tables, jtables, nd, ids in ((tm, jtm, nodes, None),
                                             (store, jstore, snodes, cids)):
                want = jax_constrained_decoding_step(
                    jnp.asarray(logits), jnp.asarray(nd), jtables, step,
                    fused=fused,
                    constraint_ids=None if ids is None else jnp.asarray(ids))
                got = constrained_decoding_step(
                    _t(logits), _t(nd), tables, step, fused=fused,
                    constraint_ids=None if ids is None else _t(ids))
                np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                           **tol)
                np.testing.assert_array_equal(got[1].numpy(),
                                              np.asarray(want[1]))
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
        want = jax_constrain_log_probs(jnp.asarray(lp), jnp.asarray(nodes),
                                       jtm, step)
        got = constrain_log_probs(_t(lp), _t(nodes), tm, step)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _, nxt = constrain_log_probs(_t(lp), _t(nodes), tm, step)
        _, snxt = constrain_log_probs(_t(lp), _t(snodes), store, step,
                                      constraint_ids=_t(cids))
        nodes = nxt[torch.arange(nb), prefixes[:, step]].numpy()
        snodes = snxt[torch.arange(nb), prefixes[:, step]].numpy()
    with pytest.raises(ValueError, match="constraint_ids"):
        constrain_log_probs(_t(lp), _t(nodes), store, 0)
    with pytest.raises(ValueError, match="constraint_ids"):
        constrained_decoding_step(_t(lp), _t(nodes), store, 0)


# ---------------------------------------------------------------------------
# beam search and retrieval under the baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ppv_exact", "ppv_approx", "cpu_trie",
                                  "hash_bitmap", "unconstrained"])
def test_beam_search_trace_matches_reference(rng, name):
    V, L, B, M = 16, 4, 2, 5
    sids = make_sids(rng, 200, V, L, clustered=True)
    table = rng.normal(size=(L, V, V)).astype(np.float32)
    ref = {"ppv_exact": lambda: JaxDecodePolicy.ppv(sids, V),
           "ppv_approx": lambda: JaxDecodePolicy.ppv(sids, V, exact=False,
                                                     top_k=6),
           "cpu_trie": lambda: JaxDecodePolicy.cpu_trie(sids, V),
           "hash_bitmap": lambda: JaxDecodePolicy.hash_bitmap(sids, V,
                                                              log2_bits=9),
           "unconstrained": JaxDecodePolicy.unconstrained}[name]()
    port = {"ppv_exact": lambda: DecodePolicy.ppv(sids, V, device="cpu"),
            "ppv_approx": lambda: DecodePolicy.ppv(
                sids, V, exact=False, top_k=6, device="cpu"),
            "cpu_trie": lambda: DecodePolicy.cpu_trie(sids, V),
            "hash_bitmap": lambda: DecodePolicy.hash_bitmap(
                sids, V, log2_bits=9, device="cpu"),
            "unconstrained": DecodePolicy.unconstrained}[name]()
    _, _, want = jax_beam_search(
        lambda c, last, s: (jnp.asarray(table)[s][last], c), None, B, M, L,
        ref, return_trace=True)
    tbl = _t(table)
    _, _, got = beam_search(lambda c, last, s: (tbl[s][last.long()], c), None,
                            B, M, L, port, return_trace=True, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))


def test_convert_baseline_tables(rng):
    V, L = 32, 5
    sids = make_sids(rng, 300, V, L, clustered=True)
    ref_ppv = jb.PPVBaseline(sids, V, exact=False, top_k=7)
    ref_bmp = jb.HashBitmapBaseline(sids, V, log2_bits=11)
    ppv = ppv_backend_from_numpy(ref_ppv, device="cpu")
    bmp = hash_bitmap_backend_from_numpy(ref_bmp, device="cpu")
    built = PPVBackend.from_sids(sids, V, exact=False, top_k=7, device="cpu")
    for f in ("n", "vocab_size", "sid_length", "exact", "top_k",
              "n_search_steps"):
        assert getattr(ppv, f) == getattr(built, f), f
    assert torch.equal(ppv.sids_sorted, built.sids_sorted)
    assert torch.equal(ppv.keys, built.keys)
    assert torch.equal(bmp.bitmap, HashBitmapBackend.from_sids(
        sids, V, log2_bits=11, device="cpu").bitmap)
    pf = _prefixes(rng, sids, V, L, 8)
    lp = rng.normal(size=(8, V)).astype(np.float32)
    for step in range(L):
        for port, ref in ((ppv, ref_ppv), (bmp, ref_bmp)):
            got, _ = port.mask_step(_t(lp), None, step, prefix_tokens=_t(pf))
            want = ref.mask(jnp.asarray(lp), jnp.asarray(pf), step)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def retrieval():
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(2)  # top-M score gaps >= 1e-3 (asserted)
    sids = rng.integers(0, 32, (400, 4))
    jparams = jax_transformer.init_params(jcfg, jax.random.key(2))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, sids=sids, jparams=jparams, params=params,
                hist=rng.integers(0, jcfg.vocab_size, (2, 10)))


@pytest.mark.parametrize("name", ["none", "ppv_exact"])
def test_retriever_matches_reference(retrieval, name):
    s = retrieval
    L, V, M = 4, 32, 6
    jpolicy = None if name == "none" else JaxDecodePolicy.ppv(s["sids"], V)
    policy = None if name == "none" else DecodePolicy.ppv(s["sids"], V,
                                                          device="cpu")
    want_sids, want_scores = JaxGenerativeRetriever(
        s["jparams"], s["jcfg"], jpolicy, L, V, beam_size=M).retrieve(
        s["hist"])
    assert (-np.diff(want_scores, axis=1)).min() >= 1e-3
    r = GenerativeRetriever(s["params"], s["cfg"], policy, L, V, beam_size=M)
    assert r.constraints is None
    assert r.policy.is_constrained == (name != "none")
    sids, scores = r.retrieve(s["hist"])
    np.testing.assert_array_equal(sids, want_sids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="required"):
        GenerativeRetriever(s["params"], s["cfg"], policy)
