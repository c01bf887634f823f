"""Port training losses against the JAX reference: ``lm_loss`` (chunked
CE), ``lm_loss_trie_aware`` and ``recsys_loss`` for the four recsys models,
values and every parameter's gradient against ``jax.grad`` on weights
carried over from the reference, and a gradient check through
``chunked_causal_attention``.

Tolerances: float32 values and gradients within rtol 1e-5 and atol 1e-6
(gradients near zero); the two frameworks sum matrix products and
reductions in different orders, so results agree to a few ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jax_attention
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro_torch.configs import RecsysConfig, TransformerConfig
from repro_torch.convert import params_from_jax, recsys_params_from_jax
from repro_torch.models import recsys, transformer
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.training.tree import flatten_with_path, tree_map

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tn(t):
    return t.detach().float().numpy()


def _assert_tree_close(jax_tree, torch_tree, rtol=RTOL, atol=ATOL):
    want = dict(flatten_with_path(jax.tree.map(_np, jax_tree)))
    got = dict(flatten_with_path(torch_tree))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(_tn(got[k]), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------
def _gr_pair():
    jcfg = dataclasses.replace(jax_smoke_config("static-gr"), ce_chunk=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jax_transformer.init_params(jcfg, jax.random.key(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _grads_of(loss_fn, params):
    leaves = [l for _, l in flatten_with_path(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _assert_gr_grads(jg, tg, cfg):
    for i in range(cfg.n_layers):
        _assert_tree_close(jax.tree.map(lambda a: a[i], jg["dense_layers"]),
                           tg["layers"][i], atol=1e-6)
    np.testing.assert_allclose(_tn(tg["emb"]), np.asarray(jg["emb"]),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("trie_aware", [False, True])
def test_lm_losses_and_gradients_match_jax(trie_aware):
    """lm_loss (chunked CE, ce_chunk 8 of S = 32) and lm_loss_trie_aware
    (a restrictive mask that keeps every label admissible, and one
    all-False row): values and every parameter's gradient vs jax.grad."""
    jcfg, cfg, jp, tp = _gr_pair()
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    if trie_aware:
        adm = rng.random((2, 32, cfg.vocab_size)) < 0.2
        labels = np.roll(tok, -1, axis=1)
        adm[np.arange(2)[:, None], np.arange(32)[None, :], np.roll(
            labels, 1, axis=1)] = True
        adm[1, 5] = False
        jfn = lambda p: jax_transformer.lm_loss_trie_aware(
            p, jnp.asarray(tok), jcfg, jnp.asarray(adm), 0.5)
        tfn = lambda p: transformer.lm_loss_trie_aware(
            p, torch.from_numpy(tok), cfg, torch.from_numpy(adm), 0.5)
    else:
        jfn = lambda p: jax_transformer.lm_loss(p, jnp.asarray(tok), jcfg)
        tfn = lambda p: transformer.lm_loss(p, torch.from_numpy(tok), cfg)
    jl, jg = jax.jit(jax.value_and_grad(jfn))(jp)
    tl, tg = _grads_of(tfn, tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_gr_grads(jg, tg, cfg)


def test_lm_loss_trie_aware_identities():
    _, cfg, _, tp = _gr_pair()
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    full = torch.ones((2, 16, cfg.vocab_size), dtype=torch.bool)
    with torch.no_grad():
        base = transformer.lm_loss(tp, tok, cfg)
        same = transformer.lm_loss_trie_aware(tp, tok, cfg, full, 0.5)
    np.testing.assert_allclose(float(same), float(base), atol=1e-6)


@pytest.mark.parametrize("arch", ["wide-deep", "fm", "dlrm-mlperf", "mind"])
def test_recsys_loss_and_table_gradients_match_jax(arch):
    """recsys_loss and the gradient of every parameter (the tables through
    the bag lookups' backward, ids past the tables included: the clamped
    row gets their gradient) vs jax.grad."""
    jcfg = jax_smoke_config(arch)
    cfg = RecsysConfig(**dataclasses.asdict(jcfg))
    jp = jax_recsys.init_params(jcfg, jax.random.key(0))
    tp = recsys_params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    rng = np.random.default_rng(6)
    n = 24
    batch = {
        "sparse": np.stack([rng.integers(0, v + 3, (n, cfg.multi_hot))
                            for v in cfg.vocab_sizes], 1).astype(np.int32),
        "dense": rng.normal(size=(n, max(cfg.n_dense, 1))).astype(np.float32),
        "hist": rng.integers(0, 40, (n, cfg.hist_len)).astype(np.int32),
        "target": rng.integers(0, 40, (n,)).astype(np.int32),
        "label": rng.integers(0, 2, (n,)).astype(np.float32),
    }
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_recsys.recsys_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)))(jp)
    tl, tg = _grads_of(lambda p: recsys.recsys_loss(
        p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_tree_close(jg, tg)
    assert tg["table_0"].abs().sum() > 0


def _dense_attention(q, k, v):
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def test_chunked_attention_gradients_flow_through_the_slice_writes():
    """chunked_causal_attention writes its query chunks into a
    ``torch.empty`` by slice assignment: its gradients for q, k and v equal
    a dense causal attention's (rtol 1e-5) and jax.grad of the reference's
    chunked attention."""
    rng = np.random.default_rng(7)
    B, S, H, KV, D = 2, 24, 4, 2, 8
    arrs = [rng.normal(size=(B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]
    cot = rng.normal(size=(B, S, H, D)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = chunked_causal_attention(*ts, chunk_q=8, chunk_kv=4)
    got = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    ds = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    want = torch.autograd.grad(_dense_attention(*ds), ds,
                               torch.from_numpy(cot))
    jfn = lambda q, k, v: jnp.sum(jax_attention.chunked_causal_attention(
        q, k, v, chunk_q=8, chunk_kv=4) * cot)
    jax_grads = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for g, w, j in zip(got, want, jax_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
