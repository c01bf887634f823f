"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on carried-over float32 weights.

Tolerances: outputs and gradients within 1e-5 of the largest magnitude of
the tensor compared (``_close``), aux losses within rtol/atol 1e-5.  The
reference's He fan-in of ``w1``/``w3`` is their leading axis (the expert
count), so expert outputs run to ~50 at the smoke width; float32 products
summed in another order by the two frameworks' kernels differ by a few
float32 ulps of that scale.  The integer dispatch (expert ids, positions in
the expert, ``keep``) must be equal, held against the reference's own
lines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro_torch.configs import smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.models.layers import swiglu
from repro_torch.training.tree import flatten_with_path, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-5 * scale, err_msg
ARCHS = ["mixtral-8x7b", "deepseek-v2-lite-16b"]


def _configs(arch, **kw):
    """(JAX MoEConfig, port MoEConfig, d_model) of an arch's smoke config."""
    jm = dataclasses.replace(jax_smoke_config(arch).moe, **kw)
    return jm, MoEConfig(**dataclasses.asdict(jm)), smoke_config(arch).d_model


def _params(jm, D, seed=0):
    jp = jax_moe.moe_init(jax.random.key(seed), D, jm, jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, jp))
    return jp, tp


def _reference_dispatch(jp, x, jm):
    """The reference's routing, line for line from ``_moe_ffn_single``:
    (expert ids (T*K,), positions (T*K,), keep (T*K,))."""
    x = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, jm.top_k)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jm.n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    keep = pos < jax_moe.expert_capacity(x.shape[0], jm)
    return np.asarray(flat_e), np.asarray(pos), np.asarray(keep)


def _run_both(jp, tp, x, jm, cfg):
    j_out, j_aux = jax_moe.moe_ffn(jp, jnp.asarray(x), jm)
    t_out, t_aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    _close(t_out.numpy(), j_out)
    np.testing.assert_allclose(float(t_aux), float(j_aux), **TOL)
    return t_out, t_aux


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(rng, arch):
    jm, cfg, D = _configs(arch)
    jp, tp = _params(jm, D)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    _run_both(jp, tp, x, jm, cfg)
    _, _, top_i, pos, keep = moe.route(tp["router"], torch.from_numpy(
        x.reshape(1, -1, D)), cfg)
    e, p, k = _reference_dispatch(jp, x, jm)
    np.testing.assert_array_equal(top_i.reshape(-1).numpy(), e)
    np.testing.assert_array_equal(pos.reshape(-1).numpy(), p)
    np.testing.assert_array_equal(keep.reshape(-1).numpy(), k)
    # a 2-D input (decode rows) takes the flat dispatch too
    _run_both(jp, tp, x[0], jm, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_equivalence(rng, arch):
    """dispatch_groups 2 == 0 where the capacity drops nothing (the
    reference's ``test_grouped_dispatch_equivalence``), and each equals the
    reference's grouped and flat calls."""
    jm, cfg, D = _configs(arch, capacity_factor=8.0)
    jp, tp = _params(jm, D)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    flat, _ = _run_both(jp, tp, x, jm, cfg)
    jg = dataclasses.replace(jm, dispatch_groups=2)
    grouped, _ = _run_both(jp, tp, x, jg, dataclasses.replace(
        cfg, dispatch_groups=2))
    _close(grouped.numpy(), flat.numpy())
    # S % G != 0 falls back to the flat dispatch, as in the reference
    _run_both(jp, tp, x[:, :15], dataclasses.replace(jm, dispatch_groups=4),
              dataclasses.replace(cfg, dispatch_groups=4))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_reference_tokens(rng, arch):
    """At capacity factor 0.25 the experts overflow: the same assignments
    are dropped (``keep`` and positions equal) and the outputs agree."""
    jm, cfg, D = _configs(arch, capacity_factor=0.25)
    jp, tp = _params(jm, D, seed=3)
    x = rng.normal(size=(1, 64, D)).astype(np.float32)
    _run_both(jp, tp, x, jm, cfg)
    _, _, top_i, pos, keep = moe.route(tp["router"], torch.from_numpy(x),
                                       cfg)
    e, p, k = _reference_dispatch(jp, x, jm)
    assert not k.all() and k.any()
    np.testing.assert_array_equal(top_i.reshape(-1).numpy(), e)
    np.testing.assert_array_equal(pos.reshape(-1).numpy(), p)
    np.testing.assert_array_equal(keep.reshape(-1).numpy(), k)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_to_the_lower_experts(rng, arch):
    """A zero router gives every token equal probabilities: ties go to the
    lower expert index (``lax.top_k``), so experts 0..K-1 take every token
    and the others none."""
    jm, cfg, D = _configs(arch, capacity_factor=8.0)
    jp, tp = _params(jm, D)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = rng.normal(size=(2, 8, D)).astype(np.float32)
    _run_both(jp, tp, x, jm, cfg)
    _, top_w, top_i, _, keep = moe.route(tp["router"], torch.from_numpy(
        x.reshape(1, -1, D)), cfg)
    assert (top_i == torch.arange(cfg.top_k)).all()
    assert torch.equal(top_w, torch.full_like(top_w, 1.0 / cfg.top_k))
    assert keep.all()


def test_shared_experts_add_outside_the_grouping(rng):
    """DeepSeek's shared experts (one SwiGLU of width ``d_shared``) add to
    the routed output of every token, with grouped dispatch too."""
    jm, cfg, D = _configs("deepseek-v2-lite-16b", dispatch_groups=2,
                          capacity_factor=8.0)
    assert cfg.n_shared == 2
    jp, tp = _params(jm, D)
    assert tp["shared"]["w1"].shape == (D, cfg.d_shared)
    x = rng.normal(size=(2, 8, D)).astype(np.float32)
    out, _ = _run_both(jp, tp, x, jm, cfg)
    routed, _ = moe.moe_ffn({k: v for k, v in tp.items() if k != "shared"},
                            torch.from_numpy(x), cfg)
    shared = swiglu(tp["shared"], torch.from_numpy(x))
    _close(out.numpy(), (routed + shared).numpy())
    assert shared.abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(rng, arch):
    """d(sum(out * w) + aux) / d(params, x) against ``jax.grad``: through the
    renormalized top-k weights, the experts' products, the scatter into the
    buffer and the aux loss's mean probabilities."""
    jm, cfg, D = _configs(arch, capacity_factor=0.5)
    jp, tp = _params(jm, D, seed=1)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def j_loss(p, xx):
        out, aux = jax_moe.moe_ffn(p, xx, jm)
        return jnp.sum(out * w) + aux

    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = [v.requires_grad_(True) for _, v in flatten_with_path(tp)]
    out, aux = moe.moe_ffn(tp, tx, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                leaves + [tx])
    _close(grads[-1].numpy(), jgx)
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jgp)))
    for (key, _), g in zip(flatten_with_path(tp), grads):
        _close(g.numpy(), want[key], err_msg=key)
    assert np.abs(want["router"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_equals_reference(arch):
    """At the smoke and the published config, from one token (a decode
    row) to prefill_32k's 32,768."""
    for jm in (jax_smoke_config(arch).moe, get_bundle(arch).config.moe):
        cfg = MoEConfig(**dataclasses.asdict(jm))
        for n in (1, 32, 4 * 4_096, 32_768):
            assert moe.expert_capacity(n, cfg) == jax_moe.expert_capacity(
                n, jm)
