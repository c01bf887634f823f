"""The port's MeshGraphNet (``repro_torch.models.gnn``) and fanout sampler
(``repro_torch.data.graph_sampler``) against the reference's, and the
training launcher on the families this slice adds.

The sampler is a numpy copy: under one ``np.random.Generator`` seed its
arrays must be equal.  The model runs on carried-over float32 weights
(``gnn_params_from_jax``); tolerance rtol/atol 1e-5 on outputs and losses
(float32 products in another order), gradients within 1e-5 of the largest
magnitude of each tensor.  A batched input runs as one graph of disjoint
parts: it must equal a per-graph loop within 1e-6 (the same arithmetic,
row for row; only the products' blocking may differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import graph_sampler as jax_sampler
from repro.models import gnn as jax_gnn
from repro_torch.configs import smoke_config
from repro_torch.configs.base import GNNConfig
from repro_torch.convert import gnn_params_from_jax
from repro_torch.data import graph_sampler
from repro_torch.launch import train as train_launcher
from repro_torch.models import gnn
from repro_torch.training.tree import flatten_with_path

TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = ("node_feats", "edge_feats", "senders", "receivers")
_j_init = jax.jit(jax_gnn.init_params, static_argnums=(0,))


def _model(**kw):
    jcfg = dataclasses.replace(jax_smoke_config("meshgraphnet"), **kw)
    cfg = GNNConfig(**dataclasses.asdict(jcfg))
    jparams = _j_init(jcfg, jax.random.key(0))
    params = gnn_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return jcfg, cfg, jparams, params


def _graph(rng, cfg, N=20, E=50):
    return {
        "node_feats": rng.normal(size=(N, cfg.node_feat_dim)).astype(
            np.float32),
        "edge_feats": rng.normal(size=(E, cfg.edge_feat_dim)).astype(
            np.float32),
        "senders": rng.integers(0, N, E).astype(np.int32),
        "receivers": rng.integers(0, N, E).astype(np.int32),
        "targets": rng.normal(size=(N, cfg.out_dim)).astype(np.float32),
    }


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def test_sampler_is_array_equal_to_the_reference():
    """``random_graph`` and ``fanout_sample`` under one seed: every array
    equal, at a fanout above some nodes' degree (sampling with replacement)
    and below others'."""
    for seed, (n, deg, fanout) in enumerate([(500, 8, (3, 2)),
                                             (300, 3, (5, 4)),
                                             (2_000, 20, (15, 10))]):
        g = graph_sampler.random_graph(np.random.default_rng(seed), n, deg, 6)
        jg = jax_sampler.random_graph(np.random.default_rng(seed), n, deg, 6)
        for f in ("indptr", "indices", "node_feats"):
            np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
        assert g.n_nodes == jg.n_nodes == n
        seeds = np.random.default_rng(seed + 10).choice(n, 16, replace=False)
        got = graph_sampler.fanout_sample(g, seeds, fanout,
                                          np.random.default_rng(seed + 20), 4)
        want = jax_sampler.fanout_sample(jg, seeds, fanout,
                                         np.random.default_rng(seed + 20), 4)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        sizes = np.cumprod(fanout)
        assert got["node_mask"].shape == (16 * (1 + int(sizes.sum())),)
        assert got["edge_mask"].shape == (16 * int(sizes.sum()),)


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_forward_and_loss_match_reference(rng, aggregator):
    """A full graph: node outputs and the L2 loss, sum and mean message
    aggregation (mean divides by the in-degree, at least 1)."""
    jcfg, cfg, jparams, params = _model(aggregator=aggregator)
    jb, tb = _both(_graph(rng, cfg))
    want = jax_gnn.forward(jparams, *(jb[k] for k in KEYS), jcfg)
    got = gnn.forward(params, *(tb[k] for k in KEYS), cfg)
    assert got.shape == (20, cfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gnn.gnn_loss(params, tb, cfg)),
                               float(jax_gnn.gnn_loss(jparams, jb, jcfg)),
                               **TOL)


def test_sampled_subgraph_with_node_mask_matches_reference():
    """A fanout subgraph of the sampler: masked nodes' outputs are zero,
    the loss averages over the nodes in the mask only."""
    jcfg, cfg, jparams, params = _model()
    g = graph_sampler.random_graph(np.random.default_rng(0), 400, 2,
                                   cfg.node_feat_dim)
    sub = graph_sampler.fanout_sample(g, np.arange(8), (4, 3),
                                      np.random.default_rng(1),
                                      cfg.edge_feat_dim)
    assert not sub["node_mask"].all()
    batch = {k: sub[k] for k in KEYS + ("node_mask",)}
    batch["targets"] = np.random.default_rng(2).normal(
        size=(len(sub["node_mask"]), cfg.out_dim)).astype(np.float32)
    jb, tb = _both(batch)
    want = jax_gnn.forward(jparams, *(jb[k] for k in KEYS), jcfg,
                           node_mask=jb["node_mask"])
    got = gnn.forward(params, *(tb[k] for k in KEYS), cfg,
                      node_mask=tb["node_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[~tb["node_mask"]].any()
    np.testing.assert_allclose(float(gnn.gnn_loss(params, tb, cfg)),
                               float(jax_gnn.gnn_loss(jparams, jb, jcfg)),
                               **TOL)


def test_batched_graphs_match_reference_and_a_per_graph_loop(rng):
    """Three small graphs (the molecule shape's layout): the batched call
    against the reference's vmap and against the port's own loop over the
    graphs; the loss against the reference's."""
    jcfg, cfg, jparams, params = _model()
    graphs = [_graph(rng, cfg, N=12, E=30) for _ in range(3)]
    batch = {k: np.stack([g[k] for g in graphs]) for k in graphs[0]}
    jb, tb = _both(batch)
    got = gnn.forward(params, *(tb[k] for k in KEYS), cfg)
    want = jax.vmap(lambda *a: jax_gnn.forward(jparams, *a, jcfg))(
        *(jb[k] for k in KEYS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    loop = torch.stack([gnn.forward(params, *(tb[k][b] for k in KEYS), cfg)
                        for b in range(3)])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(gnn.gnn_loss(params, tb, cfg)),
                               float(jax_gnn.gnn_loss(jparams, jb, jcfg)),
                               **TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_gnn_loss_gradients_match_jax_grad(rng, remat):
    """``gnn_loss`` gradients against ``jax.grad`` on a masked graph, with
    the processor's layers recomputed in the backward or kept."""
    jcfg, cfg, jparams, params = _model(remat=remat, aggregator="mean")
    batch = _graph(rng, cfg)
    batch["node_mask"] = rng.random(20) < 0.7
    jb, tb = _both(batch)
    want = jax.grad(jax_gnn.gnn_loss)(jparams, jb, jcfg)
    want = gnn_params_from_jax(jax.tree.map(np.asarray, want), cfg,
                               device="cpu")
    leaves = [v.requires_grad_(True) for _, v in flatten_with_path(params)]
    grads = torch.autograd.grad(gnn.gnn_loss(params, tb, cfg), leaves)
    for (key, w), g in zip(flatten_with_path(want), grads):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-5 * scale, key
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_init_params_layout_matches_reference():
    _, cfg, _, ref = _model()
    got = gnn.init_params(cfg, seed=0, device="cpu")
    assert ([(k, tuple(v.shape)) for k, v in flatten_with_path(got)]
            == [(k, tuple(v.shape)) for k, v in flatten_with_path(ref)])
    assert len(got["processor"]) == cfg.n_layers
    again = gnn.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["node_enc"]["l0"]["w"],
                       got["node_enc"]["l0"]["w"])


@pytest.mark.parametrize("arch", ["meshgraphnet", "mixtral-8x7b"])
def test_launch_train_new_families_on_cpu(capsys, arch):
    """``launch.train --device cpu`` trains the smoke config of the gnn and
    of an lm arch (MoE, sliding window) for a few steps, as the reference's
    launcher does; the synthetic batches equal the reference launcher's."""
    losses = train_launcher.main(["--arch", arch, "--steps", "3", "--batch",
                                  "4", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done: 3 steps" in capsys.readouterr().out
    from repro.launch.train import synth_batches as jax_synth
    j = jax_synth(arch, jax_smoke_config(arch), 4)
    t = train_launcher.synth_batches(arch, smoke_config(arch), 4)
    for _ in range(2):
        jb, tb = next(j), next(t)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
