"""Step parity of the dry-run cells: the port's ``Cell.fn`` in a world of
one on the CPU (``repro_torch.launch.dryrun.run_one``: DTensors on a (1, 1)
mesh over gloo) against the reference's ``cell.fn`` jitted on a one-device
mesh, on the same inputs, for one cell of every step kind.

Debug configs and shapes (``tests/torch_dryrun_workers.py``) replace the
registry's on both sides; the reference's registry and static-gr's catalog
size are patched in this process only (``monkeypatch``).  Weights are the
reference's ``init_params``, carried over by ``repro_torch.convert``.
Integers equal; float32 scores, losses and, after one AdamW update, the
parameters and moments within rtol 1e-5 and atol 1e-5 (FM's sum-square
term cancels near 0); the permuted beam caches equal but for the step's own
k/v, bf16 roundings of products, within one bf16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.static_gr as jstatic_gr
import repro.launch.steps as jsteps
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import GraphShape as JGraphShape
from repro.configs.base import LMShape as JLMShape
from repro.configs.base import RecsysShape as JRecsysShape
from repro.configs.static_gr import GRShape as JGRShape
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import static_gr
from repro_torch.launch import dryrun
from repro_torch.models.kvcache import KVCache
from torch_dryrun_workers import debug_bundle

N_CONSTRAINTS = 3_000  # the catalog both sides' GR trie specs are sized by
_JSHAPE = {"LMShape": JLMShape, "GRShape": JGRShape,
           "GraphShape": JGraphShape, "RecsysShape": JRecsysShape}


def _jax_bundle(arch):
    port = debug_bundle(arch)
    cfg = jax_smoke_config(arch)
    if port.family == "gr":
        cfg = dataclasses.replace(cfg, vocab_size=port.config.vocab_size)
    shapes = tuple(_JSHAPE[type(s).__name__](**dataclasses.asdict(s))
                   for s in port.shapes)
    return dataclasses.replace(jconfigs.get_bundle(arch), config=cfg,
                               shapes=shapes)


@pytest.fixture
def patched(monkeypatch):
    monkeypatch.setattr(jsteps, "get_bundle", _jax_bundle)
    monkeypatch.setattr(jstatic_gr, "N_CONSTRAINTS", N_CONSTRAINTS)
    monkeypatch.setattr(static_gr, "N_CONSTRAINTS", N_CONSTRAINTS)


def _ref_run(arch, shape, args):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    cell = jsteps.build_cell(arch, shape, mesh)
    with jax.set_mesh(mesh):
        fn = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                     out_shardings=cell.out_shardings)
        return jax.tree.map(np.asarray, fn(*args)), cell


def _port_run(arch, shape, args):
    rec = dryrun.run_one(arch, shape, "cpu", bundle=debug_bundle(arch),
                         args=dict(enumerate(args)), iters=0)
    return _numpy(rec["outputs"]), rec


def _numpy(x):
    """Outputs as numpy: DTensors by their (1, 1) shard, caches by field."""
    if isinstance(x, KVCache):
        return dataclasses.replace(x, **{
            k: _local(v) for k, v in vars(x).items()
            if isinstance(v, torch.Tensor)})
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return _local(x) if isinstance(x, torch.Tensor) else x


def _local(t):
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.detach().float().numpy() if t.is_floating_point() else \
        t.numpy()


def _t(a, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                              if dtype else a))
    return x.to(dtype) if dtype else x


def _bf16(rng, shape):
    """bf16 values: float32 numbers rounded once, the same on both sides."""
    x = np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _lm_params(arch, seed=0):
    cfg = _jax_bundle(arch).config
    p = jax.tree.map(np.asarray, jtransformer.init_params(
        cfg, jax.random.key(seed)))
    return p, convert.params_from_jax(p, debug_bundle(arch).config, "cpu")


def _opt_zero(tree):
    return {"m": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree),
            "v": jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)}


def _port_opt_zero(tree):
    z = lambda t: torch.zeros(t.shape, dtype=torch.float32)  # noqa: E731
    from repro_torch.training.tree import tree_map

    return {"m": tree_map(z, tree), "v": tree_map(z, tree)}


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _params_close(port_tree, ref_tree, cfg, what):
    """The port's per-layer tree against the reference's stacked one."""
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    for k, v in ref_tree.items():
        if k in ("dense_layers", "moe_layers"):
            off = 0 if k == "dense_layers" else n_dense
            for i in range(jax.tree.leaves(v)[0].shape[0]):
                _tree_close(port_tree["layers"][off + i],
                            jax.tree.map(lambda x: x[i], v), what + (k, i))
        else:
            _tree_close(port_tree[k], v, what + (k,))


def _tree_close(p, r, what):
    if isinstance(r, dict):
        for k in r:
            _tree_close(p[k], r[k], what + (k,))
    else:
        _close(p, r, what=str(what))


def test_lm_train_step_matches_the_reference(patched):
    arch = "stablelm-12b"
    cfg = _jax_bundle(arch).config
    rng = np.random.default_rng(0)
    jp, tp = _lm_params(arch)
    tok = rng.integers(0, cfg.vocab_size, (16, 32), dtype=np.int32)
    (rp, ro, rl), _ = _ref_run(arch, "train_4k",
                               (jp, _opt_zero(jp), np.int32(0), tok))
    (pp, po, pl), rec = _port_run(arch, "train_4k", (
        tp, _port_opt_zero(tp), torch.tensor(0, dtype=torch.int32),
        torch.from_numpy(tok)))
    _close(pl, rl, what="loss")
    _params_close(pp, rp, cfg, ("params",))
    _params_close(po["m"], ro["m"], cfg, ("m",))
    _params_close(po["v"], ro["v"], cfg, ("v",))
    assert rec["kind"] == "train"


def test_lm_prefill_and_decode_match_the_reference(patched):
    arch = "stablelm-12b"
    cfg = _jax_bundle(arch).config
    rng = np.random.default_rng(1)
    jp, tp = _lm_params(arch, 1)
    tok = rng.integers(0, cfg.vocab_size, (8, 32), dtype=np.int32)
    (rl, rc), _ = _ref_run(arch, "prefill_32k", (jp, tok))
    (pl, pc), _ = _port_run(arch, "prefill_32k", (tp, torch.from_numpy(tok)))
    _close(pl, rl, what="prefill logits")
    _close(pc.k, rc.k, what="prefill k")
    _close(pc.v, rc.v, what="prefill v")
    np.testing.assert_array_equal(pc.slot_pos, rc.slot_pos)

    # decode at position 32 against a cache whose first 32 slots are set
    B, slots = 16, 256
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    k = rng.normal(size=(L, B, slots, KV, hd)).astype(np.float32)
    v = rng.normal(size=(L, B, slots, KV, hd)).astype(np.float32)
    slot_pos = np.where(np.arange(slots) < 32, np.arange(slots), -1).astype(
        np.int32)
    tok1 = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
    jcache = jtransformer.init_cache(cfg, B, slots)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(k), v=jnp.asarray(v),
                                 slot_pos=jnp.asarray(slot_pos))
    (rl, rc), _ = _ref_run(arch, "decode_32k", (jp, jcache, tok1))
    pcache = KVCache(k=_t(k), v=_t(v), slot_pos=torch.from_numpy(slot_pos),
                     pos=0)
    (pl, pc), _ = _port_run(arch, "decode_32k",
                            (tp, pcache, torch.from_numpy(tok1)))
    _close(pl, rl, what="decode logits")
    _close(pc.k, rc.k, what="decode k")
    np.testing.assert_array_equal(pc.slot_pos, rc.slot_pos)


def _trie(rng, n_states, n_edges, V, bmax):
    """A CSR of ``n_states`` rows (each 0..bmax sorted distinct tokens,
    next states in range) in the cell's shapes: edges padded with zeros."""
    counts = rng.integers(0, bmax + 1, n_states)
    counts[np.cumsum(counts) > n_edges] = 0
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    edges = np.zeros((n_edges + 256, 2), np.int32)
    for s in np.flatnonzero(counts):
        toks = np.sort(rng.choice(V, counts[s], replace=False))
        edges[rp[s]:rp[s + 1], 0] = toks
        edges[rp[s]:rp[s + 1], 1] = rng.integers(0, n_states, counts[s])
    return rp, edges


@pytest.mark.parametrize("kind", ["gr_serve_constrained",
                                  "gr_serve_unconstrained"])
@pytest.mark.parametrize("batched", [False, True])
def test_gr_serve_step_matches_the_reference(patched, monkeypatch, kind,
                                             batched):
    arch = "static-gr"
    if batched:
        monkeypatch.setattr(jsteps, "get_bundle", lambda a: dataclasses.replace(
            _jax_bundle(a), config=dataclasses.replace(
                _jax_bundle(a).config, gr_batched_beams=True)))
    cfg = _jax_bundle(arch).config
    bundle = debug_bundle(arch)
    port_bundle = dataclasses.replace(bundle, config=dataclasses.replace(
        bundle.config, gr_batched_beams=batched))
    shape = next(s for s in bundle.shapes if s.name == kind)
    B, M, S_h, S = (shape.global_batch, shape.beam_size, shape.history_len,
                    shape.sid_length)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim()
    rng = np.random.default_rng(2)
    jp, tp = _lm_params(arch, 2)
    specs = {k: tuple(v.shape) for k, v in jsteps._gr_trie_specs().items()}
    rp, edges = _trie(rng, specs["row_pointers"][0] - 1,
                      specs["edges"][0] - 256, static_gr.SID_VOCAB, 32)
    l1p = rng.integers(0, 256, specs["l1_mask_packed"], dtype=np.uint8)
    l1s = rng.integers(0, 100, specs["l1_states"], dtype=np.int32)
    hk, thk = _bf16(rng, (L, B, S_h, KV, hd))
    hv, thv = _bf16(rng, (L, B, S_h, KV, hd))
    beam_shape = (L, B, M, S, KV, hd) if batched else (L, B * M, S, KV, hd)
    bk, tbk = _bf16(rng, beam_shape)
    bv, tbv = _bf16(rng, beam_shape)
    tok = rng.integers(0, static_gr.SID_VOCAB, (B * M, 1), dtype=np.int32)
    scores = rng.normal(size=(B, M)).astype(np.float32)
    nodes = rng.integers(0, len(rp) - 1, (B, M), dtype=np.int32)
    tm = {"row_pointers": rp, "edges": edges, "l1_mask_packed": l1p,
          "l1_states": l1s}
    want, _ = _ref_run(arch, kind, (jp, jnp.asarray(hk), jnp.asarray(hv),
                                    jnp.asarray(bk), jnp.asarray(bv), tok,
                                    scores, nodes, tm))
    rec = dryrun.run_one(arch, kind, "cpu", bundle=port_bundle, iters=0,
                         args=dict(enumerate((
                             tp, thk, thv, tbk, tbv, torch.from_numpy(tok),
                             torch.from_numpy(scores),
                             torch.from_numpy(nodes),
                             {k: torch.from_numpy(v) for k, v in tm.items()}))))
    got = _numpy(rec["outputs"])
    np.testing.assert_array_equal(got[0], want[0])  # tokens
    _close(got[1], want[1], atol=0, what="scores")
    np.testing.assert_array_equal(got[2], want[2])  # next nodes
    # the permuted caches: a gather of the inputs, equal; this step's k/v
    # (slot SID_STEP) are products rounded to bf16, within one bf16 ulp
    slot = (slice(None),) * (3 if batched else 2) + (2,)  # SID_STEP
    for g, w in ((got[3], want[3]), (got[4], want[4])):
        w = np.asarray(w, np.float32)
        keep = np.ones(w.shape, bool)
        keep[slot] = False
        np.testing.assert_array_equal(g[keep], w[keep])
        np.testing.assert_allclose(g[slot], w[slot], rtol=2.0 ** -7, atol=0)


def test_gnn_train_step_matches_the_reference(patched):
    arch = "meshgraphnet"
    bundle = debug_bundle(arch)
    shape = bundle.shapes[0]
    cfg = dataclasses.replace(bundle.config, node_feat_dim=shape.d_feat)
    jcfg = dataclasses.replace(_jax_bundle(arch).config,
                               node_feat_dim=shape.d_feat)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(np.asarray, jgnn.init_params(jcfg, jax.random.key(3)))
    tp = convert.gnn_params_from_jax(jp, cfg, "cpu")
    n, e = 512, 512  # padded to 512 by the cell
    batch = {
        "node_feats": rng.normal(size=(n, shape.d_feat)).astype(np.float32),
        "edge_feats": rng.normal(size=(e, cfg.edge_feat_dim)).astype(
            np.float32),
        "senders": rng.integers(0, shape.n_nodes, e, dtype=np.int32),
        "receivers": rng.integers(0, shape.n_nodes, e, dtype=np.int32),
        "targets": rng.normal(size=(n, cfg.out_dim)).astype(np.float32),
        "node_mask": np.arange(n) < shape.n_nodes,
    }
    (rp, _, rl), _ = _ref_run(arch, shape.name,
                              (jp, _opt_zero(jp), np.int32(0), batch))
    (pp, _, pl), _ = _port_run(arch, shape.name, (
        tp, _port_opt_zero(tp), torch.tensor(0, dtype=torch.int32),
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    _close(pl, rl, what="gnn loss")
    for i in range(cfg.n_layers):
        _tree_close(pp["processor"][i],
                    jax.tree.map(lambda x: x[i], rp["processor"]), ("proc", i))


@pytest.mark.parametrize("arch,shape", [("wide-deep", "serve_p99"),
                                        ("mind", "retrieval_cand"),
                                        ("fm", "retrieval_cand")])
def test_recsys_steps_match_the_reference(patched, arch, shape):
    bundle = debug_bundle(arch)
    cfg = bundle.config
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.asarray, jrecsys.init_params(
        _jax_bundle(arch).config, jax.random.key(4)))
    tp = convert.recsys_params_from_jax(jp, cfg, "cpu")
    sh = next(s for s in bundle.shapes if s.name == shape)
    if arch == "mind":
        hist = rng.integers(0, cfg.vocab_sizes[0], (1, cfg.hist_len),
                            dtype=np.int32)
        cand = rng.integers(0, cfg.vocab_sizes[0], sh.n_candidates,
                            dtype=np.int32)
        want, _ = _ref_run(arch, shape, (jp, hist, cand))
        got, _ = _port_run(arch, shape, (tp, torch.from_numpy(hist),
                                         torch.from_numpy(cand)))
    else:
        n = sh.n_candidates or sh.batch
        batch = {
            "dense": rng.normal(size=(n, max(cfg.n_dense, 1))).astype(
                np.float32),
            "sparse": np.stack([rng.integers(0, v, (n, cfg.multi_hot))
                                for v in cfg.vocab_sizes], 1).astype(np.int32),
            "hist": rng.integers(0, 10, (n, cfg.hist_len), dtype=np.int32),
            "target": rng.integers(0, 10, n, dtype=np.int32),
            "label": rng.integers(0, 2, n).astype(np.float32),
        }
        want, _ = _ref_run(arch, shape, (jp, batch))
        got, _ = _port_run(arch, shape, (
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    _close(got, want, what=f"{arch} {shape}")
