"""Per-(architecture x shape) step builders for the multi-pod dry run
(``repro.launch.steps``).

``build_cell(arch_id, shape_name, mesh)`` returns a :class:`Cell` holding
the step function, its arguments as ``meta`` tensors (shapes and dtypes,
never allocated), their specs and the outputs' on the mesh (the port's tuple
specs, :mod:`repro_torch.distributed.sharding`), and the analytic model
FLOPs per chip of the reference's roofline (6·N·D dense, 6·N_active·D MoE,
plus the exact attention terms).  ``mesh`` is a ``DeviceMesh`` or a
:class:`~repro_torch.launch.mesh.MeshSpec`: the specs need no world.

Step kinds:
  lm/train    — loss + grads + AdamW update (a full training step)
  lm/prefill  — forward + KV-cache build, last-token logits
  lm/decode   — one token against a (sequence-sharded) KV cache
  gr/serve    — one constrained SID decode step: prefix-shared decode, then
                Algorithm 1 (log-softmax -> VNTK mask -> beam top-k ->
                gather)
  gnn/train   — full-graph or sampled-subgraph regression step
  recsys/*    — train / bulk-serve / retrieval scoring

Each step calls the port's own model functions on the plain route (a
CUDA kernel launch cannot take a meta tensor or a ``DTensor``), as the
reference's cells take its plain scatter and gathers.  Decode attention
takes no ``impl``: over meta shards it runs its plain ops, and over CUDA
shards (``--mesh one`` on the card) its kernel raises, so an LM decode
cell that reaches it (GQA, cache written eagerly) runs in a world of one
on the CPU only.  The train steps take
their gradients with ``torch.autograd.grad`` and update the parameters and
AdamW moments in place (:mod:`repro_torch.training.optimizer`); they return
them, as the reference's return the new ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_bundle, static_gr, supports_shape
from repro_torch.configs.base import GraphShape, LMShape, RecsysShape
from repro_torch.core.vntk import top_m, vntk_reference_scatter
from repro_torch.distributed import sharding as sh
from repro_torch.models import gnn, recsys, transformer
from repro_torch.training.optimizer import adamw
from repro_torch.training.tree import tree_leaves, tree_map, unflatten_like

__all__ = ["Cell", "build_cell", "input_specs", "list_cells"]

_OPT = adamw(lr=1e-4)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple  # trees of meta tensors
    in_specs: tuple  # a spec tree per argument
    out_specs: Any
    model_flops_per_chip: float  # analytic useful flops / chip / step
    notes: str = ""
    donate_argnums: tuple = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _bspec(mesh, batch, rank) -> tuple:
    n_dp = sh.dp_size(mesh)
    lead = (sh._entry(sh.dp_axes(mesh))
            if batch % n_dp == 0 and batch >= n_dp else None)
    return (lead,) + (None,) * (rank - 1)


def _round_to(x, m):
    return -(-x // m) * m


def _train(loss_fn, params, opt_state, step_no):
    """One AdamW step of ``loss_fn(params)``: ``(params, opt_state,
    loss)``, the parameters and moments updated in place."""
    tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(tree)
    grads = unflatten_like(tree, torch.autograd.grad(loss, tree_leaves(tree)))
    new_p, new_o = _OPT.update(grads, opt_state, params, step_no)
    return new_p, new_o, loss.detach()


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------


def _lm_attn_flops(cfg, n_tokens, kv_len=None, causal=True):
    hd = cfg.resolved_head_dim() if cfg.attention != "mla" else (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    kv_len = kv_len or n_tokens
    if cfg.sliding_window:
        kv_len = min(kv_len, cfg.sliding_window)
    f = 2 * 2 * n_tokens * kv_len * cfg.n_heads * hd
    return f / 2 if causal else f


def _lm_train_cell(arch_id, bundle, shape: LMShape, mesh) -> Cell:
    cfg = bundle.config
    dp_ok = shape.global_batch % sh.dp_size(mesh) == 0
    if cfg.use_sp and dp_ok:
        # read only by JAX sharding constraints; kept for the field mapping
        cfg = dataclasses.replace(cfg, sp_axes=sh.dp_axes(mesh))
    p_specs = transformer.param_specs(cfg)
    o_specs = _OPT.init(p_specs)
    p_psh = sh.lm_param_pspecs(p_specs, mesh, cfg.n_kv_heads)
    o_psh = {"m": p_psh, "v": p_psh}
    tok = _meta((shape.global_batch, shape.seq_len), torch.int32)
    tok_psh = _bspec(mesh, shape.global_batch, 2)

    n_mb = cfg.train_microbatches

    def train_step(params, opt_state, step_no, tokens):
        if n_mb == 1:
            return _train(lambda p: transformer.lm_loss(p, tokens, cfg),
                          params, opt_state, step_no)
        mbs = tokens.reshape(n_mb, tokens.shape[0] // n_mb, -1)

        def loss_fn(p):  # the mean over microbatches: grads average too
            return sum(transformer.lm_loss(p, mbs[i], cfg) / n_mb
                       for i in range(n_mb))

        return _train(loss_fn, params, opt_state, step_no)

    n_chips = mesh.size()
    tokens_total = shape.global_batch * shape.seq_len
    mf = (
        6 * cfg.active_param_count() * tokens_total
        + 3 * shape.global_batch * _lm_attn_flops(cfg, shape.seq_len)
    ) / n_chips
    return Cell(
        arch_id, shape.name, "train", train_step,
        (p_specs, o_specs, _meta((), torch.int32), tok),
        (p_psh, o_psh, (), tok_psh),
        (p_psh, o_psh, ()),
        mf,
        donate_argnums=(0, 1),
    )


def _lm_prefill_cell(arch_id, bundle, shape: LMShape, mesh) -> Cell:
    cfg = bundle.config
    p_specs = transformer.param_specs(cfg)
    p_psh = sh.lm_param_pspecs(p_specs, mesh, cfg.n_kv_heads)
    B, S = shape.global_batch, shape.seq_len
    tok = _meta((B, S), torch.int32)
    tok_psh = _bspec(mesh, B, 2)

    def prefill_step(params, tokens):
        return transformer.prefill(params, tokens, cfg)

    # prefill's cache with no reserved slots has init_cache's layout
    cache_specs = transformer.init_cache(cfg, B, S, device="meta")
    cache_psh = sh.kv_cache_pspecs(
        cache_specs, mesh, batch_shardable=B >= mesh.size() // 16)
    tokens_total = B * S
    mf = (
        2 * cfg.active_param_count() * tokens_total
        + B * _lm_attn_flops(cfg, S)
    ) / mesh.size()
    return Cell(
        arch_id, shape.name, "prefill", prefill_step,
        (p_specs, tok),
        (p_psh, tok_psh),
        (_bspec(mesh, B, 3), cache_psh),
        mf,
    )


def _lm_decode_cell(arch_id, bundle, shape: LMShape, mesh) -> Cell:
    cfg = bundle.config
    p_specs = transformer.param_specs(cfg)
    p_psh = sh.lm_param_pspecs(p_specs, mesh, cfg.n_kv_heads)
    B = shape.global_batch
    slots = _round_to(shape.seq_len + 128, 256)
    if cfg.sliding_window and cfg.sliding_window < slots:
        slots = cfg.sliding_window
    cache_specs = transformer.init_cache(cfg, B, slots, device="meta")
    cache_psh = sh.kv_cache_pspecs(cache_specs, mesh, batch_shardable=B > 1)
    tok = _meta((B, 1), torch.int32)
    tok_psh = _bspec(mesh, B, 2)

    def decode(params, cache, tokens):
        # place the query at the end of the prefilled context
        cache = dataclasses.replace(cache, pos=shape.seq_len)
        return transformer.decode_step(params, cache, tokens, cfg)

    kv_len = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    if cfg.attention == "mla":
        attn = 2 * 2 * B * kv_len * cfg.n_heads * (
            cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    else:
        attn = 2 * 2 * B * kv_len * cfg.n_heads * cfg.resolved_head_dim()
    mf = (2 * cfg.active_param_count() * B + attn) / mesh.size()
    logits_psh = _bspec(mesh, B, 3)
    if cfg.defer_cache_write:
        bdp = _bspec(mesh, B, 1)[0]
        pend_psh = ((None, bdp, None, None, None) if cfg.attention != "mla"
                    else (None, bdp, None, None))
        out_sh = (logits_psh, cache_psh, (pend_psh, pend_psh))
    else:
        out_sh = (logits_psh, cache_psh)
    notes = ""
    if cfg.decode_split_k:
        notes = ("decode_split_k: the reference only constrains the per-token "
                 "q/k/v to be replicated over model; the cache stays "
                 "sequence-sharded by its spec and DTensor places q/k/v by "
                 "the weights' rules")
    return Cell(
        arch_id, shape.name, "decode", decode,
        (p_specs, cache_specs, tok),
        (p_psh, cache_psh, tok_psh),
        out_sh,
        mf,
        notes=notes,
        donate_argnums=(1,),
    )


# --------------------------------------------------------------------------
# GR (paper) cells
# --------------------------------------------------------------------------


def _gr_trie_specs():
    """Spec-only stand-in for the 20M-constraint CSR (see DESIGN.md §6)."""
    V, L, C = static_gr.SID_VOCAB, static_gr.SID_LENGTH, static_gr.N_CONSTRAINTS
    n_states = 1 + sum(min(V ** l, C) for l in range(2, L + 1))
    n_edges = sum(min(V ** l, C) for l in range(3, L + 1))
    return {
        "row_pointers": _meta((n_states + 1,), torch.int32),
        "edges": _meta((n_edges + 256, 2), torch.int32),
        "l1_mask_packed": _meta((V, V // 8), torch.uint8),
        "l1_states": _meta((V, V), torch.int32),
    }


SID_STEP = 2  # first sparse (VNTK) level — the representative step
BMAX = 32  # level-2 max branch factor bound for |C|=20M (DESIGN.md §6)


def _gr_serve_cell(arch_id, bundle, shape, mesh, constrained: bool) -> Cell:
    cfg = bundle.config
    sid_v = static_gr.SID_VOCAB
    B, M = shape.global_batch, shape.beam_size
    S_h = shape.history_len
    S_sid = shape.sid_length
    hd = cfg.resolved_head_dim()
    KV, L = cfg.n_kv_heads, cfg.n_layers
    dt = torch.bfloat16

    p_specs = transformer.param_specs(cfg)
    if cfg.serve_replicate_weights:
        # weights fit per-chip; batch shards over ALL axes => no TP psums
        p_psh = tree_map(lambda _: (), p_specs)
        dp = tuple(mesh.mesh_dim_names)
    else:
        p_psh = sh.lm_param_pspecs(p_specs, mesh, cfg.n_kv_heads)
        dp = _bspec(mesh, B, 1)[0]

    batched_beams = cfg.gr_batched_beams
    hist_k = _meta((L, B, S_h, KV, hd), dt)
    if batched_beams:
        beam_k = _meta((L, B, M, S_sid, KV, hd), dt)
        beam_psh = (None, dp, None, None, None, None)
    else:
        beam_k = _meta((L, B * M, S_sid, KV, hd), dt)
        beam_psh = (None, dp, None, None, None)
    hist_psh = (None, dp, None, None, None)
    tok = _meta((B * M, 1), torch.int32)
    tm_specs = _gr_trie_specs()
    tm_psh = tree_map(lambda _: (), tm_specs)
    scores = _meta((B, M), torch.float32)
    nodes = _meta((B, M), torch.int32)
    bm_psh = (dp, None)

    def serve_step(params, hk, hv, bk, bv, tokens, beam_scores, beam_nodes,
                   tm):
        logits, bk, bv = transformer.gr_decode_step(
            params, hk, hv, bk, bv, tokens, SID_STEP, cfg)
        logits = logits[:, 0, :sid_v].reshape(B, M, sid_v)
        lp = torch.log_softmax(logits.float(), dim=-1)
        if constrained:
            masked, nxt = vntk_reference_scatter(
                lp, beam_nodes, tm["row_pointers"], tm["edges"], BMAX, sid_v)
        else:
            masked, nxt = lp, None
        total = beam_scores[:, :, None] + masked
        top_scores, top_idx = top_m(total.reshape(B, M * sid_v), M)
        beam_idx = top_idx // sid_v
        token = (top_idx % sid_v).to(torch.int32)
        # nxt[b, beam_idx, token] is the flat (B, M*V) map at top_idx
        new_nodes = (nxt.reshape(B, M * sid_v).gather(1, top_idx)
                     if constrained else beam_nodes)
        # beam-permute the suffix caches
        if batched_beams:
            # batch-local: a gather over the beam axis only — never crosses
            # the dp-sharded batch axis
            idx = beam_idx[None, :, :, None, None, None].expand(
                (L, B, M) + tuple(bk.shape[3:]))
            bk = torch.gather(bk, 2, idx)
            bv = torch.gather(bv, 2, idx)
        else:
            flat = (torch.arange(B, device=beam_idx.device)[:, None] * M
                    + beam_idx).reshape(-1)
            bk = bk.index_select(1, flat)
            bv = bv.index_select(1, flat)
        return token, top_scores, new_nodes, bk, bv

    attn = 2 * 2 * B * M * (S_h + S_sid) * cfg.n_heads * hd
    mf = (2 * cfg.active_param_count() * B * M + attn) / mesh.size()
    return Cell(
        arch_id, shape.name,
        "serve_constrained" if constrained else "serve_unconstrained",
        serve_step,
        (p_specs, hist_k, hist_k, beam_k, beam_k, tok, scores, nodes, tm_specs),
        (p_psh, hist_psh, hist_psh, beam_psh, beam_psh, bm_psh, bm_psh, bm_psh,
         tm_psh),
        (bm_psh, bm_psh, bm_psh, beam_psh, beam_psh),
        mf,
        notes="prefix-shared beam KV; VNTK at SID level 2 (bmax=32)",
    )


def _gr_train_cell(arch_id, bundle, shape, mesh) -> Cell:
    lm_shape = LMShape(shape.name, "train", shape.history_len, shape.global_batch)
    return _lm_train_cell(arch_id, bundle, lm_shape, mesh)


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------


def _gnn_batch_specs(cfg, shape: GraphShape, pad_multiple: int = 512):
    """Node/edge arrays padded to a mesh-divisible size; padding is masked
    out in the loss and routed to a sink node in the segment sum."""
    if shape.kind == "batched":
        B, N, E = shape.batch, shape.n_nodes, shape.n_edges
        return {
            "node_feats": _meta((B, N, shape.d_feat), torch.float32),
            "edge_feats": _meta((B, E, cfg.edge_feat_dim), torch.float32),
            "senders": _meta((B, E), torch.int32),
            "receivers": _meta((B, E), torch.int32),
            "targets": _meta((B, N, cfg.out_dim), torch.float32),
        }
    if shape.kind == "sampled":
        # fanout 15-10 from 1024 seeds: nodes = 1024*(1+15+150),
        # edges = 1024*(15+150) — already 512-divisible
        seeds = shape.batch_nodes
        n_pad = seeds * (1 + sum(_cumprod(shape.fanout)))
        e_pad = seeds * sum(_cumprod(shape.fanout))
    else:
        n_pad = _round_to(shape.n_nodes, pad_multiple)
        e_pad = _round_to(shape.n_edges, pad_multiple)
    return {
        "node_feats": _meta((n_pad, shape.d_feat), torch.float32),
        "edge_feats": _meta((e_pad, cfg.edge_feat_dim), torch.float32),
        "senders": _meta((e_pad,), torch.int32),
        "receivers": _meta((e_pad,), torch.int32),
        "targets": _meta((n_pad, cfg.out_dim), torch.float32),
        "node_mask": _meta((n_pad,), torch.bool),
    }


def _cumprod(xs):
    out, acc = [], 1
    for x in xs:
        acc *= x
        out.append(acc)
    return out


def _gnn_train_cell(arch_id, bundle, shape: GraphShape, mesh) -> Cell:
    cfg = dataclasses.replace(bundle.config, node_feat_dim=shape.d_feat)
    p_specs = gnn.param_specs(cfg)
    o_specs = _OPT.init(p_specs)
    p_psh = tree_map(lambda _: (), p_specs)
    o_psh = {"m": p_psh, "v": p_psh}
    batch = _gnn_batch_specs(cfg, shape)
    gaxes = sh.graph_axes(mesh)

    def bspec(leaf):
        if shape.kind == "batched":
            return _bspec(mesh, shape.batch, leaf.dim())
        lead = gaxes if leaf.shape[0] % mesh.size() == 0 else None
        return (lead,) + (None,) * (leaf.dim() - 1)

    b_psh = {k: bspec(v) for k, v in batch.items()}

    def train_step(params, opt_state, step_no, batch):
        return _train(lambda p: gnn.gnn_loss(p, batch, cfg),
                      params, opt_state, step_no)

    H, Lp = cfg.d_hidden, cfg.n_layers
    n_eff = shape.n_nodes * (shape.batch if shape.kind == "batched" else 1)
    e_eff = shape.n_edges * (shape.batch if shape.kind == "batched" else 1)
    if shape.kind == "sampled":
        n_eff = batch["node_feats"].shape[0]
        e_eff = batch["edge_feats"].shape[0]
    per_layer = 2 * e_eff * (3 * H * H + H * H) + 2 * n_eff * (2 * H * H + H * H)
    enc = 2 * n_eff * shape.d_feat * H + 2 * e_eff * cfg.edge_feat_dim * H
    mf = 3 * (Lp * per_layer + enc) / mesh.size()
    return Cell(
        arch_id, shape.name, "train", train_step,
        (p_specs, o_specs, _meta((), torch.int32), batch),
        (p_psh, o_psh, (), b_psh),
        (p_psh, o_psh, ()),
        mf,
        donate_argnums=(0, 1),
    )


# --------------------------------------------------------------------------
# Recsys cells
# --------------------------------------------------------------------------


def _recsys_batch_specs(cfg, batch: int):
    return {
        "dense": _meta((batch, max(cfg.n_dense, 1)), torch.float32),
        "sparse": _meta((batch, cfg.n_sparse, cfg.multi_hot), torch.int32),
        "hist": _meta((batch, cfg.hist_len), torch.int32),
        "target": _meta((batch,), torch.int32),
        "label": _meta((batch,), torch.float32),
    }


def _recsys_cell(arch_id, bundle, shape: RecsysShape, mesh) -> Cell:
    cfg = bundle.config
    p_specs = recsys.param_specs(cfg)
    p_psh = sh.recsys_param_pspecs(p_specs, mesh)

    def mlp_flops(dims, d_in):
        f, prev = 0, d_in
        for d in dims:
            f += 2 * prev * d
            prev = d
        return f

    if cfg.model == "dlrm":
        per_row = (
            mlp_flops(cfg.bot_mlp, cfg.n_dense)
            + mlp_flops(cfg.top_mlp, (cfg.n_sparse + 1) * cfg.n_sparse // 2
                        + cfg.embed_dim)
            + 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
        )
    elif cfg.model == "wide_deep":
        per_row = mlp_flops(cfg.mlp + (1,), cfg.n_sparse * cfg.embed_dim)
    elif cfg.model == "fm":
        per_row = 4 * cfg.n_sparse * cfg.embed_dim
    else:  # mind
        per_row = (
            2 * cfg.hist_len * cfg.embed_dim ** 2
            + cfg.capsule_iters * 4 * cfg.n_interests * cfg.hist_len * cfg.embed_dim
        )

    def batch_psh(batch, n):
        return {k: _bspec(mesh, n, v.dim()) for k, v in batch.items()}

    if shape.kind == "train":
        o_specs = _OPT.init(p_specs)
        o_psh = {"m": p_psh, "v": p_psh}
        batch = _recsys_batch_specs(cfg, shape.batch)

        def train_step(params, opt_state, step_no, batch):
            return _train(
                lambda p: recsys.recsys_loss(p, batch, cfg, impl="plain"),
                params, opt_state, step_no)

        mf = 3 * shape.batch * per_row / mesh.size()
        return Cell(
            arch_id, shape.name, "train", train_step,
            (p_specs, o_specs, _meta((), torch.int32), batch),
            (p_psh, o_psh, (), batch_psh(batch, shape.batch)),
            (p_psh, o_psh, ()),
            mf,
            donate_argnums=(0, 1),
        )

    if shape.kind == "retrieval":
        if cfg.model == "mind":
            hist = _meta((max(shape.batch, 1), cfg.hist_len), torch.int32)
            cand = _meta((shape.n_candidates,), torch.int32)

            def retrieve(params, hist, cand_ids):
                return recsys.mind_retrieval_scores(params, hist, cand_ids, cfg)

            mf = (shape.n_candidates * 2 * cfg.n_interests * cfg.embed_dim
                  + shape.batch * per_row) / mesh.size()
            model = sh.model_size(mesh)
            cand_psh = ("model" if shape.n_candidates % model == 0 else None,)
            return Cell(
                arch_id, shape.name, "retrieval", retrieve,
                (p_specs, hist, cand),
                (p_psh, (), cand_psh),
                (None, "model"),
                mf,
                notes="single batched max-over-interest dot vs 1M candidates",
            )
        # non-two-tower models: bulk-score candidates as a serve batch
        batch = _recsys_batch_specs(cfg, shape.n_candidates)

        def serve(params, batch):
            return recsys.forward(params, batch, cfg, impl="plain")

        mf = shape.n_candidates * per_row / mesh.size()
        return Cell(
            arch_id, shape.name, "retrieval", serve,
            (p_specs, batch), (p_psh, batch_psh(batch, shape.n_candidates)),
            _bspec(mesh, shape.n_candidates, 1),
            mf,
            notes="scored as bulk batch (model is not two-tower factorizable)",
        )

    # serve_p99 / serve_bulk
    batch = _recsys_batch_specs(cfg, shape.batch)

    def serve(params, batch):
        return recsys.forward(params, batch, cfg, impl="plain")

    mf = shape.batch * per_row / mesh.size()
    return Cell(
        arch_id, shape.name, "serve", serve,
        (p_specs, batch), (p_psh, batch_psh(batch, shape.batch)),
        _bspec(mesh, shape.batch, 1),
        mf,
    )


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh,
               cfg_overrides: dict | None = None, bundle=None) -> Cell:
    """The cell of ``arch_id`` x ``shape_name`` on ``mesh``.

    ``cfg_overrides`` replaces config fields (``moe_dispatch_groups`` sets
    the MoE config's ``dispatch_groups``); ``bundle`` takes the place of
    the registry's (tests build cells of small configs and shapes)."""
    bundle = bundle or get_bundle(arch_id)
    if cfg_overrides:
        cfg_overrides = dict(cfg_overrides)
        moe_groups = cfg_overrides.pop("moe_dispatch_groups", None)
        cfg = dataclasses.replace(bundle.config, **cfg_overrides)
        if moe_groups is not None and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=moe_groups)
            )
        bundle = dataclasses.replace(bundle, config=cfg)
    shape = next(s for s in bundle.shapes if s.name == shape_name)
    ok, why = supports_shape(arch_id, shape_name)
    if not ok:
        raise ValueError(f"{arch_id} x {shape_name} skipped: {why}")
    if bundle.family == "lm":
        if shape.kind == "train":
            return _lm_train_cell(arch_id, bundle, shape, mesh)
        if shape.kind == "prefill":
            return _lm_prefill_cell(arch_id, bundle, shape, mesh)
        return _lm_decode_cell(arch_id, bundle, shape, mesh)
    if bundle.family == "gr":
        if shape.kind == "train":
            return _gr_train_cell(arch_id, bundle, shape, mesh)
        return _gr_serve_cell(
            arch_id, bundle, shape, mesh,
            constrained=shape.kind == "serve_constrained",
        )
    if bundle.family == "gnn":
        return _gnn_train_cell(arch_id, bundle, shape, mesh)
    if bundle.family == "recsys":
        return _recsys_cell(arch_id, bundle, shape, mesh)
    raise ValueError(bundle.family)


def input_specs(arch_id: str, shape_name: str, mesh) -> tuple:
    """Meta-tensor stand-ins for every input of the cell's step fn."""
    return build_cell(arch_id, shape_name, mesh).args


def list_cells(include_gr: bool = True):
    """All runnable (arch, shape) pairs + documented skips."""
    from repro_torch.configs import ARCHS

    runnable, skipped = [], []
    for arch_id, bundle in ARCHS.items():
        if bundle.family == "gr" and not include_gr:
            continue
        for shape in bundle.shapes:
            ok, why = supports_shape(arch_id, shape.name)
            (runnable if ok else skipped).append((arch_id, shape.name, why))
    return runnable, skipped
