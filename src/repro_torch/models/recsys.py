"""RecSys model zoo: Wide&Deep, MIND, DLRM (MLPerf), FM
(``repro.models.recsys``).

Shared substrate: large per-feature embedding tables with a zero sentinel
row (row ``rows``, and the pad rows after it) and fixed-arity EmbeddingBag
lookups.  The bag lookups of one kind — all ``table_i`` bags, or all
``wide_i`` bags (wide-deep's wide part, FM's first-order term) — go through
one :func:`repro_torch.kernels.ops.embedding_bag_grouped` call over the
``(B, F, K)`` batch, which launches the CUDA EmbeddingBag kernel once per 64
tables on the card (2 launches per wide-deep or FM forward, 1 per DLRM
forward) and its plain version on the CPU; its ``(B, F, D)`` output is what
the deep MLP reads, with no stack.  Ids are clamped into each table, as
the reference's ``jnp.take(..., mode="clip")`` does.  MIND's history,
target and candidate gathers stay plain indexing, as the reference's
``jnp.take`` there.

Batch layout (all models), tensors on the parameters' device:
  dense  : (B, n_dense) float32                    [dlrm only]
  sparse : (B, n_sparse, K) int32   multi-hot ids  [K = cfg.multi_hot]
  hist   : (B, hist_len) int32                     [mind only]
  target : (B,) int32 candidate item               [mind only]
  label  : (B,) float32 click label                [recsys_loss]

:func:`recsys_loss` trains through the same lookups: on the card the bag
kernel's launches sit under ``torch.autograd.Function``s whose backward
scatter-adds into the tables' rows (``kernels/embedding_bag.py``).
:func:`param_specs` is :func:`init_params` on ``meta`` (the dry run's
stand-ins).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.dlrm_mlperf import DLRM_CRITEO_VOCABS
from repro_torch.kernels import ops
from repro_torch.models.layers import _generator, _he, mlp, mlp_init

__all__ = ["init_params", "param_specs", "forward", "recsys_loss",
           "mind_interests", "mind_retrieval_scores", "DLRM_CRITEO_VOCABS",
           "padded_rows"]


def _dtype(cfg: RecsysConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_rows(rows: int) -> int:
    """Rows of a table of ``rows`` ids: the sentinel added, padded to a
    multiple of 128 (the reference's vocab-sharding padding)."""
    return -(-(rows + 1) // 128) * 128


def _table_init(gen, rows, dim, dtype, device):
    """Normal / sqrt(dim) rows; row ``rows`` (the zero sentinel) and the pad
    rows after it are zero."""
    t = torch.randn(padded_rows(rows), dim, generator=gen, device=device,
                    dtype=torch.float32)
    t.mul_(1.0 / dim ** 0.5)
    t[rows:] = 0.0
    return t.to(dtype)


def _take_clip(table, ids):
    """``jnp.take(table, ids, axis=0, mode="clip")``."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[1])


def _sparse_embeds(params, sparse, n_feats, impl):
    """-> (B, n_feats, D) bag outputs of the ``table_i``, one grouped call."""
    return ops.embedding_bag_grouped(
        [params[f"table_{i}"] for i in range(n_feats)], sparse, impl=impl)


def _wide_sum(params, sparse, n_feats, impl):
    """Sum over features of the (B,) first-order ``wide_i`` bags: one
    grouped call -> (B, n_feats, 1), then ``0 + w_0 + w_1 + ...`` in the
    reference's order."""
    wide = ops.embedding_bag_grouped(
        [params[f"wide_{i}"] for i in range(n_feats)], sparse, impl=impl)
    return sum(wide[:, i, 0] for i in range(n_feats))


# --------------------------------------------------------------------------
# Wide & Deep (arXiv:1606.07792)
# --------------------------------------------------------------------------


def _wide_deep_init(cfg, gen, dev):
    dt = _dtype(cfg)
    p = {}
    for i, rows in enumerate(cfg.vocab_sizes):
        p[f"table_{i}"] = _table_init(gen, rows, cfg.embed_dim, dt, dev)
        p[f"wide_{i}"] = _table_init(gen, rows, 1, dt, dev)
    p["deep"] = mlp_init(
        gen, (cfg.n_sparse * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), dt,
        device=dev)
    return p


def _wide_deep_fwd(params, batch, cfg, impl):
    sparse = batch["sparse"]
    B = sparse.shape[0]
    emb = _sparse_embeds(params, sparse, cfg.n_sparse, impl)  # (B, F, D)
    deep = mlp(params["deep"], emb.reshape(B, -1))[:, 0]
    wide = _wide_sum(params, sparse, cfg.n_sparse, impl)
    return (deep + wide).float()


# --------------------------------------------------------------------------
# DLRM (arXiv:1906.00091, MLPerf config)
# --------------------------------------------------------------------------


def _dlrm_init(cfg, gen, dev):
    dt = _dtype(cfg)
    p = {f"table_{i}": _table_init(gen, rows, cfg.embed_dim, dt, dev)
         for i, rows in enumerate(cfg.vocab_sizes)}
    p["bot"] = mlp_init(gen, (cfg.n_dense,) + tuple(cfg.bot_mlp), dt,
                        device=dev)
    n_vec = cfg.n_sparse + 1
    n_int = n_vec * (n_vec - 1) // 2
    p["top"] = mlp_init(gen, (n_int + cfg.embed_dim,) + tuple(cfg.top_mlp),
                        dt, device=dev)
    return p


def _dlrm_fwd(params, batch, cfg, impl):
    dense, sparse = batch["dense"], batch["sparse"]
    bot = mlp(params["bot"], dense.to(_dtype(cfg)))  # (B, D)
    emb = _sparse_embeds(params, sparse, cfg.n_sparse, impl)  # (B, F, D)
    vecs = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F+1, D)
    inter = torch.bmm(vecs, vecs.transpose(1, 2))  # (B, F+1, F+1)
    n_vec = cfg.n_sparse + 1
    iu, ju = torch.triu_indices(n_vec, n_vec, offset=1, device=vecs.device)
    flat = inter[:, iu, ju]  # (B, n_int), row-major like jnp.triu_indices
    top_in = torch.cat([flat, bot], dim=-1)
    return mlp(params["top"], top_in)[:, 0].float()


# --------------------------------------------------------------------------
# FM (Rendle, ICDM'10) — O(nk) sum-square trick
# --------------------------------------------------------------------------


def _fm_init(cfg, gen, dev):
    dt = _dtype(cfg)
    p = {"bias": torch.zeros((), dtype=torch.float32, device=dev)}
    for i, rows in enumerate(cfg.vocab_sizes):
        p[f"table_{i}"] = _table_init(gen, rows, cfg.embed_dim, dt, dev)
        p[f"wide_{i}"] = _table_init(gen, rows, 1, dt, dev)
    return p


def _fm_fwd(params, batch, cfg, impl):
    sparse = batch["sparse"]
    emb = _sparse_embeds(params, sparse, cfg.n_sparse, impl).float()
    first = _wide_sum(params, sparse, cfg.n_sparse, impl).float()
    s = emb.sum(dim=1)  # (B, D)
    second = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=-1)
    return params["bias"] + first + second


# --------------------------------------------------------------------------
# MIND (arXiv:1904.08030) — multi-interest capsule routing
# --------------------------------------------------------------------------


def _mind_init(cfg, gen, dev):
    dt = _dtype(cfg)
    table = _table_init(gen, cfg.vocab_sizes[0], cfg.embed_dim, dt, dev)
    bilinear = _he(gen, (cfg.embed_dim, cfg.embed_dim), dt, dev)
    routing = torch.randn(cfg.n_interests, cfg.hist_len, generator=gen,
                          device=dev, dtype=torch.float32) * 0.1
    return {"table_0": table, "bilinear": bilinear, "routing_init": routing}


def _squash(x, dim=-1):
    n2 = (x * x).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(params, hist: torch.Tensor, cfg: RecsysConfig):
    """(B, T) item ids -> (B, n_interests, D) interest capsules."""
    table = params["table_0"]
    pad = table.shape[0] - 1  # the last pad row, as the reference has it
    e = _take_clip(table, hist).float()  # (B, T, D)
    valid = (hist != pad)[:, :, None].float()
    u = (e @ params["bilinear"].float()) * valid  # (B, T, D)
    b = params["routing_init"][None].expand(hist.shape[0], -1, -1)  # (B, K, T)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1)  # over interests
        caps = _squash(torch.einsum("bkt,btd->bkd", w, u))  # (B, K, D)
        b = b + torch.einsum("bkd,btd->bkt", caps, u)
    return caps


def _mind_fwd(params, batch, cfg, impl):
    caps = mind_interests(params, batch["hist"], cfg)  # (B, K, D)
    tgt = _take_clip(params["table_0"], batch["target"]).float()
    scores = torch.einsum("bkd,bd->bk", caps, tgt)
    return scores.max(dim=-1).values  # label-aware hard attention


def mind_retrieval_scores(params, hist, cand_ids, cfg: RecsysConfig):
    """(B, T) history x (N,) candidates -> (B, N) max-over-interest scores."""
    caps = mind_interests(params, hist, cfg)  # (B, K, D)
    cand = _take_clip(params["table_0"], cand_ids).float()
    scores = torch.einsum("bkd,nd->bkn", caps, cand)
    return scores.max(dim=1).values


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

_INIT = {"wide_deep": _wide_deep_init, "dlrm": _dlrm_init, "fm": _fm_init,
         "mind": _mind_init}
_FWD = {"wide_deep": _wide_deep_fwd, "dlrm": _dlrm_fwd, "fm": _fm_fwd,
        "mind": _mind_fwd}


def init_params(cfg: RecsysConfig, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless the caller names one).  Same layout and distributions as
    the reference; the numbers differ from ``jax.random``'s (use
    :func:`repro_torch.convert.recsys_params_from_jax` for the reference's
    weights).  ``device="meta"`` gives :func:`param_specs`."""
    dev = resolve_device(device)
    return _INIT[cfg.model](cfg, _generator(dev, seed), dev)


def param_specs(cfg: RecsysConfig):
    """:func:`init_params`' tree as ``meta`` tensors (no allocation)."""
    return init_params(cfg, device="meta")


def forward(params, batch, cfg: RecsysConfig, impl=None) -> torch.Tensor:
    """(B,) float32 scores.  ``impl`` goes to every bag lookup
    (:func:`repro_torch.kernels.ops.embedding_bag_grouped`): ``None``
    launches the kernel on the card, ``"plain"`` takes the plain version."""
    return _FWD[cfg.model](params, batch, cfg, impl)


def recsys_loss(params, batch, cfg: RecsysConfig, impl=None) -> torch.Tensor:
    """Mean binary cross-entropy of the (B,) scores against
    ``batch["label"]``, the reference's stable BCE-with-logits form."""
    logits = forward(params, batch, cfg, impl)
    y = batch["label"].float()
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-torch.abs(logits))))
