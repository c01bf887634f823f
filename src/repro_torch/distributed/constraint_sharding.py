"""SPMD constrained retrieval over a process mesh (DESIGN.md §6;
``repro.distributed.constraint_sharding``).

The reference runs the hot path inside ``shard_map``; the port runs one
process per rank (:mod:`repro_torch.launch.mesh`):

  * **Batch parallelism** — :func:`spmd_beam_search` hands every rank the
    same global batch; each decodes its own block of rows along the mesh's
    data axes (``dp_axes``) with the ordinary
    :func:`~repro_torch.core.beam_search.beam_search`, and one all-gather
    over those axes returns the global ``(B, M, L)`` / ``(B, M)`` arrays to
    every rank.  Rows are independent in Algorithm 1, so the result is
    bit-identical to single-device decoding of the same rows.

  * **Constraint placement** — each backend's ``shardings(mesh, rows=...)``
    is a spec tree with the backend's own structure.  Default is paper
    §A.3: every table replicated, the constraint step collective-free (and
    on the card, the CUDA kernels of every rank).  ``rows="model"``
    row-shards the CSR ``edges`` slab (and the compressed ``tok_delta``)
    along ``model``: :func:`shard_policy` keeps on each rank only its block
    of ``E_pad / ms`` rows, and the sparse steps resolve cross-shard rows
    with ONE all-reduce over ``model`` — of the ``(nb, bmax, 2)`` burst
    (:func:`vntk_row_sharded`), the ``(nb, bmax)`` delta burst (the
    compressed twins), or the ``(nb, ms, C)`` per-shard winner lists of the
    candidate-compressed step (:func:`vntk_row_sharded_topk`).  The
    reference has no Pallas form of these steps and the port no kernel:
    they are plain torch, as the reference's are plain XLA, so a
    row-sharded policy must ask for ``impl="plain"``.

  * **Hot-swap invariance** — spec trees and the shard envelope are
    functions of the policy's static fields and shapes only, so a registry
    hot swap keeps every shape, and the retriever's specialization key.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.beam_search import beam_search
from repro_torch.core.vntk import (
    NEG_INF,
    _project_scatter,
    _rows,
    _topk_from_candidates,
    top_m,
)
from repro_torch.decoding.backends import StackedStaticBackend, StaticBackend
from repro_torch.decoding.policy import as_policy
from repro_torch.distributed.collectives import all_gather_cat, all_reduce_sum
from repro_torch.distributed.sharding import (
    axis_size,
    dp_axes,
    dp_rank,
    dp_size,
)
from repro_torch.serving.generative_retrieval import _signature

__all__ = [
    "dp_size",
    "ModelShard",
    "policy_pspecs",
    "shard_policy",
    "pad_rows",
    "pad_slab",
    "pad_policy_rows",
    "vntk_row_sharded",
    "vntk_row_sharded_topk",
    "vntk_row_sharded_compressed",
    "vntk_row_sharded_compressed_topk",
    "RowShardedStatic",
    "to_row_sharded",
    "gather_dp",
    "spmd_beam_search",
]


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the mesh's ``model`` axis: its block ``index``
    of ``size``, and the process group the sharded step reduces over
    (``jax.lax.axis_index`` / ``psum`` of the reference)."""

    index: int = 0
    size: int = 1
    group: object = None

    @classmethod
    def of(cls, mesh) -> "ModelShard":
        return cls(mesh.get_local_rank("model"), axis_size(mesh, "model"),
                   mesh.get_group("model"))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else all_reduce_sum(t, self.group)


def policy_pspecs(policy, mesh, *, rows: str = "replicated"):
    """Spec tree of a DecodePolicy (its ``shardings`` composed)."""
    return policy.shardings(mesh, rows=rows)


def _map_specs(obj, spec, fn, memo):
    """Rebuild ``obj`` with ``fn(tensor, spec)`` on every tensor leaf,
    through nested dataclasses; objects met twice (the dense and sparse
    backends share one matrix) are rebuilt once."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, spec)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            new = tuple(_map_specs(x, s, fn, memo)
                        for x, s in zip(v, getattr(spec, f.name)))
        elif isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            new = _map_specs(v, getattr(spec, f.name), fn, memo)
        else:
            continue
        if new is not v:
            changes[f.name] = new
    out = dataclasses.replace(obj, **changes) if changes else obj
    memo[id(obj)] = out
    return out


def shard_policy(policy, mesh, *, rows: str = "replicated"):
    """The rank's copy of ``policy``: every tensor a spec shards over
    ``model`` is cut to this rank's block (a copy of ``1/ms`` of the rows,
    so the full slab can be freed); the rest is kept as it is.

    With ``rows="model"`` the CSR edge slab must divide the model axis:
    apply :func:`pad_policy_rows` first (the SPMD serving stack does).
    """
    shard = ModelShard.of(mesh)

    def cut(t, spec):
        if "model" not in spec or shard.size == 1:
            return t
        dim = spec.index("model")
        if t.shape[dim] % shard.size:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not divide the "
                f"{shard.size}-way model axis; pad_policy_rows first")
        n = t.shape[dim] // shard.size
        return t.narrow(dim, shard.index * n, n).clone()

    return _map_specs(policy, policy_pspecs(policy, mesh, rows=rows), cut,
                      {})


# ---------------------------------------------------------------------------
# Row-sharded CSR: padding + one-hop gather lookup
# ---------------------------------------------------------------------------
def _pad_axis(t: torch.Tensor, dim: int, n_shards: int) -> torch.Tensor:
    e = t.shape[dim]
    e_pad = -(-e // n_shards) * n_shards
    if e_pad == e:
        return t
    shape = list(t.shape)
    shape[dim] = e_pad - e
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def pad_rows(obj, n_shards: int):
    """Pad the CSR ``edges`` row count to a multiple of ``n_shards``.

    Works on a TransitionMatrix (rows on axis 0) or a ConstraintStore (rows
    on axis 1).  Pad rows are zeros, outside every CSR row's ``[start,
    start + n_child)`` window, so the ``slot < n_child`` test of Alg. 2
    never reads them as edges.  Static fields (``n_edges`` = real edge
    count) are untouched; only the tensor grows, deterministically, so
    padding again (every hot swap) lands on the same shapes.
    """
    if n_shards <= 1:
        return obj
    edges = _pad_axis(obj.edges, -2, n_shards)
    return obj if edges is obj.edges else dataclasses.replace(obj,
                                                              edges=edges)


def pad_slab(slab, n_shards: int):
    """Pad a compressed slab's ``tok_delta`` edge axis like
    :func:`pad_rows`.  Zero pad deltas sit past every CSR row's window, so
    they decode to the same masked garbage as the uncompressed path's
    speculative over-read."""
    if slab is None or n_shards <= 1:
        return slab
    tok = _pad_axis(slab.tok_delta, -1, n_shards)
    return slab if tok is slab.tok_delta else dataclasses.replace(
        slab, tok_delta=tok)


def pad_policy_rows(policy, n_shards: int):
    """Apply :func:`pad_rows` to every CSR-carrying backend in a policy,
    and :func:`pad_slab` to its compressed slab in lock-step (both are
    row-sharded under ``rows="model"``).  A matrix shared by the dense and
    sparse backends is padded once."""
    memo = {}

    def once(fn, obj):
        if id(obj) not in memo:
            memo[id(obj)] = fn(obj, n_shards)
        return memo[id(obj)]

    def pad_backend(b):
        if isinstance(b, StaticBackend):
            return dataclasses.replace(b, tm=once(pad_rows, b.tm),
                                       slab=pad_slab(b.slab, n_shards))
        if isinstance(b, StackedStaticBackend):
            return dataclasses.replace(b, store=once(pad_rows, b.store),
                                       slab=pad_slab(b.slab, n_shards))
        return b

    return dataclasses.replace(
        policy, backends=tuple(pad_backend(b) for b in policy.backends))


def _sharded_row_window(nodes, row_pointers, bmax: int, constraint_ids):
    """Phase 1 of Alg. 2, replicated: per-row speculative burst window.

    Row pointers are replicated (``4(S+1)`` bytes against the slab's
    ``8E``), so every rank computes the same global edge indices and
    validity; only the slab gather is shard-local.  Returns ``(cid,
    offsets, idx, valid)``, ``idx`` the int64 global edge rows.
    """
    starts, lens, cid = _rows(nodes, row_pointers, constraint_ids)
    offsets = torch.arange(bmax, device=nodes.device)
    idx = starts[:, None] + offsets[None, :]
    valid = offsets[None, :] < lens[:, None]
    return cid, offsets, idx, valid


def _own_window(idx, rows_local: int, shard: ModelShard):
    """Ownership mask + clipped local indices for this shard's row block."""
    rel = idx - shard.index * rows_local
    own = (rel >= 0) & (rel < rows_local)
    return own, rel.clamp(0, rows_local - 1)


def _gather_local(table, cid, rel_c):
    return table[rel_c] if cid is None else table[cid[:, None], rel_c]


def vntk_row_sharded(log_probs, nodes, row_pointers, edges_local, bmax: int,
                     vocab_size: int, shard: ModelShard,
                     constraint_ids=None):
    """Alg. 2 with the CSR edge slab row-sharded along ``model``.

    ``edges_local`` is this rank's ``(E_pad/ms, 2)`` block (``(K, E_pad/ms,
    2)`` stacked).  Every rank computes the same global speculative
    indices, keeps the rows it owns, and one all-reduce over ``model``
    assembles the full ``(nb, bmax, 2)`` burst: the one-hop gather of
    cross-shard next states.  int32 sums are exact and exactly one rank
    owns each index, so the result is bit-identical to the replicated
    :func:`~repro_torch.core.vntk.vntk_reference_scatter`.
    """
    cid, _, idx, valid = _sharded_row_window(nodes, row_pointers, bmax,
                                             constraint_ids)
    own, rel_c = _own_window(idx, edges_local.shape[-2], shard)
    g = torch.where(own[..., None], _gather_local(edges_local, cid, rel_c), 0)
    g = shard.psum(g.to(torch.int32))  # one hop: the full burst everywhere
    nxt = torch.where(valid, g[..., 1], 0)
    return _project_scatter(log_probs, nodes, (g[..., 0].long(), nxt, valid),
                            vocab_size)


def vntk_row_sharded_topk(log_probs, nodes, row_pointers, edges_local,
                          bmax: int, vocab_size: int, width: int,
                          shard: ModelShard, constraint_ids=None):
    """Candidate-compressed Alg. 2 (§8) over the row-sharded edge slab.

    Shard-local top-C + one all-reduce: each rank scores only the CSR slots
    it owns (the rest pinned to the float minimum), selects its local
    dense-rank top-``width``, writes them into its slice of zero
    ``(nb, ms, width)`` merge buffers, and ONE all-reduce over ``model``
    assembles every shard's winners plus the additive missing-token counts
    on every rank.  The merged pool is re-ranked with the same stable
    selection the replicated oracle uses.  The float keys ride as their
    int32 bits: each entry has one writer and zeros elsewhere, so the sum is
    exact, bit for bit.

    Bit-identity with :func:`~repro_torch.core.vntk._topk_from_candidates`
    rests on two invariants:

      * any entry of the true global top-``width`` ranks at least as high
        within its own shard, so it survives the local cut;
      * the oracle breaks key ties by pool index — token-ascending over the
        real candidates, then the fills.  Each shard emits its winners in
        slot order (token-ascending), shards own contiguous slot ranges and
        the fills come last, so the merged pool keeps the oracle's tie
        order.

    Traffic is ``(nb, ms, width)`` x (key + token + next) int32 plus the
    ``(nb, width)`` counts, instead of the ``(nb, bmax, 2)`` burst.
    """
    V, ms = vocab_size, shard.size
    lp_flat = log_probs.reshape(-1, V)
    dev = lp_flat.device
    cid, offsets, idx, valid = _sharded_row_window(nodes, row_pointers, bmax,
                                                   constraint_ids)
    own, rel_c = _own_window(idx, edges_local.shape[-2], shard)
    own = own & valid
    g = _gather_local(edges_local, cid, rel_c)
    cols = g[..., 0].long()
    nb = cols.shape[0]
    minf = torch.finfo(torch.float32).min
    cand_lp = lp_flat.gather(1, cols.clamp(0, V - 1)).float()
    key_loc = torch.where(own, cand_lp, minf)
    tok_loc = torch.where(own, cols, 0).to(torch.int32)
    nxt_loc = torch.where(own, g[..., 1], 0).to(torch.int32)

    # local pool padded with `width` sentinels so the cut is always in
    # range (a shard may own fewer than `width` slots of a row's burst)
    pad_i = torch.zeros((nb, width), dtype=torch.int32, device=dev)
    pool_k = torch.cat(
        [key_loc, torch.full((nb, width), minf, device=dev)], dim=1)
    pool_t = torch.cat([tok_loc, pad_i], dim=1)
    pool_n = torch.cat([nxt_loc, pad_i], dim=1)
    _, win = top_m(pool_k, width)
    win = torch.sort(win, dim=-1).values  # back to slot (token) order
    loc = torch.stack([pool_k.gather(1, win).view(torch.int32),
                       pool_t.gather(1, win), pool_n.gather(1, win)], dim=1)

    # i-th missing token's count contribution from this shard's slots
    adj = torch.where(own, cols - offsets[None, :], V + bmax + 1)
    fill_i = torch.arange(width, device=dev)
    cnt_loc = (adj[:, None, :] <= fill_i[None, :, None]).sum(-1)

    # ONE all-reduce: this shard's slice of the zero merge buffers + counts
    buf = torch.zeros((nb, ms, 3, width), dtype=torch.int32, device=dev)
    buf[:, shard.index] = loc
    flat = shard.psum(torch.cat([buf.reshape(-1),
                                 cnt_loc.to(torch.int32).reshape(-1)]))
    buf = flat[: buf.numel()].reshape(nb, ms, 3, width)
    cnt = flat[buf.numel():].reshape(nb, width)

    # replicated finale: merged winners + the oracle's missing-token fills
    fill_tok = fill_i[None, :] + cnt
    in_range = fill_tok < V
    fill_key = torch.where(in_range, NEG_INF, minf)
    fill_tok = torch.where(in_range, fill_tok, 0).to(torch.int32)
    keys = torch.cat([buf[:, :, 0].reshape(nb, -1).view(torch.float32),
                      fill_key], dim=1)
    toks = torch.cat([buf[:, :, 1].reshape(nb, -1), fill_tok], dim=1)
    nxts = torch.cat([buf[:, :, 2].reshape(nb, -1), pad_i], dim=1)
    top_vals, top_idx = top_m(keys, width)
    shp = tuple(nodes.shape) + (width,)
    return (top_vals.to(lp_flat.dtype).reshape(shp),
            toks.gather(1, top_idx).reshape(shp),
            nxts.gather(1, top_idx).reshape(shp))


def _sharded_delta_decode(nodes, row_pointers, tok_delta_local, base,
                          bmax: int, shard: ModelShard, constraint_ids):
    """Assemble + decode a compressed burst whose slab is row-sharded.

    Each rank contributes the deltas it owns (zeros elsewhere) and one
    all-reduce assembles the full ``(nb, bmax)`` int32 burst, which then
    decompresses with the row-start anchored prefix sum (DESIGN.md §11),
    replicated.  Unowned indices contribute zero, as the replicated
    oracle's past-the-slab fill does; slots past a row's end differ only
    where ``valid`` is false, which every consumer masks.  Returns
    ``(cols, nxt, valid)`` as :func:`~repro_torch.core.vntk
    ._compressed_burst` does.
    """
    cid, _, idx, valid = _sharded_row_window(nodes, row_pointers, bmax,
                                             constraint_ids)
    own, rel_c = _own_window(idx, tok_delta_local.shape[-1], shard)
    d = _gather_local(tok_delta_local, cid, rel_c).to(torch.int32)
    deltas = shard.psum(torch.where(own, d, 0))
    cols = torch.cumsum(deltas, dim=1, dtype=torch.int64)
    base = torch.as_tensor(base, device=idx.device).long()
    if cid is not None:
        base = base[cid]
    elif base.dim():
        base = base.expand(nodes.shape).reshape(-1)
    base = base.reshape(-1, 1) if base.dim() else base
    nxt = torch.where(valid, idx + base, 0).to(torch.int32)
    return cols, nxt, valid


def vntk_row_sharded_compressed(log_probs, nodes, row_pointers,
                                tok_delta_local, base, bmax: int,
                                vocab_size: int, shard: ModelShard,
                                constraint_ids=None):
    """Alg. 2 over the row-sharded COMPRESSED slab (§11): the all-reduce
    carries the ``(nb, bmax)`` int32 delta burst, half the raw
    ``(nb, bmax, 2)`` one, and the result is bit-identical to
    :func:`~repro_torch.core.vntk.vntk_compressed_reference`."""
    burst = _sharded_delta_decode(nodes, row_pointers, tok_delta_local, base,
                                  bmax, shard, constraint_ids)
    return _project_scatter(log_probs, nodes, burst, vocab_size)


def vntk_row_sharded_compressed_topk(log_probs, nodes, row_pointers,
                                     tok_delta_local, base, bmax: int,
                                     vocab_size: int, width: int,
                                     shard: ModelShard, constraint_ids=None):
    """Candidate-compressed step over the row-sharded compressed slab.

    The burst must decompress before its candidates can be ranked (the
    prefix sum needs the whole row), so the all-reduce assembles the delta
    burst and the §8 selection runs replicated."""
    V = vocab_size
    sc, tok, nx = _topk_from_candidates(
        log_probs.reshape(-1, V),
        *_sharded_delta_decode(nodes, row_pointers, tok_delta_local, base,
                               bmax, shard, constraint_ids), width, V)
    shp = tuple(nodes.shape) + (width,)
    return sc.reshape(shp), tok.reshape(shp), nx.reshape(shp)


@dataclasses.dataclass(frozen=True)
class RowShardedStatic:
    """A rank's view of a Static/StackedStatic backend whose ``edges`` (and
    ``tok_delta``) hold only this rank's row block.

    Dense-band steps delegate to the inner backend (dense tables are
    replicated); sparse steps run the row-sharded VNTK.  Built by
    :func:`to_row_sharded` — never constructed by user code.
    """

    inner: object  # StaticBackend | StackedStaticBackend
    shard: ModelShard = ModelShard()

    supports_fused = False
    fused = False
    needs_prefix = False
    supports_level_free = False
    # Candidate compression composes with row sharding (DESIGN.md §8 x §6):
    # topk_step runs the shard-local top-C + one all-reduce merge.
    supports_topk = True

    @property
    def supports_stacked(self) -> bool:
        return self.inner.supports_stacked

    @property
    def sid_length(self) -> int:
        return self.inner.sid_length

    @property
    def device(self):
        return self.inner.device

    @property
    def levels(self):
        return self.inner.levels

    @property
    def num_sets(self):
        return getattr(self.inner, "num_sets", None)

    @property
    def _tables(self):
        return (self.inner.store if self.inner.supports_stacked
                else self.inner.tm)

    def shardings(self, mesh, *, rows: str = "replicated"):
        raise TypeError(
            "RowShardedStatic is a rank's view; take shardings from the "
            "inner backend before slicing it")

    def topk_at(self, step: int) -> bool:
        return self.inner.topk_at(step)

    def candidate_width(self, beams: int) -> int:
        return self.inner.candidate_width(beams)

    def _ids(self, constraint_ids):
        if not self.supports_stacked:
            return None
        if constraint_ids is None:
            raise ValueError(
                "ConstraintStore lookups need per-row constraint_ids")
        return constraint_ids

    def mask_step(self, log_probs, nodes, step, *, prefix_tokens=None,
                  constraint_ids=None):
        obj = self._tables
        cids = self._ids(constraint_ids)
        if step < obj.dense_d:
            # dense band: replicated bit-packed tables, untouched path
            return self.inner.mask_step(log_probs, nodes, step,
                                        constraint_ids=cids)
        bmax = max(obj.bmax_for_step(step), 1)
        slab = self.inner.slab
        if slab is not None:
            return vntk_row_sharded_compressed(
                log_probs, nodes, obj.row_pointers, slab.tok_delta,
                slab.base_for_step(step), bmax, obj.vocab_size, self.shard,
                constraint_ids=cids)
        return vntk_row_sharded(
            log_probs, nodes, obj.row_pointers, obj.edges, bmax,
            obj.vocab_size, self.shard, constraint_ids=cids)

    def topk_step(self, values, nodes, step, width, *, constraint_ids=None,
                  normalized=True):
        """Sharded candidate-compressed Phases 1-2 (DESIGN.md §8 x §6)."""
        if not normalized:
            # to_row_sharded rejects fused inners, so the policy hands over
            # log-probs; this guards direct callers
            values = torch.log_softmax(values.float(), dim=-1)
        obj = self._tables
        cids = self._ids(constraint_ids)
        if not self.topk_at(step):
            raise ValueError(
                f"no candidate row at dense step {step}; fix the policy plan")
        bmax = max(obj.bmax_for_step(step), 1)
        slab = self.inner.slab
        if slab is not None:
            return vntk_row_sharded_compressed_topk(
                values, nodes, obj.row_pointers, slab.tok_delta,
                slab.base_for_step(step), bmax, obj.vocab_size, width,
                self.shard, constraint_ids=cids)
        return vntk_row_sharded_topk(
            values, nodes, obj.row_pointers, obj.edges, bmax,
            obj.vocab_size, width, self.shard, constraint_ids=cids)


def to_row_sharded(policy, shard: ModelShard = ModelShard()):
    """Wrap a policy's sparse Static backends into this rank's row-sharded
    views (their tables already cut by :func:`shard_policy`).

    Dense-band backends never touch ``edges`` and are left alone.  The
    row-sharded step exists in plain torch only: a backend that asks for
    the CUDA kernels (``impl=None``) or the fused step is rejected, never
    quietly served by plain code.
    """
    def wrap(b):
        if (isinstance(b, (StaticBackend, StackedStaticBackend))
                and b.levels != "dense"):
            if b.impl != "plain" or b.fused:
                raise ValueError(
                    "rows='model' runs the plain unfused VNTK only; rebuild "
                    "the policy with impl='plain', fused=False")
            return RowShardedStatic(inner=b, shard=shard)
        return b

    return dataclasses.replace(
        policy, backends=tuple(wrap(b) for b in policy.backends))


# ---------------------------------------------------------------------------
# SPMD beam search: batch axis over the mesh's data axes
# ---------------------------------------------------------------------------
def gather_dp(mesh, tokens: torch.Tensor, scores: torch.Tensor):
    """All-gather ``(b, M, L)`` int32 tokens and ``(b, M)`` float32 scores
    over the dp axes into the global ``(B, M, L)`` / ``(B, M)``, dp-rank
    order (``pod`` major).  One all-gather per dp axis of the scores' bits
    riding beside the tokens."""
    b, M, L = tokens.shape
    packed = torch.cat([tokens, scores.float().view(torch.int32)[..., None]],
                       dim=-1)
    for a in reversed(dp_axes(mesh)):  # minor axis first
        packed = all_gather_cat(packed, mesh.get_group(a))
    return (packed[..., :L].contiguous(),
            packed[..., L].contiguous().view(torch.float32))


_SPMD_SEARCH_CACHE: dict = {}


def _rank_policy(policy, mesh, rows: str):
    """The rank's padded, cut and wrapped copy of ``policy``."""
    if rows != "model":
        return policy
    shard = ModelShard.of(mesh)
    to_row_sharded(policy, shard)  # reject impl/fused before any copy
    padded = pad_policy_rows(policy, shard.size)
    return to_row_sharded(shard_policy(padded, mesh, rows="model"), shard)


def spmd_beam_search(mesh, logits_fn, batch_size: int, beam_size: int,
                     length: int, policy, *, constraint_ids=None,
                     rows: str = "replicated"):
    """Data-parallel :func:`~repro_torch.core.beam_search.beam_search` over
    ``mesh``.

    Every rank passes the same global arguments and decodes its own block
    of ``batch_size / dp_size`` rows; with ``rows="model"`` the sparse
    steps run the row-sharded VNTK.  ``logits_fn(carry, last, step)`` must
    be shard-oblivious: a function of its arguments and replicated closures
    only.  ``batch_size`` must divide by :func:`dp_size` (callers pad with
    inactive rows, DESIGN.md §6).  Returns ``(tokens (B, M, L), scores (B,
    M))``, global on every rank, bit-identical to the single-device search.

    The rank's copy of the policy is cached, keyed like the reference's
    compiled search (mesh, logits function, local batch, beams, length,
    rows, ids given, the policy's signature), and reused while the same
    policy object is passed, so a loop does not re-cut the slab.
    """
    policy = as_policy(policy)
    n = dp_size(mesh)
    if batch_size % n:
        raise ValueError(
            f"batch_size {batch_size} must divide the {n}-way data "
            f"parallelism (axes {dp_axes(mesh)}); pad with inactive rows")
    local_b = batch_size // n
    have_ids = constraint_ids is not None
    key = (mesh, logits_fn, local_b, beam_size, length, rows, have_ids,
           _signature(policy))
    hit = _SPMD_SEARCH_CACHE.get(key)
    if hit is None or hit[0] is not policy:
        hit = (policy, _rank_policy(policy, mesh, rows))
        _SPMD_SEARCH_CACHE[key] = hit
    local = hit[1]
    r = dp_rank(mesh)
    cids = None
    if have_ids:
        cids = torch.as_tensor(constraint_ids, dtype=torch.int32)
        cids = cids[r * local_b:(r + 1) * local_b]
    state, _ = beam_search(logits_fn, None, local_b, beam_size, length, local,
                           constraint_ids=cids)
    return gather_dp(mesh, state.tokens, state.scores)
