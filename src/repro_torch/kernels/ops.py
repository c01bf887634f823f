"""Dispatch of the VNTK step, the embedding bag and decode attention to the
CUDA kernels or their plain versions.

``impl``:
  * ``None``    — by the tensor's device: a CUDA tensor launches the kernel
                  (which raises if it cannot), a CPU tensor takes the plain
                  version.  Any other device raises.
  * ``"plain"`` — the plain PyTorch version on any device (used to hold the
                  kernels against it on the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _attn
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import vntk as _k

__all__ = ["vntk", "vntk_fused_logsoftmax", "vntk_topk", "vntk_compressed",
           "vntk_compressed_topk", "embedding_bag", "embedding_bag_grouped",
           "decode_attention"]

IMPLS = (None, "plain")


def _check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _use_kernel(t, impl) -> bool:
    _check_impl(impl)
    if impl == "plain" or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel implementation for device {t.device}")


def _call(name: str, values, nodes, tables, bmax: int, vocab: int, width,
          fused: bool, impl, constraint_ids):
    """Run ``vntk[_stacked]_<name>`` (the kernel or its plain version) on
    the flattened rows; outputs come back shaped like ``nodes`` plus
    ``(vocab,)`` (mask) or ``(width,)`` (topk)."""
    batch_shape = tuple(nodes.shape)
    head = [values.reshape(-1, vocab), nodes.reshape(-1)]
    stacked = constraint_ids is not None
    if stacked:  # per-row ids broadcast over the rows like ``nodes``
        head.append(constraint_ids.expand(batch_shape).reshape(-1))
    kind = "cuda" if _use_kernel(values, impl) else "plain"
    fn = getattr(_k, f"vntk{'_stacked' if stacked else ''}_{name}_{kind}")
    out = fn(*head, *tables, bmax, vocab,
             *(() if width is None else (width,)), fused)
    last = vocab if width is None else width
    return tuple(o.reshape(batch_shape + (last,)) for o in out)


def vntk(log_probs, nodes, row_pointers, edges, bmax: int, vocab: int,
         impl=None, constraint_ids=None):
    """Alg. 2 (VNTK): ``(masked_log_probs, next_states)``, vocab-aligned.

    With ``constraint_ids`` (per-row int32), ``row_pointers``/``edges`` carry
    a leading constraint axis — (K, S+1) / (K, E, 2) — and each row is masked
    by its own set (DESIGN.md §4).  ``None`` keeps the single-matrix path.
    """
    return _call("mask", log_probs, nodes, (row_pointers, edges), bmax, vocab,
                 None, False, impl, constraint_ids)


def vntk_fused_logsoftmax(logits, nodes, row_pointers, edges, bmax: int,
                          vocab: int, impl=None, constraint_ids=None):
    """Fused LogSoftmax + VNTK masking (one pass over the logits)."""
    return _call("mask", logits, nodes, (row_pointers, edges), bmax, vocab,
                 None, True, impl, constraint_ids)


def vntk_topk(values, nodes, row_pointers, edges, bmax: int, vocab: int,
              width: int, fused_logsoftmax: bool = False, impl=None,
              constraint_ids=None):
    """Candidate-compressed VNTK (DESIGN.md §8): per-beam dense-rank top-C.

    Returns ``(scores, tokens, next_states)``, each ``(..., width)``;
    ``values`` are log-probs, or raw logits with ``fused_logsoftmax``.  With
    ``constraint_ids`` the tables carry the stacked leading constraint axis.
    """
    return _call("topk", values, nodes, (row_pointers, edges), bmax, vocab,
                 width, fused_logsoftmax, impl, constraint_ids)


def vntk_compressed(values, nodes, row_pointers, tok_delta, base, bmax: int,
                    vocab: int, impl=None, constraint_ids=None,
                    fused_logsoftmax: bool = False):
    """VNTK over a compressed slab (DESIGN.md §11): vocab-aligned outputs.

    ``tok_delta``/``base`` come from a
    :class:`~repro_torch.core.compressed_slab.CompressedSlab`: ``base`` is
    the step's ``level_base`` entry, a scalar, or per member ``(K,)`` with
    ``constraint_ids``.  Equal to :func:`vntk` /
    :func:`vntk_fused_logsoftmax` on the same trie.
    """
    return _call("compressed_mask", values, nodes,
                 (row_pointers, tok_delta, base), bmax, vocab, None,
                 fused_logsoftmax, impl, constraint_ids)


def vntk_compressed_topk(values, nodes, row_pointers, tok_delta, base,
                         bmax: int, vocab: int, width: int, impl=None,
                         constraint_ids=None, fused_logsoftmax: bool = False):
    """Candidate-compressed VNTK over a compressed slab (§8 x §11): per-beam
    dense-rank top-``width`` ``(scores, tokens, next_states)``."""
    return _call("compressed_topk", values, nodes,
                 (row_pointers, tok_delta, base), bmax, vocab, width,
                 fused_logsoftmax, impl, constraint_ids)


def embedding_bag(table, indices, mode: str = "sum", impl=None):
    """Fixed-arity EmbeddingBag: (B, K) int32 ids into a (R+1, D) table ->
    (B, D) sums or means over K, accumulated in float32 (ids clamped into
    ``[0, R]``; row R is the zero sentinel).  Differentiable in ``table``
    on either route: the kernel runs under an ``autograd.Function`` when
    the table needs a gradient."""
    if not _use_kernel(table, impl):
        return _bag.embedding_bag_plain(table, indices, mode)
    if torch.is_grad_enabled() and table.requires_grad:
        return _bag._Bag.apply(table, indices, mode)
    return _bag.embedding_bag_cuda(table, indices, mode)


def embedding_bag_grouped(tables, indices, mode: str = "sum", impl=None):
    """EmbeddingBag over F tables of one width and dtype: (B, F, K) int32
    ids -> (B, F, D), table f looked up by column f, as
    :func:`embedding_bag` per table but in one launch per 64 tables."""
    if not _use_kernel(indices, impl):
        return _bag.embedding_bag_grouped_plain(tables, indices, mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _bag._BagGrouped.apply(indices, mode, *tables)
    return _bag.embedding_bag_grouped_cuda(tables, indices, mode)


def decode_attention(q, k_cache, v_cache, slot_positions, cur_pos, *,
                     window=None, scale=None, impl=None):
    """Single-token GQA attention over a ``(B, S, KVH, D)`` KV cache,
    slot-validity masked (``models/attention.decode_attention``): on a CUDA
    tensor one call of the kernel, which reads the cache in place (and
    raises on a tensor subclass).  A ``meta`` tensor, a ``DTensor`` over
    meta shards included, takes the plain version, whose ops the multi-pod
    dry run traces for shapes, collectives and FLOPs (``launch/dryrun.py``)."""
    _check_impl(impl)
    if q.is_meta or not _use_kernel(q, impl):
        return _attn.decode_attention_plain(q, k_cache, v_cache,
                                            slot_positions, cur_pos,
                                            window=window, scale=scale)
    return _attn.decode_attention_cuda(q, k_cache, v_cache, slot_positions,
                                       cur_pos, window=window, scale=scale)
