"""Dispatch of the VNTK step to the CUDA kernels or their plain versions.

``impl``:
  * ``None``    — by the tensor's device: a CUDA tensor launches the kernel
                  (which raises if it cannot), a CPU tensor takes the plain
                  version.  Any other device raises.
  * ``"plain"`` — the plain PyTorch version on any device (used to hold the
                  kernels against it on the card).
"""
from __future__ import annotations

from repro_torch.kernels import vntk as _k

__all__ = ["vntk", "vntk_fused_logsoftmax", "vntk_topk"]

IMPLS = (None, "plain")


def _use_kernel(t, impl) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain" or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no VNTK implementation for device {t.device}")


def _flat_ids(constraint_ids, batch_shape):
    """Per-row ids broadcast over the rows and flattened like ``nodes``."""
    return constraint_ids.expand(batch_shape).reshape(-1)


def _mask(values, nodes, row_pointers, edges, bmax, vocab, fused, impl,
          constraint_ids):
    batch_shape = tuple(nodes.shape)
    flat_v, flat_n = values.reshape(-1, vocab), nodes.reshape(-1)
    kernel = _use_kernel(values, impl)
    if constraint_ids is None:
        fn = _k.vntk_mask_cuda if kernel else _k.vntk_mask_plain
        lp, nxt = fn(flat_v, flat_n, row_pointers, edges, bmax, vocab, fused)
    else:
        fn = _k.vntk_stacked_mask_cuda if kernel else _k.vntk_stacked_mask_plain
        lp, nxt = fn(flat_v, flat_n, _flat_ids(constraint_ids, batch_shape),
                     row_pointers, edges, bmax, vocab, fused)
    return (lp.reshape(batch_shape + (vocab,)),
            nxt.reshape(batch_shape + (vocab,)))


def vntk(log_probs, nodes, row_pointers, edges, bmax: int, vocab: int,
         impl=None, constraint_ids=None):
    """Alg. 2 (VNTK): ``(masked_log_probs, next_states)``, vocab-aligned.

    With ``constraint_ids`` (per-row int32), ``row_pointers``/``edges`` carry
    a leading constraint axis — (K, S+1) / (K, E, 2) — and each row is masked
    by its own set (DESIGN.md §4).  ``None`` keeps the single-matrix path.
    """
    return _mask(log_probs, nodes, row_pointers, edges, bmax, vocab, False,
                 impl, constraint_ids)


def vntk_fused_logsoftmax(logits, nodes, row_pointers, edges, bmax: int,
                          vocab: int, impl=None, constraint_ids=None):
    """Fused LogSoftmax + VNTK masking (one pass over the logits)."""
    return _mask(logits, nodes, row_pointers, edges, bmax, vocab, True, impl,
                 constraint_ids)


def vntk_topk(values, nodes, row_pointers, edges, bmax: int, vocab: int,
              width: int, fused_logsoftmax: bool = False, impl=None,
              constraint_ids=None):
    """Candidate-compressed VNTK (DESIGN.md §8): per-beam dense-rank top-C.

    Returns ``(scores, tokens, next_states)``, each ``(..., width)``;
    ``values`` are log-probs, or raw logits with ``fused_logsoftmax``.  With
    ``constraint_ids`` the tables carry the stacked leading constraint axis.
    """
    batch_shape = tuple(nodes.shape)
    flat_v, flat_n = values.reshape(-1, vocab), nodes.reshape(-1)
    kernel = _use_kernel(values, impl)
    if constraint_ids is None:
        fn = _k.vntk_topk_cuda if kernel else _k.vntk_topk_plain
        sc, tok, nxt = fn(flat_v, flat_n, row_pointers, edges, bmax, vocab,
                          width, fused_logsoftmax)
    else:
        fn = _k.vntk_stacked_topk_cuda if kernel else _k.vntk_stacked_topk_plain
        sc, tok, nxt = fn(flat_v, flat_n,
                          _flat_ids(constraint_ids, batch_shape), row_pointers,
                          edges, bmax, vocab, width, fused_logsoftmax)
    shp = batch_shape + (width,)
    return sc.reshape(shp), tok.reshape(shp), nxt.reshape(shp)
