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


def _mask(values, nodes, row_pointers, edges, bmax, vocab, fused, impl):
    batch_shape = tuple(nodes.shape)
    flat_v, flat_n = values.reshape(-1, vocab), nodes.reshape(-1)
    fn = _k.vntk_mask_cuda if _use_kernel(values, impl) else _k.vntk_mask_plain
    lp, nxt = fn(flat_v, flat_n, row_pointers, edges, bmax, vocab, fused)
    return (lp.reshape(batch_shape + (vocab,)),
            nxt.reshape(batch_shape + (vocab,)))


def vntk(log_probs, nodes, row_pointers, edges, bmax: int, vocab: int,
         impl=None):
    """Alg. 2 (VNTK): ``(masked_log_probs, next_states)``, vocab-aligned."""
    return _mask(log_probs, nodes, row_pointers, edges, bmax, vocab, False,
                 impl)


def vntk_fused_logsoftmax(logits, nodes, row_pointers, edges, bmax: int,
                          vocab: int, impl=None):
    """Fused LogSoftmax + VNTK masking (one pass over the logits)."""
    return _mask(logits, nodes, row_pointers, edges, bmax, vocab, True, impl)


def vntk_topk(values, nodes, row_pointers, edges, bmax: int, vocab: int,
              width: int, fused_logsoftmax: bool = False, impl=None):
    """Candidate-compressed VNTK (DESIGN.md §8): per-beam dense-rank top-C.

    Returns ``(scores, tokens, next_states)``, each ``(..., width)``;
    ``values`` are log-probs, or raw logits with ``fused_logsoftmax``.
    """
    batch_shape = tuple(nodes.shape)
    flat_v, flat_n = values.reshape(-1, vocab), nodes.reshape(-1)
    fn = _k.vntk_topk_cuda if _use_kernel(values, impl) else _k.vntk_topk_plain
    sc, tok, nxt = fn(flat_v, flat_n, row_pointers, edges, bmax, vocab, width,
                      fused_logsoftmax)
    shp = batch_shape + (width,)
    return sc.reshape(shp), tok.reshape(shp), nxt.reshape(shp)
