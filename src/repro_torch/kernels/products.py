"""Float32 results of batched products, and the mask constant, shared by the
decoder's attention (``models/attention.py``, ``models/transformer.py``) and
decode attention's plain version (``kernels/decode_attention.py``).

As in the reference (``preferred_element_type=float32``), a product is the
float32 result of the operands' values: on the card a bf16 product asks
cuBLAS for a float32 result (``torch.bmm(..., out_dtype=torch.float32)``,
with a backward of its own under autograd); elsewhere the operands are
upcast, which keeps their values exactly.
"""
from __future__ import annotations

import torch

__all__ = ["NEG", "product_f32"]

NEG = -1.0e30


class _ProductF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=float32)`` with a backward: torch has no
    derivative for ``aten::bmm.dtype``.  The forward is that same call; the
    backward is two float32-output products of the operands' dtype (the
    incoming float32 gradient cast to it), each cast back to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.mT, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.mT, g, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` as a float32 result of the operands' values (of
    mixed dtypes too, as JAX promotes them)."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda and a.dtype == b.dtype:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _ProductF32.apply(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())
