"""CUDA VNTK kernels: ctypes wrappers and their plain PyTorch versions.

Two kernels in ``csrc/vntk.cu``, each templated on ``FUSED`` (log-softmax
of raw logits inside the kernel), carry four functions of the TPU package:

============================  ==================================================
wrapper (fused)               replaces (``src/repro/kernels/vntk.py``)
============================  ==================================================
``vntk_topk_cuda`` (False)    ``vntk_topk_pallas``, ``fused_logsoftmax=False``
``vntk_topk_cuda`` (True)     ``vntk_topk_pallas``, ``fused_logsoftmax=True``
``vntk_mask_cuda`` (False)    ``vntk_pallas``
``vntk_mask_cuda`` (True)     ``vntk_fused_logsoftmax_pallas``
============================  ==================================================

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, raises on what the kernel does not take, and launches on the
current stream.  ``LAUNCHES`` counts each function's launches (its key is
:func:`counter_name`); nothing but a launch moves it.  The plain versions
(``vntk_topk_plain``, ``vntk_mask_plain``) compute the same functions with
torch ops on any device; the CPU path and the kernel comparisons use them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.vntk import vntk_reference_scatter, vntk_topk_reference
from repro_torch.kernels import build

__all__ = ["LAUNCHES", "counter_name", "reset_launches", "vntk_topk_cuda",
           "vntk_mask_cuda", "vntk_topk_plain", "vntk_mask_plain"]

LAUNCHES = {"vntk_topk": 0, "vntk_topk_fused": 0, "vntk_mask": 0,
            "vntk_mask_fused": 0}

# Shared memory a block may use on Hopper (the topk keys live there).
_MAX_SMEM = 227 * 1024


def counter_name(kernel: str, fused: bool) -> str:
    return f"{kernel}_fused" if fused else kernel


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/vntk.cu`` with its C signatures declared (pointers
    and the stream as ``c_void_p``, so ctypes never truncates them)."""
    lib = build.load("vntk")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vntk_topk_launch.argtypes = [p, i64, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.vntk_topk_launch.restype = ctypes.c_int
    lib.vntk_mask_launch.argtypes = [p, i64, p, p, p, i, i, i, i, p, p, p]
    lib.vntk_mask_launch.restype = ctypes.c_int
    lib.vntk_topk_smem_bytes.argtypes = [i, i]
    lib.vntk_topk_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_inputs(values, nodes, row_pointers, edges, bmax: int, vocab: int):
    """Validate the kernel's inputs; returns the row count ``nb``."""
    dev = values.device
    for name, t in (("values", values), ("nodes", nodes),
                    ("row_pointers", row_pointers), ("edges", edges)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{t.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if values.dim() != 2 or values.shape[1] != vocab or values.stride(1) != 1:
        raise ValueError(f"values must be (nb, {vocab}) with unit column "
                         f"stride, got {tuple(values.shape)} strides "
                         f"{values.stride()}")
    nb = values.shape[0]
    if nodes.dtype != torch.int32 or nodes.shape != (nb,) or not nodes.is_contiguous():
        raise ValueError(f"nodes must be a contiguous ({nb},) int32 tensor, "
                         f"got {nodes.dtype} {tuple(nodes.shape)}")
    if row_pointers.dtype == torch.int64:
        raise TypeError("row_pointers are int64 (a trie past 2**31 index "
                        "values); the CUDA VNTK kernels take int32 indices")
    if (row_pointers.dtype != torch.int32 or row_pointers.dim() != 1
            or not row_pointers.is_contiguous()):
        raise ValueError("row_pointers must be a contiguous 1-D int32 tensor")
    if (edges.dtype != torch.int32 or edges.dim() != 2 or edges.shape[1] != 2
            or not edges.is_contiguous() or edges.data_ptr() % 8):
        raise ValueError("edges must be a contiguous, 8-byte aligned (E, 2) "
                         "int32 tensor")
    if bmax < 1:
        raise ValueError(f"bmax must be >= 1, got {bmax}")
    if edges.shape[0] < bmax:
        raise ValueError("edges tensor smaller than one speculative burst")
    return nb


def vntk_topk_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   width: int, fused: bool = False):
    """Per-beam dense-rank top-``width`` (DESIGN.md §8) on the card.

    ``values`` (nb, V) float32 are normalized log-probs, or raw logits when
    ``fused``.  Returns ``(scores f32, tokens i32, next_states i32)``, each
    ``(nb, width)``.
    """
    bmax, vocab, width = int(bmax), int(vocab), int(width)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab)
    if not 1 <= width <= vocab:
        raise ValueError(f"width must be in [1, {vocab}], got {width}")
    lib = _lib()
    smem = lib.vntk_topk_smem_bytes(bmax, width)
    if smem > _MAX_SMEM:
        raise ValueError(f"bmax + width = {bmax + width} candidate keys need "
                         f"{smem} B of shared memory (limit {_MAX_SMEM})")
    kw = dict(device=values.device)
    sc = torch.empty((nb, width), dtype=torch.float32, **kw)
    tok = torch.empty((nb, width), dtype=torch.int32, **kw)
    nxt = torch.empty((nb, width), dtype=torch.int32, **kw)
    if nb == 0:
        return sc, tok, nxt
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_topk_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            row_pointers.data_ptr(), edges.data_ptr(), nb, vocab, bmax, width,
            int(fused), sc.data_ptr(), tok.data_ptr(), nxt.data_ptr(), stream)
    if err:
        raise RuntimeError(f"vntk_topk kernel launch failed: CUDA error {err}")
    LAUNCHES[counter_name("vntk_topk", fused)] += 1
    return sc, tok, nxt


def vntk_mask_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   fused: bool = False):
    """Alg. 2, vocab-aligned, on the card: ``(masked_lp f32, next i32)``,
    each ``(nb, V)`` (``NEG_INF`` / 0 off the trie)."""
    bmax, vocab = int(bmax), int(vocab)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab)
    lib = _lib()
    kw = dict(device=values.device)
    out_lp = torch.empty((nb, vocab), dtype=torch.float32, **kw)
    out_next = torch.empty((nb, vocab), dtype=torch.int32, **kw)
    if nb == 0:
        return out_lp, out_next
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_mask_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            row_pointers.data_ptr(), edges.data_ptr(), nb, vocab, bmax,
            int(fused), out_lp.data_ptr(), out_next.data_ptr(), stream)
    if err:
        raise RuntimeError(f"vntk_mask kernel launch failed: CUDA error {err}")
    LAUNCHES[counter_name("vntk_mask", fused)] += 1
    return out_lp, out_next


def _normalize(values, fused: bool):
    return torch.log_softmax(values.float(), dim=-1) if fused else values


def vntk_topk_plain(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                    width: int, fused: bool = False):
    """Plain PyTorch version of :func:`vntk_topk_cuda` (any device)."""
    return vntk_topk_reference(_normalize(values, fused), nodes, row_pointers,
                               edges, bmax, vocab, width)


def vntk_mask_plain(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                    fused: bool = False):
    """Plain PyTorch version of :func:`vntk_mask_cuda` (any device)."""
    return vntk_reference_scatter(_normalize(values, fused), nodes,
                                  row_pointers, edges, bmax, vocab)
