"""CUDA VNTK kernels: ctypes wrappers and their plain PyTorch versions.

Two kernels in ``csrc/vntk.cu``, each templated on ``FUSED`` (log-softmax
of raw logits inside the kernel) and ``STACKED`` (a multi-tenant store read
through per-row constraint ids), carry eight functions of the TPU package:

====================================  ==========================================
wrapper (fused)                       replaces (``src/repro/kernels/vntk.py``)
====================================  ==========================================
``vntk_topk_cuda`` (False)            ``vntk_topk_pallas``
``vntk_topk_cuda`` (True)             ``vntk_topk_pallas``, fused
``vntk_mask_cuda`` (False)            ``vntk_pallas``
``vntk_mask_cuda`` (True)             ``vntk_fused_logsoftmax_pallas``
``vntk_stacked_topk_cuda`` (False)    ``vntk_stacked_topk_pallas``
``vntk_stacked_topk_cuda`` (True)     ``vntk_stacked_topk_pallas``, fused
``vntk_stacked_mask_cuda`` (False)    ``vntk_stacked_pallas``
``vntk_stacked_mask_cuda`` (True)     ``vntk_stacked_fused_logsoftmax_pallas``
====================================  ==========================================

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, raises on what the kernel does not take, and launches on the
current stream.  ``LAUNCHES`` counts each function's launches (its key is
:func:`counter_name`); nothing but a launch moves it.  The plain versions
(``*_plain``) compute the same functions with torch ops on any device; the
CPU path and the kernel comparisons use them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.vntk import (
    vntk_reference_scatter,
    vntk_stacked_reference_scatter,
    vntk_stacked_topk_reference,
    vntk_topk_reference,
)
from repro_torch.kernels import build

__all__ = ["LAUNCHES", "counter_name", "reset_launches", "vntk_topk_cuda",
           "vntk_mask_cuda", "vntk_topk_plain", "vntk_mask_plain",
           "vntk_stacked_topk_cuda", "vntk_stacked_mask_cuda",
           "vntk_stacked_topk_plain", "vntk_stacked_mask_plain"]

LAUNCHES = {"vntk_topk": 0, "vntk_topk_fused": 0, "vntk_mask": 0,
            "vntk_mask_fused": 0, "vntk_stacked_topk": 0,
            "vntk_stacked_topk_fused": 0, "vntk_stacked_mask": 0,
            "vntk_stacked_mask_fused": 0}

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
    lib.vntk_mask_launch.argtypes = [p, i64, p, p, p, i, i, i, i, p, p, p]
    lib.vntk_stacked_topk_launch.argtypes = [
        p, i64, p, p, i, p, i64, p, i64, i, i, i, i, i, p, p, p, p]
    lib.vntk_stacked_mask_launch.argtypes = [
        p, i64, p, p, i, p, i64, p, i64, i, i, i, i, p, p, p]
    for fn in (lib.vntk_topk_launch, lib.vntk_mask_launch,
               lib.vntk_stacked_topk_launch, lib.vntk_stacked_mask_launch):
        fn.restype = ctypes.c_int
    lib.vntk_topk_smem_bytes.argtypes = [i, i]
    lib.vntk_topk_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_inputs(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                  cids=None):
    """Validate the kernel's inputs; returns the row count ``nb``.

    With ``cids`` the tables are a stacked store: ``row_pointers`` (K, S+1)
    and ``edges`` (K, E, 2) with equal K, and ``cids`` a contiguous (nb,)
    int32 tensor."""
    dev = values.device
    tensors = (("values", values), ("nodes", nodes),
               ("row_pointers", row_pointers), ("edges", edges))
    if cids is not None:
        tensors += (("constraint_ids", cids),)
    for name, t in tensors:
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
    lead = 0 if cids is None else 1  # the store's constraint axis
    if row_pointers.dtype == torch.int64:
        raise TypeError("row_pointers are int64 (a trie past 2**31 index "
                        "values); the CUDA VNTK kernels take int32 indices")
    if (row_pointers.dtype != torch.int32 or row_pointers.dim() != 1 + lead
            or not row_pointers.is_contiguous()):
        raise ValueError(f"row_pointers must be a contiguous {1 + lead}-D "
                         "int32 tensor")
    if (edges.dtype != torch.int32 or edges.dim() != 2 + lead
            or edges.shape[-1] != 2 or not edges.is_contiguous()
            or edges.data_ptr() % 8):
        shape = "(K, E, 2)" if lead else "(E, 2)"
        raise ValueError(f"edges must be a contiguous, 8-byte aligned {shape} "
                         "int32 tensor")
    if cids is not None:
        if (cids.dtype != torch.int32 or cids.shape != (nb,)
                or not cids.is_contiguous()):
            raise ValueError(f"constraint_ids must be a contiguous ({nb},) "
                             f"int32 tensor, got {cids.dtype} "
                             f"{tuple(cids.shape)}")
        if row_pointers.shape[0] != edges.shape[0] or edges.shape[0] < 1:
            raise ValueError(f"row_pointers ({row_pointers.shape[0]} sets) and "
                             f"edges ({edges.shape[0]} sets) disagree on K")
    if bmax < 1:
        raise ValueError(f"bmax must be >= 1, got {bmax}")
    if edges.shape[-2] < bmax:
        raise ValueError("edges tensor smaller than one speculative burst")
    return nb


def _outputs(values, nb: int, width: int, topk: bool = True):
    """(scores f32, tokens i32, next i32) for topk; (masked f32, next i32)
    for the mask, each ``(nb, width)``."""
    kw = dict(device=values.device)
    ints = 2 if topk else 1
    return ((torch.empty((nb, width), dtype=torch.float32, **kw),)
            + tuple(torch.empty((nb, width), dtype=torch.int32, **kw)
                    for _ in range(ints)))


def _check_width(lib, bmax: int, width: int, vocab: int) -> None:
    if not 1 <= width <= vocab:
        raise ValueError(f"width must be in [1, {vocab}], got {width}")
    smem = lib.vntk_topk_smem_bytes(bmax, width)
    if smem > _MAX_SMEM:
        raise ValueError(f"bmax + width = {bmax + width} candidate keys need "
                         f"{smem} B of shared memory (limit {_MAX_SMEM})")


def _launched(err: int, kernel: str, fused: bool) -> None:
    """Raise on a failed launch; count a good one."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter_name(kernel, fused)] += 1


def vntk_topk_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   width: int, fused: bool = False):
    """Per-beam dense-rank top-``width`` (DESIGN.md §8) on the card.

    ``values`` (nb, V) float32 are normalized log-probs, or raw logits when
    ``fused``.  Returns ``(scores f32, tokens i32, next_states i32)``, each
    ``(nb, width)``.
    """
    bmax, vocab, width = int(bmax), int(vocab), int(width)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab)
    lib = _lib()
    _check_width(lib, bmax, width, vocab)
    sc, tok, nxt = _outputs(values, nb, width)
    if nb == 0:
        return sc, tok, nxt
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_topk_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            row_pointers.data_ptr(), edges.data_ptr(), nb, vocab, bmax, width,
            int(fused), sc.data_ptr(), tok.data_ptr(), nxt.data_ptr(), stream)
    _launched(err, "vntk_topk", fused)
    return sc, tok, nxt


def vntk_stacked_topk_cuda(values, nodes, cids, row_pointers, edges,
                           bmax: int, vocab: int, width: int,
                           fused: bool = False):
    """:func:`vntk_topk_cuda` over a stacked store: row ``r`` reads member
    ``cids[r]`` (clamped into ``[0, K)``) of ``row_pointers`` (K, S+1) and
    ``edges`` (K, E, 2)."""
    bmax, vocab, width = int(bmax), int(vocab), int(width)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab, cids)
    lib = _lib()
    _check_width(lib, bmax, width, vocab)
    sc, tok, nxt = _outputs(values, nb, width)
    if nb == 0:
        return sc, tok, nxt
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_stacked_topk_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            cids.data_ptr(), edges.shape[0], row_pointers.data_ptr(),
            row_pointers.shape[1], edges.data_ptr(), edges.shape[1], nb,
            vocab, bmax, width, int(fused), sc.data_ptr(), tok.data_ptr(),
            nxt.data_ptr(), stream)
    _launched(err, "vntk_stacked_topk", fused)
    return sc, tok, nxt


def vntk_mask_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   fused: bool = False):
    """Alg. 2, vocab-aligned, on the card: ``(masked_lp f32, next i32)``,
    each ``(nb, V)`` (``NEG_INF`` / 0 off the trie)."""
    bmax, vocab = int(bmax), int(vocab)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab)
    lib = _lib()
    out_lp, out_next = _outputs(values, nb, vocab, topk=False)
    if nb == 0:
        return out_lp, out_next
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_mask_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            row_pointers.data_ptr(), edges.data_ptr(), nb, vocab, bmax,
            int(fused), out_lp.data_ptr(), out_next.data_ptr(), stream)
    _launched(err, "vntk_mask", fused)
    return out_lp, out_next


def vntk_stacked_mask_cuda(values, nodes, cids, row_pointers, edges,
                           bmax: int, vocab: int, fused: bool = False):
    """:func:`vntk_mask_cuda` over a stacked store (see
    :func:`vntk_stacked_topk_cuda`)."""
    bmax, vocab = int(bmax), int(vocab)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab, cids)
    lib = _lib()
    out_lp, out_next = _outputs(values, nb, vocab, topk=False)
    if nb == 0:
        return out_lp, out_next
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vntk_stacked_mask_launch(
            values.data_ptr(), values.stride(0), nodes.data_ptr(),
            cids.data_ptr(), edges.shape[0], row_pointers.data_ptr(),
            row_pointers.shape[1], edges.data_ptr(), edges.shape[1], nb,
            vocab, bmax, int(fused), out_lp.data_ptr(), out_next.data_ptr(),
            stream)
    _launched(err, "vntk_stacked_mask", fused)
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


def vntk_stacked_topk_plain(values, nodes, cids, row_pointers, edges,
                            bmax: int, vocab: int, width: int,
                            fused: bool = False):
    """Plain PyTorch version of :func:`vntk_stacked_topk_cuda` (any device)."""
    return vntk_stacked_topk_reference(_normalize(values, fused), nodes, cids,
                                       row_pointers, edges, bmax, vocab, width)


def vntk_stacked_mask_plain(values, nodes, cids, row_pointers, edges,
                            bmax: int, vocab: int, fused: bool = False):
    """Plain PyTorch version of :func:`vntk_stacked_mask_cuda` (any device)."""
    return vntk_stacked_reference_scatter(_normalize(values, fused), nodes,
                                          cids, row_pointers, edges, bmax,
                                          vocab)
