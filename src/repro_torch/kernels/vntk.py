"""CUDA VNTK kernels: ctypes wrappers and their plain PyTorch versions.

Two kernels in ``csrc/vntk.cu``, each templated on ``FUSED`` (log-softmax
of raw logits inside the kernel), ``STACKED`` (a multi-tenant store read
through per-row constraint ids) and the edge source (the raw ``(token,
next)`` pairs, or a delta-compressed slab of int16/int32 token deltas and a
next-state base, DESIGN.md §11), carry sixteen functions of the TPU package:

===============================================  ==========================================
wrapper (fused)                                  replaces (``src/repro/kernels/vntk.py``)
===============================================  ==========================================
``vntk_topk_cuda`` (False)                       ``vntk_topk_pallas``
``vntk_topk_cuda`` (True)                        ``vntk_topk_pallas``, fused
``vntk_mask_cuda`` (False)                       ``vntk_pallas``
``vntk_mask_cuda`` (True)                        ``vntk_fused_logsoftmax_pallas``
``vntk_stacked_topk_cuda`` (False)               ``vntk_stacked_topk_pallas``
``vntk_stacked_topk_cuda`` (True)                ``vntk_stacked_topk_pallas``, fused
``vntk_stacked_mask_cuda`` (False)               ``vntk_stacked_pallas``
``vntk_stacked_mask_cuda`` (True)                ``vntk_stacked_fused_logsoftmax_pallas``
``vntk_compressed_topk_cuda`` (both)             ``vntk_compressed_topk_pallas``
``vntk_compressed_mask_cuda`` (both)             ``vntk_compressed_pallas``
``vntk_stacked_compressed_topk_cuda`` (both)     ``vntk_stacked_compressed_topk_pallas``
``vntk_stacked_compressed_mask_cuda`` (both)     ``vntk_stacked_compressed_pallas``
===============================================  ==========================================

The topk kernel takes one of two routes by ``bmax`` (:func:`topk_path`): a
warp per beam row for rows of at most 32 slots, a block per row above; each
call is one launch either way.  :func:`topk_ranks_closed_form` models the
warp route's selection on the CPU, :func:`topk_radix_select_model` the
block route's (a radix select with no cap on the row width: the keys are
staged in shared memory while they fit, :func:`topk_staged`, and re-read
otherwise, or at every width within :func:`topk_keys_reread`).  The mask kernel is a block per row on both of its routes
(:func:`mask_path`): for rows of at most 32 slots one warp holds them in
its lanes while the others fill the row, above that the block scatters them
chunk by chunk; :func:`row_lse_model` models its fused log-sum-exp on the
CPU.

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, raises on what the kernel does not take, and launches on the
current stream.  ``LAUNCHES`` counts each function's launches (its key is
:func:`counter_name`), ``BLOCK_LAUNCHES`` the topk functions' launches on
the block route and ``WIDE_LAUNCHES`` those of its 1,024-thread
instantiation (rows past 8,192 slots); nothing but a launch moves them.  The plain versions
(``*_plain``) compute the same functions with torch ops on any device; the
CPU path and the kernel comparisons use them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.core.vntk import (
    NEG_INF,
    vntk_compressed_reference,
    vntk_compressed_topk_reference,
    vntk_reference_scatter,
    vntk_stacked_compressed_reference,
    vntk_stacked_compressed_topk_reference,
    vntk_stacked_reference_scatter,
    vntk_stacked_topk_reference,
    vntk_topk_reference,
)
from repro_torch.kernels import build

__all__ = ["LAUNCHES", "counter_name", "reset_launches", "vntk_topk_cuda",
           "vntk_mask_cuda", "vntk_topk_plain", "vntk_mask_plain",
           "vntk_stacked_topk_cuda", "vntk_stacked_mask_cuda",
           "vntk_stacked_topk_plain", "vntk_stacked_mask_plain",
           "vntk_compressed_topk_cuda", "vntk_compressed_mask_cuda",
           "vntk_stacked_compressed_topk_cuda",
           "vntk_stacked_compressed_mask_cuda", "vntk_compressed_topk_plain",
           "vntk_compressed_mask_plain", "vntk_stacked_compressed_topk_plain",
           "vntk_stacked_compressed_mask_plain", "topk_path",
           "topk_ranks_closed_form", "topk_radix_select_model", "topk_staged",
           "topk_keys_reread", "mask_path", "row_lse_model",
           "BLOCK_LAUNCHES", "WIDE_LAUNCHES"]

KERNELS = ("vntk_topk", "vntk_mask", "vntk_stacked_topk", "vntk_stacked_mask",
           "vntk_compressed_topk", "vntk_compressed_mask",
           "vntk_stacked_compressed_topk", "vntk_stacked_compressed_mask")
LAUNCHES = {f"{k}{suffix}": 0 for k in KERNELS for suffix in ("", "_fused")}
BLOCK_LAUNCHES = {k: 0 for k in LAUNCHES if k.removesuffix("_fused").endswith(
    "topk")}
WIDE_LAUNCHES = dict(BLOCK_LAUNCHES)


def counter_name(kernel: str, fused: bool) -> str:
    return f"{kernel}_fused" if fused else kernel


def reset_launches() -> None:
    for counts in (LAUNCHES, BLOCK_LAUNCHES, WIDE_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    lib.vntk_compressed_topk_launch.argtypes = [
        p, i64, p, p, p, i, p, i, i, i, i, i, p, p, p, p]
    lib.vntk_compressed_mask_launch.argtypes = [
        p, i64, p, p, p, i, p, i, i, i, i, p, p, p]
    lib.vntk_stacked_compressed_topk_launch.argtypes = [
        p, i64, p, p, i, p, i64, p, i64, i, p, i64, i, i, i, i, i, p, p, p, p]
    lib.vntk_stacked_compressed_mask_launch.argtypes = [
        p, i64, p, p, i, p, i64, p, i64, i, p, i64, i, i, i, i, p, p, p]
    for kernel in KERNELS:
        getattr(lib, f"{kernel}_launch").restype = ctypes.c_int
    for route in ("vntk_topk_warp_route", "vntk_mask_warp_route",
                  "vntk_topk_staged", "vntk_topk_wide_route"):
        getattr(lib, route).argtypes = [i]
        getattr(lib, route).restype = ctypes.c_int
    lib.vntk_topk_reread.argtypes = [i]
    lib.vntk_topk_reread.restype = None
    return lib


def _check_inputs(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                  cids=None, base=None):
    """Validate the kernel's inputs; returns the row count ``nb``.

    With ``cids`` the tables are a stacked store: ``row_pointers`` (K, S+1)
    and ``edges`` (K, E, 2) with equal K, and ``cids`` a contiguous (nb,)
    int32 tensor.  With ``base`` ``edges`` is a compressed slab's
    ``tok_delta`` ((E+pad,) or (K, E+pad), int16 or int32) and ``base`` the
    step's int32 next-state base: one value, or (K,) when stacked."""
    dev = values.device
    tensors = (("values", values), ("nodes", nodes),
               ("row_pointers", row_pointers),
               ("edges" if base is None else "tok_delta", edges))
    if cids is not None:
        tensors += (("constraint_ids", cids),)
    if base is not None:
        tensors += (("base", base),)
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
    if base is None:
        if (edges.dtype != torch.int32 or edges.dim() != 2 + lead
                or edges.shape[-1] != 2 or not edges.is_contiguous()
                or edges.data_ptr() % 8):
            shape = "(K, E, 2)" if lead else "(E, 2)"
            raise ValueError(f"edges must be a contiguous, 8-byte aligned "
                             f"{shape} int32 tensor")
        if edges.shape[-2] < bmax:
            raise ValueError("edges tensor smaller than one speculative burst")
    else:
        if (edges.dtype not in (torch.int16, torch.int32)
                or edges.dim() != 1 + lead or not edges.is_contiguous()):
            shape = "(K, E+pad)" if lead else "(E+pad,)"
            raise ValueError(f"tok_delta must be a contiguous {shape} int16 "
                             f"or int32 tensor, got {edges.dtype} "
                             f"{tuple(edges.shape)}")
        if edges.shape[-1] < bmax:
            raise ValueError("token slab smaller than one speculative burst")
        if base.dtype != torch.int32 or (
                base.shape != (edges.shape[0],) if lead else base.numel() != 1):
            want = f"({edges.shape[0]},)" if lead else "one-element"
            raise ValueError(f"base must be a {want} int32 tensor, got "
                             f"{base.dtype} {tuple(base.shape)}")
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
    return nb


def _outputs(values, nb: int, width: int, topk: bool = True):
    """(scores f32, tokens i32, next i32) for topk; (masked f32, next i32)
    for the mask, each ``(nb, width)``."""
    kw = dict(device=values.device)
    ints = 2 if topk else 1
    return ((torch.empty((nb, width), dtype=torch.float32, **kw),)
            + tuple(torch.empty((nb, width), dtype=torch.int32, **kw)
                    for _ in range(ints)))


def _check_width(width: int, vocab: int) -> None:
    if not 1 <= width <= vocab:
        raise ValueError(f"width must be in [1, {vocab}], got {width}")


@functools.lru_cache(maxsize=None)
def _block_route(bmax: int) -> bool:
    return topk_path(bmax) == "block"


@functools.lru_cache(maxsize=None)
def _wide_route(bmax: int) -> bool:
    return bool(_lib().vntk_topk_wide_route(int(bmax)))


def _launched(err: int, kernel: str, fused: bool, block: bool,
              wide: bool) -> None:
    """Raise on a failed launch; count a good one (``block``: a topk launch
    on the block route, ``wide``: of its 1,024-thread instantiation)."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter_name(kernel, fused)] += 1
    if block:
        BLOCK_LAUNCHES[counter_name(kernel, fused)] += 1
    if wide:
        WIDE_LAUNCHES[counter_name(kernel, fused)] += 1


def _launch(kernel: str, fused: bool, values, nodes, cids, row_pointers,
            edges, base, bmax: int, vocab: int, width=None):
    """Check, allocate and launch one function: ``width`` ``None`` is the
    vocab-aligned mask, else the candidate topk; ``cids`` selects the
    stacked kernels, ``base`` the compressed ones (``edges`` is then the
    slab's ``tok_delta``)."""
    bmax, vocab = int(bmax), int(vocab)
    nb = _check_inputs(values, nodes, row_pointers, edges, bmax, vocab, cids,
                       base)
    lib = _lib()
    topk = width is not None
    if topk:
        width = int(width)
        _check_width(width, vocab)
    outs = _outputs(values, nb, width if topk else vocab, topk=topk)
    if nb == 0:
        return outs
    slab = [] if base is None else [edges.element_size(), base.data_ptr()]
    if cids is None:
        tables = [row_pointers.data_ptr(), edges.data_ptr(), *slab]
    else:
        tables = [cids.data_ptr(), edges.shape[0], row_pointers.data_ptr(),
                  row_pointers.shape[1], edges.data_ptr(), edges.shape[1],
                  *slab, *([] if base is None else [base.stride(0)])]
    shape = [nb, vocab, bmax] + ([width] if topk else [])
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{kernel}_launch")(
            values.data_ptr(), values.stride(0), nodes.data_ptr(), *tables,
            *shape, int(fused), *(o.data_ptr() for o in outs), stream)
    _launched(err, kernel, fused, topk and _block_route(bmax),
              topk and _wide_route(bmax))
    return outs


def vntk_topk_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   width: int, fused: bool = False):
    """Per-beam dense-rank top-``width`` (DESIGN.md §8) on the card.

    ``values`` (nb, V) float32 are normalized log-probs, or raw logits when
    ``fused``.  Returns ``(scores f32, tokens i32, next_states i32)``, each
    ``(nb, width)``.
    """
    return _launch("vntk_topk", fused, values, nodes, None, row_pointers,
                   edges, None, bmax, vocab, width)


def vntk_stacked_topk_cuda(values, nodes, cids, row_pointers, edges,
                           bmax: int, vocab: int, width: int,
                           fused: bool = False):
    """:func:`vntk_topk_cuda` over a stacked store: row ``r`` reads member
    ``cids[r]`` (clamped into ``[0, K)``) of ``row_pointers`` (K, S+1) and
    ``edges`` (K, E, 2)."""
    return _launch("vntk_stacked_topk", fused, values, nodes, cids,
                   row_pointers, edges, None, bmax, vocab, width)


def vntk_mask_cuda(values, nodes, row_pointers, edges, bmax: int, vocab: int,
                   fused: bool = False):
    """Alg. 2, vocab-aligned, on the card: ``(masked_lp f32, next i32)``,
    each ``(nb, V)`` (``NEG_INF`` / 0 off the trie)."""
    return _launch("vntk_mask", fused, values, nodes, None, row_pointers,
                   edges, None, bmax, vocab)


def vntk_stacked_mask_cuda(values, nodes, cids, row_pointers, edges,
                           bmax: int, vocab: int, fused: bool = False):
    """:func:`vntk_mask_cuda` over a stacked store (see
    :func:`vntk_stacked_topk_cuda`)."""
    return _launch("vntk_stacked_mask", fused, values, nodes, cids,
                   row_pointers, edges, None, bmax, vocab)


def vntk_compressed_topk_cuda(values, nodes, row_pointers, tok_delta, base,
                              bmax: int, vocab: int, width: int,
                              fused: bool = False):
    """:func:`vntk_topk_cuda` over a compressed slab (DESIGN.md §11):
    ``tok_delta`` (E+pad,) int16/int32 token deltas and ``base`` the step's
    one-element int32 next-state base (``CompressedSlab.base_for_step``)."""
    return _launch("vntk_compressed_topk", fused, values, nodes, None,
                   row_pointers, tok_delta, base, bmax, vocab, width)


def vntk_compressed_mask_cuda(values, nodes, row_pointers, tok_delta, base,
                              bmax: int, vocab: int, fused: bool = False):
    """:func:`vntk_mask_cuda` over a compressed slab."""
    return _launch("vntk_compressed_mask", fused, values, nodes, None,
                   row_pointers, tok_delta, base, bmax, vocab)


def vntk_stacked_compressed_topk_cuda(values, nodes, cids, row_pointers,
                                      tok_delta, base_k, bmax: int,
                                      vocab: int, width: int,
                                      fused: bool = False):
    """:func:`vntk_compressed_topk_cuda` over a stacked store's slab: row
    ``r`` reads member ``k = cids[r]`` (clamped into ``[0, K)``) of
    ``row_pointers`` (K, S+1) and ``tok_delta`` (K, E+pad), with base
    ``base_k[k]`` of the (K,) int32 bases (any stride)."""
    return _launch("vntk_stacked_compressed_topk", fused, values, nodes, cids,
                   row_pointers, tok_delta, base_k, bmax, vocab, width)


def vntk_stacked_compressed_mask_cuda(values, nodes, cids, row_pointers,
                                      tok_delta, base_k, bmax: int,
                                      vocab: int, fused: bool = False):
    """:func:`vntk_compressed_mask_cuda` over a stacked store's slab (see
    :func:`vntk_stacked_compressed_topk_cuda`)."""
    return _launch("vntk_stacked_compressed_mask", fused, values, nodes, cids,
                   row_pointers, tok_delta, base_k, bmax, vocab)


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


def vntk_compressed_topk_plain(values, nodes, row_pointers, tok_delta, base,
                               bmax: int, vocab: int, width: int,
                               fused: bool = False):
    """Plain PyTorch version of :func:`vntk_compressed_topk_cuda`."""
    return vntk_compressed_topk_reference(_normalize(values, fused), nodes,
                                          row_pointers, tok_delta, base, bmax,
                                          vocab, width)


def vntk_compressed_mask_plain(values, nodes, row_pointers, tok_delta, base,
                               bmax: int, vocab: int, fused: bool = False):
    """Plain PyTorch version of :func:`vntk_compressed_mask_cuda`."""
    return vntk_compressed_reference(_normalize(values, fused), nodes,
                                     row_pointers, tok_delta, base, bmax, vocab)


def vntk_stacked_compressed_topk_plain(values, nodes, cids, row_pointers,
                                       tok_delta, base_k, bmax: int,
                                       vocab: int, width: int,
                                       fused: bool = False):
    """Plain PyTorch version of :func:`vntk_stacked_compressed_topk_cuda`."""
    return vntk_stacked_compressed_topk_reference(
        _normalize(values, fused), nodes, cids, row_pointers, tok_delta,
        base_k, bmax, vocab, width)


def vntk_stacked_compressed_mask_plain(values, nodes, cids, row_pointers,
                                       tok_delta, base_k, bmax: int,
                                       vocab: int, fused: bool = False):
    """Plain PyTorch version of :func:`vntk_stacked_compressed_mask_cuda`."""
    return vntk_stacked_compressed_reference(
        _normalize(values, fused), nodes, cids, row_pointers, tok_delta,
        base_k, bmax, vocab)


def topk_path(bmax: int) -> str:
    """The route the topk launcher takes for rows of ``bmax`` slots, read
    from the built library: ``"warp"`` (a warp per beam row) or ``"block"``
    (a block per beam row)."""
    return "warp" if _lib().vntk_topk_warp_route(int(bmax)) else "block"


def topk_staged(bmax: int) -> bool:
    """Whether the block route stages the keys of rows of ``bmax`` slots in
    shared memory (4 bytes a slot, while they fit the card's limit), or
    re-reads them in each pass."""
    staged = _lib().vntk_topk_staged(int(bmax))
    if staged < 0:
        raise RuntimeError("vntk_topk_staged: CUDA error")
    return bool(staged)


@contextlib.contextmanager
def topk_keys_reread():
    """Within it the block route stages no keys: each pass re-reads them
    from the CSR row and the logit row at every row width, as it does past
    :func:`topk_staged`'s limit, so that path is checked and timed at widths
    that would stage."""
    lib = _lib()
    lib.vntk_topk_reread(1)
    try:
        yield
    finally:
        lib.vntk_topk_reread(0)


def mask_path(bmax: int) -> str:
    """The path the mask kernel takes for rows of ``bmax`` slots, read from
    the built library: ``"warp"`` (one warp holds the slots in its lanes)
    or ``"block"`` (the block scatters them chunk by chunk)."""
    return "warp" if _lib().vntk_mask_warp_route(int(bmax)) else "block"


def topk_ranks_closed_form(keys, toks, n_real, bmax: int, width: int,
                           vocab: int):
    """The warp route's selection (``vntk_topk_warp_kernel`` in
    ``csrc/vntk.cu``) in plain torch, step for step; no path calls it.

    Row ``r``'s lane ``j`` holds slot ``j``: its key ``keys[r, j]`` (the
    log-prob at its token) and token ``toks[r, j]``, both read only below
    ``n_real[r]``; slots from ``n_real`` to ``bmax`` are ``-FLT_MAX``.  A
    warp ballot is a sum over the lanes, a shuffle an index along them.
    Returns ``(scores, tokens, source)``, each ``(nb, width)``: the first
    ``width`` candidates in ``(key desc, index asc)`` order, ``source``
    being the candidate index (slot ``j``, or ``bmax + i`` for the ``i``-th
    missing token) — what a stable descending sort of the candidates puts
    there.
    """
    if not 1 <= bmax <= 32:
        raise ValueError(f"the warp route takes bmax in [1, 32], got {bmax}")
    nb, dev = keys.shape[0], keys.device
    minf = torch.finfo(torch.float32).min
    lane = torch.arange(32, device=dev)[None, :]
    n_real = n_real.reshape(nb, 1).long()
    real = lane < n_real
    pad = torch.zeros((nb, 32 - bmax), device=dev)
    key = torch.where(real, torch.cat([keys.float(), pad], 1), minf)
    tok = torch.where(real, torch.cat([toks.long(), pad.long()], 1), 0)
    cand = lane < bmax
    # missing tokens below tok_j: g_j = tok_j - j, non-decreasing over a row
    g = torch.where(real, tok - lane, torch.iinfo(torch.int32).max)
    # slots with a key >= each of the two keys a missing candidate can have
    c_neg = (cand & (key >= NEG_INF)).sum(1, keepdim=True)
    c_min = (cand & (key >= minf)).sum(1, keepdim=True)

    scores = torch.full((nb, width), float("nan"), device=dev)
    tokens = torch.full((nb, width), -1, dtype=torch.int32, device=dev)
    source = torch.full((nb, width), -1, dtype=torch.long, device=dev)
    rows = torch.arange(nb, device=dev)[:, None].expand(nb, 32)

    def write(ok, rank, sc, tk, src):
        r, c = rows[ok], rank[ok]
        if bool((source[r, c] >= 0).any()):
            raise AssertionError("two candidates took one rank")
        scores[r, c], tokens[r, c], source[r, c] = sc[ok], tk[ok].int(), src[ok]

    n_in = torch.zeros((nb, 1), dtype=torch.long, device=dev)
    for i0 in range(0, width, 32):  # lane l takes missing token i0 + l
        i = i0 + lane
        cnt = torch.zeros((nb, 32), dtype=torch.long, device=dev)
        for q in range(bmax):  # q < n_real: a shuffle of g from lane q
            cnt += (q < n_real) & (g[:, q:q + 1] <= i)
        t = i + cnt
        live = i < width
        in_range = live & (t < vocab)
        n_in += in_range.sum(1, keepdim=True)
        rank = torch.where(in_range, c_neg, c_min) + i
        write(live & (rank < width), rank,
              torch.where(in_range, NEG_INF, minf).expand(nb, 32),
              torch.where(in_range, t, 0), bmax + i.expand(nb, 32))

    # slot j: the slots before it in (key desc, index asc), then the missing
    # candidates with a greater key (all of them have a greater index)
    rank = torch.zeros((nb, 32), dtype=torch.long, device=dev)
    for q in range(bmax):  # q < n_real: a shuffle of the key from lane q
        kq = key[:, q:q + 1]
        rank += (q < n_real) & ((kq > key) | ((kq == key) & (q < lane)))
    # the padding slots [n_real, bmax), all at -FLT_MAX, in closed form
    n_pad = bmax - n_real
    rank += torch.where(minf > key, n_pad, torch.where(
        minf == key, (lane - n_real).clamp(min=0).minimum(n_pad), 0))
    rank += torch.where(NEG_INF > key, n_in, 0)
    rank += torch.where(minf > key, width - n_in, 0)
    write(cand & (rank < width), rank, key, tok, lane.expand(nb, 32))
    if bool((source < 0).any()):
        raise AssertionError("a rank below width was not written")
    return scores, tokens, source


_BINS = 256  # the block route's radix digit: 8 bits a pass
_ROUND = 256  # winners it ranks a round


def _order_key(keys):
    """``order_key`` of ``csrc/vntk.cu``: float32 keys as int64 values of
    uint32s in the selection's order (larger first); -0 takes +0's value,
    every NaN the largest."""
    bits = keys.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    u = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(keys), 0xFFFFFFFF, u)


def _radix_threshold(comp, k: int, digits: int, passes: list):
    """The radix select of ``vntk_topk_kernel``: the composite of the
    ``k``-th largest of ``comp`` (distinct int64s of ``digits`` bytes), a
    digit of 8 bits a pass from the top, each pass a histogram of the
    values that match the digits chosen so far; it stops once the digit's
    bin holds exactly the values still needed.  Every value at or above the
    result is among the top ``k``, and no other.  Appends the passes made
    to ``passes``."""
    prefix = 0
    for p in range(digits):
        dsh = 8 * (digits - 1 - p)
        live = (comp if p == 0
                else comp[(comp >> (dsh + 8)) == (prefix >> (dsh + 8))])
        hist = torch.bincount((live >> dsh) & (_BINS - 1), minlength=_BINS)
        from_top = hist.flip(0).cumsum(0).flip(0)  # the values in bins >= b
        b = int((from_top >= k).nonzero().max())
        above = int(from_top[b] - hist[b])
        prefix |= b << dsh
        k -= above
        if int(hist[b]) == k:
            break
    passes.append(p + 1)
    return prefix


def _missing_tokens(toks, need: int):
    """Missing candidates ``i < need`` of a row's sorted distinct tokens,
    as the kernel writes them: slot ``j`` owns the ``i`` in ``[g_{j-1},
    g_j)`` (``g_j = tok_j - j``, ``g_{-1} = 0``), whose token is ``i + j``;
    the tail ``i >= g_{n-1}`` takes ``i + n``.  Returns ``(i, token)``."""
    n = toks.shape[0]
    g = toks - torch.arange(n)
    lo = torch.cat([torch.zeros(1, dtype=torch.long), g[:-1]]).clamp(min=0)
    hi = g.clamp(max=need)
    ii, tt = [], []
    for j in (hi > lo).nonzero().flatten().tolist():
        i = torch.arange(int(lo[j]), int(hi[j]))
        ii.append(i)
        tt.append(i + j)
    start = max(int(g[-1]) if n else 0, 0)
    tail = torch.arange(start, max(start, need))
    ii.append(tail)
    tt.append(tail + n)
    return torch.cat(ii), torch.cat(tt)


def topk_radix_select_model(keys, toks, n_real, bmax: int, width: int,
                            vocab: int, passes: list | None = None):
    """The block route's selection (``vntk_topk_kernel`` in
    ``csrc/vntk.cu``) in plain torch, step for step; no path calls it.

    Row ``r``'s slot ``j`` has key ``keys[r, j]`` (the log-prob at its
    token) and token ``toks[r, j]``, both read only below ``n_real[r]``;
    the row's tokens are sorted and distinct, as a CSR row's are.  The
    candidates in closed form: padding slot ``p`` (``-FLT_MAX``) at rank
    ``c_min + n_in + p``, missing token ``i`` at ``c_neg + i`` while in
    range (``NEG_INF``) and ``c_min + n_pad + i`` past it (``-FLT_MAX``),
    ``c_neg`` and ``c_min`` counting the real keys at or above each; the
    real slots' top ``min(width, n_real)`` by a radix select on (order key,
    inverted slot index), ``_ROUND`` ranks a round, ranked among
    themselves by counting and shifted past the closed-form candidates
    above them.  Returns ``(scores, tokens, source)`` as
    :func:`topk_ranks_closed_form` does; ``passes`` receives each select's
    pass count.
    """
    if not 33 <= bmax <= 1 << 24:
        raise ValueError(f"the block route models bmax in [33, 2**24], got "
                         f"{bmax}")
    nb = keys.shape[0]
    minf = torch.finfo(torch.float32).min
    uneg = int(_order_key(torch.tensor([NEG_INF]))[0])
    umin = int(_order_key(torch.tensor([minf]))[0])
    passes = [] if passes is None else passes
    ns = 1  # bytes of the inverted slot index in the composite
    while ns < 3 and (bmax - 1) >> (8 * ns):
        ns += 1
    digits, smask = 4 + ns, (1 << (8 * ns)) - 1
    scores = torch.full((nb, width), float("nan"))
    tokens = torch.full((nb, width), -1, dtype=torch.int32)
    source = torch.full((nb, width), -1, dtype=torch.long)

    for r in range(nb):
        def put(rank, sc, tk, src):
            ok = rank < width
            rank = rank[ok]
            if (bool((source[r, rank] >= 0).any())
                    or rank.unique().numel() != rank.numel()):
                raise AssertionError("two candidates took one rank")
            scores[r, rank] = torch.as_tensor(sc, dtype=torch.float32
                                              ).expand(ok.shape)[ok]
            tokens[r, rank] = torch.as_tensor(tk).expand(ok.shape)[ok].int()
            source[r, rank] = src[ok]

        n = int(min(max(int(n_real[r]), 0), bmax))
        key, tok = keys[r, :n].float(), toks[r, :n].long()
        uk = _order_key(key)
        c_neg, c_min = int((uk >= uneg).sum()), int((uk >= umin).sum())
        n_pad, n_in = bmax - n, min(width, max(vocab - n, 0))
        p = torch.arange(n_pad)
        put(c_min + n_in + p, minf, 0, n + p)
        i = torch.arange(n_in, width)
        put(c_min + n_pad + i, minf, 0, bmax + i)
        need = max(0, min(n_in, width - c_neg))
        if need:
            i, t = _missing_tokens(tok, need)
            put(c_neg + i, NEG_INF, t, bmax + i)
        comp = (uk << (8 * ns)) | (~torch.arange(n) & smask)
        kk, done, thr_prev = min(width, n), 0, None
        while done < kk:
            k = min(kk, done + _ROUND)
            thr = _radix_threshold(comp, k, digits, passes)
            won = comp >= thr
            if thr_prev is not None:
                won &= comp < thr_prev
            j = won.nonzero().flatten()
            if j.numel() != k - done:
                raise AssertionError(f"a round gathered {j.numel()} slots, "
                                     f"not {k - done}")
            c = comp[j]
            rank = done + (c[None, :] > c[:, None]).sum(1)
            rank += torch.where(uk[j] < uneg, n_in, 0)
            rank += torch.where(uk[j] < umin, n_pad + width - n_in, 0)
            put(rank, key[j], tok[j], j)
            done, thr_prev = k, thr
    if bool((source < 0).any()):
        raise AssertionError("a rank below width was not written")
    return scores, tokens, source


_LOG2E = 1.4426950408889634


def _exp_le0(d):
    """``exp_le0`` of ``csrc/vntk.cu``: exp(d) as exp2(d * log2 e), in
    float32."""
    return torch.exp2(d * torch.tensor(_LOG2E, dtype=torch.float32))


def row_lse_model(x, threads: int = 128, vec: bool = True):
    """The mask kernel's fused log-sum-exp (``fill_and_lse`` and
    ``WorkerRowLse`` in ``csrc/vntk.cu``) in plain float32 torch, step for
    step; no path calls it.

    ``x`` is ``(nb, V)`` logits; ``threads`` the block size (the kernel's
    is 128), whose warps past the first are the workers; ``vec`` the
    kernel's 16-byte load path (it takes it when ``V % 4 == 0`` and the row
    is 16-byte aligned), else scalar loads.  Each worker folds its elements
    into an online ``(m, s)`` pair from ``m = -FLT_MAX``: batch by batch of
    8 float4s (the batch's max first, then its exponentials summed as a
    tree) or element by element.  Each warp merges its 32 pairs (the max,
    then a butterfly sum of the scaled ``s``), and the warps' pairs merge
    in warp order.  Returns ``(m, lse)``, each ``(nb,)``: the row's
    log-probs are ``(x - m) - lse``.
    """
    x = x.float()
    nb, V = x.shape
    nw = threads - 32
    if threads % 32 or nw <= 0:
        raise ValueError(f"threads must be a multiple of 32 above 32, got "
                         f"{threads}")
    if vec and V % 4:
        raise ValueError(f"the 16-byte path needs V % 4 == 0, got V = {V}")
    minf = torch.finfo(torch.float32).min
    w = torch.arange(nw)
    m = torch.full((nb, nw), minf)
    s = torch.zeros((nb, nw))
    if vec:
        batch = 8
        x4 = torch.cat([x.view(nb, V // 4, 4),
                        torch.full((nb, 1, 4), -float("inf"))], 1)
        for b in range(0, max(V // 4, 1), nw * batch):
            k = b + w[:, None] + nw * torch.arange(batch)[None, :]
            v = x4[:, k.clamp(max=V // 4)]  # (nb, nw, batch, 4); -inf past V
            r = v.amax(dim=(2, 3))  # the batch's max (exact in any order)
            up = r > m
            s = torch.where(up, s * _exp_le0(m - r), s)
            m = torch.where(up, r, m)
            d = _exp_le0(v - m[..., None, None])
            e = (d[..., 0] + d[..., 1]) + (d[..., 2] + d[..., 3])
            half = batch // 2
            while half:  # the tree: e[u] += e[u + half] for u < half
                e = e[..., :half] + e[..., half:2 * half]
                half //= 2
            s = s + e[..., 0]
    else:
        for i0 in range(0, V, nw):
            i = i0 + w
            live = i < V
            xi = torch.where(live, x[:, i.clamp(max=V - 1)], minf)
            up = live & (xi > m)
            s = torch.where(up, s * _exp_le0(m - xi) + 1.0,
                            torch.where(live, s + _exp_le0(xi - m), s))
            m = torch.where(up, xi, m)
    # each warp: the max of its lanes' m, then a butterfly sum of the s
    # scaled to it (every lane ends with the same sum)
    m = m.view(nb, nw // 32, 32)
    s = s.view(nb, nw // 32, 32)
    mr = m.amax(-1)
    t = s * _exp_le0(m - mr[..., None])
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lane ^ o]
    # the block: the warps' pairs in warp order
    M = mr[:, 0]
    for q in range(1, nw // 32):
        M = torch.fmax(M, mr[:, q])
    S = torch.zeros(nb)
    for q in range(nw // 32):
        S = S + t[:, q, 0] * _exp_le0(mr[:, q] - M)
    return M, torch.log(S)
