"""CUDA EmbeddingBag kernel: ctypes wrappers and their plain PyTorch versions.

``csrc/embedding_bag.cu`` replaces ``embedding_bag_pallas``
(``src/repro/kernels/embedding_bag.py``): a fixed-arity bag of ``K`` ids per
row looked up in a ``(R+1, D)`` table whose row ``R`` is the zero sentinel,
summed (or averaged over ``K``) in float32 and cast once to the table's
type.  Ids are clamped into ``[0, R]``, as the recsys models' own lookup
clamps them (``jnp.take(..., mode="clip")``).

Two entry points launch the same kernel:

* :func:`embedding_bag_cuda` — one table, ``(B, K)`` ids -> ``(B, D)``;
  the direct counterpart of ``embedding_bag_pallas``.
* :func:`embedding_bag_grouped_cuda` — ``F`` tables of one width and dtype,
  the model's ``(B, F, K)`` id batch read in place -> one contiguous
  ``(B, F, D)`` output: one launch per :data:`MAX_TABLES` tables, so a
  model's bags of one width take one launch instead of ``F`` launches and a
  ``torch.stack``.

Rows whose bytes are a multiple of 16, in 16-byte aligned tables, take the
kernel's 16-byte load path (``"v16"``); others, a misaligned view among
them, its scalar path (:func:`load_path`).  Both wrappers take CUDA tensors
only: they check them, raise on what the kernel does not take, launch on
the current stream and count each launch in ``LAUNCHES`` and in ``SHAPES``
(by ``(B, F, K, D)``, ``F = 1`` for the single-table entry); nothing else
moves the counts.  :func:`embedding_bag_plain` and
:func:`embedding_bag_grouped_plain` compute the same functions with torch
ops on any device, adding the ``K`` rows in the kernel's order; the CPU path
and the kernel comparisons use them.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["LAUNCHES", "SHAPES", "MAX_TABLES", "reset_launches",
           "launch_groups", "load_path", "embedding_bag_cuda",
           "embedding_bag_plain", "embedding_bag_grouped_cuda",
           "embedding_bag_grouped_plain"]

LAUNCHES = {"embedding_bag": 0}
SHAPES = collections.Counter()  # launches by (B, F, K, D)
MODES = ("sum", "mean")
DTYPES = (torch.float32, torch.bfloat16)
MAX_TABLES = 64  # tables of one launch (the kernel's parameter struct)
MAX_ITEMS = 2 ** 31  # B * F of one launch (the kernel's divider)


def reset_launches() -> None:
    LAUNCHES["embedding_bag"] = 0
    SHAPES.clear()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/embedding_bag.cu`` with its C signatures declared."""
    lib = build.load("embedding_bag")
    p, i, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.embedding_bag_launch.argtypes = [p, i64, i64, i, i, p, i64, i, i64, i,
                                         p, p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_grouped_launch.argtypes = [
        p, p, i, i64, i, i, p, i64, i64, i, i64, u32, u32, i, p, i64, p]
    lib.embedding_bag_grouped_launch.restype = ctypes.c_int
    return lib


def launch_groups(keys) -> list:
    """Launches of a grouped bag over tables keyed by ``(D, dtype)``: the
    indices of each key's tables in order, at most :data:`MAX_TABLES` a
    launch (wide-deep's 40 deep and 40 wide tables: two launches of 40)."""
    by_key = {}
    for i, key in enumerate(keys):
        by_key.setdefault(key, []).append(i)
    return [idx[s:s + MAX_TABLES] for idx in by_key.values()
            for s in range(0, len(idx), MAX_TABLES)]


def load_path(tables) -> str:
    """``"v16"`` where each row is a whole number of 16-byte chunks and
    every table starts 16-byte aligned, else ``"scalar"``."""
    row = tables[0].shape[1] * tables[0].element_size()
    if row % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tables):
        return "v16"
    return "scalar"


def _fast_divider(d: int) -> tuple:
    """``(mul, shift)`` with ``n // d == (((n * mul) >> 32) + n) >> shift``
    for ``0 <= n < 2**31`` (torch's ``IntDivider``): the kernel's ``b = w //
    F`` without a division."""
    shift = (d - 1).bit_length()  # the least s with 2**s >= d
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _check_table(table, device) -> None:
    if table.dim() != 2 or table.shape[0] < 1 or table.dtype not in DTYPES:
        raise ValueError(f"table must be a 2-D float32 or bfloat16 tensor of "
                         f"at least one row, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if table.device != device:
        raise ValueError(f"indices on {device}, table on {table.device}")


def _check_ids(indices, n_dim: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if (indices.dim() != n_dim or indices.shape[-1] < 1
            or indices.dtype != torch.int32):
        shape = "(B, K >= 1)" if n_dim == 2 else "(B, F, K >= 1)"
        raise ValueError(f"indices must be a {shape} int32 tensor, got "
                         f"{indices.dtype} {tuple(indices.shape)}")


def _check(table, indices, mode: str) -> None:
    """What both versions need: a 2-D float32/bf16 table of at least one
    row, (B, K >= 1) int32 ids on its device, and a known mode."""
    _check_ids(indices, 2, mode)
    _check_table(table, indices.device)


def _check_grouped(tables, indices, mode: str) -> None:
    """What both grouped versions need: F >= 1 tables as :func:`_check`
    takes them, of one width and dtype, and (B, F, K >= 1) int32 ids."""
    _check_ids(indices, 3, mode)
    if not tables or indices.shape[1] != len(tables):
        raise ValueError(f"indices {tuple(indices.shape)} for "
                         f"{len(tables)} tables: F must match and be >= 1")
    for t in tables:
        _check_table(t, indices.device)
    if len({(t.shape[1], t.dtype) for t in tables}) != 1:
        raise ValueError("grouped tables must share one width and dtype, got "
                         f"{sorted({(t.shape[1], str(t.dtype)) for t in tables})}")


def _check_cuda(tables, indices) -> None:
    """What the kernel takes beyond :func:`_check`: contiguous CUDA tables
    and ids with a unit K stride (any other strides)."""
    for t in tables:
        if t.device.type != "cuda":
            raise ValueError(f"table must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("table must be contiguous")
    if indices.shape[-1] > 1 and indices.stride(-1) != 1:
        raise ValueError(f"indices need a unit K stride, got strides "
                         f"{indices.stride()}")


def _counted(err: int, shape) -> None:
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["embedding_bag"] += 1
    SHAPES[shape] += 1


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """(R+1, D) table, (B, K) int32 ids -> (B, D) bag sums or means, on the
    card.  The table must be contiguous; the ids need a unit K stride (any
    bag stride, so a column of a (B, F, K) batch is read in place)."""
    _check(table, indices, mode)
    _check_cuda([table], indices)
    (B, K), (R1, D) = indices.shape, table.shape
    if B >= MAX_ITEMS:
        raise ValueError(f"B = {B} bags: one launch takes fewer than 2^31")
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().embedding_bag_launch(
            table.data_ptr(), R1, D, int(table.dtype == torch.bfloat16),
            int(load_path([table]) == "v16"), indices.data_ptr(),
            indices.stride(0), K, B, int(mode == "mean"), out.data_ptr(),
            stream)
    _counted(err, (B, 1, K, D))
    return out


def embedding_bag_grouped_cuda(tables, indices: torch.Tensor,
                               mode: str = "sum") -> torch.Tensor:
    """F tables (R_f+1, D) of one width and dtype, (B, F, K) int32 ids ->
    (B, F, D) bag sums or means, on the card: one launch per
    :data:`MAX_TABLES` tables.  Each table must be contiguous; the ids need
    a unit K stride (any bag and feature strides)."""
    tables = list(tables)
    _check_grouped(tables, indices, mode)
    _check_cuda(tables, indices)
    B, F, K = indices.shape
    D, dtype = tables[0].shape[1], tables[0].dtype
    if B * min(F, MAX_TABLES) >= MAX_ITEMS:
        raise ValueError(f"B * F = {B} * {min(F, MAX_TABLES)} bags: one "
                         "launch takes fewer than 2^31")
    out = torch.empty((B, F, D), dtype=dtype, device=tables[0].device)
    if B == 0 or D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(tables[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for group in launch_groups([(D, dtype)] * F):
            f0, n = group[0], len(group)
            ids, dst = indices[:, f0:f0 + n], out[:, f0:f0 + n]
            members = tables[f0:f0 + n]
            mul, shift = _fast_divider(n)
            err = lib.embedding_bag_grouped_launch(
                (ctypes.c_void_p * n)(*[t.data_ptr() for t in members]),
                (ctypes.c_int64 * n)(*[t.shape[0] for t in members]), n, D,
                int(dtype == torch.bfloat16),
                int(load_path(members) == "v16"), ids.data_ptr(),
                ids.stride(0), ids.stride(1), K, B, mul, shift,
                int(mode == "mean"), dst.data_ptr(), dst.stride(0), stream)
            _counted(err, (B, n, K, D))
    return out


def _row_grad(table_shape, dtype, indices, grad, mode: str) -> torch.Tensor:
    """The gradient of one table: each bag's output gradient, accumulated in
    float32 (divided by K for ``mean``) into the rows at its K clamped ids
    (the rows the forward read, the sentinel among them), cast once to the
    table's dtype.  ``index_add_``: deterministic on the card only under
    ``torch.use_deterministic_algorithms(True)``."""
    B, K = indices.shape
    g = grad.float()
    if mode == "mean":
        g = g / K
    ids = indices.clamp(0, table_shape[0] - 1).reshape(-1).long()
    acc = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    acc.index_add_(0, ids, g[:, None, :].expand(B, K, g.shape[-1]).reshape(
        B * K, g.shape[-1]))
    return acc.to(dtype)


class _Bag(torch.autograd.Function):
    """:func:`embedding_bag_cuda` under autograd (the kernel has no
    backward of its own; the reference's has none either: XLA scatters)."""

    @staticmethod
    def forward(ctx, table, indices, mode):
        ctx.save_for_backward(indices)
        ctx.meta = (tuple(table.shape), table.dtype, mode)
        return embedding_bag_cuda(table, indices, mode)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (indices,) = ctx.saved_tensors
        shape, dtype, mode = ctx.meta
        return _row_grad(shape, dtype, indices, grad, mode), None, None


class _BagGrouped(torch.autograd.Function):
    """:func:`embedding_bag_grouped_cuda` under autograd: table f's
    gradient is :func:`_row_grad` of output column f at id column f."""

    @staticmethod
    def forward(ctx, indices, mode, *tables):
        ctx.save_for_backward(indices)
        ctx.meta = ([(tuple(t.shape), t.dtype) for t in tables], mode)
        return embedding_bag_grouped_cuda(tables, indices, mode)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        metas, mode = ctx.meta
        return (None, None) + tuple(
            _row_grad(shape, dtype, indices[:, f], grad[:, f], mode)
            if ctx.needs_input_grad[2 + f] else None
            for f, (shape, dtype) in enumerate(metas))


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of :func:`embedding_bag_cuda` (any device):
    clamp, ``index_select``, a float32 sum over ``k = 0..K-1`` in order,
    ``/ K`` for ``mean``, one cast."""
    _check(table, indices, mode)
    B, K = indices.shape
    ids = indices.clamp(0, table.shape[0] - 1).reshape(-1)
    rows = table.index_select(0, ids).reshape(B, K, table.shape[1]).float()
    acc = rows[:, 0]
    for k in range(1, K):
        acc = acc + rows[:, k]
    if mode == "mean":
        acc = acc / K
    return acc.to(table.dtype)


def embedding_bag_grouped_plain(tables, indices: torch.Tensor,
                                mode: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of :func:`embedding_bag_grouped_cuda` (any
    device): :func:`embedding_bag_plain` per table, stacked in order."""
    tables = list(tables)
    _check_grouped(tables, indices, mode)
    return torch.stack([embedding_bag_plain(t, indices[:, f], mode)
                        for f, t in enumerate(tables)], dim=1)
