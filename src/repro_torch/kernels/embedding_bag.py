"""CUDA EmbeddingBag kernel: ctypes wrapper and its plain PyTorch version.

``csrc/embedding_bag.cu`` replaces ``embedding_bag_pallas``
(``src/repro/kernels/embedding_bag.py``): a fixed-arity bag of ``K`` ids per
row looked up in a ``(R+1, D)`` table whose row ``R`` is the zero sentinel,
summed (or averaged over ``K``) in float32 and cast once to the table's
type.  Ids are clamped into ``[0, R]``, as the recsys models' own lookup
clamps them (``jnp.take(..., mode="clip")``).

:func:`embedding_bag_cuda` takes CUDA tensors only: it checks them, raises
on what the kernel does not take, launches on the current stream and counts
the launch in ``LAUNCHES`` (and in ``SHAPES``, by ``(B, K, D)``); nothing
else moves the counts.  :func:`embedding_bag_plain` computes the same
function with torch ops on any device, adding the ``K`` rows in the same
order as the kernel; the CPU path and the kernel comparisons use it.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["LAUNCHES", "SHAPES", "reset_launches", "embedding_bag_cuda",
           "embedding_bag_plain"]

LAUNCHES = {"embedding_bag": 0}
SHAPES = collections.Counter()  # launches by (B, K, D)
MODES = ("sum", "mean")
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    LAUNCHES["embedding_bag"] = 0
    SHAPES.clear()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/embedding_bag.cu`` with its C signature declared."""
    lib = build.load("embedding_bag")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.embedding_bag_launch.argtypes = [p, i64, i64, i, p, i64, i, i64, i, p,
                                         p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    return lib


def _check(table, indices, mode: str) -> None:
    """What both versions need: a 2-D float32/bf16 table of at least one
    row, (B, K >= 1) int32 ids on its device, and a known mode."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or table.shape[0] < 1 or table.dtype not in DTYPES:
        raise ValueError(f"table must be a 2-D float32 or bfloat16 tensor of "
                         f"at least one row, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if indices.dim() != 2 or indices.shape[1] < 1 or indices.dtype != torch.int32:
        raise ValueError(f"indices must be a (B, K >= 1) int32 tensor, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if indices.device != table.device:
        raise ValueError(f"indices on {indices.device}, table on "
                         f"{table.device}")


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """(R+1, D) table, (B, K) int32 ids -> (B, D) bag sums or means, on the
    card.  The table must be contiguous; the ids need a unit K stride (any
    bag stride, so a column of a (B, F, K) batch is read in place)."""
    _check(table, indices, mode)
    if table.device.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if indices.shape[1] > 1 and indices.stride(1) != 1:
        raise ValueError(f"indices need a unit K stride, got strides "
                         f"{indices.stride()}")
    (B, K), (R1, D) = indices.shape, table.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().embedding_bag_launch(
            table.data_ptr(), R1, D, int(table.dtype == torch.bfloat16),
            indices.data_ptr(), indices.stride(0), K, B, int(mode == "mean"),
            out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["embedding_bag"] += 1
    SHAPES[(B, K, D)] += 1
    return out


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
