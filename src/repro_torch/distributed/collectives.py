"""The port's collectives, and their byte accounting (``repro.distributed
.collectives``).

The reference parses the per-device HLO of a compiled program for its
all-gathers, all-reduces, ... (``parse_collective_bytes``).  Torch issues
each collective from Python, so the port counts them where they are issued:
every collective of the SPMD path goes through :func:`all_reduce_sum` or
:func:`all_gather_cat`, and each adds ``(op, bytes)`` to the
:class:`CollectiveLog` that :func:`recording` installs.  ``bytes`` is the
size of the tensor the rank reduces, or of the gathered output, as the
reference reads the HLO result shapes: per-rank bytes.

Link-traffic model (ring algorithms, the reference's approximations):
  all-reduce         ~ 2 x bytes  (reduce-scatter + all-gather phases)
  all-gather         ~ 1 x output bytes
  reduce-scatter     ~ 1 x input bytes
  all-to-all         ~ 1 x bytes
  collective-permute ~ 1 x bytes

A group of one rank moves nothing: both helpers return their input and log
nothing.  Under ``gloo`` a CUDA tensor crosses through pinned host memory,
staged here: that is the gloo transport (it reduces on the host), not a
move of the computation off the card.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["CollectiveLog", "recording", "all_reduce_sum", "all_gather_cat",
           "collective_link_bytes"]

_FACTORS = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}


def collective_link_bytes(bytes_by_op: dict) -> float:
    """Apply the ring-traffic factors (module docstring)."""
    return sum(_FACTORS.get(op, 1.0) * b for op, b in bytes_by_op.items())


class CollectiveLog:
    """``(op, bytes)`` of every collective issued while it records."""

    def __init__(self):
        self.ops: list[tuple[str, int]] = []

    def add(self, op: str, nbytes: int) -> None:
        self.ops.append((op, int(nbytes)))

    def summary(self) -> dict:
        """The reference's ``parse_collective_bytes`` dict: bytes and counts
        by op, their total, and the ring-model link bytes."""
        totals, counts = defaultdict(int), defaultdict(int)
        for op, n in self.ops:
            totals[op] += n
            counts[op] += 1
        return {
            "bytes_by_op": dict(totals),
            "counts_by_op": dict(counts),
            "total_bytes": int(sum(totals.values())),
            "link_bytes": int(collective_link_bytes(totals)),
        }


_ACTIVE: contextvars.ContextVar[Optional[CollectiveLog]] = \
    contextvars.ContextVar("collective_log", default=None)


@contextlib.contextmanager
def recording(log: Optional[CollectiveLog] = None):
    """Log the collectives this thread issues in the ``with`` body."""
    log = CollectiveLog() if log is None else log
    token = _ACTIVE.set(log)
    try:
        yield log
    finally:
        _ACTIVE.reset(token)


def _record(op: str, nbytes: int) -> None:
    log = _ACTIVE.get()
    if log is not None:
        log.add(op, nbytes)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``t`` over ``group``, as a new tensor
    (``jax.lax.psum``)."""
    if dist.get_world_size(group) == 1:
        return t
    _record("all-reduce", t.numel() * t.element_size())
    if _staged(t, group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along dim 0 in group
    rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    _record("all-gather", n * t.numel() * t.element_size())
    src = t.contiguous()
    if _staged(src, group):
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
