"""Multi-pod dry run (``repro.launch.dryrun``).

For every (architecture x input-shape) cell, lay the step's arguments out on
the production mesh — 16x16 (256 ranks) and 2x16x16 (512 ranks, multi-pod)
— as ``DTensor``s over ``meta`` local shards, run the step once, and record
the bytes each rank holds, the FLOPs it computes and the collectives it
issues.  A failure here (a spec that does not divide, an op no layout can
run) is a fault of the system, not of the harness.

The world is fake: a ``fake`` process group of 256 or 512 ranks over
``torch.testing._internal.distributed.fake_pg.FakeStore`` (a private torch
module; the run fails if it cannot be imported), in which this process is
rank 0 and every collective returns at once.  The default process group is
process-global, so each production mesh runs in a spawned process of its
own.  Nothing is allocated: every tensor is ``meta``.

What a record holds (the reference's keys wherever the port computes the
same quantity):
  * ``arg_bytes_per_chip`` / ``out_bytes_per_chip``: the bytes of rank 0's
    local shards of the arguments, and of the outputs once placed by the
    cell's out specs;
  * ``collectives``: :meth:`CollectiveLog.summary` of every collective the
    rank issued (the step under ``CommDebugMode``; bytes are the result
    tensor's, as the reference reads the HLO's result shapes);
  * ``model_flops_per_chip``: the cell's analytic FLOPs;
  * ``counted_flops_per_rank``: ``torch.utils.flop_counter``'s formulas over
    the local ops the rank runs (counted below ``DTensor``: a counter
    around ``DTensor`` ops counts the global product);
  * ``trace_s``: the step's wall time in the fake world (host only);
  * ``notes``: the cell's, and every op the step redistributed explicitly.
XLA's ``compile_s``, ``temp_bytes_per_chip``, ``hlo_flops_per_chip`` and
``hlo_bytes_per_chip`` have no counterpart and are left out.  So is a peak
of a rank's bytes: ``torch.distributed._tools.mem_tracker.MemTracker`` over
the meta shards of the fake world reads values that differ between torch
releases by up to 64x for the same cell, so it does not measure the peak;
the allocator's peak of a world of one on the card (``--mesh one``) does.

Ops ``DTensor`` cannot run as laid out are redistributed explicitly here
(:class:`_Explicit`), each named in the cell's notes and its collectives
counted: a lookup along a sharded dim (an embedding row, a gathered
log-prob, a node's features) either all-gathers the table or takes each
rank's own rows and all-reduces them, whichever moves fewer bytes; an
``index_add`` into a buffer the sources do not shard is summed per rank and
left partial.

``--mesh one`` runs a cell in a world of one (nccl on the card, gloo with
``--device cpu``) on a (1, 1) mesh over real tensors: floats drawn from a
seeded ``torch.Generator``, integers 0 (a valid id for every lookup, an
empty trie row) unless the caller passes them (:func:`run_one`).  It times
the step after a warm-up call and records the argument bytes the allocator
holds beside what the same cell predicts at (1, 1), and the allocator's
peak.  On the card a cell whose step reaches decode attention raises there
(its kernel takes no ``DTensor``; ``launch/steps.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape long_500k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch static-gr \\
      --shape gr_serve_constrained --mesh one            # on the card
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import CollectiveLog
from repro_torch.launch.mesh import MeshSpec, _mesh, production_spec
from repro_torch.launch.steps import build_cell, list_cells
from repro_torch.models.kvcache import KVCache, MLACache

__all__ = ["run_cell", "run_one", "place", "main"]

aten = torch.ops.aten

MESH_NAMES = {False: "16x16", True: "2x16x16"}

# funcol ops -> the reference's HLO collective names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}


# --------------------------------------------------------------------------
# The fake world
# --------------------------------------------------------------------------


def fake_world(n_ranks: int) -> None:
    """Make this process rank 0 of a fake world of ``n_ranks``."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - a torch without it
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _device_mesh(spec: MeshSpec, device_type: str = "cpu"):
    return _mesh(spec.shape, spec.mesh_dim_names, device_type)


# --------------------------------------------------------------------------
# Arguments as DTensors
# --------------------------------------------------------------------------


def _placements(spec, mesh):
    """:func:`sharding.placements`, with a mesh dim of size 1 replicated
    (it shards nothing, and a world of one then runs no lookup handler)."""
    pl = sh.placements(spec, mesh)
    return tuple(Replicate() if mesh.size(i) == 1 else p
                 for i, p in enumerate(pl))


def _local_shape(shape, placements, mesh) -> tuple:
    shape = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} ({n})")
            shape[p.dim] //= n
    return tuple(shape)


def _map(fn, tree, spec):
    """``fn(leaf, spec)`` over an argument tree and its spec tree (dicts,
    lists, tuples; a KV cache's arrays by its spec dict's field names)."""
    if isinstance(tree, (KVCache, MLACache)):
        return dataclasses.replace(tree, **{
            k: fn(getattr(tree, k), s) for k, s in spec.items()
            if isinstance(getattr(tree, k), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, spec))
    return fn(tree, spec)


def _leaves(tree) -> list:
    if isinstance(tree, (KVCache, MLACache)):
        return [v for v in vars(tree).values() if isinstance(v, torch.Tensor)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def place(args, specs, mesh, local=None):
    """The argument trees as ``DTensor``s on ``mesh``: each leaf's local
    shard is ``local(leaf, local_shape)`` (``meta`` by default)."""
    local = local or (lambda t, shape: torch.empty(
        shape, dtype=t.dtype, device="meta"))

    def one(t, spec):
        pl = _placements(spec, mesh)
        loc = local(t, _local_shape(t.shape, pl, mesh))
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tuple(_map(one, a, s) for a, s in zip(args, specs))


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for t in _leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _placed_outputs(out, specs, mesh):
    """The step's outputs redistributed to the cell's out specs."""
    def one(t, spec):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, _placements(spec, mesh))

    return _map(one, out, specs)


# --------------------------------------------------------------------------
# Counting below DTensor
# --------------------------------------------------------------------------


class _Counter(CommDebugMode):
    """``CommDebugMode`` that also logs each collective's result bytes into
    a :class:`CollectiveLog` and sums the FLOPs of the local ops the rank
    runs (``DTensor`` ops fall through to ``DTensor``, whose local ops and
    collectives come back here)."""

    def __init__(self):
        super().__init__()
        self.log = CollectiveLog()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator) or any(
                issubclass(t, FakeTensor) for t in types):
            # FakeTensors: DTensor's sharding propagation inferring an
            # op's output shapes the first time it meets the op
            return out
        packet = func._overloadpacket
        name = _COLLECTIVES.get(packet.__name__)
        if name is not None:
            res = out[0] if isinstance(out, (list, tuple)) else out
            self.log.add(name, res.numel() * res.element_size())
        elif packet in flop_registry:
            if func is aten.bmm.dtype:  # its formula takes no out_dtype
                args = args[:2]
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        return out


def _reduced(t):
    """``t`` with every ``Partial`` placement reduced (an all-reduce)."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def _as_dtensor(t, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sharded_along(t, dim) -> list:
    """Mesh dims that shard ``t``'s dim ``dim``."""
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def _lookup(table, dim, index, op):
    """``op(table, dim, index)`` (``torch.gather`` along ``dim``, or a
    dim-0 row lookup) where ``table`` is sharded along ``dim``.

    Either all-gather the table along ``dim`` and look up locally, or take
    each rank's own entries (others 0) and all-reduce the result, whichever
    moves fewer bytes per rank.  The second needs the index replicated over
    the mesh dims that shard the table, and the table sharded along
    nothing else."""
    mesh = table.device_mesh
    table, index = _reduced(table), _reduced(_as_dtensor(index, mesh))
    along = _sharded_along(table, dim)
    gathered = [Replicate() if i in along else p
                for i, p in enumerate(table.placements)]
    masked_ok = (all(isinstance(table.placements[i], Replicate) or i in along
                     for i in range(mesh.ndim))
                 and all(not isinstance(index.placements[i], Shard)
                         for i in along))
    n_along = math.prod(mesh.size(i) for i in along)
    t_loc = table.to_local()
    gather_bytes = t_loc.numel() * t_loc.element_size() * n_along
    out_numel = (index.to_local().numel() if op == "gather"
                 else index.to_local().numel() * math.prod(t_loc.shape[1:]))
    reduce_bytes = out_numel * t_loc.element_size()
    if not masked_ok or gather_bytes <= reduce_bytes:
        return _apply(op, table.redistribute(mesh, gathered), dim, index)
    # each rank's own block of ``dim``: rows [off, off + n)
    n = t_loc.shape[dim]
    block = 0
    for i in along:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    ids = index.to_local().long() - block * n
    hit = (ids >= 0) & (ids < n)
    part = _apply(op, t_loc, dim, ids.clamp(0, n - 1))
    mask = hit if op == "gather" else hit.reshape(
        hit.shape + (1,) * (t_loc.dim() - 1))
    part = part * mask.to(part.dtype)
    out_pl = [Partial() if i in along else index.placements[i]
              for i in range(mesh.ndim)]
    shape = (index.shape if op == "gather"
             else tuple(index.shape) + tuple(table.shape[1:]))
    out = DTensor.from_local(part, mesh, out_pl, run_check=False,
                             shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    return _reduced(out)


def _apply(op, table, dim, index):
    if op == "gather":
        return torch.gather(table, dim, index)
    return table.index_select(0, index.reshape(-1)).reshape(
        tuple(index.shape) + tuple(table.shape[1:]))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


_LOCAL_NAME = ("lookup by ids sharded over several mesh dims, on each "
               "rank's shards (no DTensor strategy)")


_PRODUCTS = (aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default)


class _Explicit(TorchDispatchMode):
    """Explicit redistributions for ops whose ``DTensor`` layout fails or
    is not the one a sharded program runs; ``used`` names each op that
    took one."""

    def __init__(self):
        super().__init__()
        self.used: set[str] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        run = self._handler(func, args)
        if run is None:
            return NotImplemented
        name, fn = run
        out = fn()
        if isinstance(out, _AsIs):  # it needed no redistribution after all
            return out.value
        self.used.add(name)
        return out

    def _handler(self, func, args):
        self_ = args[0] if args else None
        if not isinstance(self_, DTensor):
            return None
        rows = _row_lookup(func, args)
        if rows is not None:
            table, ids = rows
            if _local_rows_ok(table, ids):
                return (_LOCAL_NAME,
                        lambda: _local_lookup(table, 0, ids, "rows"))
            if _sharded_along(table, 0):
                return ("row lookup of a row-sharded table",
                        lambda: _lookup(table, 0, ids, "rows"))
        if func is aten.gather.default:
            dim, index = args[1] % self_.dim(), args[2]
            if _sharded_along(self_, dim) or any(
                    p.is_partial() for p in self_.placements):
                return ("gather along a sharded or partial dim",
                        lambda: _lookup(self_, dim, index, "gather"))
            if _hybrid(self_) or _hybrid(index):
                return (_LOCAL_NAME,
                        lambda: _local_lookup(self_, dim, index, "gather"))
        if func is aten.bmm.dtype:
            return ("batched product with a float32 result (no DTensor "
                    "strategy: on each rank's batch shard, or on float32 "
                    "operands)", lambda: _bmm_to(*args))
        if func in _PRODUCTS:
            return ("partial sums of a sharded contraction all-reduced at "
                    "once", lambda: _reduced_or_as_is(func(*args)))
        if func in (aten.view.default, aten._unsafe_view.default):
            uneven = _uneven_split(self_, args[1])
            if uneven:
                return ("view splitting a sharded dim unevenly (all-gathered "
                        "first)",
                        lambda: func(self_.redistribute(
                            self_.device_mesh,
                            [Replicate() if i in uneven else p
                             for i, p in enumerate(self_.placements)]),
                            args[1]))
            inner = _inner_sharded(self_, args[1])
            if inner:
                return ("view merging a sharded dim into the one before it "
                        "(all-gathered first)",
                        lambda: func(self_.redistribute(
                            self_.device_mesh,
                            [Replicate() if i in inner else p
                             for i, p in enumerate(self_.placements)]),
                            args[1]))
        if (func is aten.index_put.default and _leading_index(args[1])
                and isinstance(args[2], DTensor)):
            return ("index_put over unsharded trailing dims, on each rank's "
                    "batch shard (no DTensor strategy)",
                    lambda: _local_index_put(*args))
        if (func is aten.index_add.default
                and _splits_sources(*args[:4])):
            return ("index_add into an unsharded buffer (summed per rank, "
                    "left partial)",
                    lambda: _index_add(*args))
        return None


def _row_lookup(func, args):
    """``(table, ids)`` of a dim-0 row lookup (``embedding``, ``t[ids]``,
    ``index_select(0, ids)``), else ``None``."""
    if func is aten.embedding.default:
        return args[0], args[1]
    if (func is aten.index.Tensor and len(args[1]) == 1
            and args[1][0] is not None):
        return args[0], args[1][0]
    if func is aten.index_select.default and args[1] == 0:
        return args[0], args[2]
    return None


def _local_rows_ok(table, index) -> bool:
    """A row lookup each rank can do alone: the table replicated (and not
    partial) on every mesh dim, the ids sharded over several mesh dims."""
    return (all(isinstance(p, Replicate) for p in table.placements)
            and _hybrid(index))


def _hybrid(t) -> bool:
    """Whether a tensor dim of ``t`` is sharded over two or more mesh dims
    (``[Shard(0), Shard(0), ...]``), for which some torch releases have no
    ``DTensor`` strategy for lookups."""
    dims = [p.dim for p in getattr(t, "placements", ()) if isinstance(p, Shard)]
    return len(dims) != len(set(dims))


def _local_lookup(table, dim, index, op):
    """``op`` (see :func:`_lookup`) on each rank's shards, no collective:
    ``table`` sharded nowhere along ``dim``, and ``index`` sharded like the
    output (a row lookup: as the ids; a gather: as ``table``)."""
    mesh = table.device_mesh
    index = _as_dtensor(index, mesh)
    if op == "gather":
        index = index.redistribute(mesh, table.placements)
        out_pl = table.placements
        shape = index.shape
    else:
        out_pl = index.placements
        shape = tuple(index.shape) + tuple(table.shape[1:])
    part = _apply(op, table.to_local(), dim, index.to_local().long())
    return DTensor.from_local(part, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


class _AsIs:
    """A handler's result that took no redistribution."""

    def __init__(self, value):
        self.value = value


def _reduced_or_as_is(out):
    return (_reduced(out) if any(p.is_partial() for p in out.placements)
            else _AsIs(out))


def _view_groups(t, shape):
    """``(shape, [(input dims, output dims), ...])`` of a view of ``t``:
    the runs of dims whose sizes multiply to the same number, in order."""
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = t.numel() // max(known, 1)
    in_shape, groups, i, j = list(t.shape), [], 0, 0
    while i < len(in_shape) and j < len(shape):
        a, b, start_i, start_j = in_shape[i], shape[j], i, j
        while a != b:
            if a < b:
                i += 1
                a *= in_shape[i]
            else:
                j += 1
                b *= shape[j]
        groups.append((range(start_i, i + 1), range(start_j, j + 1)))
        i, j = i + 1, j + 1
    return shape, groups


def _uneven_split(t, shape) -> list:
    """Mesh dims whose shard of ``t`` a view to ``shape`` would split
    unevenly: a sharded dim split into several, the leading one of which
    the mesh dims' sizes do not divide."""
    shape, groups = _view_groups(t, shape)
    bad = []
    for ins, outs in groups:
        for d in ins:
            mesh_dims = _sharded_along(t, d)
            n = math.prod(t.device_mesh.size(m) for m in mesh_dims)
            if mesh_dims and shape[outs[0]] % n:
                bad += mesh_dims
    return bad


def _inner_sharded(t, shape) -> list:
    """Mesh dims that shard a dim a view to ``shape`` merges into the dim
    before it.  Some torch releases refuse such a view; others make a
    strided shard of it, whose sharding propagation on a 3-D mesh takes
    minutes an op: the harness gathers the dim first on every release."""
    _, groups = _view_groups(t, shape)
    return [m for ins, _ in groups if len(ins) > 1
            for d in list(ins)[1:] for m in _sharded_along(t, d)]


def _bmm_to(a, b, out_dtype):
    """``torch.bmm(a, b, out_dtype=out_dtype)``: on each rank's shards
    when both operands are replicated or split along the batch dim alike,
    else as the product of the operands cast to ``out_dtype``."""
    mesh = a.device_mesh
    a, b = _reduced(a), _reduced(_as_dtensor(b, mesh))
    if a.placements == b.placements and all(
            isinstance(p, Replicate) or p == Shard(0) for p in a.placements):
        part = _bmm_local(a.to_local(), b.to_local(), out_dtype)
        shape = (a.shape[0], a.shape[1], b.shape[2])
        return DTensor.from_local(part, mesh, a.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return _reduced(torch.bmm(a.to(out_dtype), b.to(out_dtype)))


def _bmm_local(a, b, out_dtype):
    """``aten.bmm.dtype`` on local shards; the CPU has no kernel for it, so
    there the operands are cast first (the products of bf16 or half values
    are exact in float32)."""
    if a.device.type == "cpu":
        return torch.bmm(a.to(out_dtype), b.to(out_dtype))
    return aten.bmm.dtype(a, b, out_dtype)


def _leading_index(indices) -> int:
    """``k`` when ``indices`` is ``k >= 1`` ``None``s, then index tensors
    only (``x[:, i, j]``); else 0."""
    k = 0
    while k < len(indices) and indices[k] is None:
        k += 1
    rest = indices[k:]
    return k if k and rest and all(i is not None for i in rest) else 0


def _local_index_put(self_, indices, values, accumulate=False):
    """``self.index_put(indices, values)`` with ``None`` over the leading
    dims: ``self`` takes ``values``' sharding of those dims (a local slice
    of a replicated dim) and each rank puts its own rows."""
    mesh = self_.device_mesh
    k = _leading_index(indices)
    values = _reduced(values)
    if any(isinstance(p, Shard) and p.dim >= k for p in values.placements):
        raise NotImplementedError("index_put values sharded past the "
                                  "leading dims")
    self_ = _reduced(self_).redistribute(mesh, values.placements)
    idx = [None if i is None else _as_dtensor(i, mesh).full_tensor().long()
           for i in indices]
    part = aten.index_put.default(self_.to_local(), idx, values.to_local(),
                                  accumulate)
    return DTensor.from_local(part, mesh, values.placements, run_check=False,
                              shape=self_.shape, stride=self_.stride())


def _splits_sources(buf, dim, index, source) -> bool:
    """Whether some mesh dim shards ``index_add``'s index or sources."""
    return any(isinstance(t, DTensor) and any(
        isinstance(p, Shard) for p in t.placements) for t in (index, source))


def _index_add(buf, dim, index, source, alpha=1):
    """``buf.index_add(dim, index, source)``: each rank adds its own
    sources into a zero copy of the buffer; the sum over the ranks that
    split the sources is ``Partial`` (``buf`` is added back once)."""
    mesh = buf.device_mesh
    buf, index, source = (_reduced(buf), _reduced(_as_dtensor(index, mesh)),
                          _reduced(_as_dtensor(source, mesh)))
    split = [i for i in range(mesh.ndim)
             if isinstance(index.placements[i], Shard)
             or isinstance(source.placements[i], Shard)]
    want = [Replicate() if i in split else p
            for i, p in enumerate(buf.placements)]
    buf = buf.redistribute(mesh, want)
    if not all(isinstance(buf.placements[i], Replicate) for i in split):
        raise NotImplementedError("index_add into a buffer sharded where "
                                  "its sources are")
    part = torch.zeros_like(buf.to_local()).index_add(
        dim, index.to_local().long(), source.to_local(), alpha=alpha)
    out = DTensor.from_local(
        part, mesh, [Partial() if i in split else p
                     for i, p in enumerate(buf.placements)],
        run_check=False, shape=buf.shape, stride=buf.stride())
    return buf + out


# --------------------------------------------------------------------------
# Running a cell
# --------------------------------------------------------------------------


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


@contextlib.contextmanager
def _stepping(count: bool = True):
    """What a step over ``DTensor`` arguments runs under: the explicit
    redistributions, plain tensors made inside the step taken as
    replicated, and (``count``) the :class:`_Counter`; yields ``(counter or
    None, explicit)``."""
    from torch.distributed.tensor.experimental import implicit_replication

    with contextlib.ExitStack() as stack:
        counter = stack.enter_context(_Counter()) if count else None
        explicit = stack.enter_context(_Explicit())
        stack.enter_context(implicit_replication())
        yield counter, explicit


def _trace(cell, dargs, mesh):
    """Run the step once over ``dargs``: ``(outputs placed by the out
    specs, counter, ops redistributed explicitly, seconds)``."""
    t0 = time.perf_counter()
    with _stepping() as (counter, explicit):
        out = cell.fn(*dargs)
        out = _placed_outputs(out, cell.out_specs, mesh)
    seconds = time.perf_counter() - t0
    return out, counter, sorted(explicit.used), seconds


def _with_notes(cell, used) -> str:
    """The cell's notes, naming the ops :class:`_Explicit` took over."""
    if used:
        cell.notes = "; ".join(filter(None, [
            cell.notes, "explicit layouts: " + ", ".join(used)]))
    return cell.notes


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             verbose: bool = True, *, mesh=None, cfg_overrides=None,
             bundle=None) -> dict:
    """One cell's record on the production mesh (or on ``mesh``, a
    ``DeviceMesh`` over the world's first ranks); the world must exist
    and hold the mesh's ranks (:func:`fake_world`)."""
    if mesh is None:
        mesh = _device_mesh(production_spec(multi_pod=multi_pod))
    cell = build_cell(arch, shape, mesh, cfg_overrides, bundle)
    dargs = place(cell.args, cell.in_specs, mesh)
    out, counter, used, trace_s = _trace(cell, dargs, mesh)
    coll = counter.log.summary()
    if sum(coll["counts_by_op"].values()) != counter.get_total_counts():
        raise AssertionError(f"collectives logged {coll['counts_by_op']} "
                             f"!= CommDebugMode's {counter.get_comm_counts()}")
    rec = {
        "arch": arch,
        "shape": shape,
        "kind": cell.kind,
        "mesh": _mesh_name(mesh),
        "chips": mesh.size(),
        "ok": True,
        "trace_s": round(trace_s, 3),
        "arg_bytes_per_chip": local_bytes(dargs),
        "out_bytes_per_chip": local_bytes(out),
        "collectives": coll,
        "model_flops_per_chip": float(cell.model_flops_per_chip),
        "counted_flops_per_rank": int(counter.flops),
        "notes": _with_notes(cell, used),
    }
    if verbose:
        print(f"[{rec['mesh']}] {arch} x {shape} ({cell.kind}): "
              f"trace {trace_s:.1f}s")
        print(f"  bytes/rank: args {rec['arg_bytes_per_chip']/1e9:.3f} GB, "
              f"out {rec['out_bytes_per_chip']/1e9:.3f} GB; "
              f"{rec['counted_flops_per_rank']/1e9:.1f} GFLOP/rank counted, "
              f"{rec['model_flops_per_chip']/1e9:.1f} model")
        print(f"  collectives: {coll['counts_by_op']} "
              f"link_bytes/rank {coll['link_bytes']/1e6:.1f} MB")
    return rec


def materializer(seed: int, device):
    """``local(t, shape)`` for :func:`place`: floats ~ N(0, 0.02) from a
    seeded generator on ``device``, integers 0, booleans True."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def local(t, shape):
        if t.dtype.is_floating_point:
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * 0.02
            return x.to(t.dtype)
        if t.dtype == torch.bool:
            return torch.ones(shape, dtype=t.dtype, device=device)
        return torch.zeros(shape, dtype=t.dtype, device=device)

    return local


def _allocated(nbytes: int) -> int:
    """What the CUDA caching allocator holds for ``nbytes``: blocks are
    multiples of 512 bytes."""
    return max(512, -(-nbytes // 512) * 512)


def run_one(arch: str, shape: str, device=None, *, cfg_overrides=None,
            bundle=None, args: dict | None = None, seed: int = 0,
            iters: int = 1, materialize: bool = True) -> dict:
    """One cell in a world of one on a (1, 1) mesh over real tensors.

    ``args`` maps argument positions to trees of real tensors that take the
    place of the drawn ones (``chip_smoke.py`` passes the real trie and
    beam nodes; each leaf must have the cell's shape).  The record holds
    ``arg_bytes_per_chip`` over the real arguments beside
    ``arg_bytes_predicted``, the same cell placed at (1, 1) over meta; on
    the card, the allocator's bytes for the drawn arguments
    (``arg_bytes_allocated``) beside their sizes each rounded up to the
    allocator's 512-byte blocks (``arg_bytes_predicted_allocated``);
    ``counted_flops_per_rank`` on the real tensors beside
    ``counted_flops_fake`` on the meta ones; the step's median ms over
    ``iters`` timed calls after a warm-up call (CUDA events around the
    call: the host's dispatch included); and, on the card, the allocator's
    peak bytes.
    ``outputs`` are the last call's — the warm-up call's at ``iters=0``
    (a train step updates its arguments in place at every call).
    ``materialize=False`` stops after the meta trace: the predicted bytes
    (``out_bytes_predicted`` too) and FLOPs only, nothing allocated."""
    from repro_torch import resolve_device
    from repro_torch.launch.mesh import world

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev.index or 0)  # before the world's mesh
    with world(dev):
        mesh = _mesh((1, 1), ("data", "model"), dev.type)
        cell = build_cell(arch, shape, mesh, cfg_overrides, bundle)
        fake_args = place(cell.args, cell.in_specs, mesh)
        fake_out, fake_counter, _, _ = _trace(cell, fake_args, mesh)
        predicted = {"arch": arch, "shape": shape, "kind": cell.kind,
                     "mesh": "1x1", "chips": 1,
                     "arg_bytes_predicted": local_bytes(fake_args),
                     "out_bytes_predicted": local_bytes(fake_out),
                     "model_flops_per_chip": float(cell.model_flops_per_chip),
                     "counted_flops_fake": int(fake_counter.flops)}
        if not materialize:
            return predicted
        if cuda:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
        given = args or {}
        draw = materializer(seed, dev)
        dargs = [place((given.get(i, a),), (s,), mesh,
                       local=_given if i in given else draw)[0]
                 for i, (a, s) in enumerate(zip(cell.args, cell.in_specs))]
        drawn = [a for i, a in enumerate(dargs) if i not in given]
        rec = dict(predicted, ok=True, device=str(dev),
                   arg_bytes_per_chip=local_bytes(dargs))
        if cuda:
            torch.cuda.synchronize()
            rec["arg_bytes_allocated"] = torch.cuda.memory_allocated() - before
            rec["arg_bytes_predicted_allocated"] = sum(
                _allocated(t.to_local().numel() * t.element_size())
                for t in _leaves(drawn))
            torch.cuda.reset_peak_memory_stats()
        out, counter, used, _ = _trace(cell, dargs, mesh)  # warm-up
        rec["counted_flops_per_rank"] = int(counter.flops)
        rec["collectives"] = counter.log.summary()
        times = []
        for _ in range(iters):
            del out
            with _stepping(count=False):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = cell.fn(*dargs)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                else:
                    t0 = time.perf_counter()
                    out = cell.fn(*dargs)
                    times.append((time.perf_counter() - t0) * 1e3)
        rec["step_ms"] = sorted(times)[len(times) // 2] if times else None
        rec["step_ms_all"] = times
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["out_bytes_per_chip"] = local_bytes(out)
        rec["notes"] = _with_notes(cell, used)
        rec["outputs"] = out
        rec["args"] = dargs
    return rec


def _given(t, shape):
    """``local`` for :func:`place` over a tree of real tensors at (1, 1):
    each leaf is its own shard."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"argument leaf {tuple(t.shape)} is not the "
                         f"shard {tuple(shape)}")
    return t


# --------------------------------------------------------------------------
# Command line
# --------------------------------------------------------------------------


def _sweep(multi_pod: bool, cells: list, out_path: str, verbose: bool,
           cfg_overrides: dict):
    """Run ``cells`` on one production mesh in this (spawned) process and
    append their records to ``out_path``; returns the failures."""
    spec = production_spec(multi_pod=multi_pod)
    fake_world(spec.size())
    n_fail = 0
    try:
        mesh = _device_mesh(spec)
        for arch, shape in cells:
            over = cfg_overrides.get(arch)
            try:
                rec = run_cell(arch, shape, multi_pod, verbose, mesh=mesh,
                               cfg_overrides=over)
                if over:
                    rec["cfg_overrides"] = over
            except Exception as e:  # noqa: BLE001 - recorded as a failure
                n_fail += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": MESH_NAMES[multi_pod], "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {arch} x {shape} @ {rec['mesh']}: "
                      f"{rec['error']}")
                traceback.print_exc()
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
    finally:
        dist.destroy_process_group()
    return n_fail


def _sweep_proc(result, *args):
    result.put(_sweep(*args))


def sweep(cells_by_mesh: dict, out_path: str, verbose: bool = True,
          workers: int = 1, cfg_overrides: dict | None = None) -> int:
    """Each production mesh's cells over ``workers`` spawned processes of
    its own (a fake world is process-global; each process makes one), all
    side by side, prefill cells dealt first (the longest); returns the
    number of failed cells (a process that dies fails all of its cells).
    ``cfg_overrides`` maps an architecture to its cells' config overrides
    (a cut depth), written into their records.  The processes are daemons
    (they end with the caller)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    procs = []
    for multi, cells in cells_by_mesh.items():
        order = sorted(cells, key=lambda c: "prefill" not in c[1])
        for w in range(workers):
            part = order[w::workers]
            if part:
                p = ctx.Process(target=_sweep_proc, daemon=True,
                                args=(result, multi, part, out_path, verbose,
                                      cfg_overrides or {}))
                p.start()
                procs.append((p, part))
    for p, _ in procs:
        p.join()
    n_fail = sum(len(part) for p, part in procs if p.exitcode != 0)
    while not result.empty():
        n_fail += result.get()
    return n_fail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "one"],
                    default="both")
    ap.add_argument("--out", default="reports/dryrun.jsonl")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--device", default=None,
                    help="--mesh one: the card unless 'cpu'")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes per production mesh")
    args = ap.parse_args(argv)

    runnable, skipped = list_cells()
    cells = [
        (a, s) for a, s, _ in runnable
        if (args.arch == "all" or a == args.arch)
        and (args.shape == "all" or s == args.shape)
    ]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.mesh == "one":
        n_fail = 0
        for arch, shape in cells:
            try:
                rec = run_one(arch, shape, args.device)
                rec = {k: v for k, v in rec.items()
                       if k not in ("outputs", "args")}
                print(json.dumps(rec))
            except Exception as e:  # noqa: BLE001 - recorded as a failure
                n_fail += 1
                rec = {"arch": arch, "shape": shape, "mesh": "1x1",
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                traceback.print_exc()
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        raise SystemExit(1 if n_fail else 0)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    todo = {}
    for multi in meshes:
        todo[multi] = []
        for arch, shape in cells:
            if (arch, shape, MESH_NAMES[multi]) in done:
                print(f"[skip cached] {arch} x {shape} @ {MESH_NAMES[multi]}")
            else:
                todo[multi].append((arch, shape))
    n_fail = sweep(todo, args.out, workers=args.workers)
    with open(args.out, "a") as f:
        for arch, shape, why in skipped:
            f.write(json.dumps({
                "arch": arch, "shape": shape, "mesh": "-", "ok": None,
                "skipped": why,
            }) + "\n")
    print(f"\ndone; {n_fail} failures; skipped cells: "
          f"{[(a, s) for a, s, _ in skipped]}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
