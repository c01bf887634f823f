"""Debug-size bundles and the spawned fake-world worker of
``tests/test_torch_dryrun_exec.py`` (imports only the port).

A fake world is process-global, so each one runs in a process of its own:
:func:`fake_world_cells` makes a world of the mesh's ranks, runs
:func:`repro_torch.launch.dryrun.run_cell` on the named cells and writes
their records (the placed arguments' per-leaf local bytes too) to a JSON
file.
"""
import dataclasses
import json

from repro_torch.configs import get_bundle, smoke_config
from repro_torch.configs.base import GraphShape, LMShape, RecsysShape
from repro_torch.configs.static_gr import GRShape

# one cell of every step kind: (arch, shape, cfg_overrides)
KINDS = [
    ("stablelm-12b", "train_4k", None),
    ("stablelm-12b", "prefill_32k", None),
    ("stablelm-12b", "decode_32k", None),
    ("static-gr", "gr_serve_constrained", None),
    ("static-gr", "gr_serve_unconstrained", None),
    ("static-gr", "gr_serve_constrained", {"serve_replicate_weights": True}),
    ("static-gr", "gr_serve_constrained", {"gr_batched_beams": True}),
    ("static-gr", "gr_train", None),
    ("meshgraphnet", "full_graph_sm", None),
    ("dlrm-mlperf", "train_batch", None),
    ("wide-deep", "serve_p99", None),
    ("mind", "retrieval_cand", None),
    ("fm", "retrieval_cand", None),
]


def debug_bundle(arch: str):
    """The registry's bundle of ``arch`` at its smoke config, with shapes
    of the same names and kinds cut to a few rows (a 4x4 or 2x4x4 mesh
    divides them); static-gr keeps the SID vocabulary (2,048 + 2)."""
    b = get_bundle(arch)
    cfg = smoke_config(arch)
    if b.family == "lm":
        shapes = (LMShape("train_4k", "train", 32, 16),
                  LMShape("prefill_32k", "prefill", 32, 8),
                  LMShape("decode_32k", "decode", 32, 16),
                  LMShape("long_500k", "decode", 64, 1))
    elif b.family == "gr":
        cfg = dataclasses.replace(cfg, vocab_size=2050)
        shapes = (GRShape("gr_train", "train", 16, history_len=16),
                  GRShape("gr_serve_constrained", "serve_constrained", 32,
                          beam_size=4, history_len=16),
                  GRShape("gr_serve_unconstrained", "serve_unconstrained",
                          32, beam_size=4, history_len=16))
    elif b.family == "gnn":
        shapes = (GraphShape("full_graph_sm", "full", 100, 300, 5),
                  GraphShape("minibatch_lg", "sampled", 1000, 5000, 6,
                             batch_nodes=16, fanout=(2, 2)),
                  GraphShape("ogb_products", "full", 200, 700, 4),
                  GraphShape("molecule", "batched", 6, 10, 3, batch=16))
    else:
        shapes = (RecsysShape("train_batch", "train", 64),
                  RecsysShape("serve_p99", "serve", 32),
                  RecsysShape("serve_bulk", "serve", 64),
                  RecsysShape("retrieval_cand", "retrieval", 1,
                              n_candidates=64))
    return dataclasses.replace(b, config=cfg, shapes=shapes)


def fake_world_cells(mesh_shape, cells, out_path):
    """Run ``cells`` ((arch, shape, overrides) triples) in a fake world of
    ``prod(mesh_shape)`` ranks on a mesh of that shape; write each record
    with ``leaf_bytes`` (rank 0's local bytes per argument leaf, from the
    specs alone) and ``leaf_shapes`` to ``out_path``."""
    import math

    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.steps import build_cell

    dims = (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))
    dryrun.fake_world(math.prod(mesh_shape))
    recs = []
    try:
        mesh = _mesh(tuple(mesh_shape), dims, "cpu")
        for arch, shape, overrides in cells:
            bundle = debug_bundle(arch)
            rec = dryrun.run_cell(arch, shape, mesh=mesh, bundle=bundle,
                                  cfg_overrides=overrides, verbose=False)
            cell = build_cell(arch, shape, mesh, overrides, bundle)
            rec["spec_bytes"] = _spec_bytes(cell, dict(zip(dims, mesh_shape)))
            rec["overrides"] = overrides
            recs.append(rec)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(recs, f)


def _spec_bytes(cell, sizes) -> int:
    """Rank 0's bytes of every argument, worked out from the specs: each
    leaf's bytes over the product of the mesh dims its spec names."""
    from repro_torch.launch.dryrun import _map

    total = [0]

    def one(t, spec):
        n = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= sizes[axis]
        total[0] += t.numel() * t.element_size() // n
        return t

    for a, s in zip(cell.args, cell.in_specs):
        _map(one, a, s)
    return total[0]


# --------------------------------------------------------------------------
# The explicit layouts over real values: a gloo world of 4 ranks, (2, 2)
# --------------------------------------------------------------------------

# the handler each case must take (a prefix of the name in the notes)
ROWS = "row lookup of a row-sharded table"
LOCAL = "lookup by ids sharded over several mesh dims"
GATHER = "gather along a sharded or partial dim"
BMM = "batched product with a float32 result"
PARTIAL = "partial sums of a sharded contraction"
SPLIT = "view splitting a sharded dim unevenly"
MERGE = "view merging a sharded dim into the one before it"
PUT = "index_put over unsharded trailing dims"
ADD = "index_add into an unsharded buffer"


def _cases():
    """name -> (handler, collectives the step must issue ("all-gather",
    "all-reduce" or nothing), build(gen) -> (op, full inputs, placements
    of each input: a tuple of placements, "partial" for a ``Partial`` over
    the data dim, or ``None`` for a plain tensor[, the op over the full
    tensors where the CPU has no kernel for ``op``]))."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate as R
    from torch.distributed.tensor import Shard as S

    aten = torch.ops.aten

    def f32(gen, *shape):
        return torch.randn(shape, generator=gen)

    def ids(gen, hi, *shape):
        return torch.randint(0, hi, shape, generator=gen)

    def bmm_f32(a, b):  # the CPU has no aten.bmm.dtype
        return torch.bmm(a.float(), b.float())

    return {
        # a table row-sharded over "model", more ids than table rows
        "rows_all_gather": (ROWS, "all-gather", lambda g: (
            lambda t, i: F.embedding(i, t),
            [f32(g, 8, 64), ids(g, 8, 6, 10)], [(R(), S(0)), (R(), R())])),
        # few ids into a table row-sharded over both mesh dims (block
        # offsets data * 2 + model): each id in another rank's block
        "rows_masked_two_dims": (ROWS, "all-reduce", lambda g: (
            lambda t, i: t[i],
            [f32(g, 64, 4), torch.tensor([3, 21, 38, 60, 17, 50, 0, 63])],
            [(S(0), S(0)), None])),
        # ids batch-sharded over "data", the table over "model"
        "rows_masked_batch": (ROWS, "all-reduce", lambda g: (
            lambda t, i: t.index_select(0, i),
            [f32(g, 64, 4), ids(g, 64, 8)], [(R(), S(0)), (S(0), R())])),
        "rows_local": (LOCAL, None, lambda g: (
            lambda t, i: F.embedding(i, t),
            [f32(g, 16, 8), ids(g, 16, 8, 2)], [(R(), R()), (S(0), S(0))])),
        "gather_masked": (GATHER, "all-reduce", lambda g: (
            lambda x, i: torch.gather(x, 1, i),
            [f32(g, 4, 64), ids(g, 64, 4, 3)], [(R(), S(1)), (R(), R())])),
        "gather_all_gather": (GATHER, "all-gather", lambda g: (
            lambda x, i: torch.gather(x, 1, i),
            [f32(g, 4, 8), ids(g, 8, 4, 40)], [(R(), S(1)), (R(), R())])),
        "gather_partial": (GATHER, "all-reduce", lambda g: (
            lambda x, i: torch.gather(x, -1, i),
            [f32(g, 2, 4, 16), ids(g, 16, 4, 5)], ["partial", (R(), R())])),
        "gather_local": (LOCAL, None, lambda g: (
            lambda x, i: torch.gather(x, 1, i),
            [f32(g, 8, 6), ids(g, 6, 8, 2)], [(S(0), S(0)), (R(), R())])),
        "bmm_f32_batch": (BMM, None, lambda g: (
            lambda a, b: torch.bmm(a, b, out_dtype=torch.float32),
            [f32(g, 4, 3, 5).bfloat16(), f32(g, 4, 5, 2).bfloat16()],
            [(S(0), R()), (S(0), R())], bmm_f32)),
        "bmm_f32_contraction": (BMM, "all-reduce", lambda g: (
            lambda a, b: torch.bmm(a, b, out_dtype=torch.float32),
            [f32(g, 4, 3, 6).bfloat16(), f32(g, 4, 6, 2).bfloat16()],
            [(R(), S(2)), (R(), S(1))], bmm_f32)),
        "mm_partial": (PARTIAL, "all-reduce", lambda g: (
            lambda a, b: a @ b,
            [f32(g, 6, 8), f32(g, 8, 5)], [(R(), S(1)), (R(), S(0))])),
        "view_split": (SPLIT, "all-gather", lambda g: (
            lambda x: x.view(2, 3, 4), [f32(g, 2, 12)], [(R(), S(1))])),
        "view_merge": (MERGE, "all-gather", lambda g: (
            lambda x: x.view(24), [f32(g, 4, 6)], [(R(), S(1))])),
        "index_put_rows": (PUT, None, lambda g: (
            lambda buf, v, i: aten.index_put.default(buf, [None, i], v),
            [f32(g, 4, 6, 3), f32(g, 4, 2, 3), torch.tensor([4, 1])],
            [(S(0), R()), (S(0), R()), None])),
        "index_add_batch": (ADD, None, lambda g: (
            lambda buf, i, src: buf.index_add(0, i, src),
            [f32(g, 10, 3), ids(g, 10, 8), f32(g, 8, 3)],
            [(R(), R()), (S(0), R()), (S(0), R())])),
        "index_add_two_dims": (ADD, None, lambda g: (
            lambda buf, i, src: buf.index_add(0, i, src),
            [f32(g, 10, 3), ids(g, 10, 8), f32(g, 8, 3)],
            [(R(), R()), (S(0), S(0)), (S(0), S(0))])),
    }


CASES = sorted(_cases())


def _placed(mesh, full, placement):
    """``full`` on ``mesh``: distributed by ``placement``; "partial" is a
    ``Partial`` sum over "data" of ``full``'s leading dim, one slice a
    data rank; ``None`` leaves it a plain tensor."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)

    if placement is None:
        return full
    if placement == "partial":
        part = full[mesh.get_local_rank(0)]
        return DTensor.from_local(part, mesh, [Partial(), Replicate()],
                                  run_check=False)
    return distribute_tensor(full, mesh, list(placement))


def gloo_handler_cases(rank: int, world_size: int, root: str) -> None:
    """Rank ``rank`` of a gloo world of 4 on a (2, 2) CPU mesh: each case's
    op over ``DTensor``s under the dry run's explicit layouts, its result
    gathered and held beside the same op over the full tensors; rank 0
    writes ``{case: record}`` to ``root/handlers.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{root}/store", world_size),
        rank=rank, world_size=world_size)
    recs = {}
    try:
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        for i, (name, (_, _, build)) in enumerate(sorted(_cases().items())):
            gen = torch.Generator().manual_seed(i)
            op, full, placements, *plain = build(gen)
            args = [_placed(mesh, t, p) for t, p in zip(full, placements)]
            want = (plain or [op])[0](*[t.sum(0) if p == "partial" else t
                                        for t, p in zip(full, placements)])
            with dryrun._stepping() as (counter, explicit):
                out = op(*args)
            got = out.full_tensor()
            recs[name] = {
                "used": sorted(explicit.used),
                "collectives": counter.log.summary()["counts_by_op"],
                "shape_ok": tuple(got.shape) == tuple(want.shape),
                "dtype_ok": got.dtype == want.dtype,
                "equal": bool(torch.equal(got, want)),
                "max_abs_err": float((got.double() - want.double()).abs()
                                     .max()),
                "max_abs": float(want.double().abs().max()),
            }
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(f"{root}/handlers.json", "w") as f:
            json.dump(recs, f)
