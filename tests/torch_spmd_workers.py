"""Rank bodies of ``tests/test_torch_spmd_multiproc.py``.

Spawned by ``torch.multiprocessing``, each rank imports only numpy, torch
and the port (never JAX), joins a ``gloo`` world over a ``FileStore`` in
the test's directory, runs every check on each mesh the world holds, and
writes what it computed to ``rank<r>.npz`` for the parent to compare with
the reference.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import TransformerConfig
from repro_torch.constraints import ConstraintStore
from repro_torch.core import TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.distributed import collectives
from repro_torch.distributed.constraint_sharding import (
    ModelShard,
    pad_policy_rows,
    shard_policy,
    spmd_beam_search,
    vntk_row_sharded,
    vntk_row_sharded_compressed,
    vntk_row_sharded_compressed_topk,
    vntk_row_sharded_topk,
)
from repro_torch.launch.mesh import make_subset_mesh
from repro_torch.models import transformer
from repro_torch.serving import GenerativeRetriever
from repro_torch.serving.spmd_engine import SpmdRetriever

MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
TINY_LM = dict(name="gr-tiny", n_layers=2, d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab_size=40, dtype="float32",
               tie_embeddings=True, attn_chunk_q=8)


def tables(inp):
    """The single matrix, the two-member store, and their slabs."""
    V, dense_d = int(inp["V"]), int(inp["dense_d"])
    tm = TransitionMatrix.from_sids(inp["sids1"], V, dense_d=dense_d,
                                    device="cpu")
    tm2 = TransitionMatrix.from_sids(inp["sids2"], V, dense_d=dense_d,
                                     device="cpu")
    store = ConstraintStore.from_matrices([tm2, tm], headroom=0.2,
                                          device="cpu")
    return tm, store


def _cut(policy, mesh):
    """The sparse backend of the rank's padded and cut policy."""
    ms = mesh.shape[1]
    return shard_policy(pad_policy_rows(policy, ms), mesh,
                        rows="model").backends[-1]


def vntk_checks(inp, mesh, out, tag):
    """The four row-sharded steps, single and stacked, on this rank."""
    tm, store = tables(inp)
    shard = ModelShard.of(mesh)
    V, step, width = int(inp["V"]), int(inp["step"]), int(inp["width"])
    lp = torch.as_tensor(inp["lp"])
    nodes = torch.as_tensor(inp["nodes"])
    cids = torch.as_tensor(inp["cids"])
    for kind, obj, ids in (("single", tm, None), ("stacked", store, cids)):
        bmax = max(obj.bmax_for_step(step), 1)
        b = _cut(DecodePolicy.static(obj, impl="plain", compressed=True),
                 mesh)
        t = b.store if kind == "stacked" else b.tm
        out[f"{tag}/edges_rows_{kind}"] = np.int64(t.edges.shape[-2])
        out[f"{tag}/edges_bytes_{kind}"] = np.int64(
            t.edges.untyped_storage().nbytes())
        base = b.slab.base_for_step(step)
        res = {
            "mask": vntk_row_sharded(lp, nodes, t.row_pointers, t.edges,
                                     bmax, V, shard, ids),
            "topk": vntk_row_sharded_topk(lp, nodes, t.row_pointers, t.edges,
                                          bmax, V, width, shard, ids),
            "cmask": vntk_row_sharded_compressed(
                lp, nodes, t.row_pointers, b.slab.tok_delta, base, bmax, V,
                shard, ids),
            "ctopk": vntk_row_sharded_compressed_topk(
                lp, nodes, t.row_pointers, b.slab.tok_delta, base, bmax, V,
                width, shard, ids),
        }
        for name, outs in res.items():
            for i, o in enumerate(outs):
                out[f"{tag}/{name}_{kind}_{i}"] = o.numpy()


def search_checks(inp, mesh, out, tag):
    """spmd_beam_search over the fuzz cases, both placements, topk on and
    off; the collectives of the row-sharded top-k run."""
    n = mesh.shape[0]
    B = 2 * n
    for seed in inp["seeds"]:
        sids, table = inp[f"case{seed}_sids"], inp[f"case{seed}_table"]
        V, L, dense_d = (int(x) for x in inp[f"case{seed}_meta"])
        tm = TransitionMatrix.from_sids(sids, V, dense_d=dense_d,
                                        device="cpu")
        table = torch.as_tensor(table)

        def logits_fn(carry, last, step):
            return table[step][last.long()], carry

        for rows in ("replicated", "model"):
            for topk in (True, False):
                pol = DecodePolicy.static(tm, impl="plain", topk=topk)
                with collectives.recording() as log:
                    tokens, scores = spmd_beam_search(
                        mesh, logits_fn, B, 5, L, pol, rows=rows)
                key = f"{tag}/bs{seed}_{rows}_{int(topk)}"
                out[key + "_tokens"] = tokens.numpy()
                out[key + "_scores"] = scores.numpy()
                out[key + "_log"] = np.array(
                    [[op == "all-reduce", b] for op, b in log.ops],
                    np.int64).reshape(-1, 2)


def retriever_checks(inp, mesh, out, tag):
    """SpmdRetriever against GenerativeRetriever on this rank's half and on
    the whole batch (each placement the mesh has an axis for)."""
    cfg = TransformerConfig(**TINY_LM)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tm, _ = tables(inp)
    V, hist = int(inp["V"]), inp["hist"]
    rows = "model" if mesh.shape[1] > 1 else "replicated"
    pol = DecodePolicy.static(tm, impl="plain")
    got = SpmdRetriever(params, cfg, pol, 4, V, beam_size=4, mesh=mesh,
                        rows=rows).retrieve(hist)
    whole = GenerativeRetriever(params, cfg, pol, 4, V,
                                beam_size=4).retrieve(hist)
    n, r = mesh.shape[0], mesh.get_local_rank("data")
    b = hist.shape[0] // n
    half = GenerativeRetriever(params, cfg, pol, 4, V, beam_size=4).retrieve(
        hist[r * b:(r + 1) * b])
    for name, (t, s) in (("spmd", got), ("whole", whole), ("own", half)):
        out[f"{tag}/retr_{name}_tokens"] = t
        out[f"{tag}/retr_{name}_scores"] = s
    out[f"{tag}/retr_own_rows"] = np.array([r * b, (r + 1) * b])


def run_world(rank: int, world_size: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{root}/store", world_size),
        rank=rank, world_size=world_size)
    try:
        inp = dict(np.load(f"{root}/inputs.npz"))
        out = {}
        for data, model in MESHES[world_size]:
            mesh = make_subset_mesh(data, model, device_type="cpu")
            tag = f"{data}x{model}"
            if model > 1:
                vntk_checks(inp, mesh, out, tag)
            search_checks(inp, mesh, out, tag)
            retriever_checks(inp, mesh, out, tag)
        np.savez(f"{root}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
