"""Port recsys serving path and its EmbeddingBag kernel against the JAX
reference.

The bag's plain version (what the CPU path runs, and what the CUDA kernel is
held against on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``) is held against ``embedding_bag_pallas`` in
interpret mode and ``ref.embedding_bag_ref`` on the reference's own sweep,
within the reference's tolerances (1e-6 float32, 2e-2 bfloat16); with ids
out of range it equals the model's own clipping lookup.  The four recsys
models run on weights carried over from the reference and agree with the
JAX forward within rtol/atol 1e-5 in float32: the bags only gather and add,
but the MLPs, the DLRM interaction and the capsule routing are matrix
products that the two frameworks sum in different orders.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle, smoke_config
from repro.configs.base import RECSYS_SHAPES as JAX_RECSYS_SHAPES
from repro.kernels import ref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.models import recsys as jax_recsys
from repro_torch.configs import RECSYS_SHAPES, RecsysConfig
from repro_torch.configs import dlrm_mlperf, fm, mind, wide_deep
from repro_torch.convert import recsys_params_from_jax
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops
from repro_torch.models import recsys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = {"wide-deep": wide_deep, "mind": mind, "dlrm-mlperf": dlrm_mlperf,
         "fm": fm}
# grouped bag lookups per forward, each over all n_sparse tables: the table_i
# and the wide_i bags (wide_deep, fm), the table_i bags (dlrm); MIND gathers
# without bags
BAGS_PER_FORWARD = {"wide_deep": 2, "fm": 2, "dlrm": 1, "mind": 0}


def _bag_inputs(rng, B, K, D, dtype, R=200):
    table = jnp.asarray(rng.normal(size=(R + 1, D)), dtype=dtype)
    table = table.at[R].set(0.0)  # sentinel pad row
    idx = rng.integers(0, R + 1, size=(B, K)).astype(np.int32)
    return table, idx


def _torch(a):
    """A JAX or numpy array as a CPU tensor (bfloat16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,K,D", [(8, 1, 32), (16, 4, 128), (5, 7, 64)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_plain_matches_pallas_and_ref(rng, B, K, D, dtype, mode):
    """The reference's sweep (tests/test_kernels_pallas.py), against both
    of its functions, at its tolerances."""
    table, idx = _bag_inputs(rng, B, K, D, dtype)
    got = bag.embedding_bag_plain(_torch(table), torch.from_numpy(idx), mode)
    assert got.dtype == _torch(table).dtype and got.shape == (B, D)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-6
    for want in (embedding_bag_pallas(table, jnp.asarray(idx), mode=mode,
                                      interpret=True),
                 ref.embedding_bag_ref(table, jnp.asarray(idx), mode=mode)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("K,D", [(1, 1), (3, 10)])
def test_bag_plain_clips_out_of_range_ids_like_the_model(rng, K, D):
    """Ids below 0 and past R clamp into [0, R], as the model's
    ``jnp.take(mode="clip")`` lookup does (the oracle's fill mode would give
    NaN there)."""
    table, idx = _bag_inputs(rng, 64, K, D, jnp.float32)
    idx[::3, 0] = -5
    idx[1::3, -1] = 201 + rng.integers(0, 1000, size=idx[1::3].shape[0])
    got = bag.embedding_bag_plain(_torch(table), torch.from_numpy(idx))
    want = jax_recsys.embedding_bag(table, jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bag_dispatch_on_the_cpu(rng):
    table, idx = _bag_inputs(rng, 8, 2, 16, jnp.float32)
    t, i = _torch(table), torch.from_numpy(idx)
    before = dict(bag.LAUNCHES), dict(bag.SHAPES)
    want = bag.embedding_bag_plain(t, i, "mean")
    assert torch.equal(ops.embedding_bag(t, i, "mean"), want)
    assert torch.equal(ops.embedding_bag(t, i, "mean", impl="plain"), want)
    assert (bag.LAUNCHES, bag.SHAPES) == before  # no launch counted
    with pytest.raises(ValueError, match="impl"):
        ops.embedding_bag(t, i, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        bag.embedding_bag_cuda(t, i)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag(t, i, mode="max")
    with pytest.raises(ValueError, match="int32"):
        ops.embedding_bag(t, i.long())
    assert bag._lib.cache_info().currsize == 0  # nothing built or loaded


@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_are_copies(arch):
    ref_cfg = get_bundle(arch).config
    port_cfg = ARCHS[arch].CONFIG
    assert RecsysConfig(**dataclasses.asdict(ref_cfg)) == port_cfg
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    assert ([dataclasses.asdict(s) for s in RECSYS_SHAPES]
            == [dataclasses.asdict(s) for s in JAX_RECSYS_SHAPES])


def _batch(cfg, B=8, seed=0):
    """tests/test_configs_smoke.py's batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    sparse = np.stack(
        [rng.integers(0, v, size=(B, cfg.multi_hot)) for v in cfg.vocab_sizes],
        axis=1).astype(np.int32)
    return {
        "sparse": sparse,
        "dense": rng.normal(size=(B, max(cfg.n_dense, 1))).astype(np.float32),
        "hist": rng.integers(0, 40, size=(B, cfg.hist_len)).astype(np.int32),
        "target": rng.integers(0, 40, size=(B,)).astype(np.int32),
    }


def _carried(cfg):
    jparams = jax_recsys.init_params(cfg, jax.random.key(0))
    params = recsys_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    RecsysConfig(**dataclasses.asdict(cfg)),
                                    device="cpu")
    return jparams, params


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_forward_matches_jax(arch, monkeypatch):
    jcfg = smoke_config(arch)
    cfg = RecsysConfig(**dataclasses.asdict(jcfg))
    jparams, params = _carried(jcfg)
    batch = _batch(jcfg)
    want = jax_recsys.forward(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)

    calls = []
    real = ops.embedding_bag_grouped

    def counted(tables, *a, **kw):
        calls.append(len(tables))
        return real(tables, *a, **kw)

    monkeypatch.setattr(ops, "embedding_bag_grouped", counted)
    got = recsys.forward(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg)
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert calls == [cfg.n_sparse] * BAGS_PER_FORWARD[cfg.model]


def test_mind_retrieval_scores_match_jax():
    jcfg = smoke_config("mind")
    cfg = RecsysConfig(**dataclasses.asdict(jcfg))
    jparams, params = _carried(jcfg)
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 50, size=(3, cfg.hist_len)).astype(np.int32)
    hist[0, -2:] = params["table_0"].shape[0] - 1  # padding, masked out
    cands = rng.integers(-3, 140, size=(37,)).astype(np.int32)  # clipped
    want = jax_recsys.mind_retrieval_scores(jparams, jnp.asarray(hist),
                                            jnp.asarray(cands), jcfg)
    got = recsys.mind_retrieval_scores(params, torch.from_numpy(hist),
                                       torch.from_numpy(cands), cfg)
    assert got.shape == (3, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_layout_matches_the_reference(arch):
    jcfg = smoke_config(arch)
    cfg = RecsysConfig(**dataclasses.asdict(jcfg))
    specs = jax.tree.map(lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
                         jax_recsys.param_specs(jcfg))
    params = recsys.init_params(cfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape),
                                     str(t.dtype).removeprefix("torch.")),
                          params)
    assert shapes == specs
    for i, rows in enumerate(cfg.vocab_sizes):
        for name in (f"table_{i}", f"wide_{i}"):
            if name not in params:
                continue
            t = params[name]
            assert t.shape[0] == recsys.padded_rows(rows) and t.shape[0] % 128 == 0
            assert not t[rows:].any() and t[:rows].abs().sum(dim=1).all()


IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_recsys_modules_fall_under_the_import_guard():
    """The new modules are among the files the port's import guard walks
    (``tests/test_torch_retrieval.py``) and import neither JAX nor repro."""
    walked = set((ROOT / "src" / "repro_torch").rglob("*.py"))
    new = [ROOT / "src" / "repro_torch" / p for p in (
        "models/recsys.py", "kernels/embedding_bag.py", "configs/wide_deep.py",
        "configs/fm.py", "configs/dlrm_mlperf.py", "configs/mind.py")]
    assert set(new) <= walked
    assert not [p for p in new if IMPORT.search(p.read_text())]
