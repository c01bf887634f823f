"""The grouped EmbeddingBag (one launch for a model's tables of one width)
against the per-table bag and the JAX reference, on the CPU.

``embedding_bag_grouped_plain`` is what the CPU path runs and what the
grouped CUDA launch is held against on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``).  Here it must equal the stack of per-table
``embedding_bag_plain`` calls bit for bit, and, table by table, the
reference's ``repro.models.recsys.embedding_bag`` and
``embedding_bag_pallas`` in interpret mode (one call over all tables laid
end to end, with the ids shifted by each table's first row) within the
reference's tolerances (1e-6 float32, 2e-2 bfloat16).  The recsys forwards
through the grouped op give the per-table route's scores bit for bit;
their agreement with the JAX forwards is
``tests/test_torch_recsys.py::test_model_forward_matches_jax``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.models import recsys as jax_recsys
from repro_torch.configs import RecsysConfig, dlrm_mlperf, fm, wide_deep
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops
from repro_torch.models import recsys

FS = (1, 3, 70)  # one table, a few, and more than one launch holds


def _group(rng, F, B, K, D, dtype, R=20):
    """F tables of R_f + 1 rows (R_f in [R, 2R), sentinel zero) as numpy
    float32, and in-range (B, F, K) int32 ids."""
    rows = rng.integers(R, 2 * R, size=F)
    tables = []
    for r in rows:
        t = rng.normal(size=(r + 1, D)).astype(np.float32)
        t[r] = 0.0
        tables.append(np.array(jnp.asarray(t, dtype).astype(jnp.float32)))
    ids = np.stack([rng.integers(0, r + 1, size=(B, K)) for r in rows],
                   axis=1).astype(np.int32)
    return tables, ids


def _torch(tables, dtype):
    return [torch.from_numpy(t).to(dtype) for t in tables]


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("K", [1, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_grouped_plain_is_the_stack_of_plain(rng, F, K, dtype, mode):
    tables, ids = _group(rng, F, 5, K, 10, jnp.float32)
    ids[::2, :, 0] = -3  # out of range on both sides: clamped per table
    ids[1::2, :, -1] = 10_000
    ts, i = _torch(tables, dtype), torch.from_numpy(ids)
    got = bag.embedding_bag_grouped_plain(ts, i, mode)
    want = torch.stack([bag.embedding_bag_plain(t, i[:, f], mode)
                        for f, t in enumerate(ts)], dim=1)
    assert got.dtype == dtype and got.shape == (5, F, 10)
    assert torch.equal(got, want)
    assert torch.equal(ops.embedding_bag_grouped(ts, i, mode), want)


@pytest.mark.parametrize("K", [1, 4, 7])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_grouped_plain_matches_the_model_and_pallas(rng, K, dtype, mode):
    """Every F of :data:`FS` at once: per table, against the reference
    model's lookup (a sum; / K for a mean) and ``embedding_bag_pallas``."""
    B, D = 2, 16
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    groups = [_group(rng, F, B, K, D, dtype) for F in FS]
    got = [bag.embedding_bag_grouped_plain(_torch(t, tdtype),
                                           torch.from_numpy(i), mode)
           for t, i in groups]
    # all tables end to end; each group's ids shifted to its tables' rows
    tables = [t for ts, _ in groups for t in ts]
    first = np.cumsum([0] + [t.shape[0] for t in tables])[:-1]
    flat, f0 = [], 0
    for ts, ids in groups:
        F = len(ts)
        flat.append((ids + first[f0:f0 + F, None]).reshape(B * F, K))
        f0 += F
    table = jnp.asarray(np.concatenate(tables), dtype)
    flat = jnp.asarray(np.concatenate(flat))
    model = jax_recsys.embedding_bag(table, flat)
    if mode == "mean":
        model = model / K
    pallas = embedding_bag_pallas(table, flat, mode=mode, bag_tile=1,
                                  interpret=True)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-6
    for want in (model, pallas):
        want = np.asarray(want, np.float32)
        start = 0
        for g, (ts, _) in zip(got, groups):
            F = len(ts)
            assert g.dtype == tdtype and g.shape == (B, F, D)
            np.testing.assert_allclose(
                g.float().numpy(),
                want[start:start + B * F].reshape(B, F, D), rtol=tol,
                atol=tol)
            start += B * F


def _keys(cfg):
    """(D, dtype) of each bag table of a model at its smoke size, in the
    order ``init_params`` makes them."""
    params = recsys.init_params(cfg, seed=0, device="cpu")
    return [(t.shape[1], t.dtype) for name, t in params.items()
            if name.startswith(("table_", "wide_"))]


@pytest.mark.parametrize("arch,full,sizes", [
    ("wide-deep", wide_deep, [40, 40]), ("fm", fm, [39, 39]),
    ("dlrm-mlperf", dlrm_mlperf, [26])])
def test_launch_groups_of_the_models(arch, full, sizes):
    """The models' bag tables at their published feature counts (the smoke
    configs keep n_sparse): one launch per width."""
    cfg = RecsysConfig(**dataclasses.asdict(smoke_config(arch)))
    assert cfg.n_sparse == full.CONFIG.n_sparse
    keys = _keys(cfg)
    groups = bag.launch_groups(keys)
    assert [len(g) for g in groups] == sizes
    assert sorted(i for g in groups for i in g) == list(range(len(keys)))
    for g in groups:
        assert len({keys[i] for i in g}) == 1 and g == sorted(g)


def test_launch_groups_split_past_64_tables():
    key = (32, torch.float32)
    assert bag.launch_groups([key] * 70) == [list(range(64)),
                                             list(range(64, 70))]
    assert bag.launch_groups([key] * 64) == [list(range(64))]
    mixed = [key, (1, torch.float32), key]
    assert bag.launch_groups(mixed) == [[0, 2], [1]]


@pytest.mark.parametrize("d", [1, 2, 3, 7, 26, 39, 40, 63, 64, 1000,
                               2 ** 31 - 1])
def test_fast_divider_divides(rng, d):
    """The kernel's b = w // F as a multiply-high, an add and a shift, for
    every w it may see (0 <= w < 2^31)."""
    mul, shift = bag._fast_divider(d)
    assert 0 < mul < 2 ** 32 and 0 <= shift <= 31
    edges = [0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - d,
             (2 ** 31 - 1) // d * d, (2 ** 31 - 1) // d * d - 1]
    n = np.concatenate([rng.integers(0, 2 ** 31, size=20_000),
                        np.array([e for e in edges if 0 <= e < 2 ** 31])])
    n = n.astype(np.uint64)
    q = ((((n * np.uint64(mul)) >> np.uint64(32)) + n)
         >> np.uint64(shift))
    np.testing.assert_array_equal(q, n // np.uint64(d))


def test_load_path():
    f32 = torch.zeros(8, 32)
    assert bag.load_path([f32, torch.zeros(3, 32)]) == "v16"
    assert bag.load_path([torch.zeros(4, 8, dtype=torch.bfloat16)]) == "v16"
    assert bag.load_path([torch.zeros(8, 1)]) == "scalar"
    assert bag.load_path([torch.zeros(8, 10)]) == "scalar"
    view = torch.zeros(8 * 32 + 1)[1:].view(8, 32)  # 4 bytes off
    assert view.is_contiguous() and bag.load_path([view]) == "scalar"
    assert bag.load_path([f32, view]) == "scalar"


def test_grouped_dispatch_on_the_cpu(rng):
    tables, ids = _group(rng, 3, 4, 2, 8, jnp.float32)
    ts, i = _torch(tables, torch.float32), torch.from_numpy(ids)
    before = dict(bag.LAUNCHES), dict(bag.SHAPES)
    want = bag.embedding_bag_grouped_plain(ts, i, "mean")
    assert torch.equal(ops.embedding_bag_grouped(ts, i, "mean"), want)
    assert torch.equal(ops.embedding_bag_grouped(ts, i, "mean", impl="plain"),
                       want)
    assert (bag.LAUNCHES, bag.SHAPES) == before  # no launch counted
    with pytest.raises(ValueError, match="impl"):
        ops.embedding_bag_grouped(ts, i, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        bag.embedding_bag_grouped_cuda(ts, i)  # never reaches the kernel
    with pytest.raises(ValueError, match="width"):
        ops.embedding_bag_grouped(ts[:2] + [torch.zeros(5, 4)], i)
    with pytest.raises(ValueError, match="F must match"):
        ops.embedding_bag_grouped(ts[:2], i)
    with pytest.raises(ValueError, match="int32"):
        ops.embedding_bag_grouped(ts, i.long())
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag_grouped(ts, i, mode="max")
    assert bag._lib.cache_info().currsize == 0  # nothing built or loaded


@pytest.mark.parametrize("arch", ["wide-deep", "fm", "dlrm-mlperf", "mind"])
def test_forward_equals_the_per_table_route(arch, monkeypatch):
    """Scores through the grouped op equal, bit for bit, those of the
    per-table route: one ``ops.embedding_bag`` per table, stacked."""
    cfg = RecsysConfig(**dataclasses.asdict(smoke_config(arch)))
    params = recsys.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    sparse = np.stack([rng.integers(-2, v + 3, size=(16, cfg.multi_hot))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    batch = {"sparse": torch.from_numpy(sparse),
             "dense": torch.from_numpy(
                 rng.normal(size=(16, max(cfg.n_dense, 1))).astype(np.float32)),
             "hist": torch.from_numpy(
                 rng.integers(0, 40, size=(16, cfg.hist_len)).astype(np.int32)),
             "target": torch.from_numpy(
                 rng.integers(0, 40, size=(16,)).astype(np.int32))}
    grouped = recsys.forward(params, batch, cfg)

    def per_table(tables, indices, mode="sum", impl=None):
        return torch.stack([ops.embedding_bag(t, indices[:, f], mode, impl)
                            for f, t in enumerate(tables)], dim=1)

    monkeypatch.setattr(ops, "embedding_bag_grouped", per_table)
    assert torch.equal(grouped, recsys.forward(params, batch, cfg))
