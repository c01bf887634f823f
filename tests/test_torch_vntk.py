"""Plain VNTK versions of the port against the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode (as
``tests/test_kernels_pallas.py`` does) or through ``repro.kernels.ref``;
the port side runs the plain PyTorch versions the CUDA kernels are held
against on the card.  Tokens and next states are equal; scores agree within
rtol 1e-6, or 1e-5 where the log-softmax is fused.
"""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.core import dense_mask as jax_dense_mask
from repro.core.vntk import candidate_width as jax_candidate_width
from repro.kernels import ref
from repro.kernels.vntk import (
    vntk_fused_logsoftmax_pallas,
    vntk_pallas,
    vntk_topk_pallas,
)
from repro_torch.convert import transition_matrix_from_numpy
from repro_torch.core import dense_mask
from repro_torch.core.vntk import candidate_width
from repro_torch.kernels import ops
from repro_torch.kernels import vntk as kv

from conftest import make_sids

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


def _random_csr(rng, n_states, vocab, bmax_true):
    """Random CSR with rows of 0..bmax_true children, unique sorted tokens."""
    counts = rng.integers(0, bmax_true + 1, n_states)
    counts[0] = 0  # sink
    rowptr = np.zeros(n_states + 1, np.int64)
    rowptr[1:] = np.cumsum(counts)
    E = int(rowptr[-1])
    edges = np.zeros((E + 256, 2), np.int32)
    for s in range(n_states):
        lo, hi = rowptr[s], rowptr[s + 1]
        edges[lo:hi, 0] = np.sort(rng.choice(vocab, size=hi - lo, replace=False))
        edges[lo:hi, 1] = rng.integers(1, n_states, size=hi - lo)
    return rowptr.astype(np.int32), edges


def _case(rng, vocab, nb, bmax, n_states=40, scale=1.0, ties=False):
    rowptr, edges = _random_csr(rng, n_states, vocab, bmax)
    nodes = rng.integers(0, n_states, nb).astype(np.int32)
    x = (rng.normal(size=(nb, vocab)) * scale).astype(np.float32)
    if ties:  # many equal logits: the tie order decides the output
        # (+ 0.0 turns -0.0 into +0.0: XLA's TopK orders -0.0 below +0.0,
        # IEEE comparison — torch.sort, the kernels — calls them equal)
        x = np.round(x * 2) / 2 + 0.0
    return rowptr, edges, nodes, x


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=rtol,
                               atol=atol)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# rows 3-4: vntk_pallas / vntk_fused_logsoftmax_pallas (vocab-aligned)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,nb,dtype", [
    (128, 1, "float32"), (128, 7, "bfloat16"), (128, 16, "float32"),
    (2048, 1, "bfloat16"), (2048, 7, "float32"), (2048, 16, "bfloat16")])
def test_mask_matches_vntk_pallas(rng, vocab, nb, dtype):
    rowptr, edges, nodes, x = _case(rng, vocab, nb, 24, n_states=64)
    lp_j = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = vntk_pallas(lp_j, *_jax(nodes, rowptr, edges), 24, vocab,
                       interpret=True)
    lp_t = torch.from_numpy(np.array(lp_j, np.float32)).to(
        getattr(torch, dtype))
    got = kv.vntk_mask_plain(lp_t, *_torch(nodes, rowptr, edges), 24, vocab)
    assert got[0].dtype == lp_t.dtype  # the input's dtype, like the kernel's
    _check(got, want, rtol=1e-6)


@pytest.mark.parametrize("bmax", [1, 8, 33, 128])
def test_mask_branch_factor_sweep(rng, bmax):
    rowptr, edges, nodes, x = _case(rng, 512, 8, bmax)
    want = vntk_pallas(*_jax(x, nodes, rowptr, edges), bmax, 512,
                       interpret=True)
    got = kv.vntk_mask_plain(*_torch(x, nodes, rowptr, edges), bmax, 512)
    _check(got, want, rtol=1e-6)


@pytest.mark.parametrize("vocab", [128, 1024])
def test_fused_mask_matches_pallas(rng, vocab):
    rowptr, edges, nodes, x = _case(rng, vocab, 8, 16, n_states=32, scale=4)
    want = vntk_fused_logsoftmax_pallas(*_jax(x, nodes, rowptr, edges), 16,
                                        vocab, interpret=True)
    got = kv.vntk_mask_plain(*_torch(x, nodes, rowptr, edges), 16, vocab,
                             fused=True)
    _check(got, want, rtol=1e-5, atol=1e-5)


def test_mask_on_real_trie(rng):
    vocab, length, nb = 64, 5, 12
    sids = make_sids(rng, 800, vocab, length, clustered=True)
    jtm = JaxTransitionMatrix.from_sids(sids, vocab, dense_d=2)
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    pref = sids[rng.integers(0, sids.shape[0], nb)]
    nodes = np.asarray(jtm.l1_states)[pref[:, 0], pref[:, 1]].astype(np.int32)
    x = rng.normal(size=(nb, vocab)).astype(np.float32)
    bmax = tm.bmax_for_step(2)
    want = vntk_pallas(*_jax(x, nodes), jtm.row_pointers, jtm.edges, bmax,
                       vocab, interpret=True)
    got = kv.vntk_mask_plain(*_torch(x, nodes), tm.row_pointers, tm.edges,
                             bmax, vocab)
    _check(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# rows 1-2: vntk_topk_pallas (candidate-compressed, §8)
# ---------------------------------------------------------------------------
# nb 7 is prime; bmax spans bmax < M and > M
@pytest.mark.parametrize("vocab,nb,bmax", [
    (128, 1, 1), (128, 7, 8), (128, 16, 33), (512, 1, 33), (512, 7, 1),
    (512, 16, 8)])
def test_topk_matches_vntk_topk_pallas(rng, vocab, nb, bmax):
    rowptr, edges, nodes, x = _case(rng, vocab, nb, bmax)
    lp = np.asarray(torch.log_softmax(torch.from_numpy(x), -1))
    width = candidate_width(10, vocab)
    want = vntk_topk_pallas(*_jax(lp, nodes, rowptr, edges), bmax, vocab,
                            width, interpret=True)
    got = kv.vntk_topk_plain(*_torch(lp, nodes, rowptr, edges), bmax, vocab,
                             width)
    _check(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_fused_topk_matches_pallas(rng, ties):
    vocab, nb, bmax = 256, 9, 12
    rowptr, edges, nodes, x = _case(rng, vocab, nb, bmax, n_states=32,
                                    scale=4, ties=ties)
    width = candidate_width(6, vocab)
    want = vntk_topk_pallas(*_jax(x, nodes, rowptr, edges), bmax, vocab,
                            width, fused_logsoftmax=True, interpret=True)
    got = kv.vntk_topk_plain(*_torch(x, nodes, rowptr, edges), bmax, vocab,
                             width, fused=True)
    _check(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["topk", "mask"])
def test_tie_heavy_logits(rng, kernel):
    """Quantized log-probs: most candidates tie, so only the (score desc,
    token asc) order decides which tokens and next states come out."""
    vocab, nb, bmax = 64, 11, 40
    rowptr, edges, nodes, x = _case(rng, vocab, nb, bmax, ties=True)
    args = _jax(x, nodes, rowptr, edges)
    targs = _torch(x, nodes, rowptr, edges)
    if kernel == "topk":
        want = ref.vntk_topk_ref(*args, bmax, vocab, vocab)  # full rank order
        got = kv.vntk_topk_plain(*targs, bmax, vocab, vocab)
    else:
        want = ref.vntk_ref(*args, bmax, vocab)
        got = kv.vntk_mask_plain(*targs, bmax, vocab)
    _check(got, want, rtol=0)


@pytest.mark.parametrize("beams,vocab", [(1, 12), (10, 128), (70, 2048),
                                         (300, 256)])
def test_candidate_width_matches_reference_lane(beams, vocab):
    assert candidate_width(beams, vocab) == jax_candidate_width(beams, vocab)


# ---------------------------------------------------------------------------
# dense levels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense_d", [1, 2])
def test_dense_lookups_match_reference(rng, dense_d):
    vocab, length = 40, 4
    sids = make_sids(rng, 400, vocab, length, clustered=True)
    jtm = JaxTransitionMatrix.from_sids(sids, vocab, dense_d=dense_d)
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    lp = rng.normal(size=(3, 5, vocab)).astype(np.float32)
    got = dense_mask.dense_lookup_l0(torch.from_numpy(lp), tm)
    want = jax_dense_mask.dense_lookup_l0(jnp.asarray(lp), jtm)
    _check(got, want, rtol=0)
    if dense_d == 2:
        nodes = np.asarray(jtm.l0_states)[sids[rng.integers(0, 400, 15), 0]]
        nodes = nodes.reshape(3, 5).astype(np.int32)
        nodes[0, 0] = 0  # a sink parent has no continuation
        got = dense_mask.dense_lookup_l1(*_torch(lp, nodes), tm)
        want = jax_dense_mask.dense_lookup_l1(*_jax(lp, nodes), jtm)
        _check(got, want, rtol=0)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_cpu_tensors_route_to_the_plain_version(rng):
    rowptr, edges, nodes, x = _case(rng, 64, 6, 8)
    lp = torch.log_softmax(torch.from_numpy(x), -1).reshape(2, 3, 64)
    t_nodes, t_rp, t_edges = _torch(nodes.reshape(2, 3), rowptr, edges)
    before = dict(kv.LAUNCHES)
    for fused in (False, True):
        got = ops.vntk_topk(lp, t_nodes, t_rp, t_edges, 8, 64, 8,
                            fused_logsoftmax=fused)
        want = kv.vntk_topk_plain(lp.reshape(6, 64), t_nodes.reshape(-1),
                                  t_rp, t_edges, 8, 64, 8, fused)
        for g, w in zip(got, want):
            assert g.shape[:2] == (2, 3)
            assert torch.equal(g.reshape(w.shape), w)
    masked, nxt = ops.vntk(lp, t_nodes, t_rp, t_edges, 8, 64)
    assert torch.equal(masked.reshape(6, 64), kv.vntk_mask_plain(
        lp.reshape(6, 64), t_nodes.reshape(-1), t_rp, t_edges, 8, 64)[0])
    fl, fn = ops.vntk_fused_logsoftmax(lp, t_nodes, t_rp, t_edges, 8, 64,
                                       impl="plain")
    assert torch.equal(fn, nxt)
    assert kv.LAUNCHES == before  # no kernel launched on CPU tensors
    with pytest.raises(ValueError, match="impl"):
        ops.vntk(lp, t_nodes, t_rp, t_edges, 8, 64, impl="pallas")


def test_kernel_wrappers_reject_cpu_tensors(rng):
    rowptr, edges, nodes, x = _case(rng, 64, 4, 8)
    args = _torch(x, nodes, rowptr, edges)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_topk_cuda(*args, 8, 64, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vntk_mask_cuda(*args, 8, 64, fused=True)


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Importing the kernel modules builds nothing and needs no compiler."""
    code = ("import sys, repro_torch.kernels.ops, repro_torch.kernels.vntk, "
            "repro_torch.kernels.build; assert 'jax' not in sys.modules")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=tmp_path)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
