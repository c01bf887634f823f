"""Port retrieval end to end against the JAX reference, and import guards.

``GenerativeRetriever.retrieve`` of both packages runs on the same converted
weights and trie.  SIDs must be equal and scores agree within 1e-4 (float32
matmul and reduction orders differ between the frameworks).  The seed is
chosen so the reference's consecutive top-M scores are at least 1e-3 apart,
which the test asserts, so no near-tie can flip the order.
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.core import TransitionMatrix as JaxTransitionMatrix
from repro.decoding import DecodePolicy as JaxDecodePolicy
from repro.models import transformer as jax_transformer
from repro.serving.generative_retrieval import (
    GenerativeRetriever as JaxGenerativeRetriever,
)
from repro_torch.configs.base import TransformerConfig
from repro_torch.convert import params_from_jax, transition_matrix_from_numpy
from repro_torch.decoding import DecodePolicy
from repro_torch.launch.serve import compliance, is_member
from repro_torch.serving import GenerativeRetriever

ROOT = pathlib.Path(__file__).resolve().parents[1]
V, L, M, B, S = 32, 4, 6, 2, 10
SEED = 2  # reference top-M score gaps >= 1e-3 (asserted below)
POLICIES = {"static": {}, "static_fused": dict(fused=True),
            "static_notopk": dict(topk=False)}


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxTransformerConfig(
        name="gr-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=34, dtype="float32", tie_embeddings=True,
        attn_chunk_q=8)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(SEED)
    sids = rng.integers(0, V, (400, L))
    jtm = JaxTransitionMatrix.from_sids(sids, V, dense_d=2)
    jparams = jax_transformer.init_params(jcfg, jax.random.key(SEED))
    hist = rng.integers(0, jcfg.vocab_size, (B, S))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    tm = transition_matrix_from_numpy(jtm, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, sids=sids, jtm=jtm, tm=tm,
                jparams=jparams, params=params, hist=hist)


@pytest.mark.parametrize("name", list(POLICIES))
def test_retrieve_matches_reference(setup, name):
    s = setup
    kw = POLICIES[name]
    want_sids, want_scores = JaxGenerativeRetriever(
        s["jparams"], s["jcfg"], JaxDecodePolicy.static(s["jtm"], **kw), L, V,
        beam_size=M).retrieve(s["hist"])
    assert (-np.diff(want_scores, axis=1)).min() >= 1e-3
    sids, scores = GenerativeRetriever(
        s["params"], s["cfg"], DecodePolicy.static(s["tm"], **kw), L, V,
        beam_size=M).retrieve(s["hist"])
    assert sids.dtype == np.int32 and sids.shape == (B, M, L)
    np.testing.assert_array_equal(sids, want_sids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    members, live = compliance(np.unique(s["sids"], axis=0), sids, scores)
    assert members == live == B * M


def test_is_member_walks_sorted_sids():
    sids = np.unique(np.array([[1, 2, 3], [1, 2, 5], [2, 0, 0], [0, 9, 9]]),
                     axis=0)
    assert is_member(sids, np.array([1, 2, 5]))
    assert not is_member(sids, np.array([1, 2, 4]))
    assert not is_member(sids, np.array([3, 0, 0]))


IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


EXAMPLES_TORCH = ("quickstart", "serve_constrained", "serve_multi_constraint",
                  "train_retrieval", "cold_start_amazon")


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += [ROOT / "examples" / f"{n}_torch.py" for n in EXAMPLES_TORCH]
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): IMPORT.findall(f.read_text())
                 for f in files}
    assert not {f: m for f, m in offenders.items() if m}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, importlib.util, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.core import beam_search, BeamState, recall_at_k, "
            "FlatTrie, build_flat_trie, random_constraint_set\n"
            "from repro_torch.decoding import ConstraintBackend, Impl, Rows\n"
            "assert callable(beam_search)\n"
            f"for n in {EXAMPLES_TORCH!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            f"        n, {str(ROOT / 'examples')!r} + f'/{{n}}_torch.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
