"""The five examples in torch form (``examples/*_torch.py``) on the CPU, the
port's import surface, and the two helpers of ``core/trie.py`` it adds.

The reference's examples are loaded by path, unedited.  ``quickstart``
prints the reference's lines (the policy line names the port's ``impl``);
``serve_constrained`` and ``serve_multi_constraint`` run at their own
sizes; ``train_retrieval`` runs at reduced steps passed to
``main``, and its resumed run's last loss is bit-equal to an uninterrupted
run's; ``cold_start_amazon``'s flags resolve the reference example's
scenario config.  The examples' kernel launches are held on the card in
``chip_smoke.py`` (phase 16).
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core import trie as jax_trie
from repro.scenarios import config_to_dict as jax_config_to_dict
from repro_torch.constraints import ConstraintStore
from repro_torch.core import TransitionMatrix
from repro_torch.core import trie as torch_trie
from repro_torch.core.baselines import CpuTrieBaseline
from repro_torch.decoding import (
    ConstraintBackend,
    CpuTrieBackend,
    HashBitmapBackend,
    PPVBackend,
    StackedStaticBackend,
    StaticBackend,
    UnconstrainedBackend,
)
from repro_torch.scenarios import config_to_dict

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers on the same
    cores, where these loops of small ops slow down many times over when
    every worker's intra-op threads compete for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if not ln.startswith("decode policy:")]


def _topk_levels(res) -> int:
    return sum(row["topk"] for row in res["plan"])


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------
def test_quickstart_prints_the_references_lines(capsys):
    load("quickstart").main()
    ref = capsys.readouterr().out
    res = load("quickstart_torch").main(CPU)
    port = capsys.readouterr().out
    assert _lines(port) == _lines(ref)
    assert "decode policy: L0-1:dense-bitpack L2-3:vntk[auto+topk]" in port
    assert res["compliance"] is True and res["n_valid"] == 61
    assert _topk_levels(res) == 2  # the kernel's launches a search


def test_serve_constrained_on_the_cpu(capsys):
    res = load("serve_constrained_torch").main(CPU)
    assert res["compliance"] is True
    assert res["lengths"] == [6] * 8
    assert res["searches"] == 6 and _topk_levels(res) == 2
    assert "100% compliance: True" in capsys.readouterr().out


def test_serve_multi_constraint_swaps_without_specializing():
    res = load("serve_multi_constraint_torch").main(CPU)
    assert res["new_compiles"] == 0
    ok, total = res["compliance"]
    ok2, total2 = res["compliance_after_swap"]
    assert ok == total == 72 and ok2 == total2 == 48
    assert res["versions"] == [res["swap_version"]] == [2]
    assert res["batches_before_swap"] == 3 and res["searches"] == 5


def test_train_retrieval_resumes_bit_exactly(tmp_path):
    """The example's own claim of an exact resume: the int8 error-feedback
    residual, the optimizer state and the loader cursor cross the
    checkpoint, so the last loss equals an uninterrupted run's bit for bit
    (as the reference's ``Trainer`` does at the same steps)."""
    from repro_torch.data.loader import ShardedBatcher
    from repro_torch.models import transformer
    from repro_torch.scenarios import gr_model_config
    from repro_torch.training.optimizer import adamw

    ex = load("train_retrieval_torch")
    steps = dict(rqvae_steps=20, crash_step=4, n_steps=6, ckpt_every=2)
    res = ex.main(CPU + ["--ckpt-dir", str(tmp_path / "ckpt")], **steps)
    assert (res["resumed_step"], res["final_step"]) == (4, 6)
    assert len(res["losses"]) == 6 and np.all(np.isfinite(res["losses"]))

    tokens = ex.corpus_tokens(20, torch.device("cpu"), log=lambda *a: None)
    cfg = gr_model_config(256)
    whole = ex.Trainer(ex.loss_fn_for(cfg), adamw(lr=1e-3),
                       transformer.init_params(cfg, seed=0, device="cpu"),
                       ex.trainer_config(6, None, 2))
    losses = whole.fit(ShardedBatcher({"tokens": tokens}, global_batch=64,
                                      seed=0), log=lambda *a: None)
    assert losses == res["losses"]  # floats compared exactly


def _reference_cold_start_config(argv, monkeypatch):
    """The config the reference example resolves for ``argv`` (its run is
    stopped before any stage)."""
    mod = load("cold_start_amazon")
    registry = mod.get_default_registry()
    seen = {}

    class Resolved(Exception):
        pass

    class Recorder:
        def resolve(self, *a, **kw):
            seen["config"] = registry.resolve(*a, **kw).config
            raise Resolved

    monkeypatch.setattr(mod, "get_default_registry", Recorder)
    monkeypatch.setattr(sys, "argv", ["cold_start_amazon.py", *argv])
    with pytest.raises(Resolved):
        mod.main()
    return seen["config"]


@pytest.mark.parametrize("argv", [
    [], ["--quick"], ["--cold-frac", "0.05"],
    ["--quick", "--cold-frac", "0.1", "--trie-aware", "0.5"],
])
def test_cold_start_flags_resolve_the_references_config(argv, monkeypatch):
    ref = jax_config_to_dict(_reference_cold_start_config(argv, monkeypatch))
    run = load("cold_start_amazon_torch").resolve(argv + CPU)
    port = config_to_dict(run.config)
    # the port's impl values are its own (ROADMAP §3, "Training")
    assert (ref["serve"].pop("impl"), port["serve"].pop("impl")) == ("xla",
                                                                     None)
    assert port == ref
    assert run.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# helpers and surfaces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2026])
def test_random_constraint_set_equals_the_references(seed):
    args = (1_000, 2_048, 8)
    got = torch_trie.random_constraint_set(np.random.default_rng(seed), *args)
    want = jax_trie.random_constraint_set(np.random.default_rng(seed), *args)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 8, 13, 64, 70])
def test_unpack_bits_word_inverts_pack_bits(n):
    bits = np.random.default_rng(n).random((3, n)) < 0.5
    packed = torch_trie.pack_bits(bits)
    got = torch_trie.unpack_bits_word(packed, n)
    np.testing.assert_array_equal(got, bits)
    np.testing.assert_array_equal(
        got, jax_trie.unpack_bits_word(jax_trie.pack_bits(bits), n))


def test_core_exports_the_beam_search_function():
    from repro_torch.core import beam_search

    import repro_torch.core.beam_search as via_import
    from repro_torch.core.beam_search import BeamState

    assert callable(beam_search) and via_import is beam_search
    assert BeamState.__module__ == "repro_torch.core.beam_search"


def test_every_backend_is_a_constraint_backend():
    rng = np.random.default_rng(0)
    sids = rng.integers(0, 32, size=(200, 4))
    tm = TransitionMatrix.from_sids(sids, 32, dense_d=1, device="cpu")
    store = ConstraintStore.from_matrices([tm, tm], device="cpu")
    backends = [
        StaticBackend(tm), StackedStaticBackend(store),
        CpuTrieBackend(CpuTrieBaseline(sids, 32)),
        PPVBackend.from_sids(sids, 32, device="cpu"),
        HashBitmapBackend.from_sids(sids, 32, log2_bits=12, device="cpu"),
        UnconstrainedBackend(),
    ]
    assert all(isinstance(b, ConstraintBackend) for b in backends)
    assert not isinstance(tm, ConstraintBackend)
