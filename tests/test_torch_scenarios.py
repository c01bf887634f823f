"""Port scenario registry and pipeline (DESIGN.md §12) on the CPU.

The registry's contracts as ``tests/test_scenarios.py`` states them for
the reference (names, smoke shrink, dotted overrides, seed precedence,
loud failure on typos), the trie-aware signal's arrays equal to the
reference's, the port's whole ``cold_start_amazon`` pipeline passing its
own gates and bit-reproducible under one seed, the catalog scenarios at
full compliance, ``spmd_smoke`` passing its gates (bit-identical to a
single-device retrieve) under both CSR placements, and the
``run_scenario`` launcher.  Everything runs with ``device="cpu"``; without
it every entry point wants the card.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.constraints.refresh import TrieSource as JaxTrieSource
from repro.scenarios import trie_signal as jax_trie_signal
from repro_torch.constraints import ConstraintRegistry
from repro_torch.constraints.refresh import TrieSource
from repro_torch.launch import run_scenario
from repro_torch.scenarios import (
    ScenarioRegistry,
    ScenarioSpec,
    ServeConfig,
    Stage,
    apply_overrides,
    config_to_dict,
    get_default_registry,
    parse_override,
    trie_signal,
)

TINY = {
    "data.n_items": 240,
    "data.n_users": 1_000,
    "data.n_clusters": 32,
    "data.feat_dim": 32,
    "data.cold_frac": 0.03,
    "tokenizer.train_steps": 40,
    "tokenizer.latent_dim": 16,
    "train.steps": 40,
    "train.batch": 32,
    "train.n_layers": 2,
    "train.d_model": 64,
    "train.n_heads": 2,
    "train.d_ff": 128,
    "serve.beam": 16,
    "serve.batch_size": 8,
    "eval.max_eval": 24,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: pytest-xdist runs several workers on the same
    cores, where these training loops of small ops slow down many times over
    when every worker's intra-op threads compete for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tiny(**extra):
    return get_default_registry().resolve(
        "cold_start_amazon", overrides={**TINY, **extra}, seed=0,
        device="cpu")


@pytest.fixture(scope="module")
def cold_ctx():
    run = _tiny()
    return run, run.run()


# ---------------------------------------------------------------------------
# registry + config resolution
# ---------------------------------------------------------------------------
def test_registry_builtin_names():
    reg = get_default_registry()
    assert set(reg.names) == {"cold_start_amazon", "multi_constraint",
                              "refresh_churn", "spmd_smoke"}
    assert set(reg.describe()) == set(reg.names)
    with pytest.raises(KeyError, match="cold_start_amazon"):
        reg.get("no_such_scenario")


def test_registry_rejects_name_mismatch_and_dupes():
    reg = ScenarioRegistry()
    spec = get_default_registry().get("multi_constraint")
    with pytest.raises(ValueError, match="!= config name"):
        reg.register(dataclasses.replace(spec, name="other_name"))
    reg.register(spec)
    with pytest.raises(ValueError, match="already registered"):
        reg.register(spec)


def test_resolve_precedence_smoke_then_overrides_then_seed():
    reg = get_default_registry()
    base = reg.get("cold_start_amazon").config
    smoked = reg.resolve("cold_start_amazon", smoke=True, device="cpu").config
    assert smoked.data.n_items < base.data.n_items
    run = reg.resolve("cold_start_amazon", smoke=True,
                      overrides={"data.n_items": 7_777}, seed=42,
                      device="cpu")
    assert run.config.data.n_items == 7_777
    assert run.config.seed == 42
    assert run.config.train.steps == smoked.train.steps
    assert run.device == torch.device("cpu")


def test_resolve_wants_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_default_registry().resolve("multi_constraint", smoke=True)


def test_overrides_fail_loudly_and_parse():
    cfg = get_default_registry().get("cold_start_amazon").config
    with pytest.raises(KeyError, match="cold_frac"):
        apply_overrides(cfg, {"data.cold_fraq": 0.05})
    with pytest.raises(KeyError, match="leaf"):
        apply_overrides(cfg, {"data.n_items.x": 1})
    assert parse_override("train.steps=40") == ("train.steps", 40)
    assert parse_override("data.cold_frac=0.05") == ("data.cold_frac", 0.05)
    assert parse_override("serve.fused=true") == ("serve.fused", True)
    assert parse_override("serve.engine=spmd") == ("serve.engine", "spmd")
    with pytest.raises(ValueError):
        parse_override("no-equals-sign")
    d = config_to_dict(get_default_registry().get("multi_constraint").config)
    assert d["serve"]["beam"] == 8 and isinstance(d["index"]["slots"], list)
    assert d["serve"]["impl"] is None


def test_serve_impl_takes_the_ports_values_only():
    cfg = get_default_registry().get("multi_constraint").config
    assert apply_overrides(cfg, {"serve.impl": "plain"}).serve.impl == "plain"
    for ref in ("xla", "pallas"):
        with pytest.raises(ValueError, match="not an implementation"):
            apply_overrides(cfg, {"serve.impl": ref})
    with pytest.raises(ValueError, match="xla"):
        ServeConfig(impl="xla")


def test_custom_spec_registration_resolves():
    reg = ScenarioRegistry()
    base = get_default_registry().get("multi_constraint")
    cfg = dataclasses.replace(base.config, name="my_tenant")
    reg.register(ScenarioSpec(name="my_tenant", description="custom",
                              config=cfg,
                              smoke_overrides=dict(base.smoke_overrides)))
    assert reg.resolve("my_tenant", smoke=True,
                       device="cpu").config.data.n_items == 800


# ---------------------------------------------------------------------------
# trie-aware signal: arrays equal to the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,V,L", [(3, 6, 3), (4, 16, 4)])
def test_trie_signal_arrays_equal_reference(seed, V, L):
    rng = np.random.default_rng(seed)
    sids = rng.integers(0, V, (80, L))
    for a, b in zip(trie_signal.admissible_stats(sids, V),
                    jax_trie_signal.admissible_stats(sids, V)):
        np.testing.assert_array_equal(a, b)
    uniq = np.unique(sids, axis=0)
    rng.shuffle(uniq)
    src, jsrc = (TrieSource.from_sids(uniq, V, dense_d=2),
                 JaxTrieSource.from_sids(uniq, V, dense_d=2))
    for a, b in zip(trie_signal.source_admissible(src),
                    jax_trie_signal.source_admissible(jsrc)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trie_signal.item_admissible(uniq, src),
                    jax_trie_signal.item_admissible(uniq, jsrc)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not present"):
        trie_signal.map_items_to_slab(np.full((1, L), V),
                                      np.asarray(src.sids))


# ---------------------------------------------------------------------------
# the port's pipeline end to end
# ---------------------------------------------------------------------------
def test_cold_start_pipeline_passes_its_gates(cold_ctx):
    _, ctx = cold_ctx
    res = ctx["result"]
    assert res["n_cold"] <= res["beam_size"]
    assert res["hit@M_static"] == 1.0  # beam >= n_cold: every cold SID
    assert res["hit@M_static"] > res["hit@M_unconstrained"]
    assert res["gates"] == {"static_beats_unconstrained": True,
                            "zero_unexpected_recompiles": True,
                            "passed": True}
    assert isinstance(ctx["registry"], ConstraintRegistry)
    assert ctx["store"] is ctx["registry"].current()[0]
    assert res["serve_meta"]["eval_slot"] == "cold_only"
    assert ctx["device"] == torch.device("cpu")


def test_cold_start_pipeline_is_bit_reproducible(cold_ctx):
    _, ctx1 = cold_ctx
    ctx2 = _tiny().run()
    np.testing.assert_array_equal(ctx1["sids"], ctx2["sids"])
    for arm in ("static", "unconstrained"):
        for a, b in zip(ctx1["serve_results"][arm], ctx2["serve_results"][arm]):
            np.testing.assert_array_equal(a, b)
    assert ctx1["result"] == ctx2["result"]


def test_resume_skips_completed_stages(cold_ctx):
    run, ctx = cold_ctx
    lines = []
    out = run.run(log=lines.append, ctx=dict(ctx))
    assert out["result"] == ctx["result"]
    assert sum("resumed from context" in ln for ln in lines) == 6
    partial = {k: v for k, v in ctx.items()
               if k not in ("serve_results", "serve_meta", "result",
                            "eval_targets")}
    lines = []
    out = run.run(log=lines.append, ctx=partial)
    ran = [ln.rsplit(" ", 1)[-1] for ln in lines if "running stage" in ln]
    assert ran == ["serve", "eval"]
    assert out["result"]["hit@M_static"] == ctx["result"]["hit@M_static"]


def test_trie_aware_training_runs_through_the_pipeline():
    res = _tiny(**{"train.trie_aware_weight": 0.5, "train.steps": 10,
                   "tokenizer.train_steps": 10}).run()["result"]
    assert res["gates"]["passed"]


def test_run_cold_start_experiment_keeps_the_legacy_surface():
    from repro_torch.pipelines import run_cold_start_experiment
    res = run_cold_start_experiment(
        cold_frac=0.02, seed=0, n_items=200, train_steps=0, beam_size=16,
        smoke=True, device="cpu")
    for key in ("cold_frac", "n_cold", "n_test", "recall@1_unconstrained",
                "recall@1_constrained_random", "recall@1_static"):
        assert key in res, key
    assert res["n_cold"] == 4 and res["hit@M_static"] == 1.0
    assert res["gates"]["passed"]


@pytest.mark.parametrize("name,overrides", [
    ("multi_constraint", {"data.n_items": 300, "serve.n_requests": 8}),
    ("refresh_churn", {"data.n_items": 300, "serve.n_requests": 8}),
])
def test_catalog_scenarios_full_compliance(name, overrides):
    res = get_default_registry().resolve(
        name, smoke=True, overrides=overrides, device="cpu").run()["result"]
    assert res["alive_beams"] > 0 and res["compliance"] == 1.0
    assert res["gates"]["passed"]
    meta = res["serve_meta"]
    if name == "refresh_churn":
        assert meta["versions"] == [1, 2, 3] and meta["cold_swaps"] == 0
    assert meta["unexpected_recompiles"] == 0


@pytest.mark.parametrize("overrides", [
    {}, {"serve.spmd_rows": "model", "serve.impl": "plain"}])
def test_spmd_smoke_passes_its_gates(overrides):
    """The SPMD engine over a world of one it creates (and destroys):
    full compliance and results bit-identical to a single-device
    retrieve."""
    res = get_default_registry().resolve(
        "spmd_smoke", smoke=True, overrides=overrides,
        device="cpu").run()["result"]
    assert res["serve_meta"]["engine"] == "spmd"
    assert res["alive_beams"] > 0 and res["compliance"] == 1.0
    assert res["spmd_bit_identical"] is True
    assert res["gates"]["spmd_bit_identical"] and res["gates"]["passed"]
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_run_scenario_on_cpu(tmp_path, capsys):
    assert run_scenario.main(["--list"]) == 0
    assert "refresh_churn" in capsys.readouterr().out
    path = tmp_path / "out.json"
    rc = run_scenario.main(
        ["--scenario", "multi_constraint", "--smoke", "--set",
         "data.n_items=300", "--set", "serve.n_requests=8", "--json",
         str(path), "--device", "cpu"])
    assert rc == 0
    art = json.loads(path.read_text())
    assert art["gates"]["passed"] and art["meta"]["device"] == "cpu"
    assert art["config"]["data"]["n_items"] == 300


def test_run_scenario_exits_nonzero_when_a_gate_fails(monkeypatch):
    class FailingEval(Stage):
        name = "eval"

        def provides(self, cfg):
            return ("result",)

        def run(self, cfg, ctx, log):
            ctx["result"] = {"gates": {"full_compliance": False,
                                       "passed": False}}

    reg = ScenarioRegistry()
    base = get_default_registry().get("multi_constraint")
    reg.register(dataclasses.replace(base, stages=lambda: (FailingEval(),)))
    monkeypatch.setattr(run_scenario, "get_default_registry", lambda: reg)
    assert run_scenario.main(["--scenario", "multi_constraint",
                              "--device", "cpu"]) == 1
