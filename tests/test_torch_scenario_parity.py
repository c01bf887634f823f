"""The port's Index -> Serve -> Eval stages against the JAX reference's
``cold_start_amazon`` run.

One tiny reference run (RQ-VAE SIDs, a trained GR model, STATIC serving on
the cold-only slot) hands its Semantic IDs, its RQ-VAE and its model
weights to the port through the resumable context: the port's Data stage
regenerates the same corpus (bit-equal numpy), its Tokenizer and Train
stages are skipped, and its Index, Serve and Eval stages run on the CPU.
The constrained and unconstrained beams must equal the reference's, the
scores agree within rtol 1e-5 (float32 decoders summing in different
orders), and the hit metrics must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.scenarios import get_default_registry as jax_registry
from repro_torch.configs import TransformerConfig
from repro_torch.convert import params_from_jax, rqvae_params_from_jax
from repro_torch.scenarios import get_default_registry

# tests/test_scenarios.py's tiny config: 7 cold items, beam 16 >= n_cold
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


@pytest.fixture(scope="module")
def both():
    jctx = jax_registry().resolve("cold_start_amazon", overrides=TINY,
                                  seed=0).run()
    mcfg = TransformerConfig(**dataclasses.asdict(jctx["model_cfg"]))
    ctx = {k: jctx[k] for k in ("sids", "vocab", "sid_length", "rq_cfg")}
    ctx["rq_params"] = rqvae_params_from_jax(
        jax.tree.map(np.asarray, jctx["rq_params"]), device="cpu")
    ctx["params"] = params_from_jax(jax.tree.map(np.asarray, jctx["params"]),
                                    mcfg, device="cpu")
    ctx["model_cfg"] = mcfg
    lines = []
    run = get_default_registry().resolve("cold_start_amazon", overrides=TINY,
                                         seed=0, device="cpu")
    return jctx, run.run(log=lines.append, ctx=ctx), lines


def test_only_data_index_serve_eval_run(both):
    _, _, lines = both
    ran = [ln.rsplit(" ", 1)[-1] for ln in lines if "running stage" in ln]
    assert ran == ["data", "index", "serve", "eval"]


def test_data_and_index_equal_reference(both):
    jctx, ctx, _ = both
    for f in dataclasses.fields(jctx["data"]):
        np.testing.assert_array_equal(getattr(ctx["data"], f.name),
                                      getattr(jctx["data"], f.name))
    assert ctx["slots"] == jctx["slots"] == {"servable": 0, "cold_only": 1}
    for name in ctx["slots"]:
        np.testing.assert_array_equal(
            ctx["registry"].slot_sids(ctx["slots"][name]),
            jctx["registry"].slot_sids(jctx["slots"][name]))


@pytest.mark.parametrize("arm", ["static", "unconstrained"])
def test_serve_beams_equal_reference(both, arm):
    jctx, ctx, _ = both
    jb, js = jctx["serve_results"][arm]
    tb, ts = ctx["serve_results"][arm]
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    np.testing.assert_array_equal(ctx["eval_targets"], jctx["eval_targets"])


def test_hit_metrics_and_gates_equal_reference(both):
    jctx, ctx, _ = both
    want, got = jctx["result"], ctx["result"]
    for key in ("hit@M_static", "recall@1_static", "hit@M_unconstrained",
                "recall@1_unconstrained", "recall@1_constrained_random",
                "n_cold", "n_test"):
        assert got[key] == want[key], key
    assert got["gates"] == want["gates"]
    assert got["gates"]["passed"]
