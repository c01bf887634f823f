"""Compatibility shims over the scenario pipeline (DESIGN.md §12;
``repro.pipelines``).

The end-to-end cold-start experiment lives in :mod:`repro_torch.scenarios`
— declarative :class:`~repro_torch.scenarios.ScenarioConfig`s resolved by
the :class:`~repro_torch.scenarios.ScenarioRegistry` into composed ``Data
-> Tokenizer -> Index -> Train -> Serve -> Eval`` stages, serving through
the production ``ConstraintRegistry`` + ``DecodePolicy`` + engine stack (no
hand-rolled masking).  This module keeps the historical entry points:

  * :func:`run_cold_start_experiment` — the paper's §6 protocol, returning
    the same result keys as before (plus the new hit@M metrics), now a thin
    wrapper over the ``cold_start_amazon`` scenario.
  * :func:`gr_model_config` / :func:`train_rqvae` — re-exported from
    :mod:`repro_torch.scenarios.stages`.

Prefer ``launch/run_scenario.py`` (or ``get_default_registry()`` directly)
for new code.
"""
from __future__ import annotations

from repro_torch.scenarios.stages import gr_model_config, train_rqvae

__all__ = ["run_cold_start_experiment", "train_rqvae", "gr_model_config"]


def run_cold_start_experiment(
    cold_frac: float = 0.02,
    seed: int = 0,
    n_items: int | None = None,
    train_steps: int | None = None,
    beam_size: int | None = None,
    log=lambda *a: None,
    smoke: bool = False,
    trie_aware_weight: float = 0.0,
    device=None,
) -> dict:
    """Run the ``cold_start_amazon`` scenario; returns its result dict.

    Keys match the historical surface (``recall@1_unconstrained``,
    ``recall@1_constrained_random``, ``recall@1_static``, ``cold_frac``,
    ``n_cold``, ``n_test``) plus ``hit@M_static`` / ``hit@M_unconstrained``
    and the ``gates`` block from the scenario's EvalStage.  ``None`` sizes
    defer to the scenario config (the full-size defaults, or the smoke
    shrink under ``smoke=True``).  Runs on ``device``: the card unless
    named.
    """
    from repro_torch.scenarios import get_default_registry

    overrides = {
        "data.cold_frac": cold_frac,
        "train.trie_aware_weight": trie_aware_weight,
    }
    if n_items is not None:
        overrides["data.n_items"] = n_items
    if train_steps is not None:
        overrides["train.steps"] = train_steps
    if beam_size is not None:
        overrides["serve.beam"] = beam_size
    run = get_default_registry().resolve(
        "cold_start_amazon", smoke=smoke, overrides=overrides, seed=seed,
        device=device,
    )
    ctx = run.run(log=log)
    return ctx["result"]
