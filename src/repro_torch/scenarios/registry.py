"""ScenarioRegistry: named declarative configs -> composed pipelines
(``repro.scenarios.registry``).

The registry is the single launch surface (DESIGN.md §12): a scenario is a
frozen :class:`~repro_torch.scenarios.config.ScenarioConfig` plus the stage
chain that realizes it; ``resolve`` specializes it (``--smoke`` shrink,
dotted ``--set`` overrides, seed, device) into a :class:`ScenarioRun` whose
``run()`` executes the pipeline on that device (the card unless the caller
names another) and returns the artifact context (``ctx["result"]`` carries
the metrics + gates).

Which scenario when (also in DESIGN.md §12):

==================  =====================================================
cold_start_amazon   The paper's Table 3 protocol end-to-end: RQ-VAE SIDs,
                    GR training on no-cold sequences, STATIC serving on
                    the cold-only registry slot, hit@M vs unconstrained.
multi_constraint    Mixed-tenant serving: one batch decoded under K
                    staggered freshness slots + a category slot, 100%
                    per-request compliance required.
refresh_churn       multi_constraint under live catalog churn: an
                    AsyncRefresher splices deltas between batches; swaps
                    must stay zero-recompile.
spmd_smoke          The multi-constraint batch served through the SPMD
                    engine over a debug mesh of the world's ranks,
                    bit-identical to a single-device retrieve.
==================  =====================================================
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.scenarios.config import (
    DataConfig,
    EvalConfig,
    IndexConfig,
    ScenarioConfig,
    ServeConfig,
    SlotSpec,
    TokenizerConfig,
    TrainConfig,
    apply_overrides,
)
from repro_torch import resolve_device
from repro_torch.scenarios.stages import default_stages, run_pipeline

__all__ = [
    "ScenarioSpec",
    "ScenarioRun",
    "ScenarioRegistry",
    "get_default_registry",
]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A registered scenario: full-size config + its smoke shrink."""

    name: str
    description: str
    config: ScenarioConfig
    smoke_overrides: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    stages: Callable[[], tuple] = default_stages


@dataclasses.dataclass(frozen=True)
class ScenarioRun:
    """A resolved scenario, ready to execute (and re-enter via ``ctx``)."""

    config: ScenarioConfig
    stages: tuple
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device(None))

    def run(self, log=lambda *a: None, ctx: Optional[dict] = None) -> dict:
        """Execute the pipeline on ``self.device``; returns the artifact
        context.

        ``ctx["result"]`` holds the metrics + gates dict.  Pass a context
        from a previous run to resume: stages whose artifacts are present
        are skipped (see :func:`~repro_torch.scenarios.stages.run_pipeline`).
        """
        return run_pipeline(self.stages, self.config, log=log, ctx=ctx,
                            device=self.device)


class ScenarioRegistry:
    def __init__(self):
        self._specs: dict[str, ScenarioSpec] = {}

    def register(self, spec: ScenarioSpec) -> None:
        if spec.name in self._specs:
            raise ValueError(f"scenario {spec.name!r} already registered")
        if spec.config.name != spec.name:
            raise ValueError(
                f"spec name {spec.name!r} != config name "
                f"{spec.config.name!r}")
        self._specs[spec.name] = spec

    @property
    def names(self) -> tuple:
        return tuple(self._specs)

    def get(self, name: str) -> ScenarioSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown scenario {name!r}; registered: "
                f"{sorted(self._specs)}"
            ) from None

    def describe(self) -> dict:
        return {n: s.description for n, s in self._specs.items()}

    def resolve(self, name: str, *, smoke: bool = False,
                overrides: Optional[Mapping[str, Any]] = None,
                seed: Optional[int] = None, device=None) -> ScenarioRun:
        """Specialize a named scenario into a runnable pipeline on
        ``device`` (the card unless named; raises without one).

        Order: base config -> smoke shrink -> caller overrides -> seed, so
        an explicit ``--set`` beats the smoke preset and ``--seed`` beats
        both.
        """
        dev = resolve_device(device)
        spec = self.get(name)
        cfg = spec.config
        if smoke:
            cfg = apply_overrides(cfg, spec.smoke_overrides)
        if overrides:
            cfg = apply_overrides(cfg, overrides)
        if seed is not None:
            cfg = dataclasses.replace(cfg, seed=seed)
        return ScenarioRun(config=cfg, stages=tuple(spec.stages()),
                           device=dev)


# ---------------------------------------------------------------------------
# built-in scenarios
# ---------------------------------------------------------------------------
def _cold_start_amazon() -> ScenarioSpec:
    cfg = ScenarioConfig(
        name="cold_start_amazon",
        data=DataConfig(kind="amazon_cold_start", n_items=2_000,
                        cold_frac=0.02),
        tokenizer=TokenizerConfig(kind="rqvae", n_levels=3,
                                  codebook_size=256, train_steps=400),
        index=IndexConfig(slots=(
            SlotSpec("servable", "all"),
            SlotSpec("cold_only", "cold_only"),
        )),
        train=TrainConfig(steps=500, batch=64),
        serve=ServeConfig(engine="batch", beam=20, batch_size=16,
                          eval_slot="cold_only"),
        eval=EvalConfig(max_eval=256),
    )
    return ScenarioSpec(
        name="cold_start_amazon",
        description=("Table 3 end-to-end: RQ-VAE SIDs -> GR training -> "
                     "STATIC serving on the cold-only slot, hit@M vs "
                     "unconstrained"),
        config=cfg,
        smoke_overrides={
            "data.n_items": 400,
            "data.n_users": 1_200,
            "tokenizer.train_steps": 60,
            "train.steps": 60,
            "train.batch": 32,
            "serve.batch_size": 8,
            "eval.max_eval": 48,
        },
    )


def _multi_constraint() -> ScenarioSpec:
    cfg = ScenarioConfig(
        name="multi_constraint",
        data=DataConfig(kind="synthetic_catalog", n_items=5_000,
                        n_categories=8, max_age_days=90.0),
        tokenizer=TokenizerConfig(kind="random", codebook_size=256,
                                  sid_length=4),
        index=IndexConfig(slots=(
            SlotSpec("fresh_22", "freshness", (22.5,)),
            SlotSpec("fresh_45", "freshness", (45.0,)),
            SlotSpec("fresh_67", "freshness", (67.5,)),
            SlotSpec("fresh_90", "freshness", (90.0,)),
            SlotSpec("cat_01", "category", (0, 1)),
        )),
        train=TrainConfig(steps=0),
        serve=ServeConfig(engine="batch", beam=8, batch_size=8,
                          n_requests=32, hist_len=16),
        eval=EvalConfig(with_unconstrained=False, with_random=False),
    )
    return ScenarioSpec(
        name="multi_constraint",
        description=("mixed-tenant batch under staggered freshness + "
                     "category slots; 100% per-request compliance"),
        config=cfg,
        smoke_overrides={
            "data.n_items": 800,
            "serve.n_requests": 16,
        },
    )


def _refresh_churn() -> ScenarioSpec:
    base = _multi_constraint().config
    cfg = dataclasses.replace(
        base, name="refresh_churn",
        serve=dataclasses.replace(base.serve, refresh_cycles=3,
                                  churn_frac=0.01),
    )
    return ScenarioSpec(
        name="refresh_churn",
        description=("multi_constraint under live churn: AsyncRefresher "
                     "deltas between batches, zero-recompile hot swaps"),
        config=cfg,
        smoke_overrides={
            "data.n_items": 600,
            "serve.n_requests": 8,
            "serve.refresh_cycles": 2,
        },
    )


def _spmd_smoke() -> ScenarioSpec:
    base = _multi_constraint().config
    cfg = dataclasses.replace(
        base, name="spmd_smoke",
        serve=dataclasses.replace(base.serve, engine="spmd", n_requests=8,
                                  batch_size=8),
    )
    return ScenarioSpec(
        name="spmd_smoke",
        description=("the mixed-constraint batch through the SPMD engine "
                     "over a debug mesh, bit-identical to single-device"),
        config=cfg,
        smoke_overrides={
            "data.n_items": 600,
        },
    )


_DEFAULT: Optional[ScenarioRegistry] = None


def get_default_registry() -> ScenarioRegistry:
    """The process-wide registry with the built-in scenarios installed."""
    global _DEFAULT
    if _DEFAULT is None:
        reg = ScenarioRegistry()
        for build in (_cold_start_amazon, _multi_constraint,
                      _refresh_churn, _spmd_smoke):
            reg.register(build())
        _DEFAULT = reg
    return _DEFAULT
