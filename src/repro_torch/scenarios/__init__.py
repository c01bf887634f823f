"""Scenario registry: one declarative launch surface (DESIGN.md §12; the
port of ``repro.scenarios``).

A scenario is a frozen :class:`ScenarioConfig` resolved by the
:class:`ScenarioRegistry` into a composed, resumable pipeline of stages
(``Data -> Tokenizer -> Index -> Train -> Serve -> Eval``).  Quickstart::

    from repro_torch.scenarios import get_default_registry

    run = get_default_registry().resolve("cold_start_amazon", smoke=True)
    # (on the card; add device="cpu" for the plain PyTorch path)
    ctx = run.run(log=print)
    print(ctx["result"])          # metrics + gates

or from the CLI::

    PYTHONPATH=src python -m repro_torch.launch.run_scenario \\
        --scenario cold_start_amazon --smoke --json build/coldstart.json
"""
from repro_torch.scenarios import trie_signal
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
    config_to_dict,
    parse_override,
)
from repro_torch.scenarios.registry import (
    ScenarioRegistry,
    ScenarioRun,
    ScenarioSpec,
    get_default_registry,
)
from repro_torch.scenarios.stages import (
    DataStage,
    EvalStage,
    IndexStage,
    ServeStage,
    Stage,
    TokenizerStage,
    TrainStage,
    default_stages,
    gr_model_config,
    run_pipeline,
    train_rqvae,
)

__all__ = [
    "ScenarioConfig", "DataConfig", "TokenizerConfig", "IndexConfig",
    "TrainConfig", "ServeConfig", "EvalConfig", "SlotSpec",
    "apply_overrides", "parse_override", "config_to_dict",
    "ScenarioRegistry", "ScenarioRun", "ScenarioSpec",
    "get_default_registry",
    "Stage", "DataStage", "TokenizerStage", "IndexStage", "TrainStage",
    "ServeStage", "EvalStage", "default_stages", "run_pipeline",
    "gr_model_config", "train_rqvae", "trie_signal",
]
