"""Declarative scenario configs (DESIGN.md §12; a copy of
``repro.scenarios.config``).

A :class:`ScenarioConfig` is a frozen tree of per-stage configs — data,
tokenizer, index, train, serve, eval — plus ONE explicit ``seed`` from which
every stochastic component derives its stream (dataset synthesis, RQ-VAE
init/batching, transformer init, the training batcher, and the
constrained-random eval baseline).  Two runs of the same config are
bit-reproducible (asserted in ``tests/test_torch_scenarios.py``).

Configs are *declarative*: nothing here touches torch or builds arrays.  The
:class:`~repro_torch.scenarios.registry.ScenarioRegistry` resolves a named config
into composed pipeline stages (the ``build_config`` idiom); callers
specialize a scenario with dotted-path overrides::

    cfg = apply_overrides(cfg, {"data.cold_frac": 0.05, "train.steps": 200})

which keeps the CLI (``--set data.cold_frac=0.05``), the benchmark harness,
and the tests on one override surface.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from repro_torch.kernels.ops import IMPLS

__all__ = [
    "SlotSpec",
    "DataConfig",
    "TokenizerConfig",
    "IndexConfig",
    "TrainConfig",
    "ServeConfig",
    "EvalConfig",
    "ScenarioConfig",
    "apply_overrides",
    "parse_override",
    "config_to_dict",
]


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One named constraint slot: a predicate kind + its parameters.

    Kinds (resolved by the IndexStage into registry predicates):

      * ``all``        — every catalog item is servable.
      * ``cold_only``  — the held-out cold-start items (newest ``age_days``
                         band; the paper's Table 3 serving set).
      * ``freshness``  — ``arg[0]`` = max age in days
                         (:func:`~repro_torch.constraints.freshness_window`).
      * ``category``   — ``arg`` = allow-listed category ids
                         (:func:`~repro_torch.constraints.category_allowlist`).
    """

    name: str
    kind: str = "all"
    arg: tuple = ()


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DataStage: which corpus, and its shape."""

    kind: str = "amazon_cold_start"  # | "synthetic_catalog"
    n_items: int = 2_000
    n_clusters: int = 64
    feat_dim: int = 64
    n_users: int = 6_000
    seq_len: int = 12
    cold_frac: float = 0.02
    # synthetic_catalog only: per-item metadata ranges
    n_categories: int = 8
    max_age_days: float = 90.0


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    """TokenizerStage: item -> Semantic ID.

    ``rqvae`` trains the residual quantizer on item features and appends the
    TIGER dedup token (SID length = ``n_levels + 1``); ``random`` draws SIDs
    uniformly (catalog-only scenarios that never train a model).
    """

    kind: str = "rqvae"  # | "random"
    n_levels: int = 3
    codebook_size: int = 256
    latent_dim: int = 32
    train_steps: int = 400
    batch: int = 256
    lr: float = 3e-3
    sid_length: int = 4  # "random" kind only; rqvae derives n_levels + 1

    @property
    def resolved_sid_length(self) -> int:
        return self.n_levels + 1 if self.kind == "rqvae" else self.sid_length


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """IndexStage: catalog -> ConstraintRegistry slots -> ConstraintStore."""

    dense_d: int = 2
    headroom: float = 0.5
    slots: tuple = (SlotSpec("servable", "all"),)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """TrainStage: the reduced generative-retrieval transformer."""

    steps: int = 500
    batch: int = 64
    lr: float = 1e-3
    log_every: int = 100
    # reduced GR transformer dims (gr_model_config)
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 256
    # Trie-aware auxiliary signal (DESIGN.md §12): weight on the
    # admissible-mass loss derived from the warm-item TrieSource slab's
    # per-prefix admissible sets.  0.0 = off (the default: plain LM loss).
    trie_aware_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """ServeStage: which engine fronts the constrained beam search.

    ``impl`` takes the port's values (:data:`~repro_torch.kernels.ops.IMPLS`),
    not the reference's ``"xla"``/``"pallas"``: a reference value raises.
    """

    engine: str = "batch"  # | "spmd" (SpmdServingEngine over a mesh)
    beam: int = 20
    batch_size: int = 16
    impl: Optional[str] = None
    fused: bool = False
    topk: bool = True
    spmd_rows: str = "replicated"
    eval_slot: str = "servable"  # slot whose constraint masks eval requests
    n_requests: int = 32  # catalog-only scenarios: synthetic request count
    hist_len: int = 16  # catalog-only scenarios: synthetic history width
    # refresh_churn scenario: async delta-refresh cycles between batches
    refresh_cycles: int = 0
    churn_frac: float = 0.01

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(
                f"serve.impl={self.impl!r} is not an implementation of the "
                f"port: it takes {IMPLS} (None: the CUDA kernels on the card, "
                "their plain versions on the CPU; 'plain': the plain PyTorch "
                "versions everywhere); the reference's 'xla'/'pallas' name "
                "JAX paths")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """EvalStage: metric protocol."""

    max_eval: int = 256  # cap on eval sequences (static serve shapes)
    with_unconstrained: bool = True  # serve the unconstrained baseline arm
    with_random: bool = True  # constrained-random guessing baseline


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """The full declarative launch surface for one scenario."""

    name: str
    seed: int = 0
    data: DataConfig = DataConfig()
    tokenizer: TokenizerConfig = TokenizerConfig()
    index: IndexConfig = IndexConfig()
    train: TrainConfig = TrainConfig()
    serve: ServeConfig = ServeConfig()
    eval: EvalConfig = EvalConfig()


# ---------------------------------------------------------------------------
# dotted-path overrides
# ---------------------------------------------------------------------------
def _replace_path(obj, parts: list[str], value):
    name = parts[0]
    names = {f.name for f in dataclasses.fields(obj)}
    if name not in names:
        raise KeyError(
            f"unknown config field {name!r} on {type(obj).__name__} "
            f"(known: {sorted(names)})"
        )
    if len(parts) == 1:
        return dataclasses.replace(obj, **{name: value})
    child = getattr(obj, name)
    if not dataclasses.is_dataclass(child):
        raise KeyError(
            f"{type(obj).__name__}.{name} is a leaf; cannot descend into "
            f"{'.'.join(parts[1:])!r}"
        )
    return dataclasses.replace(obj, **{name: _replace_path(child, parts[1:],
                                                           value)})


def apply_overrides(cfg: ScenarioConfig,
                    overrides: Mapping[str, Any]) -> ScenarioConfig:
    """A new config with dotted-path fields replaced.

    ``{"data.cold_frac": 0.05}`` replaces ``cfg.data.cold_frac``; unknown
    paths raise ``KeyError`` with the known field names (typos must fail
    loudly — a silently ignored override would run the WRONG experiment).
    """
    for path, value in overrides.items():
        cfg = _replace_path(cfg, path.split("."), value)
    return cfg


def parse_override(text: str) -> tuple[str, Any]:
    """CLI ``key=value`` -> (dotted path, typed value).

    Values parse as bool ("true"/"false"), int, float, then fall back to
    string — matching the scalar leaves of the config tree.
    """
    if "=" not in text:
        raise ValueError(f"override must be key=value, got {text!r}")
    path, raw = text.split("=", 1)
    low = raw.strip().lower()
    if low in ("true", "false"):
        return path.strip(), low == "true"
    for cast in (int, float):
        try:
            return path.strip(), cast(raw)
        except ValueError:
            pass
    return path.strip(), raw


def _jsonify(value):
    if dataclasses.is_dataclass(value):
        return {f.name: _jsonify(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


def config_to_dict(cfg) -> dict:
    """JSON-ready nested dict (tuples -> lists, dataclasses -> dicts)."""
    return _jsonify(cfg)
