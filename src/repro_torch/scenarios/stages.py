"""Composable pipeline stages: Data -> Tokenizer -> Index -> Train -> Serve
-> Eval (DESIGN.md §12; ``repro.scenarios.stages``).

Each stage consumes the frozen :class:`~repro_torch.scenarios.config
.ScenarioConfig` plus a mutable context dict and deposits the artifacts it
``provides``.  :func:`run_pipeline` composes them and makes the pipeline
*resumable*: a stage whose provided keys are already in the context is
skipped, so a caller can re-enter with a partially populated context (e.g.
re-serve under a new constraint slot without re-training).

The cold-start loop runs through the port's production stack: RQ-VAE
Semantic IDs (:mod:`repro_torch.models.rqvae`), the slots' tries through
:class:`~repro_torch.constraints.ConstraintRegistry`, training through the
:class:`~repro_torch.training.Trainer`, and serving through
``DecodePolicy.stacked`` + :class:`~repro_torch.serving.generative_retrieval
.GenerativeRetriever` behind a :class:`~repro_torch.serving.engine
.ServingEngine` — on the card, the stacked top-k VNTK kernel.  With
``serve.engine="spmd"`` the serve stage runs
:class:`~repro_torch.serving.spmd_engine.SpmdServingEngine` over a process
mesh of the world that exists (or a world of one it creates and destroys),
and the eval stage gates its results bit-identical to a single-device
retrieve.

Every stage runs on ``ctx["device"]`` (set by :func:`run_pipeline`: the
card unless the caller names another).  Seed discipline: every stochastic
component derives its stream from ``cfg.seed`` plus a documented offset
(the ``SEED_*`` constants), so two runs of one config on one device are
bit-reproducible.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RQVAEConfig, TransformerConfig
from repro_torch.constraints import (
    AsyncRefresher,
    CatalogDelta,
    ConstraintRegistry,
    ItemCatalog,
    TrieSource,
    category_allowlist,
    freshness_window,
    synthetic_catalog,
)
from repro_torch.core.vntk import NEG_INF
from repro_torch.data.amazon import make_cold_start_dataset
from repro_torch.data.loader import ShardedBatcher
from repro_torch.decoding import DecodePolicy
from repro_torch.launch.mesh import make_debug_mesh, world
from repro_torch.models import rqvae, transformer
from repro_torch.scenarios import trie_signal
from repro_torch.scenarios.config import ScenarioConfig, SlotSpec
from repro_torch.serving.engine import RequestQueue, ServingEngine
from repro_torch.serving.generative_retrieval import GenerativeRetriever
from repro_torch.serving.spmd_engine import SpmdRetriever, SpmdServingEngine
from repro_torch.training.optimizer import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig
from repro_torch.training.tree import tree_leaves, unflatten_like

__all__ = [
    "Stage",
    "DataStage",
    "TokenizerStage",
    "IndexStage",
    "TrainStage",
    "ServeStage",
    "EvalStage",
    "default_stages",
    "run_pipeline",
    "gr_model_config",
    "train_rqvae",
]

# One config seed, documented per-component offsets (bit-reproducibility):
SEED_DATA = 0  # corpus + split synthesis
SEED_RQVAE = 1  # RQ-VAE init + its training batch stream
SEED_MODEL = 2  # transformer init
SEED_BATCHER = 3  # ShardedBatcher epoch shuffles
SEED_REQUESTS = 5  # synthetic serving requests (catalog scenarios)
SEED_CHURN = 6  # refresh-churn delta sampling
SEED_BASELINE = 7  # constrained-random guessing baseline


def _noop_log(*a):  # pragma: no cover - default sink
    pass


def gr_model_config(vocab: int = 256, *, n_layers: int = 4,
                    d_model: int = 128, n_heads: int = 4, d_ff: int = 256,
                    name: str = "gr-coldstart") -> TransformerConfig:
    """The reduced generative-retrieval transformer (paper §6 scale)."""
    return TransformerConfig(
        name=name,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=vocab,
        head_dim=d_model // n_heads,
        tie_embeddings=True,
        dtype="float32",
        attn_chunk_q=64,
        attn_chunk_kv=64,
    )


def train_rqvae(feats: np.ndarray, cfg: RQVAEConfig, steps: int = 400,
                seed: int = 0, lr: float = 3e-3, batch: int = 256,
                log=_noop_log, device=None, params=None):
    """Train the RQ-VAE tokenizer on item features; returns its params.

    Starts from ``params`` when given (e.g. weights carried over from the
    reference), else from :func:`rqvae.init_params` at ``seed``; the batch
    stream is ``np.random.default_rng(seed)``'s, as in the reference.
    """
    dev = resolve_device(device)
    if params is None:
        params = rqvae.init_params(cfg, seed=seed, device=dev)
    opt = adamw(lr=lr, weight_decay=0.0)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    leaves = tree_leaves(params)
    for i in range(steps):
        idx = rng.integers(0, feats.shape[0], batch)
        x = torch.as_tensor(feats[idx], device=dev)
        for p in leaves:
            p.requires_grad_(True)
        loss = rqvae.rqvae_loss(params, x, cfg)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        params, state = opt.update(unflatten_like(params, grads), state,
                                   params, i)
        if i % 100 == 0:
            log(f"rqvae step {i}: loss {float(loss.detach()):.4f}")
    return params


# ---------------------------------------------------------------------------
# stage protocol
# ---------------------------------------------------------------------------
class Stage:
    """One pipeline step: reads config + context, deposits ``provides``."""

    name = "stage"

    def provides(self, cfg: ScenarioConfig) -> tuple:
        """Context keys this stage deposits (the resume/skip contract)."""
        return ()

    def run(self, cfg: ScenarioConfig, ctx: dict, log) -> None:
        raise NotImplementedError


def run_pipeline(stages, cfg: ScenarioConfig, log=_noop_log,
                 ctx: dict | None = None, device=None) -> dict:
    """Run ``stages`` in order over a shared context; returns the context.

    The stages run on ``ctx["device"]``: the one a resumed context carries,
    else ``device`` (the card unless named).  A stage whose ``provides``
    keys are all present is skipped — pass a pre-populated ``ctx`` to
    resume mid-pipeline.
    """
    ctx = {} if ctx is None else ctx
    if "device" not in ctx:
        ctx["device"] = resolve_device(device)
    for stage in stages:
        keys = stage.provides(cfg)
        if keys and all(k in ctx for k in keys):
            log(f"[{cfg.name}] {stage.name}: resumed from context, skipping")
            continue
        log(f"[{cfg.name}] running stage: {stage.name}")
        stage.run(cfg, ctx, log)
        missing = [k for k in keys if k not in ctx]
        if missing:
            raise RuntimeError(
                f"stage {stage.name!r} did not provide {missing}"
            )
    return ctx


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------
class DataStage(Stage):
    name = "data"

    def provides(self, cfg):
        if cfg.data.kind == "amazon_cold_start":
            return ("data",)
        return ("catalog",)

    def run(self, cfg, ctx, log):
        d = cfg.data
        if d.kind == "amazon_cold_start":
            data = make_cold_start_dataset(
                seed=cfg.seed + SEED_DATA, n_items=d.n_items,
                n_clusters=d.n_clusters, feat_dim=d.feat_dim,
                n_users=d.n_users, seq_len=d.seq_len, cold_frac=d.cold_frac,
            )
            ctx["data"] = data
            log(f"  {d.n_items} items, {data.cold_items.shape[0]} cold, "
                f"{data.train_seqs.shape[0]} train / "
                f"{data.test_seqs.shape[0]} test sequences")
        elif d.kind == "synthetic_catalog":
            rng = np.random.default_rng(cfg.seed + SEED_DATA)
            ctx["catalog"] = synthetic_catalog(
                rng, d.n_items, cfg.tokenizer.codebook_size,
                cfg.tokenizer.resolved_sid_length,
                n_categories=d.n_categories, max_age_days=d.max_age_days,
            )
            log(f"  synthetic catalog: {d.n_items} items, "
                f"{d.n_categories} categories")
        else:
            raise ValueError(f"unknown data kind {d.kind!r}")


class TokenizerStage(Stage):
    name = "tokenizer"

    def provides(self, cfg):
        base = ("sids", "vocab", "sid_length")
        if cfg.tokenizer.kind == "rqvae":
            return base + ("rq_params", "rq_cfg")
        return base

    def run(self, cfg, ctx, log):
        t = cfg.tokenizer
        if t.kind == "rqvae":
            data, dev = ctx["data"], ctx["device"]
            rq_cfg = RQVAEConfig(
                feat_dim=data.item_feats.shape[1], latent_dim=t.latent_dim,
                n_levels=t.n_levels, codebook_size=t.codebook_size,
            )
            rq_params = train_rqvae(
                data.item_feats, rq_cfg, steps=t.train_steps,
                seed=cfg.seed + SEED_RQVAE, lr=t.lr, batch=t.batch, log=log,
                device=dev,
            )
            levels = rqvae.encode_to_sids(
                rq_params, torch.as_tensor(data.item_feats, device=dev),
                rq_cfg).cpu().numpy()
            # TIGER's collision fix: L = n_levels RQ codes + 1 dedup token
            sids = rqvae.assign_dedup_tokens(
                levels, t.codebook_size).astype(np.int64)
            ctx["rq_params"], ctx["rq_cfg"] = rq_params, rq_cfg
            ctx["sids"] = sids
            ctx["vocab"] = t.codebook_size
            ctx["sid_length"] = sids.shape[1]
            n_unique = np.unique(sids, axis=0).shape[0]
            log(f"  unique SIDs: {n_unique}/{sids.shape[0]}")
        elif t.kind == "random":
            cat = ctx["catalog"]
            ctx["sids"] = np.asarray(cat.sids)
            ctx["vocab"] = t.codebook_size
            ctx["sid_length"] = cat.sids.shape[1]
        else:
            raise ValueError(f"unknown tokenizer kind {t.kind!r}")


class IndexStage(Stage):
    name = "index"

    def provides(self, cfg):
        return ("registry", "store", "slots", "catalog", "predicates")

    def _predicate(self, spec: SlotSpec, ctx):
        if spec.kind == "all":
            return lambda cat: np.ones(cat.sids.shape[0], dtype=bool)
        if spec.kind == "cold_only":
            data = ctx.get("data")
            if data is None:
                raise ValueError(
                    "cold_only slots need the amazon_cold_start data kind"
                )
            # age_days maps the newest (cold) band to [0, n_cold), so a
            # freshness window at n_cold - 0.5 selects exactly the cold set
            return freshness_window(data.cold_items.shape[0] - 0.5)
        if spec.kind == "freshness":
            return freshness_window(float(spec.arg[0]))
        if spec.kind == "category":
            return category_allowlist(*(int(c) for c in spec.arg))
        raise ValueError(f"unknown slot kind {spec.kind!r}")

    def run(self, cfg, ctx, log):
        if "catalog" not in ctx:
            data = ctx["data"]
            ctx["catalog"] = ItemCatalog(
                sids=ctx["sids"], age_days=data.age_days,
                category=data.item_cluster.astype(np.int64),
            )
        reg = ConstraintRegistry(
            ctx["vocab"], dense_d=cfg.index.dense_d,
            headroom=cfg.index.headroom, device=ctx["device"],
        )
        predicates = {}
        for spec in cfg.index.slots:
            pred = self._predicate(spec, ctx)
            reg.register(spec.name, pred)
            predicates[spec.name] = pred
        store = reg.build(ctx["catalog"])
        ctx["registry"] = reg
        ctx["store"] = store
        ctx["slots"] = {name: i for i, name in enumerate(reg.names)}
        ctx["predicates"] = predicates
        log(f"  registry v{reg.version}: slots {list(reg.names)}, "
            f"envelope {store.n_states} states")


class TrainStage(Stage):
    name = "train"

    def provides(self, cfg):
        return ("params", "model_cfg")

    def run(self, cfg, ctx, log):
        tr, dev = cfg.train, ctx["device"]
        V, L = ctx["vocab"], ctx["sid_length"]
        mcfg = gr_model_config(
            V, n_layers=tr.n_layers, d_model=tr.d_model,
            n_heads=tr.n_heads, d_ff=tr.d_ff,
        )
        params = transformer.init_params(mcfg, seed=cfg.seed + SEED_MODEL,
                                         device=dev)
        ctx["model_cfg"] = mcfg
        data = ctx.get("data")
        if data is None or tr.steps <= 0:
            # catalog-only scenarios exercise the serving path, not model
            # quality — an initialized model is all they need
            ctx["params"] = params
            return
        sids = ctx["sids"]
        train_tokens = sids[data.train_seqs].reshape(
            data.train_seqs.shape[0], -1).astype(np.int32)
        arrays = {"tokens": train_tokens}
        if tr.trie_aware_weight > 0.0:
            # admissible sets from the WARM-item trie slab only — the cold
            # set is invisible at train time, exactly as at serve time
            warm = np.ones(data.n_items, dtype=bool)
            warm[data.cold_items] = False
            warm_idx = np.flatnonzero(warm)
            source = TrieSource.from_sids(
                sids[warm_idx], V, dense_d=cfg.index.dense_d)
            sizes_w, masks_w = trie_signal.item_admissible(
                sids[warm_idx], source)
            masks = np.ones((data.n_items, L, V), dtype=bool)
            masks[warm_idx] = masks_w  # cold rows never appear in train_seqs
            masks_dev = torch.as_tensor(masks, device=dev)
            arrays["items"] = data.train_seqs.astype(np.int32)
            weight = float(tr.trie_aware_weight)
            log(f"  trie-aware signal on (weight {weight}); mean admissible "
                f"set size by level: "
                f"{np.round(sizes_w.mean(axis=0), 1).tolist()}")

            def loss_fn(p, batch):
                adm = masks_dev[batch["items"].long()]  # (B, T, L, V)
                adm = adm.reshape(adm.shape[0], -1, V)
                return transformer.lm_loss_trie_aware(
                    p, batch["tokens"], mcfg, adm, weight)
        else:
            def loss_fn(p, batch):
                return transformer.lm_loss(p, batch["tokens"], mcfg)

        trainer = Trainer(
            loss_fn, adamw(lr=tr.lr, weight_decay=0.0), params,
            TrainerConfig(n_steps=tr.steps, log_every=tr.log_every),
        )
        batches = ShardedBatcher(arrays, global_batch=tr.batch,
                                 seed=cfg.seed + SEED_BATCHER)
        trainer.fit(batches, log=log)
        ctx["params"] = trainer.params


class ServeStage(Stage):
    """Serve eval traffic through a real engine over the registry store:
    ``ServingEngine`` (``serve.engine="batch"``) or ``SpmdServingEngine``
    over a debug mesh (``"spmd"``)."""

    name = "serve"

    def provides(self, cfg):
        return ("serve_results", "serve_meta")

    # -- engine construction ------------------------------------------------
    def _retriever_and_engine(self, cfg, ctx, prompt_width: int,
                              constrained: bool):
        sv = cfg.serve
        L, V = ctx["sid_length"], ctx["vocab"]
        policy = (
            DecodePolicy.stacked(ctx["store"], impl=sv.impl, fused=sv.fused,
                                 topk=sv.topk)
            if constrained else DecodePolicy.unconstrained()
        )
        registry = ctx["registry"] if constrained else None
        if sv.engine == "spmd":
            mesh = make_debug_mesh(
                model=2 if sv.spmd_rows == "model" else 1)
            retr = SpmdRetriever(
                ctx["params"], ctx["model_cfg"], policy, L, V,
                beam_size=sv.beam, mesh=mesh, rows=sv.spmd_rows)
            engine = SpmdServingEngine(
                retr, registry=registry, slots=sv.batch_size,
                prompt_width=prompt_width)
        elif sv.engine == "batch":
            retr = GenerativeRetriever(
                ctx["params"], ctx["model_cfg"], policy, L, V,
                beam_size=sv.beam)
            engine = ServingEngine(
                ctx["params"], ctx["model_cfg"], sv.batch_size,
                max_len=2 * prompt_width, retriever=retr, registry=registry)
        else:
            raise ValueError(f"unknown serve engine {sv.engine!r}")
        return retr, engine

    @staticmethod
    def _serve(engine, hist: np.ndarray, n_out: int,
               cids: np.ndarray | None):
        queue = RequestQueue()
        rids = [
            queue.submit(hist[i], n_out,
                         constraint_id=0 if cids is None else int(cids[i]))
            for i in range(hist.shape[0])
        ]
        res = engine.serve(queue)
        beams = np.stack([res[r]["sids"] for r in rids])
        scores = np.stack([res[r]["scores"] for r in rids])
        return beams, scores

    # -- scenario families --------------------------------------------------
    def _run_cold_start(self, cfg, ctx, log):
        sv, data, sids = cfg.serve, ctx["data"], ctx["sids"]
        L = ctx["sid_length"]
        test = data.test_seqs
        if test.shape[0] > cfg.eval.max_eval:
            test = test[: cfg.eval.max_eval]
        hist = sids[test[:, :-1]].reshape(test.shape[0], -1).astype(np.int32)
        ctx["eval_targets"] = sids[test[:, -1]]
        cid = ctx["slots"][sv.eval_slot]
        cids = np.full(hist.shape[0], cid, dtype=np.int32)
        _, engine = self._retriever_and_engine(
            cfg, ctx, hist.shape[1], constrained=True)
        results = {"static": self._serve(engine, hist, L, cids)}
        meta = {
            "engine": sv.engine,
            "eval_slot": sv.eval_slot,
            "n_test": int(hist.shape[0]),
            "store_version": ctx["registry"].version,
            "unexpected_recompiles": int(engine.metrics.counter(
                "serving_recompiles_total").value(expected="false")),
        }
        if cfg.eval.with_unconstrained:
            _, engine_u = self._retriever_and_engine(
                cfg, ctx, hist.shape[1], constrained=False)
            results["unconstrained"] = self._serve(engine_u, hist, L, None)
        ctx["serve_results"] = results
        ctx["serve_meta"] = meta
        log(f"  served {hist.shape[0]} test requests through "
            f"{sv.engine} engine (slot {sv.eval_slot!r})")

    def _run_catalog(self, cfg, ctx, log):
        sv = cfg.serve
        V, L = ctx["vocab"], ctx["sid_length"]
        reg = ctx["registry"]
        n_slots = len(ctx["slots"])
        rng = np.random.default_rng(cfg.seed + SEED_REQUESTS)
        hist = rng.integers(
            0, V, (sv.n_requests, sv.hist_len)).astype(np.int32)
        cids = (np.arange(sv.n_requests) % n_slots).astype(np.int32)
        ctx["request_cids"] = cids
        _, engine = self._retriever_and_engine(
            cfg, ctx, sv.hist_len, constrained=True)
        beams, scores = self._serve(engine, hist, L, cids)
        versions = [reg.version]
        current = ctx["catalog"]
        if sv.refresh_cycles > 0:
            churn_rng = np.random.default_rng(cfg.seed + SEED_CHURN)
            with AsyncRefresher(reg) as refresher:
                for cycle in range(sv.refresh_cycles):
                    churn = max(
                        1, int(current.sids.shape[0] * sv.churn_frac))
                    rm = current.sids[churn_rng.choice(
                        current.sids.shape[0], churn, replace=False)]
                    added = synthetic_catalog(
                        churn_rng, churn, V, L,
                        n_categories=cfg.data.n_categories,
                        max_age_days=cfg.data.max_age_days)
                    delta = CatalogDelta(added=added, removed_sids=rm)
                    fut = refresher.apply_delta_async(delta)
                    current = current.apply_delta(delta)
                    # serving continues while the rebuild runs off-thread
                    beams, scores = self._serve(engine, hist, L, cids)
                    versions.append(int(fut.result(timeout=120)))
                    # post-swap serve: the engine installs the new store at
                    # its batch boundary — this batch must not specialize
                    # the retrieve step anew (hot swap), the gate below
                    beams, scores = self._serve(engine, hist, L, cids)
                    log(f"  refresh cycle {cycle}: ±{churn} items -> "
                        f"registry v{versions[-1]}")
        ctx["final_catalog"] = current
        ctx["serve_results"] = {"constrained": (beams, scores)}
        ctx["serve_meta"] = {
            "engine": sv.engine,
            "n_requests": int(sv.n_requests),
            "versions": versions,
            "cold_swaps": int(engine.cold_swaps),
            "unexpected_recompiles": int(engine.metrics.counter(
                "serving_recompiles_total").value(expected="false")),
        }
        if sv.engine == "spmd":
            # bit-identity reference: the same policy + params on one device
            retr = GenerativeRetriever(
                ctx["params"], ctx["model_cfg"],
                DecodePolicy.stacked(reg.current()[0], impl=sv.impl,
                                     fused=sv.fused, topk=sv.topk),
                L, V, beam_size=sv.beam)
            ctx["reference_results"] = retr.retrieve(
                hist, constraint_ids=cids)
        log(f"  served {sv.n_requests} mixed-constraint requests over "
            f"{n_slots} slots ({sv.engine} engine)")

    def run(self, cfg, ctx, log):
        run = self._run_cold_start if "data" in ctx else self._run_catalog
        if cfg.serve.engine != "spmd":
            return run(cfg, ctx, log)
        with world(ctx["device"]):  # the world that exists, or one of one
            run(cfg, ctx, log)


class EvalStage(Stage):
    name = "eval"

    def provides(self, cfg):
        return ("result",)

    @staticmethod
    def _hits(beams: np.ndarray, scores: np.ndarray, targets: np.ndarray):
        """(hit@M, recall@1) — a hit is the target SID in any ALIVE beam."""
        alive = scores > NEG_INF / 2
        match = (beams == targets[:, None, :]).all(axis=2) & alive
        hit_m = float(match.any(axis=1).mean())
        r1 = float(match[:, 0].mean())
        return hit_m, r1

    def _eval_cold_start(self, cfg, ctx, log):
        data, sids = ctx["data"], ctx["sids"]
        targets = ctx["eval_targets"]
        beams_s, scores_s = ctx["serve_results"]["static"]
        hit_s, r1_s = self._hits(beams_s, scores_s, targets)
        result = {
            "scenario": cfg.name,
            "cold_frac": cfg.data.cold_frac,
            "n_cold": int(data.cold_items.shape[0]),
            "n_test": int(targets.shape[0]),
            "beam_size": cfg.serve.beam,
            "recall@1_static": r1_s,
            "hit@M_static": hit_s,
        }
        if "unconstrained" in ctx["serve_results"]:
            beams_u, scores_u = ctx["serve_results"]["unconstrained"]
            hit_u, r1_u = self._hits(beams_u, scores_u, targets)
            result["recall@1_unconstrained"] = r1_u
            result["hit@M_unconstrained"] = hit_u
        if cfg.eval.with_random:
            # constrained random guessing: uniform over the cold corpus
            rng = np.random.default_rng(cfg.seed + SEED_BASELINE)
            cold_sids = sids[data.cold_items]
            guesses = cold_sids[rng.integers(
                0, cold_sids.shape[0], targets.shape[0])]
            result["recall@1_constrained_random"] = float(
                (guesses == targets).all(axis=1).mean())
        gates = {}
        if "hit@M_unconstrained" in result:
            gates["static_beats_unconstrained"] = (
                result["hit@M_static"] > result["hit@M_unconstrained"])
        gates["zero_unexpected_recompiles"] = (
            ctx["serve_meta"]["unexpected_recompiles"] == 0)
        gates["passed"] = all(gates.values())
        result["gates"] = gates
        result["serve_meta"] = ctx["serve_meta"]
        ctx["result"] = result
        log(f"  hit@M static {result['hit@M_static']:.3f} vs unconstrained "
            f"{result.get('hit@M_unconstrained', float('nan')):.3f}; "
            f"gates passed: {gates['passed']}")

    def _eval_catalog(self, cfg, ctx, log):
        beams, scores = ctx["serve_results"]["constrained"]
        cids = ctx["request_cids"]
        catalog = ctx.get("final_catalog", ctx["catalog"])
        names = list(ctx["slots"])
        valid_per_slot = []
        for name in names:
            mask = ctx["predicates"][name](catalog)
            valid_per_slot.append(
                {tuple(int(t) for t in row) for row in catalog.sids[mask]})
        alive = scores > NEG_INF / 2
        total, ok = 0, 0
        for b in range(beams.shape[0]):
            valid = valid_per_slot[int(cids[b])]
            for m in range(beams.shape[1]):
                if alive[b, m]:
                    total += 1
                    ok += tuple(int(t) for t in beams[b, m]) in valid
        compliance = ok / total if total else 0.0
        meta = ctx["serve_meta"]
        gates = {
            "full_compliance": compliance == 1.0 and total > 0,
            "zero_unexpected_recompiles":
                meta["unexpected_recompiles"] == 0,
        }
        result = {
            "scenario": cfg.name,
            "n_requests": meta["n_requests"],
            "n_slots": len(names),
            "alive_beams": total,
            "compliance": compliance,
            "serve_meta": meta,
        }
        if "reference_results" in ctx:
            ref_beams, ref_scores = ctx["reference_results"]
            identical = bool(np.array_equal(ref_beams, beams)
                             and np.array_equal(ref_scores, scores))
            gates["spmd_bit_identical"] = identical
            result["spmd_bit_identical"] = identical
        gates["passed"] = all(gates.values())
        result["gates"] = gates
        ctx["result"] = result
        log(f"  compliance {compliance:.3f} over {total} alive beams; "
            f"gates passed: {gates['passed']}")

    def run(self, cfg, ctx, log):
        if "data" in ctx:
            self._eval_cold_start(cfg, ctx, log)
        else:
            self._eval_catalog(cfg, ctx, log)


def default_stages() -> tuple:
    """The canonical Data -> ... -> Eval stage chain."""
    return (DataStage(), TokenizerStage(), IndexStage(), TrainStage(),
            ServeStage(), EvalStage())
