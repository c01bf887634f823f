"""The system under test for a generative-retrieval configuration: the port's
``ServingEngine`` in retrieval mode over a ``GenerativeRetriever``.

From the configuration file it reads ``model`` (the decoder's sizes),
``search`` (beams, SID length and vocabulary, dense levels, the engine's
``max_len``), ``index`` (``"single"``: one trie over the catalog;
``"stacked"``: a ``ConstraintRegistry`` of the ``slots`` at ``headroom``)
and ``policy`` (the ``DecodePolicy`` flags).  Loading this file imports
the port (set-up's ``port_imports``).  The program gets the
benchmark's weights (viewed in its parameter layout) and catalog; it builds
its trie, store and engine itself.  Each round submits the round's requests
to a ``RequestQueue`` and drains it with one ``serve()`` call.

The system contract (``harness/spec.py``): besides :class:`System` and
:func:`judge`, a system file names the three pieces that depend on the
model's architecture, which the harness reaches only through it:

* ``make_weights(model, seed, device)``: the weights, drawn from
  ``data.generator(seed, "weights", device)``;
* ``retrieve_passes(model, B, M, S, L)``: a retrieve's operations and least
  bytes, a list of ``work.Pass``;
* ``decoder(weights, model, precision)``: the plain reference over those
  weights in ``"float32"`` or ``"fp8"`` (the control).

Here they are the dense GQA decoder's:
:func:`gpubench.harness.data.make_weights`,
:func:`gpubench.harness.work.retrieve_passes` and
:class:`gpubench.reference.decoder.Decoder`.  A configuration of another
architecture names a system file of its own; :func:`readings` judges any
decoder's served answers.
"""
from __future__ import annotations

import gc

import numpy as np
import torch
from repro_torch import constraints
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import build_flat_trie, sorted_unique_sids
from repro_torch.decoding import DecodePolicy
from repro_torch.kernels import vntk
from repro_torch.serving import (
    GenerativeRetriever,
    RequestQueue,
    ServingEngine,
)

from gpubench.harness import data, work
from gpubench.reference.decoder import Decoder

__all__ = ["System", "judge", "readings", "make_weights", "retrieve_passes",
           "decoder"]

make_weights = data.make_weights
retrieve_passes = work.retrieve_passes
decoder = Decoder


def port_params(w: dict, n_layers: int) -> dict:
    """The benchmark's stacked weights as the port's parameter tree (views,
    no copies)."""
    return {
        "emb": w["emb"],
        "final_norm": {"scale": w["final_norm"]},
        "layers": [{
            "ln_attn": {"scale": w["ln_attn"][i]},
            "attn": {"wq": {"w": w["wq"][i]}, "wk": {"w": w["wk"][i]},
                     "wv": {"w": w["wv"][i]}, "wo": {"w": w["wo"][i]}},
            "ln_ffn": {"scale": w["ln_ffn"][i]},
            "ffn": {"w1": w["w1"][i], "w3": w["w3"][i], "w2": w["w2"][i]},
        } for i in range(n_layers)],
    }


class System:
    """Built in set-up; :meth:`serve` answers one round."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict,
                 catalog: np.ndarray, meta: dict, device: torch.device):
        m, s, ix = cfg["model"], cfg["search"], cfg["index"]
        tcfg = TransformerConfig(
            name=cfg["name"], n_layers=m["n_layers"], d_model=m["d_model"],
            n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"],
            vocab_size=m["vocab_size"], head_dim=m["head_dim"],
            tie_embeddings=m["tie_embeddings"], rope_theta=m["rope_theta"],
            norm_eps=m["norm_eps"], dtype=m["dtype"])
        params = port_params(weights, m["n_layers"])
        V, d = s["sid_vocab"], s["dense_d"]
        flags = cfg["policy"]
        self.registry = None
        if ix["kind"] == "single":
            # the catalog is drawn sorted: the program's sort is skipped
            ft = build_flat_trie(sorted_unique_sids(catalog), V, dense_d=d)
            self.tables = TransitionMatrix.from_flat_trie(ft, device=device)
            policy = DecodePolicy.static(self.tables, **flags)
        elif ix["kind"] == "stacked":
            reg = constraints.ConstraintRegistry(
                V, dense_d=d, headroom=ix["headroom"], device=device)
            for slot in ix["slots"]:
                reg.register(slot["name"], getattr(
                    constraints, slot["predicate"])(*slot["args"]))
            self.tables = reg.build(constraints.ItemCatalog(
                sids=catalog, age_days=meta["age_days"],
                category=meta["category"]))
            self.registry = reg
            policy = DecodePolicy.stacked(self.tables, **flags)
        else:
            raise ValueError(f"unknown index kind {ix['kind']!r}")
        if traffic["history_items"] * s["sid_length"] != s["max_len"] // 2:
            raise ValueError("a history must fill the engine's prompt width "
                             "max_len // 2, which the reference reads as is")
        self.L = s["sid_length"]
        self.retriever = GenerativeRetriever(
            params, tcfg, policy, s["sid_length"], V, beam_size=s["beam_size"])
        self.engine = ServingEngine(
            params, tcfg, traffic["batch"], s["max_len"],
            retriever=self.retriever, registry=self.registry)
        self.queue = RequestQueue()

    def index_bytes(self) -> int:
        """Bytes of the policy's tables on the device."""
        return int(self.tables.nbytes())

    @staticmethod
    def launches() -> int:
        """Constraint-kernel launches so far (the port's counter)."""
        return sum(vntk.LAUNCHES.values())

    def serve(self, histories: np.ndarray, cids: list) -> list:
        """Submit the round's requests, drain the queue with one ``serve()``;
        per request ``{"sids", "scores"}`` or ``None`` where it failed."""
        rids = [self.queue.submit(h, self.L, constraint_id=c or 0)
                for h, c in zip(histories, cids)]
        results = self.engine.serve(self.queue)
        out = []
        for rid in rids:
            r = results.get(rid)
            out.append(None if r is None or "error" in r else
                       {"sids": r["sids"], "scores": r["scores"]})
        return out

    def close(self) -> None:
        """Free the program's state on the device."""
        del self.engine, self.retriever, self.tables, self.registry
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def judge(cfg: dict, weights: dict, catalog: np.ndarray, meta: dict,
          served: list, sample: list) -> dict:
    """:func:`readings` against the float32 reference ``decoder``."""
    return readings(cfg, decoder(weights, cfg["model"], "float32"), catalog,
                    meta, served, sample)


def readings(cfg: dict, dec, catalog: np.ndarray, meta: dict, served: list,
             sample: list) -> dict:
    """The readings of :mod:`gpubench.reference.judge` on what was served
    (every answered request for ``bad_beams``, ``sample`` for the gaps
    against the reference decoder ``dec``)."""
    from gpubench.reference.judge import bad_beams, sample_gaps
    from gpubench.reference.sets import Catalog

    s = cfg["search"]
    cat = Catalog(catalog, s["sid_vocab"], meta, cfg["index"].get("slots"))
    out = {"bad_beams": bad_beams(cat, served, s["beam_size"])}
    out.update(sample_gaps(dec, cat, sample, s["sid_vocab"]))
    return out
