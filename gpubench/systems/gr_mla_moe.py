"""The system under test for a generative-retrieval configuration whose
decoder is DeepSeek-V2's: multi-head latent attention (MLA), a routed
mixture of experts with shared experts, YaRN rotary positions.

The program is the port's ``ServingEngine`` in retrieval mode over a
``GenerativeRetriever``, as in ``gr_retrieval``: the decoder's prefill and
absorbed decode with the latent cache (``MLACache``), tiled across the beams
and reordered each step, the constrained beam search, the constraint index
of the configuration's ``index``.  The configuration's ``model`` holds the
published ``config.json``'s keys (DeepSeek-V2-Lite's), plus ``dtype`` and
``router_logit_std``.  Loading this file imports the port.

The three pieces of the system contract that depend on the architecture:

* :func:`make_weights`: the weights, stacked over layers in the port's
  layout, so that the port's parameter tree is views of them
  (:func:`port_params`); its one copy is the float32 router;
* :func:`retrieve_passes`: a retrieve's operations and least bytes;
* :data:`decoder`: :class:`gpubench.reference.mla_moe_decoder.MLAMoEDecoder`.

:func:`expert_least_seconds` counts the routed experts' least time for the
``expert_roofline_share`` metric.
"""
from __future__ import annotations

import torch
from repro_torch import constraints
from repro_torch.configs.base import MoEConfig, RopeScaling, TransformerConfig
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import build_flat_trie, sorted_unique_sids
from repro_torch.decoding import DecodePolicy
from repro_torch.models import moe
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine

from gpubench.harness import data, work
from gpubench.reference.mla_moe_decoder import UNSUPPORTED, MLAMoEDecoder
from gpubench.systems import gr_retrieval as gr

__all__ = ["System", "judge", "make_weights", "retrieve_passes", "decoder",
           "port_config", "port_params", "expert_least_seconds"]

decoder = MLAMoEDecoder


def _dims(m: dict) -> dict:
    return {"D": m["hidden_size"], "n": m["num_hidden_layers"],
            "nd": m["first_k_dense_replace"], "H": m["num_attention_heads"],
            "nope": m["qk_nope_head_dim"], "rope": m["qk_rope_head_dim"],
            "lora": m["kv_lora_rank"], "vd": m["v_head_dim"],
            "Fd": m["intermediate_size"], "E": m["n_routed_experts"],
            "K": m["num_experts_per_tok"], "Fe": m["moe_intermediate_size"],
            "Fs": m["n_shared_experts"] * m["moe_intermediate_size"],
            "V": m["vocab_size"]}


def make_weights(model: dict, seed: int, device) -> dict:
    """The decoder's weights, stacked over layers: ``emb`` (V, D),
    ``unemb`` (D, V), ``final_norm`` (D,); per layer ``ln_attn``/``ln_ffn``
    (n, D), ``wq`` (n, D, H (nope + rope)), ``w_kv_a`` (n, D, lora + rope),
    ``kv_norm`` (n, lora), ``w_kv_b`` (n, lora, H (nope + v)), ``wo``
    (n, H v, D); the dense layers' ``dense_w1``/``dense_w3`` (nd, D, Fd),
    ``dense_w2`` (nd, Fd, D); the MoE layers' ``router`` (nm, D, E),
    ``w1``/``w3`` (nm, E, D, Fe), ``w2`` (nm, E, Fe, D),
    ``shared_w1``/``shared_w3`` (nm, D, Fs), ``shared_w2`` (nm, Fs, D).
    Embedding N(0, 0.02²), norm scales 1 + N(0, 0.1²), every projection
    and expert He-normal at its own fan-in (variance 2 / d_in), the router
    N(0, (router_logit_std / sqrt(D))²) so that its logits' spread is about
    ``router_logit_std``; all drawn and stored in bf16."""
    gen = data.generator(seed, "weights", device)
    dt = data.torch_dtype(model["dtype"])
    d = _dims(model)
    D, n, nd = d["D"], d["n"], d["nd"]
    nm, E = n - nd, d["E"]
    qk, kv_b = d["H"] * (d["nope"] + d["rope"]), d["H"] * (d["nope"] + d["vd"])

    def normal(shape, std, mean=0.0):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        w.mul_(std)
        return w.add_(mean) if mean else w

    def he(*shape):
        return normal(shape, (2.0 / shape[-2]) ** 0.5)

    return {
        "emb": normal((d["V"], D), 0.02),
        "unemb": he(D, d["V"]),
        "final_norm": normal((D,), 0.1, 1.0),
        "ln_attn": normal((n, D), 0.1, 1.0),
        "ln_ffn": normal((n, D), 0.1, 1.0),
        "wq": he(n, D, qk),
        "w_kv_a": he(n, D, d["lora"] + d["rope"]),
        "kv_norm": normal((n, d["lora"]), 0.1, 1.0),
        "w_kv_b": he(n, d["lora"], kv_b),
        "wo": he(n, d["H"] * d["vd"], D),
        "dense_w1": he(nd, D, d["Fd"]),
        "dense_w3": he(nd, D, d["Fd"]),
        "dense_w2": he(nd, d["Fd"], D),
        "router": normal((nm, D, E), model["router_logit_std"] / D ** 0.5),
        "w1": he(nm, E, D, d["Fe"]),
        "w3": he(nm, E, D, d["Fe"]),
        "w2": he(nm, E, d["Fe"], D),
        "shared_w1": he(nm, D, d["Fs"]),
        "shared_w3": he(nm, D, d["Fs"]),
        "shared_w2": he(nm, d["Fs"], D),
    }


def port_config(name: str, model: dict) -> TransformerConfig:
    """The port's config of the published keys; settings the port does not
    compute raise."""
    bad = {k: model.get(k) for k, v in UNSUPPORTED.items()
           if model.get(k, v) != v}
    if model["routed_scaling_factor"] != 1:
        bad["routed_scaling_factor"] = model["routed_scaling_factor"]
    rs = model["rope_scaling"]
    if bad or rs.get("type") != "yarn":
        raise ValueError(f"the port does not serve {bad} / {rs}")
    d = _dims(model)
    return TransformerConfig(
        name=name, n_layers=d["n"], d_model=d["D"], n_heads=d["H"],
        n_kv_heads=model["num_key_value_heads"], d_ff=d["Fd"],
        vocab_size=d["V"], attention="mla", kv_lora_rank=d["lora"],
        qk_nope_head_dim=d["nope"], qk_rope_head_dim=d["rope"],
        v_head_dim=d["vd"],
        moe=MoEConfig(n_experts=d["E"], top_k=d["K"], d_expert=d["Fe"],
                      n_shared=model["n_shared_experts"], d_shared=d["Fs"],
                      first_dense_layers=d["nd"], d_ff_dense=d["Fd"],
                      capacity_factor=None,
                      norm_topk_prob=model["norm_topk_prob"]),
        rope_theta=float(model["rope_theta"]),
        rope_scaling=RopeScaling(**{k: v for k, v in rs.items()
                                    if k != "type"}),
        norm_eps=model["rms_norm_eps"], tie_embeddings=False,
        dtype=model["dtype"])


def port_params(w: dict, model: dict) -> dict:
    """The stacked weights as the port's parameter tree: views, but for
    the router, which the port computes in float32 (as the published
    ``MoEGate`` does) and holds as a float32 copy."""
    nd = model["first_k_dense_replace"]
    router = w["router"].to(torch.float32)
    layers = []
    for i in range(model["num_hidden_layers"]):
        p = {"ln_attn": {"scale": w["ln_attn"][i]},
             "attn": {"wq": w["wq"][i], "w_kv_a": w["w_kv_a"][i],
                      "kv_norm": {"scale": w["kv_norm"][i]},
                      "w_kv_b": w["w_kv_b"][i], "wo": w["wo"][i]},
             "ln_ffn": {"scale": w["ln_ffn"][i]}}
        if i < nd:
            p["ffn"] = {k: w[f"dense_{k}"][i] for k in ("w1", "w3", "w2")}
        else:
            j = i - nd
            p["moe"] = {"router": router[j], "w1": w["w1"][j],
                        "w3": w["w3"][j], "w2": w["w2"][j],
                        "shared": {k: w[f"shared_{k}"][j]
                                   for k in ("w1", "w3", "w2")}}
        layers.append(p)
    return {"emb": w["emb"], "unemb": w["unemb"],
            "final_norm": {"scale": w["final_norm"]}, "layers": layers}


def retrieve_passes(model: dict, B: int, M: int, S: int, L: int) -> list:
    """The prefill and each decode step of one retrieve, with operations
    and least bytes (``harness/work.py``'s conventions).

    Operations: two a matmul parameter a token, as computed: the prefill
    builds every position's keys and values from its latent through
    ``W_kv_b`` (not absorbed); a decode step folds its query through
    ``W_uk`` and unfolds its context through ``W_uv`` (absorbed; as many
    parameters a token); per MoE layer the router, the
    ``num_experts_per_tok`` routed experts and the shared experts; the
    unembedding where logits are read.  Attention, each layer: the prefill
    ``4 x queries x keys x H x (nope + rope + v) / 2`` (causal), a decode
    step ``2 x rows x keys x H x (2 lora + rope)`` (scores over the latents
    and rotary keys, the context over the latents).  Least bytes: every
    weight outside the routed experts once a pass, and of the routed
    experts ``num_experts_per_tok`` a layer-pass, the fewest any routing
    touches (so no share built on these bytes can read over 100%, though a
    batch hits most experts); the latent cache (``kv_lora_rank +
    qk_rope_head_dim`` a position and layer) written once by the prefill,
    the history read once a request and the generated positions once a
    beam by each decode step, this step's latents written; logits written
    once."""
    elem = work.DTYPES[model["dtype"]]["bytes"]
    d = _dims(model)
    D, n, nd, H, lora = d["D"], d["n"], d["nd"], d["H"], d["lora"]
    nm, vocab = n - nd, d["V"]
    attn = (D * H * (d["nope"] + d["rope"]) + D * (lora + d["rope"])
            + lora * H * (d["nope"] + d["vd"]) + H * d["vd"] * D)
    dense, expert = 3 * D * d["Fd"], 3 * D * d["Fe"]
    router_shared = D * d["E"] + 3 * D * d["Fs"]
    body = n * attn + nd * dense + nm * (router_shared + d["K"] * expert)
    unemb = 2.0 * vocab * D
    # every weight once, the routed experts at num_experts_per_tok a layer
    w_bytes = (2 * vocab * D + body + D * (2 * n + 1) + lora * n) * elem
    lat_tok = n * (lora + d["rope"]) * elem  # a position's latents
    pre_flops = (2.0 * body * B * S + unemb * B
                 + 4.0 * B * S * S * H * (d["nope"] + d["rope"] + d["vd"])
                 * n / 2)
    pre_bytes = w_bytes + B * S * 4 + B * S * lat_tok + B * vocab * 4
    passes = [work.Pass("prefill", pre_flops, pre_bytes)]
    rows = B * M
    for j in range(1, L):
        keys = S + j  # the history, earlier generated positions, itself
        flops = (2.0 * body * rows + unemb * rows
                 + 2.0 * rows * keys * H * (2 * lora + d["rope"]) * n)
        byts = (w_bytes + rows * 4
                + B * S * lat_tok  # history, once a request
                + rows * (j - 1) * lat_tok  # generated positions, a beam
                + rows * lat_tok  # this step's latents
                + rows * vocab * 4)
        passes.append(work.Pass(f"decode{j}", flops, byts))
    return passes


def expert_least_seconds(model: dict, counts: dict, L: int) -> float:
    """The routed experts' least time a retrieve of SID length ``L``, from
    the port's routing counts (``repro_torch.models.moe.routing_counts``:
    per phase the distinct experts hit, the assignments and the
    layer-passes, summed): the larger of two sums over the retrieve's
    layer-passes (one prefill pass and ``L - 1`` decode passes of each MoE
    layer, at each phase's mean), of the hit experts' weights read once
    plus each assignment's row read and written at 3.35 TB/s, and of the
    experts' operations (two a weight an assignment) at the dtype's peak."""
    d = _dims(model)
    elem = work.DTYPES[model["dtype"]]["bytes"]
    nm = d["n"] - d["nd"]
    expert = 3 * d["D"] * d["Fe"]
    byts = flops = 0.0
    for phase, passes in (("prefill", nm), ("decode", nm * (L - 1))):
        c = counts[phase]
        hit = c["experts_hit"] / c["passes"]
        rows = c["assignments"] / c["passes"]
        byts += passes * (hit * expert + rows * 2 * d["D"]) * elem
        flops += passes * rows * 2.0 * expert
    return max(byts / work.HBM_BYTES_PER_S, flops / work.peak_flops(model))


def _index(cfg: dict, catalog, meta: dict, device) -> tuple:
    """(tables, registry or None, DecodePolicy) of the configuration's
    ``index``, built by the program (as ``gr_retrieval`` builds them)."""
    s, ix, flags = cfg["search"], cfg["index"], cfg["policy"]
    V, dense_d = s["sid_vocab"], s["dense_d"]
    if ix["kind"] == "single":
        ft = build_flat_trie(sorted_unique_sids(catalog), V, dense_d=dense_d)
        tables = TransitionMatrix.from_flat_trie(ft, device=device)
        return tables, None, DecodePolicy.static(tables, **flags)
    if ix["kind"] != "stacked":
        raise ValueError(f"unknown index kind {ix['kind']!r}")
    reg = constraints.ConstraintRegistry(V, dense_d=dense_d,
                                         headroom=ix["headroom"], device=device)
    for slot in ix["slots"]:
        reg.register(slot["name"], getattr(constraints, slot["predicate"])(
            *slot["args"]))
    tables = reg.build(constraints.ItemCatalog(
        sids=catalog, age_days=meta["age_days"], category=meta["category"]))
    return tables, reg, DecodePolicy.stacked(tables, **flags)


class System(gr.System):
    """Built in set-up; serves as ``gr_retrieval.System`` does."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict, catalog,
                 meta: dict, device: torch.device):
        m, s = cfg["model"], cfg["search"]
        if traffic["history_items"] * s["sid_length"] != s["max_len"] // 2:
            raise ValueError("a history must fill the engine's prompt width "
                             "max_len // 2, which the reference reads as is")
        tcfg = port_config(cfg["name"], m)
        params = port_params(weights, m)
        moe.reset_routing()  # the counter holds this run's traced rounds
        self.tables, self.registry, policy = _index(cfg, catalog, meta,
                                                    device)
        self.L = s["sid_length"]
        self.retriever = GenerativeRetriever(
            params, tcfg, policy, s["sid_length"], s["sid_vocab"],
            beam_size=s["beam_size"])
        self.engine = ServingEngine(
            params, tcfg, traffic["batch"], s["max_len"],
            retriever=self.retriever, registry=self.registry)
        self.queue = RequestQueue()


def judge(cfg: dict, weights: dict, catalog, meta: dict, served: list,
          sample: list) -> dict:
    """``gr_retrieval.readings`` against the float32 reference."""
    return gr.readings(cfg, decoder(weights, cfg["model"], "float32"),
                       catalog, meta, served, sample)
