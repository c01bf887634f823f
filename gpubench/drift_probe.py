"""Where the DeepSeek cell's bf16 drift from the float32 reference comes from.

Parts (``--parts``, comma-separated):

(A) The port in float32 at the published widths, with the first ``--layers``
layers, against the float32 reference on the same weights: the prefill's
logits for one request and for each request of a batch of two, the routing
of both prefills (per MoE layer the tokens whose top-k set differs; in the
batch, each flipped (layer, token) with the reference's margin
``p_K - p_(K+1)``), and every decode step's logits through the retriever's
tiled and reordered latent cache (a row's max |gap| over its max |logit| of
the SID slice, each request's worst row, and for rows off by more than 1e-4
the least margin over the row's own tokens).  Each grouped product is also
held to a float32 loop of products over the same rows.

``Aloop``: (A) with every grouped product a loop of plain products.

(B) The port as served (bf16, all layers) against the float32 reference on
one request's history: per MoE layer the tokens whose top-k set differs, the
router input's relative L2 gap, and the tokens whose top-k set the rounding
of the reference's own router input to bf16 flips alone.

(C) The port as served (bf16, all layers) through the retriever, as (A).

``J`` (float32) and ``Jb`` (bf16): the configuration's own cell, its model
cut to ``--layers`` layers, served for two rounds and judged as the
benchmark judges it (``score_gap`` and the rest against the float32
reference).

    python3 gpubench/drift_probe.py --out drift.jsonl

on the card (about 40 s for (A) and 1 s for (B) after set-up, 18 GB in
float32 and 34 GB in bf16); ``--config-file`` and ``--device cpu`` run it
at a tiny size.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--root", default=str(ROOT))
ap.add_argument("--config", default="static-gr-dsv2lite.stacked5")
ap.add_argument("--config-file", default=None)
ap.add_argument("--seed", type=int, default=2147489009)
ap.add_argument("--layers", type=int, default=8)
ap.add_argument("--hist", type=int, default=256)
ap.add_argument("--parts", default="A,B")
ap.add_argument("--device", default="cuda")
ap.add_argument("--out", default=None)
a = ap.parse_args()
root = pathlib.Path(a.root)
sys.path[:0] = [str(root), str(root / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench.harness.spec import Spec  # noqa: E402
from repro_torch.core.transition_matrix import TransitionMatrix  # noqa: E402
from repro_torch.decoding import DecodePolicy  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.serving import GenerativeRetriever, generative_retrieval  # noqa: E402

dev = torch.device(a.device)
spec = Spec(root, root / "gpubench")
cfg = (json.loads(pathlib.Path(a.config_file).read_text()) if a.config_file
       else spec.config(a.config))
sysmod = spec.system("gr_mla_moe")
s = cfg["search"]
V, L, M = s["sid_vocab"], s["sid_length"], s["beam_size"]
K = cfg["model"]["num_experts_per_tok"]
out = []


def emit(rec):
    print(json.dumps(rec), flush=True)
    out.append(rec)


LOG = {"on": False, "port": [], "ref": []}
_top_k = moe._top_k


def port_top_k(router, x, c):
    probs, w, i = _top_k(router, x, c)
    if LOG["on"]:
        LOG["port"].append((x.detach().reshape(-1, x.shape[-1]).float(),
                            i.reshape(-1, i.shape[-1])))
    return probs, w, i


moe._top_k = port_top_k


class RefLog(sysmod.decoder):
    def _experts(self, j, h):
        if LOG["on"]:
            LOG["ref"].append((j, h.detach().clone()))
        if LOG.get("margins") is not None:  # p_K - p_(K+1) a token
            p = torch.topk(torch.softmax(h @ self._w("router", j), dim=-1),
                           K + 1, dim=-1).values
            LOG["margins"].append(p[:, K - 1] - p[:, K])
        return super()._experts(j, h)


def top_sets(h, router):
    idx = torch.topk(torch.softmax(h @ router, dim=-1), K, dim=-1).indices
    return idx.sort(dim=-1).values


_grouped = torch._grouped_mm
GMM = {"loop": False, "log": None}


def _loop(x, w, offs):
    y, start = x.new_empty(x.shape[0], w.shape[-1]), 0
    for g, end in enumerate(offs.tolist()):
        y[start:end] = x[start:end] @ w[g]
        start = end
    return y


def grouped_mm(x, w, offs):
    """``torch._grouped_mm`` (a loop of products under ``GMM["loop"]``);
    under ``GMM["log"]`` each group's worst row's relative gap from a
    float32 loop is logged."""
    y = _loop(x, w, offs) if GMM["loop"] else _grouped(x, w, offs=offs)
    if GMM["log"] is not None:
        want = _loop(x.float(), w.float(), offs)
        err = ((y.float() - want).norm(dim=-1)
               / want.norm(dim=-1).clamp_min(1e-30))
        sizes = torch.diff(offs.long(), prepend=offs.new_zeros(1).long())
        grp = torch.repeat_interleave(
            torch.arange(sizes.numel(), device=err.device), sizes)
        worst = torch.zeros(sizes.numel(), device=err.device).scatter_reduce(
            0, grp, err, "amax")
        GMM["log"].append((worst, sizes))
    return y


def grouped_summary(tol):
    worst = torch.cat([w for w, _ in GMM["log"]])
    sizes = torch.cat([n for _, n in GMM["log"]])
    bad = worst > tol
    return {"calls": len(GMM["log"]), "worst_group_rel_gap": float(worst.max()),
            "groups": int((sizes > 0).sum()), f"groups_over_{tol:g}":
            int(bad.sum()), "bad_group_sizes": sizes[bad][:20].tolist()}


def batch_flips(w, B):
    """Of the logged batch prefill: per request, each (layer, token) whose
    top-k set the port and the reference chose differently, with the
    reference's margin ``p_K - p_(K+1)`` there."""
    n = len(LOG["port"])
    out = [[] for _ in range(B)]
    for l, (hp, ip) in enumerate(LOG["port"]):
        j = LOG["ref"][l][0]
        router = w["router"][j].to(torch.float32)
        for b in range(B):
            hr = LOG["ref"][b * n + l][1].reshape(-1, hp.shape[-1])
            T = hr.shape[0]
            p = torch.topk(torch.softmax(hr @ router, dim=-1), K + 1,
                           dim=-1)
            want = p.indices[:, :K].sort(dim=-1).values
            got = ip[b * T:(b + 1) * T].sort(dim=-1).values
            for t in torch.nonzero((got != want).any(-1)).flatten().tolist():
                out[b].append({"layer": j + cfg["model"][
                    "first_k_dense_replace"], "token": t, "margin": float(
                        p.values[t, K - 1] - p.values[t, K])})
    return [r[:10] for r in out]


def flips_by_layer(w):
    """Per MoE layer of the logged prefill: tokens whose top-k set differs
    port vs reference, the router input's relative L2, and the flips of the
    reference's input rounded to bf16 alone."""
    rows = []
    for (hp, ip), (j, hr) in zip(LOG["port"], LOG["ref"]):
        hr = hr.reshape(-1, hr.shape[-1])
        router = w["router"][j].to(torch.float32)
        want = top_sets(hr, router)
        got = ip.sort(dim=-1).values
        local = top_sets(hr.to(torch.bfloat16).float(), router)
        rows.append({
            "layer": j + cfg["model"]["first_k_dense_replace"],
            "tokens": hr.shape[0],
            "flipped": int((got != want).any(-1).sum()),
            "input_rel_l2": float((hp - hr).norm() / hr.norm()),
            "flipped_by_input_rounding": int((local != want).any(-1).sum())})
    return rows


def part(model, name, steps):
    t0 = time.time()
    w = sysmod.make_weights(model, a.seed, dev)
    ref = RefLog(w, model, "float32")
    params = sysmod.port_params(w, model)
    pcfg = sysmod.port_config(name, model)
    rng = np.random.default_rng(a.seed)
    B = 2 if steps else 1
    hist = torch.as_tensor(rng.integers(0, V, (B, a.hist)), device=dev)
    LOG.update(on=True, port=[], ref=[])
    with torch.inference_mode():
        pre, _ = transformer.prefill(params, hist[:1], pcfg,
                                     max_len=a.hist + L + 1)
    h0 = ref.history(hist[0])
    LOG["on"] = False
    rec = {"part": name, "layers": model["num_hidden_layers"],
           "dtype": model["dtype"], "seed": a.seed, "hist": a.hist,
           "prefill_rel_gap": float((pre[0, 0, :V] - h0.last_logits[:V]).abs()
                                    .max() / h0.last_logits[:V].abs().max()),
           "routing": flips_by_layer(w)}
    if steps:
        LOG.update(on=True, port=[], ref=[])
        with torch.inference_mode():
            pre_b, _ = transformer.prefill(params, hist, pcfg,
                                           max_len=a.hist + L + 1)
        hs = [ref.history(hist[b]) for b in range(B)]
        LOG["on"] = False
        rec["prefill_rel_gap_by_request"] = [
            float((pre_b[b, 0, :V] - h.last_logits[:V]).abs().max()
                  / h.last_logits[:V].abs().max()) for b, h in enumerate(hs)]
        rec["prefill_flips_by_request"] = batch_flips(w, B)
        tm = TransitionMatrix.from_sids(rng.integers(0, V, (200_000, L)), V,
                                        dense_d=s["dense_d"], device=dev)
        ret = GenerativeRetriever(params, pcfg, DecodePolicy.static(tm), L, V,
                                  beam_size=M)
        got_steps, search = [], generative_retrieval.beam_search

        def spy(logits_fn, cache, *args, **kw):
            def fn(c, last, step):
                logits, c = logits_fn(c, last, step)
                got_steps.append(logits)
                return logits, c
            state, carry, trace = search(fn, cache, *args, return_trace=True,
                                         **kw)
            got_steps.append(trace)
            return state, carry

        generative_retrieval.beam_search = spy
        GMM["log"] = []
        with torch.inference_mode():
            ret._retrieve(hist)
        rec["grouped_mm"] = grouped_summary(
            1e-4 if model["dtype"] == "float32" else 3e-2)
        GMM["log"] = None
        generative_retrieval.beam_search = search
        trace, decode = got_steps[-1], got_steps[:-1]
        rel, margin = [], []  # a row's gap; its least top-k margin
        for b, h in enumerate(hs):
            for st, got in enumerate(decode, start=1):
                prefix = trace.tokens[st - 1][b, :, :st]
                LOG["margins"] = []
                want = ref.suffix_logits(h, prefix, last_only=True)
                m = torch.stack(LOG["margins"]).view(-1, M, st)
                LOG["margins"] = None
                margin.append(m.amin(dim=(0, 2)))
                g = got[b].float()
                rel.append((g - want[:, :V]).abs().amax(-1)
                           / want[:, :V].abs().amax(-1))
        rel, margin = torch.cat(rel), torch.cat(margin)
        rec["decode_rel_gap_max_by_request"] = [
            float(r.max()) for r in rel.view(B, -1)]
        off = rel > 1e-4
        rec.update(decode_steps=len(decode), decode_rows=int(rel.numel()),
                   decode_rel_gap_max=float(rel.max()),
                   decode_rows_over_1e4=int(off.sum()),
                   decode_rel_gap_max_of_the_rest=float(
                       rel[~off].max()) if (~off).any() else None,
                   off_rows=[{"rel_gap": float(r), "least_margin": float(q)}
                             for r, q in zip(rel[off][:20], margin[off][:20])],
                   least_margin_median=float(margin.median()),
                   rows_with_margin_below_1e5=int((margin < 1e-5).sum()))
    rec["seconds"] = time.time() - t0
    emit(rec)
    del w, ref, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def judge_cell(model, name):
    """The configuration's cell served and judged as the benchmark does
    (``run_cell``'s inputs, two rounds, the sampled requests against the
    float32 reference), with ``model`` in place of its model."""
    from gpubench.harness.runner import make_inputs, sample_requests

    t0 = time.time()
    cell = next(c for c in spec.data["workloads"]
                if c["config"] == cfg["name"])
    traffic = spec.traffic(cell["traffic"])
    run_cfg = dict(cfg, model=model)
    weights, catalog, meta, reqs = make_inputs(sysmod, run_cfg, traffic,
                                               a.seed, dev)
    system = sysmod.System(run_cfg, traffic, weights, catalog, meta, dev)
    loop = spec.loop(traffic["loop"])
    served = []
    loop.window(system, reqs, served, rounds=2)
    system.close()
    sample = sample_requests(served, traffic["check_requests"], a.seed)
    emit({"part": name, "layers": model["num_hidden_layers"],
          "dtype": model["dtype"], "seed": a.seed, "served": len(served),
          "readings": sysmod.judge(run_cfg, weights, catalog, meta, served,
                                   sample),
          "seconds": time.time() - t0})
    del weights, system
    if dev.type == "cuda":
        torch.cuda.empty_cache()


if dev.type == "cuda":
    print(json.dumps({"torch": torch.__version__,
                      "card": torch.cuda.get_device_name()}), flush=True)
torch._grouped_mm = grouped_mm
parts = a.parts.split(",")
f32 = dict(cfg["model"], num_hidden_layers=a.layers, dtype="float32")
if "A" in parts:
    part(f32, "A_float32_full_width", steps=True)
if "Aloop" in parts:  # the same with each grouped product a loop of products
    GMM["loop"] = True
    part(f32, "A_float32_full_width_loop", steps=True)
    GMM["loop"] = False
if "B" in parts:
    part(dict(cfg["model"]), "B_served_bf16", steps=False)
if "C" in parts:  # served bf16 through the retriever, grouped products checked
    part(dict(cfg["model"]), "C_served_bf16_retriever", steps=True)
for key, dtype in (("J", "float32"), ("Jb", "bfloat16")):
    if key in parts:  # the cell's own judge, its model cut to --layers
        judge_cell(dict(cfg["model"], num_hidden_layers=a.layers,
                        dtype=dtype), key)
if a.out:
    pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        for r in out:
            f.write(json.dumps(r) + "\n")
