"""Mixture-of-Experts FFN with position-in-expert dispatch
(``repro.models.moe``).

Covers both MoE architectures: Mixtral-8x7B (8 experts, top-2) and
DeepSeek-V2-Lite (64 routed experts top-6 plus 2 shared, first layer dense).
Each token's top-k experts come from the router's softmax (ties to the lower
expert, as ``lax.top_k``); a token's position in an expert is the count of
earlier assignments to that expert over the token-major ``(T*K,)``
assignment list, and assignments at or past the capacity ``C`` are dropped.
The kept ones are copied into an ``(E, C, D)`` buffer per group, the
experts run as batched products over it, and each token sums its K
weighted outputs.

The copy into the buffer is a scatter with no accumulation: kept positions
are unique, and every dropped assignment writes one trash row that no
expert reads, so the buffer holds what the reference's ``.at[].add`` builds
without a host sync.  The combine adds the K outputs of a token in the
reference's order (``k = 0, 1, ...``, in the activation dtype) as plain
tensor adds, so it is deterministic on the card, where ``index_add_`` would
add in the order its atomics land.

With ``capacity_factor=None`` the dispatch is dropless, as a model served at
its published settings computes it (DeepSeek-V2-Lite): nothing is dropped,
so a token's output does not depend on the batch it came in.  The ``T*K``
assignments are sorted by expert (stably, so each expert's rows keep token
order), the experts' row offsets are a cumulative sum on the device, and the
routed experts run as one grouped product over the sorted rows alone
(``torch._grouped_mm``, int32 offsets); the outputs go back to token-major
order and combine as above.  Nothing of it waits for the device.

Each call is a span ``moe`` (no-op untraced).  While a profiler records,
:data:`ROUTING` counts the dropless dispatch's calls (layer-passes), the
assignments routed and, on the device, the distinct experts they hit, by
``phase`` (``"prefill"`` or ``"decode"``); :func:`routing_counts` reads it
once, after the recorded work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.vntk import top_m
from repro_torch.models.layers import _he, swiglu, swiglu_init
from repro_torch.observability.profiling import annotate

__all__ = ["expert_capacity", "moe_init", "moe_ffn", "ROUTING",
           "reset_routing", "routing_counts"]

# phase -> {"experts_hit": device int64 sum, "assignments": int, "passes": int}
ROUTING: dict = {}


def reset_routing() -> None:
    ROUTING.clear()


def routing_counts() -> dict:
    """:data:`ROUTING` on the host (reading it waits for the device):
    phase -> ``{"experts_hit", "assignments", "passes"}``, summed over the
    layer-passes recorded."""
    return {phase: {"experts_hit": int(c["experts_hit"]),
                    "assignments": c["assignments"], "passes": c["passes"]}
            for phase, c in ROUTING.items()}


def _record(phase: str, counts: torch.Tensor, assignments: int) -> None:
    """Count one layer-pass whose experts received ``counts`` (E,)
    assignments, while a profiler records."""
    if not torch.autograd._profiler_enabled():
        return
    c = ROUTING.setdefault(phase, {"experts_hit": 0, "assignments": 0,
                                   "passes": 0})
    c["experts_hit"] = c["experts_hit"] + (counts > 0).sum()
    c["assignments"] += assignments
    c["passes"] += 1


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-cap // 8) * 8)  # round up to 8


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.bfloat16, device=None):
    """The reference's distributions: a float32 He router, and expert
    weights ``(E, D, F)`` whose He fan-in is the leading axis, as the
    reference's ``_he`` takes it (``E`` for ``w1``/``w3``, ``d_expert``
    for ``w2``)."""
    E = cfg.n_experts
    p = {
        "router": _he(gen, (d_model, E), torch.float32, device),
        "w1": _he(gen, (E, d_model, cfg.d_expert), dtype, device),
        "w3": _he(gen, (E, d_model, cfg.d_expert), dtype, device),
        "w2": _he(gen, (E, cfg.d_expert, d_model), dtype, device,
                  fan_in=cfg.d_expert),
    }
    if cfg.n_shared:
        d_sh = cfg.d_shared or cfg.n_shared * cfg.d_expert
        p["shared"] = swiglu_init(gen, d_model, d_sh, dtype, device)
    return p


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig,
            phase: str = "prefill"):
    """x (..., D) -> (y (..., D), router aux loss (float32 scalar)).

    With ``cfg.capacity_factor=None`` every token is routed without drops
    (:func:`_dropless`).  Otherwise, with ``cfg.dispatch_groups = G >= 1``
    and a 3-D input (B, S, D) whose S divides by G, the tokens split into
    B*G groups of S/G, each dispatched on its own (own capacity, own
    positions) and the aux loss is the mean over the groups; else all
    tokens form one group.  Shared experts add outside the grouping.
    ``phase`` keys the dropless dispatch's counter (:data:`ROUTING`).
    """
    G = cfg.dispatch_groups
    D = x.shape[-1]
    with annotate("moe"):
        if cfg.capacity_factor is None:
            out, aux = _dropless(params, x.reshape(-1, D), cfg, phase)
        elif G >= 1 and x.dim() == 3 and x.shape[1] % G == 0:
            B, S, _ = x.shape
            out, aux = _dispatch(params, x.reshape(B * G, S // G, D), cfg)
            aux = aux.mean()
        else:
            out, aux = _dispatch(params, x.reshape(1, -1, D), cfg)
            aux = aux[0]
        out = out.reshape(x.shape)
        if "shared" in params:
            out = out + swiglu(params["shared"], x)
    return out, aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot`` without its range check, a host sync on the card
    (the indices are top-k positions, in range by construction)."""
    out = idx.new_zeros(idx.shape + (n,), dtype=dtype)
    return out.scatter_(-1, idx[..., None], 1)


def _top_k(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """``(probs, top_w, top_i)`` of x (..., D): the float32 softmax over
    the experts, its top-k (ties to the lower expert) and their weights,
    divided by their sum where ``cfg.norm_topk_prob``."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_w, top_i = top_m(probs, cfg.top_k)
    if cfg.norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return probs, top_w, top_i


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """The reference's routing of x (N, T, D), per group:
    ``(probs (N, T, E) f32, top_w (N, T, K) f32, top_i (N, T, K),
    pos (N, T*K), keep (N, T*K))`` — the top-k weights, each assignment's
    position in its expert (token-major order) and whether it fits the
    capacity."""
    N, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, top_w, top_i = _top_k(router, x, cfg)
    flat_e = top_i.reshape(N, T * K)
    counts = _one_hot(flat_e, E, torch.int32).cumsum(dim=1)  # (N, T*K, E)
    pos = counts.gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos < expert_capacity(T, cfg)
    return probs, top_w, top_i, pos, keep


def _dispatch(params, x: torch.Tensor, cfg: MoEConfig):
    """Routed experts of each group of x (N, T, D) -> ((N, T, D), aux (N,))."""
    N, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = expert_capacity(T, cfg)
    probs, top_w, top_i, pos, keep = route(params["router"], x, cfg)

    # Switch-style load-balancing loss: E * sum_e f_e * P_e, per group
    me = probs.mean(dim=1)  # (N, E)
    ce = _one_hot(top_i, E, torch.float32).sum(dim=2).mean(dim=1) / K
    aux = cfg.router_aux_weight * E * (me * ce).sum(dim=-1)  # ce: (N, E)

    flat_e = top_i.reshape(N, T * K)
    group = torch.arange(N, device=x.device)[:, None]
    # row of the (E*N*C + 1, D) buffer, expert-major so that one batched
    # product per expert serves every group; each dropped assignment -> trash
    row = torch.where(keep, (flat_e * N + group) * C + pos, E * N * C)
    xk = x.repeat_interleave(K, dim=1)  # (N, T*K, D): token t's k-th copy
    buf = x.new_zeros((E * N * C + 1, D)).index_put(
        (row.reshape(-1),), xk.reshape(-1, D))
    buf = buf[:-1].view(E, N * C, D)
    h = F.silu(torch.bmm(buf, params["w1"])) * torch.bmm(buf, params["w3"])
    y = torch.bmm(h, params["w2"]).reshape(E * N * C, D)

    out_k = y[torch.where(keep, row, 0).reshape(-1)].view(N, T * K, D)
    out_k = out_k * keep[..., None].to(x.dtype)
    out_k = (out_k * top_w.reshape(N, T * K, 1).to(x.dtype)).view(N, T, K, D)
    out = out_k[:, :, 0]
    for k in range(1, K):
        out = out + out_k[:, :, k]
    return out, aux


def _dropless(params, x: torch.Tensor, cfg: MoEConfig, phase: str):
    """Routed experts of x (T, D), nothing dropped -> ((T, D), aux)."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, top_w, top_i = _top_k(params["router"], x, cfg)
    flat_e = top_i.reshape(-1)  # (T*K,), token-major
    order = torch.argsort(flat_e, stable=True)  # by expert, then token
    counts = flat_e.new_zeros(E).scatter_add_(0, flat_e,
                                              torch.ones_like(flat_e))
    _record(phase, counts, T * K)
    offs = counts.cumsum(0).to(torch.int32)
    rows = x.index_select(0, order // K)
    h = (F.silu(torch._grouped_mm(rows, params["w1"], offs=offs))
         * torch._grouped_mm(rows, params["w3"], offs=offs))
    y = torch._grouped_mm(h, params["w2"], offs=offs)
    out_k = torch.empty_like(y).index_copy_(0, order, y)  # token-major
    out_k = (out_k * top_w.reshape(T * K, 1).to(x.dtype)).view(T, K, D)
    out = out_k[:, 0]
    for k in range(1, K):
        out = out + out_k[:, k]
    if not torch.is_grad_enabled():  # served: no caller reads the loss
        return out, out.new_zeros((), dtype=torch.float32)
    # the load-balancing loss of :func:`_dispatch`, over one group
    aux = cfg.router_aux_weight * E * (
        probs.mean(dim=0) * counts.float() / (T * K)).sum()
    return out, aux
