"""Plain decoder of a DeepSeek-V2 transformer (multi-head latent attention, a
routed mixture of experts with shared experts, YaRN), for judging what the
served model computed.

It follows the equations of the published ``modeling_deepseek.py``
(DeepSeek-V2-Lite's ``config.json`` names them): token embedding, then per
layer an RMS norm, MLA, a residual, an RMS norm, a feed-forward and a
residual; a final RMS norm and logits against an untied output matrix.

* MLA without q-LoRA, not absorbed: ``q = W_q h`` split per head into a
  non-rotary part and a rotary part; ``[c ; k_pe] = W_kv_a h``, ``c`` RMS
  normed; ``K = [W_uk c ; k_pe]`` (the rotary key shared by every head),
  ``V = W_uv c``; softmax of ``q . K`` times the scale below, causal.
* Rotary positions on interleaved pairs ``(x[2i], x[2i + 1])``: what the
  published model's permute-then-rotate-half computes on its checkpoint's
  layout (it permutes queries and keys alike, so their products are these).
* YaRN (``rope_scaling``, ``DeepseekV2YarnRotaryEmbedding``): pair ``i``'s
  frequency ``theta ** (-2i / d)`` is blended with itself divided by
  ``factor`` by a ramp over the pairs making ``beta_fast`` to
  ``beta_slow`` rotations in ``original_max_position_embeddings``
  positions; cos and sin carry ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``; the softmax scale is ``(nope + rope)
  ** -0.5 * mscale(factor, mscale_all_dim) ** 2``, ``mscale(s, m) = 0.1 m
  ln s + 1``.
* The first ``first_k_dense_replace`` layers have a SwiGLU feed-forward;
  every later one routes each token to the ``num_experts_per_tok`` experts
  of largest float32 softmax score (greedy, nothing dropped), weights each
  expert's SwiGLU output by its score (divided by the top-k sum only where
  ``norm_topk_prob``, times ``routed_scaling_factor``) and adds the shared
  experts, one SwiGLU of ``n_shared_experts * moe_intermediate_size``.

Departures from the published model, none of which changes the function:
every value is float32 here (the published model computes in bf16 but for
its router and norms); the router's weight is read from a (hidden, experts)
matrix, the transpose of the checkpoint's ``gate.weight``; each expert's
outputs are added in float32 in the order the experts are visited, not the
published ``moe_infer``'s sorted order; no q-LoRA, attention bias, grouped
top-k or auxiliary loss, which DeepSeek-V2-Lite's configuration does not
use (other values raise).

It reads the weights the benchmark made (``systems/gr_mla_moe.py``'s
layout, bf16) and nothing the program made, upcasting one layer's
projections, or one expert, at a time: a float32 copy of the whole model
would be twice its size.  Two precisions, as
:class:`gpubench.reference.decoder.Decoder`: ``"float32"`` (the reference;
TF32 off while it runs) and ``"fp8"`` (the control: every matmul operand
rounded to float8 e4m3 under a scale per row of activations or per output
column of weights, products accumulated in float32).
"""
from __future__ import annotations

import math

import torch

from gpubench.reference.decoder import History, _fp8, no_tf32

__all__ = ["MLAMoEDecoder", "yarn_mscale", "yarn_frequencies"]


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(dim: int, theta: float, rs: dict) -> torch.Tensor:
    """The (dim / 2,) rotary frequencies under YaRN's ``rope_scaling``."""
    def pair(rotations):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(pair(rs["beta_fast"])), 0)
    high = min(math.ceil(pair(rs["beta_slow"])), dim - 1)
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    return base / rs["factor"] * ramp + base * (1 - ramp)


UNSUPPORTED = {"q_lora_rank": None, "scoring_func": "softmax",
               "topk_method": "greedy", "attention_bias": False,
               "hidden_act": "silu", "moe_layer_freq": 1, "n_group": 1,
               "topk_group": 1, "tie_word_embeddings": False}


class MLAMoEDecoder:
    """The configuration's decoder over the benchmark's weights.

    ``model`` holds the published configuration's keys; ``weights`` the
    stacked bf16 tensors of ``systems/gr_mla_moe.py``, whose ``device`` it
    runs on."""

    def __init__(self, weights: dict, model: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision}")
        bad = {k: model.get(k) for k, v in UNSUPPORTED.items()
               if model.get(k, v) != v}
        if bad or model["rope_scaling"].get("type") != "yarn":
            raise ValueError(f"unsupported settings {bad} / "
                             f"{model['rope_scaling']}")
        self.m, self.w = model, weights
        self.quant = precision == "fp8"
        self.device = weights["emb"].device
        self.H = model["num_attention_heads"]
        self.nope, self.rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
        self.lora, self.vd = model["kv_lora_rank"], model["v_head_dim"]
        self.eps = model["rms_norm_eps"]
        self.n_dense = model["first_k_dense_replace"]
        rs = model["rope_scaling"]
        self.freqs = yarn_frequencies(self.rope, model["rope_theta"],
                                      rs).to(self.device)
        self.mag = (yarn_mscale(rs["factor"], rs["mscale"])
                    / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
        self.scale = ((self.nope + self.rope) ** -0.5
                      * yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2)

    # -- pieces ------------------------------------------------------------
    def _w(self, name: str, *index) -> torch.Tensor:
        """One weight matrix (d_in, d_out) in float32; in fp8 rounded under
        a scale per output column."""
        w = self.w[name][index].to(torch.float32)
        return _fp8(w, dim=-2) if self.quant else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, dim=-1) if self.quant else x) @ w

    def _bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched product; in fp8 both operands rounded along the
        contracted dimension."""
        if self.quant:
            a, b = _fp8(a, dim=-1), _fp8(b, dim=-2)
        return a @ b

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
                * scale.to(torch.float32))

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (..., T, heads, d) rotated by positions pos (T,) on pairs
        (x[2i], x[2i + 1])."""
        ang = pos.to(torch.float32)[:, None] * self.freqs  # (T, d/2)
        cos = (torch.cos(ang) * self.mag)[:, None, :]
        sin = (torch.sin(ang) * self.mag)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                           dim=-1).flatten(-2)

    def _swiglu(self, h, w1, w3, w2) -> torch.Tensor:
        g = self._mm(h, w1)
        return self._mm(g * torch.sigmoid(g) * self._mm(h, w3), w2)

    def _experts(self, j: int, h: torch.Tensor) -> torch.Tensor:
        """Routed and shared experts of MoE layer ``j`` on h (N, D)."""
        m = self.m
        probs = torch.softmax(self._mm(h, self._w("router", j)), dim=-1)
        top_w, top_i = torch.topk(probs, m["num_experts_per_tok"], dim=-1)
        if m["norm_topk_prob"]:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        top_w = top_w * m["routed_scaling_factor"]
        y = torch.zeros_like(h)
        for e in torch.unique(top_i).tolist():
            tok, k = torch.nonzero(top_i == e, as_tuple=True)
            out = self._swiglu(h[tok], self._w("w1", j, e), self._w("w3", j, e),
                               self._w("w2", j, e))
            y.index_add_(0, tok, out * top_w[tok, k, None])
        return y + self._swiglu(h, self._w("shared_w1", j),
                                self._w("shared_w3", j),
                                self._w("shared_w2", j))

    def _ffn(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if i < self.n_dense:
            return self._swiglu(h, self._w("dense_w1", i), self._w("dense_w3", i),
                                self._w("dense_w2", i))
        shape = h.shape
        return self._experts(i - self.n_dense, h.reshape(-1, shape[-1])
                             ).reshape(shape)

    def _forward(self, tokens: torch.Tensor, past: History | None = None):
        """Hidden states (R, T, D) of R rows of T tokens after ``past`` (one
        history shared by the rows), and each layer's new keys (R, T, H,
        nope + rope) and values (R, T, H, v)."""
        H, nope, rope, lora, vd = self.H, self.nope, self.rope, self.lora, self.vd
        R, T = tokens.shape
        S = 0 if past is None else past.length
        pos = torch.arange(S, S + T, device=tokens.device)
        causal = pos[None, :] <= pos[:, None]  # (T, T)
        x = self.w["emb"][tokens.long()].to(torch.float32)
        keys, values = [], []
        for i in range(self.m["num_hidden_layers"]):
            h = self._norm(x, self.w["ln_attn"][i])
            q = self._mm(h, self._w("wq", i)).view(R, T, H, nope + rope)
            q = torch.cat([q[..., :nope], self._rope(q[..., nope:], pos)], -1)
            kv_a = self._mm(h, self._w("w_kv_a", i))
            c = self._norm(kv_a[..., :lora], self.w["kv_norm"][i])
            k_pe = self._rope(kv_a[..., None, lora:], pos)  # (R, T, 1, rope)
            kv = self._mm(c, self._w("w_kv_b", i)).view(R, T, H, nope + vd)
            k = torch.cat([kv[..., :nope], k_pe.expand(R, T, H, rope)], -1)
            v = kv[..., nope:]
            keys.append(k)
            values.append(v)
            qh = q.permute(0, 2, 1, 3)  # (R, H, T, nope + rope)
            s = self._bmm(qh, k.permute(0, 2, 3, 1)) * self.scale  # (R,H,T,T)
            s = s.masked_fill(~causal, float("-inf"))
            vh = v.permute(0, 2, 1, 3)  # (R, H, T, vd)
            if past is not None:
                pk = past.keys[i].permute(1, 2, 0)[None]  # (1, H, d, S)
                pv = past.values[i].permute(1, 0, 2)[None]  # (1, H, S, vd)
                s = torch.cat([self._bmm(qh, pk) * self.scale, s], -1)
                p = torch.softmax(s, dim=-1)
                o = self._bmm(p[..., :S], pv) + self._bmm(p[..., S:], vh)
            else:
                o = self._bmm(torch.softmax(s, dim=-1), vh)
            x = x + self._mm(o.permute(0, 2, 1, 3).reshape(R, T, H * vd),
                             self._w("wo", i))
            x = x + self._ffn(i, self._norm(x, self.w["ln_ffn"][i]))
        return x, keys, values

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self._mm(self._norm(x, self.w["final_norm"]), self._w("unemb"))

    # -- passes --------------------------------------------------------------
    def history(self, tokens: torch.Tensor) -> History:
        """The causal pass over one request's history tokens (S,)."""
        with torch.inference_mode(), no_tf32():
            x, keys, values = self._forward(tokens[None])
            return History([k[0] for k in keys], [v[0] for v in values],
                           self._logits(x[0, -1]))

    def suffix_logits(self, hist: History, suffix: torch.Tensor,
                      last_only: bool = False) -> torch.Tensor:
        """Logits (R, T, vocab) at each position of R suffixes (R, T) that
        follow ``hist``, or (R, vocab) at their last position."""
        with torch.inference_mode(), no_tf32():
            x, _, _ = self._forward(suffix, hist)
            return self._logits(x[:, -1] if last_only else x)
