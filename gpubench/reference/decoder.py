"""Plain decoder of a dense GQA transformer, for judging what the served model
computed.

It follows the architecture the configuration states, written from its
equations: token embedding, then per layer an RMS norm, grouped-query
attention with rotary positions on interleaved pairs, a residual, an RMS norm,
a SwiGLU feed-forward and a residual; a final RMS norm and logits against the
tied embedding.  It reads the weights the benchmark made (the stacked layout
of :func:`gpubench.harness.data.make_weights`) and nothing the program made.

Two precisions:

* ``"float32"`` — every value and product in float32 (the weights' bf16
  values exactly), TF32 off while it runs: the reference.
* ``"fp8"`` — the control: every matmul operand rounded to float8 e4m3 with
  a per-row (activations) or per-output-column (weights) scale, products
  accumulated in float32.  It stands in for the program computed one
  precision below the configuration's bfloat16.

Histories are processed one request at a time and the beams of a request in
one block: ``history`` runs the causal pass over the request's tokens and
keeps each layer's keys and values; ``suffix_logits`` runs beam suffixes
after it (each suffix attends to the shared history and causally to itself),
recomputed from the start at each call.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["Decoder", "History", "no_tf32"]

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls in float32, not TF32, while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@dataclasses.dataclass
class History:
    keys: list  # per layer (S, KVH, Dh) float32
    values: list  # per layer (S, KVH, Dh) float32
    last_logits: torch.Tensor  # (vocab,) float32, at the history's last position

    @property
    def length(self) -> int:
        return self.keys[0].shape[0]


class Decoder:
    """The configuration's decoder over the benchmark's weights.

    ``model`` holds the configuration's sizes (``n_layers``, ``d_model``,
    ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab_size``,
    ``rope_theta``, ``norm_eps``); ``weights`` the stacked tensors, whose
    ``device`` it runs on.
    """

    def __init__(self, weights: dict, model: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision}")
        self.m = model
        self.quant = precision == "fp8"
        self.H, self.KV = model["n_heads"], model["n_kv_heads"]
        self.hd = model["head_dim"] or model["d_model"] // model["n_heads"]
        self.eps = model["norm_eps"]
        f32 = {k: v.to(torch.float32) for k, v in weights.items()}
        if self.quant:  # weights (d_in, d_out): a scale per output column
            for k in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
                f32[k] = _fp8(f32[k], dim=-2)
            f32["emb"] = _fp8(f32["emb"], dim=-1)  # rows are output columns
        self.w = f32
        self.device = dev = f32["emb"].device
        exps = torch.arange(0, self.hd, 2, dtype=torch.float32, device=dev)
        self.freqs = 1.0 / (model["rope_theta"] ** (exps / self.hd))

    # -- pieces ------------------------------------------------------------
    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = _fp8(x, dim=-1)
        return x @ w

    def _bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched product; in fp8 both operands rounded along the
        contracted dimension."""
        if self.quant:
            a, b = _fp8(a, dim=-1), _fp8(b, dim=-2)
        return a @ b

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (..., T, heads, Dh) rotated by positions pos (T,), on the pairs
        (x[2i], x[2i + 1])."""
        ang = pos.to(torch.float32)[:, None] * self.freqs  # (T, Dh/2)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                           dim=-1).flatten(-2)

    def _ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        h = self._norm(x, w["ln_ffn"][i])
        g = self._mm(h, w["w1"][i])
        return x + self._mm(g * torch.sigmoid(g) * self._mm(h, w["w3"][i]),
                            w["w2"][i])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self._mm(self._norm(x, self.w["final_norm"]), self.w["emb"].T)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["emb"][tokens.long()]

    # -- passes --------------------------------------------------------------
    def history(self, tokens: torch.Tensor) -> History:
        """The causal pass over one request's history tokens (S,)."""
        w, H, KV, hd = self.w, self.H, self.KV, self.hd
        G = H // KV
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        causal = pos[None, :] <= pos[:, None]  # (query, key)
        x = self._embed(tokens)
        keys, values = [], []
        for i in range(self.m["n_layers"]):
            h = self._norm(x, w["ln_attn"][i])
            q = self._rope(self._mm(h, w["wq"][i]).view(S, H, hd), pos)
            k = self._rope(self._mm(h, w["wk"][i]).view(S, KV, hd), pos)
            v = self._mm(h, w["wv"][i]).view(S, KV, hd)
            keys.append(k)
            values.append(v)
            qg = q.view(S, KV, G, hd).permute(1, 2, 0, 3)  # (KV, G, S, hd)
            s = self._bmm(qg, k.permute(1, 2, 0)[:, None]) * hd ** -0.5
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            o = self._bmm(p, v.permute(1, 0, 2)[:, None])  # (KV, G, S, hd)
            x = x + self._mm(o.permute(2, 0, 1, 3).reshape(S, H * hd),
                             w["wo"][i])
            x = self._ffn(i, x)
        return History(keys, values, self._logits(x[-1]))

    def suffix_logits(self, hist: History, suffix: torch.Tensor,
                      last_only: bool = False) -> torch.Tensor:
        """Logits (R, T, vocab) at each position of R suffixes (R, T) that
        follow ``hist``, or (R, vocab) at their last position."""
        w, H, KV, hd = self.w, self.H, self.KV, self.hd
        G = H // KV
        R, T = suffix.shape
        S = hist.length
        pos = torch.arange(S, S + T, device=suffix.device)
        causal = pos[None, :] <= pos[:, None]  # (T, T)
        x = self._embed(suffix)  # (R, T, D)
        for i in range(self.m["n_layers"]):
            h = self._norm(x, w["ln_attn"][i])
            q = self._rope(self._mm(h, w["wq"][i]).view(R, T, H, hd), pos)
            k = self._rope(self._mm(h, w["wk"][i]).view(R, T, KV, hd), pos)
            v = self._mm(h, w["wv"][i]).view(R, T, KV, hd)
            qg = q.view(R, T, KV, G, hd).permute(0, 2, 3, 1, 4)  # (R,KV,G,T,hd)
            hk = hist.keys[i].permute(1, 2, 0)  # (KV, hd, S)
            hv = hist.values[i].permute(1, 0, 2)  # (KV, S, hd)
            s_h = self._bmm(qg, hk[None, :, None])  # (R, KV, G, T, S)
            s_s = self._bmm(qg, k.permute(0, 2, 3, 1)[:, :, None])  # (.., T, T)
            s_s = s_s.masked_fill(~causal, float("-inf"))
            p = torch.softmax(torch.cat([s_h, s_s], -1) * hd ** -0.5, dim=-1)
            o = (self._bmm(p[..., :S], hv[None, :, None])
                 + self._bmm(p[..., S:], v.permute(0, 2, 1, 3)[:, :, None]))
            x = x + self._mm(o.permute(0, 3, 1, 2, 4).reshape(R, T, H * hd),
                             w["wo"][i])
            x = self._ffn(i, x)
        return self._logits(x[:, -1] if last_only else x)
