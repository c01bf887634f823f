"""A system file of the tests, ``tiny_fused``: a decoder whose weights take a
layout that ``data.make_weights`` cannot make, added as a file alone.

The decoder is the dense GQA one, but its query, key and value projections
are one fused ``wqkv`` (n, D, (H + 2 KV) hd) and its gate and up projections
one ``w13`` (n, D, 2F).  The program under test is the port's
``ServingEngine`` of ``gr_retrieval``, given views of the fused tensors in
its own parameter layout; the reference is a decoder of this file's own over
the fused tensors; a retrieve's work is counted the coarse way (two
operations a parameter a token, the weights read once a pass), so that it
differs from the dense count.
"""
from __future__ import annotations

import torch

from gpubench.harness import data, work
from gpubench.reference.decoder import History, _fp8
from gpubench.systems import gr_retrieval as gr

__all__ = ["System", "judge", "make_weights", "retrieve_passes", "decoder"]


def _sizes(model: dict) -> tuple:
    H, KV = model["n_heads"], model["n_kv_heads"]
    return H, KV, model["head_dim"] or model["d_model"] // H, model["d_ff"]


def make_weights(model: dict, seed: int, device) -> dict:
    """Fused ``wqkv`` and ``w13`` beside ``emb``, the norms, ``wo`` and
    ``w2``; the scales of :func:`gpubench.harness.data.make_weights`."""
    gen = data.generator(seed, "weights", device)
    dt = data.torch_dtype(model["dtype"])
    n, D = model["n_layers"], model["d_model"]
    H, KV, hd, F = _sizes(model)

    def normal(shape, std, mean=0.0):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return w.mul_(std).add_(mean)

    return {
        "emb": normal((model["vocab_size"], D), 0.02),
        "final_norm": normal((D,), 0.1, 1.0),
        "ln_attn": normal((n, D), 0.1, 1.0),
        "ln_ffn": normal((n, D), 0.1, 1.0),
        "wqkv": normal((n, D, (H + 2 * KV) * hd), (2.0 / D) ** 0.5),
        "wo": normal((n, H * hd, D), (2.0 / (H * hd)) ** 0.5),
        "w13": normal((n, D, 2 * F), (2.0 / D) ** 0.5),
        "w2": normal((n, F, D), (2.0 / F) ** 0.5),
    }


def retrieve_passes(model: dict, B: int, M: int, S: int, L: int) -> list:
    """Two operations a parameter a token and the weights once a pass."""
    params = work.param_count(model)
    w_bytes = params * work.DTYPES[model["dtype"]]["bytes"]
    return ([work.Pass("prefill", 2.0 * params * B * S, w_bytes)]
            + [work.Pass(f"decode{j}", 2.0 * params * B * M, w_bytes)
               for j in range(1, L)])


def _split(w: dict, model: dict) -> dict:
    """The fused tensors as views in the dense layout the port reads."""
    H, KV, hd, F = _sizes(model)
    q, kv = H * hd, KV * hd
    qkv, w13 = w["wqkv"], w["w13"]
    return {k: w[k] for k in ("emb", "final_norm", "ln_attn", "ln_ffn",
                              "wo", "w2")} | {
        "wq": qkv[..., :q], "wk": qkv[..., q:q + kv], "wv": qkv[..., q + kv:],
        "w1": w13[..., :F], "w3": w13[..., F:]}


class System(gr.System):
    def __init__(self, cfg, traffic, weights, catalog, meta, device):
        super().__init__(cfg, traffic, _split(weights, cfg["model"]), catalog,
                         meta, device)


class FusedDecoder:
    """The fused decoder in float32, or with every matmul operand rounded
    to float8 e4m3 (``"fp8"``, the control)."""

    def __init__(self, weights: dict, model: dict, precision: str):
        self.m, self.quant = model, precision == "fp8"
        self.H, self.KV, self.hd, self.F = _sizes(model)
        w = {k: v.to(torch.float32) for k, v in weights.items()}
        if self.quant:
            for k in ("wqkv", "wo", "w13", "w2"):
                w[k] = _fp8(w[k], dim=-2)
            w["emb"] = _fp8(w["emb"], dim=-1)
        self.w, self.device = w, w["emb"].device
        exps = torch.arange(0, self.hd, 2, dtype=torch.float32,
                            device=self.device)
        self.freqs = 1.0 / (model["rope_theta"] ** (exps / self.hd))

    def _mm(self, x, w):
        return (_fp8(x, -1) if self.quant else x) @ w

    def _norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.m["norm_eps"]) * scale

    def _rope(self, x, pos):
        ang = pos.to(torch.float32)[:, None] * self.freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                           dim=-1).flatten(-2)

    def _forward(self, tokens, past=None):
        """Hidden states (R, T, D) of R rows of T tokens after ``past``, and
        each layer's new keys and values (R, T, KV, hd)."""
        w, H, KV, hd = self.w, self.H, self.KV, self.hd
        R, T = tokens.shape
        S = 0 if past is None else past.length
        pos = torch.arange(S, S + T, device=tokens.device)
        seen = torch.cat([torch.ones(T, S, dtype=torch.bool,
                                     device=tokens.device),
                          pos[None, :] <= pos[:, None]], 1)  # (T, S + T)
        x = w["emb"][tokens]
        keys, values = [], []
        for i in range(self.m["n_layers"]):
            qkv = self._mm(self._norm(x, w["ln_attn"][i]), w["wqkv"][i])
            q, k, v = qkv.split([H * hd, KV * hd, KV * hd], -1)
            q = self._rope(q.reshape(R, T, H, hd), pos)
            k = self._rope(k.reshape(R, T, KV, hd), pos)
            v = v.reshape(R, T, KV, hd)
            keys.append(k)
            values.append(v)
            if past is not None:
                k = torch.cat([past.keys[i].expand(R, -1, -1, -1), k], 1)
                v = torch.cat([past.values[i].expand(R, -1, -1, -1), v], 1)
            qg = q.reshape(R, T, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
            kt = k.permute(0, 2, 3, 1)[:, :, None]  # (R, KV, 1, hd, S + T)
            vt = v.permute(0, 2, 1, 3)[:, :, None]  # (R, KV, 1, S + T, hd)
            if self.quant:  # along the contracted dimension
                kt, vt = _fp8(kt, -2), _fp8(vt, -2)
            s = self._mm(qg, kt) * hd ** -0.5
            p = torch.softmax(s.masked_fill(~seen, -torch.inf), dim=-1)
            o = self._mm(p, vt)
            x = x + self._mm(o.permute(0, 3, 1, 2, 4).reshape(R, T, H * hd),
                             w["wo"][i])
            gu = self._mm(self._norm(x, w["ln_ffn"][i]), w["w13"][i])
            g, u = gu.split(self.F, -1)
            x = x + self._mm(g * torch.sigmoid(g) * u, w["w2"][i])
        return x, keys, values

    def _logits(self, x):
        return self._mm(self._norm(x, self.w["final_norm"]), self.w["emb"].T)

    def history(self, tokens: torch.Tensor) -> History:
        x, keys, values = self._forward(tokens[None])
        return History([k[0] for k in keys], [v[0] for v in values],
                       self._logits(x[0, -1]))

    def suffix_logits(self, hist: History, suffix: torch.Tensor,
                      last_only: bool = False) -> torch.Tensor:
        x, _, _ = self._forward(suffix, hist)
        return self._logits(x[:, -1] if last_only else x)


decoder = FusedDecoder


def judge(cfg, weights, catalog, meta, served, sample):
    return gr.readings(cfg, decoder(weights, cfg["model"], "float32"),
                       catalog, meta, served, sample)
