"""Inputs made from the seed: weights, the catalog's SIDs and its metadata.

:func:`make_weights` makes a dense GQA decoder's weights, the system file
``gr_retrieval``'s; a system of another architecture draws its own from
``generator(seed, "weights", device)``.

Everything is drawn on the run's device with seeded ``torch.Generator``s, in
a few large calls, in the dtype it is served in; each kind of input has a
stream of its own (:func:`stream_seed`), so adding one never moves another.
The same seed gives the same arrays on the same device type.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["stream_seed", "generator", "make_weights", "make_catalog",
           "make_meta", "torch_dtype"]

STREAMS = {"weights": 1, "catalog": 2, "meta": 3, "requests": 4, "sample": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` derived from the run's ``seed`` (any
    non-negative integer)."""
    ss = np.random.SeedSequence([int(seed), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def make_weights(model: dict, seed: int, device) -> dict:
    """A dense GQA decoder's weights, stacked over layers: ``emb`` (vocab, D),
    ``final_norm`` (D,), ``ln_attn``/``ln_ffn`` (n, D), ``wq`` (n, D, H*hd),
    ``wk``/``wv`` (n, D, KV*hd), ``wo`` (n, H*hd, D), ``w1``/``w3`` (n, D, F),
    ``w2`` (n, F, D).  Embeddings N(0, 0.02²); projections He-normal
    (variance 2 / fan-in); norm scales 1 + N(0, 0.1²)."""
    gen = generator(seed, "weights", device)
    dt = torch_dtype(model["dtype"])
    n, D, F = model["n_layers"], model["d_model"], model["d_ff"]
    H, KV = model["n_heads"], model["n_kv_heads"]
    hd = model["head_dim"] or D // H

    def normal(shape, std, mean=0.0):
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        w.mul_(std)
        return w.add_(mean) if mean else w

    return {
        "emb": normal((model["vocab_size"], D), 0.02),
        "final_norm": normal((D,), 0.1, 1.0),
        "ln_attn": normal((n, D), 0.1, 1.0),
        "ln_ffn": normal((n, D), 0.1, 1.0),
        "wq": normal((n, D, H * hd), (2.0 / D) ** 0.5),
        "wk": normal((n, D, KV * hd), (2.0 / D) ** 0.5),
        "wv": normal((n, D, KV * hd), (2.0 / D) ** 0.5),
        "wo": normal((n, H * hd, D), (2.0 / (H * hd)) ** 0.5),
        "w1": normal((n, D, F), (2.0 / D) ** 0.5),
        "w3": normal((n, D, F), (2.0 / D) ** 0.5),
        "w2": normal((n, F, D), (2.0 / F) ** 0.5),
    }


def _keys(tokens: torch.Tensor, vocab: int) -> list:
    """(N, L) tokens -> int64 keys whose lexicographic order is the rows'."""
    per_key = 1
    while vocab ** (per_key + 1) < 2 ** 63:
        per_key += 1
    keys = []
    for c0 in range(0, tokens.shape[1], per_key):
        k = torch.zeros(tokens.shape[0], dtype=torch.int64,
                        device=tokens.device)
        for c in range(c0, min(c0 + per_key, tokens.shape[1])):
            k = k * vocab + tokens[:, c]
        keys.append(k)
    return keys


def make_catalog(n_items: int, length: int, vocab: int, seed: int,
                 device) -> np.ndarray:
    """``n_items`` SIDs with uniform tokens, lexicographically sorted and
    unique (a repeat, about 1 in 1e12 runs at 20M items, is dropped), as
    (N, length) int32 on the host."""
    gen = generator(seed, "catalog", device)
    tok = torch.randint(0, vocab, (n_items, length), generator=gen,
                        device=device, dtype=torch.int64)
    keys = _keys(tok, vocab)
    order = torch.arange(n_items, device=device)
    for k in reversed(keys):
        order = order[torch.argsort(k[order], stable=True)]
    keys = [k[order] for k in keys]
    new = torch.ones(n_items, dtype=torch.bool, device=device)
    if n_items > 1:
        same = torch.ones(n_items - 1, dtype=torch.bool, device=device)
        for k in keys:
            same &= k[1:] == k[:-1]
        new[1:] = ~same
    return tok[order[new]].to(torch.int32).cpu().numpy()


def make_meta(n_items: int, seed: int, device, max_age_days: float,
              n_categories: int) -> dict:
    """Per-item metadata: ``age_days`` uniform in [0, max_age_days) and
    ``category`` uniform over ``n_categories``."""
    gen = generator(seed, "meta", device)
    age = torch.rand(n_items, generator=gen, device=device,
                     dtype=torch.float64) * max_age_days
    cat = torch.randint(0, n_categories, (n_items,), generator=gen,
                        device=device)
    return {"age_days": age.cpu().numpy(), "category": cat.cpu().numpy()}
