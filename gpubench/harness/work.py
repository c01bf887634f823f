"""The work of one constrained retrieve, counted from shapes, and the chip's
peaks it is held against.

:func:`retrieve_passes` counts a dense GQA decoder's retrieve (the system
file ``gr_retrieval`` names it as its own); a system of another architecture
counts its passes itself, and :func:`peak_flops` and :func:`least_seconds`
read only the configuration's dtype and the passes.

A retrieve of ``B`` requests with ``M`` beams and SIDs of ``L`` tokens runs a
prefill over the ``B`` histories of ``S`` tokens, then ``L - 1`` decode
steps over ``B * M`` rows.  Operations: ``2 x parameters x tokens`` for the
matmuls (the unembedding only where logits are read: the prefill's last
position and every decode row) plus ``4 x queries x keys x heads x head_dim``
for attention (half of it under the prefill's causal mask), the arithmetic of
``launch/steps.py``'s ``_gr_serve_cell``.  Least bytes: the weights once per
forward pass; the history's keys and values written once by the prefill and
read once per request (not per beam) by each decode step; the generated
positions read once per beam; each step's new keys and values written once;
the logits written once.  The configuration's ``model.dtype`` sets the
bytes a weight or cache value takes and the peak its operations are held
against (:data:`DTYPES`); a dtype missing there is an error.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DTYPES", "HBM_BYTES_PER_S", "Pass", "retrieve_passes",
           "decode_step_flops", "param_count", "peak_flops",
           "least_seconds"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit: per
# served dtype, the bytes a value and the matmul peak (float32 without TF32,
# as PyTorch runs float32 matmuls by default).
DTYPES = {"bfloat16": {"bytes": 2, "flops_per_s": 989e12},
          "float32": {"bytes": 4, "flops_per_s": 67e12}}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    flops: float
    bytes: float


def _dims(model: dict):
    D, H, KV = model["d_model"], model["n_heads"], model["n_kv_heads"]
    return D, H, KV, model["head_dim"] or D // H


def param_count(model: dict) -> int:
    """Matmul parameters: the embedding (tied: once) and every layer's
    projections and feed-forward; norm scales are not counted."""
    D, H, KV, hd = _dims(model)
    emb = model["vocab_size"] * D * (1 if model["tie_embeddings"] else 2)
    attn = D * hd * (H + 2 * KV) + H * hd * D
    return emb + model["n_layers"] * (attn + 3 * D * model["d_ff"])


def _weight_bytes(model: dict, elem: int) -> float:
    D = model["d_model"]
    norms = D * (2 * model["n_layers"] + 1)
    return (param_count(model) + norms) * elem


def _attn_flops(model: dict, queries: int, keys: float) -> float:
    _, H, _, hd = _dims(model)
    return 4.0 * queries * keys * H * hd


def decode_step_flops(model: dict, rows: int, kv_len: int) -> float:
    """One decode step of ``rows`` tokens, each attending to ``kv_len``
    positions."""
    return 2.0 * param_count(model) * rows + _attn_flops(model, rows, kv_len)


def peak_flops(model: dict) -> float:
    """The card's dense matmul peak in the model's dtype, operations/s."""
    return DTYPES[model["dtype"]]["flops_per_s"]


def retrieve_passes(model: dict, B: int, M: int, S: int, L: int) -> list:
    """The prefill and each decode step of one retrieve, with its operations
    and least bytes."""
    elem = DTYPES[model["dtype"]]["bytes"]
    D, H, KV, hd = _dims(model)
    vocab, n = model["vocab_size"], model["n_layers"]
    w_bytes = _weight_bytes(model, elem)
    kv_tok = 2 * n * KV * hd * elem  # one position's keys and values
    unemb = 2.0 * vocab * D
    body = 2.0 * (param_count(model) - vocab * D)  # per token, no unembedding
    pre_flops = (body * B * S + unemb * B
                 + _attn_flops(model, B * S, S) / 2)
    pre_bytes = (w_bytes + B * S * 4  # weights, token ids
                 + B * S * kv_tok  # the history's keys and values
                 + B * vocab * 4)  # last-position logits
    passes = [Pass("prefill", pre_flops, pre_bytes)]
    rows = B * M
    for j in range(1, L):
        kv_len = S + j  # the history, earlier generated positions, itself
        flops = decode_step_flops(model, rows, kv_len)
        byts = (w_bytes + rows * 4
                + B * S * kv_tok  # history, once a request
                + rows * (j - 1) * kv_tok  # generated positions, once a beam
                + rows * kv_tok  # this step's keys and values
                + rows * vocab * 4)
        passes.append(Pass(f"decode{j}", flops, byts))
    return passes


def least_seconds(model: dict, passes: list) -> float:
    """Sum over ``model``'s passes of the larger of operations and bytes
    over their peaks."""
    peak = peak_flops(model)
    return sum(max(p.flops / peak, p.bytes / HBM_BYTES_PER_S)
               for p in passes)
