"""Constrained-decoding baselines of the paper (§5.2), in PyTorch.

Counterparts of ``repro.core.baselines``.  Every baseline exposes
``mask(log_probs, prefix_tokens, step) -> masked_log_probs`` and
``mask_step(...) -> (masked_log_probs, next_states)`` with vocab-aligned
next states (DESIGN.md §3.1), so the ``repro_torch.decoding`` backends drive
them through the same ``DecodePolicy`` and beam search as STATIC.

  * ``CpuTrieBaseline``    — a nested-dict prefix tree on the host.  Every
    step copies the prefixes to the host, walks the trie there and sends the
    mask back, so the device waits for the host as under the reference's
    ``io_callback``.
  * ``PPVBaseline``        — DISC-PPV: a binary search over the sorted SID
    table on the device, ``ceil(log2 N) + 1`` dependent gathers per
    candidate.  ``exact=True`` checks every token, ``exact=False`` only the
    ``top_k`` most likely (the paper's approximate variant).
  * ``HashBitmapBaseline`` — every prefix of every SID hashed into a
    ``2^log2_bits``-bit table: constant time, false positives allowed.

None of them reaches a Pallas kernel in the reference (PPV and the bitmap
are plain XLA, the CPU trie a host callback), so each is plain PyTorch on
the device here.

Keys pack a SID into four 32-bit lanes, two 16-bit tokens each, in
lexicographic order.  Torch has no shifts or adds on ``uint32``, so the
lanes and hashes are int64 tensors holding uint32 values, masked to 32 bits
after every operation that can carry past them.  Lanes stay below 2^32, so
a signed comparison orders them as unsigned ones.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.trie import sorted_unique_sids
from repro_torch.core.vntk import NEG_INF

__all__ = [
    "CpuTrieBaseline",
    "PPVBaseline",
    "HashBitmapBaseline",
    "unconstrained_mask",
]

_MAX_L = 8  # key packing covers SIDs up to length 8 (paper: L=8)
_U32 = 0xFFFFFFFF


def _validate_sid_length(sid_length: int, who: str) -> None:
    """Fail at construction on SIDs longer than the key packing covers."""
    if sid_length > _MAX_L:
        raise ValueError(
            f"{who}: sid_length {sid_length} exceeds the key-packing limit "
            f"_MAX_L={_MAX_L}; rebuild with shorter SIDs")


def _alive_next(masked: torch.Tensor) -> torch.Tensor:
    """Vocab-aligned next states of a prefix-tracking baseline: 1 while the
    prefix is alive, 0 (the sink) where the token is invalid (DESIGN.md
    §3.1)."""
    return (masked > NEG_INF / 2).to(torch.int32)


def unconstrained_mask(log_probs, prefix_tokens, step):
    """Latency lower bound: no validity check at all."""
    del prefix_tokens, step
    return log_probs


# ---------------------------------------------------------------------------
# Key packing: tokens (..., L) -> 4 uint32 lanes, lexicographic order kept
# (token t occupies bits [16 * (1 - t % 2), ...) of lane t // 2).
# ---------------------------------------------------------------------------
def _pack_keys_np(tokens: np.ndarray, length: int) -> np.ndarray:
    """(..., length) -> (..., 4) uint32; positions >= length are zero."""
    if length > _MAX_L:
        raise ValueError(f"key packing supports L<={_MAX_L}")
    out = np.zeros(tokens.shape[:-1] + (4,), np.uint32)
    for t in range(min(length, tokens.shape[-1])):
        lane, hi = t // 2, (t % 2 == 0)
        shift = 16 if hi else 0
        out[..., lane] |= tokens[..., t].astype(np.uint32) << shift
    return out


def _pack_keys_torch(tokens: torch.Tensor, length: int) -> torch.Tensor:
    """(..., length) -> (..., 4) int64 holding the uint32 lanes of
    :func:`_pack_keys_np`; positions >= length are zero."""
    if length > _MAX_L:
        raise ValueError(f"key packing supports L<={_MAX_L}")
    n = min(length, tokens.shape[-1])
    t = torch.zeros(tokens.shape[:-1] + (_MAX_L,), dtype=torch.int64,
                    device=tokens.device)
    t[..., :n] = tokens[..., :n].long() & _U32
    return ((t[..., 0::2] << 16) + t[..., 1::2]) & _U32


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over trailing 4-lane keys."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for lane in range(4):
        less = less | (eq & (a[..., lane] < b[..., lane]))
        eq = eq & (a[..., lane] == b[..., lane])
    return less


def _extend(prefix: torch.Tensor, cand: torch.Tensor, step: int):
    """(nb, >= step) prefixes and (nb, k) candidates -> (nb, k, _MAX_L)
    tokens: the first ``step`` of each prefix, then the candidate, then
    zeros."""
    nb, k = cand.shape
    ext = torch.zeros((nb, k, _MAX_L), dtype=torch.int64, device=cand.device)
    if step:
        ext[:, :, :step] = prefix[:, None, :step].long()
    ext[:, :, step] = cand
    return ext


# ---------------------------------------------------------------------------
# CPU trie (pointer chasing on the host)
# ---------------------------------------------------------------------------
class CpuTrieBaseline:
    """Nested-dict prefix tree on the host, consulted once per step."""

    def __init__(self, sids: np.ndarray, vocab_size: int):
        self.vocab_size = int(vocab_size)
        self.sid_length = int(sids.shape[1])
        _validate_sid_length(self.sid_length, "CpuTrieBaseline")
        self.root: dict = {}
        for row in np.asarray(sids):
            node = self.root
            for tok in row:
                node = node.setdefault(int(tok), {})

    def _host_mask(self, prefixes: np.ndarray, step: int) -> np.ndarray:
        nb = prefixes.shape[0]
        out = np.zeros((nb, self.vocab_size), dtype=bool)
        for i in range(nb):
            node = self.root
            ok = True
            for t in range(step):
                node = node.get(int(prefixes[i, t]))
                if node is None:
                    ok = False
                    break
            if ok and node:
                out[i, list(node.keys())] = True
        return out

    def mask(self, log_probs, prefix_tokens, step: int):
        """Copies the prefixes to the host (a synchronization), walks the
        trie there and sends the mask back to ``log_probs``' device."""
        shape = log_probs.shape
        lp = log_probs.reshape(-1, self.vocab_size)
        pf = prefix_tokens.reshape(-1, prefix_tokens.shape[-1])
        mask = torch.from_numpy(self._host_mask(pf.cpu().numpy(), step))
        return torch.where(mask.to(lp.device), lp, NEG_INF).reshape(shape)

    def mask_step(self, log_probs, prefix_tokens, step: int):
        """(masked_lp, next_states), both vocab-aligned (DESIGN.md §3.1)."""
        masked = self.mask(log_probs, prefix_tokens, step)
        return masked, _alive_next(masked)


# ---------------------------------------------------------------------------
# PPV (DISC-PPV): sorted SID table + parallel binary search
# ---------------------------------------------------------------------------
class PPVBaseline:
    """Parallel Prefix-Verification by binary search (exact or top-k).

    The sorted table is built on ``device`` (default: the card).  A catalog
    that is already sorted and unique skips the host sort.
    """

    def __init__(self, sids: np.ndarray, vocab_size: int, exact: bool = True,
                 top_k: int = 50, device=None):
        sids = sorted_unique_sids(np.asarray(sids))
        _validate_sid_length(int(sids.shape[1]), "PPVBaseline")
        self.sids_sorted = torch.from_numpy(sids.astype(np.int32)).to(
            resolve_device(device))
        self.keys = _pack_keys_torch(self.sids_sorted, sids.shape[1])
        self.n = int(sids.shape[0])
        self.vocab_size = int(vocab_size)
        self.sid_length = int(sids.shape[1])
        self.exact = bool(exact)
        self.top_k = int(top_k)
        self.n_search_steps = max(1, int(np.ceil(np.log2(max(self.n, 2)))) + 1)

    def _lower_bound(self, cand_keys: torch.Tensor) -> torch.Tensor:
        """Vectorized lower bound over the sorted key table, a fixed number
        of rounds with no host synchronization. (..., 4) -> (...,)"""
        lo = torch.zeros(cand_keys.shape[:-1], dtype=torch.int64,
                         device=cand_keys.device)
        hi = torch.full_like(lo, self.n)
        for _ in range(self.n_search_steps):
            mid = (lo + hi) >> 1
            less = _lex_less(self.keys[mid.clamp(0, self.n - 1)], cand_keys)
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        return lo

    def _verify(self, prefix, cand, step: int):
        """prefix (nb, >= step), cand (nb, k) -> bool (nb, k): is the prefix
        followed by the candidate a prefix of some SID?"""
        ext = _extend(prefix, cand, step)
        idx = self._lower_bound(_pack_keys_torch(ext, step + 1))
        row = self.sids_sorted[idx.clamp(0, self.n - 1)]  # (nb, k, L)
        same = row[:, :, :step + 1] == ext[:, :, :step + 1]
        return (idx < self.n) & same.all(dim=-1)

    def mask(self, log_probs, prefix_tokens, step: int):
        shape = log_probs.shape
        V = self.vocab_size
        lp = log_probs.reshape(-1, V)
        pf = prefix_tokens.reshape(-1, prefix_tokens.shape[-1])
        if self.exact:
            cand = torch.arange(V, device=lp.device).expand(lp.shape)
            valid = self._verify(pf, cand, step)
            return torch.where(valid, lp, NEG_INF).reshape(shape)
        # approximate: verify only the top-k log-probs, ties to the lower
        # index as jax.lax.top_k breaks them
        top_lp, top_idx = torch.sort(lp, dim=-1, descending=True, stable=True)
        top_lp, top_idx = top_lp[:, :self.top_k], top_idx[:, :self.top_k]
        valid = self._verify(pf, top_idx, step)
        out = torch.full_like(lp, NEG_INF)
        out.scatter_(1, top_idx, torch.where(valid, top_lp, NEG_INF))
        return out.reshape(shape)

    def mask_step(self, log_probs, prefix_tokens, step: int):
        """(masked_lp, next_states), both vocab-aligned (DESIGN.md §3.1)."""
        masked = self.mask(log_probs, prefix_tokens, step)
        return masked, _alive_next(masked)


# ---------------------------------------------------------------------------
# Hash bitmap (Bloom-style, false positives)
# ---------------------------------------------------------------------------
def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` holding uint32 values, in two
    16-bit halves of ``c`` so no int64 product overflows."""
    hi = (x * (c >> 16)) & 0xFFFF
    return ((hi << 16) + x * (c & 0xFFFF)) & _U32


def _mix32_torch(x: torch.Tensor) -> torch.Tensor:
    x = x & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class HashBitmapBaseline:
    """Every valid prefix (all levels) hashed into a ``2^log2_bits`` bitmap,
    built on ``device`` (default: the card)."""

    def __init__(self, sids: np.ndarray, vocab_size: int, log2_bits: int = 27,
                 device=None):
        sids = np.asarray(sids)
        self.vocab_size = int(vocab_size)
        self.sid_length = int(sids.shape[1])
        _validate_sid_length(self.sid_length, "HashBitmapBaseline")
        self.log2_bits = int(log2_bits)
        s = torch.from_numpy(sorted_unique_sids(sids)).to(
            resolve_device(device))
        bits = torch.zeros(1 << self.log2_bits, dtype=torch.bool,
                           device=s.device)
        # rows are sorted, so a prefix is new where it differs from the
        # previous row's: the distinct prefixes of each level, no sort
        new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
        for t in range(self.sid_length):
            new[1:] |= s[1:, t] != s[:-1, t]
            keys = _pack_keys_torch(s[new, :t + 1], t + 1)
            bits[self._hash_torch(keys, t)] = True
        by_byte = bits.view(-1, 8).to(torch.uint8)
        bitmap = by_byte[:, 0].clone()
        for b in range(1, 8):  # little-endian bits within each byte
            bitmap |= by_byte[:, b] << b
        self.bitmap = bitmap

    def _hash_np(self, keys: np.ndarray, step: int) -> np.ndarray:
        with np.errstate(over="ignore"):
            h = _mix32_np(
                keys[..., 0] ^ (np.uint32(0x9E3779B9) * np.uint32(step + 1)))
            for lane in range(1, 4):
                h = _mix32_np(h ^ (keys[..., lane] + np.uint32(0x85EBCA6B)
                                   + (h << 6) + (h >> 2)))
        return (h & np.uint32((1 << self.log2_bits) - 1)).astype(np.uint32)

    def _hash_torch(self, keys: torch.Tensor, step: int) -> torch.Tensor:
        h = _mix32_torch(keys[..., 0] ^ ((0x9E3779B9 * (step + 1)) & _U32))
        for lane in range(1, 4):
            h = _mix32_torch(h ^ ((keys[..., lane] + 0x85EBCA6B
                                   + ((h << 6) & _U32) + (h >> 2)) & _U32))
        return h & ((1 << self.log2_bits) - 1)

    def mask(self, log_probs, prefix_tokens, step: int):
        shape = log_probs.shape
        V = self.vocab_size
        lp = log_probs.reshape(-1, V)
        pf = prefix_tokens.reshape(-1, prefix_tokens.shape[-1])
        cand = torch.arange(V, device=lp.device).expand(lp.shape)
        h = self._hash_torch(_pack_keys_torch(_extend(pf, cand, step),
                                              step + 1), step)  # (nb, V)
        bit = (self.bitmap[h >> 3].long() >> (h & 7)) & 1
        return torch.where(bit.bool(), lp, NEG_INF).reshape(shape)

    def mask_step(self, log_probs, prefix_tokens, step: int):
        """(masked_lp, next_states), both vocab-aligned (DESIGN.md §3.1)."""
        masked = self.mask(log_probs, prefix_tokens, step)
        return masked, _alive_next(masked)

    def false_positive_rate(self, sids: np.ndarray, n_probe: int = 20000,
                            seed: int = 0) -> float:
        """Empirical false-positive rate at the deepest level (§5.2), from
        the reference's probes of the same seed.  Membership is a binary
        search over the sorted set's packed keys, not a set of tuples, so a
        catalog of tens of millions of SIDs takes seconds."""
        rng = np.random.default_rng(seed)
        L = self.sid_length
        probes = rng.integers(0, self.vocab_size, size=(n_probe, L),
                              dtype=np.int64)
        h = self._hash_np(_pack_keys_np(probes, L), L - 1)
        word = self.bitmap.cpu().numpy()[h >> 3]
        hit = ((word >> (h & 7)) & 1).astype(bool)
        members = _row_keys(sorted_unique_sids(np.asarray(sids)))
        want = _row_keys(probes)
        i = np.minimum(np.searchsorted(members, want), len(members) - 1)
        neg = members[i] != want
        return int(np.sum(hit & neg)) / max(int(neg.sum()), 1)


def _row_keys(sids: np.ndarray) -> np.ndarray:
    """(n, L) SIDs of tokens below 2^16 -> (n,) 16-byte keys whose byte
    order is the rows' lexicographic order (big-endian packed lanes)."""
    keys = _pack_keys_np(sids, sids.shape[1]).astype(">u4")
    return np.ascontiguousarray(keys).view("V16").ravel()
