"""CUDA decode attention: the ctypes wrapper and its plain PyTorch version.

``csrc/decode_attention.cu`` computes single-token GQA attention over a KV
cache (``models/attention.decode_attention``): per row and query head, the
float32 scores of the query against every cache slot, scaled, masked by the
slots' positions, a float32 softmax, the probabilities cast to the value
dtype, and their float32 product with the values cast to the query's dtype.
It replaces no Pallas kernel (the reference's ``decode_attention`` is plain
``jnp``): on the card the plain version below copied the whole cache twice
a call into permuted layouts and ran both products as ``align1`` GEMMs; the
kernel reads K and V once, in the cache's ``(B, S, KVH, D)`` layout,
through its strides, and writes only the output.

:func:`decode_attention_cuda` takes CUDA tensors only: it checks them
(:func:`check`, which runs on any device), raises on what the kernel does
not take, launches on the current stream and counts each call in
``LAUNCHES``; a cache longer than :data:`SHORT_MAX_S` slots takes the
kernel's split route (:func:`route`: two launches, one call).
:func:`decode_attention_plain` computes the same function with torch ops on
any device; the CPU path and the kernel comparisons use it.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from repro_torch.kernels import build
from repro_torch.kernels.products import NEG, product_f32

__all__ = ["LAUNCHES", "SHORT_MAX_S", "SPLIT_S", "reset_launches", "route",
           "check", "decode_attention_cuda", "decode_attention_plain"]

LAUNCHES = {"decode_attention": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POSITION_DTYPES = (torch.int32, torch.int64)
SHORT_MAX_S = 1024  # the longest cache whose scores the kernel keeps in shared memory
SPLIT_S = 1024  # slots a split on the long route
MAX_HEAD_DIM = 256


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


def route(S: int) -> str:
    """The kernel's route for a cache of ``S`` slots: ``"short"`` (scores in
    shared memory, one launch) or ``"split"`` (per-split statistics, then
    the output: two launches).  It depends on ``S`` alone, so a row's result
    never depends on how many rows share the call."""
    return "short" if S <= SHORT_MAX_S else "split"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/decode_attention.cu`` with its C signature declared
    (pointers and the stream as ``c_void_p``, so ctypes never truncates
    them); its route constants must be this module's."""
    lib = build.load("decode_attention")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.decode_attention_launch.argtypes = [
        i, i, p, i64, i64, p, i64, i64, i64, p, i64, i64, i64, p, i64, i64, i,
        p, i64, i, i64, i64, p, p, i, i, i, i, i, i, ctypes.c_float, p]
    lib.decode_attention_launch.restype = ctypes.c_int
    for name in ("decode_attention_short_max_s", "decode_attention_split_s"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if (lib.decode_attention_short_max_s(), lib.decode_attention_split_s()) != (
            SHORT_MAX_S, SPLIT_S):
        raise RuntimeError("csrc/decode_attention.cu's route constants differ "
                           "from kernels/decode_attention.py's")
    return lib


def check(q, k_cache, v_cache, slot_positions, cur_pos, window=None) -> None:
    """Raise ``ValueError`` on what the kernel does not take (on any device):
    q (B, 1, H, Dh), k_cache (B, S, KVH, Dh), v_cache (B, S, KVH, Dv) with
    S >= 1, H a multiple of KVH, Dh and Dv multiples of 8 up to 256;
    float32/bfloat16/float16 caches of one dtype and a query of one of
    those; unit innermost strides; K and V 16-byte aligned (base and outer
    strides); int32/int64 ``slot_positions`` of shape (S,) or (B, S);
    ``cur_pos`` an int or an integer tensor of shape (), (1,) or (B,);
    ``window`` None or >= 1; every tensor on one device and none a tensor
    subclass (a ``DTensor``'s data is not where its pointer would say)."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("slot_positions", slot_positions), ("cur_pos", cur_pos)):
        if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor:
            raise ValueError(f"the kernel takes plain tensors, got {name} as "
                             f"{type(t).__name__}")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"q, k_cache, v_cache must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, S, KVH, Dh = k_cache.shape
    H, Dv = q.shape[2], v_cache.shape[3]
    if (tuple(q.shape) != (B, 1, H, Dh)
            or tuple(v_cache.shape[:3]) != (B, S, KVH) or S < 1 or KVH < 1
            or H % KVH):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)} must be "
                         f"(B, 1, H, Dh) with H a multiple of KVH, k_cache "
                         f"{tuple(k_cache.shape)} (B, S >= 1, KVH, Dh), "
                         f"v_cache {tuple(v_cache.shape)} (B, S, KVH, Dv)")
    for name, d in (("Dh", Dh), ("Dv", Dv)):
        if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"{name} = {d}: the kernel takes multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    if k_cache.dtype not in DTYPES or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"caches must share one of {list(DTYPES)}, got "
                         f"{k_cache.dtype} and {v_cache.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {list(DTYPES)}, got {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit innermost stride, got "
                             f"strides {t.stride()}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for st, n in zip(
                t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name} must be 16-byte aligned: its base and "
                             f"outer strides {t.stride()[:3]} in bytes")
    if (slot_positions.dtype not in POSITION_DTYPES
            or tuple(slot_positions.shape) not in ((S,), (B, S))):
        raise ValueError(f"slot_positions must be int32/int64 of shape ({S},) "
                         f"or ({B}, {S}), got {slot_positions.dtype} "
                         f"{tuple(slot_positions.shape)}")
    devices = {q.device, k_cache.device, v_cache.device, slot_positions.device}
    if isinstance(cur_pos, torch.Tensor):
        if (cur_pos.dtype not in POSITION_DTYPES or cur_pos.dim() > 1
                or cur_pos.numel() not in (1, B)):
            raise ValueError(f"cur_pos must be an int or an int32/int64 "
                             f"tensor of shape (), (1,) or ({B},), got "
                             f"{cur_pos.dtype} {tuple(cur_pos.shape)}")
        devices.add(cur_pos.device)
    elif not isinstance(cur_pos, numbers.Integral) or isinstance(cur_pos, bool):
        raise ValueError(f"cur_pos must be an int or a tensor, got "
                         f"{type(cur_pos).__name__}")
    if window is not None and (not isinstance(window, numbers.Integral)
                               or window < 1):
        raise ValueError(f"window must be None or an int >= 1, got {window!r}")
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _launch(q, k_cache, v_cache, slot_positions, cur_pos, window, scale,
            stream: int) -> torch.Tensor:
    """Allocate the output (and the split route's statistics) and launch on
    ``stream``; the arguments are checked."""
    B, S, KVH, Dh = k_cache.shape
    H, Dv = q.shape[2], v_cache.shape[3]
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    stats = None
    if route(S) == "split":
        stats = torch.empty(B * H * -(-S // SPLIT_S) * 2, dtype=torch.float32,
                            device=q.device)
    pos_sb = slot_positions.stride(0) if slot_positions.dim() == 2 else 0
    if isinstance(cur_pos, torch.Tensor):
        cur, cur_sb, cur_i64, cur_value = (
            cur_pos.data_ptr(), cur_pos.stride(0) if cur_pos.numel() > 1 else 0,
            int(cur_pos.dtype == torch.int64), 0)
    else:
        cur, cur_sb, cur_i64, cur_value = None, 0, 0, int(cur_pos)
    err = _lib().decode_attention_launch(
        DTYPES[k_cache.dtype], DTYPES[q.dtype], q.data_ptr(), q.stride(0),
        q.stride(2), k_cache.data_ptr(), *k_cache.stride()[:3],
        v_cache.data_ptr(), *v_cache.stride()[:3], slot_positions.data_ptr(),
        pos_sb, slot_positions.stride(-1),
        int(slot_positions.dtype == torch.int64), cur, cur_sb, cur_i64,
        cur_value, 0 if window is None else int(window), out.data_ptr(),
        None if stats is None else stats.data_ptr(), B, S, KVH, H // KVH, Dh,
        Dv, scale if scale is not None else Dh ** -0.5, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_cuda(q, k_cache, v_cache, slot_positions, cur_pos, *,
                          window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """:func:`decode_attention_plain`'s function on the card, one call of
    the kernel (no backward: it raises for inputs that need a gradient)."""
    check(q, k_cache, v_cache, slot_positions, cur_pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        raise ValueError("decode_attention's kernel has no backward")
    with torch.cuda.device(q.device):
        return _launch(q, k_cache, v_cache, slot_positions, cur_pos, window,
                       scale, torch.cuda.current_stream().cuda_stream)


def decode_attention_plain(
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, S, KVH, Dh)
    v_cache: torch.Tensor,  # (B, S, KVH, Dv)
    slot_positions: torch.Tensor,  # (S,) or (B, S): position per slot, -1 empty
    cur_pos,  # int or (B,) tensor: position of the query token
    *,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token GQA attention over a KV cache, slot-validity masked, in
    torch ops (any device)."""
    B, S, KVH, Dh = k_cache.shape
    H = q.shape[2]
    G = H // KVH
    Dv = v_cache.shape[-1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q3 = q.reshape(B * KVH, G, Dh)
    kt = k_cache.permute(0, 2, 3, 1).reshape(B * KVH, Dh, S)
    s = product_f32(q3, kt).view(B, KVH, G, S) * scale
    pos = slot_positions.expand(B, S)
    cur = torch.as_tensor(cur_pos, device=q.device).expand(B)[:, None]
    mask = (pos >= 0) & (pos <= cur)
    if window is not None:
        mask = mask & (pos > cur - window)
    s = torch.where(mask[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    vv = v_cache.permute(0, 2, 1, 3).reshape(B * KVH, S, Dv)
    out = product_f32(p.view(B * KVH, G, S), vv)
    return out.reshape(B, 1, H, Dv).to(q.dtype)
