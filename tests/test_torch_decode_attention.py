"""Decode attention's dispatch and the kernel wrapper's checks, on the CPU.

A CPU tensor takes the plain version (its values are held against the
reference in ``tests/test_torch_transformer.py``) and launches nothing; a
tensor subclass on the card raises; the kernel's argument checks run on any
device; its launch is driven through a fake library here (the kernel itself
runs only on the card: ``tests/test_torch_gpu.py``).  Imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import attention, transformer
from repro_torch.configs.base import TransformerConfig


def _inputs(rng, B=3, S=37, KVH=2, G=3, Dh=16, Dv=None, dtype=torch.bfloat16):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
    q, k, v = t(B, 1, KVH * G, Dh), t(B, S, KVH, Dh), t(B, S, KVH, Dv or Dh)
    return q, k, v, torch.arange(S, dtype=torch.int32), S - 1


CASES = {
    "bf16": {},
    "float32": {"dtype": torch.float32},
    "float16_dv_wider": {"dtype": torch.float16, "Dh": 8, "Dv": 24},
    "g1": {"G": 1, "KVH": 4},
    "g8": {"G": 8, "KVH": 1},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("masks", ["plain", "rows", "window"])
def test_cpu_takes_the_plain_version_bit_for_bit(monkeypatch, case, masks):
    """The dispatch hands a CPU call to the plain version with its arguments
    and returns its result, bit for bit; nothing launches."""
    rng = np.random.default_rng(7)
    q, k, v, pos, cur = _inputs(rng, **CASES[case])
    window = None
    if masks == "rows":  # (B, S) slots, some empty; a (B,) position tensor
        pos = pos.repeat(q.shape[0], 1)
        pos[1, ::4] = -1
        cur = torch.tensor([36, 20, -2])
    elif masks == "window":
        window = 9
    plain, calls = da.decode_attention_plain, []

    def spy(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(da, "decode_attention_plain", spy)
    da.reset_launches()
    got = attention.decode_attention(q, k, v, pos, cur, window=window)
    assert calls == [{"window": window, "scale": None}]
    assert da.LAUNCHES["decode_attention"] == 0
    want = plain(q, k, v, pos, cur, window=window)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ops.decode_attention(q, k, v, pos, cur, window=window,
                                            impl="plain"), want)


def test_cpu_decode_steps_launch_nothing():
    cfg = TransformerConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                            n_kv_heads=2, d_ff=64, vocab_size=50)
    params = transformer.init_params(cfg, 0, device="cpu")
    prompt = torch.arange(6).reshape(1, 6) % 50
    da.reset_launches()
    with torch.inference_mode():
        _, cache = transformer.prefill(params, prompt, cfg, max_len=9)
        for _ in range(3):
            _, cache = transformer.decode_step(params, cache,
                                               torch.ones(1, 1, dtype=torch.long),
                                               cfg)
    assert da.LAUNCHES["decode_attention"] == 0


@pytest.mark.parametrize("impl", ["cuda", "kernel", "xla", ""])
def test_impl_outside_none_and_plain_raises(impl):
    q, k, v, pos, cur = _inputs(np.random.default_rng(0))
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.decode_attention(q, k, v, pos, cur, impl=impl)


def test_the_kernel_takes_cuda_tensors_only():
    q, k, v, pos, cur = _inputs(np.random.default_rng(0))
    da.check(q, k, v, pos, cur)  # a valid call on any device
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_cuda(q, k, v, pos, cur)


def _bad(name, q, k, v, pos, cur, window=None):
    rng = np.random.default_rng(1)
    if name == "int_cache":
        k, v = k.to(torch.int16), v.to(torch.int16)
    elif name == "caches_of_two_dtypes":
        v = v.float()
    elif name == "float64_query":
        q = q.double()
    elif name == "dh_not_multiple_of_8":
        q, k, v, pos, cur = _inputs(rng, Dh=12)
    elif name == "dv_not_multiple_of_8":
        q, k, v, pos, cur = _inputs(rng, Dv=20)
    elif name == "dh_past_256":
        q, k, v, pos, cur = _inputs(rng, Dh=264)
    elif name == "q_rows_differ":
        q = q[:2]
    elif name == "v_slots_differ":
        v = v[:, :-1]
    elif name == "q_two_tokens":
        q = torch.cat([q, q], dim=1)
    elif name == "heads_not_a_multiple":
        q = q[:, :, :5]
    elif name == "q_dh_differs":
        q = q[..., :8]
    elif name == "three_dim_cache":
        k = k[:, :, 0]
    elif name == "k_innermost_stride":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "v_innermost_stride":
        v = v.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "q_innermost_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "k_misaligned_base":
        k = torch.cat([k.flatten(), k.flatten()[:4]])[4:].view(k.shape)
    elif name == "v_misaligned_slot_stride":
        v = torch.zeros(v.shape[:3] + (v.shape[3] + 4,), dtype=v.dtype)[
            ..., :v.shape[3]]
    elif name == "float_positions":
        pos = pos.float()
    elif name == "positions_of_another_length":
        pos = pos[:-1]
    elif name == "cur_float":
        cur = 3.0
    elif name == "cur_of_another_length":
        cur = torch.tensor([1, 2])
    elif name == "cur_2d":
        cur = torch.ones(3, 1, dtype=torch.long)
    elif name == "window_zero":
        window = 0
    elif name == "positions_on_meta":
        pos = pos.to("meta")
    return q, k, v, pos, cur, window


BAD = {  # case: what the message names
    "int_cache": "caches must share", "caches_of_two_dtypes": "caches must share",
    "float64_query": "q must be one of", "dh_not_multiple_of_8": "Dh = 12",
    "dv_not_multiple_of_8": "Dv = 20", "dh_past_256": "Dh = 264",
    "q_rows_differ": "shapes do not match",
    "v_slots_differ": "shapes do not match",
    "q_two_tokens": "shapes do not match",
    "heads_not_a_multiple": "shapes do not match",
    "q_dh_differs": "shapes do not match", "three_dim_cache": "4-D",
    "k_innermost_stride": "k_cache needs a unit innermost stride",
    "v_innermost_stride": "v_cache needs a unit innermost stride",
    "q_innermost_stride": "q needs a unit innermost stride",
    "k_misaligned_base": "k_cache must be 16-byte aligned",
    "v_misaligned_slot_stride": "v_cache must be 16-byte aligned",
    "float_positions": "slot_positions must be",
    "positions_of_another_length": "slot_positions must be",
    "cur_float": "cur_pos must be an int or a tensor",
    "cur_of_another_length": "cur_pos must be an int or an int32",
    "cur_2d": "cur_pos must be an int or an int32", "window_zero": "window",
    "positions_on_meta": "several devices"}


@pytest.mark.parametrize("name", list(BAD))
def test_check_raises_on_what_the_kernel_does_not_take(name):
    q, k, v, pos, cur = _inputs(np.random.default_rng(0), Dh=16)
    args = _bad(name, q, k, v, pos, cur)
    with pytest.raises(ValueError, match=BAD[name]):
        da.check(*args)


@pytest.mark.parametrize("view", ["layer_of_a_5d_cache", "slot_window",
                                  "positions_strided"])
def test_check_takes_strided_views(view):
    """The port's caches are views: a layer of the retriever's stacked cache,
    a window of slots, every other position of a longer vector."""
    q, k, v, pos, cur = _inputs(np.random.default_rng(0), S=20)
    if view == "layer_of_a_5d_cache":
        k = torch.zeros((2,) + k.shape, dtype=k.dtype)[1]
    elif view == "slot_window":
        v = torch.zeros(v.shape[0], 30, *v.shape[2:], dtype=v.dtype)[:, 5:25]
    else:
        pos = torch.arange(40, dtype=torch.int64)[::2]
    da.check(q, k, v, pos, cur, window=4)


def test_route_depends_on_the_cache_length_alone():
    assert da.route(1) == da.route(265) == da.route(da.SHORT_MAX_S) == "short"
    assert da.route(da.SHORT_MAX_S + 1) == da.route(4096) == "split"


class _FakeLib:
    """Records ``decode_attention_launch``'s arguments; returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def decode_attention_launch(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("S,cur_kind", [(40, "int"), (40, "rows"),
                                        (1300, "scalar_tensor")])
def test_launch_passes_layout_and_counts_one_launch(monkeypatch, S, cur_kind):
    """What the wrapper hands the kernel: dtypes, strides in elements, a
    stride-0 position row for (S,) slots, a null position pointer and the
    value for an int ``cur_pos``, the split route's statistics buffer."""
    q, k, v, pos, _ = _inputs(np.random.default_rng(0), B=2, S=S, Dh=16,
                              Dv=24)
    k = torch.zeros((3,) + k.shape, dtype=k.dtype)[2]
    cur = {"int": S - 1, "rows": torch.tensor([S - 1, 3]),
           "scalar_tensor": torch.tensor(S - 1, dtype=torch.int32)}[cur_kind]
    lib = _FakeLib()
    monkeypatch.setattr(da, "_lib", lambda: lib)
    da.reset_launches()
    out = da._launch(q, k, v, pos, cur, 8, None, 1234)
    assert da.LAUNCHES["decode_attention"] == 1
    assert out.shape == (2, 1, 6, 24) and out.dtype == q.dtype
    (a,) = lib.calls
    assert a[:2] == (1, 1)  # bf16 cache, bf16 query
    assert a[3:5] == (q.stride(0), q.stride(2))
    assert a[6:9] == k.stride()[:3] and a[10:13] == v.stride()[:3]
    assert a[14:17] == (0, 1, 0)  # (S,) int32 positions: one row for all
    if cur_kind == "int":
        assert a[17] is None and a[20] == S - 1
    else:
        assert a[17] == cur.data_ptr() and a[19] == int(cur.dtype == torch.int64)
        assert a[18] == (1 if cur_kind == "rows" else 0)
    assert a[21] == 8  # the window
    assert (a[23] is None) == (da.route(S) == "short")
    assert a[24:30] == (2, S, 2, 3, 16, 24)
    assert a[30] == 16 ** -0.5 and a[31] == 1234


def test_a_failed_launch_raises_and_counts_nothing(monkeypatch):
    q, k, v, pos, cur = _inputs(np.random.default_rng(0))
    monkeypatch.setattr(da, "_lib", lambda: _FakeLib(err=700))
    da.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        da._launch(q, k, v, pos, cur, None, None, 0)
    assert da.LAUNCHES["decode_attention"] == 0


def test_launches_are_kept_apart_from_the_vntk_counters():
    from repro_torch.kernels import vntk

    assert "decode_attention" not in vntk.LAUNCHES


def test_meta_tensors_take_the_plain_version():
    """The multi-pod dry run traces decode steps over ``meta`` shards (and
    ``DTensor``s): they take the plain ops, which give shapes, not a
    launch."""
    q, k, v, pos, cur = (t.to("meta") if isinstance(t, torch.Tensor) else t
                         for t in _inputs(np.random.default_rng(0)))
    da.reset_launches()
    out = ops.decode_attention(q, k, v, pos, cur)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert da.LAUNCHES["decode_attention"] == 0
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.decode_attention(q, k, v, pos, cur, impl="cuda")


class _OnTheCard(torch.Tensor):
    """A tensor subclass that says it lives on the card and holds no data
    (as a ``DTensor`` over CUDA shards would reach the dispatch)."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, strides=t.stride(), dtype=t.dtype,
            device=torch.device("cuda"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a subclass with no data")


def test_a_tensor_subclass_on_the_card_raises():
    """Only ``meta`` data takes the plain version off the CPU: a subclass on
    the card reaches the kernel's checks, which raise before a launch."""
    q, k, v, pos, cur = _inputs(np.random.default_rng(0))
    q, k, v, pos = map(_OnTheCard, (q, k, v, pos))
    assert q.device.type == "cuda" and not q.is_meta
    da.reset_launches()
    with pytest.raises(ValueError, match="plain tensors, got q as _OnTheCard"):
        ops.decode_attention(q, k, v, pos, cur)
    assert da.LAUNCHES["decode_attention"] == 0


class _Subclass(torch.Tensor):
    """A plain subclass whose data is the tensor's own."""


@pytest.mark.parametrize("name", ["k_cache", "v_cache", "slot_positions",
                                  "cur_pos"])
def test_check_raises_on_a_tensor_subclass(name):
    args = dict(zip(("q", "k_cache", "v_cache", "slot_positions", "cur_pos"),
                    _inputs(np.random.default_rng(0))))
    if name == "cur_pos":
        args[name] = torch.tensor(3)
    args[name] = args[name].as_subclass(_Subclass)
    with pytest.raises(ValueError, match=f"got {name} as _Subclass"):
        da.check(*args.values())
