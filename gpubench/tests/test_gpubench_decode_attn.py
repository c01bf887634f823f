"""``decode_attn_ms``: the device ms of the program's decode-attention
kernel a round.  It reads kernels named ``decode_attn`` and nothing else;
the kernel's symbols fall under no other metric's marks, so ``matmul_ms``
and ``copy_kernel_ms`` never count them; a trace without the kernel (the
program before it) reads nothing and raises nothing."""
from __future__ import annotations

import re
from types import SimpleNamespace

from gpubench.harness.spec import Spec
from gpubench.tests.tinyroot import REPO

KERNEL_SOURCE = REPO / "src" / "repro_torch" / "kernels" / "csrc" / \
    "decode_attention.cu"
OTHER_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "direct_copy")


def _rec(device_s, rounds=2):
    return SimpleNamespace(trace=SimpleNamespace(device_s=device_s),
                           trace_rounds=rounds)


def _kernels():
    src = KERNEL_SOURCE.read_text()
    return re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", src)


def test_the_kernels_symbols_are_named_for_the_metric_alone():
    names = _kernels()
    assert len(names) == 3, names
    for name in names:
        assert "decode_attn" in name
        assert not any(m in name.lower() for m in OTHER_MARKS), name


def test_reads_the_kernels_ms_a_round_and_nothing_else():
    spec = Spec(REPO)
    read = spec.reader("decode_attn_ms").read
    names = ["void (anonymous namespace)::decode_attn_kernel<__nv_bfloat16, "
             "3>(Params)", "void (anonymous namespace)::"
             "decode_attn_split_kernel<float>(Params)"]
    device_s = {names[0]: 0.030, names[1]: 0.002,
                "nvjet_tst_192x72_64x6_1x2_h_bz_NNT": 0.5,
                "void at::native::elementwise_kernel<128, 4, direct_copy>": 0.7}
    assert abs(read(_rec(device_s)) - 16.0) < 1e-9
    assert read(_rec({k: v for k, v in device_s.items()
                      if k not in names})) is None
    assert read(_rec(device_s, rounds=0)) is None
    assert read(SimpleNamespace(trace=None, trace_rounds=2)) is None
    for other in ("matmul_ms", "copy_kernel_ms"):
        got = spec.reader(other).read(_rec({n: 1.0 for n in names}))
        assert got is None, other
