"""The work arithmetic (FLOPs, least bytes) and the trace's reductions."""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from gpubench.harness import work
from gpubench.harness.trace import _label_gaps, _union

CFG = json.loads((pathlib.Path(__file__).resolve().parents[1] / "configs"
                  / "static-gr-3b.single20m.json").read_text())
MODEL = CFG["model"]


def test_decode_step_flops_equal_the_dry_run_cell():
    from repro_torch.configs import static_gr
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import production_spec

    spec = production_spec()
    cell = steps.build_cell("static-gr", "gr_serve_constrained", spec)
    shape = next(s for s in static_gr.SHAPES
                 if s.name == "gr_serve_constrained")
    rows = shape.global_batch * shape.beam_size
    kv = shape.history_len + shape.sid_length
    n_chips = int(np.prod(spec.shape))
    assert work.decode_step_flops(MODEL, rows, kv) / n_chips == pytest.approx(
        cell.model_flops_per_chip, rel=1e-12)


def test_param_count_equals_the_port_config():
    from repro_torch.configs import static_gr

    assert work.param_count(MODEL) == static_gr.CONFIG.param_count()


def test_retrieve_at_b2_bounds():
    passes = work.retrieve_passes(MODEL, 2, 70, 256, 8)
    assert [p.name for p in passes] == ["prefill"] + [f"decode{j}"
                                                      for j in range(1, 8)]
    flops = sum(p.flops for p in passes)
    assert 1.0e13 < flops < 1.2e13  # ~1.09e13, as reckoned by hand
    least = work.least_seconds(MODEL, passes)
    assert 0.017 < least < 0.021  # prefill compute-bound, decodes by bytes
    pre = passes[0]
    assert pre.flops / 989e12 > pre.bytes / work.HBM_BYTES_PER_S
    for p in passes[1:]:
        assert p.bytes / work.HBM_BYTES_PER_S > p.flops / 989e12
    # history keys and values count once a request, not once a beam
    more_beams = work.retrieve_passes(MODEL, 2, 140, 256, 8)
    hist_kv = 2 * 256 * 2 * 26 * 8 * 128 * 2
    assert more_beams[1].bytes - passes[1].bytes < hist_kv


def test_the_configured_dtype_sets_bytes_and_peak():
    bf16 = work.retrieve_passes(MODEL, 2, 70, 256, 8)
    f32_model = dict(MODEL, dtype="float32")
    f32 = work.retrieve_passes(f32_model, 2, 70, 256, 8)
    assert [p.flops for p in f32] == [p.flops for p in bf16]
    # weights and cache values take twice the bytes; ids and logits do not
    assert 1.9 < f32[1].bytes / bf16[1].bytes < 2.0
    assert work.peak_flops(MODEL) == 989e12
    assert work.peak_flops(f32_model) == 67e12
    assert work.least_seconds(f32_model, f32) > 2 * work.least_seconds(
        MODEL, bf16)
    with pytest.raises(KeyError):
        work.retrieve_passes(dict(MODEL, dtype="float16"), 2, 70, 256, 8)


def test_union_and_gaps():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 55]])
    busy, gaps = _union(iv)
    assert busy == pytest.approx((20 + 10 + 5) * 1e-9)
    assert gaps.tolist() == [[20, 30], [40, 50]]
    host = np.array([[0, 100], [18, 32], [41, 49]])
    labels = _label_gaps(gaps, ["outer", "sync", "launch"], host)
    assert labels == {"sync": pytest.approx(10e-9),
                      "launch": pytest.approx(10e-9)}
    assert _union(np.zeros((0, 2), np.int64))[0] == 0.0
