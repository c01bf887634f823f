"""The DeepSeek-V2 system (``systems/gr_mla_moe.py``): the port against the
plain reference decoder (``reference/mla_moe_decoder.py``) on seeded random
weights at a tiny size (``tiny/tiny-mla-moe.json``: 3 layers, the first
dense, 8 experts top-2 and one shared, latent rank 32, rotary 16, YaRN), the
tiny cell run from files alone with every metric the DeepSeek cell lists,
the work count, the three MoE readers and the control.

Tolerances.  Float32 on both sides: logits within 1e-4 of the largest
magnitude (the same function; sums in another order).  The port in bf16
against the float32 reference: within 0.25 of the largest logit magnitude
(rounding of every activation to bf16 through three layers, which also
moves near-tied expert choices; the port reads 0.066 and 0.115 at these
seeds).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench.calibrate import control_readings
from gpubench.harness import work
from gpubench.harness.runner import run_cell
from gpubench.harness.spec import Spec
from gpubench.tests.tinyroot import REPO, TINY, make_root, one_thread
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.decoding import DecodePolicy
from repro_torch.models import moe, transformer
from repro_torch.serving import GenerativeRetriever, generative_retrieval

CPU = torch.device("cpu")
CELL = "tiny-mla-moe-b4"
NEW = ("expert_gemm_ms", "expert_roofline_share", "moe_host_ms")
REAL = "dsv2lite-stacked5-b8"
# what a CPU run reads of them: the host's clock, spans and counters (a CPU
# trace holds no device kernels, and the constraint kernels, counted by
# vntk_launches, run on the card alone)
HOST = {"engine_host_ms", "index_gb", "retrieve_mfu",
        "retrieve_roofline_share", "decoder_host_ms", "constraint_host_ms",
        "beam_select_host_ms", "kv_host_ms", "device_wait_ms",
        "retrieve_self_ms", "moe_host_ms"}


def add_mla_moe_cell(root):
    """The tiny DeepSeek-V2 configuration and its cell, as a file and
    entries alone; every metric that lists the DeepSeek cell lists it."""
    shutil.copy(TINY / "tiny-mla-moe.json",
                root / "gpubench" / "configs" / "tiny-mla-moe.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-mla-moe", "source": "test",
                            "why": "test", "reduced": [],
                            "file": "gpubench/configs/tiny-mla-moe.json"})
    spec["workloads"].append({"name": CELL, "config": "tiny-mla-moe",
                              "traffic": "closed-tiny-zipf", "chips": 1,
                              "why": "test"})
    for m in spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = add_mla_moe_cell(make_root(tmp_path_factory.mktemp("root")))
    return Spec(root, root / "gpubench")


@pytest.fixture(autouse=True)
def _one_thread_and_a_clean_counter():
    with one_thread():
        yield
    moe.reset_routing()


def _model(dtype: str) -> dict:
    cfg = json.loads((TINY / "tiny-mla-moe.json").read_text())
    return dict(cfg["model"], dtype=dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_port_through_the_retriever_matches_the_reference(spec, dtype, tol,
                                                          seed, monkeypatch):
    """The prefill's logits and every decode step's, through the retriever's
    tiled and reordered latent cache, against the reference's full forward
    over each beam's tokens."""
    sysmod = spec.system("gr_mla_moe")
    model = _model(dtype)
    w = sysmod.make_weights(model, seed, CPU)
    ref = sysmod.decoder(w, model, "float32")
    V, L, M, B = 64, 4, 8, 2
    rng = np.random.default_rng(seed)
    tm = TransitionMatrix.from_sids(rng.integers(0, V, (500, L)), V,
                                    dense_d=2, device="cpu")
    ret = GenerativeRetriever(sysmod.port_params(w, model),
                              sysmod.port_config("tiny", model),
                              DecodePolicy.static(tm), L, V, beam_size=M)
    hist = torch.as_tensor(rng.integers(0, V, (B, 16)))
    steps, search = [], generative_retrieval.beam_search

    def spy(logits_fn, cache, *args, **kw):
        def fn(c, last, step):
            logits, c = logits_fn(c, last, step)
            steps.append(logits)
            return logits, c

        state, carry, trace = search(fn, cache, *args, return_trace=True,
                                     **kw)
        steps.append(trace)
        return state, carry

    monkeypatch.setattr(generative_retrieval, "beam_search", spy)
    with torch.inference_mode():
        pre, _ = transformer.prefill(ret.params, hist, ret.cfg,
                                     max_len=16 + L + 1)
        ret._retrieve(hist)
    trace, decode = steps[-1], steps[:-1]
    assert len(decode) == L - 1
    worst = 0.0
    for b in range(B):
        h = ref.history(hist[b])
        want = h.last_logits[:V]
        worst = max(worst, float((pre[b, 0, :V] - want).abs().max())
                    / float(want.abs().max()))
        for s, got in enumerate(decode, start=1):
            prefix = trace.tokens[s - 1][b, :, :s]  # (M, s) after step s-1
            want = ref.suffix_logits(h, prefix, last_only=True)[:, :V]
            worst = max(worst, float((got[b] - want).abs().max())
                        / float(want.abs().max()))
    assert worst <= tol, worst


def test_the_tiny_cell_runs_correct_from_files_alone(tmp_path):
    root = add_mla_moe_cell(make_root(tmp_path))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gpubench import run\n"
        f"sys.exit(run.main(['--workload', {CELL!r}, '--seed', "
        "'2147483801', '--seconds', '0.3', '--trace', '1'], device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=240,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(root)})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == HOST, set(got) ^ HOST
    assert all(got[m] > 0 for m in HOST - {"device_wait_ms"}), got


def test_retrieve_passes_match_a_count_by_hand(spec):
    m = _model("bfloat16")
    B, M, S, L = 2, 8, 16, 4
    D, H, lora, rope, nope, vd = 64, 4, 32, 16, 16, 16
    attn = D * H * 32 + D * 48 + lora * H * 32 + H * 16 * D
    assert attn == 19456
    dense, expert, rs = 3 * 64 * 128, 3 * 64 * 32, 64 * 8 + 3 * 64 * 32
    body = 3 * attn + dense + 2 * (rs + 2 * expert)
    assert body == 120832
    w_bytes = (2 * 66 * 64 + body + 64 * 7 + 32 * 3) * 2
    lat = 3 * 48 * 2
    passes = spec.system("gr_mla_moe").retrieve_passes(m, B, M, S, L)
    assert [p.name for p in passes] == ["prefill", "decode1", "decode2",
                                        "decode3"]
    assert passes[0].flops == (2 * body * B * S + 2 * 66 * 64 * B
                               + 4 * B * S * S * H * (nope + rope + vd) * 3
                               / 2)
    assert passes[0].bytes == w_bytes + B * S * 4 + B * S * lat + B * 66 * 4
    for j, p in enumerate(passes[1:], start=1):
        rows = B * M
        assert p.flops == (2 * body * rows + 2 * 66 * 64 * rows
                           + 2 * rows * (S + j) * H * (2 * lora + rope) * 3)
        assert p.bytes == (w_bytes + rows * 4 + B * S * lat
                           + rows * (j - 1) * lat + rows * lat
                           + rows * 66 * 4)


def _record(kernels=None, spans=None, rounds=2):
    trace = SimpleNamespace(device_s=kernels or {}, busy_s=1.0)
    host = SimpleNamespace(spans=spans or {})
    return SimpleNamespace(
        trace=trace, host_trace=host, trace_rounds=rounds,
        cfg={"model": _model("bfloat16"), "search": {"sid_length": 4}})


GEMM = ("void cutlass::device_kernel<at::cuda::detail::GemmUniversal<"
        "cutlass::gemm::GroupProblemShape<cute::tuple<int, int, int> >>>")


def test_the_four_readers_read_a_synthetic_record(spec, monkeypatch):
    counts = {"prefill": {"experts_hit": 16, "assignments": 128,
                          "passes": 2},
              "decode": {"experts_hit": 30, "assignments": 60, "passes": 6}}
    monkeypatch.setattr(moe, "routing_counts", lambda: counts)
    rec = _record(kernels={GEMM: 0.004, "nvjet_tst_64x8": 0.5},
                  spans={"moe": [0.001] * 16})
    read = {m: spec.reader(m).read(rec) for m in NEW}
    assert read["expert_gemm_ms"] == pytest.approx(2.0)  # 4 ms over 2 rounds
    assert read["moe_host_ms"] == pytest.approx(8.0)
    # by hand: 2 MoE layers, one prefill pass and 3 decode passes each
    expert, elem = 3 * 64 * 32, 2
    byts = (2 * (8 * expert + 64 * 2 * 64) * elem
            + 6 * (5 * expert + 10 * 2 * 64) * elem)
    flops = 2 * 64 * 2 * expert + 6 * 10 * 2 * expert
    least = max(byts / work.HBM_BYTES_PER_S, flops / 989e12)
    assert read["expert_roofline_share"] == pytest.approx(
        100 * least / 2e-3, rel=1e-12)


@pytest.mark.parametrize("absent", ["counter", "kernels", "spans", "trace"])
def test_the_four_readers_read_nothing_where_it_is_absent(spec, absent,
                                                          monkeypatch):
    counts = {"prefill": {"experts_hit": 8, "assignments": 8, "passes": 1},
              "decode": {"experts_hit": 8, "assignments": 8, "passes": 1}}
    if absent == "counter":  # a program without the counter (the parent)
        monkeypatch.delattr(moe, "routing_counts")
    else:
        monkeypatch.setattr(moe, "routing_counts", lambda: counts)
    rec = _record(kernels=None if absent == "kernels" else {GEMM: 1e-3},
                  spans=None if absent == "spans" else {"moe": [1e-3]})
    if absent == "trace":
        rec.trace = rec.host_trace = None
    read = {m: spec.reader(m).read(rec) for m in NEW}
    gone = {"counter": {"expert_roofline_share"},
            "kernels": {"expert_gemm_ms", "expert_roofline_share"},
            "spans": {"moe_host_ms"}, "trace": set(NEW)}[absent]
    assert {m for m, v in read.items() if v is None} == gone


def test_the_port_tree_is_views_of_the_weights(spec):
    sysmod = spec.system("gr_mla_moe")
    model = _model("bfloat16")
    w = sysmod.make_weights(model, 5, CPU)
    params = sysmod.port_params(w, model)
    storages = {t.untyped_storage().data_ptr() for t in w.values()}
    own = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif node.untyped_storage().data_ptr() not in storages:
            own.append(path)

    walk(params, "")
    assert sorted(own) == ["/layers/1/moe/router", "/layers/2/moe/router"]
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert torch.equal(params["layers"][2]["moe"]["router"],
                       w["router"][1].float())


@pytest.mark.parametrize("seed", [19, 2 ** 33 + 9])
def test_the_control_fails_the_tiny_limit(spec, seed):
    limits = spec.config("tiny-mla-moe")["check"]["limits"]
    readings = control_readings(spec, CELL, seed, CPU)
    assert readings["bad_beams"] == 0
    assert readings["score_gap"] > limits["score_gap"]


def test_a_served_run_is_sound_within_the_tiny_limit(spec):
    with torch.inference_mode():
        rec, readings, attempted, failed = run_cell(
            spec, CELL, 2 ** 31 + 11, 0.2, False, CPU, time.perf_counter())
    limits = spec.config("tiny-mla-moe")["check"]["limits"]
    assert failed == 0 and attempted > 0
    assert all(readings[k] <= v for k, v in limits.items()), readings


def test_the_drift_probe_at_the_tiny_size():
    """``drift_probe.py`` on the tiny configuration: in float32 the port
    is the reference's function (no expert flipped, logits within 1e-4);
    served in bf16 it reads a routing row for each MoE layer."""
    tiny = TINY / "tiny-mla-moe.json"
    p = subprocess.run(
        [sys.executable, str(TINY.parents[1] / "drift_probe.py"),
         "--config-file", str(tiny), "--layers", "3", "--hist", "16",
         "--device", "cpu"], capture_output=True, text=True, timeout=240,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-3000:]
    a, b = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert a["prefill_rel_gap"] <= 1e-4 and a["decode_rel_gap_max"] <= 1e-4
    assert a["decode_rows"] == 2 * 8 * 3 and a["off_rows"] == []
    assert all(r["flipped"] == 0 and r["input_rel_l2"] <= 1e-5
               for r in a["routing"])
    assert b["dtype"] == "bfloat16" and len(b["routing"]) == 2


def test_the_published_keys_stand_at_the_top_and_under_model():
    """The configuration file holds the published config's keys twice: at
    its top level, as published, and under ``model``, which the harness
    hands to the system file.  The two copies agree key for key, and
    ``model`` adds only what the publication leaves open."""
    cfg = Spec(REPO).config(Spec(REPO).cell(REAL)["config"])
    top = {k: v for k, v in cfg.items() if k in cfg["model"]}
    assert set(cfg["model"]) - set(top) == {"dtype", "router_logit_std"}
    assert all(cfg["model"][k] == v for k, v in top.items())
    assert top["first_k_dense_replace"] == 1
    assert top["rope_scaling"]["type"] == "yarn"
