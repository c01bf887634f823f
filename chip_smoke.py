#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--constraints N] [--layers N] [--profile]

Phases (any failure raises and the script exits non-zero):

1. build   — compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one
             ``nvcc`` per source, all at once) and print the build time and
             ptxas resource lines.
2. kernels — every CUDA kernel function against its plain PyTorch version
             on the card, at the main path's shapes (nb = B*M = 140 rows,
             V = 2048, C = 72, each sparse level's bmax and trie nodes) and
             at stress shapes (prime nb, a bmax >= 512 root row of a
             dense_d=0 trie, rows parked at the sink, tie-heavy logits).
             Tokens and next states must be equal; scores equal when not
             fused, within rtol/atol 1e-5 when fused.  Device times come
             from CUDA graphs of back-to-back calls timed by CUDA events.
             The golden traces of ``tests/golden`` are replayed through the
             kernels as a small-input reference.
3. main    — ``static_gr.CONFIG`` (26 layers, d_model 3072, GQA 24/8, bf16)
             with seeded random weights and a trie of ``--constraints``
             random SIDs (default 20M), serving B=2 requests of 256-token
             histories at M=70, L=8 through ``GenerativeRetriever.retrieve``
             under four STATIC policies (topk / topk fused / vocab-aligned /
             vocab-aligned fused).  Every live beam must be in the constraint
             set, each policy's kernel must launch exactly L - dense_d = 6
             times per retrieve (the launch counters are zeroed just before
             this phase), and one batch rerun with the plain constraint step
             (``impl="plain"``) must give equal SIDs and scores.
4. report  — the card's ``nvidia-smi`` name and power limit, one JSON line
             per-kernel, then the last line
             ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Without CUDA, or without the repository's ``src/`` beside it, the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--constraints", type=int, default=None,
                    help="constraint-set size (default: static_gr.N_CONSTRAINTS)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (default: the config's 26)")
    ap.add_argument("--batches", type=int, default=3,
                    help="timed request batches per policy (after one warm-up)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one retrieve with torch.profiler and "
                         "print device time by kernel")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
KERNELS = {
    # name: (kernel, fused, TPU function it replaces)
    "vntk_topk": ("vntk_topk", False, "src/repro/kernels/vntk.py:1021"),
    "vntk_topk_fused": ("vntk_topk", True, "src/repro/kernels/vntk.py:1021"),
    "vntk_mask": ("vntk_mask", False, "src/repro/kernels/vntk.py:915"),
    "vntk_mask_fused": ("vntk_mask", True, "src/repro/kernels/vntk.py:940"),
}
SOURCE = "src/repro_torch/kernels/csrc/vntk.cu"


def needed_bytes(kernel, fused, nodes_np, rp_np, bmax, V, width) -> int:
    """Bytes the function must move for these inputs: the row-pointer pairs
    and valid edges it reads, the log-probs of the valid slots (the whole
    row when it normalizes), and its outputs, each once."""
    n_child = rp_np[nodes_np + 1].astype(np.int64) - rp_np[nodes_np]
    n_real = int(np.minimum(np.maximum(n_child, 0), bmax).sum())
    nb = nodes_np.shape[0]
    reads = nb * 4 + nb * 8 + n_real * 8
    reads += nb * V * 4 if fused else n_real * 4
    writes = nb * width * 12 if kernel == "vntk_topk" else nb * V * 8
    return reads + writes


class KernelCheck:
    """Runs one kernel function and its plain version on the same inputs."""

    def __init__(self, name):
        from repro_torch.kernels import vntk as kv

        self.name = name
        self.kernel, self.fused, self.replaces = KERNELS[name]
        self.cuda = getattr(kv, f"{self.kernel}_cuda")
        self.plain = getattr(kv, f"{self.kernel}_plain")
        self.max_abs_err = 0.0
        self.times = []  # (ms, plain_ms, bound_ms) per main-path level

    def args(self, values, nodes, tm, bmax, width):
        a = (values, nodes, tm.row_pointers, tm.edges, bmax, tm.vocab_size)
        return a + ((width,) if self.kernel == "vntk_topk" else ()) + (self.fused,)

    def compare(self, values, nodes, tm, bmax, width, label):
        a = self.args(values, nodes, tm, bmax, width)
        got = self.cuda(*a)
        want = self.plain(*a)
        torch.cuda.synchronize()
        for g, w in zip(got[1:], want[1:]):  # tokens / next states
            if not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"{self.name} [{label}]: integer outputs "
                                     "differ from the plain version")
        g, w = got[0], want[0].float()
        err = float((g - w).abs().max()) if g.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        ok = (torch.allclose(g, w, rtol=1e-5, atol=1e-5) if self.fused
              else torch.equal(g, w))
        if not ok:
            raise AssertionError(f"{self.name} [{label}]: scores differ from "
                                 f"the plain version (max abs err {err:g})")

    def time(self, values, nodes, tm, bmax, width, nodes_np, rp_np):
        a = self.args(values, nodes, tm, bmax, width)
        ms = device_ms(lambda: self.cuda(*a))
        plain_ms = device_ms(lambda: self.plain(*a), iters=10)
        bound = needed_bytes(self.kernel, self.fused, nodes_np, rp_np, bmax,
                             tm.vocab_size, width) / HBM_BYTES_PER_S * 1e3
        self.times.append((ms, plain_ms, bound))


def level_nodes(rng, ft, level, nb):
    lo, hi = int(ft.level_offsets[level]), int(ft.level_offsets[level + 1])
    return rng.integers(lo, hi, nb).astype(np.int32)


def make_values(rng, nb, V, fused, ties=False):
    """Raw logits (fused) or log-probs; bf16-rounded like the model's
    logits, or quantized to multiples of 0.5 for heavy ties."""
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    x = (x * 2).round() / 2 if ties else x.to(torch.bfloat16).float()
    x = x.cuda()
    return x if fused else torch.log_softmax(x, dim=-1)


def phase_kernels(rng, ft, tm, sids, M, checks):
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.vntk import candidate_width

    V, L, d = ft.vocab_size, ft.sid_length, ft.dense_d
    nb, C = 2 * M, candidate_width(M, ft.vocab_size)
    rp_np = ft.row_pointers
    # the root row of a dense_d=0 trie: one CSR row of every first token
    ft0 = build_flat_trie(sids[:200_000], V, dense_d=0)
    tm0 = TransitionMatrix.from_flat_trie(ft0, device="cuda")
    for chk in checks:
        for level in range(d, L):
            bmax = int(ft.level_bmax[level])
            nodes_np = level_nodes(rng, ft, level, nb)
            nodes = torch.from_numpy(nodes_np).cuda()
            values = make_values(rng, nb, V, chk.fused)
            chk.compare(values, nodes, tm, bmax, C, f"level {level}")
            chk.time(values, nodes, tm, bmax, C, nodes_np, rp_np)
        # stress: prime row count with a quarter of the rows at the sink,
        # tie-heavy values, and a bmax >= 512 root row
        nodes_np = level_nodes(rng, ft, d, 139)
        nodes_np[rng.random(139) < 0.25] = 0
        values = make_values(rng, 139, V, chk.fused, ties=True)
        chk.compare(values, torch.from_numpy(nodes_np).cuda(), tm,
                    int(ft.level_bmax[d]), C, "prime nb, sink rows, ties")
        bmax0 = int(ft0.level_bmax[0])
        if bmax0 < 512:
            raise AssertionError(f"stress root row has bmax {bmax0} < 512")
        nodes_np = np.ones(nb, np.int32)
        nodes_np[::7] = 0
        chk.compare(make_values(rng, nb, V, chk.fused), torch.from_numpy(
            nodes_np).cuda(), tm0, bmax0, C, f"bmax {bmax0} root row")
        ms, plain_ms, bound = np.mean(chk.times, axis=0)
        log(f"  {chk.name}: equal to plain at levels {d}-{L - 1} and stress "
            f"shapes; max abs err {chk.max_abs_err:.3g}; {ms * 1e3:.2f} us "
            f"(plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us) "
            f"per launch, mean over levels")


def phase_golden():
    """Replay tests/golden through the kernels: trace tokens must equal the
    frozen reference traces and scores agree within rtol 1e-6 (1e-5 when
    the kernel normalizes)."""
    from repro_torch.core.beam_search import beam_search
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy

    golden = os.path.join(HERE, "tests", "golden")
    inputs = np.load(os.path.join(golden, "inputs.npz"))
    traces = np.load(os.path.join(golden, "traces.npz"))
    table = torch.from_numpy(inputs["table"]).cuda()
    V, B, M = table.shape[-1], 2, 4
    L = table.shape[0]
    tm = TransitionMatrix.load(os.path.join(golden, "trie_small.npz"))
    tm_d0 = TransitionMatrix.from_sids(inputs["sids"], V, dense_d=0)

    def logits_fn(carry, last, step):
        return table[step][last.long()], carry

    for name, policy in (("static", DecodePolicy.static(tm)),
                         ("static_fused", DecodePolicy.static(tm, fused=True)),
                         ("static_d0", DecodePolicy.static(tm_d0))):
        for topk in (True, False):
            _, _, tr = beam_search(logits_fn, None, B, M, L,
                                   policy.with_topk(topk), return_trace=True)
            if not np.array_equal(tr.tokens.cpu().numpy(),
                                  traces[f"{name}_trace_tokens"]):
                raise AssertionError(f"golden {name} topk={topk}: trace tokens")
            tol = (dict(rtol=1e-5, atol=1e-5) if name == "static_fused"
                   else dict(rtol=1e-6))  # the fused kernel's own lse
            np.testing.assert_allclose(tr.scores.cpu().numpy(),
                                       traces[f"{name}_trace_scores"],
                                       err_msg=name, **tol)
    log("  golden traces static/static_fused/static_d0 (topk and dense "
        "advance) reproduced through the kernels")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def phase_main(args, rng, tm, sorted_sids):
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch.serve import compliance
    from repro_torch.models import transformer
    from repro_torch.serving import GenerativeRetriever

    cfg = static_gr.CONFIG
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    L, V, M, B = (static_gr.SID_LENGTH, static_gr.SID_VOCAB,
                  static_gr.BEAM_SIZE, 2)
    t0 = time.time()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers x {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {cfg.dtype} "
        f"({time.time() - t0:.1f}s init)")
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(args.batches + 1)]
    n_sparse = L - tm.dense_d
    policies = {  # name: (policy, kernel counter it must reach)
        "static": (DecodePolicy.static(tm), "vntk_topk"),
        "static_fused": (DecodePolicy.static(tm, fused=True),
                         "vntk_topk_fused"),
        "static_notopk": (DecodePolicy.static(tm, topk=False), "vntk_mask"),
        "static_fused_notopk": (DecodePolicy.static(tm, fused=True, topk=False),
                                "vntk_mask_fused"),
    }
    first, median_ms = {}, {}
    kv.reset_launches()  # the main path's run starts here
    for name, (policy, counter) in policies.items():
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        before = dict(kv.LAUNCHES)
        lat = []
        for i, hist in enumerate(hists):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beams, scores = r.retrieve(hist)  # host arrays: synchronized
            if i:
                lat.append(time.perf_counter() - t0)
            else:
                first[name] = (beams, scores)
            if beams.shape != (B, M, L) or not np.all(np.isfinite(scores)):
                raise AssertionError(f"{name}: bad output shape/scores")
            if np.any(np.diff(scores, axis=1) > 0):
                raise AssertionError(f"{name}: beams not score-sorted")
            members, live = compliance(sorted_sids, beams, scores)
            if members != live or live == 0:
                raise AssertionError(f"{name}: {members}/{live} live beams in "
                                     "the constraint set")
        rose = {k: kv.LAUNCHES[k] - before[k] for k in kv.LAUNCHES}
        want = {k: (n_sparse * len(hists) if k == counter else 0) for k in rose}
        if rose != want:
            raise AssertionError(f"{name}: launches {rose}, expected {want}")
        median_ms[name] = float(np.median(lat)) * 1e3
        log(f"  {name} [{policy.describe()}]: median retrieve "
            f"{median_ms[name]:.2f} ms over {len(lat)} batches of "
            f"B={B} (M={M}, L={L}); 100% compliance; {counter} launched "
            f"{n_sparse} times per retrieve")
    launches = dict(kv.LAUNCHES)  # the main path's run ends here
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")

    # per-step split of one retrieve: prefill alone vs the whole retrieve
    r = GenerativeRetriever(params, cfg, policies["static"][0], L, V,
                            beam_size=M)
    hist_t = torch.as_tensor(hists[1], device="cuda")
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            transformer.prefill(params, hist_t, cfg,
                                max_len=static_gr.HISTORY_LEN + L + 1)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    pre_ms = float(np.median(pre)) * 1e3
    log(f"  prefill (B={B}, S={static_gr.HISTORY_LEN}) median {pre_ms:.2f} "
        f"ms; per decode step (static: retrieve minus prefill over {L - 1} "
        f"steps) {(median_ms['static'] - pre_ms) / (L - 1):.2f} ms")

    # the same batch with the plain constraint step on the same card/model
    for name in ("static", "static_notopk"):
        policy = policies[name][0]
        plain = DecodePolicy.static(tm, impl="plain", topk=policy.candidate_topk)
        beams, scores = GenerativeRetriever(
            params, cfg, plain, L, V, beam_size=M).retrieve(hists[0])
        if not (np.array_equal(beams, first[name][0])
                and np.array_equal(scores, first[name][1])):
            raise AssertionError(f"{name}: plain constraint step disagrees")
        log(f"  {name}: plain constraint step gives equal SIDs and scores")

    if args.profile:
        profile_retrieve(r, hists[1], median_ms["static"])
    return launches


def profile_retrieve(r, hist, retrieve_ms):
    """Device time by kernel over one retrieve (torch.profiler); the idle
    share is taken against the unprofiled median ``retrieve_ms``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.retrieve(hist)
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in rows) / 1e6
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return
    vntk = sum(dev_us(e) for e in rows if "vntk" in e.key) / 1e6
    log(f"  profile: device busy {busy * 1e3:.2f} ms per retrieve; idle share "
        f"{1 - busy * 1e3 / retrieve_ms:.3f} of the unprofiled "
        f"{retrieve_ms:.2f} ms; VNTK kernels {vntk * 1e6:.1f} us "
        f"({vntk / busy:.2e} of device time)")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:15]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:150]}")


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import static_gr
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie, sorted_unique_sids
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.time()
    libs = build.build_all()
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f}s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {line.strip()}")

    rng = np.random.default_rng(args.seed)
    n = args.constraints or static_gr.N_CONSTRAINTS
    V, L = static_gr.SID_VOCAB, static_gr.SID_LENGTH
    t0 = time.time()
    sids = rng.integers(0, V, size=(n, L))
    ft = build_flat_trie(sids, V, dense_d=static_gr.DENSE_D)
    tm = TransitionMatrix.from_flat_trie(ft, device="cuda")
    sorted_sids = np.asfortranarray(sorted_unique_sids(sids))
    log(f"  trie of {n} random SIDs: {ft.n_states} states, {ft.n_edges} "
        f"edges, {tm.nbytes() / 1e9:.3f} GB on the card, level bmax "
        f"{list(map(int, ft.level_bmax))} ({time.time() - t0:.1f}s host build)")

    log("phase 2: kernels vs plain versions")
    checks = [KernelCheck(name) for name in KERNELS]
    phase_kernels(rng, ft, tm, sids, static_gr.BEAM_SIZE, checks)
    phase_golden()

    log("phase 3: main path")
    launches = phase_main(args, rng, tm, sorted_sids)

    log(f"phase 4: report ({time.time() - t_start:.1f}s total)")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    rows = []
    for chk in checks:
        ms, plain_ms, bound = np.mean(chk.times, axis=0)
        rows.append(dict(
            name=chk.name, route="cuda", source=SOURCE, replaces=chk.replaces,
            launches=launches[chk.name], max_abs_err=chk.max_abs_err,
            ms=float(ms), plain_ms=float(plain_ms), bound_ms=float(bound),
            bound_by="bytes", library_ms=None))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
