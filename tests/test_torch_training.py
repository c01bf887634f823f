"""Port training path against the JAX reference: optimizers, gradient
compression, checkpoints, the Trainer and the training launcher (the
losses and their gradients are in ``tests/test_torch_losses.py``).

Inputs come from seeded numpy and weights are carried over from the
reference (``convert.*_from_jax``).  Tolerances: float32 values and
gradients within rtol 1e-5 (atol 1e-6 for gradients near zero) unless a
test states otherwise; int8 compression codes equal.  The two frameworks
sum matrix products and reductions in different orders, so float32
results agree to a few ulps, not bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.loader import ShardedBatcher as JaxBatcher
from repro.models import transformer as jax_transformer
from repro.training import grad_compression as jax_gc
from repro.training import optimizer as jax_opt
from repro.training.trainer import Trainer as JaxTrainer
from repro.training.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer
from repro_torch.data import ShardedBatcher
from repro_torch.launch import train as train_launcher
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import grad_compression as gc
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import Trainer, TrainerConfig
from repro_torch.training.tree import flatten_with_path, tree_map

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tn(t):
    return t.detach().float().numpy()


def _mixed_tree(rng):
    """A tree of float32 and bfloat16 leaves, 1-D and 2-D."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "h": {"w16": rng.normal(size=(4, 3)).astype(np.float32)}}


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["h"]["w16"] = out["h"]["w16"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    out["h"]["w16"] = out["h"]["w16"].to(torch.bfloat16)
    return out


def _assert_tree_close(jax_tree, torch_tree, rtol=RTOL, atol=ATOL):
    want = dict(flatten_with_path(jax.tree.map(_np, jax_tree)))
    got = dict(flatten_with_path(torch_tree))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(_tn(got[k]), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# optimizers and compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5)),
    ("adafactor", dict(lr=1e-2, grad_clip=0.5)),
    ("sgd_momentum", dict(lr=1e-2, momentum=0.9)),
])
def test_optimizer_updates_match_reference(name, kw):
    """Three updates on float32 and bfloat16 leaves: parameters and state
    (the float32 moments) within rtol 1e-5; the bfloat16 leaves within one
    bfloat16 ulp (rtol 2^-7), since a float32 difference at a rounding
    boundary moves the cast by one."""
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    jo, to = getattr(jax_opt, name)(**kw), getattr(opt, name)(**kw)
    jp, tp = _as_jax(tree), _as_torch(tree)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _mixed_tree(rng)
        jp, js = jo.update(_as_jax(g), js, jp, jnp.asarray(step))
        tp, ts = to.update(_as_torch(g), ts, tp, step)
    _assert_tree_close({"w": jp["w"], "b": jp["b"]},
                       {"w": tp["w"], "b": tp["b"]})
    np.testing.assert_allclose(_tn(tp["h"]["w16"]), _np(jp["h"]["w16"]),
                               rtol=2 ** -7, atol=ATOL)
    assert tp["h"]["w16"].dtype == torch.bfloat16
    _assert_tree_close(js, ts)
    for leaf in jax.tree.leaves(ts):
        assert leaf.dtype == torch.float32  # float32 state for bf16 params


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _mixed_tree(rng)
    want = float(jax_opt.global_norm(_as_jax(tree)))
    got = float(opt.global_norm(_as_torch(tree)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_adamw_clips_before_the_moments_and_keeps_its_state_float32():
    p = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    o = opt.adamw(lr=1.0, weight_decay=0.0, grad_clip=1.0)
    s = o.init(p)
    o.update({"w": torch.tensor([300.0, 400.0, 0.0])}, s, p, 0)
    # clipped to norm 1 before the moments: m = (1 - b1) * (0.6, 0.8, 0)
    np.testing.assert_allclose(s["m"]["w"].numpy(), [0.06, 0.08, 0.0],
                               rtol=1e-6)
    assert s["m"]["w"].dtype == s["v"]["w"].dtype == torch.float32


def test_grad_compression_codes_equal_reference():
    rng = np.random.default_rng(2)
    for scale in (1.0, 1e-3, 1e4):
        g = (rng.normal(size=(257,)) * scale).astype(np.float32)
        jq, js = jax_gc.compress(jnp.asarray(g))
        tq, ts = gc.compress(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(gc.decompress(tq, ts).numpy(),
                                      np.asarray(jax_gc.decompress(jq, js)))


def test_error_feedback_matches_reference_over_rounds():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(31,)).astype(np.float32),
            "b": [rng.normal(size=(4, 4)).astype(np.float32)]}
    jg = jax.tree.map(jnp.asarray, tree)
    tg = tree_map(torch.from_numpy, tree)
    je, te = jax_gc.init_error_state(jg), gc.init_error_state(tg)
    for _ in range(5):
        jd, je = jax_gc.apply_error_feedback(jg, je)
        td, te = gc.apply_error_feedback(tg, te)
    _assert_tree_close(jd, td, rtol=0, atol=1e-6)
    _assert_tree_close(je, te, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "emb": torch.randn(5, 2, generator=g).to(torch.bfloat16),
                       "layers": [{"s": torch.randn(3, generator=g)}]},
            "opt": {"m": {"w": torch.zeros(4, 3)}},
            "err": {}}


def test_checkpoint_round_trip_is_exact_bf16_included(tmp_path):
    tree = _ckpt_tree()
    path = ckpt.save(str(tmp_path), 7, tree, {"data_state": {"cursor": 3}})
    assert os.path.basename(path) == "step_0000000007.npz"
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.read_meta(str(tmp_path), 7)["data_state"] == {"cursor": 3}
    with np.load(path) as z:  # path-keyed arrays, bf16 stored as float32
        assert "params||layers||0||s" in z.files
        assert z["params||emb"].dtype == np.float32
    out = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
    for (k, a), (_, b) in zip(flatten_with_path(tree), flatten_with_path(out)):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


def test_checkpoint_no_partial_files_and_prune(tmp_path):
    tree = _ckpt_tree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".")]
    ckpt.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == [
        "step_0000000003.json", "step_0000000003.npz",
        "step_0000000004.json", "step_0000000004.npz"]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    tree = _ckpt_tree()
    ckpt.save(str(tmp_path), 1, tree)
    bad = dict(tree, params=dict(tree["params"], w=torch.zeros(4, 4)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad)


def test_async_checkpointer_snapshots_before_later_updates(tmp_path):
    tree = _ckpt_tree()
    want = tree["params"]["w"].clone()
    c = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    c.save(5, tree)
    tree["params"]["w"].add_(1.0)  # an in-place update after the snapshot
    c.wait()
    out = ckpt.restore(str(tmp_path), 5, tree)
    assert torch.equal(out["params"]["w"], want)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _lin_problem(seed=0, n=512):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = x @ rng.normal(size=(8, 1)).astype(np.float32)
    return {"x": x, "y": y}


def _lin_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _lin_params():
    return {"w": torch.zeros(8, 1)}


def test_trainer_matches_jax_trainer_from_carried_over_weights():
    """K = 3 steps of static-gr's smoke config (lm_loss, AdamW lr 1e-3) on
    the same ShardedBatcher batches: per-step losses within rtol 1e-5; in
    every parameter leaf, 99.9% of the elements within atol 1e-5, the
    median difference at most 1e-6, and every element within 2 * K * lr
    (so a whole leaf updated wrongly fails, however small it is).  AdamW
    divides each gradient by its own root mean square, so an element whose
    gradient sits at float32 rounding level (where the two frameworks'
    summation orders disagree in sign) may move by up to lr per step the
    other way."""
    jcfg = jax_smoke_config("static-gr")
    cfg = smoke_config("static-gr")
    rng = np.random.default_rng(0)
    data = {"tokens": rng.integers(0, cfg.vocab_size, (64, 32)).astype(
        np.int32)}
    jp = jax_transformer.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jt = JaxTrainer(lambda p, b: jax_transformer.lm_loss(p, b["tokens"], jcfg),
                    jax_opt.adamw(lr=1e-3), jp, JaxTrainerConfig(n_steps=3))
    tt = Trainer(lambda p, b: transformer.lm_loss(p, b["tokens"], cfg),
                 opt.adamw(lr=1e-3), tp, TrainerConfig(n_steps=3))
    jl = jt.fit(JaxBatcher(data, 8, seed=1), log=lambda *a: None)
    tl = tt.fit(ShardedBatcher(data, 8, seed=1), log=lambda *a: None)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    want = jax.tree.map(np.asarray, jt.params)
    assert set(want) == {"emb", "final_norm", "dense_layers"}

    def top(tree):
        return dict(flatten_with_path(
            {k: tree[k] for k in ("emb", "final_norm")}))

    got = top(tt.params)
    pairs = {k: (w, got[k]) for k, w in top(want).items()}
    for i in range(cfg.n_layers):
        layer = dict(flatten_with_path(
            jax.tree.map(lambda a: a[i], want["dense_layers"])))
        got = dict(flatten_with_path(tt.params["layers"][i]))
        assert layer.keys() == got.keys()
        pairs.update({(i, k): (layer[k], got[k]) for k in layer})
    K, lr = 3, 1e-3
    for name, (w, t) in pairs.items():
        diff = np.abs(_tn(t) - w).ravel()
        assert (diff <= 1e-5).mean() >= 0.999, name
        assert np.median(diff) <= 1e-6, name
        assert diff.max() <= 2 * K * lr, name


def test_trainer_converges():
    t = Trainer(_lin_loss, opt.adamw(lr=5e-2), _lin_params(),
                TrainerConfig(n_steps=60, log_every=1000))
    losses = t.fit(ShardedBatcher(_lin_problem(), 64), log=lambda *a: None)
    assert losses[-1] < losses[0] * 0.2


def test_microbatch_equivalence_and_contiguous_split():
    data = _lin_problem()
    batch = {k: v[:64] for k, v in data.items()}
    outs = []
    for n_mb in (1, 4):
        t = Trainer(_lin_loss, opt.adamw(lr=1e-2), _lin_params(),
                    TrainerConfig(n_steps=1, microbatches=n_mb))
        t.train_one(batch)
        outs.append(t.params["w"].numpy().astype(np.float64))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-6)
    # the JAX trainer with the same microbatches: the same split and order
    jt = JaxTrainer(lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
                    jax_opt.adamw(lr=1e-2), {"w": jnp.zeros((8, 1))},
                    JaxTrainerConfig(n_steps=1, microbatches=4))
    jt.train_one({k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(outs[1], np.asarray(jt.params["w"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_exact_resume(tmp_path, ckpt_async):
    """Crash after step 6 + resume (step, state, data cursor) == an
    uninterrupted run, bit for bit."""
    data = _lin_problem()
    cfg = dict(ckpt_every=6, ckpt_async=ckpt_async, log_every=1000,
               grad_compression=True)
    t_ref = Trainer(_lin_loss, opt.adamw(lr=1e-2), _lin_params(),
                    TrainerConfig(n_steps=12, **cfg))
    t_ref.fit(ShardedBatcher(data, 64), log=lambda *a: None)

    d = str(tmp_path / "run")
    t1 = Trainer(_lin_loss, opt.adamw(lr=1e-2), _lin_params(),
                 TrainerConfig(n_steps=6, ckpt_dir=d, **cfg))
    b1 = ShardedBatcher(data, 64)
    t1.fit(b1, log=lambda *a: None)
    t1.maybe_checkpoint(data_state=b1.state(), force=True)
    if t1._ckpt is not None:
        t1._ckpt.wait()

    t2 = Trainer(_lin_loss, opt.adamw(lr=1e-2), _lin_params(),
                 TrainerConfig(n_steps=12, ckpt_dir=d, **cfg))
    assert t2.resume(device="cpu")
    assert t2.step == 6 and t2.data_state == b1.state()
    b2 = ShardedBatcher(data, 64)
    b2.restore(t2.data_state)
    t2.fit(b2, log=lambda *a: None)
    assert torch.equal(t_ref.params["w"], t2.params["w"])
    assert torch.equal(t_ref.err_state["w"], t2.err_state["w"])


def test_straggler_watchdog_records(monkeypatch):
    """Eight steps of 1 s on a fake clock (so a loaded host cannot make one
    a straggler), then one of 100 s: only that one is recorded."""
    import time

    data = _lin_problem()
    t = Trainer(_lin_loss, opt.adamw(lr=1e-2), _lin_params(),
                TrainerConfig(n_steps=10))
    batch = {k: v[:64] for k, v in data.items()}
    # train_one reads the clock twice a step: its start and its end
    clock = iter([v for i in range(8) for v in (2.0 * i, 2.0 * i + 1.0)]
                 + [16.0, 116.0])
    real = time.time
    monkeypatch.setattr(time, "time", lambda: next(clock, real()))
    for _ in range(8):
        t.train_one(batch)
    assert t.step_times == [1.0] * 8
    assert t.straggler_events == []
    t.train_one(batch)
    assert t.straggler_events == [8]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launch_train_static_gr_on_cpu(capsys):
    losses = train_launcher.main(
        ["--arch", "static-gr", "--steps", "1", "--batch", "2",
         "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert "done: 1 steps" in capsys.readouterr().out


def test_launch_train_recsys_checkpoints_and_resumes_on_cpu(tmp_path,
                                                            capsys):
    losses = train_launcher.main(
        ["--arch", "wide-deep", "--steps", "3", "--batch", "4",
         "--microbatches", "2", "--ckpt-dir", str(tmp_path),
         "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = train_launcher.main(
        ["--arch", "wide-deep", "--steps", "4", "--batch", "4",
         "--ckpt-dir", str(tmp_path), "--resume", "--device", "cpu"])
    assert len(out) == 1
    assert "resumed from step 3" in capsys.readouterr().out


def test_launch_train_refuses_unported_arch_and_a_missing_card():
    with pytest.raises(KeyError, match="unknown arch 'llama-7b'"):
        train_launcher.main(["--arch", "llama-7b", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_launcher.main(["--arch", "fm", "--steps", "1"])


def test_synth_batches_equal_reference():
    from repro.launch.train import synth_batches as jax_synth
    for arch in ("static-gr", "dlrm-mlperf"):
        j = jax_synth(arch, jax_smoke_config(arch), 4)
        t = train_launcher.synth_batches(arch, smoke_config(arch), 4)
        for _ in range(3):
            jb, tb = next(j), next(t)
            assert jb.keys() == tb.keys()
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
