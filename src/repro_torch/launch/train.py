"""Training launcher (``repro.launch.train``): trains the reduced (smoke)
variant of any architecture on synthetic data with the fault-tolerant
trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --steps 30 --ckpt-dir build/ckpt [--device cpu]

Every family of the registry: ``lm`` and ``gr`` (``lm_loss``, the router's
aux loss included), ``recsys`` and ``gnn`` (batched small graphs).  Runs on
the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_bundle, smoke_config
from repro_torch.data.loader import ShardedBatcher
from repro_torch.models import gnn, recsys, transformer
from repro_torch.training.optimizer import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["synth_batches", "build", "main"]


def synth_batches(arch, cfg, global_batch, seed=0):
    """The reference launcher's synthetic data, array for array."""
    rng = np.random.default_rng(seed)
    fam = get_bundle(arch).family
    n = global_batch * 8
    if fam in ("lm", "gr"):
        data = {"tokens": rng.integers(0, cfg.vocab_size, (n, 33)).astype(
            np.int32)}
    elif fam == "recsys":
        data = {
            "sparse": np.stack(
                [rng.integers(0, v, (n, cfg.multi_hot))
                 for v in cfg.vocab_sizes], axis=1).astype(np.int32),
            "dense": rng.normal(size=(n, max(cfg.n_dense, 1))).astype(
                np.float32),
            "hist": rng.integers(0, 40, (n, cfg.hist_len)).astype(np.int32),
            "target": rng.integers(0, 40, (n,)).astype(np.int32),
            "label": rng.integers(0, 2, (n,)).astype(np.float32),
        }
    else:  # gnn: batched small graphs
        N, E = 24, 48
        data = {
            "node_feats": rng.normal(size=(n, N, cfg.node_feat_dim)).astype(
                np.float32),
            "edge_feats": rng.normal(size=(n, E, cfg.edge_feat_dim)).astype(
                np.float32),
            "senders": rng.integers(0, N, (n, E)).astype(np.int32),
            "receivers": rng.integers(0, N, (n, E)).astype(np.int32),
            "targets": rng.normal(size=(n, N, cfg.out_dim)).astype(
                np.float32),
        }
    return ShardedBatcher(data, global_batch, seed=seed)


def build(arch: str, device=None):
    """``(cfg, params, loss_fn)`` of the smoke config of ``arch`` on
    ``device`` (the card unless named)."""
    fam = get_bundle(arch).family
    cfg = smoke_config(arch)
    dev = resolve_device(device)
    if fam in ("lm", "gr"):
        params = transformer.init_params(cfg, seed=0, device=dev)
        return cfg, params, lambda p, b: transformer.lm_loss(p, b["tokens"],
                                                             cfg)
    if fam == "recsys":
        params = recsys.init_params(cfg, seed=0, device=dev)
        return cfg, params, lambda p, b: recsys.recsys_loss(p, b, cfg)
    params = gnn.init_params(cfg, seed=0, device=dev)
    return cfg, params, lambda p, b: gnn.gnn_loss(p, b, cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg, params, loss = build(args.arch, args.device)
    trainer = Trainer(
        loss, adamw(lr=1e-3), params,
        TrainerConfig(
            n_steps=args.steps, microbatches=args.microbatches,
            ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 3, 1),
            grad_compression=args.grad_compression, log_every=5,
        ),
    )
    batches = synth_batches(args.arch, cfg, args.batch)
    if args.resume and trainer.resume():
        batches.restore(trainer.data_state or batches.state())
        print(f"resumed from step {trainer.step}")
    losses = trainer.fit(batches)
    print(f"done: {trainer.step} steps, final loss {losses[-1]:.4f}, "
          f"stragglers: {trainer.straggler_events}")
    return losses


if __name__ == "__main__":
    main()
