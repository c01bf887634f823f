"""Train a generative-retrieval model with the PyTorch port's fault-tolerant
trainer (``examples/train_retrieval.py`` in torch form).

Demonstrates the training substrate: sharded deterministic loader,
microbatch accumulation, int8 error-feedback gradient compression, atomic
async checkpointing, and exact resume after a simulated crash::

    PYTHONPATH=src python examples/train_retrieval_torch.py  # the card
    PYTHONPATH=src python examples/train_retrieval_torch.py --device cpu

``train_rqvae`` builds the Semantic IDs and ``gr_model_config`` sizes the
retrieval transformer, the builders the ``cold_start_amazon`` scenario
composes (``python -m repro_torch.launch.run_scenario --scenario
cold_start_amazon --smoke``).  No VNTK or bag kernel lies on this path: the
model trains through ``transformer.lm_loss``, plain PyTorch.

The optimizer updates parameters in place, so the resumed trainer starts
from the first trainer's updated tensors until ``resume()`` replaces them
with the checkpoint's.  Checkpoints go to ``--ckpt-dir`` (default
``repro_torch_train_retrieval_ckpt`` under the system's temporary
directory), which is emptied first.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RQVAEConfig
from repro_torch.data.loader import ShardedBatcher
from repro_torch.data.synthetic import make_item_corpus, make_user_sequences
from repro_torch.models import rqvae, transformer
from repro_torch.scenarios import gr_model_config, train_rqvae
from repro_torch.training.optimizer import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_retrieval_ckpt")


def corpus_tokens(rqvae_steps: int, device, log=print) -> np.ndarray:
    """The users' histories as SID token rows ``(3000, 40)`` int32, the
    Semantic IDs from an RQ-VAE trained ``rqvae_steps`` steps."""
    rng = np.random.default_rng(0)
    feats, cid = make_item_corpus(rng, 1_000, 32, 64)
    seqs = make_user_sequences(rng, 3_000, 10, cid)
    rq_cfg = RQVAEConfig(feat_dim=64, n_levels=4, codebook_size=256)
    rq = train_rqvae(feats, rq_cfg, steps=rqvae_steps, log=log, device=device)
    with torch.no_grad():
        sids = rqvae.encode_to_sids(
            rq, torch.as_tensor(feats, device=device), rq_cfg).cpu().numpy()
    return sids[seqs].reshape(seqs.shape[0], -1).astype(np.int32)


def loss_fn_for(cfg):
    def loss_fn(p, batch):
        return transformer.lm_loss(p, batch["tokens"], cfg)
    return loss_fn


def trainer_config(n_steps: int, ckpt_dir, ckpt_every: int) -> TrainerConfig:
    return TrainerConfig(
        n_steps=n_steps, microbatches=2, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, ckpt_async=True, grad_compression=True,
        log_every=20,
    )


def main(argv=None, *, rqvae_steps: int = 200, crash_step: int = 80,
         n_steps: int = 120, ckpt_every: int = 40) -> dict:
    """Train to ``crash_step``, 'crash', resume a fresh trainer from the
    checkpoint and train on to ``n_steps`` (the reference's 200, 80, 120
    and 40 by default)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--ckpt-dir", default=CKPT,
                    help="checkpoint directory, emptied first")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir
    tokens = corpus_tokens(rqvae_steps, dev)

    cfg = gr_model_config(256)
    params = transformer.init_params(cfg, seed=0, device=dev)
    loss_fn = loss_fn_for(cfg)

    shutil.rmtree(ckpt, ignore_errors=True)
    tcfg = trainer_config(n_steps, ckpt, ckpt_every)
    trainer = Trainer(loss_fn, adamw(lr=1e-3), params, tcfg)
    batches = ShardedBatcher({"tokens": tokens}, global_batch=64, seed=0)

    print(f"--- phase 1: train to step {crash_step}, then simulate a crash "
          f"---")
    trainer.cfg.n_steps = crash_step
    losses = trainer.fit(batches, log=print)
    trainer.maybe_checkpoint(data_state=batches.state(), force=True)
    trainer.wait_checkpoint()  # the crash comes after the write lands
    print(f"'crash' at step {trainer.step}; straggler events: "
          f"{trainer.straggler_events}")

    print("--- phase 2: fresh trainer, resume from checkpoint ---")
    t2 = Trainer(loss_fn, adamw(lr=1e-3), params, tcfg)
    if not t2.resume():
        raise RuntimeError(f"no checkpoint found in {ckpt}")
    resumed_at = t2.step
    print(f"resumed at step {resumed_at}")
    b2 = ShardedBatcher({"tokens": tokens}, global_batch=64, seed=0)
    b2.restore(t2.data_state)
    t2.cfg.n_steps = n_steps
    losses2 = t2.fit(b2, log=print)
    kept = sorted(os.listdir(ckpt))[-2:]
    print(f"final loss {losses2[-1]:.4f} after exact resume "
          f"(ckpts in {ckpt}: {kept})")
    return dict(resumed_step=resumed_at, final_step=t2.step,
                losses=losses + losses2, final_loss=losses2[-1],
                checkpoints=kept)


if __name__ == "__main__":
    main()
