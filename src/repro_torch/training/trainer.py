"""Fault-tolerant training loop (``repro.training.trainer``).

  * microbatch gradient accumulation: the batch is split into contiguous
    microbatches along axis 0, and their gradients are accumulated as
    ``g.float() / n_mb`` in microbatch order (the reference's scan);
  * optional int8 error-feedback gradient compression;
  * atomic + async checkpointing with exact resume (step, optimizer state,
    and the data cursor in the checkpoint's sidecar);
  * a straggler watchdog: steps slower than ``straggler_factor`` x the
    running median of the last 50 are recorded in ``straggler_events``.

The step runs eagerly: one forward and one ``torch.autograd.grad`` per
microbatch, then the optimizer's in-place update.  The loss function takes
``(params, batch)`` with the batch's arrays as tensors on the parameters'
device and returns a scalar tensor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.grad_compression import (apply_error_feedback,
                                                   init_error_state)
from repro_torch.training.optimizer import Optimizer
from repro_torch.training.tree import tree_leaves, unflatten_like

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    microbatches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = True
    grad_compression: bool = False
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    """Trains ``params`` (a tree of tensors, which the optimizer updates in
    place: pass a copy to keep the initial values) on the device they lie
    on."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer, params,
                 cfg: TrainerConfig):
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt_state = optimizer.init(params)
        self.err_state = init_error_state(params) if cfg.grad_compression else None
        self.step = 0
        self.step_times: list[float] = []
        self.straggler_events: list[int] = []
        self.data_state: dict = {}  # the data cursor of the last resume
        self._ckpt = (
            ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_keep)
            if cfg.ckpt_dir and cfg.ckpt_async
            else None
        )

    # ------------------------------------------------------------------
    def _to_device(self, batch) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _value_and_grad(self, batch):
        leaves = tree_leaves(self.params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = self.loss_fn(self.params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def _step(self, batch):
        n_mb = self.cfg.microbatches
        if n_mb == 1:
            loss, grads = self._value_and_grad(batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=self.device)
                     for p in tree_leaves(self.params)]
            for i in range(n_mb):  # contiguous microbatches, in order
                mb = {k: v.reshape((n_mb, v.shape[0] // n_mb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = self._value_and_grad(mb)
                loss = loss + l / n_mb
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float() / n_mb)
                del g
        grads = unflatten_like(self.params, grads)
        if self.err_state is not None:
            grads, self.err_state = apply_error_feedback(grads, self.err_state)
        self.params, self.opt_state = self.opt.update(
            grads, self.opt_state, self.params, self.step)
        return loss

    # ------------------------------------------------------------------
    def train_one(self, batch) -> float:
        t0 = time.time()
        loss = float(self._step(self._to_device(batch)))
        dt = time.time() - t0
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(self.step)
        self.step_times.append(dt)
        self.step += 1
        return loss

    def _tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "err": self.err_state if self.err_state is not None else {}}

    def maybe_checkpoint(self, data_state: dict | None = None, force=False):
        c = self.cfg
        if not c.ckpt_dir:
            return
        if not force and (self.step % c.ckpt_every != 0 or self.step == 0):
            return
        extra = {"data_state": data_state or {}}
        if self._ckpt is not None:
            self._ckpt.save(self.step, self._tree(), extra)
        else:
            ckpt_lib.save(c.ckpt_dir, self.step, self._tree(), extra)
            ckpt_lib.prune(c.ckpt_dir, c.ckpt_keep)

    def resume(self, device=None) -> bool:
        """Restore the latest checkpoint onto ``device`` (default: where the
        parameters are); its data cursor lands in ``self.data_state``."""
        c = self.cfg
        if not c.ckpt_dir:
            return False
        step = ckpt_lib.latest_step(c.ckpt_dir)
        if step is None:
            return False
        tree = ckpt_lib.restore(c.ckpt_dir, step, self._tree(), device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        if self.err_state is not None:
            self.err_state = tree["err"]
        self.device = tree_leaves(self.params)[0].device
        self.step = step
        self.data_state = ckpt_lib.read_meta(c.ckpt_dir, step).get(
            "data_state", {})
        return True

    def fit(self, batches: Iterator, log=print) -> list[float]:
        losses = []
        it = iter(batches)
        while self.step < self.cfg.n_steps:
            try:
                batch = next(it)  # only consume once we will actually train
            except StopIteration:
                break
            loss = self.train_one(batch)
            losses.append(loss)
            if self.step % self.cfg.log_every == 0:
                log(f"step {self.step}: loss {loss:.4f} "
                    f"({np.mean(self.step_times[-self.cfg.log_every:]):.3f}s/step)")
            self.maybe_checkpoint()
        self.wait_checkpoint()
        return losses

    def wait_checkpoint(self) -> None:
        """Block until the outstanding async checkpoint write is on disk
        (re-raising its error); a no-op for synchronous checkpoints."""
        if self._ckpt is not None:
            self._ckpt.wait()
