"""Fault-tolerant checkpointing (``repro.training.checkpoint``).

* Atomic: write to ``<dir>/.tmp-<step>-<pid>`` then ``os.replace`` — a
  crash mid-write never corrupts the latest checkpoint.
* Self-describing: trees are flattened to path-keyed arrays (keys join the
  path with ``||``) in ``step_%010d.npz`` beside a ``step_%010d.json``
  sidecar; restore checks every shape against a template tree.
* Lossless: numpy has no bfloat16 of its own, so a bfloat16 tensor is
  stored as the float32 array of its values (exact: every bfloat16 is a
  float32) and cast back to the template's dtype on restore.
* Async: :class:`AsyncCheckpointer` copies the tree to host memory
  synchronously (a blocking device-to-host copy, which waits for the
  stream that produced each tensor) and writes on a background thread.
* Elastic: checkpoints hold full logical arrays, so ``restore`` places them
  on any ``device``.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np
import torch

from repro_torch.training.tree import flatten_with_path, tree_map, unflatten_like

__all__ = ["save", "restore", "latest_step", "read_meta", "prune",
           "AsyncCheckpointer"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomically write checkpoint ``step``; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: _host(leaf) for key, leaf in flatten_with_path(tree)}
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    meta = {"step": step, "time": time.time(), **(extra or {})}
    mtmp = os.path.join(ckpt_dir, ".meta.tmp")
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step:010d}.json"))
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(m.group(1)) for fn in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", fn)))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def read_meta(ckpt_dir: str, step: int) -> dict:
    """The ``.json`` sidecar of checkpoint ``step`` (``{}`` if absent)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, template, device=None):
    """Restore ``step`` into the structure of ``template`` (a tree of
    tensors): each leaf takes its template leaf's dtype, and lands on
    ``device``, or on the template leaf's device when ``device`` is None."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    leaves = []
    with np.load(path) as z:
        for key, leaf in flatten_with_path(template):
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint/template shape mismatch at {key}: "
                    f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype))
    return unflatten_like(template, leaves)


def prune(ckpt_dir: str, keep: int) -> None:
    for s in _steps(ckpt_dir)[:-keep]:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step_{s:010d}{ext}"))
            except FileNotFoundError:
                pass


class AsyncCheckpointer:
    """Snapshot synchronously (device -> host), write on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()  # at most one outstanding write
        # a copy even of CPU tensors: the optimizer updates them in place
        host_tree = tree_map(
            lambda t: (t.detach().to("cpu", copy=True)
                       if isinstance(t, torch.Tensor) else np.array(t)),
            tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                prune(self.ckpt_dir, self.keep)
            except Exception as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
