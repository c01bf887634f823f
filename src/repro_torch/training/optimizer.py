"""Optimizers in plain PyTorch: AdamW, Adafactor, SGD-momentum
(``repro.training.optimizer``).

Each optimizer is a pair of functions over the parameter tree::

  init(params)                        -> state tree
  update(grads, state, params, step)  -> (params, state)

with the reference's math and order, not ``torch.optim``'s: gradients are
cast to float32, clipped by their global norm before the moments, the
moments are float32 whatever the parameter dtype, the bias correction uses
``t = step + 1`` as a float32 tensor, the decay is decoupled and applied to
the float32 parameter, and the result is cast back to the parameter's dtype.

``update`` runs under ``torch.no_grad()`` one leaf at a time and writes the
new values into the state's and the parameters' tensors, which it returns.
In place because two copies of static-gr-3b's float32 moments (2 x 28.9 GB)
do not fit one 80 GB card beside its weights and gradients; callers that
need the old values keep a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.training.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adafactor", "sgd_momentum", "global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    name: str = "opt"


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _f32(g: torch.Tensor) -> torch.Tensor:
    return g if g.dtype == torch.float32 else g.float()


def _clip_scale(grads, grad_clip):
    """``min(1, clip / (|g| + 1e-9))`` as a float32 tensor, or None."""
    if grad_clip is None:
        return None
    return torch.clamp(grad_clip / (global_norm(grads) + 1e-9), max=1.0)


def _step_t(step) -> torch.Tensor:
    """The reference's ``step.astype(float32) + 1``: a float32 tensor."""
    return torch.as_tensor(step, dtype=torch.float32) + 1.0


def adamw(
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: float | None = 1.0,
) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, grad_clip)
        t = _step_t(step)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(p, g, m, v):
            g = _f32(g)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p32 = p.float()
            step_ = lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                          + weight_decay * p32)
            p.copy_(p32 - step_)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update, "adamw")


def adafactor(lr: float = 1e-3, eps: float = 1e-30, decay: float = 0.8,
              grad_clip: float | None = 1.0) -> Optimizer:
    """Factored second-moment optimizer (memory-light: O(n+m) per matrix)."""

    def init(params):
        def per_leaf(p):
            if p.dim() >= 2:
                f32 = dict(dtype=torch.float32, device=p.device)
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": _zeros_f32(p)}

        return tree_map(per_leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        scale = _clip_scale(grads, grad_clip)
        t = _step_t(step)
        beta = 1.0 - torch.pow(t, -decay)

        def upd(p, g, s):
            g = _f32(g)
            if scale is not None:
                g = g * scale
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = (vr / vr.mean(dim=-1, keepdim=True))[..., None]
                u = g * torch.rsqrt(rfac * vc[..., None, :] + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            p.copy_(p.float() - lr * u)

        _walk_states(upd, params, grads, state)
        return params, state

    return Optimizer(init, update, "adafactor")


def _walk_states(fn, params, grads, state) -> None:
    """``fn(p, g, s)`` where ``s`` is the per-leaf state dict (``{"v"}`` or
    ``{"vr", "vc"}``), which ``tree_map`` would descend into."""
    if isinstance(params, dict):
        for k in params:
            _walk_states(fn, params[k], grads[k], state[k])
    elif isinstance(params, (list, tuple)):
        for p, g, s in zip(params, grads, state):
            _walk_states(fn, p, g, s)
    else:
        fn(params, grads, state)


def sgd_momentum(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_zeros_f32, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        del step

        def upd(p, g, m):
            m.mul_(momentum).add_(_f32(g))
            p.copy_(p.float() - lr * m)

        tree_map(upd, params, grads, state)
        return params, state

    return Optimizer(init, update, "sgd")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's float32
    sum of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(_f32(leaf) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
