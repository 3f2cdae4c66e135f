"""Optimizers of the port, from scratch: the reference's ``train/optim.py``
over trees of tensors (:mod:`.tree`), not ``torch.optim``, so that every
step computes what the reference computes, in the same order.

A ``Transform`` has ``init(params)`` and ``update(grads, state, params)``;
``chain`` composes.  Provided: AdamW (clipped at a global norm of 1.0 by
default), SGD with momentum, Adafactor (factored second moments), global
norm clipping, the three schedules and :func:`apply_updates`.  State
tensors are fp32 (the step counts int32) on the params' device.  Every
update returns new tensors: nothing is changed in place.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .tree import _children, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Transform", "chain", "scale", "scale_by_schedule", "clip_by_global_norm",
    "adam_moments", "add_decayed_weights", "adamw", "sgd", "adafactor",
    "cosine_schedule", "linear_warmup", "constant_schedule", "apply_updates",
    "global_norm",
]

_F32 = torch.float32


class Transform(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def chain(*ts: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in ts)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(ts, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in fp32, leaves in the reference's order;
    over DTensor leaves a replicated DTensor scalar."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.to(_F32).square().sum()
    if not isinstance(total, torch.Tensor):
        total = torch.as_tensor(total, dtype=_F32)
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return ()

    def update(grads, state, params):
        norm = global_norm(grads)
        factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: g * factor, grads), state

    return Transform(init, update)


def scale(factor: float) -> Transform:
    return Transform(
        lambda p: (),
        lambda g, s, p: (tree_map(lambda x: x * factor, g), s),
    )


def scale_by_schedule(schedule: Callable) -> Transform:
    def update(grads, count, params):
        lr = schedule(count)
        return tree_map(lambda g: g * -lr, grads), count + 1

    return Transform(_count, update)


def adam_moments(b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> Transform:
    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=_F32),
                            params)
        return {"mu": zeros(), "nu": zeros(), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(_F32).square(),
                      state["nu"], grads)
        cf = c.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=c.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=c.device), cf)
        upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                       mu, nu)
        return upd, {"mu": mu, "nu": nu, "count": c}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params):
        if weight_decay == 0.0 or params is None:
            return grads, state
        return tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                        grads, params), state

    return Transform(lambda p: (), update)


def adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          max_grad_norm: Optional[float] = 1.0) -> Transform:
    parts = []
    if max_grad_norm:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts += [adam_moments(b1, b2, eps), add_decayed_weights(weight_decay),
              scale_by_schedule(schedule)]
    return chain(*parts)


def sgd(schedule, momentum: float = 0.9) -> Transform:
    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=_F32), params)

    def update(grads, vel, params):
        vel = tree_map(lambda v, g: momentum * v + g.to(_F32), vel, grads)
        return vel, vel

    return chain(Transform(init, update), scale_by_schedule(schedule))


def adafactor(schedule, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8) -> Transform:
    """Factored second moment: O(rows + cols) optimizer memory for a
    matrix (every leaf of two or more dims; a vector keeps a full one)."""

    def init(params):
        def per(p):
            if p.ndim >= 2:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=_F32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=_F32, device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=_F32)}

        return {"m": tree_unflatten(params, [per(p) for p in
                                             tree_leaves(params)]),
                "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        beta = 1.0 - c.to(_F32) ** -decay

        def per(g, s):
            g32 = g.to(_F32)
            g2 = g32.square() + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                precond = (vr / denom)[..., None] * vc[..., None, :]
                upd = g32 / torch.sqrt(torch.clamp(precond, min=eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = g32 / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            rms = torch.sqrt(upd.square().mean() + 1e-12)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            return upd, new_s

        leaves_g = tree_leaves(grads)
        leaves_s = _state_leaves(state["m"], grads)
        flat_u, flat_s = [], []
        for g, s in zip(leaves_g, leaves_s):
            u, ns = per(g, s)
            flat_u.append(u)
            flat_s.append(ns)
        return (tree_unflatten(grads, flat_u),
                {"m": tree_unflatten(grads, flat_s), "count": c})

    return chain(Transform(init, update), scale_by_schedule(schedule))


def _state_leaves(m, grads) -> list:
    """Adafactor's per-leaf state dicts, in the order of ``grads``'s
    leaves (``m`` is the gradient tree with a dict at each leaf)."""
    out = []

    def walk(g, s):
        kids = _children(g)
        if kids is None:
            out.append(s)
            return
        for key, child in kids:
            walk(child, s[key])

    walk(grads, m)
    return out


# ---------------------------- schedules ---------------------------- #
def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    def fn(step):
        step = step.to(_F32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def linear_warmup(peak_lr: float, warmup_steps: int) -> Callable:
    return lambda step: peak_lr * torch.clamp(
        step.to(_F32) / max(warmup_steps, 1), max=1.0)


def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=_F32, device=step.device)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(_F32) + u).to(p.dtype), params,
                    updates)
