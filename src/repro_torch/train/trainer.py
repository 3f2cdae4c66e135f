"""Training loop of the port: step factory, microbatch gradient
accumulation, checkpoint/restart, straggler watchdog (the reference's
``train/trainer.py``).

:func:`make_train_step` builds the step ``(params, opt_state, batch) →
(params, opt_state, metrics)``.  It runs eagerly: ``torch.autograd`` takes
the place of ``jax.value_and_grad``, and a parameter the loss does not
reach gets a zero gradient, as JAX gives it.  Gradient accumulation loops
over the leading microbatch axis, sums fp32 gradients and divides, as the
reference's ``lax.scan`` does.  There is no ``jit`` and no mesh: the port
runs on one device (distribution is ROADMAP A12).

The step time is taken after ``torch.cuda.synchronize()`` when the loss
lives on the card (the counterpart of ``block_until_ready``).  Metrics go
into the port's registry under the reference's names: ``train.step_seconds``,
``train.steps``, ``train.tokens_per_s``, ``train.straggler_events``,
``train.checkpoint_seconds``, ``train.checkpoints`` and the
``train.checkpoint`` span.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import registry as _obs

from . import checkpoint as ckpt_lib
from .optim import Transform, apply_updates, global_norm
from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "Trainer", "StragglerWatchdog"]


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``; grads shaped as
    ``params``, zeros where the loss does not depend on a leaf."""
    live = [x.detach().requires_grad_(x.is_floating_point())
            for x in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, live), batch)
    wrt = [x for x in live if x.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in live:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics)
    optimizer: Transform,
    grad_accum: int = 1,
    compress_grads: bool = False,
):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    ``grad_accum > 1`` expects batch leaves shaped (grad_accum, ...) and
    accumulates fp32 gradients across the microbatches inside one step.
    ``compress_grads`` rounds the gradient through bf16 (what the
    reference casts the cross-replica gradient to)."""

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses, metricses = [], []
            for i in range(grad_accum):
                mb = tree_map(lambda x: x[i], batch)
                loss, metrics, grads = _value_and_grad(loss_fn, params, mb)
                acc = tree_map(lambda a, g: a + g.to(torch.float32), acc,
                               grads)
                losses.append(loss)
                metricses.append(metrics)
            grads = tree_map(lambda g: g / grad_accum, acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([torch.as_tensor(m[k])
                                       for m in metricses]).mean()
                       for k in metricses[0]}
        if compress_grads:
            grads = tree_map(
                lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        return params, opt_state, metrics

    return step


class StragglerWatchdog:
    """Tracks per-step walltime EWMA/variance; flags outliers.

    On a real cluster the flag feeds the scheduler (re-replicate the slow
    host's shard / trigger elastic re-mesh); here it records and reports."""

    def __init__(self, threshold_sigma: float = 3.0, warmup: int = 5):
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.threshold = threshold_sigma
        self.warmup = warmup
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            # prime the EWMA
            self.mean = dt if self.count == 1 else 0.7 * self.mean + 0.3 * dt
            return False
        sigma = max(self.var, 1e-12) ** 0.5
        # floor: never flag < 1.5× the mean (variance needs priming)
        is_straggler = dt > max(self.mean + self.threshold * sigma,
                                1.5 * self.mean)
        if is_straggler:
            self.flagged.append((step, dt))
            _obs.counter(
                "train.straggler_events", "steps flagged as stragglers"
            ).inc()
            _obs.gauge("train.straggler_last_dt_s", "").set(dt)
        a = 0.05
        delta = dt - self.mean
        self.mean += a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)
        return is_straggler


def _batch_tokens(batch) -> int:
    """Token count of one batch for the throughput gauge: the largest
    integer-typed leaf's element count (labels/ids), 0 if none."""
    best = 0
    for leaf in tree_leaves(batch):
        if isinstance(leaf, torch.Tensor) and not leaf.is_floating_point() \
                and not leaf.is_complex() and leaf.dtype != torch.bool:
            best = max(best, leaf.numel())
    return best


@dataclasses.dataclass
class Trainer:
    """Checkpoint-resumable training loop (restart-safe by construction:
    state = (params, opt_state, step) is fully captured per checkpoint).
    ``mesh`` must be None (distribution is ROADMAP A12); ``donate`` is
    accepted and changes nothing (a step's old state is dropped as soon as
    the new one is assigned)."""

    loss_fn: Callable
    optimizer: Transform
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    grad_accum: int = 1
    mesh: Any = None
    donate: bool = True

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the port trains on one device; "
                "distribution comes with ROADMAP A12")
        self._step_fn = make_train_step(self.loss_fn, self.optimizer,
                                        self.grad_accum)
        self._manager = (
            ckpt_lib.CheckpointManager(self.ckpt_dir, keep=self.keep)
            if self.ckpt_dir else None)
        self.watchdog = StragglerWatchdog()

    def init_state(self, params):
        return params, self.optimizer.init(params)

    def maybe_restore(self, params, opt_state):
        """Resume from the latest checkpoint if one exists."""
        if self._manager is None or ckpt_lib.latest_step(self.ckpt_dir) is None:
            return params, opt_state, 0
        (params, opt_state), step, _ = self._manager.restore(
            (params, opt_state))
        return params, opt_state, step

    def _save(self, step, state):
        t0 = time.perf_counter()
        with obs_trace.span("train.checkpoint", step=step):
            self._manager.save(step, state)
        _obs.histogram("train.checkpoint_seconds",
                       "blocking checkpoint-save duration").observe(
            time.perf_counter() - t0)
        _obs.counter("train.checkpoints", "checkpoint saves issued").inc()

    def run(self, params, opt_state, batches, start_step: int = 0,
            num_steps: int = 100, log_every: int = 10, log_fn=print):
        history = []
        step_hist = _obs.histogram("train.step_seconds",
                                   "per-step walltime (after synchronize)")
        step_ctr = _obs.counter("train.steps", "optimizer steps taken")
        for step in range(start_step, num_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       batch)
            if metrics["loss"].is_cuda:  # block_until_ready's counterpart
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0
            step_hist.observe(dt)
            step_ctr.inc()
            tokens = _batch_tokens(batch)
            if tokens:
                _obs.gauge("train.tokens_per_s",
                           "training throughput").set(tokens / max(dt, 1e-9))
            straggler = self.watchdog.observe(step, dt)
            if step % log_every == 0 or step == num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, "dt": dt, **m})
                log_fn(f"step {step:5d} loss={m['loss']:.4f} "
                       f"gnorm={m['grad_norm']:.3f} dt={dt*1e3:.1f}ms"
                       + (" [STRAGGLER]" if straggler else ""))
            if (self._manager is not None and step > start_step
                    and step % self.ckpt_every == 0):
                self._save(step, (params, opt_state))
        if self._manager is not None:
            self._save(num_steps, (params, opt_state))
            self._manager.wait()
        return params, opt_state, history
