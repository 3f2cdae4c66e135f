"""Training loop of the port: step factory, microbatch gradient
accumulation, checkpoint/restart, straggler watchdog (the reference's
``train/trainer.py``).

:func:`make_train_step` builds the step ``(params, opt_state, batch) →
(params, opt_state, metrics)``.  It runs eagerly: ``torch.autograd`` takes
the place of ``jax.value_and_grad``, and a parameter the loss does not
reach gets a zero gradient, as JAX gives it.  Gradient accumulation loops
over the leading microbatch axis, sums fp32 gradients and divides, as the
reference's ``lax.scan`` does.  There is no ``jit``.

On a ``DeviceMesh`` whose ``model`` axis is 1 the step is data-parallel:
each rank computes the gradient of its block of the global batch, the
ranks' gradients are averaged over ``("pod", "data")`` with ``all_reduce``
(uncompressed, as the reference's Trainer reduces them under GSPMD), and
every rank takes the same optimizer step, so the parameters stay equal.
A mean of the ranks' means is the global batch's mean only where every
rank's loss divides by the same count, so on a mesh the step needs the
loss's ``denominator`` (batch → the count its mean divides by): the ranks
all-reduce it and weigh their gradients, losses and metrics by
``w_r · S / Σ w`` before the mean, which is exactly 1 (no multiply) when
the counts agree (a weight other than 1 scales the loss before its
backward, so a loss that is already the global batch's, as a mixture of
experts' aux term, is not weighed twice).

On a mesh whose ``model`` axis is > 1 the step runs the model on
DTensors (tensor and expert parallelism): the parameters are placed by
``param_axes`` (the model's ``param_logical_axes``; every leaf replicated
without one), each microbatch is the data ranks' blocks as one DTensor
(split over the batch axes, whole over ``model``), the loss is the global
batch's, and each gradient comes back at its parameter's placement
(DTensor sums the summands over the batch axes).  The fp32 accumulation,
``global_norm`` and the optimizer run on the DTensor leaves; the loss and
metrics come back as plain tensors, equal on every rank.

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
from torch.distributed.tensor import DTensor

from repro_torch.dist.collectives import mean_over
from repro_torch.dist.sharding import (logical_to_spec, mesh_axis_sizes,
                                       place_tree, placements_for,
                                       use_mesh_rules)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import registry as _obs

from . import checkpoint as ckpt_lib
from .optim import Transform, apply_updates, global_norm
from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "Trainer", "StragglerWatchdog",
           "batch_on_mesh", "is_tensor_parallel"]


def _value_and_grad(loss_fn: Callable, params, batch, weight: float = 1.0):
    """(loss, metrics, grads) of ``weight · loss_fn(params, batch)`` (the
    metrics weighed alike); grads shaped as ``params``, zeros where the loss
    does not depend on a leaf.  A DTensor leaf's gradient comes back at the
    leaf's placements."""
    live = [x.detach().requires_grad_(x.is_floating_point())
            for x in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, live), batch)
    if weight != 1.0:
        loss = loss * weight
        metrics = {k: v * weight for k, v in metrics.items()}
    wrt = [x for x in live if x.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in live:
        g = next(got) if x.requires_grad else None
        if g is None:
            g = torch.zeros_like(x)
        elif isinstance(g, DTensor) and g.placements != x.placements:
            g = g.redistribute(x.device_mesh, x.placements)
        grads.append(g)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def _plain(x):
    """A replicated DTensor as the plain tensor every rank holds."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def is_tensor_parallel(mesh) -> bool:
    """Whether ``mesh`` has a ``model`` axis of more than one rank (the
    step then runs the model on DTensors)."""
    return mesh is not None and mesh_axis_sizes(mesh).get("model", 1) > 1


def batch_on_mesh(batch, mesh):
    """This rank's block of a batch (each leaf's leading dimension; the
    blocks of the data ranks in rank order, equal over ``model``) as
    DTensors of the global batch: split over the batch axes by the
    ``batch`` rule, whole over ``model``."""
    sizes = mesh_axis_sizes(mesh)

    def wrap(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        spec = ("batch",) + (None,) * (x.ndim - 1)
        n = 1
        for a in ("pod", "data"):
            n *= sizes.get(a, 1)
        shape = (x.shape[0] * n,) + tuple(x.shape[1:])
        got = logical_to_spec(spec, shape, mesh)[0]
        axes = () if got is None else (got,) if isinstance(got, str) \
            else got
        if n > 1 and sorted(axes) != sorted(a for a in ("pod", "data")
                                            if sizes.get(a, 1) > 1):
            raise ValueError(f"a batch block of {x.shape[0]} rows does not "
                             f"split over the batch axes of {sizes} by the "
                             f"'batch' rule")
        return DTensor.from_local(x, mesh, placements_for(spec, shape, mesh),
                                  run_check=False)

    return tree_map(wrap, batch)


def data_parallel_axes(mesh) -> tuple:
    """The mesh axes a data-parallel step reduces over (those of ``("pod",
    "data")`` the mesh has); refuses a mesh with another axis of more than
    one rank."""
    sizes = mesh_axis_sizes(mesh)
    other = sorted(a for a, n in sizes.items()
                   if a not in ("pod", "data", "model") and n > 1)
    if other:
        raise NotImplementedError(f"mesh axes {other}: the data-parallel "
                                  "step reduces over 'pod' and 'data' only")
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not axes or not hasattr(mesh, "get_group"):
        raise TypeError(f"want a DeviceMesh with a 'data' or 'pod' axis, "
                        f"got {type(mesh).__name__} {sizes}")
    return axes


def _rank_weights(denominator: Callable, mbs: list, device, mesh,
                  axes: tuple) -> list:
    """Each microbatch's ``w_r · S / Σ_r w_r`` (its share of the global
    microbatch's denominator, times the ranks' count ``S``): the weight
    that turns the mean over ranks into the global batch's mean.  Exactly
    1.0 when every rank divides by the same count; 0 for an empty global
    microbatch (every rank's loss is then 0)."""
    w = torch.stack([torch.as_tensor(denominator(mb), dtype=torch.float64,
                                     device=device) for mb in mbs])
    total = w.clone()
    n = 1
    for a in axes:
        group = mesh.get_group(a)
        n *= torch.distributed.get_world_size(group)
        torch.distributed.all_reduce(total, group=group)
    share = torch.where(total > 0, w * n / total.clamp_min(1e-300),
                        torch.zeros_like(w))
    return share.tolist()


def make_train_step(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics)
    optimizer: Transform,
    grad_accum: int = 1,
    compress_grads: bool = False,
    mesh: Any = None,
    denominator: Optional[Callable] = None,
):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    ``grad_accum > 1`` expects batch leaves shaped (grad_accum, ...) and
    accumulates fp32 gradients across the microbatches inside one step.
    ``compress_grads`` rounds the gradient through bf16 (what the
    reference casts the cross-replica gradient to).  With ``mesh`` (a
    ``DeviceMesh``) ``batch`` is this rank's block; on a ``model`` axis of 1
    ``denominator(microbatch)`` is the count ``loss_fn``'s mean divides by;
    gradients, loss and metrics are the global batch's on every rank.  On
    a ``model`` axis > 1 the parameters and optimizer state are DTensors
    (:meth:`Trainer.init_state` places them) and no denominator is
    needed."""
    axes = ()
    tp = is_tensor_parallel(mesh)
    if mesh is not None:
        axes = data_parallel_axes(mesh)
        if denominator is None and not tp:
            raise ValueError(
                "a data-parallel step needs denominator=: the count "
                "loss_fn's mean divides by on a batch (its target tokens, "
                "its mask's sum), which the ranks all-reduce to weigh their "
                "means into the global batch's; a loss without one cannot "
                "train on a mesh")

    def step(params, opt_state, batch):
        mbs = [batch] if grad_accum == 1 else \
            [tree_map(lambda x: x[i], batch) for i in range(grad_accum)]
        if mesh is None or tp:
            weights = [1.0] * grad_accum
        else:
            weights = _rank_weights(denominator, mbs, tree_leaves(params)[0]
                                    .device, mesh, axes)
        if tp:
            mbs = [batch_on_mesh(mb, mesh) for mb in mbs]

        def value_and_grad(i):
            loss, metrics, grads = _value_and_grad(loss_fn, params, mbs[i],
                                                   weights[i])
            return _plain(loss), {k: _plain(v) for k, v in
                                  metrics.items()}, grads

        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(0)
        else:
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
            losses, metricses = [], []
            for i in range(grad_accum):
                loss, metrics, grads = value_and_grad(i)
                acc = tree_map(lambda a, g: a + g.to(torch.float32), acc,
                               grads)
                losses.append(loss)
                metricses.append(metrics)
            grads = tree_map(lambda g: g / grad_accum, acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([torch.as_tensor(m[k])
                                       for m in metricses]).mean()
                       for k in metricses[0]}
        if mesh is not None and not tp:
            # one all_reduce for the scalars, one a gradient leaf
            names = sorted(metrics)
            scalars = torch.stack([loss] + [
                torch.as_tensor(metrics[k], dtype=loss.dtype,
                                device=loss.device) for k in names])
            mean_over([scalars] + tree_leaves(grads), mesh, axes)
            loss = scalars[0]
            metrics = {k: scalars[j + 1] for j, k in enumerate(names)}
        if compress_grads:
            grads = tree_map(
                lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = _plain(global_norm(grads))
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

    ``mesh``: None (one device) or a ``DeviceMesh``.  On a ``model`` axis
    of 1 the step is data-parallel (see :func:`make_train_step`) and
    ``denominator`` is required; on a ``model`` axis > 1 the parameters are
    placed by ``param_axes`` (a tree of logical axes, such as the
    transformer's ``param_logical_axes(cfg)``; None replicates them).  The
    loop runs under ``use_mesh_rules``, every rank calls :meth:`run` with
    its own batches, and rank 0 writes the checkpoints (DTensor leaves
    gathered first).  ``donate`` is accepted and changes nothing (a step's
    old state is dropped as soon as the new one is assigned)."""

    loss_fn: Callable
    optimizer: Transform
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    grad_accum: int = 1
    mesh: Any = None
    donate: bool = True
    denominator: Optional[Callable] = None  # batch -> loss_fn's divisor
    param_axes: Any = None  # logical axes of the params (model axis > 1)

    def __post_init__(self):
        self._step_fn = make_train_step(self.loss_fn, self.optimizer,
                                        self.grad_accum, mesh=self.mesh,
                                        denominator=self.denominator)
        self._manager = (
            ckpt_lib.CheckpointManager(self.ckpt_dir, keep=self.keep)
            if self.ckpt_dir else None)
        self.watchdog = StragglerWatchdog()

    def init_state(self, params):
        """(params, optimizer state); on a mesh the parameters are first
        broadcast from the mesh's first rank, so every rank starts from the
        same values (on a ``model`` axis > 1: placed by ``param_axes`` as
        DTensors, the first rank's values scattered)."""
        if is_tensor_parallel(self.mesh):
            params = place_tree(params, self.param_axes, self.mesh)
        elif self.mesh is not None:
            for a in data_parallel_axes(self.mesh):
                group = self.mesh.get_group(a)
                src = torch.distributed.get_global_rank(group, 0)
                for x in tree_leaves(params):
                    torch.distributed.broadcast(x, src, group=group)
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
        with use_mesh_rules(self.mesh):
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
                    _obs.gauge("train.tokens_per_s", "training throughput"
                               ).set(tokens / max(dt, 1e-9))
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
