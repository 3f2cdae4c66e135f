"""Hand-rolled collectives of the port (the reference's
``dist/collectives.py``): the two-stage distributed top-k, a ring
all-reduce of neighbour exchanges, and data-parallel gradients with bf16
compression and error feedback, on ``torch.distributed``.

Where the reference runs one SPMD program under ``shard_map`` with a
leading shard axis on the batch and the residuals, the port runs one
process a rank, and each rank holds its own slice: the port's rank ``r``
is the reference's ``[r]``.  Reductions over a mesh axis are
``all_reduce`` over that mesh dimension's process group.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

from .sharding import mesh_axis_sizes

__all__ = [
    "stable_topk",
    "distributed_topk",
    "ring_all_reduce",
    "mean_over",
    "init_error_feedback",
    "make_dp_grad_fn",
]


def stable_topk(x: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest, descending,
    ties to the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _final_stage(loc_v, loc_i, k: int) -> tuple:
    """Stage 2: the top ``k`` of the (B, S, kk) candidates, concatenated in
    block order (so ties keep index order)."""
    B = loc_v.shape[0]
    cand_v = loc_v.reshape(B, -1)
    cand_i = loc_i.reshape(B, -1)
    top_v, pos = stable_topk(cand_v, k)
    return top_v, torch.gather(cand_i, 1, pos)


def distributed_topk(scores, k: int, mesh, axis: str = "model") -> tuple:
    """Exact two-stage top-k over the vocab/item axis of ``scores`` (B, V).

    Stage 1 takes a local top-k inside each ``axis`` block (no collective);
    stage 2 reduces the S·k candidates — so the all-gather moves S·k values
    per row instead of V.  Equal to ``jax.lax.top_k`` bit for bit, ties
    included (lower index wins), because per-block candidates keep index
    order and blocks are concatenated in index order.

    A plain tensor is the whole matrix: the two stages run in one program
    over ``S = mesh[axis]`` blocks (the plain top-k when S ≤ 1 or S does
    not divide V).  A DTensor sharded on dim 1 over ``axis`` runs stage 1
    on its local block, all-gathers the candidates over that mesh
    dimension's group and returns DTensors placed as ``scores`` with
    ``axis`` replicated; another placement, or an uneven split, takes the
    full tensor and returns replicated DTensors."""
    if isinstance(scores, DTensor):
        return _distributed_topk_dtensor(scores, k, axis)
    B, V = scores.shape
    shards = mesh_axis_sizes(mesh).get(axis, 1)
    if shards <= 1 or V % shards:
        return stable_topk(scores, k)
    v_local = V // shards
    kk = min(k, v_local)
    loc_v, loc_i = stable_topk(scores.reshape(B, shards, v_local), kk)
    offs = (torch.arange(shards, device=scores.device) * v_local)[None, :,
                                                                   None]
    return _final_stage(loc_v, loc_i + offs, k)


def _distributed_topk_dtensor(scores, k: int, axis: str) -> tuple:
    mesh = scores.device_mesh
    names = list(mesh.mesh_dim_names)
    dim = names.index(axis) if axis in names else None
    shards = mesh.size(dim) if dim is not None else 1
    V = scores.shape[1]
    if dim is None or scores.placements[dim] != Shard(1) or shards <= 1 \
            or V % shards:
        top_v, top_i = stable_topk(scores.full_tensor(), k)
        rep = [Replicate()] * mesh.ndim
        return (DTensor.from_local(top_v, mesh, rep, run_check=False),
                DTensor.from_local(top_i, mesh, rep, run_check=False))
    local = scores.to_local()
    v_local = V // shards
    kk = min(k, v_local)
    loc_v, loc_i = stable_topk(local, kk)
    group = mesh.get_group(dim)
    loc_i = loc_i + dist.get_rank(group) * v_local
    got_v = [torch.empty_like(loc_v) for _ in range(shards)]
    got_i = [torch.empty_like(loc_i) for _ in range(shards)]
    dist.all_gather(got_v, loc_v.contiguous(), group=group)
    dist.all_gather(got_i, loc_i.contiguous(), group=group)
    top_v, top_i = _final_stage(torch.stack(got_v, 1), torch.stack(got_i, 1),
                                k)
    placements = list(scores.placements)
    placements[dim] = Replicate()
    return (DTensor.from_local(top_v, mesh, placements, run_check=False),
            DTensor.from_local(top_i, mesh, placements, run_check=False))


def ring_all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum all-reduce over mesh dimension ``axis`` as ``num_shards - 1``
    neighbour exchanges (the bandwidth-optimal ring schedule, unrolled):
    each step sends the last received block to the next rank and receives
    from the previous one.  Must equal ``all_reduce(SUM)``; each rank adds
    in its own order, as the reference's ``ppermute`` ring does."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    acc = x.clone()
    cur = x.contiguous()
    for _ in range(n - 1):
        got = torch.empty_like(cur)
        ops = [dist.P2POp(dist.isend, cur, nxt, group),
               dist.P2POp(dist.irecv, got, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        acc += got
        cur = got
    return acc


def mean_over(tensors: Sequence[torch.Tensor], mesh,
              axes: Sequence[str]) -> None:
    """``pmean`` in place: each tensor summed over the mesh dimensions
    ``axes`` (one ``all_reduce`` a tensor and an axis; a product of axes is
    reduced one axis after the other), then divided by their ranks' count
    (skipped at 1, where the sum is the tensor itself)."""
    n = 1
    for a in axes:
        group = mesh.get_group(a)
        n *= dist.get_world_size(group)
        for t in tensors:
            dist.all_reduce(t, group=group)
    if n > 1:
        for t in tensors:
            t.div_(n)


def init_error_feedback(params, num_shards: int):
    """This rank's fp32 residual tree for compressed gradients: zeros
    shaped as ``params`` (the reference stacks ``num_shards`` of them on a
    leading axis; here each rank holds its own).  The first step's residual
    is the bf16 error."""
    if num_shards < 1:
        raise ValueError(f"num_shards {num_shards} < 1")
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_dp_grad_fn(loss_fn: Callable, mesh, axis: str,
                    compress: bool = True):
    """Data-parallel gradient fn over mesh dimension ``axis`` with optional
    bf16 compression and error feedback.

    Returns ``fn(params, batch, residual) -> (grads, residual, loss)``:
    ``batch`` and ``residual`` are this rank's; grads and loss come back
    equal on every rank (the mean over ``axis``).  With ``compress``:
    ``corrected = g.float() + r``, ``wire = corrected.to(bfloat16)``, the
    new residual ``corrected - wire.float()`` and the gradient the mean of
    the ranks' ``wire.float()``, as the reference's ``pmean`` of the fp32
    upcast (the wire stays fp32 on the network here)."""
    from repro_torch.train.trainer import _value_and_grad

    mesh.get_group(axis)  # a mesh without ``axis`` fails here, not mid-step

    def fn(params, batch, residual):
        loss, _metrics, grads = _value_and_grad(loss_fn, params, batch)
        loss = loss.clone()
        mean_over([loss], mesh, (axis,))
        if not compress:
            mean_over(tree_leaves(grads), mesh, (axis,))
            return grads, residual, loss
        # error feedback: add the residual before quantizing, keep the
        # quantization error as the next residual (so it is re-sent, not
        # lost); leaf by leaf, so one leaf's temporaries live at a time
        wire, new_res = [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
            corrected = g.float() + r
            w = corrected.to(torch.bfloat16).float()
            new_res.append(corrected.sub_(w))
            wire.append(w)
        mean_over(wire, mesh, (axis,))
        return (tree_unflatten(grads, wire), tree_unflatten(residual, new_res),
                loss)

    return fn
