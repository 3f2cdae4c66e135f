"""Elastic meshes of the port (the reference's ``dist/elastic.py``): build
a ("data", "model") :class:`DeviceMesh` from whatever ranks exist right
now, and re-place tensors onto another mesh (restore after a resize).

The checkpoint layer is mesh-agnostic (host numpy, written once by rank
0); elasticity is "restore with the new mesh's placements"
(``train.checkpoint.restore(..., shardings=)``), and :func:`reshard` is the
in-memory version of the same move.  Both need ``torch.distributed``
initialised: NCCL on the card, gloo on the CPU.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.train.tree import tree_leaves, tree_unflatten

from .sharding import placements_for

__all__ = ["make_mesh_for", "reshard", "mesh_device_type", "place",
           "is_pair", "spec_leaves"]


def mesh_device_type() -> str:
    """The device type the default process group's backend serves:
    ``"cuda"`` for NCCL, ``"cpu"`` otherwise (gloo, the fake backend)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first (torchrun sets up "
                           "its environment)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_for(num_devices: Optional[int] = None,
                  axes: Sequence[str] = ("data", "model"),
                  model_parallel: int = 1):
    """Mesh over the first ``num_devices`` ranks of the world (default: all
    of them), on the backend's device type.

    ``model_parallel`` is clamped to a divisor of the rank count; the
    remainder goes to the data axis — on an elastic resize the same call
    yields the best mesh the surviving ranks support.  Every rank of the
    world calls it (ranks past ``num_devices`` get a mesh they are not
    part of)."""
    device_type = mesh_device_type()
    world = dist.get_world_size()
    n = world if num_devices is None else min(num_devices, world)
    mp = max(1, model_parallel)
    while n % mp:
        mp -= 1
    ranks = torch.arange(n).reshape(n // mp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def is_pair(s) -> bool:
    """Whether ``s`` is a ``(DeviceMesh, placements)`` pair."""
    return isinstance(s, tuple) and len(s) == 2 and \
        getattr(s[0], "mesh_dim_names", None) is not None


def _is_spec(s) -> bool:
    """A leaf of a specs tree: a logical-axis tuple (``("batch", None)``,
    ``()``), a ``(DeviceMesh, placements)`` pair, or None."""
    if s is None or is_pair(s):
        return True
    return isinstance(s, tuple) and all(a is None or isinstance(a, str)
                                        for a in s)


def spec_leaves(specs, n: int) -> list:
    """``n`` specs from a tree of them (matching the tensors' leaves) or a
    single one (for every leaf)."""
    if _is_spec(specs):
        return [specs] * n
    leaves = tree_leaves(specs, is_leaf=_is_spec)
    if len(leaves) == 1:
        return leaves * n
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} specs for {n} leaves")
    return leaves


def place(x: torch.Tensor, mesh, spec):
    """``x`` as a DTensor on ``mesh``: a plain tensor is distributed (every
    rank holds it whole; the mesh's first rank's values are the ones
    kept), a DTensor on another mesh is gathered to its full tensor and
    broadcast to every rank of the world first (every rank calls this
    then), one on ``mesh`` is redistributed.  ``spec``: None (replicate), a logical-axis tuple, or a
    ``(mesh, placements)`` pair whose mesh takes ``mesh``'s place."""
    if is_pair(spec):
        mesh, placements = spec
    elif spec is None:
        placements = [Replicate()] * mesh.ndim
    else:
        placements = placements_for(spec, x.shape, mesh)
    if isinstance(x, DTensor):
        old = x.device_mesh
        if old == mesh:
            return x.redistribute(mesh, placements)
        # every rank of the world gets the whole tensor from the old mesh's
        # first rank (a rank outside the old mesh holds no block of it)
        full = x.full_tensor().contiguous() if old.get_coordinate() \
            is not None else torch.empty(x.shape, dtype=x.dtype,
                                         device=old.device_type)
        dist.broadcast(full, int(old.mesh.flatten()[0]))
        x = full
    return distribute_tensor(x.to(mesh.device_type), mesh, placements)


def reshard(tree: Any, mesh, specs=None):
    """Re-place every leaf of ``tree`` onto ``mesh``.

    ``specs`` may be a matching tree of logical-axis tuples, a single one,
    or None (replicate).  Works across meshes of different sizes — the
    elastic restore path with no disk round-trip.  Every rank of the world
    calls it."""
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, [place(x, mesh, s) for x, s in zip(
        leaves, spec_leaves(specs, len(leaves)))])
