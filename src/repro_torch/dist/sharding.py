"""Logical-axis sharding of the port (the reference's ``dist/sharding.py``):
one rules table maps model-level axis names ("batch", "heads", "vocab",
...) onto the axes of a ``torch.distributed`` :class:`DeviceMesh` ("pod",
"data", "model"), with a divisibility fallback, so no shape ever errors.

Model code names its dimensions with :func:`shard`; the mapping onto the
mesh is resolved here, against the mesh that :func:`use_mesh_rules`
installed for the calling thread.  Off a mesh every helper is a no-op.

:func:`logical_to_spec` returns the entries of the reference's
``PartitionSpec`` as a tuple (``None``, an axis name, or a tuple of names
for a dimension split over a product of axes); :func:`placements_for` turns
them into DTensor placements, and :func:`local_block` cuts this rank's
block out of a tensor every rank holds whole.  A "mesh" may be a
``DeviceMesh``, a plain ``{axis: size}`` mapping, or an object whose
``shape`` is such a mapping (the reference's ``Mesh``): only the axis sizes
are read, except where a rank's coordinate or a group is needed.

On a ``DeviceMesh`` the models take DTensors: :func:`place_tree` places a
parameter tree by a matching tree of logical axes, and
:func:`on_local_shards` runs a function on each rank's local shards (the
kernels, the binning passes, any op with no DTensor sharding rule) and
wraps its outputs back, with autograd carried through.  Both are the
identity off a mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

__all__ = [
    "AXIS_RULES",
    "current_mesh",
    "use_mesh_rules",
    "mesh_axis_sizes",
    "logical_to_spec",
    "placements_for",
    "sharding_for",
    "local_block",
    "shard",
    "place_tree",
    "on_local_shards",
]

# logical axis name → mesh axes tried in order (a tuple entry means "shard
# over the product of these axes together").  First candidate that exists in
# the mesh, has size > 1, and divides the dimension wins; otherwise the
# dimension is replicated (never an error — the divisibility fallback).
AXIS_RULES: dict = {
    # data-parallel-ish dimensions
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "capacity": (("pod", "data"), ("data",), ("pod",)),
    "nodes": (("data",),),
    "edges": (("data",),),
    "candidates": (("data",),),
    "rows": (("data",),),
    # tensor-parallel dimensions
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "vocab": (("model",),),
    "embed": (("model",),),
    "experts": (("model",),),
    # FSDP: parameters sharded over the data axis
    "fsdp": (("data",),),
    # never sharded (scan axis / sequence kept whole on CPU-scale runs)
    "layers": (),
    "seq": (),
}

_STATE = threading.local()


def current_mesh() -> Any:
    """The mesh installed by the innermost ``use_mesh_rules`` (or None)."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh_rules(mesh: Any):
    """Install ``mesh`` as the target of the logical-axis rules for this
    thread.  ``None`` is accepted (single-device runs pass their mesh
    through unconditionally) and makes every sharding helper a no-op."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def mesh_axis_sizes(mesh: Any) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``), a mapping, or an object whose ``shape`` is a mapping."""
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"not a mesh: {type(mesh).__name__} (want a DeviceMesh "
                    "with mesh_dim_names, or an {axis: size} mapping)")


def logical_to_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                    mesh: Any) -> tuple:
    """Resolve logical axis names to the entries of a PartitionSpec for
    ``shape`` on ``mesh``: one entry a dimension, ``None``, an axis name, or
    a tuple of axis names (the product, major first).

    Guarantees: never raises on odd shapes (non-divisible dims fall back to
    replication), never assigns the same mesh axis to two dimensions, drops
    mesh axes of size <= 1."""
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(logical, shape):
        entry = None
        for cand in AXIS_RULES.get(name, ()):
            axes = tuple(a for a in cand
                         if sizes.get(a, 1) > 1 and a not in used)
            if not axes:
                continue
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if dim % prod == 0:
                used.update(axes)
                entry = axes if len(axes) > 1 else axes[0]
                break
        entries.append(entry)
    return tuple(entries)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(logical: Sequence[Optional[str]], shape: Sequence[int],
                   mesh, partial: Sequence[str] = ()) -> list:
    """DTensor placements (one a mesh dimension) that give each rank the
    reference's block of a ``shape`` tensor: ``Shard(d)`` on every mesh
    axis that the rules assign to tensor dimension ``d``, else
    ``Replicate()``.  A dimension split over a product of axes is sharded
    on each of them; DTensor splits in mesh-dimension order, so the axes of
    the product must come in that order (the rules' ``("pod", "data")``
    does on every mesh ``launch.mesh`` and ``dist.elastic`` build).

    ``partial`` names mesh axes on which each rank holds a summand of the
    tensor (``Partial()``): a local product's output before its sum over
    ``model``, or a gradient before its sum over the batch axes.  An axis
    the mesh lacks is skipped; one that shards a dimension is an error."""
    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(logical_to_spec(logical, shape, mesh)):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"dimension {d} is split over {axes}, in another order than "
                f"the mesh's dimensions {tuple(names)}")
        for i in idx:
            placements[i] = Shard(d)
    for a in partial:
        if a not in names:
            continue
        i = names.index(a)
        if placements[i] != Replicate():
            raise ValueError(f"axis {a!r} shards the tensor "
                             f"({placements[i]}); it cannot also be Partial")
        placements[i] = Partial()
    return placements


def sharding_for(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh=None) -> Optional[list]:
    """The placements for ``shape`` under the rules (None off a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return placements_for(logical, shape, mesh)


def local_block(x: torch.Tensor, logical: Sequence[Optional[str]],
                mesh) -> torch.Tensor:
    """This rank's block of ``x`` (which every rank holds whole) under the
    rules: the slice that ``distribute_tensor(x, mesh, placements_for(...))``
    would leave it, cut locally with no communication.  A dimension split
    over a product of axes takes block ``Σ coord[a] · (sizes of the axes
    after a)``, as the reference's ``PartitionSpec`` does.  The whole of
    ``x`` off a mesh; a rank outside ``mesh`` gets an error."""
    if mesh is None:
        return x
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    sizes = mesh_axis_sizes(mesh)
    at = dict(zip(mesh.mesh_dim_names, coord))
    for d, entry in enumerate(logical_to_spec(logical, x.shape, mesh)):
        axes = _entry_axes(entry)
        if not axes:
            continue
        block, n = 0, 1
        for a in axes:
            block = block * sizes[a] + at[a]
            n *= sizes[a]
        size = x.shape[d] // n
        x = x.narrow(d, block * size, size)
    return x


def shard(x, *logical: Optional[str]):
    """Place ``x`` by logical axis names: the identity off a mesh and for a
    plain tensor (each rank's own values); a DTensor is redistributed to
    the rules' placements on the current mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements_for(logical, x.shape, mesh))


def _is_axes(node) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(node, tuple) and all(a is None or isinstance(a, str)
                                           for a in node)


def place_tree(tree: Any, axes: Any, mesh,
               src_data_rank: Optional[int] = 0) -> Any:
    """``tree``'s tensors as DTensors on ``mesh``, each placed by the
    logical axes at the same spot of ``axes`` (a tree of the same
    structure whose leaves are tuples of names; ``None`` for the whole
    tree replicates every leaf).  ``distribute_tensor`` keeps the values of
    rank ``src_data_rank`` (scattered and broadcast from it), so every rank
    starts from the same tensors; ``src_data_rank=None`` cuts each rank's
    block from its own tensor, with no communication (for trees every rank
    made alike, from one seed).  The tree itself off a mesh."""
    from repro_torch.train.tree import tree_leaves, tree_unflatten

    if mesh is None:
        return tree
    leaves = tree_leaves(tree)
    specs = [None] * len(leaves) if axes is None else \
        tree_leaves(axes, is_leaf=_is_axes)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} logical-axes leaves for "
                         f"{len(leaves)} tensors")
    out = []
    for x, spec in zip(leaves, specs):
        if len(spec if spec is not None else ()) not in (0, x.ndim):
            raise ValueError(f"axes {spec} for a tensor of shape "
                             f"{tuple(x.shape)}")
        pl = placements_for(spec or (None,) * x.ndim, x.shape, mesh)
        out.append(distribute_tensor(x, mesh, pl,
                                     src_data_rank=src_data_rank))
    return tree_unflatten(tree, out)


def on_local_shards(fn, mesh, out_placements, in_placements,
                    in_grad_placements=None):
    """``fn`` run on each rank's local shards of its DTensor arguments,
    its outputs wrapped back into DTensors (``local_map``).

    ``in_placements`` (one entry a positional argument, None for a
    non-tensor or a tensor that every rank passes whole) are the
    placements ``fn`` needs: an argument placed otherwise is redistributed
    to them first (the all-gather of an FSDP-sharded weight, of a
    sequence-parallel activation).  ``out_placements`` say what each output
    is across ranks: ``Partial()`` on ``model`` for a row-parallel product
    before its sum.  ``in_grad_placements`` say what each argument's local
    gradient is, where it differs from its placement: ``Partial()`` on the
    batch axes for a weight that a data shard's tokens reach, on ``model``
    for an activation that each rank's local heads reach; an entry of None
    (or no ``in_grad_placements``) means the argument's own placements.
    Off a mesh (``mesh`` None) ``fn`` itself."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import local_map

    in_placements = tuple(in_placements)
    grads = in_placements if in_grad_placements is None else tuple(
        g if g is not None else p
        for g, p in zip(in_grad_placements, in_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)
