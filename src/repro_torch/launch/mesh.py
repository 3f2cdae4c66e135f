"""Production mesh of the port (the reference's ``launch/mesh.py``).

A function, not a module-level constant: importing this module creates no
process group.  The reference's 16 × 16 TPU v5e torus does not carry over;
an H100 pod is HGX nodes of 8 NVLink-connected cards, so the ``model``
axis is the NVLink domain of 8 and ``data`` runs across nodes: ``(32, 8)``
over ``("data", "model")``, and ``(2, 32, 8)`` over ``("pod", "data",
"model")`` for two pods.  ``POD_CHIPS`` stays 256, so the dry-run's cells
divide the same global batches.  The world must have exactly that many
ranks (a fake process group does for the dry-run).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["make_production_mesh", "POD_CHIPS", "NODE_CARDS"]

POD_CHIPS = 256  # 32 HGX nodes × 8 cards
NODE_CARDS = 8  # one NVLink domain


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The pod's mesh on the backend's device type, or on ``device_type``:
    the dry-run asks for ``"cuda"`` on its fake group, so that DTensor
    plans the collectives NCCL would run (on a ``"cpu"`` mesh it turns a
    shard-to-shard all-to-all into an all-gather, gloo having none)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.elastic import mesh_device_type

    nodes = POD_CHIPS // NODE_CARDS
    shape = (2, nodes, NODE_CARDS) if multi_pod else (nodes, NODE_CARDS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or mesh_device_type(), shape,
                            mesh_dim_names=axes)
