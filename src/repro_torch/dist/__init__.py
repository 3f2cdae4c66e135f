"""Distribution layer of the port (the reference's ``dist/``) on
``torch.distributed``: logical-axis sharding rules over a
:class:`~torch.distributed.device_mesh.DeviceMesh` (:mod:`.sharding`), the
hand-rolled collectives (:mod:`.collectives`) and elastic meshes
(:mod:`.elastic`).

Everything degrades to one device: off a mesh ``shard`` is the identity,
``current_mesh()`` is ``None``, and the collectives take their flat
equivalents.  Importing the package creates no process group.
"""
from . import collectives, elastic, sharding  # noqa: F401
