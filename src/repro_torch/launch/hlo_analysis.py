"""Roofline terms of the port: counted from eager dispatch, not from HLO.

The reference (``repro.launch.hlo_analysis``) reads XLA's ``cost_analysis``
of a compiled program and parses the post-SPMD HLO text for collectives.
The port compiles nothing, so there is no HLO here: the module keeps the
reference's name so a reader finds its counterpart, and counts what eager
PyTorch dispatches instead.  :class:`CountingMode` is a
``TorchDispatchMode`` that runs a step (on meta tensors for the dry-run,
on the card for a check) and records, for one rank:

* **FLOPs** from ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention ops), at the shapes this rank executes.  An op on
  DTensors is handed back to DTensor's dispatch (the mode returns
  ``NotImplemented``), which runs it on the local shards (after any
  redistribution), and the mode counts that local op; ops inside
  ``on_local_shards`` (``local_map``) are plain local tensors already.  A
  plain ``FlopCounterMode`` would count an op on DTensors once at its
  *global* shapes and a ``local_map`` block at its local ones, which is
  neither a rank's count nor the program's.  DTensor's shape inference
  (run on fake tensors) is not counted.  Replicated work counts once on
  every rank that does it, as the reference's per-partition count × the
  number of devices does.
* **Bytes**: every op's local inputs read and outputs written, views and
  allocations excluded.  That is the eager port's unfused traffic; the
  reference's "bytes accessed" is XLA's, after fusion, so the two differ
  by design (an elementwise chain is one pass there, one pass an op here).
* **Collectives**: every ``_c10d_functional`` all-gather, reduce-scatter,
  all-reduce and all-to-all (and their in-place ``c10d`` forms), with its
  tensor bytes, group size and the mesh axes its group spans.  The ring
  formulas are the reference's (:func:`ring_wire_bytes`); each op's wire
  bytes go over the bandwidth of its axes (:func:`axis_bandwidth`).
* **Peak live bytes**: the local storages the step creates, from the op
  that makes each until its storage dies (weak references to the
  storages, which PyTorch keeps alive while autograd holds a saved
  tensor), on top of the arguments' local bytes.  It leaves out the
  allocator's caching and fragmentation, the CUDA context, library
  workspaces (cuBLAS, NCCL buffers) and anything a kernel allocates
  outside torch.
* **Scopes**: :func:`scoped` tags the ops of a call, and of its backward,
  with a name; the plain attention and decode routes run under
  ``"attention"`` and ``"decode"``, so a count tells how much of itself is
  the plain path standing in for a hand-written kernel.  On the card those
  kernels are ``ctypes`` launches that no dispatch mode sees.

Hardware constants: NVIDIA H100 SXM5 80GB at its 700 W limit, from the
datasheet (not measured): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4
at 450 GB/s a direction a card (the ``model`` axis: an HGX node's 8 cards,
``launch/mesh.py``), and the inter-node fabric at 50 GB/s a card (400 Gb/s
NDR InfiniBand) for ``data`` and ``pod``.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.train.tree import tree_leaves

__all__ = ["HW", "CollectiveStats", "CountingMode", "run_counted",
           "ring_wire_bytes", "axis_bandwidth", "roofline_terms", "scoped"]

PEAK_FLOPS = 989e12  # dense bf16 / card
HBM_BW = 3.35e12  # B/s / card
NVLINK_BW = 450e9  # B/s / card, each direction (NVLink 4, HGX node)
FABRIC_BW = 50e9  # B/s / card (400 Gb/s NDR), across nodes

HW = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, nvlink_bw=NVLINK_BW,
          fabric_bw=FABRIC_BW)

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (without namespace and overload) -> collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's Shard(i) -> Shard(j)
}

# ops that move no bytes of their own: allocations, aliases, bookkeeping
_NO_BYTES = {"empty", "empty_like", "empty_strided", "_unsafe_view",
             "detach", "alias", "lift_fresh", "wait_tensor",
             "_wrap_tensor_autograd", "set_", "resize_", "new_empty",
             "new_empty_strided"}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict  # raw tensor bytes (outputs)
    wire_bytes: float  # per-device ring-model wire traffic (sum over ops)
    wire_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def ring_wire_bytes(kind: str, size: float, group_size: int) -> float:
    """One op's per-device wire bytes under the reference's ring model
    (``parse_collectives``): ``size`` is the op's output bytes."""
    g = group_size
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * size * frac  # reduce-scatter + all-gather ring
    if kind == "all-gather":
        return size * frac  # size = full output
    if kind == "reduce-scatter":
        return size * g * frac  # size = scattered output; input = g×
    if kind == "all-to-all":
        return size * frac
    return float(size)  # collective-permute


def axis_bandwidth(axes: str) -> float:
    """B/s a card for a group spanning ``axes`` ("model", "data", "pod",
    "pod+data", ...): NVLink within an HGX node (``model`` alone), the
    inter-node fabric otherwise (and for a group on no known axis).  Reads
    the module's constants at call time."""
    return NVLINK_BW if axes == "model" else FABRIC_BW


def roofline_terms(
    flops_total: float,
    bytes_total: float,
    coll: CollectiveStats,
    num_devices: int,
    model_flops: Optional[float] = None,
) -> dict:
    """Three roofline terms in seconds + diagnostics (the reference's
    arithmetic and keys).  ``flops_total`` / ``bytes_total`` are
    whole-program numbers (a rank's count × the number of ranks).  The
    collective term sums each axis's wire bytes over that axis's bandwidth
    (``coll.wire_by_axis``; without a split, all over the fabric); the
    split is added under ``t_collective_by_axis`` and
    ``wire_bytes_by_axis``."""
    t_compute = flops_total / (num_devices * PEAK_FLOPS)
    t_memory = bytes_total / (num_devices * HBM_BW)
    by_axis = dict(coll.wire_by_axis) or (
        {"": coll.wire_bytes} if coll.wire_bytes else {})
    t_axis = {a: w / axis_bandwidth(a) for a, w in by_axis.items()}
    t_collective = float(sum(t_axis.values()))
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1])
    out = dict(
        t_compute=t_compute, t_memory=t_memory, t_collective=t_collective,
        dominant=dominant[0], bound_seconds=dominant[1],
        collective_counts=coll.counts,
        collective_bytes=coll.total_bytes,
        wire_bytes=coll.wire_bytes,
        t_collective_by_axis=t_axis,
        wire_bytes_by_axis=dict(coll.wire_by_axis),
    )
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flop_frac"] = model_flops / max(flops_total, 1.0)
        # roofline fraction: useful work / (time lower-bounded by dominant term)
        t_ideal = model_flops / (num_devices * PEAK_FLOPS)
        out["roofline_fraction"] = t_ideal / max(dominant[1], 1e-30)
    return out


# --------------------------------------------------------------------- #
# scopes
# --------------------------------------------------------------------- #
_TLS = threading.local()


def _scope_stack() -> list:
    s = getattr(_TLS, "scopes", None)
    if s is None:
        s = _TLS.scopes = []
    return s


def _counting() -> bool:
    return any(isinstance(m, CountingMode)
               for m in _get_current_dispatch_mode_stack())


def _tag_graph(outputs, inputs, name: str):
    """Tag the autograd nodes between ``outputs`` and ``inputs`` with
    ``name`` (their ``metadata["count_scope"]``), so the backward's ops are
    counted under it too."""
    stop = {t.grad_fn for t in inputs if isinstance(t, torch.Tensor)}
    todo = [t.grad_fn for t in outputs
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad":
            continue
        node.metadata.setdefault("count_scope", name)
        todo.extend(nxt for nxt, _ in node.next_functions)


def scoped(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, its ops (and its backward's) counted under
    ``name`` by an active :class:`CountingMode`; just the call otherwise."""
    if not _counting():
        return fn(*args, **kwargs)
    stack = _scope_stack()
    stack.append(name)
    try:
        out = fn(*args, **kwargs)
    finally:
        stack.pop()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    _tag_graph(outs, args, name)
    return out


def _current_scope() -> Optional[str]:
    node = torch._C._current_autograd_node()
    if node is not None:
        got = node.metadata.get("count_scope")
        if got is not None:
            return got
    stack = getattr(_TLS, "scopes", None)
    return stack[-1] if stack else None


# --------------------------------------------------------------------- #
# the counting mode
# --------------------------------------------------------------------- #
def _tensors(tree) -> list:
    """The tensors in nested lists, tuples and dicts (no closure: a
    recursive one would hold them in a reference cycle past their use)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class CountingMode(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and peak live bytes of
    what runs under it (see the module's docstring).  ``mesh`` (a
    ``DeviceMesh``) names the axes a collective's group spans; ``args``
    are the step's arguments, whose local bytes start the live count.

    After the run: ``flops``, ``bytes``, ``ops`` (ops dispatched),
    ``flops_by_scope``, ``peak_bytes``, :meth:`collectives` (a
    :class:`CollectiveStats`) and ``records`` (one ``(kind, bytes,
    group_size, axes)`` a collective)."""

    def __init__(self, mesh=None, args=()):
        super().__init__()
        self.mesh = mesh
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.flops_by_scope: dict = {}
        self.records: list = []
        self._axes_of_group: dict = {}
        self._live: dict = {}  # storage id -> bytes
        self._lock = threading.Lock()  # the backward frees on its own thread
        self.live_bytes = 0
        self.peak_bytes = 0
        for leaf in tree_leaves(args):
            if isinstance(leaf, torch.Tensor):
                self._track([_local(leaf)])
            elif isinstance(leaf, int) and not isinstance(leaf, bool):
                self.live_bytes += 4  # an int32 scalar (decode's pos)
        self.arg_bytes = self.peak_bytes = self.live_bytes

    # -- collectives -------------------------------------------------- #
    def _group_axes(self, pg) -> str:
        """The mesh axes a group spans, joined by '+' in mesh order ("" if
        it is not a group of ``self.mesh``)."""
        key = pg.group_name
        if key not in self._axes_of_group:
            axes = ""
            if self.mesh is not None:
                grid = self.mesh.mesh
                coords = [torch.nonzero(grid == r)[0].tolist()
                          for r in dist.get_process_group_ranks(pg)
                          if bool((grid == r).any())]
                if len(coords) == pg.size():
                    axes = "+".join(
                        n for i, n in enumerate(self.mesh.mesh_dim_names)
                        if len({c[i] for c in coords}) > 1)
            self._axes_of_group[key] = axes
        return self._axes_of_group[key]

    def _record_collective(self, kind: str, args, out):
        """One collective: its output bytes, group size and axes (a
        functional op names its group in its last string argument, after
        any reduce op; an in-place ``c10d`` op passes the group)."""
        size = float(sum(_nbytes(t) for t in _tensors(out)))
        pg = next((dist.distributed_c10d._resolve_process_group(a)
                   if isinstance(a, str) else a for a in reversed(args)
                   if isinstance(a, (str, dist.ProcessGroup))), None)
        if pg is None:
            self.records.append((kind, size, 1, ""))
        else:
            self.records.append((kind, size, pg.size(),
                                 self._group_axes(pg)))

    def collectives(self) -> CollectiveStats:
        counts = {k: 0 for k in _COLL_KINDS}
        by_kind = {k: 0.0 for k in _COLL_KINDS}
        wire, by_axis = 0.0, {}
        for kind, size, g, axes in self.records:
            counts[kind] += 1
            by_kind[kind] += size
            w = ring_wire_bytes(kind, size, g)
            wire += w
            if w:
                by_axis[axes] = by_axis.get(axes, 0.0) + w
        return CollectiveStats(counts=counts, bytes_by_kind=by_kind,
                               wire_bytes=wire, wire_by_axis=by_axis)

    # -- live storages ------------------------------------------------ #
    def _track(self, outs):
        """Count the storages of ``outs`` not counted yet (a view or an
        in-place result shares its input's), each until it dies."""
        for t in outs:
            try:
                st = t.untyped_storage()
            except Exception:
                continue
            key = st._cdata
            with self._lock:
                if key in self._live:
                    continue
                nb = st.nbytes()
                self._live[key] = nb
                self.live_bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch ----------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's shape inference, not a rank's work
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._record_collective(kind, args, out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            scope = _current_scope()
            if scope is not None:
                self.flops_by_scope[scope] = \
                    self.flops_by_scope.get(scope, 0) + f
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        self._track(outs)
        return out


def run_counted(fn: Callable, args: tuple, mesh=None) -> CountingMode:
    """``fn(*args)`` under a :class:`CountingMode`; its result dropped
    before the count is returned (so the live bytes fall back)."""
    with CountingMode(mesh, args) as c:
        out = fn(*args)
        del out
    return c
