"""Design-choice ablations from paper §3.1 — the alternatives GraphCage
argues AGAINST, implemented so the argument is measurable:

* **2D blocking** (§3.1 choice 2): partition on BOTH source and destination
  ranges.  More, smaller blocks → fewer reuses captured per block + more
  merge overhead.  :func:`build_blocked_2d` + :func:`tocab_pull_2d`.
* **Dynamic blocking / propagation blocking** (§3.1 choice 3, Beamer's PB):
  no preprocessing — per-iteration runtime binning of (dst, contribution)
  pairs into cache-sized buckets, then bucket-sequential accumulation.
  Costs extra stores+loads for the intermediate buffers every iteration
  (the paper's argument for static blocking).
  :func:`propagation_blocking_pull`.

Both compute the flat baseline's result and reduce through the slab
engines' :func:`~repro_torch.core.tocab.segment_reduce`, so their sums are
the same float atomics (not bit-reproducible on the card).  Neither has a
kernel of its own: the reference computes both with XLA ops.  The layout
is built on the device that will hold it, array for array equal to
``repro.core.ablations.build_blocked_2d``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .graph import DeviceGraph, Graph, GraphValidationError
from .partition import REDUCE_IDENTITY, _roundup
from .tocab import _check_reduce, _edge_messages, _take_fill, segment_reduce

__all__ = ["build_blocked_2d", "tocab_pull_2d", "propagation_blocking_pull",
           "Blocked2D"]

_MERGE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}


@dataclasses.dataclass(frozen=True)
class Blocked2D:
    """2D-blocked edges: tile (bi, bj) holds edges with src∈range(bi),
    dst∈range(bj).  Stored as a flat (num_tiles, edge_budget) slab grid."""

    n: int
    m: int
    block_size: int
    tiles_per_side: int
    edge_budget: int
    src_rel: torch.Tensor  # int32[T, eb] src − src_block_lo
    dst_rel: torch.Tensor  # int32[T, eb] dst − dst_block_lo
    edge_mask: torch.Tensor  # bool[T, eb]
    edge_vals: Optional[torch.Tensor] = None  # f32[T, eb]

    @property
    def num_tiles(self) -> int:
        return self.tiles_per_side ** 2

    @property
    def device(self) -> torch.device:
        return self.src_rel.device


def _edge_lists(g: Union[Graph, DeviceGraph], device):
    """(src, dst, vals) of ``g`` on ``device`` in CSR order (src-sorted,
    the order of ``Graph.edges()``), indices as int64."""
    if isinstance(g, DeviceGraph):
        vals = None if g.vals is None else g.vals.to(device)
        return g.src.to(device).long(), g.dst.to(device).long(), vals
    rowptr = torch.from_numpy(np.ascontiguousarray(g.rowptr, np.int64))
    rowptr = rowptr.to(device)
    src = torch.repeat_interleave(
        torch.arange(g.n, dtype=torch.int64, device=rowptr.device),
        rowptr[1:] - rowptr[:-1], output_size=g.m)
    dst = torch.from_numpy(np.ascontiguousarray(g.colidx, np.int32))
    dst = dst.to(device).long()
    vals = None
    if g.vals is not None:
        vals = torch.from_numpy(
            np.ascontiguousarray(g.vals, np.float32)).to(device)
    return src, dst, vals


def build_blocked_2d(g: Union[Graph, DeviceGraph], block_size: int,
                     pad_edges_to: int = 128, device="cuda") -> Blocked2D:
    """2D blocking of ``g`` (a host :class:`Graph`, or the edge lists of a
    :class:`DeviceGraph`, which hold the same CSR order) on ``device``: a
    stable sort of the tile keys, per-tile counts and the slot scatter."""
    src, dst, vals = _edge_lists(g, device)
    dev = src.device
    n, m = g.n, g.m
    nb = max(1, -(-n // block_size))
    T = nb * nb
    bi = torch.div(src, block_size, rounding_mode="floor")
    bj = torch.div(dst, block_size, rounding_mode="floor")
    tile, order = torch.sort(bi * nb + bj, stable=True)
    del bi, bj
    src, dst = src[order], dst[order]
    if vals is not None:
        vals = vals[order]
    del order
    counts = torch.bincount(tile, minlength=T)
    eb = _roundup(max(int(counts.max()) if m else 1, 1), pad_edges_to)
    if T * eb > np.iinfo(np.int32).max:
        raise GraphValidationError(
            "budget_overflow",
            f"2D slab has {T * eb} slots ({T} tiles of {eb}), exceeding "
            "int32 addressing")
    first = torch.cumsum(counts, 0) - counts
    flat = tile * eb + torch.arange(m, dtype=torch.int64, device=dev) \
        - torch.repeat_interleave(first, counts, output_size=m)
    lo_i = torch.div(tile, nb, rounding_mode="floor") * block_size
    lo_j = torch.remainder(tile, nb) * block_size
    del tile, first, counts
    src_rel = torch.zeros((T, eb), dtype=torch.int32, device=dev)
    src_rel.view(-1)[flat] = (src - lo_i).to(torch.int32)
    del src, lo_i
    dst_rel = torch.zeros((T, eb), dtype=torch.int32, device=dev)
    dst_rel.view(-1)[flat] = (dst - lo_j).to(torch.int32)
    del dst, lo_j
    mask = torch.zeros((T, eb), dtype=torch.bool, device=dev)
    mask.view(-1)[flat] = True
    ev = None
    if vals is not None:
        ev = torch.zeros((T, eb), dtype=torch.float32, device=dev)
        ev.view(-1)[flat] = vals
    return Blocked2D(n=n, m=m, block_size=int(block_size), tiles_per_side=nb,
                     edge_budget=eb, src_rel=src_rel, dst_rel=dst_rel,
                     edge_mask=mask, edge_vals=ev)


def tocab_pull_2d(bg: Blocked2D, values: torch.Tensor,
                  reduce: str = "sum") -> torch.Tensor:
    """2D-blocked pull: per tile, gather from the source window and reduce
    into a dense per-tile destination slab; merge tiles per dst block.
    ``values`` is ``(n,)``: the reference's broadcasts of the edge values
    and the mask hold for 1-D values only."""
    if values.ndim != 1:
        raise ValueError(
            f"tocab_pull_2d takes (n,) values, got shape "
            f"{tuple(values.shape)}: the 2D layout's edge values and mask "
            "broadcast against one value a slot")
    _check_reduce(reduce)
    nb, B, T = bg.tiles_per_side, bg.block_size, bg.num_tiles
    tiles = torch.arange(T, dtype=torch.int64, device=bg.device)[:, None]
    msgs = _take_fill(values, bg.src_rel + (tiles // nb) * B)
    if bg.edge_vals is not None:
        msgs = msgs * bg.edge_vals
    msgs = torch.where(bg.edge_mask, msgs, REDUCE_IDENTITY[reduce])
    # per-tile dense partials over the destination window
    flat_idx = bg.dst_rel + tiles * B
    partials = segment_reduce(msgs.reshape(-1), flat_idx.reshape(-1),
                              T * B, reduce)
    # merge: tiles (bi, bj) reduce over bi into dst block bj
    out = _MERGE[reduce](partials.view(nb, nb, B), dim=0)
    return out.reshape(nb * B)[: bg.n]


def propagation_blocking_pull(dg: DeviceGraph, values: torch.Tensor,
                              num_bins: int = 16,
                              reduce: str = "sum") -> torch.Tensor:
    """Dynamic blocking (Beamer's propagation blocking, §3.1/§5):

    Phase 1 (binning): compute per-edge (dst, contribution) pairs and sort
    them by destination *bin* at runtime — this materializes the full
    intermediate stream (the extra loads/stores the paper charges against
    dynamic schemes).
    Phase 2 (accumulate): bucket-sequential segment reduce."""
    _check_reduce(reduce)
    msgs = _edge_messages(values, dg.src, dg.vals, None, reduce, None)
    bin_size = -(-dg.n // num_bins)
    order = torch.sort(torch.div(dg.dst, bin_size, rounding_mode="floor"),
                       stable=True).indices  # runtime binning pass
    binned_dst = dg.dst[order]  # intermediate buffer #1
    binned_msgs = msgs[order]  # intermediate buffer #2
    return segment_reduce(binned_msgs, binned_dst, dg.n, reduce)
