"""Analytic cache model — reproduces the paper's Fig. 9 (L2 miss rate) and
Fig. 10 (DRAM transactions per edge, the GAIL metric).

The model *replays the exact vertex-value access stream* of each PageRank
variant against a set-associative LRU cache configured like the paper's
GTX 1080Ti L2 (2.75 MB, 128 B lines).  It is the reference's model
(``repro.core.cache_model``) in numpy and Python, counter for counter; the
layout comes from the port's :func:`~repro_torch.core.partition.
build_blocked`, built on the CPU.
Streaming arrays (colidx/rowptr/edge vals) are accounted as compulsory-miss
sequential traffic — they have no reuse and the paper's analysis treats them
as bandwidth, not locality, traffic.

The model captures precisely the effect the paper measures:

* ``base``  — per-edge random reads ``contributions[src]`` over the full
  vertex range (thrashes when |V|·4B ≫ cache) + sequential ``sums`` writes.
* ``cb``    — reads confined per block (hit) but per-block *sparse global*
  writes of partials → repeated traffic ∝ num_blocks.
* ``tocab`` — confined reads + dense compacted partial writes + one
  sequential reduction pass (reads partials, writes sums).
* ``fused`` — the fused TOCAB pipeline: confined reads only; partials
  accumulate in a fast-memory-resident tile, so the partial write/read
  traffic terms vanish and the result spills once, sequentially.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable

import numpy as np

from repro_torch.obs.metrics import registry as _obs
from .graph import Graph
from .partition import build_blocked

__all__ = ["CacheConfig", "CacheSim", "simulate_pagerank_variant", "GAIL_VARIANTS"]

GAIL_VARIANTS = ("base", "cb", "tocab", "fused")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    capacity_bytes: int = int(2.75 * 1024 * 1024)  # GTX 1080Ti L2
    line_bytes: int = 128
    ways: int = 16

    @property
    def num_sets(self) -> int:
        return max(1, self.capacity_bytes // (self.line_bytes * self.ways))


class CacheSim:
    """Set-associative LRU cache simulator over byte addresses."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self.sets = [OrderedDict() for _ in range(cfg.num_sets)]
        self.accesses = 0
        self.misses = 0
        self.writebacks = 0

    def access_lines(self, lines: Iterable[int], write: bool = False):
        ways = self.cfg.ways
        nsets = self.cfg.num_sets
        for line in lines:
            self.accesses += 1
            s = self.sets[line % nsets]
            if line in s:
                s.move_to_end(line)
                if write:
                    s[line] = True
            else:
                self.misses += 1
                if len(s) >= ways:
                    _, dirty = s.popitem(last=False)
                    if dirty:
                        self.writebacks += 1
                s[line] = write

    def access_array(self, base: int, idx: np.ndarray, elem_bytes: int = 4, write=False):
        lines = (base + idx.astype(np.int64) * elem_bytes) // self.cfg.line_bytes
        self.access_lines(lines.tolist(), write=write)

    def access_sequential(self, base: int, count: int, elem_bytes: int = 4, write=False):
        nbytes = count * elem_bytes
        lo = base // self.cfg.line_bytes
        hi = (base + max(nbytes - 1, 0)) // self.cfg.line_bytes
        self.access_lines(range(lo, hi + 1), write=write)

    @property
    def miss_rate(self) -> float:
        return self.misses / max(self.accesses, 1)

    @property
    def dram_transactions(self) -> int:
        return self.misses + self.writebacks


def simulate_pagerank_variant(
    g: Graph,
    variant: str,
    cfg: CacheConfig = CacheConfig(),
    block_size: int | None = None,
) -> dict:
    """Replay one PR-pull iteration's vertex-value accesses; return metrics.

    Only the *cache-relevant* stream is replayed through the LRU model (the
    contributions/sums/partials arrays); purely-streaming CSR index traffic
    is added analytically to DRAM transactions (it always misses)."""
    sim = CacheSim(cfg)
    n, m = g.n, g.m
    lb = cfg.line_bytes
    # disjoint virtual address spaces
    A_CONTRIB = 0
    A_SUMS = 1 << 40
    A_PART = 2 << 40

    src, dst = g.edges()
    stream_lines = 0  # compulsory sequential traffic (colidx + rowptr)
    stream_lines += (m * 4) // lb + 1  # colidx
    stream_lines += ((n + 1) * 4) // lb + 1  # rowptr

    if variant == "base":
        # pull: for each dst in order, read contributions[src] (random),
        # write sums[dst] (sequential).
        order = np.argsort(dst, kind="stable")
        sim.access_array(A_CONTRIB, src[order])
        sim.access_sequential(A_SUMS, n, write=True)
    elif variant in ("cb", "tocab", "fused"):
        if block_size is None:
            # paper's GPU choice: block sized so the window fits L2
            block_size = max(256, cfg.capacity_bytes // 8 // 4)
        bg = build_blocked(g, block_size=block_size, direction="pull",
                           classify=False, device="cpu")
        wij = bg.window_idx.numpy()
        cij = bg.compact_idx.numpy()
        mask = bg.edge_mask.numpy()
        idmap = bg.id_map.numpy()
        nloc = bg.n_local.numpy()
        for b in range(bg.num_blocks):
            em = mask[b]
            srcs = wij[b][em] + b * bg.block_size
            sim.access_array(A_CONTRIB, srcs)  # window-confined reads
            if variant == "tocab":
                # dense partial slab writes (compacted local IDs)
                sim.access_array(A_PART + b * bg.local_budget * 4, cij[b][em], write=True)
            elif variant == "cb":
                # conventional CB: sparse *global-width* writes per block —
                # the repeated-access overhead the paper calls out.
                gdst = idmap[b][cij[b][em]]
                sim.access_array(A_SUMS, gdst, write=True)
            # fused: partials never leave the resident accumulator — no
            # partial traffic term at all.
        if variant == "tocab":
            # reduction phase: sequential read of all partials, sequential
            # write of sums (paper Fig. 5 — fully coalesced).
            total_locals = int(nloc.sum())
            sim.access_sequential(A_PART, total_locals)
            sim.access_sequential(A_SUMS, n, write=True)
            stream_lines += (total_locals * 4) // lb + 1  # id_map stream
        elif variant == "fused":
            # epilogue spill: the resident output tile is written once,
            # sequentially; id_map windows still stream in per block to
            # address the fold.
            total_locals = int(nloc.sum())
            sim.access_sequential(A_SUMS, n, write=True)
            stream_lines += (total_locals * 4) // lb + 1  # id_map stream
    else:
        raise ValueError(f"unknown variant {variant!r}")

    dram = sim.dram_transactions + stream_lines
    result = dict(
        variant=variant,
        miss_rate=sim.miss_rate,
        cache_accesses=sim.accesses,
        cache_misses=sim.misses,
        cache_writebacks=sim.writebacks,
        dram_transactions=dram,
        dram_per_edge=dram / max(m, 1),
        num_blocks=1 if variant == "base" else bg.num_blocks,
    )
    # Publish through the process-wide registry (same series the runtime
    # engines use) so a benchmark export carries the locality counters
    # alongside wall-clock — the paper's Fig. 9/10 axes, machine-readable.
    for key in ("miss_rate", "cache_accesses", "cache_misses",
                "cache_writebacks", "dram_transactions", "dram_per_edge"):
        _obs.gauge(f"cache.{key}", "analytic LRU cache model").set(
            result[key], variant=variant)
    _obs.counter("cache.simulations", "cache-model replays").inc(
        variant=variant)
    return result
