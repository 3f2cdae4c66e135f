#!/usr/bin/env python3
"""Floors and design variants of the port's graph kernels, ``fused_pull``
and ``fused_push`` (``src/repro_torch/kernels/tocab_fused/csrc/``) and
``tocab_spmm`` (``src/repro_torch/kernels/tocab_spmm/csrc/
tocab_spmm.cu``), built and timed side by side on one card at the main
path's shapes: the Graph500 scale-24 graph of ``chip_smoke.py``
(``rmat_graph(24, 16, seed=1, weights=True)``), its pull and push layouts
and the pull layout's dense bin, PageRank-like fp32 values, unweighted.

    python3 benchmarks/torch_graph_kernel_variants.py [--scale 24]
        [--out graph_kernel_variants.jsonl]   # on the card

Floors, each timed alone with CUDA events (hashed indices made inside the
kernel, so no index stream is read):

* ``red`` — as many random no-return ``red.global.add.f32`` as the graph
  has edges, into arrays of 1/4, 1/2, 1, 2 and 4 times the 26 MB window,
  without and with an L2 evict-last hint;
* ``gather`` — as many random 4-byte reads, from the same sizes, plain
  (``ld.global.nc``) and with the hint and no L1 allocation;
* ``streams`` — the push layout's ``widx``, ``cidx`` and ``mask`` slabs
  read once (16-byte loads), the pull layout's, and the dense block's
  alone;
* ``slots`` — those slabs read mask first, and per real slot one RED into
  (push) or one gather from (pull, the dense block) the window at its
  ``widx``: the kernel's memory traffic without its id_map reads and
  scans.

``push_destinations`` says how far combining equal destinations could cut
push's reductions: the share of distinct destinations among the real
slots of block 0 per range of 2^12 to 2^24 consecutive slots.

Variants: each source with one edit, made in a temporary directory (the
repository's files are not touched), built with the loader's ``nvcc``
flags and called through the package's own launcher:

* ``previous`` — the earlier designs (``PREVIOUS_SRC``, a copy of their
  global-window kernels, sum semiring): push one CTA per 4096-slot chunk,
  one slot a thread, every message an atomic; pull and SpMM one CTA per
  4096-slot chunk, one slot and one gather in flight a lane, an atomic per
  run per 32-slot step;
* ``as_is`` — the source;
* pull: ``steps1`` / ``steps2`` / ``steps8`` (batched 32-slot steps a
  warp, 4 as is), ``window_no_l1`` (window gathers without L1
  allocation), ``window_normal`` (the window's L2 policy evict-normal),
  ``streams_normal`` (the slot streams' L2 policy evict-normal),
  ``streams_l1`` (slot streams through L1, no L2 policy), ``no_carry``
  (each step's last run added at the step, not carried), ``persistent``
  (as many CTAs as are resident, each warp walking the chunks with a
  static stride; one chunk a warp as is), ``chunk2048`` (warp chunks, 512
  as is), ``stream_all_d`` (d > 1 on the streaming kernel too: timed at
  d = 8 only, in turns with ``as_is``);
* push: ``table8192`` / ``table16384`` (table entries, 28672 as is),
  ``threads256_table4096`` (combining CTAs of 256 threads, four an SM,
  each with a 4096-entry table; one CTA of 1024 threads as is),
  ``steps8`` (batched 32-slot steps a warp, 4 as is), ``counted`` (as
  is, counting edges reduced in the table, edges sent to L2 and entries
  flushed: a ``push_counts`` line);
* SpMM: ``steps2`` / ``steps8`` (4 as is), ``chunk512`` / ``chunk8192`` (warp chunks,
  2048 as is), ``nonpersistent`` (one CTA per 8 warp chunks),
  ``streams_l1`` (slot streams through L1, no L2 policy),
  ``window_normal`` (the window's L2 policy evict-normal),
  ``window_no_l1`` (window gathers without L1 allocation);
* the three sources as they are at d = 8 (``(n, 8)`` values), where each
  takes its d > 1 kernel.

Every variant is held against the plain version at the main shapes
(``chip_smoke.py``'s ``SUM_RTOL`` and atol); a ``torch.sparse`` CSR
product of the same matrices is timed beside them.
One JSON line per measurement, after the card's name and power limit; the
same lines go to ``--out``.  Fails if there is no card, or if a source no
longer has the text an edit targets.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (uint32_t)x;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

constexpr int kBatch = 8;  // independent operations in flight per thread

template <bool HINT>
__global__ void red_probe(float* a, uint32_t n, int64_t count) {
  const uint64_t pol = evict_last();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kBatch;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kBatch;
       i < count; i += stride) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i + u >= count) break;
      float* p = a + mix(i + u) % n;
      if (HINT)
        asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
                     :: "l"(p), "f"(1.0f), "l"(pol) : "memory");
      else
        asm volatile("red.global.add.f32 [%0], %1;"
                     :: "l"(p), "f"(1.0f) : "memory");
    }
  }
}

template <bool HINT>
__global__ void gather_probe(const float* a, uint32_t n, int64_t count,
                             float* sink) {
  const uint64_t pol = evict_last();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kBatch;
  float acc = 0.0f;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kBatch;
       i < count; i += stride) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = 0.0f;
      if (i + u < count) {
        const float* p = a + mix(i + u) % n;
        if (HINT)
          asm volatile(
              "ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
              : "=f"(v[u]) : "l"(p), "l"(pol));
        else
          v[u] = __ldg(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc += v[u];
  }
  if (acc == -1.0f) sink[0] = acc;  // never: keeps the loads
}

// count4: 16-byte vectors of each int32 slab; the mask has count4 4-byte
__global__ void stream_probe(const int4* widx, const int4* cidx,
                             const uint32_t* mask, int64_t count4,
                             int* sink) {
  int acc = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < count4; i += (int64_t)gridDim.x * blockDim.x) {
    const int4 w = __ldcs(widx + i), c = __ldcs(cidx + i);
    acc ^= w.x ^ w.y ^ w.z ^ w.w ^ c.x ^ c.y ^ c.z ^ c.w ^
           (int)__ldcs(mask + i);
  }
  if (acc == 0x7fffffff) sink[0] = acc;
}

// One block row of a layout's slot streams (the mask, then cidx and widx
// of the real slots) and per real slot one RED into (MODE 0) or one gather
// from (MODE 1) the block's window at widx: a kernel's memory traffic
// without its id_map and value reads and without its scans.
template <int MODE>
__global__ void slots_probe(const int32_t* widx, const int32_t* cidx,
                            const uint8_t* mask, int64_t nslots, float* win,
                            float* sink) {
  const int64_t T = (int64_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  int key = 0;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       r < nslots; r += T * kBatch) {
    int64_t at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t s = r + u * T;
      at[u] = -1;
      if (s < nslots && __ldcs(mask + s)) {
        key ^= __ldcs(cidx + s);
        at[u] = __ldcs(widx + s);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] < 0) continue;
      if (MODE == 0)
        asm volatile("red.global.add.f32 [%0], %1;"
                     :: "l"(win + at[u]), "f"(1.0f) : "memory");
      else
        acc += __ldg(win + at[u]);
    }
  }
  if (acc == -1.0f || key == 0x7fffffff) sink[0] = acc;
}

extern "C" int probe_slots(const void* widx, const void* cidx,
                           const void* mask, int64_t nslots, float* win,
                           float* sink, int mode, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(widx);
  auto c = static_cast<const int32_t*>(cidx);
  auto m = static_cast<const uint8_t*>(mask);
  if (mode == 0)
    slots_probe<0><<<grid, 256, 0, st>>>(w, c, m, nslots, win, sink);
  else
    slots_probe<1><<<grid, 256, 0, st>>>(w, c, m, nslots, win, sink);
  return cudaGetLastError();
}

extern "C" int probe_red(float* a, uint32_t n, int64_t count, int hint,
                         int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hint) red_probe<true><<<grid, 256, 0, st>>>(a, n, count);
  else red_probe<false><<<grid, 256, 0, st>>>(a, n, count);
  return cudaGetLastError();
}

extern "C" int probe_gather(const float* a, uint32_t n, int64_t count,
                            float* sink, int hint, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hint) gather_probe<true><<<grid, 256, 0, st>>>(a, n, count, sink);
  else gather_probe<false><<<grid, 256, 0, st>>>(a, n, count, sink);
  return cudaGetLastError();
}

extern "C" int probe_streams(const void* widx, const void* cidx,
                             const void* mask, int64_t count4, int* sink,
                             int grid, void* stream) {
  stream_probe<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(widx), static_cast<const int4*>(cidx),
      static_cast<const uint32_t*>(mask), count4, sink);
  return cudaGetLastError();
}
"""

#: The earlier designs of fused_pull, fused_push's global window (d = 1 and
#: d > 1 alike) and tocab_spmm, sum semiring, weighted or not: the
#: yardsticks that ``previous_ms`` times (:class:`Previous`).
PREVIOUS_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int64_t kChunkSlots = 4096;  // edge slots per CTA
constexpr unsigned kFull = 0xffffffffu;

// push: one CTA per chunk, one slot a thread, one atomic a message
template <bool W>
__global__ void __launch_bounds__(kThreads)
push_global(const float* __restrict__ values, const int32_t* __restrict__ widx,
            const int32_t* __restrict__ cidx, const float* __restrict__ ev,
            const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ id_map, float* out, int64_t n,
            int64_t edge_budget, int64_t local_budget, int64_t block_size,
            int d, int64_t chunks_per_block) {
  const int64_t b = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - b * chunks_per_block;
  const int64_t row = b * edge_budget;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  float* win = out + b * block_size * d;
  for (int64_t s = row + c * kChunkSlots + threadIdx.x; s < row + s_end;
       s += kThreads) {
    if (!mask[s]) continue;
    const int k = cidx[s];
    if (k < 0 || k >= local_budget) continue;
    const int64_t src = id_map[b * local_budget + k];
    if (src >= n) continue;
    const int64_t w_row = widx[s];
    const float w = W ? ev[s] : 1.0f;
    for (int f = 0; f < d; ++f)
      atomicAdd(win + w_row * d + f, W ? values[src * d + f] * w
                                       : values[src * d + f]);
  }
}

// pull: one CTA per chunk, one slot and one gather a lane, the runs of
// equal cidx reduced by a segmented shuffle scan, an atomic per run a step
// into out through id_map
template <bool W>
__global__ void __launch_bounds__(kThreads)
pull_kernel(const float* __restrict__ values, const int32_t* __restrict__ widx,
            const int32_t* __restrict__ cidx, const float* __restrict__ ev,
            const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ id_map, float* __restrict__ out,
            int64_t n, int64_t edge_budget, int64_t local_budget,
            int64_t block_size, int d, int64_t chunks_per_block) {
  const int64_t b = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - b * chunks_per_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = b * block_size;
  const int64_t row = b * edge_budget;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  const unsigned lanes_le = kFull >> (31 - lane);
  for (int64_t base = c * kChunkSlots + warp * 32; base < s_end;
       base += kThreads) {
    const int64_t s = base + lane;
    const bool live = s < s_end && mask[row + s];
    const int key = live ? cidx[row + s] : -1;
    const int64_t src = live ? lo + widx[row + s] : 0;
    const float w = (W && live) ? ev[row + s] : 1.0f;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = 31 - __clz(heads & lanes_le);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    int64_t gid = -1;
    if (tail && key >= 0) {
      gid = id_map[b * local_budget + key];
      if (gid >= n) gid = -1;
    }
    for (int f = 0; f < d; ++f) {
      float v = live ? values[src * d + f] : 0.0f;
      if (W) v *= w;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, v, off);
        if (lane - off >= seg) v += t;
      }
      if (gid >= 0) atomicAdd(out + gid * d + f, v);
    }
  }
}

__global__ void epilogue_kernel(float* __restrict__ out, int64_t count,
                                const float* __restrict__ eps) {
  const float mul = eps[0], add = eps[1];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < count; i += (int64_t)gridDim.x * blockDim.x)
    out[i] = __fadd_rn(__fmul_rn(out[i], mul), add);
}

// SpMM: one CTA per chunk, one slot and one gather a lane, the runs of
// equal cidx reduced by a segmented shuffle scan, an atomic per run a step
template <bool W>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ values, const int32_t* __restrict__ widx,
            const int32_t* __restrict__ cidx, const float* __restrict__ ev,
            const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ block_ids, float* __restrict__ out,
            int64_t num_blocks, int64_t edge_budget, int64_t block_size,
            int64_t local_budget, int d, int64_t chunks_per_block) {
  const int64_t j = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - j * chunks_per_block;
  const int64_t b = block_ids[j];
  if (b < 0 || b >= num_blocks) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = b * block_size;
  const int64_t row = b * edge_budget;
  float* slab = out + j * local_budget * d;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  const unsigned lanes_le = kFull >> (31 - lane);
  for (int64_t base = c * kChunkSlots + warp * 32; base < s_end;
       base += kThreads) {
    const int64_t s = base + lane;
    int key = -1;
    if (s < s_end && mask[row + s]) {
      const int k = cidx[row + s];
      if (k >= 0 && k < local_budget) key = k;
    }
    const bool live = key >= 0;
    const int64_t src = live ? lo + widx[row + s] : 0;
    const float w = (W && live) ? ev[row + s] : 1.0f;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = 31 - __clz(heads & lanes_le);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    for (int f = 0; f < d; ++f) {
      float v = live ? values[src * d + f] : 0.0f;
      if (W) v *= w;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, v, off);
        if (lane - off >= seg) v += t;
      }
      if (tail && live) atomicAdd(slab + (int64_t)key * d + f, v);
    }
  }
}

// out: the identity (0) filled by the caller; eps read when fuse_epilogue
extern "C" int previous_fused_push(
    const float* values, const int32_t* widx, const int32_t* cidx,
    const float* ev, const uint8_t* mask, const int32_t* id_map,
    const float* eps, float* out, int64_t n, int64_t num_blocks,
    int64_t edge_budget, int64_t local_budget, int64_t block_size, int d,
    int fuse_epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = num_blocks * chunks;
  if (grid > 0x7fffffff || d < 1) return cudaErrorInvalidConfiguration;
  if (grid > 0) {
    if (ev != nullptr)
      push_global<true><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, id_map, out, n, edge_budget,
          local_budget, block_size, d, chunks);
    else
      push_global<false><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, id_map, out, n, edge_budget,
          local_budget, block_size, d, chunks);
  }
  const int64_t count = n * d;
  if (fuse_epilogue && count > 0) {
    int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(out, count, eps);
  }
  return cudaGetLastError();
}

// out: the identity (0) filled by the caller; eps read when fuse_epilogue
extern "C" int previous_fused_pull(
    const float* values, const int32_t* widx, const int32_t* cidx,
    const float* ev, const uint8_t* mask, const int32_t* id_map,
    const float* eps, float* out, int64_t n, int64_t num_blocks,
    int64_t edge_budget, int64_t local_budget, int64_t block_size, int d,
    int fuse_epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = num_blocks * chunks;
  if (grid > 0x7fffffff || d < 1) return cudaErrorInvalidConfiguration;
  if (grid > 0) {
    if (ev != nullptr)
      pull_kernel<true><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, id_map, out, n, edge_budget,
          local_budget, block_size, d, chunks);
    else
      pull_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, id_map, out, n, edge_budget,
          local_budget, block_size, d, chunks);
  }
  const int64_t count = n * d;
  if (fuse_epilogue && count > 0) {
    int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(out, count, eps);
  }
  return cudaGetLastError();
}

// out: zero-filled by the caller
extern "C" int previous_tocab_spmm(
    const float* values, const int32_t* widx, const int32_t* cidx,
    const float* ev, const uint8_t* mask, const int32_t* block_ids,
    float* out, int64_t num_ids, int64_t num_blocks, int64_t edge_budget,
    int64_t block_size, int64_t local_budget, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = num_ids * chunks;
  if (grid > 0x7fffffff || d < 1) return cudaErrorInvalidConfiguration;
  if (grid > 0 && local_budget > 0) {
    if (ev != nullptr)
      spmm_kernel<true><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, block_ids, out, num_blocks,
          edge_budget, block_size, local_budget, d, chunks);
    else
      spmm_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, block_ids, out, num_blocks,
          edge_budget, block_size, local_budget, d, chunks);
  }
  return cudaGetLastError();
}
"""

_POLICIES = (
    ('asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));',
     'asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));'),
    ('asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));',
     'asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));'),
)


def _edit(src: str, edits) -> str:
    """Each ``(old, new)`` replaces the first ``old``; ``(old, new, 0)``
    replaces every one."""
    for old, new, *every in edits:
        if old not in src:
            raise SystemExit(f"the source no longer has {old[:60]!r}")
        src = src.replace(old, new, -1 if every else 1)
    return src


_CHUNK = "constexpr int64_t kWarpSlots = 2048;"
_GRID = "const int64_t grid = ctas_needed < resident ? ctas_needed : resident;"
_STREAM_LD = ("ld.global.nc.L1::no_allocate.L2::cache_hint",
              "ld.global.nc.L2::cache_hint", 0)


def _steps(src: str, u: int) -> str:
    old = next(line for line in src.splitlines()
               if line.startswith("constexpr int kSteps = "))
    return _edit(src, ((old, f"constexpr int kSteps = {u};"
                        + old[old.index(";") + 1:]),))


# push's combining kernel with counters: edges reduced in the table, edges
# sent to L2, table entries flushed to L2
_COUNT_EDITS = (
    ("namespace {\n",
     "__device__ unsigned long long g_counts[3];\n"
     "extern \"C\" int counts_read(unsigned long long* h) {\n"
     "  return cudaMemcpyFromSymbol(h, g_counts, 24);\n}\n"
     "extern \"C\" int counts_reset() {\n"
     "  unsigned long long z[3] = {0, 0, 0};\n"
     "  return cudaMemcpyToSymbol(g_counts, z, 24);\n}\n"
     "namespace {\n"),
    ("  int* tkey = table;\n",
     "  int* tkey = table;\n"
     "  unsigned long long c_hit = 0, c_red = 0, c_flush = 0;\n"),
    ("          atomic_reduce<R>(&tval[h], x);\n        else\n",
     "          atomic_reduce<R>(&tval[h], x), ++c_hit;\n        else\n"),
    ("          red_global<R>(win + w[u], x, pol_window);\n      }\n",
     "          red_global<R>(win + w[u], x, pol_window), ++c_red;\n"
     "      }\n"),
    ("        red_global<R>(out + tb * block_size + k, tval[i], pol_window);\n",
     "        red_global<R>(out + tb * block_size + k, tval[i], pol_window);\n"
     "        ++c_flush;\n"),
    ("  if (held_b >= 0) flush(held_b);\n}",
     "  if (held_b >= 0) flush(held_b);\n"
     "  atomicAdd(&g_counts[0], c_hit);\n"
     "  atomicAdd(&g_counts[1], c_red);\n"
     "  atomicAdd(&g_counts[2], c_flush);\n}"),
)


# fused_pull's streaming kernel without the run carry: every step's last
# run is emitted at the step
_NO_CARRY = (
    ("const bool tail = lane < 31 && ((heads >> (lane + 1)) & 1u);",
     "const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);"),
    ("carry_key = __shfl_sync(kFull, k, 31);", "carry_key = -1;"),
)
# fused_pull's d > 1 route taken by the streaming kernel too
_PULL_ROUTE = ("  if (a.d > 1) return launch_rows<R, M>(a, st);\n", "")
# fused_pull's streaming kernel on a persistent grid: as many CTAs as are
# resident, each warp walking the chunks with a static stride
_PULL_PERSISTENT = (
    "  const int64_t grid = (total + kWarps - 1) / kWarps;  // a chunk a warp\n",
    "  int dev = 0, sms = 0, per_sm = 0;\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
    "      &per_sm, fused_pull_stream<R, M>, kThreads, 0);\n"
    "  const int64_t needed = (total + kWarps - 1) / kWarps;\n"
    "  const int64_t resident = (int64_t)sms * per_sm;\n"
    "  const int64_t grid = needed < resident ? needed : resident;\n")
_PULL_CHUNK = "constexpr int64_t kWarpSlots = 512; "


def variants(src: str, kernel: str) -> dict:
    """The source and its one-edit variants (the module docstring lists
    them)."""
    out = {"as_is": src}
    if kernel == "fused_pull":
        out.update({
            "steps1": _steps(src, 1),
            "steps2": _steps(src, 2),
            "steps8": _steps(src, 8),
            "window_no_l1": _edit(src, ((
                "ld.global.nc.L2::cache_hint.f32 %0",
                "ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0"),)),
            "window_normal": _edit(src, _POLICIES[1:]),
            "streams_normal": _edit(src, _POLICIES[:1]),
            "streams_l1": _edit(src, (_STREAM_LD,)),
            "no_carry": _edit(src, _NO_CARRY),
            "persistent": _edit(src, (_PULL_PERSISTENT,)),
            "chunk2048": _edit(src, ((_PULL_CHUNK, "constexpr int64_t "
                                      "kWarpSlots = 2048;"),)),
            "stream_all_d": _edit(src, (_PULL_ROUTE,)),
        })
    elif kernel == "fused_push":
        table = "constexpr int kTable = 28672;"
        thr = "constexpr int kCombineThreads = 1024;"
        out.update({
            "table8192": _edit(src, ((table, table.replace("28672",
                                                           "8192")),)),
            "table16384": _edit(src, ((table, table.replace("28672",
                                                            "16384")),)),
            "threads256_table4096": _edit(src, (
                (thr, thr.replace("1024", "256")),
                (table, table.replace("28672", "4096")))),
            "steps8": _steps(src, 8),
            "counted": _edit(src, _COUNT_EDITS),
        })
    else:
        out.update({
            "steps2": _steps(src, 2),
            "steps8": _steps(src, 8),
            "chunk512": _edit(src, ((_CHUNK, "constexpr int64_t kWarpSlots = "
                                     "512;"),)),
            "chunk8192": _edit(src, ((_CHUNK, "constexpr int64_t kWarpSlots "
                                      "= 8192;"),)),
            "nonpersistent": _edit(src, ((_GRID, "const int64_t grid = "
                                          "ctas_needed;"),)),
            "streams_l1": _edit(src, (_STREAM_LD,)),
            "window_normal": _edit(src, _POLICIES[1:]),
            "window_no_l1": _edit(src, ((
                "ld.global.nc.L2::cache_hint.f32 %0",
                "ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0"),)),
        })
    return out


def registers(log: str) -> dict:
    """``{kernel entry: registers}`` from ``-Xptxas=-v`` output, for the
    persistent kernels."""
    regs, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry:
            if "stream" in entry or "combine" in entry:
                regs[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    return regs


def emit(record: dict, out):
    line = json.dumps(record)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def start_build(jobs: dict, workdir: Path) -> dict:
    """Start compiling ``{name: source text}`` into ``workdir``, one
    ``nvcc`` each, all at once; :func:`finish_build` waits for them."""
    from repro_torch.kernels import cuda_build

    nvcc = cuda_build._nvcc()
    procs = {}
    for name, text in jobs.items():
        src = workdir / f"{name}.cu"
        src.write_text(text)
        lib = workdir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build._NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(procs: dict, logs: dict = None) -> dict:
    """``{name: library path}`` once every build of :func:`start_build` has
    finished (each compiler's output into ``logs``); raises if one
    failed."""
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if logs is not None:
            logs[name] = text
        if proc.returncode:
            failed.append(f"{name}:\n{text}")
        libs[name] = lib
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


class Floors:
    """The floor probes (``PROBE_SRC``), loaded from a built library: each
    call launches its probe on the current stream and returns its mean
    time in ms over ``reps`` launches (CUDA events, one warm-up)."""

    def __init__(self, path: Path):
        P, I64, I32, U32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_uint32)
        lib = ctypes.CDLL(str(path))
        lib.probe_red.argtypes = [P, U32, I64, I32, I32, P]
        lib.probe_gather.argtypes = [P, U32, I64, P, I32, I32, P]
        lib.probe_streams.argtypes = [P, P, P, I64, P, I32, P]
        lib.probe_slots.argtypes = [P, P, P, I64, P, P, I32, I32, P]
        for fn in (lib.probe_red, lib.probe_gather, lib.probe_streams,
                   lib.probe_slots):
            fn.restype = I32
        self.lib = lib

    @staticmethod
    def _setup():
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return torch.cuda.current_stream().cuda_stream, sms * 8

    def _time(self, fn, reps: int) -> float:
        import torch

        def call():
            rc = fn()
            if rc:
                raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        call()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def red(self, elems: int, count: int, hint: bool, reps: int = 5
            ) -> float:
        """``count`` random fp32 REDs into an array of ``elems`` floats."""
        import torch

        stream, grid = self._setup()
        arr = torch.zeros(elems, device="cuda")
        return self._time(lambda: self.lib.probe_red(
            arr.data_ptr(), elems, count, int(hint), grid, stream), reps)

    def gather(self, elems: int, count: int, hint: bool, reps: int = 5
               ) -> float:
        """``count`` random 4-byte reads from an array of ``elems``
        floats."""
        import torch

        stream, grid = self._setup()
        arr = torch.zeros(elems, device="cuda")
        sink = torch.zeros(4, device="cuda")
        return self._time(lambda: self.lib.probe_gather(
            arr.data_ptr(), elems, count, sink.data_ptr(), int(hint), grid,
            stream), reps)

    def slots(self, widx, cidx, mask, windows, red: bool,
              reps: int = 5) -> float:
        """The slabs ``widx``/``cidx``/``mask`` (one row a block) read mask
        first, and per real slot a RED into (``red``) or a gather from the
        row's window ``windows[row]`` at ``widx``: one launch a row."""
        stream, grid = self._setup()
        sink = windows[0].new_zeros(4)
        rows = list(zip(widx, cidx, mask, windows))

        def run():
            for w, c, k, win in rows:
                rc = self.lib.probe_slots(
                    w.data_ptr(), c.data_ptr(), k.data_ptr(), w.numel(),
                    win.data_ptr(), sink.data_ptr(), 0 if red else 1, grid,
                    stream)
                if rc:
                    return rc
            return 0
        return self._time(run, reps)

    def streams(self, widx, cidx, mask, reps: int = 5) -> float:
        """``widx``, ``cidx`` (int32) and ``mask`` (bool) read once, in
        16-byte loads; their element count must be a multiple of 4."""
        import torch

        stream, grid = self._setup()
        if widx.numel() % 4:
            raise ValueError("the slabs' size must be a multiple of 4")
        sink = torch.zeros(4, dtype=torch.int32, device="cuda")
        return self._time(lambda: self.lib.probe_streams(
            widx.data_ptr(), cidx.data_ptr(), mask.data_ptr(),
            widx.numel() // 4, sink.data_ptr(), grid, stream), reps)


class Previous:
    """The earlier designs (``PREVIOUS_SRC``), loaded from a built library:
    each call takes the package's blocked layout and returns what the
    package's launcher returns for it (sum semiring, the global-window
    path)."""

    def __init__(self, path: Path):
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib = ctypes.CDLL(str(path))
        for fn in (lib.previous_fused_pull, lib.previous_fused_push):
            fn.argtypes = [P] * 8 + [I64] * 5 + [I32] * 2 + [P]
            fn.restype = I32
        lib.previous_tocab_spmm.argtypes = [P] * 7 + [I64] * 5 + [I32, P]
        lib.previous_tocab_spmm.restype = I32
        self.lib = lib

    @staticmethod
    def _check(rc: int, what: str):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def fused_pull(self, values, bg, edge_vals=None, epilogue=None):
        """``fused_pull_cuda(values, <bg's slabs>, edge_vals, ...,
        reduce="sum", epilogue=epilogue)`` on the earlier design."""
        return self._fused("fused_pull", values, bg, edge_vals, epilogue)

    def fused_push(self, values, bg, edge_vals=None, epilogue=None):
        """``fused_push_cuda(values, <bg's slabs>, edge_vals, ...,
        reduce="sum", epilogue=epilogue)`` on the earlier design."""
        return self._fused("fused_push", values, bg, edge_vals, epilogue)

    def _fused(self, name, values, bg, edge_vals, epilogue):
        import torch

        n, d = values.shape
        out = torch.zeros((n, d), dtype=torch.float32, device=values.device)
        eps = None if epilogue is None else torch.stack([
            torch.as_tensor(v, dtype=torch.float32,
                            device=values.device).reshape(())
            for v in epilogue])
        self._check(getattr(self.lib, f"previous_{name}")(
            values.data_ptr(), bg.window_idx.data_ptr(),
            bg.compact_idx.data_ptr(),
            None if edge_vals is None else edge_vals.data_ptr(),
            bg.edge_mask.data_ptr(), bg.id_map.data_ptr(),
            None if eps is None else eps.data_ptr(), out.data_ptr(), n,
            bg.num_blocks, bg.edge_budget, bg.local_budget, bg.block_size, d,
            int(eps is not None), torch.cuda.current_stream().cuda_stream),
            f"previous {name}")
        return out

    def tocab_spmm(self, values, window_idx, compact_idx, edge_mask,
                   edge_vals, block_ids, *, block_size: int,
                   local_budget: int):
        """``tocab_spmm_cuda`` (same arguments) on the earlier design."""
        import torch

        n, d = values.shape
        nb, eb = window_idx.shape
        k = block_ids.shape[0]
        out = torch.zeros((k, local_budget, d), dtype=torch.float32,
                          device=values.device)
        self._check(self.lib.previous_tocab_spmm(
            values.data_ptr(), window_idx.data_ptr(), compact_idx.data_ptr(),
            None if edge_vals is None else edge_vals.data_ptr(),
            edge_mask.data_ptr(), block_ids.data_ptr(), out.data_ptr(), k,
            nb, eb, block_size, local_budget, d,
            torch.cuda.current_stream().cuda_stream), "previous tocab_spmm")
        return out


def load_as(kernel: str, path: Path, signatures: dict) -> ctypes.CDLL:
    """Load a variant library and make the package's launcher for
    ``kernel`` use it (:data:`cuda_build._LIBS`)."""
    from repro_torch.kernels import cuda_build

    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    cuda_build._LIBS[kernel] = lib
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.core import (DeviceGraph, UNWEIGHTED, build_blocked,
                                  rmat_graph)
    from repro_torch.core.balance import BIN_DENSE, _compact_budget
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.tocab_fused import kernel as fk
    from repro_torch.kernels.tocab_fused.ref import (fused_pull_ref,
                                                     fused_push_ref)
    from repro_torch.kernels.tocab_spmm import kernel as sk
    from repro_torch.kernels.tocab_spmm.ref import tocab_spmm_ref

    out = args.out
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    emit({"card": card, "torch": torch.__version__}, out)

    # ---- builds: the package's sources, the probes, the variants ---- #
    t0 = time.perf_counter()
    cuda_build.build(["fused_pull", "fused_push", "tocab_spmm"])
    srcs = {name: cuda_build._source(name).read_text()
            for name in ("fused_pull", "fused_push", "tocab_spmm")}
    jobs = {"probe": PROBE_SRC, "previous": PREVIOUS_SRC}
    for kernel, text in srcs.items():
        for name, body in variants(text, kernel).items():
            jobs[f"{kernel}__{name}"] = body
    workdir = Path(tempfile.mkdtemp(prefix="graph_variants_"))
    logs = {}
    libs = finish_build(start_build(jobs, workdir), logs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "registers": {nm: registers(text) for nm, text in logs.items()
                        if nm != "probe"}}, out)
    floors = Floors(libs["probe"])
    previous = Previous(libs["previous"])

    # ---- the scale-24 graph and its layouts ---- #
    t0 = time.perf_counter()
    g = rmat_graph(args.scale, 16, seed=cs.SEED, weights=True)
    push = build_blocked(g, direction="push", bin_thresholds="auto")
    pull = build_blocked(g, direction="pull", bin_thresholds="auto")
    dg = DeviceGraph.from_host(g)
    n, m = g.n, g.m
    del g
    torch.cuda.synchronize()
    emit({"phase": "graph", "scale": args.scale, "n": n, "m": m,
          "block_size": push.block_size, "num_blocks": push.num_blocks,
          "edge_budget": {"push": push.edge_budget, "pull": pull.edge_budget},
          "seconds": time.perf_counter() - t0}, out)
    B = push.block_size

    # ---- floors ---- #
    for mult in (0.25, 0.5, 1.0, 2.0, 4.0):
        elems = int(B * mult)
        for hint in (False, True):
            red = floors.red(elems, m, hint)
            gat = floors.gather(elems, m, hint)
            emit({"phase": "floor", "array_mb": 4 * elems / 2 ** 20,
                  "of_window": mult, "ops": m, "l2_evict_last": hint,
                  "red_ms": red, "red_g_per_s": m / red / 1e6,
                  "gather_ms": gat, "gather_g_per_s": m / gat / 1e6}, out)
    dense = pull.schedule.blocks_in(BIN_DENSE)
    for what, bg, rows, red in (("push_layout", push, None, True),
                                ("pull_layout", pull, None, False),
                                ("dense_block", pull, dense, False)):
        w, c, k = bg.window_idx, bg.compact_idx, bg.edge_mask
        if rows is not None:
            sel = torch.tensor(rows, device="cuda")
            w, c, k = w[sel], c[sel], k[sel]
        ms = floors.streams(w, c, k)
        nbytes = 9 * w.numel()
        window = torch.rand(bg.num_blocks * B, device="cuda")
        blocks = range(bg.num_blocks) if rows is None else rows
        both = floors.slots(w, c, k, [window[b * B:] for b in blocks],
                            red=red)
        emit({"phase": "floor", "streams": what, "slots": w.numel(),
              "bytes": nbytes, "streams_ms": ms,
              "tb_per_s": nbytes / ms / 1e9,
              "streams_and_" + ("red" if red else "gather") + "_ms": both},
             out)
        del window

    # how far combining equal destinations could cut push's reductions:
    # distinct (range, destination) pairs over real slots, per slot range
    k0 = push.edge_mask[0]
    dst0 = push.window_idx[0].long()
    slot = torch.arange(dst0.numel(), device="cuda")
    deg = torch.bincount(dst0[k0], minlength=B)
    stats = {"block0_edges": int(k0.sum()),
             "block0_destinations": int((deg > 0).sum()),
             "edges_to_rows_of_in_degree_over_1000":
                 float((deg[dst0[k0]] > 1000).float().mean())}
    for bits in (12, 16, 20, 24):
        key = (slot >> bits) * B + dst0
        stats[f"distinct_share_per_{1 << bits}_slots"] = \
            torch.unique(key[k0]).numel() / int(k0.sum())
    emit({"phase": "push_destinations", **stats}, out)
    del k0, dst0, slot, deg, key

    # ---- yardsticks: the CSR products ---- #
    x = torch.rand(n, generator=torch.Generator().manual_seed(cs.SEED)).cuda()
    x2 = x[:, None]
    order = torch.sort(dg.dst, stable=True).indices
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(dg.dst, minlength=n), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a_t = torch.sparse_csr_tensor(crow, dg.src[order].long(),
                                      torch.ones(m, device="cuda"), (n, n),
                                      check_invariants=False)
    del order, crow
    emit({"phase": "yardstick", "name": "csr_matvec_whole",
          "ms": cs.cuda_ms(lambda: a_t @ x, reps=5)}, out)
    del a_t

    # ---- fused_pull and fused_push variants ---- #
    def fused_call(launch, bg, x):
        return lambda: launch(x, bg.window_idx, bg.compact_idx, None,
                              bg.edge_mask, bg.id_map, block_size=B,
                              reduce="sum")

    launchers = {"fused_pull": fk.fused_pull_cuda,
                 "fused_push": fk.fused_push_cuda}
    plains = {"fused_pull": fused_pull_ref, "fused_push": fused_push_ref}
    layouts = {"fused_pull": pull, "fused_push": push}
    for kernel in ("fused_pull", "fused_push"):
        bg = layouts[kernel]
        ref = plains[kernel](bg, x2, "sum", UNWEIGHTED)
        runs = [("previous", None,
                 lambda *a, bg=bg, k=kernel, **kw: getattr(previous, k)(x2,
                                                                        bg))]
        runs += [(name, libs[f"{kernel}__{name}"], launchers[kernel])
                 for name in variants(srcs[kernel], kernel)
                 if name != "stream_all_d"]  # the same kernel at d = 1
        for name, path, launch in runs:
            lib = (load_as(kernel, path, fk.signatures(kernel)) if path
                   else None)
            fn = fused_call(launch, bg, x2)
            ms = cs.cuda_ms(fn, reps=10, warmup=2)
            err, atol, used = cs.check_close(f"{kernel} {name}", fn(), ref,
                                             "sum")
            emit({"phase": "variant", "kernel": kernel, "variant": name,
                  "ms": ms, "max_abs_err": err, "tolerance_used": used}, out)
            if name == "counted":
                counts = (ctypes.c_uint64 * 3)()
                torch.cuda.synchronize()
                lib.counts_reset()
                fn()
                torch.cuda.synchronize()
                lib.counts_read(counts)
                emit({"phase": "push_counts", "reduced_in_table": counts[0],
                      "sent_to_l2": counts[1], "flushed": counts[2],
                      "reds_per_edge": (counts[1] + counts[2]) / m}, out)
        del ref
        cuda_build._LIBS.pop(kernel, None)

    # ---- tocab_spmm variants, the dense bin ---- #
    budget = _compact_budget(pull.schedule, BIN_DENSE, pull.local_budget)
    ids = torch.tensor(dense, dtype=torch.int32, device="cuda")
    sargs = (x2, pull.window_idx, pull.compact_idx, pull.edge_mask, None, ids)
    skw = dict(block_size=B, local_budget=budget)
    ref = tocab_spmm_ref(*sargs, **skw)
    sel = torch.tensor(dense, dtype=torch.long, device="cuda")
    mask = pull.edge_mask[sel]
    kk = len(dense)
    offs = torch.arange(kk, device="cuda")[:, None]
    rows = (pull.compact_idx[sel].long() + offs * budget)[mask]
    cols = (pull.window_idx[sel].long() + offs * B)[mask]
    del mask
    crow = torch.zeros(kk * budget + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=kk * budget), 0)
    del rows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, cols, torch.ones_like(
            cols, dtype=torch.float32), (kk * budget, kk * B),
            check_invariants=False)
    windows = torch.zeros(kk * B, device="cuda")
    for j, b in enumerate(dense):
        w = x[b * B: min((b + 1) * B, n)]
        windows[j * B: j * B + w.numel()] = w
    emit({"phase": "yardstick", "name": "csr_matvec_dense_block",
          "ms": cs.cuda_ms(lambda: a @ windows, reps=5)}, out)
    del a, cols, crow, windows
    runs = [("previous", None, previous.tocab_spmm)]
    runs += [(name, libs[f"tocab_spmm__{name}"], sk.tocab_spmm_cuda)
             for name in variants(srcs["tocab_spmm"], "tocab_spmm")]
    for name, path, launch in runs:
        if path is not None:
            load_as("tocab_spmm", path, sk._SIGNATURES)
        ms = cs.cuda_ms(lambda: launch(*sargs, **skw), reps=10, warmup=2)
        err, atol, used = cs.check_close(f"tocab_spmm {name}",
                                         launch(*sargs, **skw), ref, "sum")
        emit({"phase": "variant", "kernel": "tocab_spmm", "variant": name,
              "ms": ms, "max_abs_err": err, "tolerance_used": used}, out)
    cuda_build._LIBS.pop("tocab_spmm", None)
    del ref

    # d = 8, the other side of the kernels' d = 1 / d > 1 choice: the
    # package's sources as they are, and fused_pull's d > 1 route on its
    # streaming kernel (stream_all_d) in turns with it
    x8 = torch.rand((n, 8), generator=torch.Generator().manual_seed(
        cs.SEED)).cuda()
    pull8 = fused_pull_ref(pull, x8, "sum", UNWEIGHTED)
    runs = [("fused_pull", "as_is", fused_call(fk.fused_pull_cuda, pull, x8),
             pull8),
            ("fused_pull", "stream_all_d",
             fused_call(fk.fused_pull_cuda, pull, x8), pull8),
            ("fused_pull", "as_is", fused_call(fk.fused_pull_cuda, pull, x8),
             pull8),
            ("fused_pull", "stream_all_d",
             fused_call(fk.fused_pull_cuda, pull, x8), pull8),
            ("fused_push", "as_is", fused_call(fk.fused_push_cuda, push, x8),
             fused_push_ref(push, x8, "sum", UNWEIGHTED)),
            ("tocab_spmm", "as_is",
             lambda: sk.tocab_spmm_cuda(x8, *sargs[1:], **skw),
             tocab_spmm_ref(x8, *sargs[1:], **skw))]
    del pull8
    for kernel, name, fn, ref in runs:
        if kernel == "fused_pull":
            load_as(kernel, libs[f"fused_pull__{name}"],
                    fk.signatures(kernel))
        ms = cs.cuda_ms(fn, reps=5, warmup=1)
        err, atol, used = cs.check_close(f"{kernel} {name} d=8", fn(), ref,
                                         "sum")
        emit({"phase": "variant", "kernel": kernel, "d": 8,
              "variant": name, "ms": ms, "max_abs_err": err,
              "tolerance_used": used}, out)
    cuda_build._LIBS.pop("fused_pull", None)
    del x8, runs, ref

    emit({"phase": "done", "launches": dict(cuda_build.launches)}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
