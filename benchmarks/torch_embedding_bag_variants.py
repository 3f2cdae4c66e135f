#!/usr/bin/env python3
"""Floors and design variants of the port's ``embedding_bag`` kernel
(``src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu``), built
and timed side by side on one card at the main path's shapes: BERT4Rec's
1,000,002 × 64 fp32 item table (random from ``chip_smoke.SEED``) and bags of
200 cloze labels (``make_cloze_batch``, fp32 weights) at ``train_batch``
(65,536 bags) and ``serve_p99`` (512), weighted sum.

    python3 benchmarks/torch_embedding_bag_variants.py
        [--out embedding_bag_variants.jsonl]   # on the card

Floors (``PROBE_SRC``), each timed alone with CUDA events at each shape:

* ``streams`` — the ids (int32) and weights (fp32) read once, in 16-byte
  loads;
* ``gathers`` — the kernel's row reads summed without weights: a group of
  lanes a bag reads its ids and, per id, the row (16 bytes a lane), plain
  (``ld.global.nc``) and through L1 with an L2 evict-last hint.  What L1
  and L2 give this id stream, ids included.

Variants: the source with one edit, made in a temporary directory (the
repository's file is not touched), built with the loader's ``nvcc`` flags
and called through the package's own launcher:

* ``previous`` — the earlier kernel (``PREVIOUS_SRC``, verbatim: one bag a
  lane group, no cache hints, no split, 64-bit ids broadcast);
* ``as_is`` — the source (timed first and last);
* the streams' cache policy: ``streams_l1`` (ids and weights through L1),
  ``streams_normal`` (their L2 policy evict-normal);
* the table's: ``table_normal`` (rows L2 evict-normal), ``table_no_l1``
  (rows without L1 allocation), ``l1_default`` (the groups kernels with
  the default carveout, not the largest L1), ``split_l1`` (the split
  kernel at the largest L1);
* the bag split: ``no_split`` (few bags take the groups route too),
  ``split_all`` (many bags take the split route too), ``split_lanes8``
  (8 lanes a group on the split route, 16 as is);
* the main constant: ``rows4`` / ``rows16`` (row loads in flight a lane,
  8 as is); and ``keys64`` (int32 ids broadcast as 64-bit keys, as the
  earlier kernel did).

Every variant is held against the plain version at both shapes
(``chip_smoke.py``'s fp32 tolerance, rtol = atol = 2e-5); its ms per call
(CUDA events over back-to-back host calls) and device ms (20 calls in a
CUDA graph, replayed) are reported beside the route each shape took,
with ``F.embedding_bag`` as the yardstick.  One JSON line per
measurement, after the card's name and power limit; the same lines go to
``--out``.  Fails if there is no card, or if the source no longer has the
text an edit targets.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the earlier kernel, verbatim: timed beside the source as ``previous_ms``
PREVIOUS_SRC = r"""
// EmbeddingBag for NVIDIA Hopper (sm_90a), with a plain C interface:
//   out[b, :] = sum over l < L of w[b, l] * table[idx[b, l], :]
// where an id outside [0, V) contributes nothing and its row is never read.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas /
// _kernel — the TPU kernel behind embedding_bag(backend="pallas")
// (src/repro/kernels/embedding_bag/ops.py).
//
// Design.  The Pallas kernel walks a (bag tiles x table row blocks) grid: it
// pins 4096 table rows in VMEM, rescans every bag's index list once per row
// block and accumulates the output tile across blocks, so every table read
// hits VMEM.  That needs an ordered grid and a row block per step; here CTAs
// run in no order and the H100's 50 MB L2 already keeps hot rows on chip.
// So each bag is owned by a group of G lanes of one warp, G the power of two
// that covers the row in 16-byte chunks (G = 16 for a d = 64 fp32 row, two
// bags a warp), and the group reads each of its rows in place:
//   - the group's lanes load G of the bag's ids and weights at a time
//     (coalesced) and broadcast them with __shfl_sync;
//   - U rows are loaded before any is added, so U row loads per lane are in
//     flight;
//   - the bag accumulates in fp32 registers in the fixed order l = 0..L-1
//     and writes its output row once, in the table's dtype.
// No atomics and no shared memory: the result is bit-reproducible from run
// to run.  A row wider than one group's tile (G * VEC * NCH columns) is cut
// into column tiles along gridDim.y.  Rows whose width is not a whole number
// of 16-byte chunks (or tables not 16-byte aligned) take the scalar path,
// one element per load.
//
// Bound.  Bytes: each distinct row the bags touch, the ids and weights once,
// the output once; 2 flops per element of each gathered row.  Far below the
// card's flops per byte: memory bound.  The gathers are random 16-byte-chunk
// rows, so what the kernel reaches depends on how many rows L2 serves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// VEC elements of T moved by one load and converted to fp32 and back.
template <typename T, int VEC>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static void to_float(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ __forceinline__ static Raw from_float(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Chunk<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static void to_float(const Raw& r, float* f) {
    f[0] = r;
  }
  __device__ __forceinline__ static Raw from_float(const float* f) {
    return f[0];
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static void to_float(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static Raw from_float(const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ __forceinline__ static void to_float(const Raw& r, float* f) {
    f[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ __forceinline__ static Raw from_float(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16(f[0]));
  }
};

// T: table and output type; I: id type; VEC: elements per load; NCH: loads
// per lane per row (a column tile is G * VEC * NCH wide).  G (lanes per bag,
// a power of two <= 32) is a runtime argument.
template <typename T, typename I, int VEC, int NCH>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                     const float* __restrict__ w, float w_const,
                     T* __restrict__ out, int64_t B, int64_t L, int64_t V,
                     int d, int G) {
  using C = Chunk<T, VEC>;
  using Raw = typename C::Raw;
  constexpr int U = 8 / NCH;  // rows in flight per lane
  const int r = threadIdx.x & (G - 1);  // rank in the bag's group
  const int64_t bag = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
  const bool active = bag < B;
  const int col0 = blockIdx.y * G * VEC * NCH;
  int col[NCH];
  bool col_ok[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    col[k] = col0 + (k * G + r) * VEC;
    col_ok[k] = active && col[k] < d;  // VEC divides d: the chunk is whole
  }
  float acc[NCH][VEC];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.0f;

  const int64_t row0 = (active ? bag : 0) * L;
  // every lane of the warp runs the same trip counts (L is shared by all
  // bags), so the full-mask shuffles below are well defined
  for (int64_t l0 = 0; l0 < L; l0 += G) {
    const int n = (int)(L - l0 < G ? L - l0 : G);
    long long my_id = -1;
    float my_w = 0.0f;
    if (active && r < n) {
      my_id = (long long)idx[row0 + l0 + r];
      my_w = w != nullptr ? w[row0 + l0 + r] : w_const;
    }
    for (int j0 = 0; j0 < n; j0 += U) {
      long long id[U];
      float wt[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = (j0 + u) & (G - 1);
        id[u] = __shfl_sync(kFull, my_id, src, G);
        wt[u] = __shfl_sync(kFull, my_w, src, G);
        ok[u] = j0 + u < n && id[u] >= 0 && id[u] < V;
      }
      Raw raw[U][NCH];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          if (ok[u] && col_ok[k])
            raw[u][k] = *reinterpret_cast<const Raw*>(
                table + id[u] * (int64_t)d + col[k]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if (!col_ok[k]) continue;
          float f[VEC];
          C::to_float(raw[u][k], f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] = fmaf(wt[u], f[e], acc[k][e]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    if (col_ok[k])
      *reinterpret_cast<Raw*>(out + bag * (int64_t)d + col[k]) =
          C::from_float(acc[k]);
}

template <typename T, typename I, int VEC>
cudaError_t launch(const void* table, const void* idx, const float* w,
                   float w_const, void* out, int64_t B, int64_t L, int64_t V,
                   int d, cudaStream_t st) {
  const int chunks = d / VEC;
  int G = 32, nch = 4;
  if (chunks <= 32) {
    nch = 1;
    G = 1;
    while (G < chunks) G <<= 1;
  } else if (chunks <= 64) {
    nch = 2;
  }
  const int64_t tile = (int64_t)G * VEC * nch;
  const int64_t tiles = (d + tile - 1) / tile;
  const int64_t bags_per_cta = kThreads / G;
  const int64_t ctas = (B + bags_per_cta - 1) / bags_per_cta;
  if (ctas > 0x7fffffff || tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)ctas, (unsigned)tiles);
  const T* t = static_cast<const T*>(table);
  const I* ix = static_cast<const I*>(idx);
  T* o = static_cast<T*>(out);
  if (nch == 1)
    embedding_bag_kernel<T, I, VEC, 1><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, G);
  else if (nch == 2)
    embedding_bag_kernel<T, I, VEC, 2><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, G);
  else
    embedding_bag_kernel<T, I, VEC, 4><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, G);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t dispatch(const void* table, const void* idx, const float* w,
                     float w_const, void* out, int64_t B, int64_t L,
                     int64_t V, int d, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  return vec ? launch<T, I, kVec>(table, idx, w, w_const, out, B, L, V, d, st)
             : launch<T, I, 1>(table, idx, w, w_const, out, B, L, V, d, st);
}

}  // namespace

// table (V, d) of dtype (0: fp32, 1: bf16); idx (B, L) of int32 (idx64 = 0)
// or int64 (idx64 = 1); w (B, L) fp32, or null for every weight = w_const;
// out (B, d) of the table's dtype, every entry written.  All contiguous, on
// one device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int embedding_bag(const void* table, const void* idx,
                             const float* w, float w_const, void* out,
                             int64_t B, int64_t L, int64_t V, int d,
                             int dtype, int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 0 || L < 0 || V < 0 || d < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaGetLastError();
  if (dtype == 0)
    return idx64 ? dispatch<float, int64_t>(table, idx, w, w_const, out, B, L, V, d, st)
                 : dispatch<float, int32_t>(table, idx, w, w_const, out, B, L, V, d, st);
  return idx64
      ? dispatch<__nv_bfloat16, int64_t>(table, idx, w, w_const, out, B, L, V, d, st)
      : dispatch<__nv_bfloat16, int32_t>(table, idx, w, w_const, out, B, L, V, d, st);
}

extern "C" const char* embedding_bag_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

constexpr int kBatch = 8;  // loads in flight a thread

// ids and weights, n4 16-byte chunks of each, read once
__global__ void streams_probe(const int4* ids, const float4* w, int64_t n4,
                              float* sink) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int acc_i = 0;
  float acc_f = 0.0f;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n4;
       i0 += stride * kBatch) {
    int4 a[kBatch];
    float4 b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t i = i0 + u * stride;
      a[u] = i < n4 ? __ldg(ids + i) : make_int4(0, 0, 0, 0);
      b[u] = i < n4 ? __ldg(w + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      acc_i += a[u].x + a[u].y + a[u].z + a[u].w;
      acc_f += b[u].x + b[u].y + b[u].z + b[u].w;
    }
  }
  if (acc_f == 1.25f && acc_i == 7) sink[0] = acc_f;  // keeps the loads
}

// per bag, a group of G lanes reads its ids (every lane each id) and per
// id 16 bytes a lane of the row: the kernel's gathers without weights
template <bool HINT>
__global__ void gathers_probe(const float4* table, const int* ids, int64_t B,
                              int64_t L, int d4, int G, float* sink) {
  const uint64_t pol = evict_last();
  const int r = threadIdx.x & (G - 1);
  const int64_t groups = (int64_t)gridDim.x * blockDim.x / G;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t bag = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
       bag < B; bag += groups) {
    const int* row = ids + bag * L;
    for (int64_t l0 = 0; l0 < L; l0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l0 + u < L && r < d4) {
          const float4* p = table + (int64_t)__ldg(row + l0 + u) * d4 + r;
          if (HINT)
            asm volatile(
                "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
                : "l"(p), "l"(pol));
          else
            v[u] = __ldg(p);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        acc.x += v[u].x; acc.y += v[u].y; acc.z += v[u].z; acc.w += v[u].w;
      }
    }
  }
  if (acc.x + acc.y + acc.z + acc.w == 1.25f) sink[0] = acc.x;
}

extern "C" int probe_streams(const void* ids, const void* w, int64_t n4,
                             void* sink, int grid, void* stream) {
  streams_probe<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)ids, (const float4*)w, n4, (float*)sink);
  return cudaGetLastError();
}

// table (V, d) fp32, d a multiple of 4 and at most 128; ids (B, L) int32
extern "C" int probe_gathers(const void* table, const void* ids, int64_t B,
                             int64_t L, int d, void* sink, int hint, int grid,
                             void* stream) {
  const int d4 = d / 4;
  int G = 1;
  while (G < d4) G <<= 1;
  if (d % 4 || G > 32) return cudaErrorInvalidValue;
  if (hint)
    gathers_probe<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)ids, B, L, d4, G, (float*)sink);
  else
    gathers_probe<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)ids, B, L, d4, G, (float*)sink);
  return cudaGetLastError();
}
"""


def _edit(src: str, edits) -> str:
    """Each ``(old, new)`` replaces the first ``old``; ``(old, new, 0)``
    replaces every one.  Raises if the source has no ``old``."""
    for old, new, *every in edits:
        if old not in src:
            raise SystemExit(f"the source no longer has {old[:60]!r}")
        src = src.replace(old, new, -1 if every else 1)
    return src


def _constant(name: str, old: str, new: str):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


_POLICY = 'asm("createpolicy.fractional.L2::{}.b64 %0, 1.0;" : "=l"(p));'
_SPLIT_LAUNCH = "  if (p.route == kRouteSplit) {\n"
_KEY = ("using K = typename std::conditional<sizeof(I) == 4, int32_t, "
        "int64_t>::type;")


def variants(src: str) -> dict:
    """The source and its one-edit variants (the module docstring lists
    them)."""
    return {
        "as_is": src,
        "streams_l1": _edit(src, (
            ("ld.global.nc.L1::no_allocate.L2::cache_hint",
             "ld.global.nc.L2::cache_hint", 0),)),
        "streams_normal": _edit(src, ((_POLICY.format("evict_first"),
                                       _POLICY.format("evict_normal")),)),
        "table_normal": _edit(src, ((_POLICY.format("evict_last"),
                                     _POLICY.format("evict_normal")),)),
        "table_no_l1": _edit(src, (
            ("ld.global.nc.L2::cache_hint.v4",
             "ld.global.nc.L1::no_allocate.L2::cache_hint.v4", 0),)),
        "l1_default": _edit(src, (("(int)cudaSharedmemCarveoutMaxL1",
                                   "(int)cudaSharedmemCarveoutDefault"),)),
        "split_l1": _edit(src, ((_SPLIT_LAUNCH, _SPLIT_LAUNCH +
                                 "    err = cudaFuncSetAttribute(\n"
                                 "        bag_split<T, I, K, VEC>,\n"
                                 "        cudaFuncAttributePreferredShared"
                                 "MemoryCarveout,\n"
                                 "        (int)cudaSharedmemCarveoutMaxL1);\n"
                                 "    if (err != cudaSuccess) return err;\n"),)),
        "no_split": _edit(src, (_constant("kSplitWarpsPerSm", "16", "0"),)),
        "split_all": _edit(src, (_constant("kSplitWarpsPerSm", "16",
                                           "1 << 20"),)),
        "split_lanes8": _edit(src, (_constant("kSplitLanes", "16", "8"),)),
        "rows4": _edit(src, (_constant("kRowsInFlight", "8", "4"),)),
        "rows16": _edit(src, (_constant("kRowsInFlight", "8", "16"),)),
        "keys64": _edit(src, ((_KEY, "using K = int64_t;"),)),
    }


def _event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` (which returns a CUDA error code) over ``reps``
    launches after one warm-up (CUDA events)."""
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


class Probes:
    """The floor probes (``PROBE_SRC``), loaded from a built library: each
    call launches its probe on the current stream and returns its mean
    time in ms over ``reps`` launches."""

    def __init__(self, path: Path):
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib = ctypes.CDLL(str(path))
        lib.probe_streams.argtypes = [P, P, I64, P, I32, P]
        lib.probe_gathers.argtypes = [P, P, I64, I64, I32, P, I32, I32, P]
        lib.probe_streams.restype = lib.probe_gathers.restype = I32
        self.lib = lib

    @staticmethod
    def _setup():
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sink = torch.zeros(4, device="cuda")
        return torch.cuda.current_stream().cuda_stream, sms * 8, sink

    def streams(self, ids, w, reps: int = 20) -> float:
        """int32 ``ids`` and fp32 ``w`` (same element count, a multiple of
        4) read once."""
        stream, grid, sink = self._setup()
        if ids.numel() % 4 or ids.numel() != w.numel():
            raise ValueError("ids and weights: one count, a multiple of 4")
        return _event_ms(lambda: self.lib.probe_streams(
            ids.data_ptr(), w.data_ptr(), ids.numel() // 4, sink.data_ptr(),
            grid, stream), reps)

    def gathers(self, table, ids, hint: bool, reps: int = 20) -> float:
        """The rows of fp32 ``table`` that int32 ``ids`` (B, L) name,
        summed per lane without weights."""
        stream, grid, sink = self._setup()
        B, L = ids.shape
        return _event_ms(lambda: self.lib.probe_gathers(
            table.data_ptr(), ids.data_ptr(), B, L, table.shape[1],
            sink.data_ptr(), int(hint), grid, stream), reps)


class Previous:
    """The earlier kernel (``PREVIOUS_SRC``), loaded from a built library:
    ``previous(table, ids, weights)`` returns what
    ``embedding_bag_cuda(table, ids, weights)`` returns for it."""

    def __init__(self, path: Path):
        from repro_torch.kernels.embedding_bag import kernel

        lib = ctypes.CDLL(str(path))
        for fn in ("embedding_bag", "embedding_bag_error"):
            argtypes, restype = kernel._SIGNATURES[fn]
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        self.lib = lib

    def __call__(self, table, ids, weights=None, *, weight: float = 1.0):
        import torch

        from repro_torch.kernels.embedding_bag.kernel import (DTYPES,
                                                              ID_DTYPES)

        (V, d), (B, L) = table.shape, ids.shape
        out = torch.empty((B, d), dtype=table.dtype, device=table.device)
        rc = self.lib.embedding_bag(
            table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), weight,
            out.data_ptr(), B, L, V, d, DTYPES[table.dtype],
            ID_DTYPES[ids.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            msg = self.lib.embedding_bag_error(rc).decode()
            raise RuntimeError(f"previous embedding_bag: CUDA error {rc} "
                               f"({msg})")
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from benchmarks.torch_graph_kernel_variants import (emit, finish_build,
                                                        load_as, start_build)
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import make_cloze_batch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    from repro_torch.kernels.embedding_bag import kernel as ek

    out = args.out
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    emit({"card": card, "torch": torch.__version__}, out)

    # ---- builds: the probes, the earlier kernel, the variants ---- #
    t0 = time.perf_counter()
    src = cuda_build._source("embedding_bag").read_text()
    jobs = {"probe": PROBE_SRC, "previous": PREVIOUS_SRC}
    jobs.update({f"embedding_bag__{name}": body
                 for name, body in variants(src).items()})
    workdir = Path(tempfile.mkdtemp(prefix="embedding_bag_variants_"))
    libs = finish_build(start_build(jobs, workdir))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(libs)}, out)
    probes = Probes(libs["probe"])
    previous = Previous(libs["previous"])

    # ---- the main path's table and bags ---- #
    cfg = get_arch("bert4rec").make_model_cfg()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    table = torch.randn((cfg.table_size, cfg.d_model), generator=gen,
                        device="cuda") * 0.02
    rng = np.random.default_rng(cs.SEED)
    shapes = {}
    for c in get_arch("bert4rec").shapes:
        if c.name in ("train_batch", "serve_p99"):
            ids = make_cloze_batch(rng, c.batch, cfg.max_len, cfg.vocab,
                                   cfg.mask_id, device="cuda")["labels"]
            w = torch.from_numpy(rng.random((c.batch, cfg.max_len),
                                            dtype=np.float32)).cuda()
            shapes[c.name] = (ids, w, embedding_bag_ref(table, ids, w))

    # ---- floors and the yardstick ---- #
    for name, (ids, w, _) in shapes.items():
        ids64 = ids.long()
        emit({"phase": "floor", "shape": name, "slots": ids.numel(),
              "streams_ms": probes.streams(ids, w),
              "gathers_ms": probes.gathers(table, ids, hint=False),
              "gathers_l2_evict_last_ms": probes.gathers(table, ids,
                                                         hint=True),
              "library_ms": cs.cuda_ms(lambda: F.embedding_bag(
                  ids64, table, per_sample_weights=w, mode="sum"), reps=20,
                  warmup=2),
              "library_device_ms": cs.graph_ms(lambda: F.embedding_bag(
                  ids64, table, per_sample_weights=w, mode="sum"))}, out)
        del ids64

    # ---- the variants, in turns with as_is and previous ---- #
    names = list(variants(src))
    runs = ["previous"] + names + ["as_is", "previous"]
    for name in runs:
        if name != "previous":
            load_as("embedding_bag", libs[f"embedding_bag__{name}"],
                    ek._SIGNATURES)
        for shape, (ids, w, ref) in shapes.items():
            if name == "previous":
                fn = lambda ids=ids, w=w: previous(table, ids, w)
            else:
                fn = lambda ids=ids, w=w: ek.embedding_bag_cuda(table, ids, w)
            before = dict(ek.routes)
            got = fn()
            route = [r for r in ek.ROUTES if ek.routes[r] != before.get(r, 0)]
            err, share, _, _ = cs.tol_share(got, ref)
            if not share <= 1.0:
                raise AssertionError(f"embedding_bag {name} at {shape}: "
                                     f"max_abs_err {err} is {share:.3g}× "
                                     "the tolerance")
            if not torch.equal(got, fn()):
                raise AssertionError(f"embedding_bag {name} at {shape}: two "
                                     "launches differ")
            emit({"phase": "variant", "variant": name, "shape": shape,
                  "design": route[0] if route else "previous",
                  "ms": cs.cuda_ms(fn, reps=20, warmup=2),
                  "device_ms": cs.graph_ms(fn), "max_abs_err": err,
                  "tolerance_used": share}, out)
        cuda_build._LIBS.pop("embedding_bag", None)

    emit({"phase": "done", "launches": dict(cuda_build.launches),
          "routes": dict(ek.routes)}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
