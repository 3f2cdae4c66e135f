// EmbeddingBag for NVIDIA Hopper (sm_90a), with a plain C interface:
//   out[b, :] = sum over l < L of w[b, l] * table[idx[b, l], :]
// where an id outside [0, V) contributes nothing and its row is never read.
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas /
// _kernel — the TPU kernel behind embedding_bag(backend="pallas")
// (src/repro/kernels/embedding_bag/ops.py).
//
// The Pallas kernel walks a (bag tiles x table row blocks) grid: it pins
// 4096 table rows in VMEM, rescans every bag's index list once per row
// block and accumulates the output tile across blocks.  That needs an
// ordered grid; here CTAs run in no order.  Every design below gives a bag
// (or a part of one) to a group of G lanes of one warp, G the power of two
// that covers the row in 16-byte chunks: the lanes load G of the bag's ids
// and weights at a time (coalesced), broadcast them with __shfl_sync, keep
// U = 8 row loads a lane in flight and add in fp32 registers in the fixed
// order of l.  No atomics touch the output: repeats are bit-identical.
//
// Bound.  Bytes: each distinct row the bags touch, the ids and weights once,
// the output once; 2 flops per gathered element, far below the card's flops
// per byte.  But the rows are gathered once per slot (13.1 M rows of 256 B
// at BERT4Rec's train_batch, 3.4 GB, of which 304 K rows are distinct): what
// the kernel reaches is set by how many gathers L1 serves, and how fast L2
// serves the rest.
//
// Routes, chosen in C from B, d and the SM count (make_plan):
//   - split (few bags: the groups design would give the card fewer than
//     kSplitWarpsPerSm warps an SM, e.g. serve_p99's 512 bags fill 256
//     warps of 132 SMs).  One CTA per bag and column tile of at most
//     kSplitLanes chunks; its S groups each take a contiguous l-range of
//     about L / S ids, and group 0 adds the parts through shared memory
//     in the fixed order of the parts.  512 bags of d = 64 fp32 fill 512
//     CTAs of 16 groups, each group two batches of U rows; groups of 8
//     lanes (1024 CTAs of 32 half-row groups, one batch each) read 1.3x
//     the device time on an H100.
//   - groups (many bags): one bag a group, a row wider than one group's
//     tile cut into column tiles along gridDim.y.  The hot rows stay on
//     chip in L1: the ids and weights stream past it (L1::no_allocate,
//     L2 evict-first) and the kernel asks for the largest L1 carveout.
//     L1's size is what the time hangs on (rows without L1 allocation
//     read 1.25x the time at train_batch on an H100), so nothing here takes
//     shared memory from it: a shared-memory table of the hot rows (one
//     persistent CTA an SM electing its rows by a vote over sampled ids)
//     served 52 % of the gathers and read 1.35-1.76x the time, and a
//     per-warp shared-memory stage for the ids in place of the shuffles
//     1.17x (PERF.md).
//   - scalar (d not a whole number of 16-byte chunks, or an unaligned
//     table or output): the groups design one element a load.
// Table rows go through L1 with L2 evict-last on every route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;           // groups and split CTAs
constexpr int kRowsInFlight = 8;        // U: row loads in flight a lane
constexpr int kSplitLanes = 16;         // most lanes a group on split
constexpr int kSplitWarpsPerSm = 16;    // split below this many group warps

enum Route { kRouteGroups = 0, kRouteSplit = 1, kRouteScalar = 2 };

// ---- L2 cache policies and the loads that carry them ------------------ //
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// ids and weights: read once, no L1 allocation
__device__ __forceinline__ int64_t ld_stream(const int32_t* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int64_t ld_stream(const int64_t* p, uint64_t pol) {
  long long v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.s64 %0, [%1], %2;"
               : "=l"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_stream(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// table rows: through L1, which keeps rows that many slots read
__device__ __forceinline__ void ld_row(const float4* p, uint64_t pol,
                                       float4& v) {
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(pol));
}

__device__ __forceinline__ void ld_row(const uint4* p, uint64_t pol,
                                       uint4& v) {
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
}

__device__ __forceinline__ void ld_row(const float* p, uint64_t pol,
                                       float& v) {
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol));
}

__device__ __forceinline__ void ld_row(const unsigned short* p, uint64_t pol,
                                       unsigned short& v) {
  asm volatile("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
               : "=h"(v) : "l"(p), "l"(pol));
}

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

// The group of lane rank r adds w[l] * row(ids[l]) for l in [lb, le) to
// acc, in the order of l.  `ids` and `w` point at the bag's first slot
// (`ids` null: an inactive group; `w` null: every weight is w_const).
// Every lane of the warp passes the same span (>= le - lb), so the trip
// counts, and so the full-mask shuffles, agree.  The lanes of a group load
// G ids and weights at a time (coalesced, one each) and broadcast them with
// two shuffles a row; an id outside [0, V) becomes key -1 (add nothing).
// Keys are int32 for int32 ids: a 64-bit key costs a third shuffle a row,
// which read 1.19x the time at train_batch on an H100.
template <typename T, typename I, typename K, int VEC, int NCH>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ table, const I* __restrict__ ids,
    const float* __restrict__ w, float w_const, int64_t lb, int64_t le,
    int64_t span, int64_t V, int d, int G, int r, const int (&col)[NCH],
    const bool (&col_ok)[NCH], uint64_t pol_stream, uint64_t pol_table,
    float (&acc)[NCH][VEC]) {
  using C = Chunk<T, VEC>;
  using Raw = typename C::Raw;
  constexpr int U = kRowsInFlight / NCH;
  for (int64_t l0 = 0; l0 < span; l0 += G) {
    const int n = (int)(span - l0 < G ? span - l0 : G);
    K my_key = -1;
    float my_w = 0.0f;
    const int64_t l = lb + l0 + r;
    if (ids != nullptr && r < n && l < le) {
      const int64_t id = ld_stream(ids + l, pol_stream);
      my_w = w != nullptr ? ld_stream(w + l, pol_stream) : w_const;
      if (id >= 0 && id < V) my_key = (K)id;
    }
    for (int j0 = 0; j0 < n; j0 += U) {
      K key[U];
      float wt[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = (j0 + u) & (G - 1);
        key[u] = __shfl_sync(kFull, my_key, src, G);
        wt[u] = __shfl_sync(kFull, my_w, src, G);
        if (j0 + u >= n) key[u] = -1;
      }
      Raw raw[U][NCH];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          if (key[u] == -1 || !col_ok[k]) continue;
          ld_row(reinterpret_cast<const Raw*>(
                     table + (int64_t)key[u] * d + col[k]),
                 pol_table, raw[u][k]);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (key[u] == -1) continue;
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
}

// groups: one bag per G-lane group; NCH loads a lane per row (a column tile
// is G * VEC * NCH wide, tiles along gridDim.y).  K: the key type (int32
// where every id in range fits).
template <typename T, typename I, typename K, int VEC, int NCH>
__global__ void __launch_bounds__(kThreads)
bag_groups(const T* __restrict__ table, const I* __restrict__ idx,
           const float* __restrict__ w, float w_const, T* __restrict__ out,
           int64_t B, int64_t L, int64_t V, int d, int G) {
  using C = Chunk<T, VEC>;
  const uint64_t pol_stream = policy_evict_first();
  const uint64_t pol_table = policy_evict_last();
  const int r = threadIdx.x & (G - 1);
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
  accumulate<T, I, K, VEC, NCH>(
      table, active ? idx + row0 : nullptr,
      active && w != nullptr ? w + row0 : nullptr, w_const, 0, L, L, V, d, G,
      r, col, col_ok, pol_stream, pol_table, acc);
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    if (col_ok[k])
      *reinterpret_cast<typename C::Raw*>(out + bag * (int64_t)d + col[k]) =
          C::from_float(acc[k]);
}

// split: CTA (bag, column tile of G * VEC columns); its blockDim / G groups
// each add a contiguous l-range, then group 0 adds the parts in order.
template <typename T, typename I, typename K, int VEC>
__global__ void __launch_bounds__(kThreads)
bag_split(const T* __restrict__ table, const I* __restrict__ idx,
          const float* __restrict__ w, float w_const, T* __restrict__ out,
          int64_t B, int64_t L, int64_t V, int d, int G) {
  using C = Chunk<T, VEC>;
  extern __shared__ float partial[];  // [S][G * VEC]
  const uint64_t pol_stream = policy_evict_first();
  const uint64_t pol_table = policy_evict_last();
  const int S = blockDim.x / G;
  const int part = threadIdx.x / G;
  const int r = threadIdx.x & (G - 1);
  const int64_t bag = blockIdx.x;
  int col[1] = {(int)(blockIdx.y * G + r) * VEC};
  bool col_ok[1] = {col[0] < d};
  const int64_t per = (L + S - 1) / S;
  const int64_t lb = part * per;
  const int64_t le = lb + per < L ? lb + per : L;
  float acc[1][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[0][e] = 0.0f;
  accumulate<T, I, K, VEC, 1>(
      table, idx + bag * L, w != nullptr ? w + bag * L : nullptr, w_const,
      lb, le, per, V, d, G, r, col, col_ok, pol_stream, pol_table, acc);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    partial[(part * G + r) * VEC + e] = acc[0][e];
  __syncthreads();
  if (part == 0 && col_ok[0]) {
    float sum[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[e] = partial[r * VEC + e];
    for (int s = 1; s < S; ++s)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum[e] += partial[(s * G + r) * VEC + e];
    *reinterpret_cast<typename C::Raw*>(out + bag * (int64_t)d + col[0]) =
        C::from_float(sum);
  }
}

int pow2_at_least(int64_t x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// How a call runs: its route and the launch's shape.
struct Plan {
  int route = kRouteGroups;
  int vec = 1;       // elements a load
  int G = 1;         // lanes a group
  int nch = 1;       // loads a lane per row (groups, scalar)
  int64_t tiles = 1; // column tiles (gridDim.y)
  int threads = kThreads;
  int smem = 0;
  int64_t grid = 0;
};

template <typename T>
cudaError_t make_plan(const void* table, const void* out, int64_t B,
                      int64_t L, int d, Plan* p) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  p->vec = vec ? kVec : 1;
  const int chunks = d / p->vec;
  p->G = 32;
  p->nch = 4;
  if (chunks <= 32) {
    p->nch = 1;
    p->G = pow2_at_least(chunks);
  } else if (chunks <= 64) {
    p->nch = 2;
  }
  const int64_t tile = (int64_t)p->G * p->vec * p->nch;
  p->tiles = (d + tile - 1) / tile;
  p->grid = (B * p->G + kThreads - 1) / kThreads;
  p->route = vec ? kRouteGroups : kRouteScalar;
  if (!vec) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t warps = (B * p->G + 31) / 32 * p->tiles;
  if (warps < (int64_t)sms * kSplitWarpsPerSm) {
    p->route = kRouteSplit;
    p->G = pow2_at_least(chunks < kSplitLanes ? chunks : kSplitLanes);
    p->nch = 1;
    p->tiles = (chunks + p->G - 1) / p->G;
    int S = 32 / p->G > 1 ? 32 / p->G : 1;  // a whole warp at least
    while (S * p->G < kThreads && S < L) S <<= 1;
    p->threads = S * p->G;
    p->smem = p->threads * p->vec * (int)sizeof(float);
    p->grid = B;
  }
  return cudaSuccess;
}

// The groups kernels ask for the largest L1 (they use no shared memory),
// once per kernel: host work that a CUDA-graph capture of a call then
// leaves out.  The split kernel keeps the default carveout: at the largest
// L1 its shared memory admits only two CTAs an SM.
template <auto kernel>
cudaError_t prefer_l1() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxL1);
  done = err == cudaSuccess;
  return err;
}

template <typename T, typename I, int VEC>
cudaError_t launch(const Plan& p, const void* table, const void* idx,
                   const float* w, float w_const, void* out, int64_t B,
                   int64_t L, int64_t V, int d, cudaStream_t st) {
  // the id a lane broadcasts: int32 ids in an int32, int64 ones in theirs
  using K = typename std::conditional<sizeof(I) == 4, int32_t, int64_t>::type;
  const T* t = static_cast<const T*>(table);
  const I* ix = static_cast<const I*>(idx);
  T* o = static_cast<T*>(out);
  if (p.grid > 0x7fffffff || p.tiles > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)p.grid, (unsigned)p.tiles);
  cudaError_t err = cudaSuccess;
  if (p.route == kRouteSplit) {
    bag_split<T, I, K, VEC><<<grid, p.threads, p.smem, st>>>(
        t, ix, w, w_const, o, B, L, V, d, p.G);
  } else if (p.nch == 1) {
    err = prefer_l1<bag_groups<T, I, K, VEC, 1>>();
    if (err != cudaSuccess) return err;
    bag_groups<T, I, K, VEC, 1><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, p.G);
  } else if (p.nch == 2) {
    err = prefer_l1<bag_groups<T, I, K, VEC, 2>>();
    if (err != cudaSuccess) return err;
    bag_groups<T, I, K, VEC, 2><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, p.G);
  } else {
    err = prefer_l1<bag_groups<T, I, K, VEC, 4>>();
    if (err != cudaSuccess) return err;
    bag_groups<T, I, K, VEC, 4><<<grid, kThreads, 0, st>>>(
        t, ix, w, w_const, o, B, L, V, d, p.G);
  }
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t dispatch(const void* table, const void* idx, const float* w,
                     float w_const, void* out, int64_t B, int64_t L,
                     int64_t V, int d, cudaStream_t st) {
  Plan p;
  const cudaError_t err = make_plan<T>(table, out, B, L, d, &p);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / sizeof(T);
  return p.vec == kVec
      ? launch<T, I, kVec>(p, table, idx, w, w_const, out, B, L, V, d, st)
      : launch<T, I, 1>(p, table, idx, w, w_const, out, B, L, V, d, st);
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

// The route embedding_bag() takes for these arguments on the current
// device (0 groups, 1 split, 2 scalar), or -1 - the CUDA error.
extern "C" int embedding_bag_route(const void* table, const void* out,
                                   int64_t B, int64_t L, int d, int dtype) {
  if (B < 0 || L < 0 || d < 1 || dtype < 0 || dtype > 1)
    return -1 - (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err =
      dtype == 0 ? make_plan<float>(table, out, B, L, d, &p)
                 : make_plan<__nv_bfloat16>(table, out, B, L, d, &p);
  return err == cudaSuccess ? p.route : -1 - (int)err;
}

extern "C" const char* embedding_bag_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
