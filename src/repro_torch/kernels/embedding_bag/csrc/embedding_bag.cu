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
