// Split-KV decode attention for NVIDIA Hopper (sm_90a), with a plain C
// interface: one new query token per request against a KV cache, each
// split of the cache reduced to partial (max, sum, unnormalised output).
//
// Replaces: src/repro/kernels/flash_attention/decode_kernel.py,
// flash_decode_pallas / _decode_kernel.  The reference merges the
// partials with a log-sum-exp combine in XLA, outside the Pallas kernel;
// here a second, small kernel (merge_kernel) does it, launched by the same
// C call on the same stream, so that a decode step costs one call instead
// of a dozen torch ops.
//
// Computes, for q (B, Hkv, G, D) fp32 (G = Hq/Hkv query rows per KV head),
// k and v (B, Hkv, S, D), split si covering cache slots
// [si*split, min((si+1)*split, kv_len, S)):
//   s[g, j] = cap(scale * q[b, hk, g] . k[b, hk, j])
//   m[g] = max_j s[g, j],  l[g] = sum_j exp(s[g, j] - m[g]),
//   o[g] = sum_j exp(s[g, j] - m[g]) v[b, hk, j]
// all fp32, with cap(x) = softcap * tanh(x / softcap) when softcap > 0.
// Slots at or past kv_len are masked: they add exactly 0.  A split that
// lies wholly at or past kv_len reads nothing and writes m = -1e30, l = 0,
// o = 0 (the serve cache is allocated at the full horizon and is mostly
// empty early on).  kv_len is a runtime argument: a new decode position
// launches the same code.
//
// Design.  Grid (splits, Hkv, B); 128 threads a CTA.  The CTA loads its KV
// head's G query rows once (pre-scaled, fp32, shared memory) and streams
// its split of the cache in tiles of 64 slots through shared memory, with
// 16-byte loads.  Scores: each thread takes one slot and half of the G rows,
// reading its K row as 16-byte vectors; the G x 64 score tile goes through
// shared memory, one warp per row does the online-softmax update, and each
// thread then accumulates G*D/128 output entries (one column d, several
// rows) over the tile's P.  The number of splits is the caller's
// (decode_kernel.py picks it so that B*Hkv*splits fills the 132 SMs).
// Each head dim is built twice, for G <= 8 and G <= 32, so that the
// common small groups do not carry registers sized for 32 rows.
//
// Bound.  Bytes: the K/V read, 2*B*Hkv*kv_len*D*sizeof(T), over 3.35 TB/s;
// the partials and q are ~1/(2*split/G) of that, and the FMAs (2*G per
// slot and column) are far below the FP32 rate.  What the design does about
// it: each K/V byte is read once, in coalesced 16-byte loads, by enough
// CTAs (splits) to keep every SM streaming; empty splits read nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;       // cache slots per step
constexpr int kMaxGroup = 32;   // query rows per KV head
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__host__ __device__ constexpr int smem_floats(int G, int D) {
  // q [G][D], K [kTile][D+4], V [kTile][D], P [G][kTile], alpha/m/l [G]
  return G * D + kTile * (D + 4) + kTile * D + G * kTile + 3 * G;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// GM: the most query rows per KV head this instantiation takes (8 or 32);
// it sizes the per-thread score and output registers.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ m_out,
              float* __restrict__ l_out, float* __restrict__ o_out, int G,
              int S, int kv_len, int split, float scale, float softcap) {
  constexpr int KS = D + 4;  // row stride of K (16 B aligned)
  constexpr int VEC = Vec<T>::N;
  constexpr int NACC = (GM * D + kThreads - 1) / kThreads;
  constexpr int NS = GM / (kThreads / kTile);  // score rows a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][D], scaled
  float* ks = qs + G * D;           // [kTile][KS]
  float* vs = ks + kTile * KS;      // [kTile][D]
  float* ps = vs + kTile * D;       // [G][kTile]: scores, then P
  float* alpha_s = ps + G * kTile;  // [G]
  float* m_s = alpha_s + G;         // [G]
  float* l_s = m_s + G;             // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int si = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, Hkv = gridDim.y;
  const int64_t bh = (int64_t)b * Hkv + hk;
  const int64_t part = bh * splits + si;
  const int s_lo = si * split;
  const int s_hi = min(s_lo + split, min(kv_len, S));
  const T* kp = k + bh * S * D;
  const T* vp = v + bh * S * D;

  for (int e = tid; e < G * D; e += kThreads) qs[e] = q[bh * G * D + e] * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  const int c_me = tid % kTile;          // this thread's slot in a tile
  const int g_me = tid / kTile;          // its first score row
  constexpr int g_step = kThreads / kTile;

  for (int t0 = s_lo; t0 < s_hi; t0 += kTile) {
    const int n = min(kTile, s_hi - t0);
    __syncthreads();  // q, m, l ready; the last tile's readers are done
    for (int e = tid; e < kTile * D / VEC; e += kThreads) {
      const int r = e * VEC / D, c0 = e * VEC - r * D;
      float kx[VEC], vx[VEC];
      if (r < n) {
        Vec<T>::load(kp + (int64_t)(t0 + r) * D + c0, kx);
        Vec<T>::load(vp + (int64_t)(t0 + r) * D + c0, vx);
      } else {  // past the split's end: zeros, so that P = 0 times V is 0
#pragma unroll
        for (int u = 0; u < VEC; ++u) kx[u] = vx[u] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        ks[r * KS + c0 + u] = kx[u];
        vs[r * D + c0 + u] = vx[u];
      }
    }
    __syncthreads();

    // scores of slot c_me for rows g_me, g_me + g_step, ...
    float sc[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(ks + c_me * KS + d);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int g = g_me + g_step * j;
        if (g < G) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + g * D + d);
          sc[j] = fmaf(q4.x, k4.x, sc[j]);
          sc[j] = fmaf(q4.y, k4.y, sc[j]);
          sc[j] = fmaf(q4.z, k4.z, sc[j]);
          sc[j] = fmaf(q4.w, k4.w, sc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int g = g_me + g_step * j;
      if (g < G) {
        float x = sc[j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        ps[g * kTile + c_me] = c_me < n ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = ps[g * kTile + lane], c = ps[g * kTile + lane + 32];
      const float mo = m_s[g];
      const float mn = fmaxf(mo, warp_max(fmaxf(a, c)));
      const float pa = a <= kNegInf ? 0.0f : expf(a - mn);
      const float pc = c <= kNegInf ? 0.0f : expf(c - mn);
      ps[g * kTile + lane] = pa;
      ps[g * kTile + lane + 32] = pc;
      const float rs = warp_sum(pa + pc);
      if (lane == 0) {
        const float al = expf(mo - mn);
        alpha_s[g] = al;
        l_s[g] = l_s[g] * al + rs;
        m_s[g] = mn;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for entries (g, d) = divmod(tid + 128 i, D)
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + kThreads * i;
      if (e < G * D) acc[i] *= alpha_s[e / D];
    }
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int e = tid + kThreads * i;
        if (e < G * D) {
          const int g = e / D, d = e % D;
          const float4 p4 = *reinterpret_cast<const float4*>(ps + g * kTile + c);
          acc[i] = fmaf(p4.x, vs[(c + 0) * D + d], acc[i]);
          acc[i] = fmaf(p4.y, vs[(c + 1) * D + d], acc[i]);
          acc[i] = fmaf(p4.z, vs[(c + 2) * D + d], acc[i]);
          acc[i] = fmaf(p4.w, vs[(c + 3) * D + d], acc[i]);
        }
      }
    }
  }
  __syncthreads();  // m, l final

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + kThreads * i;
    if (e < G * D) o_out[part * G * D + e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    m_out[part * G + g] = m_s[g];
    l_out[part * G + g] = l_s[g];
  }
}


template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The log-sum-exp merge of the splits' partials, one CTA per query row
// (b, hk, g): alpha_s = exp(m_s - max m), out = sum alpha_s o_s /
// max(sum alpha_s l_s, 1e-30) — the reference's merge, in the order of the
// splits.  out is (B, Hkv*G, D) in the query's type.
template <typename TO>
__global__ void merge_kernel(const float* __restrict__ m,
                             const float* __restrict__ l,
                             const float* __restrict__ o,
                             TO* __restrict__ out, int splits, int G, int D) {
  const int64_t r = blockIdx.x;
  const int64_t bh = r / G;
  const int g = (int)(r - bh * G);
  const float* mp = m + bh * splits * G + g;
  const float* lp = l + bh * splits * G + g;
  float m_star = mp[0];
  for (int s = 1; s < splits; ++s) m_star = fmaxf(m_star, mp[(int64_t)s * G]);
  float l_total = 0.0f;
  for (int s = 0; s < splits; ++s)
    l_total += lp[(int64_t)s * G] * expf(mp[(int64_t)s * G] - m_star);
  const float lc = fmaxf(l_total, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s)
      acc += o[((bh * splits + s) * G + g) * D + d] *
             expf(mp[(int64_t)s * G] - m_star);
    out[r * D + d] = from_float<TO>(acc / lc);
  }
}

template <typename T, int D, int GM>
cudaError_t launch(const float* q, const void* k, const void* v, float* m,
                   float* l, float* o, int B, int Hkv, int G, int S,
                   int kv_len, int splits, int split, float scale,
                   float softcap, cudaStream_t st) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(GM, D) * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t smem = smem_floats(G, D) * sizeof(float);
  const dim3 grid(splits, Hkv, B);
  decode_kernel<T, D, GM><<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), m, l, o, G, S,
      kv_len, split, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* q, const void* k, const void* v, float* m,
                     float* l, float* o, int B, int Hkv, int G, int S, int D,
                     int kv_len, int splits, int split, float scale,
                     float softcap, cudaStream_t st) {
#define FD_CASE(DD)                                                        \
  case DD:                                                                 \
    return G <= 8 ? launch<T, DD, 8>(q, k, v, m, l, o, B, Hkv, G, S,       \
                                     kv_len, splits, split, scale,         \
                                     softcap, st)                          \
                  : launch<T, DD, kMaxGroup>(q, k, v, m, l, o, B, Hkv, G,  \
                                             S, kv_len, splits, split,     \
                                             scale, softcap, st);
  switch (D) {
    FD_CASE(8)
    FD_CASE(16)
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(128)
    FD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FD_CASE
}

}  // namespace

extern "C" int flash_decode_supports(int G, int D) {
  return G >= 1 && G <= kMaxGroup &&
         (D == 8 || D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// dtype 0: fp32 cache, 1: bf16 cache; q is fp32 (B, Hkv, G, D); k and v
// contiguous (B, Hkv, S, D) with 16-byte aligned bases.  ws holds the
// partials, fp32: m and l (B, Hkv, splits, G) then o (B, Hkv, splits, G,
// D); every split is written.  When out is not null the merge follows on
// the same stream and writes out (B, Hkv*G, D) in out_dtype (0: fp32,
// 1: bf16).  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int flash_decode(const float* q, const void* k, const void* v,
                            float* ws, void* out, int dtype, int out_dtype,
                            int B, int Hkv, int G, int S, int D, int kv_len,
                            int splits, int split, float scale,
                            float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || B > 65535 || Hkv > 65535 || S < 1 || kv_len < 1 ||
      splits < 1 || split < 1 || !flash_decode_supports(G, D))
    return cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * Hkv * G;
  float* m = ws;
  float* l = ws + rows * splits;
  float* o = ws + 2 * rows * splits;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, m, l, o, B, Hkv, G, S, D, kv_len, splits,
                          split, scale, softcap, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, m, l, o, B, Hkv, G, S, D, kv_len,
                                  splits, split, scale, softcap, st);
  if (err != cudaSuccess || out == nullptr) return err;
  if (rows > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int threads = D < 128 ? D : 128;
  if (out_dtype == 0)
    merge_kernel<float><<<(unsigned)rows, threads, 0, st>>>(
        m, l, o, static_cast<float*>(out), splits, G, D);
  else if (out_dtype == 1)
    merge_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, st>>>(
        m, l, o, static_cast<__nv_bfloat16*>(out), splits, G, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
