// Backward of flash attention for NVIDIA Hopper (sm_90a), with a plain C
// interface: dQ, dK and dV of softmax attention with GQA, causal or
// bidirectional masking, a sliding window and tanh logit capping.
//
// Replaces: nothing on the TPU.  The JAX package trains through XLA's
// autodiff of attention_ref (src/repro/kernels/flash_attention/ref.py); its
// Pallas kernel (src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas) has no backward.  This kernel is the port's own:
// it gives the forward kernels (flash_attention.cu, flash_attention_wgmma.cu)
// a gradient, so that training keeps the plain version off the card's path.
//
// Computes the VJP of attention_ref.  With q (B, Hq, Sq, D), k and v
// (B, Hkv, Skv, D), group = Hq/Hkv, the forward's output o and the output
// gradient dout (both (B, Hq, Sq, D)):
//   x[i, j]  = scale * q[i] . k[j],  s = cap(x) = softcap * tanh(x/softcap)
//   p[i, j]  = exp(s[i, j] - lse[i])             (0 where masked)
//   dp[i, j] = dout[i] . v[j],  delta[i] = dout[i] . o[i]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) (1 - tanh^2(x/softcap))
//   dq[i] = scale sum_j ds[i, j] k[j]
//   dk[j] = scale sum_{h in group, i} ds[i, j] q[i]
//   dv[j] = sum_{h in group, i} p[i, j] dout[i]
// (the tanh factor only with softcap > 0).  The mask is the forward's: key
// j hidden from query i when j >= Skv, causal and j > i, or window > 0 and
// i - j >= window.  A row whose keys are all masked gets lse = +1e30, so p
// = 0 and it contributes nothing (the forward writes 0 there).
//
// Design: two kernels a call, 256 threads a CTA, fp32 everywhere inside.
// Tiles of T = 64 rows (32 at D = 256, for shared memory) are staged in
// shared memory as fp32 rows of D + 4.  Each thread owns a (T/16) x (T/16)
// block of a T x T score tile (rows ty + 16i, columns tx + 16j) and the same
// rows of a T x D accumulator (columns tx*ND .. tx*ND + ND - 1).
//  1. dq_kernel, one CTA per (q tile, q head, batch): a first sweep over
//     the visible K tiles recomputes each row's max and sum, hence lse; the
//     CTA also forms delta from o and dout, and writes both to scratch for
//     the second kernel.  A second sweep over K and V tiles recomputes p,
//     forms ds and accumulates dq in registers.
//  2. dkdv_kernel, one CTA per (k tile, KV head, batch): it keeps its K and
//     V tiles, sweeps every query head of its group and every q tile that
//     sees the tile, recomputes p^T and ds^T, and accumulates dv = p^T dout
//     and dk = ds^T q in registers; dk and dv are written once.
// Every output element is summed by one thread in a fixed order: no
// atomics, so the gradient is bit-reproducible.  Both kernels recompute the
// scores with the same fp32 FMA chain in d order, so p is the same number
// in both.  Tiles the mask hides wholly (above the causal diagonal, left of
// the window) are never loaded.
//
// Bound.  Operations: the backward needs about 2.5x the forward's
// 4*B*Hq*Sq*Skv*D flops (halved when causal): at TinyLlama's training shape
// (8 x 32 heads x 512, D 64) ~0.02 ms at the card's 989 TFLOP/s bf16
// tensor-core rate; its bytes (q, k, v, o, dout read, dq, dk, dv written)
// are of the same order at 3.35 TB/s.  This kernel runs its products on the
// FP32 pipes with FMA (67 TFLOP/s at best) and recomputes the scores three
// times, so it stays far from that bound: the step to it is wgmma on bf16
// tiles with the scores kept in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr float kNegInf = -1e30f;
constexpr float kNoRow = 1e30f;  // lse of a row whose keys are all masked

template <int D>
struct Shape {
  static constexpr int T = D >= 256 ? 32 : 64;  // rows of a tile
  static constexpr int R = T / 16;              // rows (cols) a thread owns
  static constexpr int DS = D + 4;              // row stride of a D-wide tile
  static constexpr int PS = T + 4;              // row stride of a score tile
  static constexpr int ND = (D + 15) / 16;      // accumulator columns
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static float store(float x) { return x; }
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
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// rows [row0, row0 + T) of a (rows, D) matrix into dst[T][DS] as fp32 times
// mul; rows past nrows read 0
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int row0,
                                          int nrows, float mul) {
  constexpr int T = Shape<D>::T, DS = Shape<D>::DS, VEC = Vec<E>::N;
  for (int e = threadIdx.x; e < T * D / VEC; e += kThreads) {
    const int r = e * VEC / D, c0 = e * VEC - r * D;
    float x[VEC];
    if (row0 + r < nrows) {
      Vec<E>::load(src + (int64_t)(row0 + r) * D + c0, x);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) x[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[r * DS + c0 + u] = x[u] * mul;
  }
}

// c[i][j] = a[ty + 16i] . b[tx + 16j] over D, summed in d order (so that
// nt(a, b)[i][j] and nt(b, a)[j][i] are the same bits)
template <int D>
__device__ __forceinline__ void nt(const float* a, const float* b,
                                   float (&c)[Shape<D>::R][Shape<D>::R]) {
  constexpr int R = Shape<D>::R, DS = Shape<D>::DS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) c[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * DS + d);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * DS + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

// acc[i][n] += sum_c p[ty + 16i][c] * b[c][tx*ND + n], c over the tile
template <int D>
__device__ __forceinline__ void nn(const float* p, const float* b,
                                   float (&acc)[Shape<D>::R][Shape<D>::ND]) {
  constexpr int T = Shape<D>::T, R = Shape<D>::R, DS = Shape<D>::DS,
                PS = Shape<D>::PS, ND = Shape<D>::ND;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int c = 0; c < T; c += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * PS + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[ND];
      const float* brow = b + (c + u) * DS + tx * ND;
      if constexpr (ND % 4 == 0) {
#pragma unroll
        for (int n = 0; n < ND; n += 4) {
          const float4 x = *reinterpret_cast<const float4*>(brow + n);
          bv[n] = x.x; bv[n + 1] = x.y; bv[n + 2] = x.z; bv[n + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int n = 0; n < ND; ++n) bv[n] = tx * ND + n < D ? brow[n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float w = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                      : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int n = 0; n < ND; ++n) acc[i][n] = fmaf(w, bv[n], acc[i][n]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv,
                                        int causal, int window) {
  return qi < Sq && kj < Skv && (!causal || qi >= kj) &&
         (window <= 0 || qi - kj < window);
}

// capped score and the derivative factor of the cap at x
__device__ __forceinline__ float cap(float x, float softcap, float* dcap) {
  if (softcap > 0.0f) {
    const float t = tanhf(x / softcap);
    *dcap = 1.0f - t * t;
    return softcap * t;
  }
  *dcap = 1.0f;
  return x;
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * Shape<D>::T * Shape<D>::DS + Shape<D>::T * Shape<D>::PS +
         2 * Shape<D>::T;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * Shape<D>::T * Shape<D>::DS + 2 * Shape<D>::T * Shape<D>::PS +
         2 * Shape<D>::T;
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, const E* __restrict__ o,
          const E* __restrict__ dout, E* __restrict__ dq,
          float* __restrict__ lse, float* __restrict__ delta, int Hq,
          int Hkv, int Sq, int Skv, float scale, int causal, int window,
          float softcap) {
  constexpr int T = Shape<D>::T, R = Shape<D>::R, DS = Shape<D>::DS,
                PS = Shape<D>::PS, ND = Shape<D>::ND;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [T][DS], scaled
  float* dos = qs + T * DS;      // [T][DS]
  float* ks = dos + T * DS;      // [T][DS]
  float* vs = ks + T * DS;       // [T][DS]
  float* dss = vs + T * DS;      // [T][PS]
  float* row_lse = dss + T * PS;  // [T]
  float* row_delta = row_lse + T;  // [T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * T;
  const int64_t qoff = ((int64_t)b * Hq + h) * Sq;
  const E* kp = k + ((int64_t)b * Hkv + hk) * Skv * D;
  const E* vp = v + ((int64_t)b * Hkv + hk) * Skv * D;

  load_tile<E, D>(qs, q + qoff * D, q0, Sq, scale);
  load_tile<E, D>(dos, dout + qoff * D, q0, Sq, 1.0f);
  __syncthreads();

  // delta = dout . o, kThreads / T lanes a row, reduced in a fixed order
  {
    constexpr int TPR = kThreads / T;
    const int r = tid / TPR, part = tid % TPR;
    float acc = 0.0f;
    if (q0 + r < Sq) {
      const E* orow = o + (qoff + q0 + r) * D;
      for (int d = part; d < D; d += TPR)
        acc = fmaf(dos[r * DS + d], Vec<E>::get(orow + d), acc);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) row_delta[r] = acc;
  }

  // the K tiles any row of this q tile can see (the forward's early-out)
  const int q_last = min(q0 + T, Sq) - 1;
  int j_end = (Skv + T - 1) / T;
  if (causal) j_end = min(j_end, q_last / T + 1);
  int j_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the least key row q0 may see
    if (lo > 0) j_begin = lo / T;
  }

  // sweep 1: each row's running max and sum → lse
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * T;
    __syncthreads();
    load_tile<E, D>(ks, kp, k0, Skv, 1.0f);
    __syncthreads();
    float s[R][R];
    nt<D>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf, dcap;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = cap(s[i][j], softcap, &dcap);
        s[i][j] = visible(qi, k0 + tx + 16 * j, Sq, Skv, causal, window)
                      ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j)
        rs += s[i][j] <= kNegInf ? 0.0f : expf(s[i][j] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - mn) + rs;
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      row_lse[r] = l[i] > 0.0f ? m[i] + logf(l[i]) : kNoRow;
    }
  }
  __syncthreads();
  if (tid < T && q0 + tid < Sq) {
    lse[qoff + q0 + tid] = row_lse[tid];
    delta[qoff + q0 + tid] = row_delta[tid];
  }

  // sweep 2: ds = p (dp - delta) cap', dq += ds k
  float acc[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.0f;
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * T;
    __syncthreads();
    load_tile<E, D>(ks, kp, k0, Skv, 1.0f);
    load_tile<E, D>(vs, vp, k0, Skv, 1.0f);
    __syncthreads();
    float s[R][R], dp[R][R];
    nt<D>(qs, ks, s);
    nt<D>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      const float lr = row_lse[r], dr = row_delta[r];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        float dcap;
        const float x = cap(s[i][j], softcap, &dcap);
        const float p = visible(q0 + r, k0 + c, Sq, Skv, causal, window)
                            ? expf(x - lr) : 0.0f;
        dss[r * PS + c] = p * (dp[i][j] - dr) * dcap;
      }
    }
    __syncthreads();
    nn<D>(dss, ks, acc);
  }

  E* dqp = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = tx * ND + n;
      if (d < D) dqp[(int64_t)qi * D + d] = Vec<E>::store(acc[i][n] * scale);
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            E* __restrict__ dk, E* __restrict__ dv, int Hq, int Hkv, int Sq,
            int Skv, float scale, int causal, int window, float softcap) {
  constexpr int T = Shape<D>::T, R = Shape<D>::R, DS = Shape<D>::DS,
                PS = Shape<D>::PS, ND = Shape<D>::ND;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // [T][DS]
  float* vs = ks + T * DS;       // [T][DS]
  float* qs = vs + T * DS;       // [T][DS], scaled
  float* dos = qs + T * DS;      // [T][DS]
  float* pts = dos + T * DS;     // [T][PS], p^T
  float* dsts = pts + T * PS;    // [T][PS], ds^T
  float* row_lse = dsts + T * PS;  // [T]
  float* row_delta = row_lse + T;  // [T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * T;
  const int64_t koff = ((int64_t)b * Hkv + hk) * Skv;

  load_tile<E, D>(ks, k + koff * D, k0, Skv, 1.0f);
  load_tile<E, D>(vs, v + koff * D, k0, Skv, 1.0f);

  // the q tiles that see any key of this tile
  const int k_last = min(k0 + T, Skv) - 1;
  const int i_begin = causal ? k0 / T : 0;
  int i_end = (Sq + T - 1) / T;
  if (window > 0) i_end = min(i_end, (k_last + window - 1) / T + 1);

  float dka[R][ND], dva[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) dka[i][n] = dva[i][n] = 0.0f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const int64_t qoff = ((int64_t)b * Hq + h) * Sq;
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * T;
      __syncthreads();
      load_tile<E, D>(qs, q + qoff * D, q0, Sq, scale);
      load_tile<E, D>(dos, dout + qoff * D, q0, Sq, 1.0f);
      if (tid < T) {
        const bool in = q0 + tid < Sq;
        row_lse[tid] = in ? lse[qoff + q0 + tid] : kNoRow;
        row_delta[tid] = in ? delta[qoff + q0 + tid] : 0.0f;
      }
      __syncthreads();
      float st[R][R], dpt[R][R];
      nt<D>(ks, qs, st);   // st[i][j]: key ty + 16i, query tx + 16j
      nt<D>(vs, dos, dpt);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          float dcap;
          const float x = cap(st[i][j], softcap, &dcap);
          const float p = visible(q0 + c, k0 + r, Sq, Skv, causal, window)
                              ? expf(x - row_lse[c]) : 0.0f;
          pts[r * PS + c] = p;
          dsts[r * PS + c] = p * (dpt[i][j] - row_delta[c]) * dcap;
        }
      }
      __syncthreads();
      nn<D>(pts, dos, dva);
      nn<D>(dsts, qs, dka);
    }
  }

  E* dkp = dk + koff * D;
  E* dvp = dv + koff * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = tx * ND + n;
      if (d < D) {
        dkp[(int64_t)kj * D + d] = Vec<E>::store(dka[i][n]);
        dvp[(int64_t)kj * D + d] = Vec<E>::store(dva[i][n]);
      }
    }
  }
}

template <typename E, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* delta, int B, int Hq, int Hkv, int Sq, int Skv,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t st) {
  constexpr int T = Shape<D>::T;
  const size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  const size_t smem_kv = dkdv_smem_floats<D>() * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_q);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        dkdv_kernel<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_kv);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  dq_kernel<E, D><<<dim3((Sq + T - 1) / T, Hq, B), kThreads, smem_q, st>>>(
      qe, ke, ve, static_cast<const E*>(o), de, static_cast<E*>(dq), lse,
      delta, Hq, Hkv, Sq, Skv, scale, causal, window, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<E, D><<<dim3((Skv + T - 1) / T, Hkv, B), kThreads, smem_kv,
                      st>>>(
      qe, ke, ve, de, lse, delta, static_cast<E*>(dk), static_cast<E*>(dv),
      Hq, Hkv, Sq, Skv, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int B, int Hq,
                     int Hkv, int Sq, int Skv, int D, float scale, int causal,
                     int window, float softcap, cudaStream_t st) {
#define FAB_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch<E, DD>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Hq,   \
                         Hkv, Sq, Skv, scale, causal, window, softcap, st);
  switch (D) {
    FAB_CASE(8)
    FAB_CASE(16)
    FAB_CASE(32)
    FAB_CASE(64)
    FAB_CASE(128)
    FAB_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FAB_CASE
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v, o, dout, dq, dk and dv alike).  Tensors
// contiguous (B, H, S, D) with 16-byte aligned bases; lse and delta fp32
// scratch of B*Hq*Sq each.  D one of 8, 16, 32, 64, 128, 256 (else
// cudaErrorInvalidValue).  Launches dq_kernel, then dkdv_kernel, on
// ``stream``; returns cudaGetLastError() after the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta,
                                   int dtype, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, float scale, int causal,
                                   int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Hq, Hkv,
                           Sq, Skv, D, scale, causal, window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, B, Hq,
                                   Hkv, Sq, Skv, D, scale, causal, window,
                                   softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
