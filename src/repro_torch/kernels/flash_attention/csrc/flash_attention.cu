// Forward flash attention for NVIDIA Hopper (sm_90a), with a plain C
// interface: online-softmax attention with GQA, causal or bidirectional
// masking, a sliding window and tanh logit capping.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas / _attn_kernel — the TPU kernel behind the LM
// forward (models/layers.py attention_block), hence behind every prefill.
//
// Computes, for q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), group = Hq/Hkv,
//   s[i, j] = cap(scale * q[b, h, i] . k[b, h/group, j])
//   out[b, h, i] = sum_j softmax_j(s[i, j] masked) v[b, h/group, j]
// with cap(x) = softcap * tanh(x / softcap) when softcap > 0, and key j
// masked when j >= Skv, when causal and j > i, or when window > 0 and
// i - j >= window (positions count from 0 in both q and k).  Masked scores
// are -1e30 (the Pallas NEG_INF) in the running max and add exactly 0 to
// the sum and the output; l is clamped to 1e-30, so a row whose keys are
// all masked comes out 0.  Scores, the running max and sum and the
// accumulator are fp32; q, k, v and out are all bf16 or all fp32.
//
// Design.  One CTA of 256 threads per (q tile of 64 rows, q head, batch);
// the heaviest causal q tiles are issued first.  The CTA keeps its q tile
// (pre-scaled) in shared memory as fp32 and streams the head's K/V in tiles
// of 64 keys through shared memory, K transposed.  Each thread owns a 4x4
// block of the 64x64 score tile (rows ty+16i, columns 4tx..4tx+3) and the
// same rows of the output (columns tx*ND..).  Row max and sum are reduced
// over the 16 lanes that share a row with shuffles; P goes through shared
// memory for the P.V product.  KV tiles wholly above the causal diagonal or
// wholly left of the window are never loaded, as the Pallas kernel skips
// them; a ragged final tile is masked (no padding: S need not divide into
// tiles).  The products run on the FP32 pipes with FMA (no tensor cores);
// shared-memory reads are 16-byte vectors so that the FMAs, not the loads,
// set the pace.
//
// Bound.  Operations: 4*B*Hq*Sq*Skv*D flops (halved when causal), which at
// the prefill shapes (S = 2048, D = 64) need ~0.14 ms per layer at the
// card's 989 TFLOP/s bf16 tensor-core rate; the bytes (q, k, v read once,
// out written once) need a third of that time at 3.35 TB/s.  This kernel
// runs its products at the 67 TFLOP/s FP32 rate at best, so it stays well
// short of that bound; the step to reach it is mma/wgmma on bf16 tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr int kKT = kBK + 4;   // row stride of transposed K (16 B aligned)
constexpr int kPS = kBK + 4;   // row stride of P
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
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + D * kKT + kBK * D + kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
            int Sq, int Skv, float scale, int causal, int window,
            float softcap) {
  constexpr int QS = D + 4;              // row stride of q (16 B aligned)
  constexpr int ND = (D + 15) / 16;      // output columns per thread
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [kBQ][QS], scaled
  float* kt = qs + kBQ * QS;             // [D][kKT], K transposed
  float* vs = kt + D * kKT;              // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const T* qp = q + ((int64_t)b * Hq + h) * Sq * D;
  const T* kp = k + ((int64_t)b * Hkv + hk) * Skv * D;
  const T* vp = v + ((int64_t)b * Hkv + hk) * Skv * D;
  T* op = o + ((int64_t)b * Hq + h) * Sq * D;

  for (int e = tid; e < kBQ * D / VEC; e += kThreads) {
    const int r = e * VEC / D, c0 = e * VEC - r * D;
    float x[VEC];
    if (q0 + r < Sq) {
      Vec<T>::load(qp + (int64_t)(q0 + r) * D + c0, x);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) x[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) qs[r * QS + c0 + u] = x[u] * scale;
  }

  // KV tiles any row of this q tile can see (the Pallas early-out)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int j_end = (Skv + kBK - 1) / kBK;
  if (causal) j_end = min(j_end, q_last / kBK + 1);
  int j_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the least key row q0 may see
    if (lo > 0) j_begin = lo / kBK;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.0f;
  }

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // q loaded; the last tile's readers are done
    for (int e = tid; e < kBK * D / VEC; e += kThreads) {
      const int r = e * VEC / D, c0 = e * VEC - r * D;
      float kx[VEC], vx[VEC];
      if (k0 + r < Skv) {
        Vec<T>::load(kp + (int64_t)(k0 + r) * D + c0, kx);
        Vec<T>::load(vp + (int64_t)(k0 + r) * D + c0, vx);
      } else {  // ragged end: zeros, so that P = 0 times V stays 0
#pragma unroll
        for (int u = 0; u < VEC; ++u) kx[u] = vx[u] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        kt[(c0 + u) * kKT + r] = kx[u];
        vs[r * D + c0 + u] = vx[u];
      }
    }
    __syncthreads();

    // S = (scale q) K^T for rows ty+16i, columns 4tx+jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kv[u] = *reinterpret_cast<const float4*>(kt + (d + u) * kKT + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i].x, kv[0].x, s[i][0]);
        s[i][1] = fmaf(qv[i].x, kv[0].y, s[i][1]);
        s[i][2] = fmaf(qv[i].x, kv[0].z, s[i][2]);
        s[i][3] = fmaf(qv[i].x, kv[0].w, s[i][3]);
        s[i][0] = fmaf(qv[i].y, kv[1].x, s[i][0]);
        s[i][1] = fmaf(qv[i].y, kv[1].y, s[i][1]);
        s[i][2] = fmaf(qv[i].y, kv[1].z, s[i][2]);
        s[i][3] = fmaf(qv[i].y, kv[1].w, s[i][3]);
        s[i][0] = fmaf(qv[i].z, kv[2].x, s[i][0]);
        s[i][1] = fmaf(qv[i].z, kv[2].y, s[i][1]);
        s[i][2] = fmaf(qv[i].z, kv[2].z, s[i][2]);
        s[i][3] = fmaf(qv[i].z, kv[2].w, s[i][3]);
        s[i][0] = fmaf(qv[i].w, kv[3].x, s[i][0]);
        s[i][1] = fmaf(qv[i].w, kv[3].y, s[i][1]);
        s[i][2] = fmaf(qv[i].w, kv[3].z, s[i][2]);
        s[i][3] = fmaf(qv[i].w, kv[3].w, s[i][3]);
      }
    }

    // online softmax, one row per (i); the row's 64 scores lie in the 16
    // lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + 4 * tx + jj;
        float x = s[i][jj];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok = kj < Skv && (!causal || qi >= kj) &&
                        (window <= 0 || qi - kj < window);
        x = ok ? x : kNegInf;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float p[4], rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        p[jj] = s[i][jj] <= kNegInf ? 0.0f : expf(s[i][jj] - mn);
        rs += p[jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty + 16 * i) * kPS + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc += P V for rows ty+16i, columns tx*ND+jd
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[ND];
        const float* vrow = vs + (c + u) * D + tx * ND;
        if constexpr (ND % 4 == 0) {
#pragma unroll
          for (int jd = 0; jd < ND; jd += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + jd);
            vv[jd] = x.x; vv[jd + 1] = x.y; vv[jd + 2] = x.z; vv[jd + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int jd = 0; jd < ND; ++jd)
            vv[jd] = tx * ND + jd < D ? vrow[jd] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pw = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                         : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jd = 0; jd < ND; ++jd)
            acc[i][jd] = fmaf(pw, vv[jd], acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int dd = tx * ND + jd;
      if (dd < D) op[(int64_t)qi * D + dd] = Vec<T>::store(acc[i][jd] / lc);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, float scale,
                   int causal, int window, float softcap, cudaStream_t st) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  attn_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Skv, int D,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t st) {
#define FA_CASE(DD)                                                        \
  case DD:                                                                 \
    return launch<T, DD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal,   \
                         window, softcap, st);
  switch (D) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v and o alike).  Tensors contiguous
// (B, H, S, D) with 16-byte aligned bases; D one of 8, 16, 32, 64, 128,
// 256 (else cudaErrorInvalidValue).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int B, int Hq, int Hkv,
                               int Sq, int Skv, int D, float scale,
                               int causal, int window, float softcap,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal,
                           window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale,
                                   causal, window, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
