// Split-KV decode attention for NVIDIA Hopper (sm_90a), with a plain C
// interface: one new query token per request against a KV cache, in one
// launch — each split of the cache reduced to partial (max, sum,
// unnormalised output), and the splits merged by the last CTA of each KV
// head.
//
// Replaces: src/repro/kernels/flash_attention/decode_kernel.py,
// flash_decode_pallas / _decode_kernel, and the log-sum-exp merge of the
// splits that the reference leaves to XLA outside the Pallas kernel.
//
// Computes, for q (B, Hkv, G, D) (G = Hq/Hkv query rows per KV head), k
// and v (B, Hkv, S, D), the cache fp32 or bf16 and q either, split si
// covering cache
// slots [si*split, min((si+1)*split, kv_len, S)):
//   s[g, j] = cap(scale * q[b, hk, g] . k[b, hk, j])
//   m[g] = max_j s[g, j],  l[g] = sum_j exp(s[g, j] - m[g]),
//   o[g] = sum_j exp(s[g, j] - m[g]) v[b, hk, j]
// all fp32, with cap(x) = softcap * tanh(x / softcap) when softcap > 0;
// then out[g] = sum_si e^(m_si - M) o_si / max(sum_si e^(m_si - M) l_si,
// 1e-30) with M = max_si m_si, in q's dtype (a serving path may keep an
// fp32 query beside a bf16 cache, as the reference does).  Slots at or
// past kv_len add
// exactly 0; a split with none below kv_len gives m = -1e30, l = 0, o = 0.
// kv_len is a runtime argument: a new decode position launches the same
// code.
//
// Design.  Grid (splits, Hkv x ceil(G / GM), B), 4 warps a CTA; each CTA
// takes up to GM query rows of one KV head (a group above 8 is cut into
// chunks of 8, each chunk reading the head's K/V; the package's models have
// G <= 8).  Each warp streams its own slots of the split, 16-byte cp.async
// copies into its own ring of stages in shared memory a few iterations
// ahead of use, and keeps its own online-softmax state: the slot loop has
// no CTA barrier.  Two paths:
//   - bf16 cache, D >= 64 (the LM's): 16 slots a warp iteration on the
//     tensor cores with mma.sync m16n8k16.  S = Q K^T has the CTA's query
//     rows as rows 0-7 of the A operand (rows 8-15 zero) and K^T's
//     fragments from ldmatrix; P V takes P from registers, P_hi = bf16(P)
//     in rows 0-7 and P_lo = bf16(P - P_hi) in rows 8-15, so that the
//     padding rows carry the low half for free and P is held to 2^-16;
//     V's fragments from ldmatrix.trans.  q's rows come straight from
//     memory (no cast on the host): a bf16 q as it is, an fp32 q split the
//     same way, Q_hi in rows 0-7 and Q_lo in rows 8-15 of the Q K^T
//     product, whose two halves of each score are added (q held to 2^-16);
//     scale applies to the fp32 sum.
//   - fp32 caches and D < 64: FP32 FMA.  LPR lanes share a slot's row,
//     a warp step covers 32/LPR slots; scores are reduced over the row's
//     lanes with shuffles; each group of lanes that shares a slot row keeps
//     its own (m, l, o) per query row, merged over shuffles after the loop.
// The CTA's warps merge once through shared memory, in a fixed order.  Each
// CTA writes its split's partials; the last CTA of each (b, hk, chunk) to
// finish — told by a __threadfence() and an atomic ticket in a small int32
// workspace, which that CTA resets to 0 for the next launch — merges all
// splits in split order and writes out.  No float atomics: a launch's
// result does not depend on the CTAs' order, and repeats bit-identically.
// With out null the kernel writes the partials only (every split of the
// grid, empty ones included).
//
// Bound.  Bytes: the K/V read, 2*B*Hkv*kv_len*D*sizeof(T), over 3.35 TB/s;
// the partials, q and out are ~G/split of that.  The operations (4*G*D per
// slot) are far below the tensor-core rate; on the FP32 pipes (the scalar
// path) they take about as long as the bytes at G = 8, which is why bf16
// takes the tensor cores.  What the design does about the bytes: each live
// K/V byte is read once (per chunk of 8 query rows), in coalesced 16-byte
// copies, several iterations in flight per warp and no barrier in the loop,
// by enough CTAs (decode_kernel.py plans the splits from the live length)
// to keep every SM streaming; splits past kv_len are not launched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 32;   // query rows per KV head
constexpr float kNegInf = -1e30f;
constexpr int kStages = 4;        // a warp's cp.async ring depth
constexpr int kStageVecs = 128;   // 16-byte chunks a stage holds: K, V

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ __forceinline__ static void to_float(const uint4& x,
                                                  float* out) {
    out[0] = __uint_as_float(x.x);
    out[1] = __uint_as_float(x.y);
    out[2] = __uint_as_float(x.z);
    out[3] = __uint_as_float(x.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& x,
                                                  float* out) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// How a warp covers the cache: LPR lanes per slot row, VPL 16-byte loads
// per lane per row, RPI slot rows per warp step, U steps per iteration.
template <typename T, int D>
struct Plan {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int NV = D / VEC;  // 16-byte vectors per row
  static constexpr int LPR = NV < 32 ? NV : 32;
  static constexpr int VPL = NV / LPR;
  static constexpr int RPI = 32 / LPR;
  static constexpr int U = VPL >= 2 ? 1 : 2;
  static constexpr int SPI = U * RPI;  // slots per warp iteration
  static constexpr int EPL = VPL * VEC;  // columns a lane owns
};

// 16 bytes from global to shared memory, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

// Where a CTA's split goes: the partials (m, l: (B, Hkv, splits, G); o:
// (B, Hkv, splits, G, D)), the tickets, and which rows it holds.
struct SplitArgs {
  float* m_part;
  float* l_part;
  float* o_part;
  unsigned int* tickets;
  int G, g0, Gc;
  int64_t bh;
  int si, splits;
};

// The end of both kernels, once each warp w has left its (m, l, o) of the
// CTA's rows in shared memory (wm[w * GM + g], wl[...], wo[w * wstride +
// g * D + d]) and the CTA has synchronised: merge the warps in order and
// write the split's partials; then, unless out is null, the last CTA of
// this (b, hk, chunk) to finish merges every split, in split order, and
// writes out.  It learns that it is last from an atomic ticket, which it
// resets to 0 for the next launch.
template <int D, int GM>
__device__ __forceinline__ void finish_split(const float* wo, int wstride,
                                             const float* wm,
                                             const float* wl,
                                             const SplitArgs& a, void* out,
                                             bool out_f32, int* is_last) {
  const int tid = threadIdx.x;
  const int64_t part = (a.bh * a.splits + a.si) * a.G + a.g0;
  for (int e = tid; e < a.Gc * D; e += kThreads) {
    const int g = e / D;
    float mx = wm[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GM + g]);
    float acc = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(wm[w * GM + g] - mx);
      acc += f * wo[w * wstride + e];
      den += f * wl[w * GM + g];
    }
    a.o_part[part * D + e] = acc;
    if (e % D == 0) {
      a.m_part[part + g] = mx;
      a.l_part[part + g] = den;
    }
  }
  if (out == nullptr) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int* ticket = a.tickets + blockIdx.z * gridDim.y + blockIdx.y;
    const bool last = atomicAdd(ticket, 1u) == (unsigned int)a.splits - 1;
    if (last) *ticket = 0;  // ready for the next launch
    *is_last = last;
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  const int64_t first = a.bh * a.splits * a.G + a.g0;  // (split 0, g0)
  for (int e = tid; e < a.Gc * D; e += kThreads) {
    const int g = e / D;
    float mx = kNegInf, acc = 0.0f, den = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.splits; ++s) {
      const int64_t r = first + (int64_t)s * a.G + g;
      const float ms = __ldcg(a.m_part + r), ls = __ldcg(a.l_part + r);
      const float os = __ldcg(a.o_part + r * D + e % D);
      const float mn = fmaxf(mx, ms);
      const float f0 = __expf(mx - mn), f1 = __expf(ms - mn);
      den = den * f0 + ls * f1;
      acc = acc * f0 + os * f1;
      mx = mn;
    }
    const int64_t at = (a.bh * a.G + a.g0) * D + e;
    const float y = acc / fmaxf(den, 1e-30f);
    if (out_f32)
      static_cast<float*>(out)[at] = y;
    else
      static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(y);
  }
}

// GM: the most query rows per KV head a CTA takes (2 or 8); it sizes the
// per-lane accumulators.  CAP: softcap > 0 (a separate build, so that
// uncapped scores pay nothing for it).
template <typename T, int D, int GM, bool CAP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ m_part,
              float* __restrict__ l_part, float* __restrict__ o_part,
              void* __restrict__ out, unsigned int* __restrict__ tickets,
              int q_f32, int G, int S, int kv_len, int split, float scale,
              float softcap) {
  using P = Plan<T, D>;
  constexpr int EPL = P::EPL, LPR = P::LPR, U = P::U, VPL = P::VPL;
  __shared__ __align__(16) float qs[GM * D];  // this CTA's rows, scaled
  // the warps' K/V rings; after the slot loop, their (o) partials
  __shared__ __align__(16) uint4 ring_raw[kWarps * kStages * kStageVecs];
  // warp w's partial o: [GM][D] at the start of its own ring
  float* wo = reinterpret_cast<float*>(ring_raw);
  constexpr int kRingFloats = kStages * kStageVecs * 4;  // one warp's ring
  static_assert(GM * D <= kRingFloats, "o partials fit a warp's ring");
  static_assert(2 * 32 * U * VPL == kStageVecs, "a stage is one iteration");
  __shared__ float wm[kWarps * GM], wl[kWarps * GM];
  __shared__ int is_last;

  const int si = blockIdx.x, splits = gridDim.x;
  const int chunks = (G + GM - 1) / GM;
  const int hk = blockIdx.y / chunks, gc = blockIdx.y - hk * chunks;
  const int Hkv = gridDim.y / chunks, b = blockIdx.z;
  const int g0 = gc * GM, Gc = min(GM, G - g0);
  const int64_t bh = (int64_t)b * Hkv + hk;
  const int s_lo = si * split;
  const int s_hi = min(s_lo + split, min(kv_len, S));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPR, cl = lane % LPR;

  for (int e = tid; e < Gc * D; e += kThreads) {
    const int64_t at = (bh * G + g0) * D + e;
    qs[e] = (q_f32 ? static_cast<const float*>(q)[at]
                   : __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[at])) *
            scale;
  }
  __syncthreads();

  float m[GM], l[GM], o[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[g][e] = 0.0f;
  }
  // Each warp streams iterations i = 0, 1, ... of SPI slots (slot base
  // s_lo + (warp + kWarps i) SPI) through its own ring of kStages stages in
  // shared memory with cp.async, kStages - 1 iterations ahead.  A lane
  // copies exactly the 16-byte chunks it reads back, so it waits for its
  // own copies only: no barrier, not even a warp's.
  const T* kb = k + bh * S * D + cl * P::VEC;
  const T* vb = v + bh * S * D + cl * P::VEC;
  uint4* ring = reinterpret_cast<uint4*>(ring_raw) +
                warp * kStages * kStageVecs;
  const int n_iter = max(0, (s_hi - s_lo - warp * P::SPI + kWarps * P::SPI -
                             1) / (kWarps * P::SPI));
  auto issue = [&](int i) {
    if (i < n_iter) {
      uint4* stage = ring + (i % kStages) * kStageVecs;
      const int base = s_lo + (warp + kWarps * i) * P::SPI;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = base + u * P::RPI + rg;
        const bool ok = slot < s_hi;
#pragma unroll
        for (int w = 0; w < VPL; ++w) {
          const int64_t off = ok ? (int64_t)slot * D + w * LPR * P::VEC : 0;
          const int at = (u * VPL + w) * 32 + lane;
          cp_async16(stage + at, kb + off, ok);
          cp_async16(stage + kStageVecs / 2 + at, vb + off, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  for (int i = 0; i < n_iter; ++i) {
    issue(i + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const uint4* stage = ring + (i % kStages) * kStageVecs;
    const int base = s_lo + (warp + kWarps * i) * P::SPI;
    uint4 kr[U][VPL], vr[U][VPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = base + u * P::RPI + rg < s_hi;
#pragma unroll
      for (int w = 0; w < VPL; ++w) {
        const int at = (u * VPL + w) * 32 + lane;
        kr[u][w] = stage[at];
        vr[u][w] = stage[kStageVecs / 2 + at];
      }
    }
    float kf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int w = 0; w < VPL; ++w)
        Vec<T>::to_float(kr[u][w], &kf[u][w * P::VEC]);

    // scores of this lane group's slots, reduced over the row's lanes
    float sc[GM][U];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= Gc) break;
      float qv[EPL];
#pragma unroll
      for (int w = 0; w < VPL; ++w)
#pragma unroll
        for (int e = 0; e < P::VEC; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              qs + g * D + (cl + w * LPR) * P::VEC + e);
          qv[w * P::VEC + e] = x.x;
          qv[w * P::VEC + e + 1] = x.y;
          qv[w * P::VEC + e + 2] = x.z;
          qv[w * P::VEC + e + 3] = x.w;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qv[e], kf[u][e], d);
#pragma unroll
        for (int off = 1; off < LPR; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (CAP) d = softcap * tanhf(d / softcap);
        sc[g][u] = ok[u] ? d : kNegInf;
      }
    }

    float vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int w = 0; w < VPL; ++w)
        Vec<T>::to_float(vr[u][w], &vf[u][w * P::VEC]);
    // online softmax of each query row over this lane group's slots
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= Gc) break;
      float mx = sc[g][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[g][u]);
      const float mn = fmaxf(m[g], mx);
      const float al = __expf(m[g] - mn);
      m[g] = mn;
      float p[U], rs = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = sc[g][u] <= kNegInf ? 0.0f : __expf(sc[g][u] - mn);
        rs += p[u];
      }
      l[g] = l[g] * al + rs;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = o[g][e] * al;
#pragma unroll
        for (int u = 0; u < U; ++u) x = fmaf(p[u], vf[u][e], x);
        o[g][e] = x;
      }
    }
  }

  // merge the warp's lane groups (lanes cl, cl + LPR, ...), then the CTA's
  // warps, in a fixed order
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = __expf(m[g] - mn), c = __expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float oo = __shfl_xor_sync(0xffffffffu, o[g][e], off);
        o[g][e] = o[g][e] * a + oo * c;
      }
      m[g] = mn;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= Gc) break;
#pragma unroll
      for (int w = 0; w < VPL; ++w)
#pragma unroll
        for (int e = 0; e < P::VEC; ++e)
          wo[warp * kRingFloats + g * D + (cl + w * LPR) * P::VEC + e] =
              o[g][w * P::VEC + e];
      if (cl == 0) {
        wm[warp * GM + g] = m[g];
        wl[warp * GM + g] = l[g];
      }
    }
  }
  __syncthreads();
  finish_split<D, GM>(wo, kRingFloats, wm, wl,
                      SplitArgs{m_part, l_part, o_part, tickets, G, g0, Gc,
                                bh, si, splits},
                      out, q_f32, &is_last);
}

// ---- bf16, D >= 64: scores and P V on the tensor cores (mma.sync) ------ //
constexpr int kMmaSlots = 16;  // cache slots a warp takes per iteration
constexpr int kMmaStages = 3;  // a warp's cp.async ring depth

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte chunk c of row r of a stage's [rows][D] tile, swizzled so that
// the 8 rows an ldmatrix reads at one chunk fall in distinct banks
template <int D>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * (D / 8) + ((c & ~7) | ((c ^ r) & 7));
}

// The rows of the m16n8k16 products: query rows g (0..7) of the CTA's
// chunk; rows 8..15 of the A operand carry P's low half (P = P_hi + P_lo,
// both bf16) in the P V product, and in the Q K^T product q's low half
// when q is fp32 (Q = Q_hi + Q_lo), zeros when it is bf16.
template <int D, bool CAP>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const void* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ o_part, void* __restrict__ out,
                  unsigned int* __restrict__ tickets, int q_f32, int G,
                  int S, int kv_len, int split, float scale, float softcap) {
  constexpr int GM = 8;
  constexpr int kChunks = kMmaSlots * D / 8;  // 16-byte chunks of K (or V)
  constexpr int kStageChunks = 2 * kChunks;   // K then V
  extern __shared__ __align__(16) uint4 ring_all[];
  __shared__ float wm[kWarps * GM], wl[kWarps * GM];
  __shared__ int is_last;

  const int si = blockIdx.x, splits = gridDim.x;
  const int chunks = (G + GM - 1) / GM;
  const int hk = blockIdx.y / chunks, gc = blockIdx.y - hk * chunks;
  const int Hkv = gridDim.y / chunks, b = blockIdx.z;
  const int g0 = gc * GM, Gc = min(GM, G - g0);
  const int64_t bh = (int64_t)b * Hkv + hk;
  const int s_lo = si * split;
  const int s_hi = min(s_lo + split, min(kv_len, S));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;  // fragment row, column pair

  // Q's A fragments, straight from q: rows 0..7 Q_hi, rows 8..15 Q_lo
  // (zero for a bf16 q, which is exact as it is)
  uint32_t qa[D / 16][2], ql[D / 16][2];
  {
    const int64_t at = (bh * G + g0 + gr) * D;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * ks + 8 * h + 2 * t;
        qa[ks][h] = ql[ks][h] = 0u;
        if (gr >= Gc) continue;
        if (q_f32) {
          const float* qf = static_cast<const float*>(q) + at + col;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(qf[0], qf[1]);
          const float2 hf = __bfloat1622float2(hi);
          qa[ks][h] = *reinterpret_cast<const uint32_t*>(&hi);
          ql[ks][h] = pack2(qf[0] - hf.x, qf[1] - hf.y);
        } else {
          qa[ks][h] = *reinterpret_cast<const uint32_t*>(
              static_cast<const __nv_bfloat16*>(q) + at + col);
        }
      }
  }

  uint4* ring = ring_all + warp * kMmaStages * kStageChunks;
  const int n_iter = max(0, (s_hi - s_lo - warp * kMmaSlots +
                             kWarps * kMmaSlots - 1) / (kWarps * kMmaSlots));
  const __nv_bfloat16* kb = k + bh * S * D;
  const __nv_bfloat16* vb = v + bh * S * D;
  auto issue = [&](int i) {
    if (i < n_iter) {
      uint4* stage = ring + (i % kMmaStages) * kStageChunks;
      const int base = s_lo + (warp + kWarps * i) * kMmaSlots;
#pragma unroll
      for (int j = lane; j < kChunks; j += 32) {
        const int r = j / (D / 8), c = j % (D / 8);
        const bool ok = base + r < s_hi;
        const int64_t off = ok ? (int64_t)(base + r) * D + 8 * c : 0;
        cp_async16(stage + chunk_at<D>(r, c), kb + off, ok);
        cp_async16(stage + kChunks + chunk_at<D>(r, c), vb + off, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) issue(i);

  float acc[D / 8][4];  // O: rows gr (P_hi V) and gr + 8 (P_lo V)
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m = kNegInf, l = 0.0f;  // row gr; l is this lane's part

  for (int i = 0; i < n_iter; ++i) {
    issue(i + kMmaStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaStages - 1)
                 : "memory");
    __syncwarp();  // every lane's copies of this stage have landed
    const uint4* kt = ring + (i % kMmaStages) * kStageChunks;
    const uint4* vt = kt + kChunks;
    const int base = s_lo + (warp + kWarps * i) * kMmaSlots;

    // S (16 x 16 slots) = Q K^T: ldmatrix gives K^T's B fragments for
    // slots 0-7 (r[0], r[1]) and 8-15 (r[2], r[3]) of a 16-wide d step
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t r[4];
      const int mi = lane >> 3;  // the matrix this lane addresses
      ldsm_x4(r, kt + chunk_at<D>(8 * (mi >> 1) + (lane & 7),
                                  2 * ks + (mi & 1)));
      const uint32_t a[4] = {qa[ks][0], ql[ks][0], qa[ks][1], ql[ks][1]};
      mma_bf16(sc[0], a, r[0], r[1]);
      mma_bf16(sc[1], a, r[2], r[3]);
    }

    // row gr's scores: slots base + 8n + 2t + e, Q_hi's part in sc[n][e]
    // (e < 2) and Q_lo's in sc[n][e + 2] (exactly 0 for a bf16 q)
    float x[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y = (sc[n][e] + sc[n][e + 2]) * scale;
        if (CAP) y = softcap * tanhf(y / softcap);
        x[2 * n + e] = base + 8 * n + 2 * t + e < s_hi ? y : kNegInf;
      }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float al = __expf(m - mn);
    m = mn;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = x[e] <= kNegInf ? 0.0f : __expf(x[e] - mn);
    l = l * al + (p[0] + p[1]) + (p[2] + p[3]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= al;

    // P's A fragment over the 16 slots: rows gr = P_hi, gr + 8 = P_lo
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * n], p[2 * n + 1]);
      const float2 hf = __bfloat1622float2(hi);
      pa[2 * n] = *reinterpret_cast<const uint32_t*>(&hi);
      pa[2 * n + 1] = pack2(p[2 * n] - hf.x, p[2 * n + 1] - hf.y);
    }
    // O += P V: ldmatrix.trans gives V's B fragments for d tiles 2j, 2j+1
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t r[4];
      const int mi = lane >> 3;
      ldsm_x4_trans(r, vt + chunk_at<D>(8 * (mi & 1) + (lane & 7),
                                        2 * j + (mi >> 1)));
      mma_bf16(acc[2 * j], pa, r[0], r[1]);
      mma_bf16(acc[2 * j + 1], pa, r[2], r[3]);
    }
    __syncwarp();  // the stage is read before it is refilled
  }

  // this warp's (m, l, o) of rows g: l over the row's 4 lanes, o = hi + lo
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  float* wo = reinterpret_cast<float*>(ring);  // [GM][D], this warp's ring
  constexpr int kRingFloats = kMmaStages * kStageChunks * 4;
  static_assert(GM * D <= kRingFloats, "o partials fit a warp's ring");
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    wo[gr * D + 8 * j + 2 * t] = acc[j][0] + acc[j][2];
    wo[gr * D + 8 * j + 2 * t + 1] = acc[j][1] + acc[j][3];
  }
  if (t == 0) {
    wm[warp * GM + gr] = m;
    wl[warp * GM + gr] = l;
  }
  __syncthreads();
  finish_split<D, GM>(
      reinterpret_cast<const float*>(ring_all), kRingFloats, wm, wl,
      SplitArgs{m_part, l_part, o_part, tickets, G, g0, Gc, bh, si, splits},
      out, q_f32, &is_last);
}

template <int D>
constexpr int mma_smem() {
  return kWarps * kMmaStages * 2 * kMmaSlots * D * 2;
}

template <typename T, int D, int GM>
cudaError_t launch(const void* q, const void* k, const void* v, float* m,
                   float* l, float* o, void* out, unsigned int* tickets,
                   int q_f32, int B, int Hkv, int G, int S, int kv_len,
                   int splits, int split, float scale, float softcap,
                   cudaStream_t st) {
  const int chunks = (G + GM - 1) / GM;
  if ((int64_t)Hkv * chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(splits, Hkv * chunks, B);
  auto kernel = softcap > 0.0f ? decode_kernel<T, D, GM, true>
                               : decode_kernel<T, D, GM, false>;
  kernel<<<grid, kThreads, 0, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), m, l, o, out,
      tickets, q_f32, G, S, kv_len, split, scale, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, float* m,
                       float* l, float* o, void* out, unsigned int* tickets,
                       int q_f32, int B, int Hkv, int G, int S, int kv_len,
                       int splits, int split, float scale, float softcap,
                       cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int chunks = (G + 7) / 8;
  if ((int64_t)Hkv * chunks > 65535) return cudaErrorInvalidConfiguration;
  static bool configured = false;  // one attribute call per head dim
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<D, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem<D>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_mma_kernel<D, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 mma_smem<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(splits, Hkv * chunks, B);
  auto kernel = softcap > 0.0f ? decode_mma_kernel<D, true>
                               : decode_mma_kernel<D, false>;
  kernel<<<grid, kThreads, mma_smem<D>(), st>>>(
      q, static_cast<const bf16*>(k), static_cast<const bf16*>(v), m, l, o,
      out, tickets, q_f32, G, S, kv_len, split, scale, softcap);
  return cudaGetLastError();
}

#define FD_ARGS q, k, v, m, l, o, out, tickets, q_f32, B, Hkv, G, S, kv_len, \
                splits, split, scale, softcap, st
#define FD_SCALAR(T, DD)                                                      \
  case DD:                                                                    \
    return G <= 2 ? launch<T, DD, 2>(FD_ARGS) : launch<T, DD, 8>(FD_ARGS);

// fp32 cache: the scalar kernel at every head dim; bf16 cache: the
// tensor-core kernel from D = 64 up, the scalar one below; q of either
// dtype on every route
cudaError_t dispatch(int dtype, int q_f32, const void* q, const void* k,
                     const void* v, float* m, float* l, float* o, void* out,
                     unsigned int* tickets, int B, int Hkv, int G, int S,
                     int D, int kv_len, int splits, int split, float scale,
                     float softcap, cudaStream_t st) {
  if (dtype == 0) {
    switch (D) {
      FD_SCALAR(float, 8)
      FD_SCALAR(float, 16)
      FD_SCALAR(float, 32)
      FD_SCALAR(float, 64)
      FD_SCALAR(float, 128)
      FD_SCALAR(float, 256)
    }
  } else if (dtype == 1) {
    switch (D) {
      FD_SCALAR(__nv_bfloat16, 8)
      FD_SCALAR(__nv_bfloat16, 16)
      FD_SCALAR(__nv_bfloat16, 32)
      case 64:
        return launch_mma<64>(FD_ARGS);
      case 128:
        return launch_mma<128>(FD_ARGS);
      case 256:
        return launch_mma<256>(FD_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}
#undef FD_SCALAR
#undef FD_ARGS

}  // namespace

extern "C" int flash_decode_supports(int G, int D) {
  return G >= 1 && G <= kMaxGroup &&
         (D == 8 || D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// q (B, Hkv, G, D) of q_dtype and k and v (B, Hkv, S, D) of dtype (0:
// fp32, 1: bf16; out takes q's), all contiguous, with 16-byte aligned
// bases.  ws holds the
// partials, fp32: m and l (B, Hkv, splits, G) then o (B, Hkv, splits, G,
// D); every split of the grid is written.  When out is not null (then
// splits = ceil(min(kv_len, S) / split)), the same launch merges them into
// out (B, Hkv*G, D), and tickets must hold B * Hkv * ceil(G / GM) zeros
// (GM = 2 for G <= 2, else 8: B * Hkv * 4 ints cover every G <= 32), which
// the launch leaves at 0.  Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            float* ws, void* out, unsigned int* tickets,
                            int dtype, int q_dtype, int B, int Hkv, int G,
                            int S, int D,
                            int kv_len, int splits, int split, float scale,
                            float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || B > 65535 || S < 1 || kv_len < 1 || splits < 1 ||
      split < 1 || !flash_decode_supports(G, D) || q_dtype < 0 ||
      q_dtype > 1 ||
      (out != nullptr && tickets == nullptr))
    return cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * Hkv * G;
  float* m = ws;
  float* l = ws + rows * splits;
  float* o = ws + 2 * rows * splits;
  return dispatch(dtype, q_dtype == 0, q, k, v, m, l, o, out, tickets, B,
                  Hkv, G, S, D, kv_len, splits, split, scale, softcap, st);
}

extern "C" const char* flash_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
