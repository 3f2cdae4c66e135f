// Backward of flash attention on the Hopper tensor cores (sm_90a, wgmma,
// TMA), bf16 at head dims 64 and 128, with a plain C interface: dQ, dK and
// dV of softmax attention with GQA, causal or bidirectional masking, a
// sliding window and tanh logit capping.  kernel.py's
// attention_bwd_route(dtype, D) sends every other case (fp32, D 8-32, D
// 256, whose dK and dV accumulators alone would take 256 registers a
// thread) to the FP32 FMA backward, flash_attention_bwd.cu.
//
// Replaces: flash_attention_bwd.cu (the port's first backward, FP32 FMA) on
// the training path, and so XLA's autodiff of attention_ref
// (src/repro/kernels/flash_attention/ref.py) in the reference, which has no
// TPU backward kernel.
//
// Computes what flash_attention_bwd.cu computes, for q (B, Hq, Sq, D), k
// and v (B, Hkv, Skv, D), group = Hq/Hkv, the forward's output o, the
// output gradient dout and the forward's logsumexp lse (B, Hq, Sq):
//   x[i, j]  = scale * q[i] . k[j],  s = softcap * tanh(x / softcap)
//   p[i, j]  = exp(s[i, j] - lse[i])             (0 where masked)
//   dp[i, j] = dout[i] . v[j],  delta[i] = dout[i] . o[i]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) (1 - tanh^2(x / softcap))
//   dq[i] = scale sum_j ds[i, j] k[j]
//   dk[j] = scale sum_{h in group, i} ds[i, j] q[i]
//   dv[j] = sum_{h in group, i} p[i, j] dout[i]
// (s = x and no tanh factor without softcap).  The mask is the forward's;
// a row whose keys are all masked has lse = +1e30 (the forward stores it),
// so p = 0 there.
//
// Bound.  The backward needs five products of the forward's size (S, dP,
// dQ, dK, dV: 2.5x its 4*B*Hq*Sq*Skv*D flops, halved when causal): at
// TinyLlama's training shape (8 x 32/4 heads x 512, D 64, causal) 21.5
// GFLOP, 0.022 ms at the card's 989 TFLOP/s bf16 tensor-core rate; the
// bytes (q, k, v, o, dout read, dq, dk, dv written) need about as long at
// 3.35 TB/s.  The FMA backward ran its products on the FP32 pipes (67
// TFLOP/s at best) and recomputed the scores three times, one sweep only
// to rebuild lse.  Here every product is a wgmma on bf16 tiles, lse comes
// from the forward, and the scores are computed twice (S in the first
// kernel, S^T in the second): 3.5x the forward's flops in all.
//
// Design: two kernels a call, no atomics; every sum is taken in a fixed
// order, so a repeat gives the same bits.
//  1. dq_kernel, one CTA of two warpgroups per (128 q rows, q head, batch),
//     heaviest causal tiles first; each warpgroup owns 64 query rows (the
//     wgmma M).  Thread 0 also loads, by TMA in the forward's 128-byte
//     swizzle: q and dout once, then the visible K and V tiles through a
//     ring of kStages stages guarded by mbarriers, refilled without
//     blocking where it can (the forward's scheme).  The CTA first forms
//     delta = rowsum(dout * o) for its rows (dout from shared memory, o
//     from device memory) and writes (lse * log2 e, delta) per row to a
//     scratch the second kernel reads.  Per KV tile: S = Q K^T and dP =
//     dO V^T on wgmma (both operands K-major in shared memory); scale,
//     softcap and, only on tiles that cross the diagonal, the window's edge
//     or Skv, the element masks; P = 2^(x log2 e - lse log2 e); dS; then
//     dQ += dS K on wgmma with dS as bf16 register fragments (the
//     accumulator layout of 16 columns is the A layout of one k-step) and K
//     MN-major through the descriptor's transpose bit.  Software-pipelined
//     as the forward: tile it's S and dP are issued with tile it-1's dQ
//     product, and tile it's dS is formed while that product runs.
//  2. dkdv_kernel, one CTA of one warpgroup per (64 keys, KV head, batch),
//     the keys that causal attention's most q tiles see first.  It loads
//     its K and V tiles once, then sweeps every q head of its GQA group
//     and every q tile that sees the keys: q, dout and the rows' (lse,
//     delta) through a ring of stages (TMA, and a bulk copy for the
//     scratch).  Per step: S^T = K Q^T and dP^T = V dO^T on wgmma, P^T and
//     dS^T elementwise (each thread's columns are query rows), then dV +=
//     P^T dO and dK += dS^T Q, both with register fragments and the q-side
//     tile MN-major.  dK and dV stay in registers and are written once.
// Tiles the mask hides wholly (above the causal diagonal, left of the
// window) are never loaded.  TMA's zero fill covers the ragged ends: a q
// row past Sq has lse = +1e30 in the scratch (p = 0), a key past Skv is
// masked in the first kernel and only reaches its own unstored dK, dV rows
// in the second.  q, k, v, o and dout are (B, H, S, D) views with a
// contiguous last dim and batch, head and row strides that are multiples
// of 8 elements (the LM's transposed (B, S, H, D) projections as they
// are); dq, dk and dv come out contiguous.
//
// Precision.  P and dS enter the tensor cores as bf16, rounded to nearest
// once (kSplit false); every sum is fp32.  kSplit true feeds each as two
// bf16 halves, hi + lo, as the forward does for P (doubling the tensor work
// of the three products that read them): chip_smoke.py's phase 3 passes
// without it at its unchanged bound (2^-7 of the largest magnitude).
#include "wgmma_tma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoRow = 1e30f;  // lse of a row whose keys are all masked
// P and dS to the tensor cores as two bf16 halves (true) or rounded once
constexpr bool kSplit = false;

template <int D>
struct DqCfg {
  static constexpr int BQ = 128;      // query rows per CTA (two warpgroups)
  static constexpr int BK = 64;       // keys per KV tile
  static constexpr int kThreads = 256;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kSlabs = D / 64;       // 64-column slabs
  static constexpr int kQSlab = BQ * 128;     // bytes of a q / dout slab
  static constexpr int kKVSlab = BK * 128;    // bytes of a K / V slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKVSlab;
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes;
};

template <int D>
struct KvCfg {
  static constexpr int BK = 64;       // keys per CTA (one warpgroup)
  static constexpr int BQ = 64;       // query rows per step
  static constexpr int kThreads = 128;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kSlabs = D / 64;
  static constexpr int kKSlab = BK * 128;
  static constexpr int kKBytes = kSlabs * kKSlab;
  static constexpr int kQSlab = BQ * 128;
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kLdBytes = BQ * 8;     // (lse2, delta) per q row
  static constexpr int kStage = 2 * kQBytes + 1024;  // q, dout, (lse2, delta)
  static constexpr int kSmem = 1024 + 2 * kKBytes + kStages * kStage;
};

// rows of the (lse2, delta) scratch per (batch, q head): Sq rounded up to
// the first kernel's 128-row tiles, which write every row of theirs
__host__ __device__ __forceinline__ int padded_rows(int Sq) {
  return (Sq + 127) / 128 * 128;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// C (64 x N) = A (64 x D) B^T, A and B bf16 K-major in shared memory with
// their 64-column slabs ASLAB and BSLAB bytes apart; over D in steps of 16
// (32 bytes inside a 128-byte row).  The caller fences and commits.
template <int D, int N, int ASLAB, int BSLAB>
__device__ __forceinline__ void mma_nt(float (&c)[N / 2], const uint8_t* a,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk / 4, off = 32 * (kk % 4);
    wgmma_ss<N>(c, sw128_desc(a + slab * ASLAB + off, 16),
                sw128_desc(b + slab * BSLAB + off, 16), kk > 0);
  }
}

// C (64 x D) += A (64 x K, bf16 register fragments) B (K x D), B bf16
// MN-major in shared memory (rows of 128 bytes, 64-column slabs BSLAB
// apart); over K in steps of 16 rows.  The caller fences and commits.
template <int D, int K, int BSLAB>
__device__ __forceinline__ void mma_nn(float (&c)[D / 2],
                                       const uint32_t (&a)[K / 16][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(c, a[kk], sw128_desc(b + 2048 * kk, BSLAB));
}

// The A fragments of a 64 x K accumulator tile x: columns 16kk..16kk+15 of
// the accumulator layout are the A layout of k-step kk.  hi = x rounded to
// bf16; with kSplit, lo = x - hi rounded too.
template <int K>
__device__ __forceinline__ void to_frags(const float (&x)[K / 2],
                                         uint32_t (&hi)[K / 16][4],
                                         uint32_t (&lo)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], c = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      if constexpr (kSplit) {
        const float2 hf = __bfloat1622float2(h);
        lo[kk][r] = pack_bf16(a - hf.x, c - hf.y);
      }
    }
}

// C += A B for the fragments hi (and lo with kSplit)
template <int D, int K, int BSLAB>
__device__ __forceinline__ void mma_nn_split(float (&c)[D / 2],
                                             const uint32_t (&hi)[K / 16][4],
                                             const uint32_t (&lo)[K / 16][4],
                                             const uint8_t* b) {
  mma_nn<D, K, BSLAB>(c, hi, b);
  if constexpr (kSplit) mma_nn<D, K, BSLAB>(c, lo, b);
}

__device__ __forceinline__ bool visible(int q, int k, int Sq, int Skv,
                                        int causal, int window) {
  return q < Sq && k < Skv && (!causal || q >= k) &&
         (window <= 0 || q - k < window);
}

struct Elem {
  float sl, to_cap, cap2;  // scale log2 e; scale / softcap; softcap log2 e
  int Sq, Skv, causal, window;
};

// p = 2^(x2 - l2) of a raw score s (0 where masked, by the caller), with
// x2 the scaled (capped) score in base 2; dc the cap's derivative factor
template <bool CAP>
__device__ __forceinline__ float prob(float s, float l2, const Elem& e,
                                      float& dc) {
  if constexpr (CAP) {
    const float th = tanhf(s * e.to_cap);
    dc = 1.0f - th * th;
    return ex2(e.cap2 * th - l2);
  }
  dc = 1.0f;
  return ex2(fmaf(s, e.sl, -l2));
}

// dS of a dq_kernel tile in place of S: s[4c + e] is row r0 (e < 2) or
// r0 + 8, key k0 + 8c + cq + (e & 1)
template <bool MASK, bool CAP, int N>
__device__ __forceinline__ void ds_rows(float (&s)[N], const float (&dp)[N],
                                        const Elem& e, int r0, int k0,
                                        int cq, float l2_0, float l2_1,
                                        float d0, float d1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool lower = i & 2;
    float dc;
    float p = prob<CAP>(s[i], lower ? l2_1 : l2_0, e, dc);
    if (MASK) {
      const int q = r0 + (lower ? 8 : 0);
      const int k = k0 + 8 * (i >> 2) + cq + (i & 1);
      p = visible(q, k, e.Sq, e.Skv, e.causal, e.window) ? p : 0.0f;
    }
    s[i] = p * (dp[i] - (lower ? d1 : d0)) * dc;
  }
}

// P^T and dS^T of a dkdv_kernel step in place of S^T and dP^T: s[4c + e] is
// key kr0 (e < 2) or kr0 + 8, query q0 + 8c + cq + (e & 1), whose (lse2,
// delta) pair is ld[8c + cq + (e & 1)]
template <bool MASK, bool CAP, int N>
__device__ __forceinline__ void ds_cols(float (&s)[N], float (&dp)[N],
                                        const Elem& e, const float2* ld,
                                        int kr0, int q0, int cq) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 L = *reinterpret_cast<const float4*>(ld + 8 * c + cq);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * c + u;
      const float l2 = (u & 1) ? L.z : L.x, dl = (u & 1) ? L.w : L.y;
      float dc;
      float p = prob<CAP>(s[i], l2, e, dc);
      if (MASK) {
        const int k = kr0 + ((u & 2) ? 8 : 0);
        const int q = q0 + 8 * c + cq + (u & 1);
        p = visible(q, k, e.Sq, e.Skv, e.causal, e.window) ? p : 0.0f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - dl) * dc;
    }
  }
}

// A 64-row accumulator tile times mul as bf16, staged swizzled in a 64-row
// tile of shared memory (slabs of 64 rows x 128 B, SLAB bytes apart): row
// lr0 / lr0 + 8, columns 8c + cq (the forward's epilogue)
template <int D, int SLAB>
__device__ __forceinline__ void stage_rows(const float (&acc)[D / 2],
                                           float mul, uint8_t* tile, int lr0,
                                           int cq) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint8_t* slab = tile + (c / 8) * SLAB;
    const int chunk = c % 8, lr1 = lr0 + 8;
    *reinterpret_cast<uint32_t*>(slab + lr0 * 128 + 16 * (chunk ^ (lr0 & 7)) +
                                 2 * cq) =
        pack_bf16(acc[4 * c] * mul, acc[4 * c + 1] * mul);
    *reinterpret_cast<uint32_t*>(slab + lr1 * 128 + 16 * (chunk ^ (lr1 & 7)) +
                                 2 * cq) =
        pack_bf16(acc[4 * c + 2] * mul, acc[4 * c + 3] * mul);
  }
}

// rows [row0, row0 + 64) ∩ [0, nrows) of a staged tile to a contiguous
// (rows, D) bf16 matrix, 16 bytes a store, by the 128 threads t
template <int D, int SLAB>
__device__ __forceinline__ void store_rows(const uint8_t* tile,
                                           __nv_bfloat16* out, int row0,
                                           int nrows, int t) {
  for (int e = t; e < 64 * (D / 8); e += 128) {
    const int lr = e / (D / 8), c = e % (D / 8);
    const int row = row0 + lr;
    if (row >= nrows) continue;
    const uint8_t* src =
        tile + (c / 8) * SLAB + lr * 128 + 16 * ((c % 8) ^ (lr & 7));
    *reinterpret_cast<uint4*>(out + (int64_t)row * D + 8 * c) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// ---------------- kernel 1: delta, the (lse2, delta) scratch, dq --------- //
template <int D>
__global__ void __launch_bounds__(256, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh,
          int64_t oss, const float* __restrict__ lse, float2* __restrict__ ld,
          __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
          float scale, int causal, int window, float softcap) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_kv[kStages], bar_empty[kStages];
  __shared__ float s_l2[C::BQ], s_delta[C::BQ];
  uint8_t* sq = align1024(smem_raw);               // [slab][BQ][64]
  uint8_t* sdo = sq + C::kQBytes;                  // [slab][BQ][64]
  uint8_t* sk = sdo + C::kQBytes;                  // [stage][slab][BK][64]
  uint8_t* sv = sk + kStages * C::kKVBytes;        // [stage][slab][BK][64]

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * C::BQ;
  const int64_t row_base = (int64_t)b * Hq + h;  // (batch, head) row index

  // KV tiles any row of this q tile can see (the forward's early-out)
  const int q_last = min(q0 + C::BQ, Sq) - 1;
  int j_end = (Skv + BK - 1) / BK;
  if (causal) j_end = min(j_end, q_last / BK + 1);
  int j_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // the least key row q0 may see
    if (lo > 0) j_begin = min(lo / BK, j_end);
  }
  const int n_tiles = j_end - j_begin;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bar_kv[i], 1);
      mbar_init(&bar_empty[i], 8);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int it) {
    const int st = it % kStages, k0 = (j_begin + it) * BK;
    mbar_expect_tx(&bar_kv[st], 2 * C::kKVBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c) {
      tma_load(sk + st * C::kKVBytes + c * C::kKVSlab, &tk, &bar_kv[st],
               64 * c, k0, hk, b);
      tma_load(sv + st * C::kKVBytes + c * C::kKVSlab, &tv, &bar_kv[st],
               64 * c, k0, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_q, 2 * C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c) {
      tma_load(sq + c * C::kQSlab, &tq, &bar_q, 64 * c, q0, h, b);
      tma_load(sdo + c * C::kQSlab, &tdo, &bar_q, 64 * c, q0, h, b);
    }
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_kv(it);
  }
  // the forward's refill: later tiles go into the stage the tile kStages
  // before them freed (all 8 warps done with its dQ product); thread 0
  // blocks only before it needs a tile that is not loaded yet
  int next_load = min(kStages, n_tiles);
  auto refill = [&](bool block) {
    while (next_load < n_tiles) {
      const int old = next_load - kStages;
      uint64_t* bar = &bar_empty[old % kStages];
      const int parity = (old / kStages) & 1;
      if (block) mbar_wait(bar, parity);
      else if (!mbar_test(bar, parity)) return;
      load_kv(next_load++);
      if (block) return;
    }
  };

  const int cw = tid >> 7;             // warpgroup 0 or 1
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int row_lo = q0 + 64 * cw;     // this warpgroup's first row
  const int lr0 = 16 * warp + (lane >> 2);  // local rows lr0, lr0 + 8
  const int r0 = row_lo + lr0;
  const int cq = 2 * (lane & 3);       // column of s[0] within 8
  uint8_t* my_q = sq + cw * 64 * 128;  // this warpgroup's rows, slab 0
  uint8_t* my_do = sdo + cw * 64 * 128;

  // delta = rowsum(dout * o): two threads a row, each half of D in order
  mbar_wait(&bar_q, 0);
  {
    const int lr = t >> 1, half = t & 1, row = row_lo + lr;
    float acc = 0.0f;
    if (row < Sq) {
      const __nv_bfloat16* orow = o + b * osb + h * osh + row * oss;
#pragma unroll
      for (int c = half * (D / 16); c < (half + 1) * (D / 16); ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            my_do + (c / 8) * C::kQSlab + lr * 128 +
            16 * ((c % 8) ^ (lr & 7)));
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = __bfloat1622float2(o2[u]);
          const float2 y = __bfloat1622float2(d2[u]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const float l2 = row < Sq ? lse[row_base * Sq + row] * kLog2e : kNoRow;
      s_l2[64 * cw + lr] = l2;
      s_delta[64 * cw + lr] = acc;
      ld[row_base * padded_rows(Sq) + row] = make_float2(l2, acc);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }
  const float l2_0 = s_l2[64 * cw + lr0], l2_1 = s_l2[64 * cw + lr0 + 8];
  const float d0 = s_delta[64 * cw + lr0], d1 = s_delta[64 * cw + lr0 + 8];
  const Elem el{scale * kLog2e, scale / softcap, softcap * kLog2e,
                Sq,             Skv,             causal,
                window};
  auto tile_k = [&](int it) { return sk + (it % kStages) * C::kKVBytes; };
  auto tile_v = [&](int it) { return sv + (it % kStages) * C::kKVBytes; };
  auto phase = [&](int it) { return (it / kStages) & 1; };
  float s[BK / 2], dp[BK / 2];
  // dS of tile it in place of s (masks only where the tile needs them)
  auto grad_tile = [&](int it) {
    const int k0 = (j_begin + it) * BK;
    const bool mask = k0 + BK > Skv || (causal && k0 + BK - 1 > row_lo) ||
                      (window > 0 && row_lo + 63 - k0 >= window);
    if (softcap > 0.0f) {
      if (mask)
        ds_rows<true, true>(s, dp, el, r0, k0, cq, l2_0, l2_1, d0, d1);
      else
        ds_rows<false, true>(s, dp, el, r0, k0, cq, l2_0, l2_1, d0, d1);
    } else {
      if (mask)
        ds_rows<true, false>(s, dp, el, r0, k0, cq, l2_0, l2_1, d0, d1);
      else
        ds_rows<false, false>(s, dp, el, r0, k0, cq, l2_0, l2_1, d0, d1);
    }
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];

  // Software pipeline: tile it's S and dP are issued with tile it-1's dQ
  // product; tile it's dS is formed while that product runs, and packed
  // into the fragments only once it has finished.
  if (n_tiles > 0) {
    mbar_wait(&bar_kv[0], 0);
    wgmma_fence();
    mma_nt<D, BK, C::kQSlab, C::kKVSlab>(s, my_q, tile_k(0));
    mma_nt<D, BK, C::kQSlab, C::kKVSlab>(dp, my_do, tile_v(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grad_tile(0);
    to_frags<BK>(s, ds_hi, ds_lo);
  }
  for (int it = 1; it < n_tiles; ++it) {
    while (tid == 0 && next_load <= it) refill(true);
    __syncwarp();
    mbar_wait(&bar_kv[it % kStages], phase(it));
    wgmma_fence();
    mma_nt<D, BK, C::kQSlab, C::kKVSlab>(s, my_q, tile_k(it));
    mma_nt<D, BK, C::kQSlab, C::kKVSlab>(dp, my_do, tile_v(it));
    wgmma_commit();
    wgmma_fence();
    mma_nn_split<D, BK, C::kKVSlab>(acc, ds_hi, ds_lo, tile_k(it - 1));
    wgmma_commit();
    wgmma_wait<1>();  // S and dP of tile it
    fence_regs(s);
    fence_regs(dp);
    grad_tile(it);
    wgmma_wait<0>();  // dQ of tile it - 1
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_empty[(it - 1) % kStages]);
    to_frags<BK>(s, ds_hi, ds_lo);
    if (tid == 0) refill(false);
    __syncwarp();
  }
  if (n_tiles > 0) {
    wgmma_fence();
    mma_nn_split<D, BK, C::kKVSlab>(acc, ds_hi, ds_lo, tile_k(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // dq = scale * acc in bf16, staged in this warpgroup's own q rows
  stage_rows<D, C::kQSlab>(acc, scale, my_q, lr0, cq);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  store_rows<D, C::kQSlab>(my_q, dq + row_base * Sq * D, row_lo, Sq, t);
}

// ---------------- kernel 2: dk and dv ----------------------------------- //
template <int D>
__global__ void __launch_bounds__(128, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int Sq,
            int Skv, float scale, int causal, int window, float softcap) {
  using C = KvCfg<D>;
  constexpr int BQ = C::BQ, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[kStages],
      bar_empty[kStages];
  uint8_t* sk = align1024(smem_raw);        // [slab][64][64]
  uint8_t* sv = sk + C::kKBytes;            // [slab][64][64]
  uint8_t* ss = sv + C::kKBytes;            // [stage]: q, dout, (lse2, delta)

  const int tid = threadIdx.x;
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int k0 = blockIdx.y * C::BK;  // y = 0 first: causal's heaviest keys
  const int group = Hq / Hkv;
  const int pad = padded_rows(Sq);

  // the q tiles that see any key of this tile
  const int k_last = min(k0 + C::BK, Skv) - 1;
  const int i_begin = causal ? k0 / BQ : 0;
  int i_end = (Sq + BQ - 1) / BQ;
  if (window > 0) i_end = min(i_end, (k_last + window - 1) / BQ + 1);
  const int n_qt = max(i_end - i_begin, 0);
  const int n_steps = group * n_qt;  // q heads outer, q tiles inner

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bar_full[i], 1);
      mbar_init(&bar_empty[i], 4);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto step_q0 = [&](int it) { return (i_begin + it % n_qt) * BQ; };
  auto load_step = [&](int it) {
    const int st = it % kStages, h = hk * group + it / n_qt;
    const int q0 = step_q0(it);
    uint8_t* base = ss + st * C::kStage;
    mbar_expect_tx(&bar_full[st], 2 * C::kQBytes + C::kLdBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c) {
      tma_load(base + c * C::kQSlab, &tq, &bar_full[st], 64 * c, q0, h, b);
      tma_load(base + C::kQBytes + c * C::kQSlab, &tdo, &bar_full[st],
               64 * c, q0, h, b);
    }
    bulk_load(base + 2 * C::kQBytes, ld + ((int64_t)b * Hq + h) * pad + q0,
              C::kLdBytes, &bar_full[st]);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_kv, 2 * C::kKBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c) {
      tma_load(sk + c * C::kKSlab, &tk, &bar_kv, 64 * c, k0, hk, b);
      tma_load(sv + c * C::kKSlab, &tv, &bar_kv, 64 * c, k0, hk, b);
    }
    for (int it = 0; it < min(kStages, n_steps); ++it) load_step(it);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int lr0 = 16 * warp + (lane >> 2);  // local key rows lr0, lr0 + 8
  const int kr0 = k0 + lr0;
  const int cq = 2 * (lane & 3);
  const Elem el{scale * kLog2e, scale / softcap, softcap * kLog2e,
                Sq,             Skv,             causal,
                window};

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
  float s[BQ / 2], dp[BQ / 2];
  uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
  uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];

  mbar_wait(&bar_kv, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int st = it % kStages, q0 = step_q0(it);
    const uint8_t* tq_s = ss + st * C::kStage;
    const uint8_t* tdo_s = tq_s + C::kQBytes;
    const float2* tld = reinterpret_cast<const float2*>(tq_s + 2 * C::kQBytes);
    mbar_wait(&bar_full[st], (it / kStages) & 1);
    wgmma_fence();
    mma_nt<D, BQ, C::kKSlab, C::kQSlab>(s, sk, tq_s);    // S^T = K Q^T
    mma_nt<D, BQ, C::kKSlab, C::kQSlab>(dp, sv, tdo_s);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = q0 + BQ > Sq || k0 + C::BK > Skv ||
                      (causal && q0 < k0 + C::BK - 1) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    if (softcap > 0.0f) {
      if (mask)
        ds_cols<true, true>(s, dp, el, tld, kr0, q0, cq);
      else
        ds_cols<false, true>(s, dp, el, tld, kr0, q0, cq);
    } else {
      if (mask)
        ds_cols<true, false>(s, dp, el, tld, kr0, q0, cq);
      else
        ds_cols<false, false>(s, dp, el, tld, kr0, q0, cq);
    }
    to_frags<BQ>(s, p_hi, p_lo);
    to_frags<BQ>(dp, ds_hi, ds_lo);
    wgmma_fence();
    mma_nn_split<D, BQ, C::kQSlab>(dva, p_hi, p_lo, tdo_s);   // dV += P^T dO
    mma_nn_split<D, BQ, C::kQSlab>(dka, ds_hi, ds_lo, tq_s);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_empty[st]);
    if (tid == 0 && it + kStages < n_steps) {
      mbar_wait(&bar_empty[st], (it / kStages) & 1);
      load_step(it + kStages);
    }
  }

  // dk = scale * acc, dv in bf16, staged in the K and V tiles
  stage_rows<D, C::kKSlab>(dka, scale, sk, lr0, cq);
  stage_rows<D, C::kKSlab>(dva, 1.0f, sv, lr0, cq);
  __syncthreads();
  const int64_t kv_base = ((int64_t)b * Hkv + hk) * Skv * D;
  store_rows<D, C::kKSlab>(sk, dk + kv_base, k0, Skv, tid);
  store_rows<D, C::kKSlab>(sv, dv + kv_base, k0, Skv, tid);
}

// ---- host side ---------------------------------------------------------- //
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float2* ld, const int64_t* st, int B, int Hq,
                   int Hkv, int Sq, int Skv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  using Q = DqCfg<D>;
  using K = KvCfg<D>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // q and dout in 128-row boxes for dq_kernel, 64-row ones for dkdv_kernel;
  // k and v in 64-row boxes for both
  CUtensorMap tq, tdo, tq64, tdo64, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Hq, Sq, D, st[0], st[1], st[2], Q::BQ)) ||
      (err = make_map(&tdo, dout, B, Hq, Sq, D, st[12], st[13], st[14],
                      Q::BQ)) ||
      (err = make_map(&tq64, q, B, Hq, Sq, D, st[0], st[1], st[2], K::BQ)) ||
      (err = make_map(&tdo64, dout, B, Hq, Sq, D, st[12], st[13], st[14],
                      K::BQ)) ||
      (err = make_map(&tk, k, B, Hkv, Skv, D, st[3], st[4], st[5], K::BK)) ||
      (err = make_map(&tv, v, B, Hkv, Skv, D, st[6], st[7], st[8], K::BK)))
    return err;
  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(dq);
  dq_kernel<D><<<dim3((Sq + Q::BQ - 1) / Q::BQ, Hq, B), Q::kThreads,
                 Q::kSmem, stream>>>(
      tq, tdo, tk, tv, static_cast<const __nv_bfloat16*>(o), st[9], st[10],
      st[11], lse, ld, dqp, Hq, Hkv, Sq, Skv, scale, causal, window,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(B * Hkv, (Skv + K::BK - 1) / K::BK), K::kThreads,
                   K::kSmem, stream>>>(
      tq64, tdo64, tk, tv, ld, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hkv, Sq, Skv, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

}  // namespace

// Rows of the scratch per (batch, q head): the caller allocates
// B * Hq * flash_attention_bwd_wgmma_rows(Sq) * 2 floats.
extern "C" int flash_attention_bwd_wgmma_rows(int Sq) {
  return padded_rows(Sq);
}

// bf16 q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o and dout like q, each
// a view with a contiguous last dim, a 16-byte aligned base and batch,
// head and row strides (in elements, multiples of 8) given as st[3i +
// 0..2] for q, k, v, o, dout in that order; lse fp32 (B, Hq, Sq)
// contiguous (the forward's); dq, dk, dv bf16 contiguous (B, H, S, D); ld
// fp32 scratch of B * Hq * flash_attention_bwd_wgmma_rows(Sq) * 2.  D 64
// or 128 (else cudaErrorInvalidValue).  Launches dq_kernel, then
// dkdv_kernel, on ``stream``; returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* ld, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, int64_t dsb, int64_t dsh,
    int64_t dss, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t strides[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                               vss, osb, osh, oss, dsb, dsh, dss};
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Hq > 65535 || B > 65535 || (Skv + 63) / 64 > 65535 ||
      (int64_t)B * Hkv > 2147483647)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 15; ++i)
    if (strides[i] < 8 || strides[i] % 8) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float2* scratch = static_cast<float2*>(ld);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, dout, l, dq, dk, dv, scratch, strides, B,
                        Hq, Hkv, Sq, Skv, scale, causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, dout, l, dq, dk, dv, scratch, strides, B,
                         Hq, Hkv, Sq, Skv, scale, causal, window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_wgmma_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
