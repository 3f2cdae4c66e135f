// Forward flash attention on the Hopper tensor cores (sm_90a, wgmma), bf16,
// head dims 64, 128 and 256, with a plain C interface: online-softmax
// attention with GQA, causal or bidirectional masking, a sliding window and
// tanh logit capping.  The fp32 forward and the small head dims (8, 16, 32)
// stay on the FMA kernel in flash_attention.cu; kernel.py's
// attention_route(dtype, D) picks between the two.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas / _attn_kernel — the TPU kernel behind the LM
// forward (models/layers.py attention_block), hence behind every prefill.
//
// Computes what flash_attention.cu computes, for q (B, Hq, Sq, D), k and v
// (B, Hkv, Skv, D), group = Hq/Hkv:
//   s[i, j] = cap(scale * (q[b, h, i] . k[b, h/group, j]))
//   out[b, h, i] = sum_j softmax_j(s[i, j] masked) v[b, h/group, j]
// with key j masked when j >= Skv, when causal and j > i, or when
// window > 0 and i - j >= window.  The product q.k is taken on the tensor
// cores in fp32 from the bf16 operands, and scale is applied to that fp32
// sum (q is not pre-scaled in bf16: Gemma-2's 144^-0.5 is not a power of
// two).  A row whose keys are all masked comes out 0 (l is clamped to
// 1e-30).  Every operand is a (B, H, S, D) view whose last dim is
// contiguous; the batch, head and row strides are arguments (multiples of
// 8 elements), so the LM passes its (B, S, H, D) projections as they are
// and reads o in that layout without a copy.  When the caller passes an
// lse buffer (fp32, (B, Hq, Sq) contiguous), the kernel also stores each
// row's logsumexp, lse = m + log(l) from the online softmax it keeps (+1e30
// for a row whose keys are all masked), which the backward
// (flash_attention_bwd_wgmma.cu) reads instead of sweeping K once more;
// with a null pointer nothing more is stored (prefill and serving).
//
// Design.  A CTA of two warpgroups per (q tile of 128 rows, q head,
// batch), the heaviest causal q tiles first; each warpgroup owns 64 query
// rows (the wgmma M).  Thread 0 also loads: TMA copies (tensor maps built
// on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so that nothing links libcuda) of the q tile
// once and of the head's K and V tiles into a ring of kStages stages,
// guarded by mbarriers (full: the TMA bytes arrived; empty: all 8 warps
// done with the stage).  It refills a stage without blocking where it can,
// so that warpgroup 0 does not wait on warpgroup 1.  Tiles stay bf16 in
// shared memory, in the 128-byte swizzle that TMA writes and the wgmma
// descriptors read; a D wider than 64 is kept as 64-column slabs.  TMA's
// zero fill covers the ragged ends, so S need not divide into tiles.  KV
// tiles wholly above the diagonal or left of the window are never loaded.
// Per KV tile a warpgroup takes S = Q K^T with wgmma.mma_async (A = Q and
// B = K from shared memory, K-major); scale, softcap and, only on tiles
// that cross the causal diagonal, the window's edge or Skv, the element
// masks; the online softmax on the accumulator fragment in registers (row
// max over the 4 lanes that share a row; row sums per thread, reduced once
// at the end); then O += P V with wgmma, A = P from registers and B = V
// from shared memory, MN-major (the descriptor's transpose bit).  The loop
// is software-pipelined: tile it's Q K^T and tile it-1's P V are issued
// together, and tile it's softmax may run while P V is on the tensor cores
// (ptxas schedules it: pinning it before the P V wait, or making the two
// warpgroups take turns, gained nothing beyond the spread of runs of
// benchmarks/torch_attention_variants.py).  The epilogue
// divides by max(l, 1e-30), stages the bf16 tile in the warpgroup's own q
// rows of shared memory and stores it with 16-byte rows.  Registers: D 64
// fits 128 a thread, so two CTAs share an SM; D 128 and 256 take up to 255.
//
// Precision of P.  wgmma takes P as bf16.  P rounded to bf16 alone, one
// product, moves the output by several bf16 ulps on rows with few keys: at
// the prefill shape 4.26x chip_smoke.py's bf16 bound (rtol 2^-7, atol 2^-6
// of the mean |entry|; the plain version keeps P in fp32; the p_rounded
// variant of benchmarks/torch_attention_variants.py on an H100 80GB HBM3 at
// 700 W).  So P = P_hi + P_lo, both bf16, and O += P_hi V + P_lo V: P is
// held to 2^-16, the output differs from the plain version's by bf16
// rounding alone (at most one ulp, which the unchanged bound admits), and
// the tensor work of P V doubles.
//
// Bound.  Operations: 4*B*Hq*Sq*Skv*D flops (halved when causal): 137.4
// GFLOP at the prefill shape (8 x 32 x 2048 x 64), 0.139 ms at the card's
// 989 TFLOP/s bf16 tensor-core rate; the bytes (q, k, v read once, out
// written once) need a third of that at 3.35 TB/s.
#include "wgmma_tma.cuh"

namespace {

constexpr int kBQ = 128;          // query rows per CTA (two warpgroups)
constexpr int kThreads = 256;     // two warpgroups of 64 query rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNoRow = 1e30f;  // lse of a row whose keys are all masked

template <int D>
struct Cfg {
  // D 64: 64-key tiles and at most 128 registers, so that two CTAs share
  // an SM (16 warps, which hide the softmax's latency); D 128: 128-key
  // tiles, one CTA; D 256: 64-key tiles (the accumulator alone is 128
  // registers), one CTA
  static constexpr int BK = D == 128 ? 128 : 64;    // keys per KV tile
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // CTAs per SM
  static constexpr int kStages = D <= 128 ? (D == 64 ? 5 : 3) : 2;
  static constexpr int kSlabs = D / 64;             // 64-column slabs
  static constexpr int kQSlab = kBQ * 128;          // bytes of a q slab
  static constexpr int kKVSlab = BK * 128;          // bytes of a K/V slab
  static constexpr int kQBytes = kSlabs * kQSlab;
  static constexpr int kKVBytes = kSlabs * kKVSlab;  // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
};

struct MaskArgs {
  int r0, k0, cq, Skv, causal, window;
};

// A tile's scores to logits in base 2, in place: scale * log2(e) folded in,
// softcap applied (CAP), masked entries kNegInf (MASK).  s[4c + e] is row
// r0 (e < 2) or r0 + 8, key k0 + 8c + cq + (e & 1).  Tiles that need no
// mask or cap are instantiated without them, so they pay nothing for them.
template <bool MASK, bool CAP, int N>
__device__ __forceinline__ void tile_logits(float (&s)[N], float scale,
                                            float softcap,
                                            const MaskArgs& a) {
  const float to_cap = scale / softcap, cap2 = softcap * kLog2e;
  const float sl = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = CAP ? cap2 * tanhf(s[i] * to_cap) : s[i] * sl;
    if (MASK) {
      const int row = a.r0 + ((i & 2) ? 8 : 0);
      const int col = a.k0 + 8 * (i >> 2) + a.cq + (i & 1);
      const bool ok = col < a.Skv && (!a.causal || row >= col) &&
                      (a.window <= 0 || row - col < a.window);
      x = ok ? x : kNegInf;
    }
    s[i] = x;
  }
}

// One consumer warpgroup's state: the output accumulator and, per thread,
// the running max and (partial) sum of rows r0 and r0 + 8.
template <int D>
struct Rows {
  float acc[D / 2];
  float m0, m1, l0, l1;
};

// S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte row),
// issued and committed; the caller waits
template <int D, int BK, int QSLAB, int KVSLAB>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint8_t* q,
                                         const uint8_t* kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk / 4, off = 32 * (kk % 4);
    wgmma_ss<BK>(s, sw128_desc(q + slab * QSLAB + off, 16),
                 sw128_desc(kt + slab * KVSLAB + off, 16), kk > 0);
  }
  wgmma_commit();
}

// O += (P_hi + P_lo) V over the tile's keys in steps of 16 (2 x 8 rows of
// 128 B), V MN-major; issued and committed
template <int D, int BK, int KVSLAB>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p_hi)[BK / 16][4],
                                         const uint32_t (&p_lo)[BK / 16][4],
                                         const uint8_t* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(vt + 2048 * kk, KVSLAB);
    wgmma_rs<D>(acc, p_hi[kk], dv);
    wgmma_rs<D>(acc, p_lo[kk], dv);
  }
  wgmma_commit();
}

// The online-softmax step of one tile, on the S fragment in place: logits
// (masks only where need_mask), the new row max, P = 2^(logit - max) in
// fp32, the row sums; returns the factors al0, al1 by which the
// accumulator's rows must be scaled (the caller does it once the product
// that reads it has finished).
template <int D, int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], Rows<D>& st,
                                             bool need_mask, float scale,
                                             float softcap,
                                             const MaskArgs& ma, float& al0,
                                             float& al1) {
  // s[4c + e] is row r0 (e < 2) or r0 + 8; a row's 4 lanes: lane ^ 1, ^ 2
  const float sl = scale * kLog2e;
  // the common tile (no mask, no cap, scale > 0) keeps raw scores: its max
  // is the raw max times sl, and sl is folded into the exponent's FMA
  const bool raw = !need_mask && softcap <= 0.0f && sl > 0.0f;
  if (!raw) {
    if (softcap > 0.0f) {
      if (need_mask)
        tile_logits<true, true>(s, scale, softcap, ma);
      else
        tile_logits<false, true>(s, scale, softcap, ma);
    } else {
      if (need_mask)
        tile_logits<true, false>(s, scale, softcap, ma);
      else
        tile_logits<false, false>(s, scale, softcap, ma);
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
  }
  if (raw) {
    mx0 *= sl;
    mx1 *= sl;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  al0 = ex2(st.m0 - mn0);
  al1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  // a row masked so far subtracts 0, so that its kNegInf entries give 0
  const float mb0 = mn0 <= kNegInf ? 0.0f : mn0;
  const float mb1 = mn1 <= kNegInf ? 0.0f : mn1;
  const float f = raw ? sl : 1.0f;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = ex2(fmaf(s[i], f, (i & 2) ? -mb1 : -mb0));
    s[i] = p;
    if (i & 2) rs1 += p; else rs0 += p;
  }
  st.l0 = st.l0 * al0 + rs0;
  st.l1 = st.l1 * al1 + rs1;
}

// P = P_hi + P_lo, both bf16, as the A fragments of 16-key steps: the
// accumulator layout of columns 16kk..16kk+15 is the A layout of one k16
// step.  P_hi is P truncated to bf16 (its upper 16 bits), P_lo = P - P_hi
// truncated too: P_hi + P_lo holds P to 2^-16, and the split takes integer
// and FMA-pipe instructions only (a float-to-bf16 conversion runs on the
// slow pipe that the exponentials already fill).
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
      const uint32_t ab = __float_as_uint(a), cb = __float_as_uint(c);
      p_hi[kk][r] = __byte_perm(ab, cb, 0x7632);  // upper halves: c | a
      const float la = a - __uint_as_float(ab & 0xffff0000u);
      const float lc = c - __uint_as_float(cb & 0xffff0000u);
      p_lo[kk][r] =
          __byte_perm(__float_as_uint(la), __float_as_uint(lc), 0x7632);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh,
                  int64_t oss, float* __restrict__ lse, int Hq, int Hkv,
                  int Sq, int Skv, float scale, int causal, int window,
                  float softcap) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_empty[kStages];
  // TMA's 128-byte swizzle and the descriptors want 1024-byte alignment
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + C::kQBytes;               // [stage][slab][BK][64]
  uint8_t* sv = sk + kStages * C::kKVBytes;    // [stage][slab][BK][64]

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;

  // KV tiles any row of this q tile can see (the Pallas early-out)
  const int q_last = min(q0 + kBQ, Sq) - 1;
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
      mbar_init(&bar_k[i], 1);
      mbar_init(&bar_v[i], 1);
      mbar_init(&bar_empty[i], 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 also loads: q and the first kStages KV tiles now, and each
  // later tile into the stage that the tile kStages before it freed.
  auto load_kv = [&](int it) {
    const int st = it % kStages, k0 = (j_begin + it) * BK;
    uint8_t* kd = sk + st * C::kKVBytes;
    uint8_t* vd = sv + st * C::kKVBytes;
    mbar_expect_tx(&bar_k[st], C::kKVBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c)
      tma_load(kd + c * C::kKVSlab, &tk, &bar_k[st], 64 * c, k0, hk, b);
    mbar_expect_tx(&bar_v[st], C::kKVBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c)
      tma_load(vd + c * C::kKVSlab, &tv, &bar_v[st], 64 * c, k0, hk, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kSlabs; ++c)
      tma_load(sq + c * C::kQSlab, &tq, &bar_q, 64 * c, q0, h, b);
    for (int it = 0; it < min(kStages, n_tiles); ++it) load_kv(it);
  }
  // Later tiles go into the stage that the tile kStages before them freed
  // (both warpgroups done with its P V).  Thread 0 refills without
  // blocking where it can, so that warpgroup 0 does not wait on warpgroup
  // 1; it blocks only before it needs a tile that is not loaded yet.
  int next_load = min(kStages, n_tiles);  // thread 0's: tiles issued
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

  // ---------------- each warpgroup: 64 query rows ----------------------
  const int cw = tid >> 7;             // warpgroup 0 or 1
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int row_lo = q0 + 64 * cw;     // this warpgroup's first row
  const int r0 = row_lo + 16 * warp + (lane >> 2);  // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);       // column of s[0] within 8
  uint8_t* my_q = sq + cw * 64 * 128;  // this warpgroup's q rows, slab 0
  auto tile_k = [&](int it) { return sk + (it % kStages) * C::kKVBytes; };
  auto tile_v = [&](int it) { return sv + (it % kStages) * C::kKVBytes; };
  auto phase = [&](int it) { return (it / kStages) & 1; };
  auto tile_masked = [&](int k0) {
    return k0 + BK > Skv || (causal && k0 + BK - 1 > row_lo) ||
           (window > 0 && row_lo + 63 - k0 >= window);
  };

  Rows<D> st;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.acc[i] = 0.0f;
  st.m0 = st.m1 = kNegInf;
  st.l0 = st.l1 = 0.0f;
  float s[BK / 2];
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
  float al0, al1;

  // Software pipeline: while the tensor cores run tile it-1's P V, the
  // threads take tile it's softmax.  P's registers stay the product's
  // operand until it has finished, so tile it's P is split only after.
  mbar_wait(&bar_q, 0);
  if (n_tiles > 0) {
    mbar_wait(&bar_k[0], 0);
    issue_qk<D, BK, C::kQSlab, C::kKVSlab>(s, my_q, tile_k(0));
    wgmma_wait<0>();
    fence_regs(s);
    const int k0 = j_begin * BK;
    softmax_tile<D, BK>(s, st, tile_masked(k0), scale, softcap,
                        MaskArgs{r0, k0, cq, Skv, causal, window}, al0, al1);
    split_p<BK>(s, p_hi, p_lo);
  }
  for (int it = 1; it < n_tiles; ++it) {
    while (tid == 0 && next_load <= it) refill(true);
    __syncwarp();
    mbar_wait(&bar_k[it % kStages], phase(it));
    issue_qk<D, BK, C::kQSlab, C::kKVSlab>(s, my_q, tile_k(it));
    mbar_wait(&bar_v[(it - 1) % kStages], phase(it - 1));
    issue_pv<D, BK, C::kKVSlab>(st.acc, p_hi, p_lo, tile_v(it - 1));
    wgmma_wait<1>();  // S of tile it
    fence_regs(s);
    const int k0 = (j_begin + it) * BK;
    softmax_tile<D, BK>(s, st, tile_masked(k0), scale, softcap,
                        MaskArgs{r0, k0, cq, Skv, causal, window}, al0, al1);
    wgmma_wait<0>();  // P V of tile it - 1
    fence_regs(st.acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_empty[(it - 1) % kStages]);
    // rescale only when a row's max grew (rare after the first tiles)
    if (__any_sync(0xffffffffu, al0 != 1.0f || al1 != 1.0f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) st.acc[i] *= (i & 2) ? al1 : al0;
    }
    split_p<BK>(s, p_hi, p_lo);
    if (tid == 0) refill(false);
    __syncwarp();
  }
  if (n_tiles > 0) {
    const int it = n_tiles - 1;
    mbar_wait(&bar_v[it % kStages], phase(it));
    issue_pv<D, BK, C::kKVSlab>(st.acc, p_hi, p_lo, tile_v(it));
    wgmma_wait<0>();
    fence_regs(st.acc);
  }

  // epilogue: l over the row's 4 lanes, out = acc / max(l, 1e-30) in bf16,
  // staged swizzled in this warpgroup's own q rows (no other reader)
  float l0 = st.l0, l1 = st.l1;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    // m is in base-2 logits: lse = (m + log2 l) ln 2
    float* lp = lse + ((int64_t)b * Hq + h) * Sq;
    if (r0 < Sq) lp[r0] = l0 > 0.0f ? (st.m0 + log2f(l0)) * kLn2 : kNoRow;
    if (r0 + 8 < Sq)
      lp[r0 + 8] = l1 > 0.0f ? (st.m1 + log2f(l1)) * kLn2 : kNoRow;
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int lr0 = 16 * warp + (lane >> 2);  // local rows lr0, lr0 + 8
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint8_t* slab = my_q + (c / 8) * C::kQSlab;
    const int chunk = c % 8;
    *reinterpret_cast<uint32_t*>(slab + lr0 * 128 +
                                 16 * (chunk ^ (lr0 & 7)) + 2 * cq) =
        pack_bf16(st.acc[4 * c] * inv0, st.acc[4 * c + 1] * inv0);
    const int lr1 = lr0 + 8;
    *reinterpret_cast<uint32_t*>(slab + lr1 * 128 +
                                 16 * (chunk ^ (lr1 & 7)) + 2 * cq) =
        pack_bf16(st.acc[4 * c + 2] * inv1, st.acc[4 * c + 3] * inv1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  __nv_bfloat16* op = o + b * osb + h * osh;
  for (int e = t; e < 64 * (D / 8); e += 128) {
    const int lr = e / (D / 8), c = e % (D / 8);
    const int row = row_lo + lr;
    if (row >= Sq) continue;
    const uint8_t* src = my_q + (c / 8) * C::kQSlab + lr * 128 +
                         16 * ((c % 8) ^ (lr & 7));
    *reinterpret_cast<uint4*>(op + row * oss + 8 * c) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// ---- host side ---------------------------------------------------------- //
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int64_t* st, int B, int Hq, int Hkv,
                   int Sq, int Skv, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Hq, Sq, D, st[0], st[1], st[2], kBQ)) ||
      (err = make_map(&tk, k, B, Hkv, Skv, D, st[3], st[4], st[5], C::BK)) ||
      (err = make_map(&tv, v, B, Hkv, Skv, D, st[6], st[7], st[8], C::BK)))
    return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  attn_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], lse,
      Hq, Hkv, Sq, Skv, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q; D 64, 128 or
// 256 (else cudaErrorInvalidValue).  Each operand is a view with a
// contiguous last dim, a 16-byte aligned base and batch, head and row
// strides (in elements, multiples of 8) given as st[3i + 0..2] for q, k, v,
// o in that order.  lse: null (nothing more stored) or fp32 (B, Hq, Sq)
// contiguous, each row's logsumexp.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
    int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
    int64_t osh, int64_t oss, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    float scale, int causal, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t strides[12] = {qsb, qsh, qss, ksb, ksh, kss,
                               vsb, vsh, vss, osb, osh, oss};
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] < 8 || strides[i] % 8) return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, st);
    case 128:
      return launch<128>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, st);
    case 256:
      return launch<256>(q, k, v, o, l, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_wgmma_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
