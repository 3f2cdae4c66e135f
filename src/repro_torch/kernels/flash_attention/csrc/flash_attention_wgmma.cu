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
// and reads o in that layout without a copy.
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
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA (two warpgroups)
constexpr int kThreads = 256;     // two warpgroups of 64 query rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---- shared-memory barriers, TMA, wgmma (PTX) -------------------------- //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// whether the barrier's phase with this parity has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// spins until the barrier's phase with this parity completes; a wait that
// outlasts ~2^26 polls (seconds) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  while (!done) {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// 4-D tiled TMA load (d, row, head, batch) into shared memory, completing on
// bar's transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-column slabs), stride byte offset 1024 (8 rows of 128 B)
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo_bytes) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty asm on registers, after a wait: the compiler reads none of them
// before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) = A (64 x 16) B (16 x N) + scale_d * D; A and B bf16 in
// shared memory, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x N,
// bf16 in shared memory, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
                  int64_t oss, int Hq, int Hkv, int Sq, int Skv, float scale,
                  int causal, int window, float softcap) {
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
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map of a bf16 (B, H, S, D) view, dims innermost first (d, row,
// head, batch), strides in elements; boxes of 64 columns x rows, 128-byte
// swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int H, int S,
                     int D, int64_t sb, int64_t sh, int64_t ss, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int64_t* st, int B, int Hq, int Hkv, int Sq, int Skv,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], Hq,
      Hkv, Sq, Skv, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o like q; D 64, 128 or
// 256 (else cudaErrorInvalidValue).  Each operand is a view with a
// contiguous last dim, a 16-byte aligned base and batch, head and row
// strides (in elements, multiples of 8) given as st[3i + 0..2] for q, k, v,
// o in that order.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
    int causal, int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t strides[12] = {qsb, qsh, qss, ksb, ksh, kss,
                               vsb, vsh, vss, osb, osh, oss};
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] < 8 || strides[i] % 8) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                        causal, window, softcap, st);
    case 128:
      return launch<128>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, st);
    case 256:
      return launch<256>(q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, scale,
                         causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_wgmma_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
