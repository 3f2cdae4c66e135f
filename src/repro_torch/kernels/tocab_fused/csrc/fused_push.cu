// Fused TOCAB push for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces: src/repro/kernels/tocab_fused/kernel.py, fused_push_pallas /
// _fused_push_kernel — the TPU kernel behind tocab_push(impl="fused").
//
// Computes out[b*B + widx[b,s]] (+|min|max)= msg(values[id_map[b,
// cidx[b,s]]], ev[b,s]) over every real edge slot s of every TOCAB block b
// (row blocking: block b owns the disjoint destination window [b*B,
// b*B+B)), then, if asked, out = out*mul + add.  The message mode is the
// engine's combine: v*ev (mul), v (none), v + ev (add-ev) or v + 1
// (add-one, an additive combine on a layout without edge values).  A slot
// whose mask is clear, whose cidx lies outside [0, local_budget) or whose
// id_map entry is padding (>= n) adds nothing.
//
// Design.  The Pallas kernel gathers the block's distinct sources once into
// VMEM (block_contrib) and scatters into a VMEM copy of the block's window.
// Here the scatter goes to
//   * shared memory, when the window (B*d*4 bytes) fits kSmemWindowBytes:
//     one CTA per block accumulates its window with shared-memory atomics
//     and writes it out once, epilogue applied on the way;
//   * global memory otherwise, where the window (26 MB at the Graph500
//     scale-24 layout) stays in L2 and every real edge would be one
//     reduction into it.  A warp's 32 slots hold ~32 distinct destinations,
//     so a warp cannot combine them; but ~46 % of a block's edges go to
//     rows of in-degree > 1000, and the reductions of such a hub row queue
//     on one L2 address.  So for d = 1 (fused_push_combine) each SM runs
//     one persistent CTA of kCombineThreads threads that keeps a table of
//     kTable (destination, partial) pairs in shared memory over all its
//     chunks of a block: an edge's message goes to the slot its destination
//     hashes to — claimed by the first destination to reach it (atomicCAS),
//     reduced there with shared-memory atomics — or, when another
//     destination holds the slot, straight to L2 as a no-return RED.  The
//     table is flushed (one RED per held destination) when the CTA moves
//     to another block and at its end.  Hubs claim slots early and often:
//     at scale 24 the table takes ~24-30 % of the edges, and those are the
//     ones that would queue.  The CTAs walk their chunks block-major with a
//     static stride, so the CTAs in flight scatter into one block's window,
//     and each warp batches kSteps 32-slot steps: each step's mask, then
//     its cidx/widx where the mask is set (a padding slot reads its mask
//     only; issuing all the masks first measured slower), then all steps'
//     id_map reads, then their value reads (edges are sorted by cidx: a few
//     broadcast addresses a step, through L1), then the reductions.  Cache
//     policy: the slot streams are read with an L2 evict-first hint and no
//     L1 allocation, the reductions into the window carry an L2 evict-last
//     hint.  For d > 1 (fused_push_global) CTAs take contiguous chunks of
//     kChunkSlots slots, chunk fastest-varying in the grid, one slot a
//     thread, every message one atomic into the window in L2.  The wrapper
//     fills out with the identity, and a second small kernel applies the
//     epilogue.
// Windows are disjoint, so a block never touches another block's rows: the
// order blocks are visited in cannot change results.
//
// Bound.  Bytes: the widx/cidx/ev/mask streams (13 B per edge slot, 9 B
// unweighted), one id_map read and one value read per distinct source of a
// block, and the window rows of out.  What sets the pace on the global
// path is the reductions L2 retires: random fp32 REDs into a 26 MB array
// retire at ~91 G/s on an H100 (2.9 ms for scale 24's 263 M edges; a RED
// that misses L2 costs a 32-byte sector read and write in device memory),
// fewer where hub rows queue.  benchmarks/torch_graph_kernel_variants.py
// measures these floors and the design's variants.
//
// The earlier d = 1 design (fused_push_global at d = 1) is timed beside
// this one from benchmarks/torch_graph_kernel_variants.py's copy of it.
//
// Determinism.  Float atomics add in an order that changes from run to
// run, so the sum semiring is not bit-reproducible; min/max are exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 4;               // U: 32-slot steps a warp batches
constexpr int64_t kChunkSlots = 4096;   // d > 1: slots per CTA
constexpr int64_t kSmemWindowBytes = 200 * 1024;
constexpr int kTable = 28672;           // destinations a table holds (224 KB)
constexpr int kCombineThreads = 1024;   // a combining CTA's threads
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int64_t kCtaSlots = 1 << 16;  // slots of one CTA chunk

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };
// message modes (the C interface's `mode`)
enum Mode { kMul = 0, kNone = 1, kAddEv = 2, kAddOne = 3 };

__host__ __device__ constexpr bool reads_ev(int m) {
  return m == kMul || m == kAddEv;
}

// one rounding each, as torch's v * ev and v + ev (no FMA contraction)
template <int M>
__device__ __forceinline__ float message(float v, float e) {
  return M == kMul ? __fmul_rn(v, e)
                   : (M == kNone ? v
                                 : (M == kAddEv ? __fadd_rn(v, e)
                                                : __fadd_rn(v, 1.0f)));
}

template <int R>
__device__ __forceinline__ float identity() {
  return R == kSum ? 0.0f : (R == kMin ? __int_as_float(0x7f800000)
                                       : __int_as_float(0xff800000));
}

// min/max on float bits: a non-negative float orders like a signed int, a
// negative one like the reverse of an unsigned int.  Works on shared and
// global addresses alike.
template <int R>
__device__ __forceinline__ void atomic_reduce(float* p, float v) {
  if (R == kSum) {
    atomicAdd(p, v);
  } else if (R == kMin) {
    if (__float_as_int(v) >= 0) atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
    else atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  } else {
    if (__float_as_int(v) >= 0) atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
    else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
  }
}

// ---- L2 cache policies and the loads and reductions that carry them ---- //
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

__device__ __forceinline__ int ld_stream(const int32_t* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_stream(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_stream(const uint8_t* p, uint64_t pol) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return static_cast<int>(v);
}

// A no-return reduction into global memory with an L2 cache policy.
template <int R>
__device__ __forceinline__ void red_global(float* p, float v, uint64_t pol) {
  if (R == kSum) {
    asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
                 :: "l"(p), "f"(v), "l"(pol) : "memory");
  } else {
    // min: a non-negative value as s32 min, a negative one as u32 max;
    // max the other way round
    const int i = __float_as_int(v);
    if (R == kMin && i >= 0)
      asm volatile("red.global.min.L2::cache_hint.s32 [%0], %1, %2;"
                   :: "l"(p), "r"(i), "l"(pol) : "memory");
    else if (R == kMin)
      asm volatile("red.global.max.L2::cache_hint.u32 [%0], %1, %2;"
                   :: "l"(p), "r"(i), "l"(pol) : "memory");
    else if (i >= 0)
      asm volatile("red.global.max.L2::cache_hint.s32 [%0], %1, %2;"
                   :: "l"(p), "r"(i), "l"(pol) : "memory");
    else
      asm volatile("red.global.min.L2::cache_hint.u32 [%0], %1, %2;"
                   :: "l"(p), "r"(i), "l"(pol) : "memory");
  }
}

// The lane's slots of kSteps 32-slot steps from `slot` (slot + 32 u), step
// by step: the mask, then cidx/widx (and ev) where it is set — a padding
// slot reads its mask only — and then the source rows through id_map.
// src = n where a slot carries no message (mask clear, cidx out of range,
// or a padded id_map entry).
template <int M>
__device__ __forceinline__ void load_steps(
    const int32_t* __restrict__ widx, const int32_t* __restrict__ cidx,
    const float* __restrict__ ev, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ ids, int64_t n, int64_t local_budget,
    int64_t row, int64_t slot, int64_t s_end, uint64_t pol_stream,
    int (&w)[kSteps], float (&e)[kSteps], int64_t (&src)[kSteps]) {
  int key[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int64_t s = slot + u * 32;
    key[u] = -1;
    w[u] = 0;
    e[u] = 0.0f;
    if (s < s_end && ld_stream(mask + row + s, pol_stream)) {
      const int k = ld_stream(cidx + row + s, pol_stream);
      w[u] = ld_stream(widx + row + s, pol_stream);
      if (reads_ev(M)) e[u] = ld_stream(ev + row + s, pol_stream);
      if (k >= 0 && k < local_budget) key[u] = k;
    }
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
    src[u] = key[u] >= 0 ? __ldg(ids + key[u]) : n;
}

// ---- global window, d = 1: combining equal destinations per CTA -------- //
// A CTA walks CTA chunks of kCtaSlots slots (block-major, static stride);
// its warps take the chunk's 32*kSteps-slot iterations in turn.  The table
// lives over all the CTA's chunks of one block (small chunks keep the CTAs
// evenly loaded; the table still sees 1/grid of the block's edges).
template <int R, int M>
__global__ void __launch_bounds__(kCombineThreads)
fused_push_combine(const float* __restrict__ values,
                   const int32_t* __restrict__ widx,
                   const int32_t* __restrict__ cidx,
                   const float* __restrict__ ev,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ id_map, float* out, int64_t n,
                   int64_t edge_budget, int64_t local_budget,
                   int64_t block_size, int64_t chunks_per_block,
                   int64_t total) {
  extern __shared__ int table[];  // kTable keys, then kTable partials
  int* tkey = table;
  float* tval = reinterpret_cast<float*>(table + kTable);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t pol_stream = policy_evict_first();
  const uint64_t pol_window = policy_evict_last();
  for (int i = threadIdx.x; i < kTable; i += kCombineThreads) {
    tkey[i] = -1;
    tval[i] = identity<R>();
  }
  __syncthreads();
  // the table's partials into block tb's window, the table emptied
  auto flush = [&](int64_t tb) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTable; i += kCombineThreads) {
      const int k = tkey[i];
      if (k >= 0) {
        red_global<R>(out + tb * block_size + k, tval[i], pol_window);
        tkey[i] = -1;
        tval[i] = identity<R>();
      }
    }
    __syncthreads();
  };
  int64_t held_b = -1;  // the block the table's partials belong to
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const int64_t b = t / chunks_per_block;
    if (held_b >= 0 && b != held_b) flush(held_b);
    held_b = b;
    const int64_t s0 = (t - b * chunks_per_block) * kCtaSlots;
    const int64_t s_end =
        s0 + kCtaSlots < edge_budget ? s0 + kCtaSlots : edge_budget;
    const int64_t row = b * edge_budget;
    float* win = out + b * block_size;
    const int32_t* ids = id_map + b * local_budget;
    for (int64_t base = s0 + warp * 32 * kSteps; base < s_end;
         base += kCombineWarps * 32 * kSteps) {
      int w[kSteps];
      float e[kSteps];
      int64_t src[kSteps];
      load_steps<M>(widx, cidx, ev, mask, ids, n, local_budget, row,
                    base + lane, s_end, pol_stream, w, e, src);
      float v[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        v[u] = src[u] < n ? __ldg(values + src[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (src[u] >= n) continue;
        const float x = message<M>(v[u], e[u]);
        // the slot the destination hashes to (multiply-shift: a
        // multiplicative hash scaled to [0, kTable))
        const uint32_t hash = static_cast<uint32_t>(w[u]) * 2654435761u;
        const int h = static_cast<int>((static_cast<uint64_t>(hash) *
                                        kTable) >> 32);
        const int held = atomicCAS(&tkey[h], -1, w[u]);
        if (held == -1 || held == w[u])
          atomic_reduce<R>(&tval[h], x);
        else
          red_global<R>(win + w[u], x, pol_window);
      }
    }
  }
  if (held_b >= 0) flush(held_b);
}

// ---- shared-memory window: one CTA per block -------------------------- //
template <int R, int M>
__device__ __forceinline__ void push_edge(
    const float* __restrict__ values, const int32_t* __restrict__ widx,
    const int32_t* __restrict__ cidx, const float* __restrict__ ev,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ id_map,
    float* win, int64_t n, int64_t b, int64_t local_budget, int64_t slot,
    int d) {
  if (!mask[slot]) return;
  const int k = cidx[slot];
  if (k < 0 || k >= local_budget) return;
  const int64_t src = id_map[b * local_budget + k];
  if (src >= n) return;  // padded id_map entry reads nothing
  const int64_t w_row = widx[slot];
  const float e = reads_ev(M) ? ev[slot] : 0.0f;
  for (int f = 0; f < d; ++f)
    atomic_reduce<R>(win + w_row * d + f, message<M>(values[src * d + f], e));
}

template <int R, int M>
__global__ void __launch_bounds__(kThreads)
fused_push_shared(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ id_map,
                  const float* __restrict__ eps, float* __restrict__ out,
                  int64_t n, int64_t edge_budget, int64_t local_budget,
                  int64_t block_size, int d, int fuse_epilogue) {
  extern __shared__ float win[];  // block_size * d
  const int64_t b = blockIdx.x;
  const int win_len = static_cast<int>(block_size) * d;
  for (int i = threadIdx.x; i < win_len; i += kThreads) win[i] = identity<R>();
  __syncthreads();
  const int64_t row = b * edge_budget;
  for (int64_t s = threadIdx.x; s < edge_budget; s += kThreads)
    push_edge<R, M>(values, widx, cidx, ev, mask, id_map, win, n, b,
                    local_budget, row + s, d);
  __syncthreads();
  const float mul = fuse_epilogue ? eps[0] : 1.0f;
  const float add = fuse_epilogue ? eps[1] : 0.0f;
  const int64_t lo = b * block_size;
  for (int i = threadIdx.x; i < win_len; i += kThreads) {
    if (lo + i / d >= n) break;  // rows past n: the last block's tail
    float v = win[i];
    // no FMA contraction: the same two roundings as torch's out*mul + add
    if (fuse_epilogue) v = __fadd_rn(__fmul_rn(v, mul), add);
    out[lo * d + i] = v;
  }
}

// ---- global window, d > 1: one CTA per chunk of kChunkSlots slots ---- //
template <int R, int M>
__global__ void __launch_bounds__(kThreads)
fused_push_global(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ id_map, float* out, int64_t n,
                  int64_t edge_budget, int64_t local_budget,
                  int64_t block_size, int d, int64_t chunks_per_block) {
  const int64_t b = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - b * chunks_per_block;
  const int64_t row = b * edge_budget;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  float* win = out + b * block_size * d;
  for (int64_t s = c * kChunkSlots + threadIdx.x; s < s_end; s += kThreads)
    push_edge<R, M>(values, widx, cidx, ev, mask, id_map, win, n, b,
                    local_budget, row + s, d);
}

__global__ void epilogue_kernel(float* __restrict__ out, int64_t count,
                                const float* __restrict__ eps) {
  const float mul = eps[0], add = eps[1];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < count; i += (int64_t)gridDim.x * blockDim.x)
    out[i] = __fadd_rn(__fmul_rn(out[i], mul), add);
}

struct Args {
  const float* values;
  const int32_t* widx;
  const int32_t* cidx;
  const float* ev;
  const uint8_t* mask;
  const int32_t* id_map;
  const float* eps;
  float* out;
  int64_t n, num_blocks, edge_budget, local_budget, block_size;
  int d, mode, fuse_epilogue;
};

cudaError_t launch_epilogue(const Args& a, cudaStream_t st) {
  const int64_t count = a.n * a.d;
  if (!a.fuse_epilogue || count == 0) return cudaSuccess;
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a.out, count, a.eps);
  return cudaGetLastError();
}

// CTAs of kernel `k` resident on the current card at `threads` threads
// and `smem` bytes of dynamic shared memory each (0 if the runtime cannot
// say; its error is then pending)
template <typename K>
int64_t resident_ctas(K k, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return (int64_t)sms * (per_sm > 0 ? per_sm : 1);
}

template <int R, int M>
cudaError_t launch_shared(const Args& a, cudaStream_t st) {
  const int64_t bytes = a.block_size * a.d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_push_shared<R, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  fused_push_shared<R, M><<<(unsigned)a.num_blocks, kThreads, bytes, st>>>(
      a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.eps, a.out, a.n,
      a.edge_budget, a.local_budget, a.block_size, a.d, a.fuse_epilogue);
  return cudaGetLastError();
}

template <int R, int M>
cudaError_t launch_combine(const Args& a, cudaStream_t st) {
  const int64_t chunks = (a.edge_budget + kCtaSlots - 1) / kCtaSlots;
  const int64_t total = a.num_blocks * chunks;
  if (total > 0) {
    constexpr int smem = kTable * (sizeof(int) + sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        fused_push_combine<R, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int64_t resident =
        resident_ctas(fused_push_combine<R, M>, kCombineThreads, smem);
    if (resident == 0) return cudaGetLastError();
    const int64_t grid = total < resident ? total : resident;
    fused_push_combine<R, M><<<(unsigned)grid, kCombineThreads, smem, st>>>(
        a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.out, a.n,
        a.edge_budget, a.local_budget, a.block_size, chunks, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_epilogue(a, st);
}

// d = 1: the combining kernel; d > 1: one CTA per chunk
template <int R, int M>
cudaError_t launch_global(const Args& a, cudaStream_t st) {
  if (a.d == 1) return launch_combine<R, M>(a, st);
  const int64_t chunks = (a.edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = a.num_blocks * chunks;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (grid > 0) {
    fused_push_global<R, M><<<(unsigned)grid, kThreads, 0, st>>>(
        a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.out, a.n,
        a.edge_budget, a.local_budget, a.block_size, a.d, chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_epilogue(a, st);
}

bool window_shared(int64_t block_size, int d) {
  return block_size * d * static_cast<int64_t>(sizeof(float)) <=
         kSmemWindowBytes;
}

template <int R, int M>
cudaError_t launch_path(const Args& a, cudaStream_t st) {
  return window_shared(a.block_size, a.d) ? launch_shared<R, M>(a, st)
                                          : launch_global<R, M>(a, st);
}

template <int R>
cudaError_t launch_reduce(const Args& a, cudaStream_t st) {
  switch (a.mode) {
    case kMul: return launch_path<R, kMul>(a, st);
    case kNone: return launch_path<R, kNone>(a, st);
    case kAddEv: return launch_path<R, kAddEv>(a, st);
    default: return launch_path<R, kAddOne>(a, st);
  }
}

}  // namespace

// Whether the window of a block is accumulated in shared memory; the
// wrapper fills `out` with the identity only when it is not (the shared
// path writes every row below n).
extern "C" int tocab_fused_push_window_shared(int64_t block_size, int d) {
  return window_shared(block_size, d);
}

// Returns cudaGetLastError() after the launches (0 on success).  `mode`
// is the message mode (0 mul, 1 none, 2 add-ev, 3 add-one); `ev` is read
// by mul and add-ev and must be null for the others.  `eps` (device, 2
// floats: mul, add) is read only when fuse_epilogue is set.
extern "C" int tocab_fused_push(const float* values, const int32_t* widx,
                                const int32_t* cidx, const float* ev,
                                const uint8_t* mask, const int32_t* id_map,
                                const float* eps, float* out, int64_t n,
                                int64_t num_blocks, int64_t edge_budget,
                                int64_t local_budget, int64_t block_size,
                                int d, int reduce, int mode,
                                int fuse_epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || reduce < kSum || reduce > kMax || mode < kMul ||
      mode > kAddOne || reads_ev(mode) != (ev != nullptr))
    return cudaErrorInvalidValue;
  if (num_blocks == 0) return cudaSuccess;
  const Args a{values, widx, cidx, ev, mask, id_map, eps, out, n,
               num_blocks, edge_budget, local_budget, block_size, d, mode,
               fuse_epilogue};
  if (reduce == kSum) return launch_reduce<kSum>(a, st);
  if (reduce == kMin) return launch_reduce<kMin>(a, st);
  return launch_reduce<kMax>(a, st);
}

extern "C" const char* tocab_fused_push_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
