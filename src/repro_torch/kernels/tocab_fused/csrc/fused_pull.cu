// Fused TOCAB pull for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces: src/repro/kernels/tocab_fused/kernel.py, fused_pull_pallas /
// _fused_pull_kernel — the TPU kernel behind tocab_pull(impl="fused").
//
// Computes out[id_map[b, cidx[b,s]]] (+|min|max)= msg(values[b*B +
// widx[b,s]], ev[b,s]) over every real edge slot s of every TOCAB block b,
// then, if asked, out = out*mul + add.  The message mode is the engine's
// combine: v*ev (mul), v (none), v + ev (add-ev) or v + 1 (add-one, an
// additive combine on a layout without edge values).  A slot whose mask is
// clear or whose cidx lies outside [0, local_budget) adds nothing, and a
// padded id_map entry (>= n) is dropped.  The wrapper fills out with the
// semiring identity first.
//
// Design.  The Pallas kernel keeps the whole output resident in VMEM and
// relies on its grid running in order (init on the first block, epilogue
// on the last).  Neither holds here: the output is tens of MB and CTAs run
// in no order.  Each block's edges are sorted by cidx, so a warp reduces
// runs of equal cidx with a segmented shuffle scan and adds a run's total
// to out with one atomic.  The epilogue is a second small kernel in the
// same call, since there is no grid-wide "last block".
//   d = 1 (fused_pull_stream, the main path's width): each warp takes one
// warp chunk of kWarpSlots consecutive slots, the chunks numbered
// block-major, so the CTAs in flight all read one block's value window
// (sized to half the L2 by choose_block_size).  The hardware hands out the
// CTAs as others finish: a persistent grid of the same warps walking the
// chunks with a static stride measured ~8 % slower on an H100 (chunks
// differ in work: hub runs, padding).  A warp takes kSteps 32-slot steps
// at once: the steps' mask/cidx/widx (and ev) loads issue together, then
// the steps' window gathers, so kSteps gathers are in flight per lane
// before the first scan.  The run that reaches a step's last lane is
// carried in registers into the next step, and a run's total goes to out
// once per warp chunk.  Cache policy: the slot streams are read with an L2
// evict-first hint and no L1 allocation, the window with an L2 evict-last
// hint, through L1 (the rows of hub vertices are read by many edges), so
// the streams do not push the window out of L2.
//   d > 1 (fused_pull_rows): one CTA per chunk of kChunkSlots slots, chunk
// fastest-varying in the grid, one slot a lane; each lane gathers its row
// feature by feature and each 32-slot step adds its runs with one atomic
// each.  benchmarks/torch_graph_kernel_variants.py times the streaming
// kernel at d = 8 against this one.
//
// Bound.  Bytes: the widx/cidx/ev/mask streams (4+4+4+1 = 13 B per edge
// slot, 9 B unweighted), one read of each value-window row the edges
// touch, and per compacted row one id_map read plus one atomic
// read-modify-write on out.  A flop or two per edge: memory bound.  The
// gathers are random 4-byte reads, each a 32-byte sector: what sets the
// pace is how many sectors L2 serves per second, and whether the window
// stays in L2.
//
// The earlier d = 1 design (one CTA per 4096-slot chunk, one gather in
// flight a lane, an atomic per run per step) is timed beside this one from
// benchmarks/torch_graph_kernel_variants.py's copy of it.
//
// Determinism.  The float atomics add in an order that changes from run to
// run, so the sum semiring is not bit-reproducible; min/max are exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;               // U: 32-slot steps a warp batches
constexpr int64_t kWarpSlots = 512;     // d = 1: slots of one warp chunk
constexpr int64_t kChunkSlots = 4096;   // d > 1: slots per CTA
constexpr unsigned kFull = 0xffffffffu;

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

template <int R>
__device__ __forceinline__ float combine(float a, float b) {
  return R == kSum ? a + b : (R == kMin ? fminf(a, b) : fmaxf(a, b));
}

// min/max on float bits: a non-negative float orders like a signed int, a
// negative one like the reverse of an unsigned int.
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

// slot streams: read once, no L1 allocation
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

// window gathers: through L1, which keeps the rows of hub vertices that
// many edges read
__device__ __forceinline__ float ld_window(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// A run's total into out through id_map (a padded entry is dropped).
template <int R>
__device__ __forceinline__ void emit(float* out, const int32_t* ids,
                                     int64_t n, int key, int d, int f,
                                     float v) {
  const int64_t gid = __ldg(ids + key);
  if (gid < n) atomic_reduce<R>(out + gid * d + f, v);
}

// ---- d = 1: batched, cache-hinted --------------------------------------- //
// Work item t (a warp chunk) -> (block b, chunk c), block-major; the run
// that crosses each 32-slot step is carried in (carry_key, carry).  For
// d > 1 (the variants benchmark's comparison) the chunk is walked once
// per feature.  The loop over t lets a grid smaller than one warp a chunk
// (the benchmark's persistent variant) cover every chunk.
template <int R, int M>
__global__ void __launch_bounds__(kThreads)
fused_pull_stream(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ id_map, float* out, int64_t n,
                  int64_t edge_budget, int64_t local_budget,
                  int64_t block_size, int d, int64_t chunks_per_block,
                  int64_t total) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_le = kFull >> (31 - lane);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const uint64_t pol_stream = policy_evict_first();
  const uint64_t pol_window = policy_evict_last();
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < total; t += stride) {
    const int64_t b = t / chunks_per_block;
    const int64_t s0 = (t - b * chunks_per_block) * kWarpSlots;
    const int64_t s_end =
        s0 + kWarpSlots < edge_budget ? s0 + kWarpSlots : edge_budget;
    const int64_t row = b * edge_budget;
    const float* win = values + b * block_size * d;
    const int32_t* ids = id_map + b * local_budget;
    for (int f = 0; f < d; ++f) {
      int carry_key = -1;  // the run reaching the last step's lane 31
      float carry = identity<R>();
      for (int64_t base = s0; base < s_end; base += 32 * kSteps) {
        int key[kSteps], w[kSteps];
        float e[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int64_t s = base + u * 32 + lane;
          key[u] = -1;  // -1: no real slot here
          w[u] = 0;
          e[u] = 0.0f;
          if (s < s_end) {
            const int m = ld_stream(mask + row + s, pol_stream);
            const int k = ld_stream(cidx + row + s, pol_stream);
            w[u] = ld_stream(widx + row + s, pol_stream);
            if (reads_ev(M)) e[u] = ld_stream(ev + row + s, pol_stream);
            if (m && k >= 0 && k < local_budget) key[u] = k;
          }
        }
        float v[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u)
          v[u] = key[u] >= 0
                     ? ld_window(win + (int64_t)w[u] * d + f, pol_window)
                     : 0.0f;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int k = key[u];
          float x = k >= 0 ? message<M>(v[u], e[u]) : identity<R>();
          // the carried run continues at lane 0, or is finished: emit it
          const int k0 = __shfl_sync(kFull, k, 0);
          if (carry_key >= 0 && carry_key != k0 && lane == 0)
            emit<R>(out, ids, n, carry_key, d, f, carry);
          if (lane == 0 && k == carry_key) x = combine<R>(x, carry);
          // runs of equal key: the head is the first lane of a run, the
          // tail the last; the tail ends up holding the run's total
          const int prev = __shfl_up_sync(kFull, k, 1);
          const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != k);
          const int seg = 31 - __clz(heads & lanes_le);
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(kFull, x, off);
            if (lane - off >= seg) x = combine<R>(x, y);
          }
          const bool tail = lane < 31 && ((heads >> (lane + 1)) & 1u);
          if (tail && k >= 0) emit<R>(out, ids, n, k, d, f, x);
          carry_key = __shfl_sync(kFull, k, 31);
          carry = __shfl_sync(kFull, x, 31);
        }
      }
      if (carry_key >= 0 && lane == 0)
        emit<R>(out, ids, n, carry_key, d, f, carry);
    }
  }
}

// ---- d > 1: one CTA per chunk of kChunkSlots slots --------------------- //
template <int R, int M>
__global__ void __launch_bounds__(kThreads)
fused_pull_rows(const float* __restrict__ values,
                const int32_t* __restrict__ widx,
                const int32_t* __restrict__ cidx,
                const float* __restrict__ ev,
                const uint8_t* __restrict__ mask,
                const int32_t* __restrict__ id_map, float* out, int64_t n,
                int64_t edge_budget, int64_t local_budget,
                int64_t block_size, int d, int64_t chunks_per_block) {
  const int64_t b = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - b * chunks_per_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = b * block_size;
  const int64_t row = b * edge_budget;
  const int32_t* ids = id_map + b * local_budget;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  const unsigned lanes_le = kFull >> (31 - lane);
  // base is the same for the whole warp, so every lane takes the loop and
  // the full-mask shuffles below are well defined
  for (int64_t base = c * kChunkSlots + warp * 32; base < s_end;
       base += kThreads) {
    const int64_t s = base + lane;
    int key = -1;  // -1: no real slot here
    if (s < s_end && mask[row + s]) {
      const int k = cidx[row + s];
      if (k >= 0 && k < local_budget) key = k;
    }
    const bool live = key >= 0;
    const int64_t src = live ? lo + widx[row + s] : 0;
    const float e = (reads_ev(M) && live) ? ev[row + s] : 0.0f;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = 31 - __clz(heads & lanes_le);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    for (int f = 0; f < d; ++f) {
      float v = live ? message<M>(values[src * d + f], e) : identity<R>();
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, v, off);
        if (lane - off >= seg) v = combine<R>(v, t);
      }
      if (tail && live) emit<R>(out, ids, n, key, d, f, v);
    }
  }
}

__global__ void epilogue_kernel(float* __restrict__ out, int64_t count,
                                const float* __restrict__ eps) {
  const float mul = eps[0], add = eps[1];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < count; i += (int64_t)gridDim.x * blockDim.x) {
    // no FMA contraction: the same two roundings as torch's out*mul + add
    out[i] = __fadd_rn(__fmul_rn(out[i], mul), add);
  }
}

struct Args {
  const float* values;
  const int32_t* widx;
  const int32_t* cidx;
  const float* ev;
  const uint8_t* mask;
  const int32_t* id_map;
  float* out;
  int64_t n, num_blocks, edge_budget, local_budget, block_size;
  int d;
};

template <int R, int M>
cudaError_t launch_stream(const Args& a, cudaStream_t st) {
  const int64_t chunks = (a.edge_budget + kWarpSlots - 1) / kWarpSlots;
  const int64_t total = a.num_blocks * chunks;
  const int64_t grid = (total + kWarps - 1) / kWarps;  // a chunk a warp
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  fused_pull_stream<R, M><<<(unsigned)grid, kThreads, 0, st>>>(
      a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.out, a.n,
      a.edge_budget, a.local_budget, a.block_size, a.d, chunks, total);
  return cudaGetLastError();
}

template <int R, int M>
cudaError_t launch_rows(const Args& a, cudaStream_t st) {
  const int64_t chunks = (a.edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = a.num_blocks * chunks;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  fused_pull_rows<R, M><<<(unsigned)grid, kThreads, 0, st>>>(
      a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.out, a.n,
      a.edge_budget, a.local_budget, a.block_size, a.d, chunks);
  return cudaGetLastError();
}

template <int R, int M>
cudaError_t launch_mode(const Args& a, cudaStream_t st) {
  if (a.d > 1) return launch_rows<R, M>(a, st);
  return launch_stream<R, M>(a, st);
}

template <int R>
cudaError_t launch_reduce(const Args& a, int mode, cudaStream_t st) {
  switch (mode) {
    case kMul: return launch_mode<R, kMul>(a, st);
    case kNone: return launch_mode<R, kNone>(a, st);
    case kAddEv: return launch_mode<R, kAddEv>(a, st);
    default: return launch_mode<R, kAddOne>(a, st);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success).  `mode`
// is the message mode (0 mul, 1 none, 2 add-ev, 3 add-one); `ev` is read
// by mul and add-ev and must be null for the others.  `eps` (device, 2
// floats: mul, add) is read only when fuse_epilogue is set.
extern "C" int tocab_fused_pull(const float* values, const int32_t* widx,
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
  if (num_blocks > 0 && edge_budget > 0 && local_budget > 0) {
    const Args a{values, widx, cidx, ev, mask, id_map, out, n, num_blocks,
                 edge_budget, local_budget, block_size, d};
    cudaError_t err = reduce == kSum   ? launch_reduce<kSum>(a, mode, st)
                      : reduce == kMin ? launch_reduce<kMin>(a, mode, st)
                                       : launch_reduce<kMax>(a, mode, st);
    if (err != cudaSuccess) return err;
  }
  const int64_t count = n * d;
  if (fuse_epilogue && count > 0) {
    int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(out, count, eps);
  }
  return cudaGetLastError();
}

extern "C" const char* tocab_fused_pull_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
