// TOCAB blocked SpMM for NVIDIA Hopper (sm_90a), with a plain C interface:
// the phase-2 partial slab of a subset of blocks, sum semiring.
//
// Replaces: src/repro/kernels/tocab_spmm/kernel.py, tocab_spmm_pallas /
// _kernel — the TPU kernel behind the dense bin of schedule="balanced" pull
// (bin_pull_partials in src/repro/core/balance.py).
//
// Computes, for j < k and b = block_ids[j],
//   out[j, l, f] = sum over the real slots s of block b with cidx[b,s] == l
//                  of ev[b,s] * values[(b*B + widx[b,s]) * d + f]
// (ev = 1 when it is null).  A slot whose mask is clear is skipped, never
// multiplied by 0, so a NaN or Inf that only padding reads stays out; a
// slot with cidx outside [0, local_budget) is dropped.  The wrapper fills
// out with zeros.
//
// Design.  The Pallas kernel copies each block's value window into VMEM
// (after padding the values to num_blocks*B rows and the features to 128
// lanes) and accumulates the block's (local_budget, d) slab there over a
// sequential loop of edge chunks, as a one-hot matmul or a VMEM scatter.
// Here a dense block's slab (millions of rows) fits no CTA's shared memory,
// and CTAs run in no order.  So a persistent grid (a few CTAs per SM) walks
// warp chunks of kWarpSlots consecutive slots in block-major order with a
// static stride: the warps in flight all read one block's window, in place
// at b*B (no copy, no padding), and keep it in L2.  A warp takes U steps of
// 32 slots at once: the U steps' mask/cidx/widx loads issue together (all
// of them: reading cidx/widx only where the mask is set measured slower,
// it puts the mask load in the gathers' chain), then the U window gathers,
// so U gathers are in flight per lane before the first segmented scan.
// Edges in a block are sorted by cidx, so each step reduces runs of equal
// cidx with a segmented shuffle scan; the run that reaches the step's last
// lane is carried in registers into the next step (the dense bin's runs
// average ~19 slots), and a run's sum is added to the slab once per warp
// chunk — one atomicAdd per run, not one per step.  That is d = 1
// (tocab_spmm_stream), the main path's width.  For d > 1
// (tocab_spmm_rows) CTAs take contiguous chunks of kChunkSlots slots,
// chunk fastest-varying in the grid, one slot a lane: each lane gathers
// its row feature by feature, right after one another, and each 32-slot
// step adds its runs with one atomic each.  The streaming design, its slot
// streams read once for all features, measured 1.6x slower than this one
// on an H100 at d = 8 on the scale-24 dense block, whose 8-wide window
// (210 MB) does not fit L2.
// Cache policy (d = 1): the slot streams are read with an L2 evict-first
// hint and no L1 allocation, the window with an L2 evict-last hint,
// through L1 (the rows of hub vertices are read by many edges), so the
// streams do not push the window out of L2.  The TPU kernel's two modes
// compute one function; this kernel serves both.
//
// Bound.  Bytes: widx, cidx and mask per slot (9 B; 13 B weighted), one read
// of each window row the edges touch, one write per slab row.  One add (and
// one multiply) per edge: memory bound.  The gathers are random 4-byte
// reads, each a 32-byte sector: what sets the pace is how many sectors L2
// serves per second — and whether the window stays in L2, since a gather
// that misses reads a 32-byte sector from device memory.
//
// The earlier d = 1 design (tocab_spmm_rows at d = 1) is timed beside this
// one from benchmarks/torch_graph_kernel_variants.py's copy of it.
//
// Determinism.  The float atomics add in an order that changes from run to
// run, so the sum is not bit-reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;               // U: 32-slot steps a warp batches
constexpr int64_t kWarpSlots = 2048;    // slots of one warp chunk
constexpr int64_t kChunkSlots = 4096;   // d > 1: slots per CTA
constexpr unsigned kFull = 0xffffffffu;

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

// ---- d = 1: persistent, batched, cache-hinted ------------------------- //
// Work item t (a warp chunk) -> (id j, chunk c), id-major; the run that
// crosses each 32-slot step is carried in (carry_key, carry).
template <bool W>
__global__ void __launch_bounds__(kThreads)
tocab_spmm_stream(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ block_ids,
                  float* __restrict__ out, int64_t num_blocks,
                  int64_t edge_budget, int64_t block_size,
                  int64_t local_budget, int64_t chunks_per_block,
                  int64_t total) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_le = kFull >> (31 - lane);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const uint64_t pol_stream = policy_evict_first();
  const uint64_t pol_window = policy_evict_last();
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < total; t += stride) {
    const int64_t j = t / chunks_per_block;
    const int64_t s0 = (t - j * chunks_per_block) * kWarpSlots;
    const int64_t b = block_ids[j];
    if (b < 0 || b >= num_blocks) continue;  // the wrapper validates the ids
    const int64_t s_end =
        s0 + kWarpSlots < edge_budget ? s0 + kWarpSlots : edge_budget;
    const int64_t row = b * edge_budget;
    const float* win = values + b * block_size;
    float* slab = out + j * local_budget;
    int carry_key = -1;  // the run reaching the last step's lane 31
    float carry = 0.0f;
    for (int64_t base = s0; base < s_end; base += 32 * kSteps) {
      int key[kSteps], w[kSteps];
      float e[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int64_t s = base + u * 32 + lane;
        key[u] = -1;  // -1: no real slot here
        w[u] = 0;
        e[u] = 1.0f;
        if (s < s_end) {
          const int m = ld_stream(mask + row + s, pol_stream);
          const int k = ld_stream(cidx + row + s, pol_stream);
          w[u] = ld_stream(widx + row + s, pol_stream);
          if (W) e[u] = ld_stream(ev + row + s, pol_stream);
          if (m && k >= 0 && k < local_budget) key[u] = k;
        }
      }
      float v[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        v[u] = key[u] >= 0 ? ld_window(win + w[u], pol_window) : 0.0f;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int k = key[u];
        float x = key[u] >= 0 ? (W ? v[u] * e[u] : v[u]) : 0.0f;
        // the carried run continues at lane 0, or is finished: add it
        const int k0 = __shfl_sync(kFull, k, 0);
        if (carry_key >= 0 && carry_key != k0 && lane == 0)
          atomicAdd(slab + carry_key, carry);
        if (lane == 0 && k == carry_key) x += carry;
        // runs of equal key: the head is the first lane of a run, the
        // tail the last; the tail ends up holding the run's total
        const int prev = __shfl_up_sync(kFull, k, 1);
        const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != k);
        const int seg = 31 - __clz(heads & lanes_le);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(kFull, x, off);
          if (lane - off >= seg) x += y;
        }
        const bool tail = lane < 31 && ((heads >> (lane + 1)) & 1u);
        if (tail && k >= 0) atomicAdd(slab + k, x);
        carry_key = __shfl_sync(kFull, k, 31);
        carry = __shfl_sync(kFull, x, 31);
      }
    }
    if (carry_key >= 0 && lane == 0) atomicAdd(slab + carry_key, carry);
  }
}

// ---- d > 1: one CTA per chunk of kChunkSlots slots --------------------- //
template <bool W>
__global__ void __launch_bounds__(kThreads)
tocab_spmm_rows(const float* __restrict__ values,
                const int32_t* __restrict__ widx,
                const int32_t* __restrict__ cidx,
                const float* __restrict__ ev,
                const uint8_t* __restrict__ mask,
                const int32_t* __restrict__ block_ids,
                float* __restrict__ out, int64_t num_blocks,
                int64_t edge_budget, int64_t block_size, int64_t local_budget,
                int d, int64_t chunks_per_block) {
  const int64_t j = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - j * chunks_per_block;
  const int64_t b = block_ids[j];
  if (b < 0 || b >= num_blocks) return;  // the wrapper validates the ids
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = b * block_size;
  const int64_t row = b * edge_budget;
  float* slab = out + j * local_budget * d;
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
    const float w = (W && live) ? ev[row + s] : 1.0f;
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = 31 - __clz(heads & lanes_le);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    for (int f = 0; f < d; ++f) {
      float v = live ? values[src * d + f] : 0.0f;
      if (W) v *= w;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, v, off);
        if (lane - off >= seg) v += t;
      }
      if (tail && live) atomicAdd(slab + (int64_t)key * d + f, v);
    }
  }
}

// CTAs of kernel `k` resident on the current card at kThreads threads
// each (0 if the runtime cannot say; its error is then pending)
template <typename K>
int64_t resident_ctas(K k) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return (int64_t)sms * (per_sm > 0 ? per_sm : 1);
}

template <bool W>
cudaError_t launch(const float* values, const int32_t* widx,
                   const int32_t* cidx, const float* ev, const uint8_t* mask,
                   const int32_t* block_ids, float* out, int64_t num_ids,
                   int64_t num_blocks, int64_t edge_budget,
                   int64_t block_size, int64_t local_budget, int d,
                   cudaStream_t st) {
  if (d > 1) {
    const int64_t chunks = (edge_budget + kChunkSlots - 1) / kChunkSlots;
    const int64_t grid = num_ids * chunks;
    if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
    tocab_spmm_rows<W><<<(unsigned)grid, kThreads, 0, st>>>(
        values, widx, cidx, ev, mask, block_ids, out, num_blocks,
        edge_budget, block_size, local_budget, d, chunks);
    return cudaGetLastError();
  }
  const int64_t chunks = (edge_budget + kWarpSlots - 1) / kWarpSlots;
  const int64_t total = num_ids * chunks;
  const int64_t ctas_needed = (total + kWarps - 1) / kWarps;
  const int64_t resident = resident_ctas(tocab_spmm_stream<W>);
  if (resident == 0) return cudaGetLastError();
  const int64_t grid = ctas_needed < resident ? ctas_needed : resident;
  tocab_spmm_stream<W><<<(unsigned)grid, kThreads, 0, st>>>(
      values, widx, cidx, ev, mask, block_ids, out, num_blocks, edge_budget,
      block_size, local_budget, chunks, total);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  `ev` null
// means unweighted.  `block_ids` (device, num_ids int32) selects the
// blocks; out is (num_ids, local_budget, d), zero-filled by the caller.
extern "C" int tocab_spmm(const float* values, const int32_t* widx,
                          const int32_t* cidx, const float* ev,
                          const uint8_t* mask, const int32_t* block_ids,
                          float* out, int64_t num_ids, int64_t num_blocks,
                          int64_t edge_budget, int64_t block_size,
                          int64_t local_budget, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1) return cudaErrorInvalidValue;
  if (num_ids == 0 || edge_budget == 0 || local_budget == 0)
    return cudaSuccess;
#define TS_ARGS values, widx, cidx, ev, mask, block_ids, out, num_ids, \
    num_blocks, edge_budget, block_size, local_budget, d, st
  return ev != nullptr ? launch<true>(TS_ARGS) : launch<false>(TS_ARGS);
#undef TS_ARGS
}

extern "C" const char* tocab_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
