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
// and CTAs run in no order.  So each CTA takes kChunkSlots consecutive edge
// slots of one block, and the chunk is the fastest-varying part of the grid:
// the CTAs in flight all read one block's window, in place at b*B (no copy,
// no padding), and keep it in L2.  Edges in a block are sorted by cidx, so
// each warp reduces runs of equal cidx with a segmented shuffle scan and
// issues one atomicAdd per run into the slab, addressed in 64 bits.  The
// TPU kernel's two modes compute one function; this kernel serves both.
//
// Bound.  Bytes: widx, cidx and mask per slot (9 B; 13 B weighted), one read
// of each window row the edges touch, one atomic read-modify-write per run
// on the slab.  One add (and one multiply) per edge: memory bound.  The
// slabs stream coalesced; the random value reads stay inside the block's
// L2-resident window; the atomics go to L2.
//
// Determinism.  The float atomics add in an order that changes from run to
// run, so the sum is not bit-reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunkSlots = 4096;  // edge slots per CTA (16 per lane)
constexpr unsigned kFull = 0xffffffffu;

template <bool W>
__global__ void __launch_bounds__(kThreads)
tocab_spmm_kernel(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ block_ids,
                  float* __restrict__ out, int64_t num_blocks,
                  int64_t edge_budget, int64_t block_size,
                  int64_t local_budget, int d, int64_t chunks_per_block) {
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
    // runs of equal key: the head is the first lane of a run, the tail the
    // last; the tail ends up holding the run's total
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
  const int64_t chunks_per_block = (edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = num_ids * chunks_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (grid > 0 && local_budget > 0) {
    if (ev != nullptr)
      tocab_spmm_kernel<true><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, block_ids, out, num_blocks,
          edge_budget, block_size, local_budget, d, chunks_per_block);
    else
      tocab_spmm_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(
          values, widx, cidx, ev, mask, block_ids, out, num_blocks,
          edge_budget, block_size, local_budget, d, chunks_per_block);
  }
  return cudaGetLastError();
}

extern "C" const char* tocab_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
