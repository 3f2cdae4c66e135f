// Fused TOCAB pull for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces: src/repro/kernels/tocab_fused/kernel.py, fused_pull_pallas /
// _fused_pull_kernel — the TPU kernel behind tocab_pull(impl="fused").
//
// Computes out[id_map[b, cidx[b,s]]] (+|min|max)= values[b*B + widx[b,s]]
// (* ev[b,s]) over every real edge slot s of every TOCAB block b, then,
// if asked, out = out*mul + add.  The wrapper fills out with the semiring
// identity first.
//
// Design.  The Pallas kernel keeps the whole output resident in VMEM and
// relies on its grid running in order (init on the first block, epilogue
// on the last).  Neither holds here: the output is tens of MB and CTAs run
// in no order.  So each CTA takes a contiguous chunk of kChunkSlots edge
// slots of one block, and the chunk is the fastest-varying part of the
// grid: the CTAs in flight all read the same block's value window, which
// stays in L2 (the paper's GPU mechanism; the window is sized to half the
// L2 by choose_block_size).  Edges within a block are sorted by cidx, so
// each warp reduces runs of equal cidx with a segmented shuffle scan and
// performs one global atomic per run.  The epilogue is a second small kernel
// in the same call, since there is no grid-wide "last block".
//
// Bound.  Bytes: the widx/cidx/ev/mask streams (4+4+4+1 = 13 B per edge
// slot, 9 B unweighted), one read of each value-window row the edges
// touch, and per compacted row one id_map read plus one atomic
// read-modify-write on out.  No data reuse a cache can't give, and a
// flop or two per edge: memory bound.  The design streams the slabs
// coalesced and keeps the random value reads inside an L2-resident window;
// the atomics go to L2.
//
// Determinism.  The float atomics add in an order that changes from run to
// run, so the sum semiring is not bit-reproducible; min/max are exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunkSlots = 4096;  // edge slots per CTA (16 per lane)
constexpr unsigned kFull = 0xffffffffu;

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };

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

template <int R, bool W>
__global__ void __launch_bounds__(kThreads)
fused_pull_kernel(const float* __restrict__ values,
                  const int32_t* __restrict__ widx,
                  const int32_t* __restrict__ cidx,
                  const float* __restrict__ ev,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ id_map,
                  float* __restrict__ out, int64_t n, int64_t edge_budget,
                  int64_t local_budget, int64_t block_size, int d,
                  int64_t chunks_per_block) {
  const int64_t b = blockIdx.x / chunks_per_block;
  const int64_t c = blockIdx.x - b * chunks_per_block;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = b * block_size;
  const int64_t row = b * edge_budget;
  const int64_t s_end =
      (c + 1) * kChunkSlots < edge_budget ? (c + 1) * kChunkSlots : edge_budget;
  const unsigned lanes_le = kFull >> (31 - lane);
  for (int64_t base = c * kChunkSlots + warp * 32; base < s_end;
       base += kThreads) {
    const int64_t s = base + lane;
    const bool live = s < s_end && mask[row + s];
    const int key = live ? cidx[row + s] : -1;
    const int64_t src = live ? lo + widx[row + s] : 0;
    const float w = (W && live) ? ev[row + s] : 1.0f;
    // runs of equal key: the head is the first lane of a run, the tail the
    // last; the tail ends up holding the run's total
    const int prev = __shfl_up_sync(kFull, key, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
    const int seg = 31 - __clz(heads & lanes_le);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    int64_t gid = -1;
    if (tail && key >= 0) {
      gid = id_map[b * local_budget + key];
      if (gid >= n) gid = -1;  // padded id_map entry: dropped
    }
    for (int f = 0; f < d; ++f) {
      float v = live ? values[src * d + f] : identity<R>();
      if (W) v *= w;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, v, off);
        if (lane - off >= seg) v = combine<R>(v, t);
      }
      if (gid >= 0) atomic_reduce<R>(out + gid * d + f, v);
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

template <int R, bool W>
void launch_pull(int64_t grid, cudaStream_t st, const float* values,
                 const int32_t* widx, const int32_t* cidx, const float* ev,
                 const uint8_t* mask, const int32_t* id_map, float* out,
                 int64_t n, int64_t edge_budget, int64_t local_budget,
                 int64_t block_size, int d, int64_t chunks_per_block) {
  fused_pull_kernel<R, W><<<(unsigned)grid, kThreads, 0, st>>>(
      values, widx, cidx, ev, mask, id_map, out, n, edge_budget,
      local_budget, block_size, d, chunks_per_block);
}

template <int R>
void launch_pull_w(bool weighted, int64_t grid, cudaStream_t st,
                   const float* values, const int32_t* widx,
                   const int32_t* cidx, const float* ev, const uint8_t* mask,
                   const int32_t* id_map, float* out, int64_t n,
                   int64_t edge_budget, int64_t local_budget,
                   int64_t block_size, int d, int64_t chunks_per_block) {
  if (weighted)
    launch_pull<R, true>(grid, st, values, widx, cidx, ev, mask, id_map, out,
                         n, edge_budget, local_budget, block_size, d,
                         chunks_per_block);
  else
    launch_pull<R, false>(grid, st, values, widx, cidx, ev, mask, id_map,
                          out, n, edge_budget, local_budget, block_size, d,
                          chunks_per_block);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success).  `ev` null
// means unweighted; `eps` (device, 2 floats: mul, add) is read only when
// fuse_epilogue is set.
extern "C" int tocab_fused_pull(const float* values, const int32_t* widx,
                                const int32_t* cidx, const float* ev,
                                const uint8_t* mask, const int32_t* id_map,
                                const float* eps, float* out, int64_t n,
                                int64_t num_blocks, int64_t edge_budget,
                                int64_t local_budget, int64_t block_size,
                                int d, int reduce, int fuse_epilogue,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || reduce < kSum || reduce > kMax) return cudaErrorInvalidValue;
  const int64_t chunks_per_block = (edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = num_blocks * chunks_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (grid > 0) {
    const bool w = ev != nullptr;
    if (reduce == kSum)
      launch_pull_w<kSum>(w, grid, st, values, widx, cidx, ev, mask, id_map,
                          out, n, edge_budget, local_budget, block_size, d,
                          chunks_per_block);
    else if (reduce == kMin)
      launch_pull_w<kMin>(w, grid, st, values, widx, cidx, ev, mask, id_map,
                          out, n, edge_budget, local_budget, block_size, d,
                          chunks_per_block);
    else
      launch_pull_w<kMax>(w, grid, st, values, widx, cidx, ev, mask, id_map,
                          out, n, edge_budget, local_budget, block_size, d,
                          chunks_per_block);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t count = n * d;
  if (fuse_epilogue && count > 0) {
    int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > 65536) blocks = 65536;
    epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(out, count, eps);
    err = cudaGetLastError();
  }
  return err;
}

extern "C" const char* tocab_fused_pull_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
