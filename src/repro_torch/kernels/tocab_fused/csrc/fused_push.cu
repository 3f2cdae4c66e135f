// Fused TOCAB push for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces: src/repro/kernels/tocab_fused/kernel.py, fused_push_pallas /
// _fused_push_kernel — the TPU kernel behind tocab_push(impl="fused").
//
// Computes out[b*B + widx[b,s]] (+|min|max)= values[id_map[b, cidx[b,s]]]
// (* ev[b,s]) over every real edge slot s of every TOCAB block b (row
// blocking: block b owns the disjoint destination window [b*B, b*B+B)),
// then, if asked, out = out*mul + add.
//
// Design.  The Pallas kernel gathers the block's distinct sources once into
// VMEM (block_contrib) and scatters into a VMEM copy of the block's window.
// Here each edge reads its source value straight through id_map (edges are
// sorted by cidx, so a warp's lanes mostly share a source and the read is a
// broadcast), and the scatter goes to
//   * shared memory, when the window (B*d*4 bytes) fits kSmemWindowBytes:
//     one CTA per block accumulates its window with shared-memory atomics
//     and writes it out once, epilogue applied on the way;
//   * global memory otherwise: CTAs take contiguous edge chunks, the chunk
//     fastest-varying in the grid, so the CTAs in flight hit one block's
//     window, which stays in L2 (sized to half the L2 by choose_block_size);
//     the wrapper fills out with the identity, and a second small kernel
//     applies the epilogue.
// Windows are disjoint, so a block never touches another block's rows: the
// order blocks are visited in cannot change results.
//
// Bound.  Bytes: the widx/cidx/ev/mask streams (13 B per edge slot, 9 B
// unweighted), one id_map read and one value read per distinct source of a
// block, and the window rows of out — one write each on the shared path,
// an atomic read-modify-write per edge (in L2) on the global path.
// Memory bound, as the pull kernel.
//
// Determinism.  Float atomics add in an order that changes from run to run,
// so the sum semiring is not bit-reproducible; min/max are exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunkSlots = 4096;  // edge slots per CTA, global path
constexpr int64_t kSmemWindowBytes = 200 * 1024;

enum Reduce { kSum = 0, kMin = 1, kMax = 2 };

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

// One edge slot: reduce its message into `win` (the block's window, shared
// or global).
template <int R, bool W>
__device__ __forceinline__ void push_edge(
    const float* __restrict__ values, const int32_t* __restrict__ widx,
    const int32_t* __restrict__ cidx, const float* __restrict__ ev,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ id_map,
    float* win, int64_t n, int64_t b, int64_t local_budget, int64_t slot,
    int d) {
  if (!mask[slot]) return;
  const int64_t src = id_map[b * local_budget + cidx[slot]];
  if (src >= n) return;  // padded id_map entry reads nothing
  const int64_t w_row = widx[slot];
  const float w = W ? ev[slot] : 1.0f;
  for (int f = 0; f < d; ++f) {
    float v = values[src * d + f];
    if (W) v *= w;
    atomic_reduce<R>(win + w_row * d + f, v);
  }
}

template <int R, bool W>
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
    push_edge<R, W>(values, widx, cidx, ev, mask, id_map, win, n, b,
                    local_budget, row + s, d);
}

template <int R, bool W>
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
    push_edge<R, W>(values, widx, cidx, ev, mask, id_map, win, n, b,
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
  int d, fuse_epilogue;
};

template <int R, bool W>
cudaError_t launch_push(const Args& a, bool shared, cudaStream_t st) {
  if (shared) {
    const int64_t bytes = a.block_size * a.d * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_push_shared<R, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    fused_push_shared<R, W><<<(unsigned)a.num_blocks, kThreads, bytes, st>>>(
        a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.eps, a.out, a.n,
        a.edge_budget, a.local_budget, a.block_size, a.d, a.fuse_epilogue);
    return cudaGetLastError();
  }
  const int64_t chunks = (a.edge_budget + kChunkSlots - 1) / kChunkSlots;
  const int64_t grid = a.num_blocks * chunks;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  fused_push_global<R, W><<<(unsigned)grid, kThreads, 0, st>>>(
      a.values, a.widx, a.cidx, a.ev, a.mask, a.id_map, a.out, a.n,
      a.edge_budget, a.local_budget, a.block_size, a.d, chunks);
  cudaError_t err = cudaGetLastError();
  const int64_t count = a.n * a.d;
  if (err != cudaSuccess || !a.fuse_epilogue || count == 0) return err;
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;
  epilogue_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a.out, count, a.eps);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_push_w(const Args& a, bool shared, cudaStream_t st) {
  return a.ev != nullptr ? launch_push<R, true>(a, shared, st)
                         : launch_push<R, false>(a, shared, st);
}

}  // namespace

// Whether the window of a block is accumulated in shared memory; the
// wrapper fills `out` with the identity only when it is not (the shared
// path writes every row below n).
extern "C" int tocab_fused_push_window_shared(int64_t block_size, int d) {
  return block_size * d * static_cast<int64_t>(sizeof(float)) <=
         kSmemWindowBytes;
}

// Returns cudaGetLastError() after the launches (0 on success).  `ev` null
// means unweighted; `eps` (device, 2 floats: mul, add) is read only when
// fuse_epilogue is set.
extern "C" int tocab_fused_push(const float* values, const int32_t* widx,
                                const int32_t* cidx, const float* ev,
                                const uint8_t* mask, const int32_t* id_map,
                                const float* eps, float* out, int64_t n,
                                int64_t num_blocks, int64_t edge_budget,
                                int64_t local_budget, int64_t block_size,
                                int d, int reduce, int fuse_epilogue,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || reduce < kSum || reduce > kMax) return cudaErrorInvalidValue;
  if (num_blocks == 0) return cudaSuccess;
  const Args a{values, widx, cidx, ev, mask, id_map, eps, out, n,
               num_blocks, edge_budget, local_budget, block_size, d,
               fuse_epilogue};
  const bool shared = tocab_fused_push_window_shared(block_size, d);
  if (reduce == kSum) return launch_push_w<kSum>(a, shared, st);
  if (reduce == kMin) return launch_push_w<kMin>(a, shared, st);
  return launch_push_w<kMax>(a, shared, st);
}

extern "C" const char* tocab_fused_push_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
