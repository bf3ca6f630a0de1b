// Segment ⊕-aggregation on Hopper (sm_90a): the device code shared by the
// single-reduction kernel (segment_aggregate.cu) and the level kernel
// (level_segment_aggregate.cu).
//
//   out[g, c] = ⊕_{r : codes[r] == g} values[r, c]     ⊕ ∈ {sum, min, max}
//
// The TPU kernels this replaces (src/repro/kernels/segment_aggregate/
// kernel.py) build a one-hot (rows × groups) matrix and contract it on the
// matrix unit, because the TPU has no scatter: O(N·G·V) work.  Hopper has
// fast atomics, so here the reduction is one pass over the rows:
//
// - A grid-stride loop gives each thread one value element at a time, so a
//   warp reads 32 consecutive values (row-major) and its atomics go to the
//   contiguous output cells of a few rows.
// - When G·V floats fit comfortably in shared memory and the per-block merge
//   stays small against the row count, each block accumulates into its own
//   shared-memory copy of the output and merges it into global memory once;
//   otherwise every row updates global memory directly (wide outputs spread
//   the atomics over many addresses).
// - sum uses float atomicAdd.  CUDA has no float atomicMin/atomicMax, so
//   min/max use the ordered-integer trick: a non-negative float orders like
//   its bit pattern as a signed int, a negative one inversely to its bit
//   pattern as an unsigned int.  -0.0 is folded to +0.0 first.
// - A value equal to the ⊕-identity (0, +inf or -inf) is skipped.  This is
//   exact (x ⊕ identity = x, up to the sign of zero) and skips the row-bucket
//   pad rows and the σ-masked rows, which would otherwise all hit segment 0.
// - A code outside [0, G) matches nothing: the level kernel's pad rows carry
//   code -1.
//
// Bound: memory.  Each call reads N·4 bytes of codes and N·V·4 bytes of
// values and writes G·V·4 bytes, so on an H100 (3.35 TB/s) it takes at least
// (N·(4 + 4V) + G·V·4) / 3.35e12 seconds.  Atomic sums land in an order that
// changes from run to run, so float sums agree with a sequential sum only to
// rounding; sums of integer-valued floats below 2^24 are exact.

#pragma once

#include <cuda_runtime.h>

namespace segagg {

enum Op { kSum = 0, kMin = 1, kMax = 2 };

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr size_t kSharedBytes = 48 * 1024;

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kSum) return 0.0f;
  if (OP == kMin) return __int_as_float(0x7f800000);  // +inf
  return __int_as_float(0xff800000);                  // -inf
}

template <int OP>
__device__ __forceinline__ void combine(float* addr, float x) {
  if (OP == kSum) {
    atomicAdd(addr, x);
    return;
  }
  if (x == 0.0f) x = 0.0f;  // fold -0.0 into +0.0 for the integer orderings
  if (OP == kMin) {
    if (x >= 0.0f) {
      atomicMin(reinterpret_cast<int*>(addr), __float_as_int(x));
    } else {
      atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(x));
    }
  } else {
    if (x >= 0.0f) {
      atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
    } else {
      atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(x));
    }
  }
}

// One pass over rows [0, n); out holds g·v floats pre-filled with the
// identity by the caller.  SHARED: accumulate in dynamic shared memory.
template <int OP, bool SHARED>
__device__ __forceinline__ void aggregate_rows(const int* __restrict__ codes,
                                               const float* __restrict__ values,
                                               float* __restrict__ out,
                                               long long n, int v, int g) {
  extern __shared__ float acc[];
  const float ident = identity<OP>();
  const int cells = g * v;
  if (SHARED) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = ident;
    __syncthreads();
  }
  float* dst = SHARED ? acc : out;
  // one thread per value element (row, c): a warp reads 32 consecutive
  // values and its atomics land on the few rows' contiguous output cells;
  // (row, c) advance by the grid stride without a division per element
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long row_step = stride / v;
  const int col_step = static_cast<int>(stride % v);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long row = first / v;
  int c = static_cast<int>(first % v);
  for (long long e = first; e < n * v; e += stride) {
    const int code = codes[row];
    const float x = values[e];
    if (code >= 0 && code < g && x != ident) {
      combine<OP>(dst + static_cast<long long>(code) * v + c, x);
    }
    row += row_step;
    c += col_step;
    if (c >= v) {
      c -= v;
      ++row;
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const float x = acc[i];
      if (x != ident) combine<OP>(out + i, x);
    }
  }
}

struct LaunchShape {
  int blocks;
  bool shared;
  size_t smem;
};

inline LaunchShape launch_shape(long long n, int v, int g) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  long long want = (n * v + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  int blocks = static_cast<int>(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(g) * v * sizeof(float);
  // shared copies pay one merge of g·v cells per block: take them only
  // while that merge stays under a quarter of the row pass
  const bool shared = smem <= kSharedBytes &&
                      static_cast<long long>(blocks) * g * 4 <= n;
  return LaunchShape{blocks, shared, shared ? smem : 0};
}

}  // namespace segagg
