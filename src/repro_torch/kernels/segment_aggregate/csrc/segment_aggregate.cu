// segment_aggregate: one segment ⊕-reduction, codes (N,) int32 and values
// (N, V) float32 row-major into out (G, V) float32, as a member table of one.
//
// Replaces the TPU kernel src/repro/kernels/segment_aggregate/kernel.py:62
// (segment_aggregate, body _kernel).  Design, order of the sums and bound:
// segment_aggregate.cuh.  Plain C interface for ctypes: the caller passes a
// host segagg::Table (launch.py packs it, with each grid's size and shared
// memory), its segagg::Recipes when the member is fused (else null), the
// workspace of the current stream (null when the table needs none) and
// PyTorch's current stream.  Returns a cudaError_t.

#include "segment_aggregate.cuh"

template <int OP, int R>
__global__ void __launch_bounds__(segagg::kThreads)
segment_aggregate_kernel(const __grid_constant__ segagg::Table t, float* ws) {
  segagg::aggregate_members<OP, R>(t, nullptr, ws);
}

// a grid of fused members: their recipes come as a second by-value parameter
template <int OP, int R>
__global__ void __launch_bounds__(segagg::kThreads)
segment_aggregate_fused_kernel(const __grid_constant__ segagg::Table t,
                               const __grid_constant__ segagg::Recipes rs, float* ws) {
  segagg::aggregate_members<OP, R>(t, &rs, ws);
}

// Opt in past 48 KiB of dynamic shared memory, once per kernel.
template <typename Kernel>
static cudaError_t big_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              segagg::kBigSmemMax);
}

template <int OP, int R>
static cudaError_t launch(const segagg::Table& t, const segagg::Recipes* rs, float* ws,
                          cudaStream_t s) {
  if (t.members[R] == 0 || t.grid[R] == 0) return cudaSuccess;
  constexpr int base = segagg::base_regime(R);
  constexpr bool big = R < segagg::kMerge && (base == segagg::kThread || base == segagg::kWarp);
  if constexpr (R >= segagg::kFused && R < segagg::kMerge) {
    if constexpr (big) {
      static const cudaError_t opted = big_smem(segment_aggregate_fused_kernel<OP, R>);
      if (opted != cudaSuccess) return opted;
    }
    return segagg::launch_regime(segment_aggregate_fused_kernel<OP, R>, t, R, s, t, *rs, ws);
  } else {
    if constexpr (big) {
      static const cudaError_t opted = big_smem(segment_aggregate_kernel<OP, R>);
      if (opted != cudaSuccess) return opted;
    }
    return segagg::launch_regime(segment_aggregate_kernel<OP, R>, t, R, s, t, ws);
  }
}

// one grid per regime and source present, in grid order, then the merge grid
template <int OP>
static cudaError_t run(const segagg::Table& t, const segagg::Recipes* rs, float* ws,
                       cudaStream_t s) {
  cudaError_t err = launch<OP, segagg::kThread>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kWarp>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kSort>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kSortOrdered>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kFused + segagg::kThread>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kFused + segagg::kWarp>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kFused + segagg::kSort>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kFused + segagg::kSortOrdered>(t, rs, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kMerge>(t, rs, ws, s);
  return err;
}

extern "C" int segment_aggregate(const void* table, const void* recipes, int op, void* ws,
                                 void* stream) {
  const segagg::Table& t = *static_cast<const segagg::Table*>(table);
  const segagg::Recipes* rs = static_cast<const segagg::Recipes*>(recipes);
  if (t.count != 1 || !segagg::table_ok(t, rs, ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case segagg::kSum: return static_cast<int>(run<segagg::kSum>(t, rs, w, s));
    case segagg::kMin: return static_cast<int>(run<segagg::kMin>(t, rs, w, s));
    case segagg::kMax: return static_cast<int>(run<segagg::kMax>(t, rs, w, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segment_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
