// level_segment_aggregate: every segment ⊕-reduction of one calibration
// level in one launch.  It takes a table of member descriptors (struct
// segagg::Member: codes, values and out pointers, N_j, G_j, V_j and the
// member's own partition of the grid; a fused member's recipe in
// segagg::Recipes instead of values), as the TPU kernel's row_blocks /
// seg_blocks table did.  Each member is partitioned from its own
// (N_j, G_j, V_j) alone and reads and writes only its own tensors, so its
// output has the same bits whatever else shares the launch; nothing is
// concatenated or padded.  Up to segagg::kMaxMembers members per launch.
//
// Replaces the TPU kernel src/repro/kernels/segment_aggregate/kernel.py:125
// (level_segment_aggregate, body _level_kernel).  Design, order of the sums
// and bound: segment_aggregate.cuh.  Plain C interface for ctypes, as
// segment_aggregate.cu; returns a cudaError_t.

#include "segment_aggregate.cuh"

template <int OP, int R>
__global__ void __launch_bounds__(segagg::kThreads)
level_segment_aggregate_kernel(const __grid_constant__ segagg::Table t, float* ws) {
  segagg::aggregate_members<OP, R>(t, nullptr, ws);
}

// a grid of fused members: their recipes come as a second by-value parameter
template <int OP, int R>
__global__ void __launch_bounds__(segagg::kThreads)
level_segment_aggregate_fused_kernel(const __grid_constant__ segagg::Table t,
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
      static const cudaError_t opted = big_smem(level_segment_aggregate_fused_kernel<OP, R>);
      if (opted != cudaSuccess) return opted;
    }
    return segagg::launch_regime(level_segment_aggregate_fused_kernel<OP, R>, t, R, s, t, *rs, ws);
  } else {
    if constexpr (big) {
      static const cudaError_t opted = big_smem(level_segment_aggregate_kernel<OP, R>);
      if (opted != cudaSuccess) return opted;
    }
    return segagg::launch_regime(level_segment_aggregate_kernel<OP, R>, t, R, s, t, ws);
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

extern "C" int level_segment_aggregate(const void* table, const void* recipes, int op, void* ws,
                                       void* stream) {
  const segagg::Table& t = *static_cast<const segagg::Table*>(table);
  const segagg::Recipes* rs = static_cast<const segagg::Recipes*>(recipes);
  if (!segagg::table_ok(t, rs, ws)) {
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

extern "C" const char* level_segment_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
