// segment_aggregate: one segment ⊕-reduction, codes (N,) int32 and values
// (N, V) float32 row-major into out (G, V) float32, as a member table of one.
//
// Replaces the TPU kernel src/repro/kernels/segment_aggregate/kernel.py:62
// (segment_aggregate, body _kernel).  Design, order of the sums and bound:
// segment_aggregate.cuh.  Plain C interface for ctypes: the caller passes a
// host segagg::Table (launch.py packs it, with each regime's grid and shared
// memory), the workspace of the current stream (null when the table needs
// none) and PyTorch's current stream.  Returns a cudaError_t.

#include "segment_aggregate.cuh"

template <int OP, int R>
__global__ void __launch_bounds__(segagg::kThreads)
segment_aggregate_kernel(const __grid_constant__ segagg::Table t, float* ws) {
  segagg::aggregate_members<OP, R>(t, ws);
}

template <int OP, int R>
static cudaError_t launch(const segagg::Table& t, float* ws, cudaStream_t s) {
  if constexpr (R == segagg::kThread || R == segagg::kWarp) {  // past 48 KiB: opt in, once
    static const cudaError_t opted = cudaFuncSetAttribute(
        segment_aggregate_kernel<OP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        segagg::kBigSmemMax);
    if (opted != cudaSuccess) return opted;
  }
  return segagg::launch_regime(segment_aggregate_kernel<OP, R>, t, R, ws, s);
}

// one grid per regime present, in regime order, then the merge grid
template <int OP>
static cudaError_t run(const segagg::Table& t, float* ws, cudaStream_t s) {
  cudaError_t err = launch<OP, segagg::kThread>(t, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kWarp>(t, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kSort>(t, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kSortOrdered>(t, ws, s);
  if (err == cudaSuccess) err = launch<OP, segagg::kMerge>(t, ws, s);
  return err;
}

extern "C" int segment_aggregate(const void* table, int op, void* ws, void* stream) {
  const segagg::Table& t = *static_cast<const segagg::Table*>(table);
  if (t.count != 1 || !segagg::table_ok(t, ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case segagg::kSum: return static_cast<int>(run<segagg::kSum>(t, w, s));
    case segagg::kMin: return static_cast<int>(run<segagg::kMin>(t, w, s));
    case segagg::kMax: return static_cast<int>(run<segagg::kMax>(t, w, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segment_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
