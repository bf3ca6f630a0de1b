// level_segment_aggregate: every segment ⊕-reduction of one calibration
// level in one launch.  The wrapper concatenates the messages' operands:
// codes (ΣN_j,) int32 hold GLOBAL segment ids (each message's local ids
// shifted by its running segment offset), values (ΣN_j, V_max) float32 are
// column-padded with the ⊕-identity, out is (ΣG_j, V_max).  Codes outside
// [0, ΣG_j), such as the -1 of a pad row, match nothing.  The messages' row
// and segment ranges are disjoint, so one pass over the rows computes every
// message at once; no tile table is needed (the TPU kernel had one only to
// walk its sequential grid block-diagonally).
//
// Replaces the TPU kernel src/repro/kernels/segment_aggregate/kernel.py:125
// (level_segment_aggregate, body _level_kernel).  Design and bound:
// segment_aggregate.cuh, with N = ΣN_j, G = ΣG_j and V = V_max.
// Plain C interface for ctypes; returns a cudaError_t.

#include "segment_aggregate.cuh"

template <int OP, bool SHARED>
__global__ void __launch_bounds__(segagg::kThreads)
level_segment_aggregate_kernel(const int* __restrict__ codes, const float* __restrict__ values,
                               float* __restrict__ out, long long n, int v, int g) {
  segagg::aggregate_rows<OP, SHARED>(codes, values, out, n, v, g);
}

template <int OP>
static cudaError_t run(const int* codes, const float* values, float* out,
                       long long n, int v, int g, cudaStream_t stream) {
  const segagg::LaunchShape ls = segagg::launch_shape(n, v, g);
  if (ls.shared) {
    level_segment_aggregate_kernel<OP, true>
        <<<ls.blocks, segagg::kThreads, ls.smem, stream>>>(codes, values, out, n, v, g);
  } else {
    level_segment_aggregate_kernel<OP, false>
        <<<ls.blocks, segagg::kThreads, 0, stream>>>(codes, values, out, n, v, g);
  }
  return cudaGetLastError();
}

extern "C" int level_segment_aggregate(const void* codes, const void* values, void* out,
                                       long long n, int v, int g, int op, void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return static_cast<int>(cudaSuccess);
  const int* c = static_cast<const int*>(codes);
  const float* x = static_cast<const float*>(values);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case segagg::kSum: return static_cast<int>(run<segagg::kSum>(c, x, o, n, v, g, s));
    case segagg::kMin: return static_cast<int>(run<segagg::kMin>(c, x, o, n, v, g, s));
    case segagg::kMax: return static_cast<int>(run<segagg::kMax>(c, x, o, n, v, g, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* level_segment_aggregate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
