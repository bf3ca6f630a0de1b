// semiring_contract: the arithmetic-semiring contraction of one dense bag,
//
//   out[g, a] = Σ_b  M[g, b] · mask[b] · R[b, a]
//
// M (G, B) and R (B, A) both float32 or both float16, any 2-D views with one
// unit-stride axis each; mask (B,) float32 or absent; out (G, A) float32
// row-major, written whole by the kernel.  Full float32 FMA, no TF32.
//
// Replaces the TPU kernel src/repro/kernels/semiring_contract/kernel.py:36
// (semiring_contract, bodies _kernel and _masked_none_kernel), which walks
// a sequential (G/128, A/128, B/128) grid on the matrix unit and carries
// each output tile across the contracted steps.  Blocks on the card run in
// parallel and in no order, and the dense bags give skinny products,
// (16, 100 000) × (100 000, 8) or (100 000, 16) × (16, 1), not square
// ones.  Design, regimes and bound: ../../csrc/contract.cuh.  Split sums
// merge in a fixed order, so the result does not change from run to run.
//
// Plain C interface for ctypes: the launch geometry comes from
// repro_torch/kernels/launch.py as a host array of int64 (struct Geom), the
// workspace and tickets from the caller (kept per stream by launch.Kernel,
// or null when the geometry needs none), the stream is PyTorch's current
// one.  Returns a cudaError_t.

#include "contract.cuh"

extern "C" int semiring_contract(const void* m, const void* r, const void* mask, void* out,
                                 void* ws, void* tickets, const void* geom, void* stream) {
  const contract::Geom* q = static_cast<const contract::Geom*>(geom);
  if (!contract::geometry_ok(q, ws, tickets)) return static_cast<int>(cudaErrorInvalidValue);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q->half) {
    return static_cast<int>(contract::launch<__half, contract::Sum>(m, r, mk, o, w, t, *q, s));
  }
  return static_cast<int>(contract::launch<float, contract::Sum>(m, r, mk, o, w, t, *q, s));
}

extern "C" const char* semiring_contract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
