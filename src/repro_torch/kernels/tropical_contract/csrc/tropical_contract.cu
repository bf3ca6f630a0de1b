// tropical_contract: the (min, +) or (max, +) contraction of one dense bag,
//
//   out[g, a] = min_b ( M[g, b] + R[b, a] )      (or max)
//
// M (G, B) and R (B, A) float32, any 2-D views with one unit-stride axis
// each; out (G, A) float32 row-major, written whole by the kernel, starting
// from the ⊕-identity (+inf for min, -inf for max).
//
// Replaces the TPU kernel src/repro/kernels/tropical_contract/kernel.py:37
// (tropical_contract, body _kernel), which walks a sequential (G/16, A/128,
// B/128) grid on the vector unit, building a (16, 128, 128) broadcast slab
// per step.  Here the same body as semiring_contract serves, with ⊗ = + and
// ⊕ = fminf/fmaxf: design, regimes and bound in ../../csrc/contract.cuh.
// Split partials merge through the workspace like the sum's (min and max
// are exact in any order), so the output needs no fill.  Tropical dense
// factors hold +inf (min) or -inf (max) for absent tuples; both operands
// carry the same sign, so inf + -inf, and with it NaN, never occurs.
//
// Plain C interface for ctypes, as semiring_contract.cu.  Returns a
// cudaError_t.

#include "contract.cuh"

extern "C" int tropical_contract(const void* m, const void* r, void* out, void* ws,
                                 void* tickets, const void* geom, int is_min, void* stream) {
  const contract::Geom* q = static_cast<const contract::Geom*>(geom);
  if (!contract::geometry_ok(q, ws, tickets) || q->half) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  unsigned int* t = static_cast<unsigned int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_min) {
    return static_cast<int>(
        contract::launch<float, contract::Tropical<true>>(m, r, nullptr, o, w, t, *q, s));
  }
  return static_cast<int>(
      contract::launch<float, contract::Tropical<false>>(m, r, nullptr, o, w, t, *q, s));
}

extern "C" const char* tropical_contract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
