// tropical_contract: the (min, +) or (max, +) contraction of one dense bag,
//
//   out[g, a] = min_b ( M[g, b] + R[b, a] )      (or max)
//
// M (G, B) and R (B, A) row-major float32; out (G, A) float32, filled with
// the ⊕-identity (+inf for min, -inf for max) by the caller.
//
// Replaces the TPU kernel src/repro/kernels/tropical_contract/kernel.py:37
// (tropical_contract, body _kernel).  The TPU version walks a sequential
// (G/16, A/128, B/128) grid on the vector unit, building a (16, 128, 128)
// broadcast slab per step.  Here, as in semiring_contract.cu:
//
// - A block of up to 256 threads owns a TG × TA output tile, one output per
//   thread (TA = A rounded up to a power of two, at most 32; TG fills the
//   block).  The contracted axis goes in 32-wide steps staged in shared
//   memory; each thread keeps its running min/max in a register, starting
//   from the identity, and uses pure float adds and fminf/fmaxf.
// - When the output tiles alone give fewer than kTargetBlocks blocks, the
//   contracted axis is split across blocks and the partial results merge
//   into out with the ordered-integer atomicMin/atomicMax (CUDA has no
//   float atomic min/max): a non-negative float orders like its bits as a
//   signed int, a negative one inversely to its bits as an unsigned int;
//   -0.0 is folded to +0.0 first.  A partial equal to the identity is
//   skipped.  min and max are exact in any order, so the result does not
//   depend on the split.
// - The inner loop stops at the contracted axis' end, so no padding value
//   ever enters a sum.  Tropical dense factors hold +inf (min) or -inf (max)
//   for absent tuples; both operands carry the same sign, so inf + -inf,
//   and with it NaN, never occurs.
//
// Bound on an H100 SXM: (G·B + B·A + G·A)·4 bytes at 3.35 TB/s, against
// 2·G·B·A instructions (an add and a min/max per term) at half of the
// 67 TFLOP/s float32 FMA rate.  The CJT's shapes (A ≤ 8) are memory bound.
//
// Plain C interface for ctypes; the caller passes PyTorch's current stream.
// Returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;
constexpr int kPad = kTileK + 1;
constexpr int kTargetBlocks = 132 * 8;

template <bool IS_MIN>
__device__ __forceinline__ float identity() {
  return IS_MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
}

template <bool IS_MIN>
__device__ __forceinline__ float pick(float x, float y) {
  return IS_MIN ? fminf(x, y) : fmaxf(x, y);
}

template <bool IS_MIN>
__device__ __forceinline__ void atomic_pick(float* addr, float x) {
  if (x == 0.0f) x = 0.0f;  // fold -0.0 into +0.0 for the integer orderings
  if (IS_MIN) {
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

template <bool IS_MIN>
__global__ void __launch_bounds__(kThreads)
tropical_contract_kernel(const float* __restrict__ m, const float* __restrict__ r,
                         float* __restrict__ out, int g, int b, int a, int tg, int ta_log,
                         int k_per_split, bool atomic) {
  extern __shared__ float smem[];
  const int ta = 1 << ta_log;
  float* ms = smem;                 // tg × kPad
  float* rs = smem + tg * kPad;     // kTileK × ta
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ty = tid >> ta_log;
  const int tx = tid & (ta - 1);
  const long long row0 = static_cast<long long>(blockIdx.x) * tg;
  const int col0 = blockIdx.y * ta;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(b, k_begin + k_per_split);

  float acc = identity<IS_MIN>();
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int kn = min(kTileK, k_end - k0);
    for (int i = tid; i < tg * kTileK; i += nthreads) {
      const int rr = i / kTileK, kk = i % kTileK;
      const long long gr = row0 + rr;
      ms[rr * kPad + kk] = (gr < g && kk < kn) ? m[gr * b + k0 + kk] : 0.0f;
    }
    for (int i = tid; i < kTileK * ta; i += nthreads) {
      const int kk = i >> ta_log, cc = i & (ta - 1);
      const int gc = col0 + cc;
      rs[kk * ta + cc] = (kk < kn && gc < a) ? r[static_cast<long long>(k0 + kk) * a + gc] : 0.0f;
    }
    __syncthreads();
    const float* mrow = ms + ty * kPad;
    if (kn == kTileK) {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) acc = pick<IS_MIN>(acc, mrow[kk] + rs[kk * ta + tx]);
    } else {
      for (int kk = 0; kk < kn; ++kk) acc = pick<IS_MIN>(acc, mrow[kk] + rs[kk * ta + tx]);
    }
    __syncthreads();
  }
  const long long row = row0 + ty;
  const int col = col0 + tx;
  if (row < g && col < a) {
    float* o = out + row * a + col;
    if (!atomic) {
      *o = acc;
    } else if (acc != identity<IS_MIN>()) {
      atomic_pick<IS_MIN>(o, acc);
    }
  }
}

template <bool IS_MIN>
cudaError_t run(const float* m, const float* r, float* out, int g, int b, int a,
                cudaStream_t stream) {
  int ta_log = 0;
  while ((1 << ta_log) < a && ta_log < 5) ++ta_log;
  const int ta = 1 << ta_log;
  int tg = 1;
  while (tg < g && tg * ta < kThreads) tg <<= 1;
  const long long gx = (static_cast<long long>(g) + tg - 1) / tg;
  const long long gy = (static_cast<long long>(a) + ta - 1) / ta;
  const long long tiles = gx * gy;
  const int ksteps = (b + kTileK - 1) / kTileK;
  long long splits = 1;
  if (tiles < kTargetBlocks) {
    splits = (kTargetBlocks + tiles - 1) / tiles;
    if (splits > ksteps) splits = ksteps;
  }
  const int k_per_split = static_cast<int>((ksteps + splits - 1) / splits) * kTileK;
  splits = (b + k_per_split - 1) / k_per_split;
  if (gx > 0x7fffffffLL || gy > 65535 || splits > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(splits));
  const size_t smem = (static_cast<size_t>(tg) * kPad + kTileK * ta) * sizeof(float);
  tropical_contract_kernel<IS_MIN><<<grid, tg * ta, smem, stream>>>(
      m, r, out, g, b, a, tg, ta_log, k_per_split, splits > 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tropical_contract(const void* m, const void* r, void* out, int g, int b, int a,
                                 int is_min, void* stream) {
  if (g <= 0 || b <= 0 || a <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* mm = static_cast<const float*>(m);
  const float* rr = static_cast<const float*>(r);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_min) return static_cast<int>(run<true>(mm, rr, o, g, b, a, s));
  return static_cast<int>(run<false>(mm, rr, o, g, b, a, s));
}

extern "C" const char* tropical_contract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
