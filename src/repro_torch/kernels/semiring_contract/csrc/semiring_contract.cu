// semiring_contract: the arithmetic-semiring contraction of one dense bag,
//
//   out[g, a] = Σ_b  M[g, b] · mask[b] · R[b, a]
//
// M (G, B) and R (B, A) row-major, both float32 or both float16; mask (B,)
// float32 or absent; out (G, A) float32, filled with zeros by the caller.
//
// Replaces the TPU kernel src/repro/kernels/semiring_contract/kernel.py:36
// (semiring_contract, bodies _kernel and _masked_none_kernel).  The TPU
// version walks a sequential (G/128, A/128, B/128) grid on the matrix unit
// and carries each output tile across the contracted steps.  Blocks on the
// card run in parallel and in no order, and the CJT's dense bags give skinny
// shapes, not square ones: (16…192, 100 000) × (100 000, 1…8) for a dense
// User bag sending towards Role, (100 000…1 200 000, 16) × (16, 1) for the
// same bag sending towards Opp.  A grid over output tiles alone gives one
// block for the first shape on a card of 132 SMs.  So:
//
// - A block of up to 256 threads owns a TG × TA output tile, one output per
//   thread.  TA is A rounded up to a power of two, at most 32; TG fills the
//   rest of the block, at most G rounded up.  A skinny output keeps every
//   thread busy.
// - The contracted axis is cut into 32-wide steps staged in shared memory
//   (M with its σ mask applied and converted to float, R converted to
//   float), read by neighbouring threads at neighbouring addresses.
// - When the output tiles alone give fewer than kTargetBlocks blocks, the
//   contracted axis is also split across blocks (split-K); each block adds
//   its partial sums into out with float atomicAdd.  Sums then land in an
//   order that changes from run to run: integer-valued float32 data stays
//   exact (sums below 2^24), other data agrees with a sequential sum to
//   rounding.
// - Full float32 FMA, no TF32: integer-valued data must stay exact.
//
// Bound on an H100 SXM: the inputs are read once and the output written
// once, (G·B + B·A)·s + G·A·4 bytes (s = 4 for float32, 2 for float16, plus
// B·4 for the mask) at 3.35 TB/s, against G·B·A FMAs (2·G·B·A flops) at
// 67 TFLOP/s of float32.  The CJT's shapes are memory bound: A ≤ 8 gives
// under 4 flops per byte.
//
// Plain C interface for ctypes; the caller passes PyTorch's current stream.
// Returns a cudaError_t.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;
constexpr int kPad = kTileK + 1;            // M tile row stride: no bank conflicts
constexpr int kTargetBlocks = 132 * 8;      // 8 blocks per SM before split-K stops

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T, bool MASK>
__global__ void __launch_bounds__(kThreads)
semiring_contract_kernel(const T* __restrict__ m, const T* __restrict__ r,
                         const float* __restrict__ mask, float* __restrict__ out,
                         int g, int b, int a, int tg, int ta_log, int k_per_split,
                         bool atomic) {
  extern __shared__ float smem[];
  const int ta = 1 << ta_log;
  float* ms = smem;                 // tg × kPad
  float* rs = smem + tg * kPad;     // kTileK × ta
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // tg · ta
  const int ty = tid >> ta_log;
  const int tx = tid & (ta - 1);
  const long long row0 = static_cast<long long>(blockIdx.x) * tg;
  const int col0 = blockIdx.y * ta;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(b, k_begin + k_per_split);

  float acc = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int kn = min(kTileK, k_end - k0);
    for (int i = tid; i < tg * kTileK; i += nthreads) {
      const int rr = i / kTileK, kk = i % kTileK;
      const long long gr = row0 + rr;
      float v = 0.0f;
      if (gr < g && kk < kn) {
        v = to_float(m[gr * b + k0 + kk]);
        if (MASK) v *= mask[k0 + kk];
      }
      ms[rr * kPad + kk] = v;
    }
    for (int i = tid; i < kTileK * ta; i += nthreads) {
      const int kk = i >> ta_log, cc = i & (ta - 1);
      const int gc = col0 + cc;
      rs[kk * ta + cc] =
          (kk < kn && gc < a) ? to_float(r[static_cast<long long>(k0 + kk) * a + gc]) : 0.0f;
    }
    __syncthreads();
    const float* mrow = ms + ty * kPad;
    if (kn == kTileK) {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) acc = fmaf(mrow[kk], rs[kk * ta + tx], acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) acc = fmaf(mrow[kk], rs[kk * ta + tx], acc);
    }
    __syncthreads();
  }
  const long long row = row0 + ty;
  const int col = col0 + tx;
  if (row < g && col < a) {
    float* o = out + row * a + col;
    if (atomic) {
      atomicAdd(o, acc);
    } else {
      *o = acc;
    }
  }
}

template <typename T>
cudaError_t run(const T* m, const T* r, const float* mask, float* out, int g, int b, int a,
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
  const bool atomic = splits > 1;
  if (mask != nullptr) {
    semiring_contract_kernel<T, true><<<grid, tg * ta, smem, stream>>>(
        m, r, mask, out, g, b, a, tg, ta_log, k_per_split, atomic);
  } else {
    semiring_contract_kernel<T, false><<<grid, tg * ta, smem, stream>>>(
        m, r, nullptr, out, g, b, a, tg, ta_log, k_per_split, atomic);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int semiring_contract(const void* m, const void* r, const void* mask, void* out,
                                 int g, int b, int a, int half, void* stream) {
  if (g <= 0 || b <= 0 || a <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* mk = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half) {
    return static_cast<int>(run<__half>(static_cast<const __half*>(m),
                                        static_cast<const __half*>(r), mk, o, g, b, a, s));
  }
  return static_cast<int>(run<float>(static_cast<const float*>(m),
                                     static_cast<const float*>(r), mk, o, g, b, a, s));
}

extern "C" const char* semiring_contract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
