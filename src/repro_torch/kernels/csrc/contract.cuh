// The dense-bag contraction on Hopper (sm_90a): one templated body for the
// two contract kernels, semiring_contract.cu and tropical_contract.cu.
//
//   out[g, a] = ⊕_b  M[g, b] ⊗ R[b, a]
//
// Sum:      ⊗ = · (with the σ mask: M[g, b]·mask[b]), ⊕ = +, from 0
// Tropical: ⊗ = +, ⊕ = min or max, from +inf or -inf
//
// M (G, B) and R (B, A) are any 2-D views with one unit-stride axis each
// (strides in struct Geom), float32, or float16 for the sum; out (G, A) is
// float32 row-major.  The kernel writes every output element: the caller
// allocates out with torch.empty.  A split launch also takes a float32
// workspace for its partials and zeroed int32 tickets, which the caller
// keeps per stream (launch.Kernel.scratch).  The launch geometry
// (regime, grid, block, shared memory, split of B) is computed in Python
// (repro_torch/kernels/launch.py::contract_geometry) and read here from a
// host array.
//
// Bound on an H100 SXM: the inputs are read once and the output written
// once, (G·B + B·A)·s + G·A·4 bytes (+ B·4 for the mask) at 3.35 TB/s,
// against G·B·A terms at the float32 rate (67 TFLOP/s for the FMA; an add
// and a min/max for the tropical term).  The dense path's products have
// A ≤ 8, at most 4 flops per byte, far below the float32 ridge of
// 67 / 3.35 = 20 flops per byte: they are memory bound.  Tensor cores are
// not used: at these shapes the card is bound by bytes, TF32 would break the
// bit-exactness on integer-valued data that the tests rely on, and (max, +)
// has no MMA form.
//
// The dense path's products are skinny, not square, so the geometry picks
// one of three regimes by shape:
//
// - tall (B ≤ 64, A ≤ 32; e.g. (100 000, 16) × (16, 1)): R (and the mask)
//   is staged once per block in shared memory; each thread takes one M row
//   (or 1, 4 or 8 of its A outputs), reads the row once with 16-byte loads
//   when the row is unit-stride, and writes its outputs directly, 16 bytes
//   at a time where A is a multiple of 4.  No split, no atomics, nothing
//   padded.
// - wide (G·A ≤ 1024; e.g. (16, 100 000) × (100 000, 8)): B is cut into
//   contiguous chunks, one per block, about two blocks per SM.  Each thread
//   owns a 4×4 register tile of the output and every lanes-th column of the
//   chunk, which it streams straight into registers, four columns in flight,
//   with 4-wide loads where M or R is contiguous along G or A.  Neighbouring
//   threads take neighbouring tiles when M is contiguous along G,
//   neighbouring columns when it is contiguous along B, so a warp's loads
//   fall on neighbouring addresses.  No shared-memory staging, no barrier in
//   the loop.  The block sums its lanes with a fixed xor-shuffle tree, then
//   its warps in order.  Up to 8 blocks form one cluster: block 0 sums
//   their partials in rank order straight from their shared memory (DSMEM)
//   and writes out, with no ticket.  More blocks run as clusters of one:
//   each writes its partial to the workspace, and the last to finish (a
//   ticket: __threadfence, then atomicAdd on the caller's counter, which
//   that block resets) sums them in block order.  Sums are therefore deterministic: the same inputs
//   give the same bits on every run.
// - tiled (everything else): an output tile of up to 256 threads, one
//   output each, B in 32-wide steps through shared memory; when the tiles
//   alone give fewer than 8 blocks per SM, B is split across blocks and the
//   partials merge as in the wide regime, in split order.
//
// Staging (tall, tiled) reads each operand along its unit-stride axis
// (coalesced, 16-byte vectors where the geometry found them aligned) and
// converts to float32.  Every regime reads with indices clamped into the
// real shape, so no padding value enters a result that is kept, and ±inf
// absent tuples of a tropical factor never meet an inf of the other sign.
//
// Kernels run on the caller's stream.  The workspace and tickets come from
// the caller, one set per stream, so launches on two streams never share a
// partial or a counter.

#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace contract {

namespace cg = cooperative_groups;

enum Regime { kTall = 0, kWide = 1, kTiled = 2 };

// Field order: launch.py::GEOM_FIELDS.
struct Geom {
  long long regime, g, b, a, smg, smb, srb, sra, half, m_vec, r_vec;
  long long grid_x, grid_y, grid_z, threads, smem, kt, chunk, p0, p1, cluster, lane_fast;
};

constexpr int kThreads = 256;
constexpr int kStageUnits = 8;   // 16-byte loads in flight per thread while staging
constexpr int kMergeUnroll = 32; // workspace loads in flight per thread while merging

// ---------------------------------------------------------------------------
// semirings
// ---------------------------------------------------------------------------

struct Sum {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float fma(float acc, float m, float r) {
    return fmaf(m, r, acc);
  }
  static __device__ __forceinline__ float add(float x, float y) { return x + y; }
};

template <bool IS_MIN>
struct Tropical {
  static __device__ __forceinline__ float zero() {
    return IS_MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
  }
  static __device__ __forceinline__ float add(float x, float y) {
    return IS_MIN ? fminf(x, y) : fmaxf(x, y);
  }
  static __device__ __forceinline__ float fma(float acc, float m, float r) {
    return add(acc, m + r);
  }
};

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Vec<__half> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __half* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Copy an nr × nc box of a matrix whose element (i, j) is src[i·ld + j]
// into shared memory at dst[i·di + j·dj] as float, scaled by row_scale[i]
// and col_scale[j] where given (the σ mask).  Units of V contiguous
// elements (V = 16 bytes when vec, else 1) go to the block's threads in
// turn, kStageUnits of them loaded before any is stored.
template <typename T, int V>
__device__ __forceinline__ void stage_units(const T* __restrict__ src, long long ld, int nr,
                                            int nc, float* dst, int di, int dj,
                                            const float* __restrict__ row_scale,
                                            const float* __restrict__ col_scale) {
  const int per_row = (nc + V - 1) / V;
  const int n = nr * per_row;
  for (int u0 = threadIdx.x; u0 < n; u0 += blockDim.x * kStageUnits) {
    float v[kStageUnits][V];
#pragma unroll
    for (int q = 0; q < kStageUnits; ++q) {
      const int u = u0 + q * blockDim.x;
      if (u < n) {
        const int i = u / per_row;
        const int j = (u - i * per_row) * V;
        const T* p = src + i * ld + j;
        if constexpr (V > 1) {
          if (j + V <= nc) {
            Vec<T>::load(p, v[q]);
            continue;
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) v[q][e] = j + e < nc ? to_float(p[e]) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kStageUnits; ++q) {
      const int u = u0 + q * blockDim.x;
      if (u < n) {
        const int i = u / per_row;
        const int j = (u - i * per_row) * V;
        const float rs = row_scale != nullptr ? row_scale[i] : 1.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (j + e < nc) {
            float x = v[q][e];
            if (row_scale != nullptr) x *= rs;
            if (col_scale != nullptr) x *= col_scale[j + e];
            dst[i * di + (j + e) * dj] = x;
          }
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld, int nr, int nc,
                                      bool vec, float* dst, int di, int dj,
                                      const float* __restrict__ row_scale,
                                      const float* __restrict__ col_scale) {
  if (vec) {
    stage_units<T, Vec<T>::kN>(src, ld, nr, nc, dst, di, dj, row_scale, col_scale);
  } else {
    stage_units<T, 1>(src, ld, nr, nc, dst, di, dj, row_scale, col_scale);
  }
}

// Stage M's rows [g0, g0 + ng) × columns [k0, k0 + nk) into ms[k·pm + g]
// (σ mask applied) and R's rows [k0, k0 + nk) × columns [a0, a0 + na) into
// rs[k·pr + a], each read along its unit-stride axis.
template <typename T>
__device__ __forceinline__ void stage_tiles(const T* __restrict__ m, const T* __restrict__ r,
                                            const float* __restrict__ mask, const Geom& q,
                                            long long g0, int ng, long long k0, int nk,
                                            long long a0, int na, float* ms, int pm, float* rs,
                                            int pr) {
  const float* mk = mask != nullptr ? mask + k0 : nullptr;
  if (q.smb == 1) {  // M along B: rows g, columns k
    stage<T>(m + g0 * q.smg + k0, q.smg, ng, nk, q.m_vec, ms, 1, pm, nullptr, mk);
  } else {           // M along G: rows k, columns g
    stage<T>(m + k0 * q.smb + g0, q.smb, nk, ng, q.m_vec, ms, pm, 1, mk, nullptr);
  }
  if (q.sra == 1) {  // R along A: rows k, columns a
    stage<T>(r + k0 * q.srb + a0, q.srb, nk, na, q.r_vec, rs, pr, 1, nullptr, nullptr);
  } else {           // R along B: rows a, columns k
    stage<T>(r + a0 * q.sra + k0, q.sra, na, nk, q.r_vec, rs, 1, pr, nullptr, nullptr);
  }
}

// True in the one block that arrives last of `parts` blocks sharing
// `*ticket`, after each has written its partial; that block resets the
// ticket for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket, unsigned int parts) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == parts - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ⊕ of ws[s·stride + o] over s = first, first + step, … < n, in that order.
template <class S>
__device__ __forceinline__ float merge_parts(const float* ws, long long stride, long long o,
                                             int first, int step, int n) {
  float acc = S::zero();
  for (int s0 = first; s0 < n; s0 += step * kMergeUnroll) {
    float v[kMergeUnroll];
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      const int s = s0 + u * step;
      v[u] = s < n ? __ldcg(ws + s * stride + o) : S::zero();
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) acc = S::add(acc, v[u]);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// tall: one M row per thread (TA outputs of it), R in shared memory
// ---------------------------------------------------------------------------

template <typename T, class S, int TA>
__global__ void __launch_bounds__(kThreads)
tall_kernel(const T* __restrict__ m, const T* __restrict__ r, const float* __restrict__ mask,
            float* __restrict__ out, Geom q) {
  extern __shared__ float smem[];
  constexpr int kStep = 16;
  const int b = static_cast<int>(q.b), a = static_cast<int>(q.a);
  const int groups = static_cast<int>(q.p1);
  float* rs = smem;          // b × a, rs[k·a + c]
  float* mks = smem + b * a; // b
  if (q.sra == 1) {
    stage<T>(r, q.srb, b, a, q.r_vec, rs, a, 1, nullptr, nullptr);
  } else {
    stage<T>(r, q.sra, a, b, q.r_vec, rs, 1, a, nullptr, nullptr);
  }
  if (mask != nullptr) {
    for (int k = threadIdx.x; k < b; k += blockDim.x) mks[k] = mask[k];
  }
  __syncthreads();
  const int rows = blockDim.x / groups;
  const int lr = threadIdx.x / groups;
  const long long row = static_cast<long long>(blockIdx.x) * rows + lr;
  if (lr >= rows || row >= q.g) return;
  const int c0 = (threadIdx.x - lr * groups) * TA;
  // A a multiple of 4 and this thread's TA outputs all inside A: rs rows and
  // out rows are 16-byte aligned, so R is read and out written 4-wide
  const bool full = a % 4 == 0 && c0 + TA <= a;
  int cols[TA];
#pragma unroll
  for (int j = 0; j < TA; ++j) cols[j] = min(c0 + j, a - 1);
  float acc[TA];
#pragma unroll
  for (int j = 0; j < TA; ++j) acc[j] = S::zero();
  constexpr int V = Vec<T>::kN;
  const bool along_b = q.smb == 1;
  const T* mrow = along_b ? m + row * q.smg : m + row;
  for (int k0 = 0; k0 < b; k0 += kStep) {
    float mv[kStep];
    if (along_b && q.m_vec) {
#pragma unroll
      for (int e = 0; e < kStep; e += V) {
        if (k0 + e + V <= b) {
          Vec<T>::load(mrow + k0 + e, mv + e);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            mv[e + i] = k0 + e + i < b ? to_float(mrow[k0 + e + i]) : 0.0f;
          }
        }
      }
    } else {
      const long long step = along_b ? 1 : q.smb;
#pragma unroll
      for (int e = 0; e < kStep; ++e) mv[e] = k0 + e < b ? to_float(mrow[(k0 + e) * step]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kStep; ++e) {
      const int k = k0 + e;
      if (k < b) {
        const float x = mask != nullptr ? mv[e] * mks[k] : mv[e];
        float rv[TA];
        bool wide_read = false;
        if constexpr (TA >= 4) {
          if (full) {  // whole groups of 4, aligned in rs: 16-byte reads
#pragma unroll
            for (int j = 0; j < TA; j += 4) {
              const float4 v = *reinterpret_cast<const float4*>(rs + k * a + c0 + j);
              rv[j] = v.x; rv[j + 1] = v.y; rv[j + 2] = v.z; rv[j + 3] = v.w;
            }
            wide_read = true;
          }
        }
        if (!wide_read) {
#pragma unroll
          for (int j = 0; j < TA; ++j) rv[j] = rs[k * a + cols[j]];
        }
#pragma unroll
        for (int j = 0; j < TA; ++j) acc[j] = S::fma(acc[j], x, rv[j]);
      }
    }
  }
  float* o = out + row * a + c0;
  if constexpr (TA >= 4) {
    if (full) {
#pragma unroll
      for (int j = 0; j < TA; j += 4) {
        *reinterpret_cast<float4*>(o + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < TA; ++j) {
    if (c0 + j < a) o[j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// wide: B in long chunks, one per block; a 4×4 output tile and every
// lanes-th column of the chunk per thread, streamed from device memory into
// registers; lanes summed by a fixed shuffle tree, partials merged by the
// last block
// ---------------------------------------------------------------------------

// Four values of one operand at rows idx[0..3] (clamped into the shape) of
// column k: one 4-wide load when the geometry found them contiguous and
// aligned, else four scalar loads.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, long long k, long long sk,
                                      long long si, const int* idx, bool vec, float* v) {
  const T* q = p + k * sk;
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(q + idx[0]));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(q + idx[0]));
      const __half2* h = reinterpret_cast<const __half2*>(&x);
      const float2 lo = __half22float2(h[0]), hi = __half22float2(h[1]);
      v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_float(__ldg(q + idx[i] * si));
  }
}

template <typename T, class S>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const T* __restrict__ m, const T* __restrict__ r, const float* __restrict__ mask,
            float* __restrict__ out, float* __restrict__ ws, unsigned int* tickets, Geom q) {
  extern __shared__ float smem[];
  constexpr int U = 4;  // columns in flight per thread
  const int g = static_cast<int>(q.g), a = static_cast<int>(q.a);
  const int tiles = static_cast<int>(q.p0), tpad = static_cast<int>(q.p1);
  const int lanes = blockDim.x / tpad;
  const int tid = threadIdx.x;
  // Neighbouring threads take neighbouring tiles (a warp reads neighbouring
  // rows of an M contiguous along G), or neighbouring lanes, so columns k
  // (a warp reads a run of an M contiguous along B).
  const bool lane_fast = q.lane_fast;
  const int tile = lane_fast ? tid / lanes : tid % tpad;
  const int lane = lane_fast ? tid % lanes : tid / tpad;
  const bool active = tile < tiles;
  const int tiles_a = (a + 3) / 4;
  const int t = active ? tile : 0;
  const int g0 = (t / tiles_a) * 4, a0 = (t % tiles_a) * 4;
  int rows[4], cols[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = min(g0 + i, g - 1);
    cols[i] = min(a0 + i, a - 1);
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = S::zero();
  }
  const long long kb = static_cast<long long>(blockIdx.x) * q.chunk;
  const long long ke = min(q.b, kb + q.chunk);
  const bool m_vec = q.m_vec, r_vec = q.r_vec;
  if (active) {
    for (long long k0 = kb + lane; k0 < ke; k0 += U * lanes) {
      float mv[U][4], rv[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long k = k0 + u * lanes;
        if (k < ke) {
          load4<T>(m, k, q.smb, q.smg, rows, m_vec, mv[u]);
          load4<T>(r, k, q.srb, q.sra, cols, r_vec, rv[u]);
          if (mask != nullptr) {
            const float s = __ldg(mask + k);
#pragma unroll
            for (int i = 0; i < 4; ++i) mv[u][i] *= s;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u * lanes < ke) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = S::fma(acc[i][j], mv[u][i], rv[u][j]);
          }
        }
      }
    }
  }
  // lanes inside a warp: a fixed xor tree over the lane bits of the thread
  // index; then the warps' sums in warp order
  const int per_warp = lane_fast ? min(lanes, 32) : (tpad < 32 ? 32 / tpad : 1);
  const int off_hi = lane_fast ? per_warp / 2 : 16, off_lo = lane_fast ? 1 : tpad;
  for (int off = off_hi; off >= off_lo; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = S::add(acc[i][j], __shfl_xor_sync(0xffffffffu, acc[i][j], off));
      }
    }
  }
  const int groups = lanes / per_warp;
  float* red = smem;  // groups × tpad × 16
  if (lane % per_warp == 0) {
    float* dst = red + ((lane / per_warp) * tpad + tile) * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[i * 4 + j] = acc[i][j];
    }
  }
  __syncthreads();
  // the block's partial, then the cluster's: rank 0 sums its cluster's
  // partials from their shared memory (DSMEM) in rank order, so in chunk
  // order; the other blocks wait until it has read them
  const int n_out = g * a;
  float* bpart = smem + groups * tpad * 16;  // n_out
  for (int o = tid; o < n_out; o += blockDim.x) {
    const int gg = o / a, aa = o - gg * a;
    const int tt = (gg / 4) * tiles_a + aa / 4, e = (gg % 4) * 4 + aa % 4;
    float v = red[tt * 16 + e];
    for (int l = 1; l < groups; ++l) v = S::add(v, red[(l * tpad + tt) * 16 + e]);
    bpart[o] = v;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned clusters = gridDim.x / csize;
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* dst = clusters > 1 ? ws + static_cast<long long>(blockIdx.x / csize) * n_out : out;
    for (int o = tid; o < n_out; o += blockDim.x) {
      float v = bpart[o];
      for (unsigned rk = 1; rk < csize; ++rk) v = S::add(v, cluster.map_shared_rank(bpart, rk)[o]);
      dst[o] = v;
    }
  }
  cluster.sync();
  if (cluster.block_rank() != 0 || clusters == 1) return;
  if (!last_to_arrive(tickets, clusters)) return;
  // the last cluster: every output's partials in cluster order, in `parts`
  // interleaved runs per output, then the runs in order
  const int parts = max(1, static_cast<int>(blockDim.x) / n_out);
  float* runs = smem;  // parts × n_out
  for (int idx = tid; idx < parts * n_out; idx += blockDim.x) {
    const int pp = idx / n_out, o = idx - pp * n_out;
    runs[idx] = merge_parts<S>(ws, n_out, o, pp, parts, clusters);
  }
  __syncthreads();
  for (int o = tid; o < n_out; o += blockDim.x) {
    float v = runs[o];
    for (int pp = 1; pp < parts; ++pp) v = S::add(v, runs[pp * n_out + o]);
    out[o] = v;
  }
}

// ---------------------------------------------------------------------------
// tiled: a TG × TA output tile, one output per thread, B in 32-wide steps,
// split across blocks (grid z) when the tiles are few
// ---------------------------------------------------------------------------

template <typename T, class S>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ m, const T* __restrict__ r, const float* __restrict__ mask,
             float* __restrict__ out, float* __restrict__ ws, unsigned int* tickets, Geom q) {
  extern __shared__ float smem[];
  const int tg = static_cast<int>(q.p0), ta = static_cast<int>(q.p1);
  const int kt = static_cast<int>(q.kt);
  const int pm = tg + 1, pr = ta + 1;
  float* ms = smem;           // kt × pm
  float* rs = smem + kt * pm; // kt × pr
  const int ty = threadIdx.x / ta, tx = threadIdx.x - ty * ta;
  const long long row0 = static_cast<long long>(blockIdx.x) * tg;
  const long long col0 = static_cast<long long>(blockIdx.y) * ta;
  const int ng = static_cast<int>(min(static_cast<long long>(tg), q.g - row0));
  const int na = static_cast<int>(min(static_cast<long long>(ta), q.a - col0));
  const int rc = min(ty, ng - 1), cc = min(tx, na - 1);
  const long long kb = static_cast<long long>(blockIdx.z) * q.chunk;
  const long long ke = min(q.b, kb + q.chunk);
  float acc = S::zero();
  for (long long k0 = kb; k0 < ke; k0 += kt) {
    const int nk = static_cast<int>(min(static_cast<long long>(kt), ke - k0));
    stage_tiles<T>(m, r, mask, q, row0, ng, k0, nk, col0, na, ms, pm, rs, pr);
    __syncthreads();
    for (int k = 0; k < nk; ++k) acc = S::fma(acc, ms[k * pm + rc], rs[k * pr + cc]);
    __syncthreads();
  }
  const bool mine = ty < ng && tx < na;
  const long long o = (row0 + ty) * q.a + col0 + tx;
  if (gridDim.z == 1) {
    if (mine) out[o] = acc;
    return;
  }
  const long long n_out = q.g * q.a;
  if (mine) ws[blockIdx.z * n_out + o] = acc;
  if (!last_to_arrive(tickets + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z)) return;
  if (mine) out[o] = merge_parts<S>(ws, n_out, o, 0, 1, gridDim.z);
}

// ---------------------------------------------------------------------------
// host: launch the regime the geometry names
// ---------------------------------------------------------------------------

template <typename T, class S>
cudaError_t launch(const void* m, const void* r, const float* mask, float* out, float* ws,
                   unsigned int* tickets, const Geom& q, cudaStream_t stream) {
  const T* mm = static_cast<const T*>(m);
  const T* rr = static_cast<const T*>(r);
  const dim3 grid(static_cast<unsigned>(q.grid_x), static_cast<unsigned>(q.grid_y),
                  static_cast<unsigned>(q.grid_z));
  const unsigned threads = static_cast<unsigned>(q.threads);
  const size_t smem = static_cast<size_t>(q.smem);
  switch (q.regime) {
    case kTall:
      if (q.p0 == 1) {
        tall_kernel<T, S, 1><<<grid, threads, smem, stream>>>(mm, rr, mask, out, q);
      } else if (q.p0 == 4) {
        tall_kernel<T, S, 4><<<grid, threads, smem, stream>>>(mm, rr, mask, out, q);
      } else {
        tall_kernel<T, S, 8><<<grid, threads, smem, stream>>>(mm, rr, mask, out, q);
      }
      break;
    case kWide: {  // clusters of q.cluster consecutive blocks
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = static_cast<unsigned>(q.cluster);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaLaunchKernelEx(&cfg, wide_kernel<T, S>, mm, rr, mask, out, ws, tickets,
                                                 q);
      if (err != cudaSuccess) return err;
      break;
    }
    case kTiled:
      tiled_kernel<T, S><<<grid, threads, smem, stream>>>(mm, rr, mask, out, ws, tickets, q);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The checks a C entry point makes before it launches.
inline bool geometry_ok(const Geom* q, const void* ws, const void* tickets) {
  if (q == nullptr || q->g <= 0 || q->b <= 0 || q->a <= 0) return false;
  if (q->threads <= 0 || q->threads > kThreads || q->smem > 48 * 1024) return false;
  if (q->regime == kWide && (q->cluster < 1 || q->cluster > 8 || q->grid_x % q->cluster != 0)) {
    return false;
  }
  const bool split = (q->regime == kWide && q->grid_x > q->cluster) ||
                     (q->regime == kTiled && q->grid_z > 1);
  if (split && (ws == nullptr || tickets == nullptr)) return false;
  return true;
}

}  // namespace contract
