// Segment ⊕-aggregation on Hopper (sm_90a): the device code shared by the
// single-reduction kernel (segment_aggregate.cu) and the level kernel
// (level_segment_aggregate.cu).
//
//   out[g, c] = ⊕_{r : codes[r] == g} values[r, c]     ⊕ ∈ {sum, min, max}
//
// The TPU kernels this replaces (src/repro/kernels/segment_aggregate/
// kernel.py) build a one-hot (rows × groups) matrix and contract it on the
// matrix unit, row tiles in row order into a resident output tile, so a
// message's float sum there is a fixed function of its own rows.  Here the
// reduction is one pass over the rows, with no float atomics, and keeps that
// property.
//
// One launch reduces a table of messages ("members", struct Member, passed
// by value): each has its own codes (N_j,) int32, values (N_j, V_j) float32
// row-major and out (G_j, V_j) float32 pre-filled with the ⊕-identity, and
// its own partition of the grid's blocks.  Every member's regime and
// partition are chosen in Python (repro_torch/kernels/launch.py::
// segment_geometry) from its (N_j, G_j, V_j) alone: never from the card, the
// stream or the other members.  Each regime present runs as its own grid
// (so each has the registers and shared memory it needs), then a merge grid
// combines the block partials of the thread and warp regimes.
//
// The contract for sum.  out[g, c] is the float32 sum of the member's rows
// with code g in an order fixed by the member's (codes, values) alone, so
// its bits are the same across launches, streams and graph replays, on any
// SM count, and whether the message goes alone or as member j of a level
// launch with any other members.  A sort-regime member whose values arrive
// in code order (grid kSortOrdered: row i of values is row perm[i] of the
// message, perm its stable row order) gives the same bits as the same
// message read through its row order (kSort).  The order, by regime (B is
// the member's block count, a function of N, G and V):
//
// - thread (G ≤ 96).  Columns are cut into tiles of at most 256, each run
//   by B blocks; every thread keeps a private copy of the G cells of one
//   column in shared memory ([code][thread]).  One column: thread t of block
//   b takes the 4-row quads b·256 + t + k·B·256, k = 0, 1, …, in order, a
//   quad's rows in order; a code's 256 copies combine in a fixed order (lane
//   l of a warp takes threads l, l + 32, …, l + 224, then a fixed
//   xor-shuffle tree over the lanes).  Several columns: thread t owns column
//   t % p (p the power of two ≥ the tile's columns) and takes row t / p of
//   the 256 / p-row groups b + k·B in order; the copies of one column
//   combine in thread order.
// - warp (G > 96, G·V ≤ 1472, so V < 16).  B blocks, each with a private
//   copy of the cells per warp in shared memory.  A batch is 32 / p rows × p
//   columns (p the power of two ≥ V), lane l on row l / p and column l % p;
//   warp w of block b takes the batches b·8 + w + k·B·8, k = 0, 1, …, in
//   order (the next 8 batches load while these are added).  Within a
//   batch a cell's elements are added in lane order: the
//   lanes on column 0 set their bit in a per-warp tag of their row's code,
//   so each lane reads its peers (the lanes of its column whose row has its
//   code) and its rank among them; round r adds every element of rank r,
//   one per cell, so no two lanes of a round share a cell.  The rounds are
//   as many as the batch's largest peer group (1 when its codes differ).
//   The 8 copies combine in warp order.
// - sort (every other message): segment-major, as the TPU kernel reduces.
//   A stable order of the rows by code (a permutation, built once per codes
//   tensor in Python and cached: ops.py::row_order) cuts each segment's rows
//   into pieces of `chunk` rows; a warp reduces one piece, lane (r, c)
//   taking rows r, r + R, … of its columns in row order (one column, or four
//   when V is a multiple of 4; R = 32 / the lanes a row needs, a power of
//   two), then a fixed xor-shuffle tree over the lanes of one column.  A
//   member reads row perm[i] of its values for position i of the order, or
//   row i itself when its values arrive in code order (the plan layer
//   permutes its rowwise inputs once per cached order: core/plans.py), so
//   the two forms add the same values in the same order.  The two forms run
//   as two grids (kSort, kSortOrdered), each with the registers its loads
//   need.
//
// Two value sources.  A slab member reads its values from (N, V) `values`.
// A fused member (values null; it runs in grid kFused + its regime's grid)
// computes each value from its rowwise recipe (struct Recipe, the j-th of
// the launch's fused members in a second by-value parameter) as the plan
// layer's rowwise stage would have written it (core/plans.py): row r's
// value at lane c is
//
//   (((lift[r] ⊗ T_1[i_1[r], col_1[c]]) ⊗ T_2[i_2[r], col_2[c]]) ⊗ …)
//
// the messages' ⊗ (× or +) in step order, a broadcast message reading its
// table's row 0, then 0̄ (the ⊕-identity) where a σ predicate fails
// (mask_p[codes_p[r]] == 0).  Each ⊗ is __fmul_rn / __fadd_rn, so no
// product is contracted with the ⊕ into an FMA: the value has the bits of
// the slab's element.  It enters the regime's ⊕ loop where the slab's
// element would, in the same order (the loops' unroll moves only when loads
// are issued), so a fused member's output has the bits of the same member
// reduced from the slab that the rowwise stage writes.  A fused sort member
// in code order has its recipe's row columns (lift, indices, σ codes) in
// code order, as the slab would be.  In the thread regime with several
// columns every thread of a block reads the same rows, so the block stages
// them (a row per thread: code, lift, σ verdict and table rows, in shared
// memory) and its threads read their table entries at the staged rows.
//
// A thread or warp member of more than one block writes each block's
// partials to the workspace, and so does a sort member for each piece of a
// segment of more than one piece.  The merge grid then combines them, one
// warp per cell (thread, warp: over the blocks in block order) or per
// (split segment, column) (sort: over the pieces in piece order): lane l
// takes the partials l, l + 32, … in order, then a fixed xor-shuffle tree.
// Sums of integer-valued floats below 2^24 are exact in any order.  min and
// max take the same paths (they are exact in any order).  A code outside
// [0, G) matches nothing: the concatenated level operands of
// level_segment_aggregate carry -1 on pad rows.  The workspace comes from
// the caller, one per stream (launch.Kernel.scratch).
//
// Bound: memory.  Each member reads N·4 bytes of codes and N·V·4 bytes of
// values and writes G·V·4 bytes, so on an H100 (3.35 TB/s) it takes at least
// (N·(4 + 4V) + G·V·4) / 3.35e12 seconds.  The sort regime reads the
// permutation instead of the codes and gathers each row's values through it
// (at V = 1 a 4-byte value can cost a 32-byte sector); in code order it
// reads the values in place and neither codes nor permutation.  The warp
// regime's shared-memory traffic (a tag and a cell per element, at random
// banks) is what it spends beyond the bytes.  A fused member reads no
// values: N·4·(2 + K + P) bytes of codes, lift, K gather indices and P σ
// codes (a broadcast message has none), its tables and masks (small: they
// stay in L1 and L2), and writes G·V·4; it does N·V·(K + 1) FP32
// operations (K ⊗ and one ⊕ an element), so past a few lanes it is bound by
// those and by the loads of each element's table entries, not by the bytes
// (2^23 rows, V = 624, K = 2: 15.7 G operations, 0.47 ms at 33.5 T/s,
// against 0.06 ms of bytes at 3.35 TB/s).

#pragma once

#include <cuda_runtime.h>

namespace segagg {

enum Op { kSum = 0, kMin = 1, kMax = 2 };
// grids 0-3 take slab members by regime, grids kFused + 0-3 fused members
enum Regime { kThread = 0, kWarp = 1, kSort = 2, kSortOrdered = 3, kFused = 4, kMerge = 8 };
constexpr int kGrids = 9;          // the regimes' grids, then the merge grid

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 46 * 1024;  // dynamic shared memory of one block
constexpr int kBigSmemMax = 96 * 1024;  // ... of a thread or warp block (opted in past 48 KiB)
constexpr int kMaxMembers = 40;     // the member table stays under 4 KiB of kernel parameters
constexpr int kQuads = 2;           // thread regime, one column: 4-row quads in flight per thread
constexpr int kUnroll = 4;          // loads in flight per thread before they are ⊕-ed in order
constexpr int kWarpUnroll = 8;      // ... in the warp regime (the next ones load meanwhile)
constexpr int kSortUnroll = 8;      // ... in the sort regime
constexpr int kFusedUnroll = 4;     // ... in the sort regime, for fused members
constexpr int kMaxMsgs = 3;         // recipe: gathered messages (a star's three dimensions)
constexpr int kMaxPreds = 3;        // recipe: σ predicates
constexpr int kItemFields = 5;      // sort work item: segment, begin, end, slot, split
constexpr int kSplitFields = 3;     // sort split segment: first slot, pieces, segment
constexpr unsigned kFull = 0xffffffffu;

// field order of class SegMember in repro_torch/kernels/launch.py
struct Member {
  const int* index;      // codes (thread, warp), the row order's permutation (sort), or null
                         // (sort in code order)
  const float* values;   // (n, v) row-major; in the row order's order (sort in code order)
  float* out;            // (g, v) row-major, filled with the ⊕-identity
  const int* items;      // sort: n_items work items, then a (first slot, pieces, segment)
                         // triple per split segment
  long long n;           // rows
  long long chunk;       // rows per block, about (thread, warp) or per piece (sort)
  long long ws;          // offset of the member's partials in the workspace, in floats
  int g, v;
  int regime;            // its grid: the regime, plus kFused for a fused member
  int vt, tiles;         // column tile (thread; warp and sort: v and 1)
  int blocks;            // blocks per tile (thread, warp) or blocks of 8 items (sort)
  int first_block;       // the member's first block in its regime's grid
  int aux;               // its first warp in the merge grid
  int n_items;           // sort: work items
  int n_splits;          // sort: segments of more than one piece
};

// Members are grouped by grid (the regime, the sort regime by form, slab
// members first); per grid (and for the merge grid, whose members are all of
// them) the index of its first member, its member count, grid and dynamic
// shared memory.
struct Table {
  int count;
  int pad;
  int first[kGrids];
  int members[kGrids];
  int grid[kGrids];
  int smem[kGrids];
  Member m[kMaxMembers];
};

// field order of class SegRecipe in repro_torch/kernels/launch.py
struct Recipe {
  const float* lift;                    // (n,) the lift leaf
  const int* idx[kMaxMsgs];             // (n,) row of message k's table, or null: row 0
  const float* tab[kMaxMsgs];           // message k, (rows, cols[k]) row-major
  const int* lane_col[kMaxMsgs];        // (v,) the column of message k that lane c reads
  const int* codes[kMaxPreds];          // (n,) σ predicate p's codes
  const unsigned char* mask[kMaxPreds]; // its domain mask, a byte an entry
  int cols[kMaxMsgs];
  int msgs, preds;
  int add;                              // ⊗: 0 ×, 1 +
  int pad;
};

// The recipes of a launch's fused members, in member order: member j of the
// table (j ≥ first[kFused + kThread]) has recipe j - first[kFused + kThread].
// With the table a fused grid's parameters pass 4 KiB (CUDA 12.1 and later
// take up to 32,764 bytes).
struct Recipes {
  Recipe r[kMaxMembers];
};

__host__ __device__ constexpr int base_regime(int grid) { return grid % kFused; }

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kSum) return 0.0f;
  if (OP == kMin) return __int_as_float(0x7f800000);  // +inf
  return __int_as_float(0xff800000);                  // -inf
}

template <int OP>
__device__ __forceinline__ float combine(float a, float x) {
  if (OP == kSum) return a + x;
  if (OP == kMin) return x < a ? x : a;
  return x > a ? x : a;
}

// ⊕ of every lane's x by a fixed xor tree over lane bits [lo, 32): every
// lane of one class mod lo ends with the same bits (a + b == b + a).
template <int OP>
__device__ __forceinline__ float xor_tree(float x, int lo) {
  for (int off = lo; off < 32; off <<= 1) x = combine<OP>(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// the value source: a slab member's values, or a fused member's recipe
// ---------------------------------------------------------------------------

// A lane's part of a recipe value: the column of each message's table it reads.
struct Lane {
  int col[kMaxMsgs];
};

__device__ __forceinline__ Lane recipe_lane(const Recipe& rc, int c) {
  Lane l;
#pragma unroll
  for (int k = 0; k < kMaxMsgs; ++k) l.col[k] = k < rc.msgs ? __ldg(rc.lane_col[k] + c) : 0;
  return l;
}

// A row's part: its lift, the offset of its row in each message's table
// (index · cols; 0 for a broadcast message and past msgs) and the σ verdict.
// Tables hold fewer than 2^31 elements (ops.py checks).
struct Row {
  float lift;
  bool pass;
  int at[kMaxMsgs];
};

__device__ __forceinline__ Row recipe_row(const Recipe& rc, long long row) {
  Row w;
  w.lift = __ldg(rc.lift + row);
#pragma unroll
  for (int k = 0; k < kMaxMsgs; ++k) {
    w.at[k] = k < rc.msgs && rc.idx[k] != nullptr ? __ldg(rc.idx[k] + row) * rc.cols[k] : 0;
  }
  bool pass = true;
#pragma unroll
  for (int p = 0; p < kMaxPreds; ++p) {
    if (p < rc.preds) pass = pass && __ldg(rc.mask[p] + __ldg(rc.codes[p] + row)) != 0;
  }
  w.pass = pass;
  return w;
}

// The value of row `w` at lane `l`: the messages' ⊗ in step order, rounded
// to nearest one by one, then 0̄ where σ fails.
template <int OP>
__device__ __forceinline__ float recipe_value(const Recipe& rc, const Row& w, const Lane& l) {
  float x = w.lift;
#pragma unroll
  for (int k = 0; k < kMaxMsgs; ++k) {
    if (k < rc.msgs) {
      const float y = __ldg(rc.tab[k] + w.at[k] + l.col[k]);
      x = rc.add ? __fadd_rn(x, y) : __fmul_rn(x, y);
    }
  }
  return w.pass ? x : identity<OP>();
}

// Row `row`'s value at column `c` (lane `l` of the recipe) of the member's
// source.
template <int OP, bool FUSED>
__device__ __forceinline__ float member_value(const Member& m, const Recipe* rc, const Lane& l,
                                              long long row, int c) {
  if constexpr (FUSED) {
    return recipe_value<OP>(*rc, recipe_row(*rc, row), l);
  } else {
    return __ldg(m.values + row * m.v + c);
  }
}

template <bool FUSED>
__device__ __forceinline__ Lane member_lane(const Recipe* rc, int c) {
  if constexpr (FUSED) {
    return recipe_lane(*rc, c);
  } else {
    return Lane{};
  }
}

// ---------------------------------------------------------------------------
// thread and warp: a block's partial per cell; the merge grid combines them
// ---------------------------------------------------------------------------

// out cell of tile-local cell `cell` (row-major over g × vt), or -1 for a
// column past v in the last tile (warp and sort: one tile of all columns).
__device__ __forceinline__ long long out_cell(const Member& m, int tile, int cell) {
  const int c = tile * m.vt + cell % m.vt;
  if (c >= m.v) return -1;
  return static_cast<long long>(cell / m.vt) * m.v + c;
}

// Warp-regime block `b` has its partial of cell `cell` at part[cell].  One
// block: write out.  Else: the workspace, cell-major ([cell][block]), for
// the merge grid.
__device__ __forceinline__ void finish_block(const Member& m, int b, int cells, float* ws,
                                             const float* part) {
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
    if (m.blocks == 1) {
      m.out[cell] = part[cell];
    } else {
      ws[m.ws + static_cast<long long>(cell) * m.blocks + b] = part[cell];
    }
  }
}

// thread, several columns: thread t owns column t % p of the tile (p the
// power of two ≥ its columns) and takes row t / p of the 256 / p-row groups
// b + k·B, k = 0, 1, …, in order; then the copies of threads col, col + p, …
// of one code combine in that order into acc[code · 256 + col].
template <int OP>
__device__ __forceinline__ void thread_columns(const Member& m, int b, float* acc, int vh, int c0) {
  const int t = threadIdx.x, g = m.g, v = m.v;
  int p = 1;
  while (p < vh) p <<= 1;
  const int rows = kThreads / p;
  const int col = t % p, rsub = t / p;
  const long long groups = (m.n + rows - 1) / rows;
  if (col < vh) {
    for (long long r0 = b; r0 < groups; r0 += static_cast<long long>(m.blocks) * kUnroll) {
      int code[kUnroll];
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = (r0 + u * static_cast<long long>(m.blocks)) * rows + rsub;
        code[u] = -1;
        x[u] = 0.0f;
        if (row < m.n) {
          code[u] = __ldg(m.index + row);
          x[u] = __ldg(m.values + row * v + c0 + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (code[u] >= 0 && code[u] < g) {
          float* a = acc + code[u] * kThreads + t;
          *a = combine<OP>(*a, x[u]);
        }
      }
    }
  }
  __syncthreads();
  for (int cell = t; cell < g * p; cell += kThreads) {
    float* a = acc + (cell / p) * kThreads;
    const int c = cell % p;
    float s = a[c];
    for (int k = 1; k < rows; ++k) s = combine<OP>(s, a[c + k * p]);
    a[c] = s;
  }
}

// thread, several columns, fused: every thread of a block reads the same
// rows (its groups b + k·B, in order), so the block stages them p groups at
// a time, a row per thread: its code (plus kFailed where σ fails), its lift
// and each message's table row.  Then each thread adds its column of the
// staged rows in the order above, reading its table entries at the staged
// rows.
constexpr int kFailed = 128;   // > the thread regime's G

// Thread t's column of the p staged groups (a row each: slot jj · rows +
// rsub), MSGS messages and ⊗ = + (ADD) or × fixed, so nothing is tested per
// element but the row's code.
template <int OP, int MSGS, bool ADD>
__device__ __forceinline__ void add_staged(const int4* stage, const int* stage_row2,
                                           const float* const (&at)[kMaxMsgs], float* acc,
                                           int p, int rows, int rsub) {
  const int t = threadIdx.x;
#pragma unroll 4
  for (int jj = 0; jj < p; ++jj) {
    const int slot = jj * rows + rsub;
    const int4 e = stage[slot];
    if (e.x >= 0) {
      float x = __int_as_float(e.y);
      const int row[kMaxMsgs] = {e.z, e.w, MSGS > 2 ? stage_row2[slot] : 0};
#pragma unroll
      for (int k = 0; k < MSGS; ++k) {
        const float y = __ldg(at[k] + row[k]);
        x = ADD ? __fadd_rn(x, y) : __fmul_rn(x, y);
      }
      int code = e.x;
      if (code >= kFailed) {
        code -= kFailed;
        x = identity<OP>();
      }
      float* a = acc + code * kThreads + t;
      *a = combine<OP>(*a, x);
    }
  }
}

template <int OP>
__device__ __forceinline__ void thread_columns_fused(const Member& m, const Recipe& rc, int b,
                                                     float* acc, int vh, int c0) {
  __shared__ int4 stage[kThreads];             // code, lift, table rows 0 and 1
  __shared__ int stage_row2[kThreads];         // table row 2
  const int t = threadIdx.x, g = m.g;
  int p = 1;
  while (p < vh) p <<= 1;
  const int rows = kThreads / p;
  const int col = t % p, rsub = t / p;
  const long long groups = (m.n + rows - 1) / rows;
  const long long stride = m.blocks;
  const int msgs = rc.msgs;
  const bool add = rc.add != 0;
  const float* at[kMaxMsgs];   // this thread's column of each table's row 0
#pragma unroll
  for (int k = 0; k < kMaxMsgs; ++k) {
    at[k] = k < msgs && col < vh ? rc.tab[k] + __ldg(rc.lane_col[k] + c0 + col) : nullptr;
  }
  for (long long j0 = 0; b + j0 * stride < groups; j0 += p) {
    {  // slot t: row t % rows of group j0 + t / rows
      const long long grp = b + (j0 + t / rows) * stride;
      const long long row = grp * rows + t % rows;
      int code = -1;
      int4 e = make_int4(-1, 0, 0, 0);
      int row2 = 0;
      if (grp < groups && row < m.n) code = __ldg(m.index + row);
      if (code >= 0 && code < g) {
        const Row w = recipe_row(rc, row);
        e = make_int4(w.pass ? code : code + kFailed, __float_as_int(w.lift), w.at[0], w.at[1]);
        row2 = w.at[2];
      }
      stage[t] = e;
      stage_row2[t] = row2;
    }
    __syncthreads();
    if (col < vh) {  // several lanes need a message (recipe_ok), so msgs ≥ 1
      switch (msgs * 2 + add) {
        case 2: add_staged<OP, 1, false>(stage, stage_row2, at, acc, p, rows, rsub); break;
        case 3: add_staged<OP, 1, true>(stage, stage_row2, at, acc, p, rows, rsub); break;
        case 4: add_staged<OP, 2, false>(stage, stage_row2, at, acc, p, rows, rsub); break;
        case 5: add_staged<OP, 2, true>(stage, stage_row2, at, acc, p, rows, rsub); break;
        case 6: add_staged<OP, 3, false>(stage, stage_row2, at, acc, p, rows, rsub); break;
        default: add_staged<OP, 3, true>(stage, stage_row2, at, acc, p, rows, rsub); break;
      }
    }
    __syncthreads();
  }
  for (int cell = t; cell < g * p; cell += kThreads) {
    float* a = acc + (cell / p) * kThreads;
    const int c = cell % p;
    float s = a[c];
    for (int k = 1; k < rows; ++k) s = combine<OP>(s, a[c + k * p]);
    a[c] = s;
  }
}

// thread: a private copy of the tile's G cells of its column per thread, in
// shared memory as [code][thread] (no bank conflicts).
template <int OP, bool FUSED>
__device__ void thread_block(const Member& m, const Recipe* rc, int bt, float* ws) {
  extern __shared__ float acc[];
  const int tile = bt / m.blocks, b = bt % m.blocks;
  const int g = m.g, v = m.v, vt = m.vt;
  const int c0 = tile * vt;
  const int vh = v - c0 < vt ? v - c0 : vt;   // columns of this tile
  const int t = threadIdx.x;
  for (int k = 0; k < g; ++k) acc[k * kThreads + t] = identity<OP>();
  if (vh == 1) {
    // one column: thread t of block b takes the 4-row quads b·256 + t + k·B·256
    // in order, a quad's rows in order (one 16-byte load each of codes and
    // values where the addresses allow: the order is the same either way)
    const long long stride = static_cast<long long>(m.blocks) * kThreads;
    const bool vec = !FUSED && v == 1 &&
                     ((reinterpret_cast<unsigned long long>(m.index) |
                       reinterpret_cast<unsigned long long>(m.values)) & 15) == 0;
    const Lane lc = member_lane<FUSED>(rc, c0);
    const long long quads = (m.n + 3) / 4;
    for (long long q = static_cast<long long>(b) * kThreads + t; q < quads; q += stride * kQuads) {
      int code[kQuads][4];
      float x[kQuads][4];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const long long row = 4 * (q + u * stride);
        if (vec && row + 3 < m.n) {
          const int4 cq = __ldg(reinterpret_cast<const int4*>(m.index + row));
          const float4 xq = __ldg(reinterpret_cast<const float4*>(m.values + row));
          code[u][0] = cq.x, code[u][1] = cq.y, code[u][2] = cq.z, code[u][3] = cq.w;
          x[u][0] = xq.x, x[u][1] = xq.y, x[u][2] = xq.z, x[u][3] = xq.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = row + i < m.n;
            code[u][i] = in ? __ldg(m.index + row + i) : -1;
            x[u][i] = in ? member_value<OP, FUSED>(m, rc, lc, row + i, c0) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (code[u][i] >= 0 && code[u][i] < g) {
            float* a = acc + code[u][i] * kThreads + t;
            *a = combine<OP>(*a, x[u][i]);
          }
        }
      }
    }
    __syncthreads();
    // a code's 256 copies: lane l takes threads l, l + 32, … in order, then
    // a fixed xor tree; lane 0 leaves the block's partial in acc[code · 256]
    const int warp = t >> 5, lane = t & 31;
    for (int k = warp; k < g; k += kWarps) {
      float s = identity<OP>();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = combine<OP>(s, acc[k * kThreads + lane + 32 * w]);
      s = xor_tree<OP>(s, 1);
      __syncwarp();
      if (lane == 0) acc[k * kThreads] = s;
    }
  } else {
    if constexpr (FUSED) {
      thread_columns_fused<OP>(m, *rc, b, acc, vh, c0);
    } else {
      thread_columns<OP>(m, b, acc, vh, c0);
    }
  }
  __syncthreads();
  // the block's partial of cell (code, c) is at acc[code · 256 + c]; the
  // tile's cells are row-major over g × vt
  float* w = m.blocks == 1 ? nullptr : ws + m.ws + static_cast<long long>(tile) * g * vt * m.blocks;
  for (int cell = t; cell < g * vt; cell += kThreads) {
    const int code = cell / vt, c = cell % vt;
    if (c >= vh) continue;
    const float s = acc[code * kThreads + c];
    if (w == nullptr) {
      m.out[static_cast<long long>(code) * v + c0 + c] = s;
    } else {
      w[static_cast<long long>(cell) * m.blocks + b] = s;
    }
  }
}

// warp: a private copy of the G·V cells per warp, and a lane mask per code
// (`tag`).  A batch's elements of one cell are added in lane order by
// rounds: round r adds each lane whose rank among its peers is r.
template <int OP, bool FUSED>
__device__ void warp_block(const Member& m, const Recipe* rc, int b, float* ws) {
  extern __shared__ float copies[];
  const int g = m.g, v = m.v;
  const int cells = g * v;
  unsigned* tags = reinterpret_cast<unsigned*>(copies + kWarps * cells);
  for (int i = threadIdx.x; i < kWarps * cells; i += kThreads) copies[i] = identity<OP>();
  for (int i = threadIdx.x; i < kWarps * g; i += kThreads) tags[i] = 0u;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = copies + warp * cells;
  unsigned* tag = tags + warp * g;
  int p = 1;
  while (p < v) p <<= 1;                       // V ≤ 1472 / 97 < 32
  const int rows = 32 / p;                     // rows per batch
  const int rsub = lane / p, col = lane % p;
  const unsigned lower = (1u << lane) - 1u;    // the lanes before this one
  const long long groups = (m.n + rows - 1) / rows;
  const Lane lc = member_lane<FUSED>(rc, col < v ? col : 0);
  const long long tw = static_cast<long long>(m.blocks) * kWarps;
  const long long step = tw * kWarpUnroll;
  // code (-1: no element: past the rows, past V or outside [0, G)) and value
  // of the kWarpUnroll batches in hand; the next ones load while these are added
  int code[kWarpUnroll], next_code[kWarpUnroll];
  float x[kWarpUnroll], next_x[kWarpUnroll];
  auto load = [&](long long first, int (&c)[kWarpUnroll], float (&y)[kWarpUnroll]) {
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const long long row = (first + u * tw) * rows + rsub;
      c[u] = -1;
      y[u] = identity<OP>();
      if (row < m.n && col < v) {
        const int k = __ldg(m.index + row);
        y[u] = member_value<OP, FUSED>(m, rc, lc, row, col);
        if (k >= 0 && k < g) c[u] = k;
      }
    }
  };
  // every lane runs the same number of steps: the warp's batches
  long long r0 = static_cast<long long>(b) * kWarps + warp;
  load(r0, code, x);
  for (; r0 < groups; r0 += step) {
    load(r0 + step, next_code, next_x);
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) {
      const int k = code[u];
      // the rows of this batch with code k set their column-0 lane's bit;
      // shifted to this lane's column, the bits are its peers
      if (k >= 0 && col == 0) atomicOr(tag + k, 1u << lane);
      __syncwarp();
      const unsigned peers = k >= 0 ? tag[k] << col : 0u;
      __syncwarp();
      if (k >= 0 && col == 0) tag[k] = 0u;
      const int rank = __popc(peers & lower);
      const int rounds = __reduce_max_sync(kFull, __popc(peers));
      for (int r = 0; r < rounds; ++r) {
        if (k >= 0 && rank == r) {
          float* a = mine + k * v + col;
          *a = combine<OP>(*a, x[u]);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int u = 0; u < kWarpUnroll; ++u) code[u] = next_code[u], x[u] = next_x[u];
  }
  __syncthreads();
  for (int cell = threadIdx.x; cell < cells; cell += kThreads) {
    float s = copies[cell];
    for (int w = 1; w < kWarps; ++w) s = combine<OP>(s, copies[w * cells + cell]);
    copies[cell] = s;
  }
  __syncthreads();
  finish_block(m, b, cells, ws, copies);
}

// ⊕ of n partials p[0], p[stride], … in a fixed order: lane l takes
// partials l, l + 32, … in order, then a fixed xor tree.
template <int OP>
__device__ __forceinline__ float merge_parts(const float* p, long long stride, int n) {
  const int lane = threadIdx.x & 31;
  float acc = identity<OP>();
  int k = lane;
  for (; k + 32 * (kUnroll - 1) < n; k += 32 * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = p[(k + 32 * u) * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = combine<OP>(acc, x[u]);
  }
  for (; k < n; k += 32) acc = combine<OP>(acc, p[k * stride]);
  return xor_tree<OP>(acc, 1);
}

// merge: warp w of a member.  Thread and warp members of more than one
// block: one warp per (tile, cell), over the block partials in block order.
// Sort members: one warp per (split segment, column), over the segment's
// pieces in piece order.
template <int OP>
__device__ void merge_warp(const Member& m, long long w, const float* ws) {
  const int lane = threadIdx.x & 31;
  if (base_regime(m.regime) >= kSort) {
    const int split = static_cast<int>(w / m.v), c = static_cast<int>(w % m.v);
    const int* sp = m.items + static_cast<long long>(m.n_items) * kItemFields +
                    static_cast<long long>(split) * kSplitFields;
    const float s = merge_parts<OP>(ws + m.ws + static_cast<long long>(sp[0]) * m.v + c, m.v,
                                    sp[1]);
    if (lane == 0) m.out[static_cast<long long>(sp[2]) * m.v + c] = s;
    return;
  }
  const int cells = m.g * m.vt;
  const int tile = static_cast<int>(w / cells), cell = static_cast<int>(w % cells);
  const float s = merge_parts<OP>(
      ws + m.ws + (static_cast<long long>(tile) * cells + cell) * m.blocks, 1, m.blocks);
  const long long o = out_cell(m, tile, cell);
  if (lane == 0 && o >= 0) m.out[o] = s;
}

// ---------------------------------------------------------------------------
// sort: one warp per piece of a segment's rows, in row order
// ---------------------------------------------------------------------------

// ⊕ over positions [begin, end) of the row order (row perm[i] of values, or
// row i when the values arrive in code order: ORDERED) of W columns per lane
// from column cb + W · (lane % vp) on (W = 4 when V is a multiple of 4, read
// as one 16-byte load where the address allows: the order is the same either
// way); lanes of one column class end with the same bits.  A fused member
// computes the W values from one read of the row's recipe columns.
template <int OP, int W, bool ORDERED, bool FUSED>
__device__ __forceinline__ void piece_sum(const Member& m, const Recipe* rc, int begin, int end,
                                          int cb, int vp, int lane, float (&acc)[W]) {
  constexpr int U = FUSED ? kFusedUnroll : kSortUnroll;
  const int c = cb + W * (lane % vp);
  const int step = 32 / vp;
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = identity<OP>();
  if (c < m.v) {
    const bool vec = !FUSED && W == 4 && (reinterpret_cast<unsigned long long>(m.values) & 15) == 0;
    Lane lc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) lc[w] = member_lane<FUSED>(rc, c + w);
    for (int r = begin + lane / vp; r < end; r += step * U) {
      float x[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ru = r + step * u;
#pragma unroll
        for (int w = 0; w < W; ++w) x[u][w] = identity<OP>();
        if (ru < end) {
          const long long row = ORDERED ? ru : __ldg(m.index + ru);
          if constexpr (FUSED) {
            const Row rw = recipe_row(*rc, row);
#pragma unroll
            for (int w = 0; w < W; ++w) x[u][w] = recipe_value<OP>(*rc, rw, lc[w]);
          } else {
            const float* src = m.values + row * m.v + c;
            if (W == 4 && vec) {
              const float4 q = __ldg(reinterpret_cast<const float4*>(src));
              x[u][0] = q.x;
              x[u][W > 1 ? 1 : 0] = q.y;
              x[u][W > 2 ? 2 : 0] = q.z;
              x[u][W > 3 ? 3 : 0] = q.w;
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) x[u][w] = __ldg(src + w);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = combine<OP>(acc[w], x[u][w]);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = xor_tree<OP>(acc[w], vp);
}

template <int OP, int W, bool ORDERED, bool FUSED>
__device__ void sort_item(const Member& m, const Recipe* rc, const int* item, float* ws) {
  const int lane = threadIdx.x & 31;
  const int seg = item[0], begin = item[1], end = item[2], slot = item[3];
  const int lanes = (m.v + W - 1) / W;   // lanes a row's columns need
  int vp = 1;
  while (vp < lanes && vp < 32) vp <<= 1;
  // a segment of one piece: out; else the piece's slot, for the merge grid
  float* dst = slot < 0 ? m.out + static_cast<long long>(seg) * m.v
                        : ws + m.ws + static_cast<long long>(slot) * m.v;
  for (int cb = 0; cb < m.v; cb += 32 * W) {
    float s[W];
    piece_sum<OP, W, ORDERED, FUSED>(m, rc, begin, end, cb, vp, lane, s);
    const int c = cb + W * (lane % vp);
    if (lane < vp && c < m.v) {
#pragma unroll
      for (int w = 0; w < W; ++w) dst[c + w] = s[w];
    }
  }
}

template <int OP, bool ORDERED, bool FUSED>
__device__ void sort_block(const Member& m, const Recipe* rc, int b, float* ws) {
  const int it = b * kWarps + (threadIdx.x >> 5);
  if (it >= m.n_items) return;
  const int* item = m.items + static_cast<long long>(it) * kItemFields;
  if (m.v % 4 == 0) {
    sort_item<OP, 4, ORDERED, FUSED>(m, rc, item, ws);
  } else {
    sort_item<OP, 1, ORDERED, FUSED>(m, rc, item, ws);
  }
}

// ---------------------------------------------------------------------------
// the kernel body: find the block's member, run its regime
// ---------------------------------------------------------------------------

// a member's warps in the merge grid
__host__ __device__ inline long long merge_warps(const Member& m) {
  if (base_regime(m.regime) >= kSort) {
    return static_cast<long long>(m.n_splits) * m.v;
  }
  return m.blocks > 1 ? static_cast<long long>(m.tiles) * m.g * m.vt : 0;
}

template <int OP, int R>
__device__ __forceinline__ void aggregate_members(const Table& t, const Recipes* rs, float* ws) {
  int j = t.first[R];
  const int last = j + t.members[R] - 1;
  if constexpr (R == kMerge) {  // the merge grid counts warps: a member's first is in `aux`
    const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    while (j < last && w >= t.m[j + 1].aux) ++j;
    const Member& m = t.m[j];
    if (w - m.aux < merge_warps(m)) merge_warp<OP>(m, w - m.aux, ws);
  } else {
    while (j < last && static_cast<int>(blockIdx.x) >= t.m[j + 1].first_block) ++j;
    const Member& m = t.m[j];
    const int b = static_cast<int>(blockIdx.x) - m.first_block;
    constexpr bool kFusedGrid = R >= kFused;
    const Recipe* rc = nullptr;
    if constexpr (kFusedGrid) {  // the member's recipe, in shared memory for every thread
      __shared__ Recipe recipe;
      const int* src = reinterpret_cast<const int*>(&rs->r[j - t.first[kFused]]);
      int* dst = reinterpret_cast<int*>(&recipe);
      for (int i = threadIdx.x; i < static_cast<int>(sizeof(Recipe) / 4); i += kThreads) {
        dst[i] = src[i];
      }
      __syncthreads();
      rc = &recipe;
    }
    constexpr int kBase = base_regime(R);
    if constexpr (kBase == kThread) {
      thread_block<OP, kFusedGrid>(m, rc, b, ws);
    } else if constexpr (kBase == kWarp) {
      warp_block<OP, kFusedGrid>(m, rc, b, ws);
    } else {
      sort_block<OP, kBase == kSortOrdered, kFusedGrid>(m, rc, b, ws);
    }
  }
}

// Host side: one grid of `kernel`, if the table has work for it; `args` are
// the kernel's (the table, for a fused grid the recipes, the workspace).
template <typename Kernel, typename... Args>
inline cudaError_t launch_regime(Kernel kernel, const Table& t, int r, cudaStream_t s,
                                 const Args&... args) {
  if (t.members[r] == 0 || t.grid[r] == 0) return cudaSuccess;
  kernel<<<t.grid[r], kThreads, t.smem[r], s>>>(args...);
  return cudaGetLastError();
}

// Host side: a fused member's recipe is complete (its pointers are the
// caller's: ops.py checks every tensor's shape, dtype and device).
inline bool recipe_ok(const Recipe& rc, const Member& m) {
  if (rc.lift == nullptr || rc.msgs < 0 || rc.msgs > kMaxMsgs || rc.preds < 0 ||
      rc.preds > kMaxPreds || (rc.add != 0 && rc.add != 1)) {
    return false;
  }
  if (rc.msgs == 0 && m.v != 1) return false;   // a lift alone is one lane
  for (int k = 0; k < rc.msgs; ++k) {
    if (rc.tab[k] == nullptr || rc.lane_col[k] == nullptr || rc.cols[k] < 1) return false;
  }
  for (int p = 0; p < rc.preds; ++p) {
    if (rc.codes[p] == nullptr || rc.mask[p] == nullptr) return false;
  }
  return true;
}

// Host side: the checks a C entry point makes before it launches.
inline bool table_ok(const Table& t, const Recipes* rs, const void* ws) {
  if (t.count < 1 || t.count > kMaxMembers) return false;
  int next = 0;
  long long merge = 0;
  for (int r = kThread; r < kMerge; ++r) {
    if (t.first[r] != next || t.members[r] < 0) return false;
    next += t.members[r];
    if (t.members[r] == 0) continue;
    const int base = base_regime(r);
    const bool fused = r >= kFused;
    if (t.grid[r] < 1 || t.smem[r] < 0) return false;
    if (t.smem[r] > (base >= kSort ? kSmemMax : kBigSmemMax)) return false;
    if (fused && rs == nullptr) return false;
    int block = 0;
    for (int j = t.first[r]; j < next; ++j) {
      const Member& m = t.m[j];
      if (m.regime != r || m.n <= 0 || m.g <= 0 || m.v <= 0 || m.blocks <= 0) return false;
      if ((m.index == nullptr) != (base == kSortOrdered)) return false;
      if ((m.values == nullptr) != fused) return false;
      if (fused && !recipe_ok(rs->r[j - t.first[kFused]], m)) return false;
      if (base == kThread && m.g * kThreads * 4 > t.smem[r]) return false;
      if (base == kWarp &&
          (m.v > 32 || m.vt != m.v || m.g * (m.v + 1) * kWarps * 4 > t.smem[r])) {
        return false;
      }
      if (base >= kSort && (m.items == nullptr || m.n_items > m.blocks * kWarps)) return false;
      if (m.aux != merge || m.first_block != block) return false;
      merge += merge_warps(m);
      block += m.blocks * m.tiles;
    }
    if (block != t.grid[r]) return false;
  }
  if (merge > 0 && ws == nullptr) return false;
  if (t.first[kMerge] != 0 || t.members[kMerge] != t.count) return false;
  if (t.grid[kMerge] != (merge + kWarps - 1) / kWarps || t.smem[kMerge] != 0) return false;
  return next == t.count;
}

}  // namespace segagg
