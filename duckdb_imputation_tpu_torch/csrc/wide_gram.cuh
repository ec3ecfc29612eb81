// K7 and K8: the masked Gram for wide schemas (P > kMaxP = 88, up to
// kMaxWideP), S = Zᵀ·diag(w)·Z with Z = [1 ‖ x ‖ onehot(codes)], over each
// row's nonzeros, for sm_90a. Included by wide_gram.cu (K7, the Gram
// alone), fused_impute_aggregate.cu (the Gram of K2w, the wide fused pass)
// and grouped_wide_gram.cu (K8, one S per group over group-sorted rows).
//
// Replaces, for P > 88, the Pallas kernels of duckdb_imputation_tpu/ring/
// kernels/sigma_pallas.py that fall to pack = 1 and a wider tile there
// (sigma_pallas, sigma_pallas_fast, sigma_pallas_fast2(_cols) and
// sigma_pallas_fast3(_cols)) and, as K8, the grouped ones of
// sigma_pallas_grouped.py (see grouped_wide_gram.cu).
//
// A row of Z has only k = 1 + d + c nonzeros, so S's nonzero structure is
// fixed by the schema (ring/kernels/_build.py: WidePlan):
//   D     the (1+d)×(1+d) block of [1 ‖ x]: dense;
//   K_j   per categorical column j, Σ_{c_j = v} w·[1, x], (1+d) × V_j; its
//         row of counts is also the diagonal of j's one-hot block;
//   C_jk  per pair j < k, Σ_{c_j = u, c_k = v} w, V_j × V_k;
//   zero  the off-diagonal cells of one column's one-hot block.
// A row adds k(k + 1)/2 products in all (91 at favorita_wide, P = 492),
// where a dense tiling of S issues ~P²/2.
//
//   1. The host cuts the tables into slabs (a D row's cells, a key range
//      of K_j, past d ≈ 834 beside a code column also a column range of it
//      (KB), or a key range of C_jk) and the slabs into tasks whose f64
//      tables fit
//      kWideTaskBytes of shared memory; each slab of a task belongs to one
//      of its kWideWarps warps.
//   2. blockIdx.x is a task, blockIdx.y a row slice: a run of consecutive
//      chunks of kWideChunk = 32 rows. The block stages up to 256 rows (8
//      chunks) a step with cp.async into one of two buffers, only the
//      columns its task reads (w, x for a D or K slab, the code columns of
//      its K and C slabs), the next step's copies in flight while the
//      warps walk the current one. Every warp walks all of the slice's
//      chunks in order, one row a lane, for each of its slabs.
//   3. For a K or C slab each lane computes its row's cell;
//      __match_any_sync finds the lanes of the same cell, their values are
//      summed in f32 (at most 32 rows) by pointer jumping along the cell's
//      lanes (five shuffles a value), and the lowest of them adds the sum
//      to the f64 table. A warp takes two chunks at once: their matches
//      and sums are independent, so their latencies overlap, then the two
//      chunks' table updates follow, the first chunk's first. A D slab of
//      nc ≤ 32 cells gives each cell a power of two of lanes over
//      interleaved rows and a butterfly over them. A cell is written only
//      by the warp that owns its slab: no float atomics, and the order of
//      every sum is fixed by the lanes, so reruns are bit-identical; f32
//      spans at most 32 rows and everything beyond is f64, so counts are
//      exact at any n < 2³¹.
//   4. After its last chunk (and, in K8, when its group changes) a warp
//      writes its slabs' cells to the partial of (task, slice + group).
//      wide_gram_reduce sums each cell's slices in slice order in f64,
//      rounds to f32 once and writes both triangles of S through the
//      plan's map; cells of the zero structure are never written (the
//      output is zero-filled).
//   5. K7 over a column window S[:, lo:lo + width] (dit_wide_gram_window,
//      any P ≤ kMaxWindowP) runs over a window's plans (_build.py:
//      keyed_window_plan): the cells whose row or column lies in the
//      window, C_jk cut by either key range (a slab (C, k, j, ...) keys on
//      column k's codes) and, where a row of V_k cells passes a task (both
//      columns past kWideTaskBytes / 8 levels: Criteo's C7 and C15), by
//      row code too (CB slabs; in a keyed window each row range a table
//      of the owner column's), and a map of one place a cell and output
//      position, S[i, j] with lo ≤ j < lo + width, written with a row
//      stride `ld` (OutMap, mirror off). Past kMaxWideP, where the tables
//      keyed on one categorical column J (K_J and every C_Jk keyed on J)
//      would take more than one task, they are keyed: cut into tasks of
//      one key range [u_lo, u_hi) of J each (several tables a task,
//      packed into layers of ≤ kWideTaskBytes a key range), and the
//      keyed kernel (Keyed = true, dit_wide_gram_keyed) walks only that
//      range's rows, key_off[u_lo] .. key_off[u_hi], of a copy of w, x and
//      the codes ordered once a call by code_J (window_order: a stable
//      sort; K8 orders by (group, code_J)). Every table of a C_Jk with a
//      keyed column is keyed on one owner in every window (a CR slab
//      holds its rows of the other column's window keys), so S[i, j] and
//      S[j, i] are the same sum. A task's chunks are cut into work items
//      where they meet blocks of item_chunks chunks, a block each, so a
//      hot key's rows spread over many blocks; each item has its own
//      partial slot, and wide_gram_keyed_reduce sums a cell's items in
//      item order. The rest of the window (D, the other columns' tables)
//      is the residual plan, its tasks over all rows as in steps 1-4. Where a task walked
//      all n rows for one key range of a V_j·V_k table, a window now
//      reads each row once a layer of each keyed column. Past kMaxWideP
//      masked_gram assembles S from such windows, K2w's Gram is such
//      windows after its impute kernel (dit_impute_wide), and K8 runs once
//      a window (dit_grouped_wide_gram_window over the residual, the keyed
//      kernel with G groups), the group stride in its OutMap.
//
// What bounds it on an H100: the bytes floor is one read of x, codes and w
// (0.16 ms per 10M rows at favorita_wide); the work is ~k(k + 1)/2 table
// updates a row (91 at favorita_wide) in ~50 slabs, each slab a chain of
// dependent steps per chunk (codes, match, five shuffles, the table), so
// the kernel is bound by the latency of those chains on its busiest warp
// (PERF.md, tools/wide_gram_variants.py: a serial sum by the lowest lane
// cost 4.1×, one chunk at a time instead of two 1.5×, first-fit packing
// instead of by slab count 1.1×). Over a window, the keyed part reads
// each row once a layer, from the ordered copies; what bounds a window
// past P = 1,024 is the order pass (a sort and a gather of every column
// a keyed column, once a call), the residual's walks of all rows and
// the reduction's read of the map (PERF.md §6, tools/window_times.py).
#pragma once

#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kMaxWideP = 1024;             // K7's whole plan, K2w's fused
                                             // entry and K8's whole plan
                                             // (past it: a launch a window)
// K7, K8 and K2w over column windows: a window's map entries are counted
// in an int (WidePlanArgs::nentries), and a window of 1,024 columns
// (_build.py: WINDOW_WIDTH; a wider one past MAX_WINDOW_PLACES runs as
// such windows) maps at most P·1,024 places, so P ≤ (2³¹ − 1) / 1,024.
// Every index of S (an entry's i, j, a column's offset) is an int below
// P, and every position into S an int64 (OutMap)
constexpr int kMaxWindowP = 2097151;
constexpr int kWideChunk = 32;               // rows a warp takes a step
constexpr int kWideWarps = kThreads / 32;    // warps of a block
constexpr int kWideSubs = kThreads / kWideChunk;  // most warp steps a stage
constexpr int kWideTaskBytes = 64 * 1024;    // f64 tables of one task
constexpr int kWideSlabInts = 8;             // ints of a slab record
constexpr int kWideMaxSlabs = 256;           // slabs of one task
constexpr int kWideSmem = 227 * 1024;        // shared memory of a block
constexpr int kWidePlanInts = 8;             // ints of the plan's shape
constexpr int kKeyedTaskInts = 3;           // ints of a keyed task: J, u_lo, u_hi
constexpr int kSlabD = 0;   // (D, a, b_lo, b_hi): cells (a, b_lo .. b_hi)
constexpr int kSlabK = 1;   // (K, j, v_lo, v_hi): [v − v_lo][1 + d]
constexpr int kSlabC = 2;   // (C, j, k, u_lo, u_hi): [u − u_lo][V_k]
// (CR, j, k, v_lo, v_hi): [u − u_lo][v − v_lo], u in the keyed task's keys
// [u_lo, u_hi) (a window's keyed tasks only)
constexpr int kSlabCR = 3;
// (CM, j, k_lo, k_hi): [u][Σ_{k_lo ≤ k < k_hi} V_k], every C_jk of the row
// columns k_lo .. k_hi − 1 side by side, cell u·W + off_k − off_{k_lo} + v
// (W the sum): many small cross tables as one slab (one-level null flags)
constexpr int kSlabCM = 4;
// (CB, j, k, u_lo, u_hi) of rows [v_lo, v_hi): [u − u_lo][v − v_lo]: C_jk
// where a row of V_k cells passes a task, cut by row code too (_build.py:
// _row_cut). The kernel reads a C slab as the CB slab of rows [0, V_k):
// both records are (kind, v_lo, v_hi, u_lo, u_hi, off, the key's and the
// row column's stage slots) (_build.py: WidePlan.device_slabs)
constexpr int kSlabCB = 5;
// (KB, a_hi, v_lo, v_hi, a_lo): [v − v_lo][a − a_lo] of K_j's columns [a_lo,
// a_hi) of [1 ‖ x], where a task staging every numeric column beside a code
// column passes shared memory (_build.py: _k_cols, d ≥ 835): its record
// carries j's code slot and s with x_a at slot s + a (_build.py:
// WidePlan.device_slabs), so its task stages only those columns
constexpr int kSlabKB = 6;

static_assert(kWideChunk == 32, "one row a lane of a warp");

// The host's plan (ring/kernels/_build.py: WidePlan): its tensors in
// device memory and its shape.
struct WidePlanArgs {
  // [S][kWideSlabInts]: kind, p0..p3, off, and the stage slots the slab
  // reads; a C or CB slab's p0, p1 are its rows [v_lo, v_hi) (_build.py:
  // WidePlan.device_slabs)
  const int* slabs;
  const int* warp_begin;     // [tasks · kWideWarps + 1]
  const int64_t* task_base;  // [tasks + 1]: each task's first flat cell
  // [tasks][width]: nx, nc, the numeric then the code columns the task
  // stages (ascending each)
  const int* stage_cols;
  const int* entries;        // [nentries][4]: task, cell, i, j (i ≤ j)
  int tasks, nentries, max_cells, max_cols, max_slabs, rows, width;
};

// The keyed part of a window (_build.py: KeyedPlan, window_order): rows
// copied in the order of a keyed column J's codes (K8: of (group, code)),
// each task walking the rows of its key range only, cut into work items.
struct KeyedArgs {
  const float* rows;          // the ordered copies: column J's at
                              // rows_of[J], [n][stride] (w, x, codes)
  const int64_t* key_off;     // J's row offsets at off_of[J]: G·V_J + 1
  const int64_t* key_chunks;  // J's first chunk of each key, as key_off
  const int64_t* rows_of;     // [c], −1 for a column not ordered
  const int64_t* off_of;      // [c]
  const int* task_keys;       // [tasks][kKeyedTaskInts]: J, u_lo, u_hi
  const int64_t* item_cum;    // [tasks·G + 1]: the first work item of
                              // each (task, group), (task, group) order
  int G, item_chunks, stride; // groups; most chunks of a work item; ints
                              // of a copied row
};

// Chunks a slice takes, the same in the kernel and the reduction.
__host__ __device__ __forceinline__ int64_t chunks_per_slice(int64_t total,
                                                             int slices) {
  const int64_t cps = (total + slices - 1) / slices;
  return cps > 0 ? cps : 1;
}

// The cells a CM slab's key holds: its row columns' levels, side by side.
__device__ __forceinline__ int cm_width(const int* sl, const Cols& cols) {
  return cols.of(sl[3] - 1) + cols.sz(sl[3] - 1) - cols.of(sl[2]);
}

// keys: the keyed task's key count (a CR slab's rows of cells)
__device__ __forceinline__ int slab_cells(const int* sl, const Cols& cols,
                                          int keys) {
  if (sl[0] == kSlabD) return sl[3] - sl[2];
  if (sl[0] == kSlabK) return (sl[3] - sl[2]) * (1 + cols.d);
  if (sl[0] == kSlabKB) return (sl[3] - sl[2]) * (sl[1] - sl[4]);
  if (sl[0] == kSlabCR) return keys * (sl[4] - sl[3]);
  if (sl[0] == kSlabCM) return cols.sz(sl[1]) * cm_width(sl, cols);
  return (sl[4] - sl[3]) * (sl[2] - sl[1]);  // C, CB: keys × rows
}

// 4 bytes global → shared, asynchronously (cp.async), or `zero` when the
// row does not exist.
__device__ __forceinline__ void stage4(float* dst, const void* src,
                                       bool valid, float zero) {
  if (valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = zero;
  }
}

// The lanes of one key form a list in lane order. succ[i] is the lane 2^i
// places after this one in its list (32: none), by pointer jumping.
struct PeerList {
  int succ[5];
  __device__ __forceinline__ PeerList(unsigned peers, int lane) {
    const unsigned later = lane == 31 ? 0u : peers >> (lane + 1) << (lane + 1);
    succ[0] = later ? __ffs(later) - 1 : 32;
#pragma unroll
    for (int i = 1; i < 5; ++i) {
      const int s2 = __shfl_sync(0xffffffffu, succ[i - 1], succ[i - 1] & 31);
      succ[i] = succ[i - 1] < 32 ? s2 : 32;
    }
  }
  // Σ of v over this lane and the rest of its list (the whole key's sum
  // at its first lane), as a tree fixed by the lanes: deterministic.
  __device__ __forceinline__ float suffix_sum(float v) const {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float o = __shfl_sync(0xffffffffu, v, succ[i] & 31);
      if (succ[i] < 32) v += o;
    }
    return v;
  }
};

// One warp's update of one K or C slab from two chunks of 32 staged rows
// (w at rows[r], x_a at rows[a·R + r]; key1 = −1 for none): per chunk, the
// lanes of the same key (__match_any_sync) sum their values (w for C; w,
// w·x_a for K, as K1's z·w) in f32 over their list, and the first of them
// adds the sums to the f64 table, chunk 0's before chunk 1's. The two
// chunks' matches and sums are independent, so their latencies overlap.
// key < 0: the lane's row adds nothing.
__device__ __forceinline__ void add_keyed(double* table, int key0, int key1,
                                          int vals, const float* rows0,
                                          const float* rows1, int R,
                                          int lane) {
  const unsigned p0 = __match_any_sync(0xffffffffu, key0);
  const unsigned p1 = __match_any_sync(0xffffffffu, key1);
  const bool lead0 = key0 >= 0 && __ffs(p0) - 1 == lane;
  const bool lead1 = key1 >= 0 && __ffs(p1) - 1 == lane;
  const PeerList l0(p0, lane), l1(p1, lane);
  const float w0 = rows0[lane], w1 = rows1[lane];
  double* t0 = table + key0 * vals;
  double* t1 = table + key1 * vals;
  float s0 = l0.suffix_sum(w0), s1 = l1.suffix_sum(w1);
  if (lead0) t0[0] += static_cast<double>(s0);
  if (lead1) t1[0] += static_cast<double>(s1);
  for (int a = 1; a < vals; ++a) {
    s0 = l0.suffix_sum(rows0[a * R + lane] * w0);
    s1 = l1.suffix_sum(rows1[a * R + lane] * w1);
    if (lead0) t0[a] += static_cast<double>(s0);
    if (lead1) t1[a] += static_cast<double>(s1);
  }
}

// add_keyed over the columns [a_lo, a_hi) of [1 ‖ x] of a KB slab: cell
// a − a_lo of the key's row, w for a = 0, else w·x_a with x_a at slot sx + a;
// each cell's sums as add_keyed forms them. A K slab is the KB slab of
// columns [0, 1 + d) at sx = 0 with the same bits, but keeps add_keyed:
// read through this, with its columns from its record, K7 at favorita_wide
// ran 9% slower (PERF.md §6).
__device__ __forceinline__ void add_keyed_cols(double* table, int key0,
                                               int key1, int a_lo, int a_hi,
                                               int sx, const float* rows0,
                                               const float* rows1, int R,
                                               int lane) {
  const unsigned p0 = __match_any_sync(0xffffffffu, key0);
  const unsigned p1 = __match_any_sync(0xffffffffu, key1);
  const bool lead0 = key0 >= 0 && __ffs(p0) - 1 == lane;
  const bool lead1 = key1 >= 0 && __ffs(p1) - 1 == lane;
  const PeerList l0(p0, lane), l1(p1, lane);
  const float w0 = rows0[lane], w1 = rows1[lane];
  const int vals = a_hi - a_lo;
  double* t0 = table + key0 * vals - a_lo;
  double* t1 = table + key1 * vals - a_lo;
  for (int a = a_lo; a < a_hi; ++a) {
    const float s0 = l0.suffix_sum(a ? rows0[(sx + a) * R + lane] * w0 : w0);
    const float s1 = l1.suffix_sum(a ? rows1[(sx + a) * R + lane] * w1 : w1);
    if (lead0) t0[a] += static_cast<double>(s0);
    if (lead1) t1[a] += static_cast<double>(s1);
  }
}

// One warp's update of a D slab, cells (a, b) for b in [lo, hi), nc =
// hi − lo ≤ 32: lane = cell · P2 + part, P2 the largest power of two with
// nc · P2 ≤ 32; a part sums rows part, part + P2, … and a butterfly over
// the parts leaves the cell's sum in part 0. x_a lies at stage slot sa,
// x_b at sb + b (a task staging every numeric column: sa = a, sb = 0).
__device__ __forceinline__ void add_dense(double* table, int a, int sa,
                                          int lo, int hi, int sb,
                                          const float* rows, int R,
                                          int lane) {
  const int nc = hi - lo;
  int p2 = kWideChunk;
  while (nc * p2 > kWideChunk) p2 >>= 1;
  const int e = lane / p2, part = lane % p2;
  float s = 0.0f;
  if (e < nc) {
    const int b = lo + e;
    for (int r = part; r < kWideChunk; r += p2) {
      const float va = a == 0 ? rows[r] : rows[sa * R + r] * rows[r];
      s += va * (b == 0 ? 1.0f : rows[(sb + b) * R + r]);
    }
  }
  for (int d = 1; d < p2; d <<= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (e < nc && part == 0) table[e] += static_cast<double>(s);
}

// Grouped = false: K7 over rows 0 .. n (off, cum unused, G = 1). Grouped:
// K8 over group-sorted rows, group g owning rows off[g] .. off[g + 1] cut
// into chunks cum[g] .. cum[g + 1] that never cross a group boundary.
// partial: per task, (slices + G − 1) slots of its cells. Keyed (key's
// plan; w, off, cum, G unused; gridDim.y = 1): blockIdx.x is a work item,
// the chunks of one (task, group)'s rows key_off[base + u_lo] ..
// key_off[base + u_hi] of J's copy (base = off_of[J] + g·V_J) that lie in
// one block [b·m, (b + 1)·m) of m = item_chunks chunks of the copy, each
// key's rows cut into chunks from its first row (key_chunks): a cell's
// f32 chunk sums, and the items that add them up, are the same in every
// task and window that holds its key; its partial the item's slot of
// plan.max_cells cells.
//
// A block stages plan.rows rows (rows / 32 chunks) a step into one of two
// buffers with cp.async, the next step's copies in flight while its warps
// walk the current one; a step's buffer holds, column by column, w, the
// numeric columns its task reads (all of them for a K slab) and its code
// columns, each slab reading them at the stage slots of its record.
template <bool Grouped, bool Keyed>
__global__ void __launch_bounds__(kThreads)
wide_gram_kernel(const __grid_constant__ Cols cols,
                 const __grid_constant__ WidePlanArgs plan,
                 const float* __restrict__ w, int64_t n,
                 const int64_t* __restrict__ off,
                 const int64_t* __restrict__ cum, int G,
                 double* __restrict__ partial,
                 const __grid_constant__ KeyedArgs key) {
  extern __shared__ double wide_smem[];
  int task = blockIdx.x, slice = blockIdx.y;
  const int slices = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Keyed: the work item's (task, group), its chunks kc0 .. kc1 of the
  // copy `src` (chunk ch of key u: rows koff[u] + (ch − kcum[u])·32 ..),
  // ku the key of a thread's chunk
  int64_t item = 0, kc0 = 0, kc1 = 0;
  const int64_t *koff = nullptr, *kcum = nullptr;
  int ku = 0, ku_lo = 0, nkeys = 0;
  const float* src = w;
  if constexpr (Keyed) {
    item = blockIdx.x;
    const int tgs = plan.tasks * key.G;
    if (item >= key.item_cum[tgs]) return;      // past the items: the block
    int a = 0, b = tgs - 1;   // the last (task, group) starting at ≤ item
    while (a < b) {
      const int mid = (a + b + 1) / 2;
      if (key.item_cum[mid] <= item) a = mid; else b = mid - 1;
    }
    task = a / key.G;
    slice = 0;
    const int* tk = key.task_keys + task * kKeyedTaskInts;
    const int64_t base =
        key.off_of[tk[0]] + int64_t(a % key.G) * cols.sz(tk[0]);
    koff = key.key_off + base;
    kcum = key.key_chunks + base;
    const int64_t m = key.item_chunks;
    const int64_t b0 = (kcum[tk[1]] / m + item - key.item_cum[a]) * m;
    kc0 = b0 > kcum[tk[1]] ? b0 : kcum[tk[1]];
    kc1 = b0 + m < kcum[tk[2]] ? b0 + m : kcum[tk[2]];
    ku_lo = tk[1];
    nkeys = tk[2] - tk[1];
    int u0 = tk[1], u1 = tk[2] - 1;   // the last key starting at ≤ kc0
    while (u0 < u1) {
      const int mid = (u0 + u1 + 1) / 2;
      if (kcum[mid] <= kc0) u0 = mid; else u1 = mid - 1;
    }
    ku = u0;
    src = key.rows + key.rows_of[tk[0]];
  }
  const int R = plan.rows, subs = R / kWideChunk;
  const int64_t tbase = plan.task_base[task];
  const int cells = static_cast<int>(plan.task_base[task + 1] - tbase);
  const int sb = plan.warp_begin[task * kWideWarps];
  const int nslabs = plan.warp_begin[(task + 1) * kWideWarps] - sb;
  const int* tcols = plan.stage_cols + int64_t(task) * plan.width;
  const int xcols = tcols[0], ncodes = tcols[1];

  double* table = wide_smem;                                  // [cells]
  float* stage = reinterpret_cast<float*>(wide_smem + plan.max_cells);
  int* slabs = reinterpret_cast<int*>(stage + 2 * plan.max_cols * R);
  int* scol = slabs + plan.max_slabs * kWideSlabInts;  // [xcols + ncodes]
  int* sub_g = scol + plan.width;                      // [2][kWideSubs]

  for (int e = tid; e < cells; e += kThreads) table[e] = 0.0;
  for (int e = tid; e < nslabs * kWideSlabInts; e += kThreads)
    slabs[e] = plan.slabs[sb * kWideSlabInts + e];
  for (int q = tid; q < xcols + ncodes; q += kThreads) scol[q] = tcols[2 + q];
  const int* code_col = scol + xcols;
  const int cbase = 1 + xcols;                  // stage slot of code 0
  __syncthreads();

  const int64_t total =
      Grouped ? cum[G] : (n + kWideChunk - 1) / kWideChunk;
  const int64_t cps = chunks_per_slice(total, slices);
  const int64_t c0 = Keyed ? kc0 : int64_t(slice) * cps;
  const int64_t c1 = Keyed ? kc1 : c0 + cps < total ? c0 + cps : total;
  if (c0 >= c1) return;                         // the whole block
  const int steps = static_cast<int>((c1 - c0 + subs - 1) / subs);

  // staging: thread tid < R copies row `lane` of chunk c0 + step·subs +
  // tid / 32; gs follows that chunk's group
  int gs = 0;
  if (Grouped) {   // the group of chunk c0: the last g with cum[g] ≤ c0
    int ghi = G;
    while (gs < ghi) {
      const int mid = (gs + ghi + 1) / 2;
      if (cum[mid] <= c0) gs = mid; else ghi = mid - 1;
    }
  }
  auto stage_step = [&](int step) {
    float* buf = stage + (step & 1) * plan.max_cols * R + tid;
    if (tid < R) {
      const int64_t ch = c0 + int64_t(step) * subs + tid / kWideChunk;
      int64_t row = ch * kWideChunk + lane, end = n;
      if (Grouped && ch < c1) {
        while (ch >= cum[gs + 1]) ++gs;
        row = off[gs] + (ch - cum[gs]) * kWideChunk + lane;
        end = off[gs + 1];
        if (lane == 0) sub_g[(step & 1) * kWideSubs + tid / kWideChunk] = gs;
      }
      if constexpr (Keyed) {
        if (ch < c1) {
          while (ch >= kcum[ku + 1]) ++ku;
          row = koff[ku] + (ch - kcum[ku]) * kWideChunk + lane;
          end = koff[ku + 1];
        }
      }
      const bool valid = ch < c1 && row < end;
      if constexpr (Keyed) {   // J's copy, a row of w, x, codes
        const float* r = src + row * key.stride;
        stage4(buf, r, valid, 0.0f);
        for (int j = 0; j < xcols; ++j)
          stage4(buf + (1 + j) * R, r + 1 + scol[j], valid, 0.0f);
        for (int q = 0; q < ncodes; ++q)
          stage4(buf + (cbase + q) * R, r + 1 + cols.d + code_col[q],
                 valid, __int_as_float(-1));
      } else if (cols.far == nullptr) {   // every column in the parameter
        stage4(buf, w + row, valid, 0.0f);
        for (int j = 0; j < xcols; ++j)   // every numeric column: scol[j] = j
          stage4(buf + (1 + j) * R,
                 cols.x[xcols == cols.d ? j : scol[j]] + row, valid, 0.0f);
        for (int q = 0; q < ncodes; ++q)
          stage4(buf + (cbase + q) * R, cols.code[code_col[q]] + row, valid,
                 __int_as_float(-1));
      } else {
        stage4(buf, w + row, valid, 0.0f);
        for (int j = 0; j < xcols; ++j)
          stage4(buf + (1 + j) * R, cols.xp(scol[j]) + row, valid, 0.0f);
        for (int q = 0; q < ncodes; ++q)
          stage4(buf + (cbase + q) * R, cols.cp(code_col[q]) + row, valid,
                 __int_as_float(-1));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int s0 = plan.warp_begin[task * kWideWarps + warp] - sb;
  const int s1 = plan.warp_begin[task * kWideWarps + warp + 1] - sb;
  // the warp's cells: its slabs lie next to each other in the table
  const int lo_cell = s0 < s1 ? slabs[s0 * kWideSlabInts + 5] : 0;
  const int hi_cell = s0 < s1 ? slabs[(s1 - 1) * kWideSlabInts + 5] +
                                    slab_cells(slabs + (s1 - 1) *
                                               kWideSlabInts, cols, nkeys)
                              : 0;
  double* slots = Keyed ? partial + item * plan.max_cells
                        : partial + tbase * (slices + G - 1);
  int cur = Grouped ? -1 : 0;   // the group the warp's tables hold

  stage_step(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage_step(step + 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* buf = stage + (step & 1) * plan.max_cols * R;
    const int64_t left = c1 - (c0 + int64_t(step) * subs);
    const int nsub = left < subs ? static_cast<int>(left) : subs;
    const int* gsub = sub_g + (step & 1) * kWideSubs;
    for (int k = 0; k < nsub && s0 < s1;) {
      if (Grouped && gsub[k] != cur) {   // flush the finished group
        if (cur >= 0) {
          double* o = slots + int64_t(slice + cur) * cells;
          for (int e = lo_cell + lane; e < hi_cell; e += 32) {
            o[e] = table[e];
            table[e] = 0.0;
          }
          __syncwarp();
        }
        cur = gsub[k];
      }
      // two chunks at once where a second one of the same group follows
      const bool pair = k + 1 < nsub && (!Grouped || gsub[k + 1] == cur);
      const float* rows0 = buf + k * kWideChunk;
      const float* rows1 = pair ? rows0 + kWideChunk : rows0;
      const int* codes0 = reinterpret_cast<const int*>(rows0);
      const int* codes1 = reinterpret_cast<const int*>(rows1);
      for (int s = s0; s < s1; ++s) {
        const int* sl = slabs + s * kWideSlabInts;
        double* t = table + sl[5];
        if (sl[0] == kSlabD) {
          add_dense(t, sl[1], sl[6], sl[2], sl[3], sl[7], rows0, R, lane);
          if (pair)
            add_dense(t, sl[1], sl[6], sl[2], sl[3], sl[7], rows1, R, lane);
        } else if (sl[0] == kSlabK) {
          const int q = sl[6] * R + lane;
          const int v0 = codes0[q], v1 = codes1[q];
          add_keyed(t, v0 >= sl[2] && v0 < sl[3] ? v0 - sl[2] : -1,
                    pair && v1 >= sl[2] && v1 < sl[3] ? v1 - sl[2] : -1,
                    1 + cols.d, rows0, rows1, R, lane);
        } else if (sl[0] == kSlabKB) {   // keys [p1, p2), columns [p3, p0)
          const int q = sl[6] * R + lane;
          const int v0 = codes0[q], v1 = codes1[q];
          add_keyed_cols(t, v0 >= sl[2] && v0 < sl[3] ? v0 - sl[2] : -1,
                         pair && v1 >= sl[2] && v1 < sl[3] ? v1 - sl[2] : -1,
                         sl[4], sl[1], sl[7], rows0, rows1, R, lane);
        } else if (Keyed && sl[0] == kSlabCR) {
          const int nv = sl[4] - sl[3];
          const int qu = sl[6] * R + lane;
          const int qv = sl[7] * R + lane;
          const int u0 = codes0[qu] - ku_lo, v0 = codes0[qv] - sl[3];
          const int u1 = codes1[qu] - ku_lo, v1 = codes1[qv] - sl[3];
          add_keyed(t,
                    u0 >= 0 && u0 < nkeys && v0 >= 0 && v0 < nv
                        ? u0 * nv + v0 : -1,
                    pair && u1 >= 0 && u1 < nkeys && v1 >= 0 && v1 < nv
                        ? u1 * nv + v1 : -1,
                    1, rows0, rows1, R, lane);
        } else if (sl[0] == kSlabCM) {
          // each row column k in turn, as a C slab of its own over all of
          // column sl[1]'s keys, at its cells' place in the key's row
          const int vu = cols.sz(sl[1]), width = cm_width(sl, cols);
          const int qu = sl[6] * R + lane;
          const int u0 = codes0[qu], u1 = codes1[qu];
          const bool in0 = u0 >= 0 && u0 < vu;
          const bool in1 = pair && u1 >= 0 && u1 < vu;
          const int o0 = cols.of(sl[2]);
          for (int k = sl[2]; k < sl[3]; ++k) {
            const int vk = cols.sz(k), at = cols.of(k) - o0;
            const int qv = (sl[7] + k - sl[2]) * R + lane;
            const int v0 = codes0[qv], v1 = codes1[qv];
            add_keyed(t,
                      in0 && v0 >= 0 && v0 < vk ? u0 * width + at + v0 : -1,
                      in1 && v1 >= 0 && v1 < vk ? u1 * width + at + v1 : -1,
                      1, rows0, rows1, R, lane);
            __syncwarp();
          }
        } else {                // C, CB: keys [p2, p3), rows [p0, p1)
          const int nu = sl[4] - sl[3];
          const int nv = sl[2] - sl[1];
          const int qu = sl[6] * R + lane;
          const int qv = sl[7] * R + lane;
          const int u0 = codes0[qu] - sl[3], v0 = codes0[qv] - sl[1];
          const int u1 = codes1[qu] - sl[3], v1 = codes1[qv] - sl[1];
          add_keyed(t,
                    u0 >= 0 && u0 < nu && v0 >= 0 && v0 < nv
                        ? u0 * nv + v0 : -1,
                    pair && u1 >= 0 && u1 < nu && v1 >= 0 && v1 < nv
                        ? u1 * nv + v1 : -1,
                    1, rows0, rows1, R, lane);
        }
        __syncwarp();
      }
      k += pair ? 2 : 1;
    }
    __syncthreads();   // the buffer is restaged two steps on
  }
  if (s0 < s1) {
    double* o = slots + int64_t(slice + cur) * cells;
    for (int e = lo_cell + lane; e < hi_cell; e += 32) o[e] = table[e];
  }
}

// Where the reduction writes a map entry (i, j) of group g: out + g·gstride
// + i·ld + j − lo and, with `mirror`, + j·ld + i − lo. A whole plan (i ≤ j,
// both triangles): {P, P·P, 0, true}; a window's plan (one place an
// entry, lo ≤ j < lo + width): {ld, 0, lo, false}.
struct OutMap {
  int64_t ld, gstride;
  int lo;
  bool mirror;
};

// One thread per (group, map entry): the cell's slots over the slices that
// touched the group, in slice order, f64, one rounding; writes S_g[i, j]
// and, with om.mirror, S_g[j, i]. cum == nullptr: K7, one group of `total`
// chunks. An empty group gets zeros.
__global__ void wide_gram_reduce(const double* __restrict__ partial,
                                 const __grid_constant__ WidePlanArgs plan,
                                 const int64_t* __restrict__ cum,
                                 int64_t total, int G, int slices,
                                 const OutMap om, float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(G) * plan.nentries) return;
  const int g = static_cast<int>(t / plan.nentries);
  const int* e = plan.entries + 4 * (t % plan.nentries);
  const int task = e[0], cell = e[1], i = e[2], j = e[3];
  const int64_t lo = cum ? cum[g] : 0, hi = cum ? cum[g + 1] : total;
  double s = 0.0;
  if (hi > lo) {
    const int64_t cps = chunks_per_slice(cum ? cum[G] : total, slices);
    const int64_t tbase = plan.task_base[task];
    const int64_t cells = plan.task_base[task + 1] - tbase;
    const double* p = partial + tbase * (slices + G - 1) + cell;
    for (int64_t b = lo / cps; b <= (hi - 1) / cps; ++b)
      s += p[(b + g) * cells];
  }
  const float v = static_cast<float>(s);
  float* o = out + int64_t(g) * om.gstride;
  o[int64_t(i) * om.ld + (j - om.lo)] = v;
  if (om.mirror) o[int64_t(j) * om.ld + (i - om.lo)] = v;
}

// The keyed tasks' reduction, one thread per (group, map entry): the
// cell's slots over the work items of its (task, group), in item order,
// f64, one rounding; writes the entry's one place through om. A (task,
// group) with no rows gets zeros.
__global__ void wide_gram_keyed_reduce(const double* __restrict__ partial,
                                       const __grid_constant__ WidePlanArgs
                                           plan,
                                       const int64_t* __restrict__ item_cum,
                                       int G, const OutMap om,
                                       float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(G) * plan.nentries) return;
  const int g = static_cast<int>(t / plan.nentries);
  const int* e = plan.entries + 4 * (t % plan.nentries);
  const int task = e[0], cell = e[1], i = e[2], j = e[3];
  const int64_t tg = int64_t(task) * G + g;
  double s = 0.0;
  for (int64_t b = item_cum[tg]; b < item_cum[tg + 1]; ++b)
    s += partial[b * plan.max_cells + cell];
  out[int64_t(g) * om.gstride + int64_t(i) * om.ld + (j - om.lo)] =
      static_cast<float>(s);
}

// Mirrored by ring/kernels/_build.py: wide_smem_bytes.
inline size_t wide_smem_bytes(const WidePlanArgs& plan) {
  return sizeof(double) * plan.max_cells +
         sizeof(float) * (2 * size_t(plan.max_cols) * plan.rows +
                          kWideSlabInts * plan.max_slabs + plan.width +
                          2 * kWideSubs);
}

// The plan's arguments: its device tensors and its shape (host ints:
// tasks, nentries, max_cells, max_cols, max_slabs, rows, slices, the
// stage list's width). 0 or a cudaError_t.
inline int make_plan(const int* slabs, const int* warp_begin,
                     const int64_t* task_base, const int* stage_cols,
                     const int* entries, const int* shape,
                     WidePlanArgs& plan, int& slices) {
  plan = WidePlanArgs{slabs, warp_begin, task_base, stage_cols, entries,
                      shape[0], shape[1], shape[2], shape[3], shape[4],
                      shape[5], shape[7]};
  slices = shape[6];
  if (plan.tasks < 1 || plan.nentries < 1 || plan.max_cells < 1 ||
      plan.max_cells > kWideTaskBytes / 8 || plan.max_cols < 1 ||
      plan.width < plan.max_cols + 1 || plan.max_slabs < 1 ||
      plan.max_slabs > kWideMaxSlabs || plan.rows < kWideChunk ||
      plan.rows > kThreads || plan.rows % kWideChunk)
    return cudaErrorInvalidValue;
  if (wide_smem_bytes(plan) > kWideSmem) return cudaErrorInvalidValue;
  if (slices < 1 || slices > 65535) return cudaErrorInvalidValue;
  return 0;
}

// Launches K7 (Grouped = false; off, cum unused, G = 1) or K8 and the
// reduction on `stream`. partial: f64 scratch of task_base[tasks] ·
// (slices + G − 1); out: f32[G, P, P], zeroed by the caller, or with
// `window` (K7 over a window's plan) the places it names.
template <bool Grouped>
inline int launch_wide_gram(const Cols& cols, const WidePlanArgs& plan,
                            int P, int64_t n, const int64_t* off,
                            const int64_t* cum, int G, int slices,
                            const float* w, double* partial, float* out,
                            cudaStream_t stream,
                            const OutMap* window = nullptr) {
  const OutMap om = window ? *window
                           : OutMap{P, int64_t(P) * P, 0, true};
  const size_t smem = wide_smem_bytes(plan);
  cudaError_t rc = cudaFuncSetAttribute(
      wide_gram_kernel<Grouped, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  wide_gram_kernel<Grouped, false><<<dim3(plan.tasks, slices), kThreads,
                                     smem, stream>>>(
      cols, plan, w, n, off, cum, G, partial, KeyedArgs{});
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int64_t threads = int64_t(G) * plan.nentries;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  wide_gram_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      partial, plan, Grouped ? cum : nullptr,
      (n + kWideChunk - 1) / kWideChunk, G, slices, om, out);
  return cudaGetLastError();
}

// Launches the keyed tasks of a window (K7, or K8 with key.G groups) and
// their reduction on `stream`: `items` blocks (_build.keyed_items_bound;
// those past key.item_cum[tasks·G] exit), partial f64 scratch of items ·
// plan.max_cells, each entry's place written through om.
inline int launch_wide_gram_keyed(const Cols& cols, const WidePlanArgs& plan,
                                  const KeyedArgs& key, int64_t n,
                                  int64_t items, double* partial,
                                  const OutMap& om, float* out,
                                  cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(plan);
  cudaError_t rc = cudaFuncSetAttribute(
      wide_gram_kernel<false, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  if (items > 0) {
    wide_gram_kernel<false, true><<<static_cast<unsigned>(items), kThreads,
                                    smem, stream>>>(
        cols, plan, nullptr, n, nullptr, nullptr, 1, partial, key);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  const int64_t threads = int64_t(key.G) * plan.nentries;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  wide_gram_keyed_reduce<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(partial, plan, key.item_cum, key.G, om,
                                     out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit
