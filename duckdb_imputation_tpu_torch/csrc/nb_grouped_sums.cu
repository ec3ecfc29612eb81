// K6 and K6w: the grouped naive-Bayes sums, for sm_90a: per group g the
// sums over its rows of w·F, F = [1 ‖ x ‖ x² ‖ onehot(codes)] (F = 1 + 2d +
// V features), the whole of an NB aggregate. G = 1 is the ungrouped one.
// One kernel and one launch for any G and any F: K6 and K6w are the names
// of its narrow (F ≤ 256) and wide uses.
//
// Replaces the Pallas kernel of duckdb_imputation_tpu/ring/kernels/
// nb_pallas.py, _nb_grouped_pallas, with both of its bodies: _nb_kernel
// (general weights) and _nb_kernel_fast (binary weights through a 3-way
// bf16 split of x and x², for the TPU's matrix unit). Here the sums are
// f32 within 32 rows and f64 beyond, for any weights.
//
// Keyed sums over each row's nonzeros. A row adds 1 + 2d values (w, w·x_a,
// w·(x_a·x_a)) under the key g, and w under the key (g, code_j) for each
// categorical column j: 1 + 3d + c terms, not F. The tables are D, G × (1 +
// 2d) f64 cells, and K_j, G × V_j; the host (ring/kernels/_build.py:
// nb_plan) cuts them by group range into slabs (D also into runs of
// terms, as many a slab as its cost model of the busiest warp picks: 1 at
// favorita_classify's family label, 3 at config 3; a row of K_j longer
// than a task, V_j > 8,192, by code range, a slab of kind kNbSlabCodes
// for each range of each group) and the slabs into tasks of at most
// kWideTaskBytes of shared memory, as K7's plan does.
//
//   1. blockIdx.x is a task, blockIdx.y a row slice: a run of consecutive
//      chunks of 32 rows. The block stages up to 256 rows a step with
//      cp.async into one of two buffers (w, the group ids, x if the task
//      has the D slab, its code columns), the next step's copies in flight.
//   2. Each slab belongs to one warp, which walks every staged chunk, one
//      row a lane, two chunks at once: __match_any_sync finds the lanes of
//      one key, their values are summed in f32 by pointer jumping
//      (wide_gram.cuh: PeerList), and the lowest lane adds the sums to the
//      f64 table. A row whose id lies outside the slab's groups, or whose
//      code lies outside [0, V_j), has key −1 and adds nothing.
//   3. A warp writes its cells to the (task, slice) partial; nb_reduce sums
//      each cell's slices in f64 (a warp a cell, lanes over the slices, a
//      fixed shuffle tree), rounds to f32 once and writes it to its place
//      in out f32[G, F] (the plan's map).
// Every cell is written only by the warp that owns its slab, no atomics:
// reruns are bit-identical; counts are exact (f32 over at most 32 rows).
//
// What bounds it on an H100: one read of the inputs, 4·d + 4·c + 8 bytes a
// row (56 at BASELINE config 3, 52 at favorita_classify), ~0.16 ms per 10M
// rows; the work is the chains of match, shuffles and table updates of
// each slab a chunk, so it is bound by their latency on the busiest warp,
// and each task reads the rows again (PERF.md; tools/nb_variants.py).
#include "wide_gram.cuh"

namespace dit {
namespace {

constexpr int kNbPlanInts = 9;   // ints of the plan's shape
constexpr int kNbSlabCodes = 3;  // slab kind: codes u_lo .. u_hi of K_j's row g

// The host's plan (ring/kernels/_build.py: NbPlan).
struct NbPlanArgs {
  // [S][kWideSlabInts]: (kSlabD, v_lo, g_lo, g_hi, v_hi, off, ...),
  // (kSlabK, j, g_lo, g_hi, 0, off, ...) or (kNbSlabCodes, j, g, u_lo,
  // u_hi, off, ...), field 6 the stage slot the slab reads: a D slab's
  // x_a lies at slot field 6 + a, a K or codes slab's column j at field
  // 6; field 7 a K slab's V_j (_build.py: NbPlan.device_slabs)
  const int* slabs;
  const int* warp_begin;     // [tasks · kWideWarps + 1]
  const int64_t* task_base;  // [tasks + 1]: each task's first flat cell
  // [tasks][width]: nx, nc, the numeric then the code columns the task
  // stages (ascending each)
  const int* stage_cols;
  const int* out_index;      // [cells]: the flat index in out [G, F]
  int tasks, cells, max_cells, max_cols, max_slabs, rows, slices, G, width;
};

// Mirrored by ring/kernels/_build.py: wide_smem_bytes.
inline size_t nb_smem_bytes(const NbPlanArgs& plan) {
  return sizeof(double) * plan.max_cells +
         sizeof(float) * (2 * plan.max_cols * plan.rows +
                          kWideSlabInts * plan.max_slabs + plan.width +
                          2 * kWideSubs);
}

// A D term of a staged row (w at rows[r], x_a at rows[(sx + a)·R + r]):
// v = 0 → w; 1 + a → w·x_a; 1 + d + a → w·(x_a·x_a).
__device__ __forceinline__ float nb_term(int v, int d, int sx,
                                         const float* rows, int R, int lane) {
  const float w = rows[lane];
  if (v == 0) return w;
  const float x = rows[(sx + (v - 1) % d) * R + lane];
  return v <= d ? w * x : w * (x * x);
}

// One warp's update of a D slab, terms v_lo .. v_hi, from two chunks
// (key1 = −1 for none): each key's terms summed in f32 over its lanes,
// added to the f64 table by its first lane, chunk 0's before chunk 1's.
// Four terms at a time: their sums are independent chains of shuffles.
__device__ __forceinline__ void nb_add_d(double* table, int key0, int key1,
                                         int v_lo, int v_hi, int d, int sx,
                                         const float* rows0,
                                         const float* rows1, int R,
                                         int lane) {
  const unsigned p0 = __match_any_sync(0xffffffffu, key0);
  const unsigned p1 = __match_any_sync(0xffffffffu, key1);
  const bool lead0 = key0 >= 0 && __ffs(p0) - 1 == lane;
  const bool lead1 = key1 >= 0 && __ffs(p1) - 1 == lane;
  const PeerList l0(p0, lane), l1(p1, lane);
  const int vals = v_hi - v_lo;
  double* t0 = table + key0 * vals - v_lo;
  double* t1 = table + key1 * vals - v_lo;
  for (int v4 = v_lo; v4 < v_hi; v4 += 4) {
    float s0[4], s1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (v4 + k < v_hi) {
        s0[k] = l0.suffix_sum(nb_term(v4 + k, d, sx, rows0, R, lane));
        s1[k] = l1.suffix_sum(nb_term(v4 + k, d, sx, rows1, R, lane));
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (v4 + k < v_hi) {
        if (lead0) t0[v4 + k] += static_cast<double>(s0[k]);
        if (lead1) t1[v4 + k] += static_cast<double>(s1[k]);
      }
  }
}

// Far: a schema past kInlineCols columns of a kind, its columns read
// through Cols' accessors and a D slab's terms at the stage slots of its
// record; else the columns straight from the parameter and, as every task
// with a D slab then stages every numeric column (_build.py: _nb_stage),
// x_a at slot 2 + a.
template <bool Far>
__global__ void __launch_bounds__(kThreads)
nb_kernel(const __grid_constant__ Cols cols,
          const __grid_constant__ NbPlanArgs plan, const float* __restrict__ w,
          const int32_t* __restrict__ gid, int64_t n,
          double* __restrict__ partial) {
  extern __shared__ double nb_smem[];
  const int task = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = plan.rows, subs = R / kWideChunk, d = cols.d;
  const int64_t tbase = plan.task_base[task];
  const int cells = static_cast<int>(plan.task_base[task + 1] - tbase);
  const int sb = plan.warp_begin[task * kWideWarps];
  const int nslabs = plan.warp_begin[(task + 1) * kWideWarps] - sb;
  const int* tcols = plan.stage_cols + int64_t(task) * plan.width;
  const int xcols = tcols[0], ncodes = tcols[1];

  double* table = nb_smem;                                    // [cells]
  float* stage = reinterpret_cast<float*>(nb_smem + plan.max_cells);
  int* slabs = reinterpret_cast<int*>(stage + 2 * plan.max_cols * R);
  int* scol = slabs + plan.max_slabs * kWideSlabInts;  // [xcols + ncodes]

  for (int e = tid; e < cells; e += kThreads) table[e] = 0.0;
  for (int e = tid; e < nslabs * kWideSlabInts; e += kThreads)
    slabs[e] = plan.slabs[sb * kWideSlabInts + e];
  for (int q = tid; q < xcols + ncodes; q += kThreads) scol[q] = tcols[2 + q];
  const int* code_col = scol + xcols;
  const int cbase = 2 + xcols;                  // stage slot of code 0
  __syncthreads();

  const int64_t total = (n + kWideChunk - 1) / kWideChunk;
  const int64_t cps = chunks_per_slice(total, slices);
  const int64_t c0 = int64_t(slice) * cps;
  const int64_t c1 = c0 + cps < total ? c0 + cps : total;
  if (c0 >= c1) return;                         // the whole block
  const int steps = static_cast<int>((c1 - c0 + subs - 1) / subs);

  // thread tid < R copies row `lane` of chunk c0 + step·subs + tid / 32
  auto stage_step = [&](int step) {
    float* buf = stage + (step & 1) * plan.max_cols * R + tid;
    if (tid < R) {
      const int64_t ch = c0 + int64_t(step) * subs + tid / kWideChunk;
      const int64_t row = ch * kWideChunk + lane;
      const bool valid = ch < c1 && row < n;
      if (w) stage4(buf, w + row, valid, 0.0f);
      else *buf = valid ? 1.0f : 0.0f;       // no weights: all ones
      stage4(buf + R, gid + row, valid, __int_as_float(-1));
      if constexpr (!Far) {   // every numeric column: scol[j] = j
        for (int j = 0; j < xcols; ++j)
          stage4(buf + (2 + j) * R, cols.x[j] + row, valid, 0.0f);
        for (int q = 0; q < ncodes; ++q)
          stage4(buf + (cbase + q) * R, cols.code[code_col[q]] + row, valid,
                 __int_as_float(-1));
      } else {
        for (int j = 0; j < xcols; ++j)
          stage4(buf + (2 + j) * R, cols.xp(scol[j]) + row, valid, 0.0f);
        for (int q = 0; q < ncodes; ++q)
          stage4(buf + (cbase + q) * R, cols.cp(code_col[q]) + row, valid,
                 __int_as_float(-1));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int s0 = plan.warp_begin[task * kWideWarps + warp] - sb;
  const int s1 = plan.warp_begin[task * kWideWarps + warp + 1] - sb;
  const int lo_cell = s0 < s1 ? slabs[s0 * kWideSlabInts + 5] : 0;
  int hi_cell = lo_cell;
  if (s0 < s1) {
    const int* sl = slabs + (s1 - 1) * kWideSlabInts;
    hi_cell = sl[5] + (sl[0] == kSlabD   ? (sl[3] - sl[2]) * (sl[4] - sl[1])
                       : sl[0] == kSlabK ? (sl[3] - sl[2]) * sl[7]
                                         : sl[4] - sl[3]);
  }

  stage_step(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage_step(step + 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* buf = stage + (step & 1) * plan.max_cols * R;
    const int64_t left = c1 - (c0 + int64_t(step) * subs);
    const int nsub = left < subs ? static_cast<int>(left) : subs;
    for (int k = 0; k < nsub && s0 < s1;) {
      const bool pair = k + 1 < nsub;
      const float* rows0 = buf + k * kWideChunk;
      const float* rows1 = pair ? rows0 + kWideChunk : rows0;
      const int g0 = reinterpret_cast<const int*>(rows0)[R + lane];
      const int g1 = reinterpret_cast<const int*>(rows1)[R + lane];
      const int* codes0 = reinterpret_cast<const int*>(rows0);
      const int* codes1 = reinterpret_cast<const int*>(rows1);
      for (int s = s0; s < s1; ++s) {
        const int* sl = slabs + s * kWideSlabInts;
        double* t = table + sl[5];
        const int kind = sl[0], glo = sl[2];
        const int ghi = kind == kNbSlabCodes ? glo + 1 : sl[3];
        const bool in0 = g0 >= glo && g0 < ghi;
        const bool in1 = pair && g1 >= glo && g1 < ghi;
        if (kind == kSlabD) {
          nb_add_d(t, in0 ? g0 - glo : -1, in1 ? g1 - glo : -1, sl[1], sl[4],
                   d, Far ? sl[6] : 2, rows0, rows1, R, lane);
        } else {   // codes u_lo .. u_hi of K_j's rows glo .. ghi
          const int ulo = kind == kSlabK ? 0 : sl[3];
          const int uhi = kind == kSlabK ? sl[7] : sl[4];
          const int q = sl[6] * R + lane;
          const int v0 = codes0[q], v1 = codes1[q], vw = uhi - ulo;
          add_keyed(t,
                    in0 && v0 >= ulo && v0 < uhi ? (g0 - glo) * vw + v0 - ulo
                                                 : -1,
                    in1 && v1 >= ulo && v1 < uhi ? (g1 - glo) * vw + v1 - ulo
                                                 : -1,
                    1, rows0, rows1, R, lane);
        }
        __syncwarp();
      }
      k += pair ? 2 : 1;
    }
    __syncthreads();   // the buffer is restaged two steps on
  }
  double* o = partial + tbase * slices + int64_t(slice) * cells;
  for (int e = lo_cell + lane; e < hi_cell; e += 32) o[e] = table[e];
}

// One warp per cell of the plan: its task's slices that held rows, lanes
// striding over them, then a fixed shuffle tree; f64 throughout, one
// rounding, to the cell's place in out.
__global__ void nb_reduce(const double* __restrict__ partial,
                          const __grid_constant__ NbPlanArgs plan,
                          int64_t total, float* __restrict__ out) {
  const int64_t cell = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cell >= plan.cells) return;
  int lo = 0, hi = plan.tasks - 1;     // the task: last t, task_base[t] ≤ cell
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (plan.task_base[mid] <= cell) lo = mid; else hi = mid - 1;
  }
  const int64_t tbase = plan.task_base[lo];
  const int64_t cells = plan.task_base[lo + 1] - tbase;
  const int64_t cps = chunks_per_slice(total, plan.slices);
  const int64_t used = (total + cps - 1) / cps;
  const double* p = partial + tbase * plan.slices + (cell - tbase);
  double s = 0.0;
  for (int64_t b = lane; b < used; b += 32) s += p[b * cells];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[plan.out_index[cell]] = static_cast<float>(s);
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches the NB kernel (K6/K6w) and its reduction on `stream` for G
// groups; rows with other ids add nothing; w == nullptr: weights of one;
// far: the columns' device table (gram_common.cuh: Cols), needed past
// kInlineCols columns of a kind, else nullptr.
// Plan: NbPlan's tensors and its
// shape (kNbPlanInts host ints: tasks, cells, max_cells, max_cols,
// max_slabs, rows, slices, G, the stage list's width). partial: f64
// scratch of cells · slices; out: f32[G, F]. Returns 0 or a cudaError_t.
int dit_nb_grouped_sums(const void* const* x_cols, int d,
                        const void* const* code_cols, const int* cat_sizes,
                        int c, const int64_t* far, const float* w,
                        const int32_t* gid, int64_t n,
                        const int* slabs, const int* warp_begin,
                        const int64_t* task_base, const int* stage_cols,
                        const int* out_index, const int* shape,
                        double* partial, float* out, void* stream) {
  using namespace dit;
  if (d < 0 || c < 0 || ((d > kInlineCols || c > kInlineCols) && !far))
    return cudaErrorInvalidValue;
  for (int j = 0; j < c; ++j)
    if (cat_sizes[j] < 0) return cudaErrorInvalidValue;
  if (n < 0 || n >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const NbPlanArgs plan{slabs, warp_begin, task_base, stage_cols, out_index,
                        shape[0], shape[1], shape[2], shape[3], shape[4],
                        shape[5], shape[6], shape[7], shape[8]};
  if (plan.tasks < 1 || plan.cells < 1 || plan.max_cells < 1 ||
      plan.max_cells > kWideTaskBytes / 8 || plan.max_cols < 2 ||
      plan.width < plan.max_cols || plan.max_slabs < 1 ||
      plan.max_slabs > kWideMaxSlabs || plan.rows < kWideChunk ||
      plan.rows > kThreads || plan.rows % kWideChunk || plan.slices < 1 ||
      plan.slices > 65535 || plan.G < 1)
    return cudaErrorInvalidValue;
  const size_t smem = nb_smem_bytes(plan);
  if (smem > kWideSmem) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  auto s = static_cast<cudaStream_t>(stream);
  const auto kernel = far ? nb_kernel<true> : nb_kernel<false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3(plan.tasks, plan.slices), kThreads, smem, s>>>(
      cols, plan, w, gid, n, partial);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int64_t total = (n + kWideChunk - 1) / kWideChunk;
  const int64_t blocks = (int64_t(plan.cells) * 32 + kThreads - 1) / kThreads;
  nb_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(partial, plan,
                                                              total, out);
  return cudaGetLastError();
}

}  // extern "C"
