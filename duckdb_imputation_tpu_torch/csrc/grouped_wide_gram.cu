// K8: the grouped masked Gram for wide schemas (P > kMaxP = 88, up to
// kMaxWideP), one S_g = Zᵀ·diag(w·[id = g])·Z per group, over rows sorted
// by group, for sm_90a.
//
// Replaces, for P > 88, the grouped Pallas kernels of
// duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py: the unsorted
// ones (_sigma_pallas_grouped_unsorted and its _fast, _fast2, _fast3
// variants), whose entry (ring/kernels/sigma_pallas_grouped.py:
// grouped_gram) sorts the rows first here, and the sorted-slab ones
// (_sigma_pallas_grouped_padded, _fast2_padded, _fast3_padded).
//
// K8 is K7 (wide_gram.cuh: the same plan of tasks and slabs over S's
// nonzeros, the same kernel) over group-sorted rows:
//
//   1. Group g owns sorted rows off[g] .. off[g + 1], cut into chunks of
//      kWideChunk rows that never cross a group boundary; cum[g] is its
//      first chunk, cum[G] the chunk count.
//   2. blockIdx.x is a task, blockIdx.y a slice: a run of chunks_per_slice
//      consecutive chunks. Each warp meets the groups in order: when the
//      group changes it writes its slabs' cells to the partial of (task,
//      slice + group) and starts again from zero. Groups never decrease
//      from one slice to the next, so that slot is written by one block.
//   3. wide_gram_reduce sums each group's slots over the slices that
//      touched it, in slice order, in f64, and rounds to f32 once.
//
// K7's guarantees hold: no float atomics (bit-identical reruns), f32 sums
// span at most 32 rows and everything beyond is f64 (counts exact past 2²⁴
// rows), any n < 2³¹. Empty groups and the zero structure stay at the
// zeros the output was allocated with; rows past off[G] (ids outside
// [0, G)) are never read.
//
// Past kMaxWideP (dit_grouped_wide_gram_window, any P ≤ kMaxWindowP) the
// caller runs it once a column window of S, over the window's residual
// plan (_build.keyed_window_plan, as dit_wide_gram_window), its partial
// sized for that plan, each group's places S_g[i, j], lo ≤ j < lo +
// width, written through the window's OutMap with the group stride of out
// f32[G, P, ld]; the window's keyed tasks run in the keyed kernel
// (wide_gram.cu: dit_wide_gram_keyed, G groups) over the rows ordered
// once a call by (group, code) of each keyed column, a work item within
// one (task, group), so no group boundary is crossed.
//
// What bounds it on an H100: as K7; each row joins one group, so G does
// not multiply the work. A group change costs a warp one flush of its
// cells, and the reduction reads (slices + G − 1) slots of every cell.
#include "wide_gram.cuh"

extern "C" {

// Launches K8 and its reduction on `stream` over rows sorted by group:
// off i64[G + 1] (group g's rows are off[g] .. off[g + 1]), cum i64[G + 1]
// (cum[g] = Σ_{h<g} ceil((off[h+1] − off[h]) / kWideChunk) chunks). The
// plan and shape as dit_wide_gram; partial: f64 scratch of
// task_base[tasks] · (slices + G − 1); out: f32[G, P, P], zeroed. Returns
// 0 or a cudaError_t.
int dit_grouped_wide_gram(const void* const* x_cols, int d,
                          const void* const* code_cols, const int* cat_sizes,
                          int c, const int64_t* far, const float* w,
                          const int64_t* off, const int64_t* cum, int G,
                          int64_t n, int P,
                          const int* slabs, const int* warp_begin,
                          const int64_t* task_base, const int* stage_cols,
                          const int* entries, const int* shape,
                          double* partial, float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP, far))
    return rc;
  if (G < 1) return cudaErrorInvalidValue;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  return launch_wide_gram<true>(cols, plan, P, n, off, cum, G, slices, w,
                                partial, out,
                                static_cast<cudaStream_t>(stream));
}

// Launches K8 over a window's plan (ring/kernels/_build.py: window_plan)
// and its reduction on `stream`: S_g[:, lo:lo + width] of every group g, any
// P ≤ kMaxWindowP, written to out[g·gstride + i·ld + j − lo] for the map's
// places (i, j); out zeroed by the caller (e.g. f32[G, P, P] at its column
// lo: ld = P, gstride = P·P). partial: f64 scratch of the window plan's
// task_base[tasks] · (slices + G − 1). Other arguments as
// dit_grouped_wide_gram. Returns 0 or a cudaError_t.
int dit_grouped_wide_gram_window(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const int64_t* far, const float* w,
    const int64_t* off, const int64_t* cum, int G, int64_t n, int P, int lo,
    int width, int64_t ld, int64_t gstride, const int* slabs,
    const int* warp_begin, const int64_t* task_base, const int* stage_cols,
    const int* entries, const int* shape, double* partial, float* out,
    void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWindowP, far))
    return rc;
  if (G < 1 || lo < 0 || width < 1 || lo > P - width || ld < width ||
      gstride < int64_t(P) * ld)
    return cudaErrorInvalidValue;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  const OutMap om{ld, gstride, lo, false};
  return launch_wide_gram<true>(cols, plan, P, n, off, cum, G, slices, w,
                                partial, out,
                                static_cast<cudaStream_t>(stream), &om);
}

}  // extern "C"
