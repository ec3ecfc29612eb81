// K7's entry points: the masked Gram over per-column inputs for P > 88,
// whole up to kMaxWideP or over a column window up to kMaxWindowP, the
// window's keyed tasks by dit_wide_gram_keyed (kernel and design in
// wide_gram.cuh).
#include "wide_gram.cuh"

extern "C" {

// Launches K7 and its reduction on `stream`. slabs, warp_begin,
// task_base, stage_cols and entries: the plan (ring/kernels/_build.py:
// WidePlan) in device memory; shape: its sizes and the slices on the host
// (WidePlan.shape_ints); partial: f64 scratch of task_base[tasks] ·
// slices; out: f32[P, P], zeroed. far: the columns' device table
// (gram_common.cuh: Cols), needed past kInlineCols columns of a kind,
// else nullptr. Returns 0 or a cudaError_t.
int dit_wide_gram(const void* const* x_cols, int d,
                  const void* const* code_cols, const int* cat_sizes, int c,
                  const int64_t* far, const float* w, int64_t n, int P,
                  const int* slabs, const int* warp_begin,
                  const int64_t* task_base, const int* stage_cols,
                  const int* entries,
                  const int* shape, double* partial, float* out,
                  void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP, far))
    return rc;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  return launch_wide_gram<false>(cols, plan, P, n, nullptr, nullptr, 1,
                                 slices, w, partial, out,
                                 static_cast<cudaStream_t>(stream));
}

// Launches K7 over a window's plan (ring/kernels/_build.py: window_plan)
// and its reduction on `stream`: S[:, lo:lo + width] of any P ≤
// kMaxWindowP, written to out[i·ld + j − lo] for the map's places (i, j);
// out f32[P, ld] (ld ≥ width), zeroed by the caller. Other arguments as
// dit_wide_gram. Returns 0 or a cudaError_t.
int dit_wide_gram_window(const void* const* x_cols, int d,
                         const void* const* code_cols, const int* cat_sizes,
                         int c, const int64_t* far, const float* w,
                         int64_t n, int P, int lo, int width, int64_t ld,
                         const int* slabs, const int* warp_begin,
                         const int64_t* task_base,
                         const int* stage_cols, const int* entries,
                         const int* shape, double* partial, float* out,
                         void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWindowP, far))
    return rc;
  if (lo < 0 || width < 1 || lo > P - width || ld < width)
    return cudaErrorInvalidValue;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  const OutMap om{ld, 0, lo, false};
  return launch_wide_gram<false>(cols, plan, P, n, nullptr, nullptr, 1,
                                 slices, w, partial, out,
                                 static_cast<cudaStream_t>(stream), &om);
}

// Launches the keyed tasks of a window (_build.py: KeyedPlan; K7's, or
// K8's with G groups) and their reduction on `stream`: each task walks its
// key range's rows of a copy of the columns ordered by its key column
// (window_order): rows (rows of `stride` ints), key_off, key_chunks,
// rows_of and off_of as KeyedArgs;
// task_keys the plan's i32[tasks][kKeyedTaskInts]; item_cum
// i64[tasks·G + 1] its work items (keyed_items), items the grid
// (_build.keyed_items_bound) and item_chunks the blocks of chunks they
// are cut at. The plan
// (slabs .. shape, its slices 1) as dit_wide_gram_window; partial f64
// scratch of items · max_cells; each map entry (i, j) of group g written
// to out[g·gstride + i·ld + j − lo], out zeroed by the caller. Returns 0
// or a cudaError_t.
int dit_wide_gram_keyed(const int* cat_sizes, int d, int c,
                        const int64_t* far, int64_t n,
                        int P, int lo, int width, int64_t ld,
                        int64_t gstride, const float* rows, int stride,
                        const int64_t* key_off, const int64_t* key_chunks,
                        const int64_t* rows_of, const int64_t* off_of,
                        const int* task_keys, const int64_t* item_cum, int G,
                        int item_chunks, int64_t items, const int* slabs,
                        const int* warp_begin, const int64_t* task_base,
                        const int* stage_cols, const int* entries,
                        const int* shape, double* partial, float* out,
                        void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWindowP, far))
    return rc;
  if (G < 1 || lo < 0 || width < 1 || lo > P - width || ld < width ||
      (G > 1 && gstride < int64_t(P) * ld) || item_chunks < 1 || items < 0 ||
      items > 0x7fffffff || stride < 1 + d + c)
    return cudaErrorInvalidValue;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  if (int64_t(plan.tasks) * G >= 0x7fffffff) return cudaErrorInvalidValue;
  Cols cols{};            // the sizes alone: the rows come from `rows`
  cols.d = d;
  cols.c = c;
  cols.far = far;
  for (int j = 0, o = 1 + d; j < c && j < kInlineCols;
       o += cat_sizes[j], ++j) {
    cols.size[j] = cat_sizes[j];
    cols.off[j] = o;
  }
  const KeyedArgs key{rows,     key_off,  key_chunks, rows_of,     off_of,
                      task_keys, item_cum, G,          item_chunks, stride};
  return launch_wide_gram_keyed(cols, plan, key, n, items, partial,
                                OutMap{ld, gstride, lo, false}, out,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
