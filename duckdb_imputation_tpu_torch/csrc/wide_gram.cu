// K7's entry points: the masked Gram over per-column inputs for P > 88,
// whole up to kMaxWideP or over a column window up to kMaxWindowP (kernel
// and design in wide_gram.cuh).
#include "wide_gram.cuh"

extern "C" {

// Launches K7 and its reduction on `stream`. slabs, warp_begin,
// task_base, stage_cols and entries: the plan (ring/kernels/_build.py:
// WidePlan) in device memory; shape: its sizes and the slices on the host
// (WidePlan.shape_ints); partial: f64 scratch of task_base[tasks] ·
// slices; out: f32[P, P], zeroed. Returns 0 or a cudaError_t.
int dit_wide_gram(const void* const* x_cols, int d,
                  const void* const* code_cols, const int* cat_sizes, int c,
                  const float* w, int64_t n, int P, const int* slabs,
                  const int* warp_begin, const int64_t* task_base,
                  const int* stage_cols, const int* entries,
                  const int* shape, double* partial, float* out,
                  void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP)) return rc;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
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
                         int c, const float* w, int64_t n, int P, int lo,
                         int width, int64_t ld, const int* slabs,
                         const int* warp_begin, const int64_t* task_base,
                         const int* stage_cols, const int* entries,
                         const int* shape, double* partial, float* out,
                         void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWindowP)) return rc;
  if (lo < 0 || width < 1 || lo > P - width || ld < width)
    return cudaErrorInvalidValue;
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const OutMap om{ld, 0, lo, false};
  return launch_wide_gram<false>(cols, plan, P, n, nullptr, nullptr, 1,
                                 slices, w, partial, out,
                                 static_cast<cudaStream_t>(stream), &om);
}

}  // extern "C"
