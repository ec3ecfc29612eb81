// K7's entry point: the masked Gram over per-column inputs for P > 88
// (kernel and design in wide_gram.cuh).
#include "wide_gram.cuh"

static_assert(dit::kThreads == 2 * dit::kWideChunk,
              "K7 stages one row of each side per thread");

extern "C" {

// Launches K7 and its reduction on `stream`. region_lo: 2·nregions ints,
// the (lo_i, lo_j) of each planned region; partial: f64 scratch of
// nregions · slices · dit_wide_region_entries(); out: f32[P, P], zeroed.
// Returns 0 or a cudaError_t.
int dit_wide_gram(const void* const* x_cols, int d,
                  const void* const* code_cols, const int* cat_sizes, int c,
                  const float* w, int64_t n, int P, const int* region_lo,
                  int nregions, int slices, double* partial, float* out,
                  void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP)) return rc;
  Regions rg;
  if (int rc = make_regions(region_lo, nregions, P, slices, rg)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  return launch_wide_gram(cols, rg, P, n, slices, w, partial, out,
                          static_cast<cudaStream_t>(stream));
}

// f64 entries of one (region, slice) partial.
int dit_wide_region_entries() { return dit::kRegionEntries; }

}  // extern "C"
