// K1: the masked Gram over per-column inputs, S = Zᵀ·diag(w)·Z, P ≤ 88, for
// sm_90a: on the tensor cores (tc_gram.cuh) for a schema whose S is one
// output tile there (P ≤ 21 and 1 + 3d + V ≤ 32: BASELINE config 5), on
// the CUDA cores (masked_gram_kernel below) for any other.
//
// Replaces the Pallas kernels of duckdb_imputation_tpu/ring/kernels/
// sigma_pallas.py that the MICE loops aggregate with:
// sigma_pallas_fast3_cols (_sigma_fast3_cols_kernel) and
// sigma_pallas_fast2_cols (_sigma_fast2_cols_kernel), dispatched by
// sigma_pallas_fast_cols_padded, and through the stacked entry point the
// stacked ones (sigma_pallas, _fast, _fast2, _fast3). Those split each
// value into bf16 parts because the TPU's matrix unit takes bf16; here
// the same idea feeds Hopper's tensor cores, with three parts (exact, not
// ~2⁻¹⁶) and any weights (not only binary ones).
//
// What bounds it on an H100: one row reads 4·d + 4·c + 4 bytes (28 at the
// BASELINE schema d=4, c=2), so at 3.35 TB/s the device-memory floor is
// ~0.08 ms per 10M rows. The tensor-core design, its split, the flush
// interval and what bounds it are in tc_gram.cuh, the CUDA-core one in
// gram_common.cuh; measured (tools/k1_variants.py, tools/k1_nb_times.py,
// chip_smoke.py) in PERF.md.
#include "tc_gram.cuh"

namespace dit {
namespace {

// The CUDA-core route, for schemas past the tensor-core tile: each thread
// owns a 4×4 tile of S (gram_common.cuh), f32 products, the rows of a
// 256-row chunk staged densely in shared memory.
__global__ void __launch_bounds__(kThreads)
masked_gram_kernel(const __grid_constant__ Cols cols,
                   const __grid_constant__ Geom gm, const float* __restrict__ w,
                   double* __restrict__ partial) {
  extern __shared__ float smem[];
  float* zs = smem;                      // [kChunk][PS]
  float* ws = smem + kChunk * gm.PS;     // [kChunk]
  const TileOwner own(gm);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;

  const int64_t nchunks = (gm.n + kChunk - 1) / kChunk;
  for (int64_t ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int64_t row = ch * kChunk + threadIdx.x;
    float* zr = zs + threadIdx.x * gm.PS;
    if (row < gm.n) {
      build_row(zr, cols, row, gm.PS);
      ws[threadIdx.x] = w[row];
    } else {
      zero_row(zr, gm.PS);
      ws[threadIdx.x] = 0.0f;
    }
    __syncthreads();
    if (own.active) accumulate_chunk(zs, ws, gm, own.i0, own.j0, own.g, acc);
    __syncthreads();
  }
  write_block_partial(acc, own.active, own.t, own.g, smem, gm, partial);
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K1 on the tensor cores and its cross-block reduction on
// `stream`, for a schema that tc_fits (_build.tc_fits). partial: f64
// scratch of 21 · 21 · nblocks; out: f32[P, P]. Returns 0 or a cudaError_t.
int dit_masked_gram(const void* const* x_cols, int d,
                    const void* const* code_cols, const int* cat_sizes,
                    int c, const float* w, int64_t n, int P,
                    double* partial, int nblocks, float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (!tc_fits(d, P)) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  return launch_tc_gram(cols, P, w, n, partial, nblocks, out,
                        static_cast<cudaStream_t>(stream));
}

// K1's CUDA-core route and its cross-block reduction on `stream`.
// partial: f64 scratch of dit_gram_entries(P) · nblocks; out: f32[P, P].
// Returns 0 or a cudaError_t.
int dit_masked_gram_cores(const void* const* x_cols, int d,
                          const void* const* code_cols, const int* cat_sizes,
                          int c, const float* w, int64_t n, int P,
                          double* partial, int nblocks, float* out,
                          void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Geom gm = make_geom(P, n);
  const size_t smem = sizeof(float) * gram_smem_floats(gm);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        masked_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  auto s = static_cast<cudaStream_t>(stream);
  masked_gram_kernel<<<nblocks, kThreads, smem, s>>>(cols, gm, w, partial);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  launch_gram_reduce(partial, nblocks, gm, out, s);
  return cudaGetLastError();
}

// f64 entries of one block's partial of the CUDA-core Gram (gram_common.cuh)
// for sigma size P: K1's CUDA-core route, K2, K4 and K5.
int dit_gram_entries(int P) { return dit::gram_entries(dit::make_geom(P, 0)); }

const char* dit_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
