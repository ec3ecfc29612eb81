// K8: the grouped masked Gram for wide schemas (P > kMaxP = 88, up to
// kMaxWideP), one S_g = Zᵀ·diag(w·[id = g])·Z per group, over rows sorted
// by group, for sm_90a, plain f32 on the CUDA cores.
//
// Replaces, for P > 88, the grouped Pallas kernels of
// duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py: the unsorted
// ones (_sigma_pallas_grouped_unsorted and its _fast, _fast2, _fast3
// variants), whose entry (ring/kernels/sigma_pallas_grouped.py:
// grouped_gram) sorts the rows first here, and the sorted-slab ones
// (_sigma_pallas_grouped_padded, _fast2_padded, _fast3_padded).
//
// K8 is K7 (wide_gram.cuh) over group-sorted rows:
//
//   1. The host plans K7's regions (structurally zero ones skipped) and
//      row slices. Group g owns sorted rows off[g] .. off[g + 1], cut into
//      chunks of kWideChunk rows that never cross a group boundary; cum[g]
//      is its first chunk, cum[G] the chunk count.
//   2. blockIdx.x is a region, blockIdx.y a slice: a run of chunks_per_slice
//      consecutive chunks. A block stages and multiplies its chunks as K7
//      does, and meets the groups in order: when the group changes it
//      writes its f64 tile to the partial of (region, slice + group) and
//      starts a new one. Groups never decrease from one slice to the next,
//      so that slot is written by one block only.
//   3. grouped_wide_reduce sums each group's slots over the slices that
//      touched it, in slice order, in f64, and rounds to f32 once.
//
// K7's guarantees hold: no float atomics (bit-identical reruns), f32 sums
// span one chunk of 128 rows and everything beyond is f64 (counts exact
// past 2²⁴ rows), any n < 2³¹. Empty groups and skipped regions stay at the
// zeros the output was allocated with; rows past off[G] (ids outside
// [0, G)) are never read.
//
// What bounds it on an H100: as K7, issuing 4,096 FMAs a row per kept
// region (each row joins one group, so G does not multiply the work): at
// favorita_classify (P = 459, 26 kept regions; P = 490, 30) ~1.1e12-1.2e12
// FMA per 10M rows, ≥ ~32-37 ms at the 67 TFLOP/s f32 peak. The slices
// add one flush per group boundary they cross and (slices + G) f64
// partial tiles per region to the reduction.
#include "wide_gram.cuh"

namespace dit {
namespace {

// Chunks a slice takes, the same in the kernel and the reduction.
__host__ __device__ __forceinline__ int64_t chunks_per_slice(int64_t total,
                                                             int slices) {
  const int64_t cps = (total + slices - 1) / slices;
  return cps > 0 ? cps : 1;
}

__device__ __forceinline__ void store_tile(const double acc64[16],
                                           double* out, int ti, int tj) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      out[(4 * ti + k) * kWideTile + 4 * tj + l] = acc64[k * 4 + l];
}

// partial: per region, (slices + G) slots of kRegionEntries f64.
__global__ void __launch_bounds__(kThreads)
grouped_wide_gram_kernel(const __grid_constant__ Cols cols,
                         const __grid_constant__ Regions rg,
                         const float* __restrict__ w,
                         const int64_t* __restrict__ off,
                         const int64_t* __restrict__ cum, int G,
                         double* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [kWideChunk][kWideStride]
  float* B = A + kWideChunk * kWideStride;      // [kWideChunk][kWideStride]
  const int reg = blockIdx.x;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  const int64_t total = cum[G];
  const int64_t cps = chunks_per_slice(total, slices);
  const int64_t c0 = int64_t(slice) * cps;
  const int64_t c1 = c0 + cps < total ? c0 + cps : total;
  if (c0 >= c1) return;                  // the whole block: no barrier left
  double* slots = partial + int64_t(reg) * (slices + G) * kRegionEntries;

  // staging role, as in K7: threads 0..127 weighted rows of range I, the
  // rest unweighted rows of range J
  const bool side_a = threadIdx.x < kWideChunk;
  const int srow = threadIdx.x % kWideChunk;
  float* dst = (side_a ? A : B) + srow * kWideStride;
  const int lo = side_a ? rg.lo_i[reg] : rg.lo_j[reg];
  const float* wsrc = side_a ? w : nullptr;

  // the group of chunk c0: the last g with cum[g] ≤ c0 (skips empty ones)
  int glo = 0, ghi = G;
  while (glo < ghi) {
    const int mid = (glo + ghi + 1) / 2;
    if (cum[mid] <= c0) glo = mid; else ghi = mid - 1;
  }
  int cur = glo;

  double acc64[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc64[e] = 0.0;
  for (int64_t ch = c0; ch < c1; ++ch) {
    int g = cur;
    while (ch >= cum[g + 1]) ++g;
    if (g != cur) {
      store_tile(acc64, slots + int64_t(slice + cur) * kRegionEntries, ti, tj);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc64[e] = 0.0;
      cur = g;
    }
    // rows past the group's end stage as zeros
    stage_range_row(dst, cols, off[g] + (ch - cum[g]) * kWideChunk + srow,
                    off[g + 1], lo, wsrc);
    __syncthreads();
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    const float4* a4 = reinterpret_cast<const float4*>(A) + ti;
    const float4* b4 = reinterpret_cast<const float4*>(B) + tj;
#pragma unroll 4
    for (int r = 0; r < kWideChunk; ++r) {
      const float4 a = a4[r * (kWideStride / 4)];
      const float4 b = b4[r * (kWideStride / 4)];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[k * 4 + l] += av[k] * bv[l];
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) acc64[e] += static_cast<double>(acc[e]);
    __syncthreads();
  }
  store_tile(acc64, slots + int64_t(slice + cur) * kRegionEntries, ti, tj);
}

// One thread per (group, region entry): the group's slots over the slices
// that touched it, in slice order, f64, one rounding; writes S_g[i, j] and
// S_g[j, i] for i ≤ j < P. An empty group gets zeros.
__global__ void grouped_wide_reduce(const double* __restrict__ partial,
                                    const int64_t* __restrict__ cum, int G,
                                    int slices,
                                    const __grid_constant__ Regions rg,
                                    int P, float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t per_group = int64_t(rg.count) * kRegionEntries;
  if (t >= G * per_group) return;
  const int g = static_cast<int>(t / per_group);
  const int reg = static_cast<int>((t % per_group) / kRegionEntries);
  const int e = static_cast<int>(t % kRegionEntries);
  const int i = rg.lo_i[reg] + e / kWideTile;
  const int j = rg.lo_j[reg] + e % kWideTile;
  if (i >= P || j >= P || i > j) return;
  double s = 0.0;
  if (cum[g + 1] > cum[g]) {
    const int64_t cps = chunks_per_slice(cum[G], slices);
    const int64_t b0 = cum[g] / cps, b1 = (cum[g + 1] - 1) / cps;
    const double* p =
        partial + int64_t(reg) * (slices + G) * kRegionEntries + e;
    for (int64_t b = b0; b <= b1; ++b) s += p[(b + g) * kRegionEntries];
  }
  const float v = static_cast<float>(s);
  float* o = out + int64_t(g) * P * P;
  o[int64_t(i) * P + j] = v;
  o[int64_t(j) * P + i] = v;
}

}  // namespace
}  // namespace dit

static_assert(dit::kThreads == 2 * dit::kWideChunk,
              "K8 stages one row of each side per thread");

extern "C" {

// Launches K8 and its reduction on `stream` over rows sorted by group:
// off i64[G + 1] (group g's rows are off[g] .. off[g + 1]), cum i64[G + 1]
// (cum[g] = Σ_{h<g} ceil((off[h+1] − off[h]) / kWideChunk) chunks). region_lo: 2·nregions ints, the (lo_i, lo_j) of each planned
// region; partial: f64 scratch of nregions · (slices + G) ·
// dit_wide_region_entries(); out: f32[G, P, P], zeroed. Returns 0 or a
// cudaError_t.
int dit_grouped_wide_gram(const void* const* x_cols, int d,
                          const void* const* code_cols, const int* cat_sizes,
                          int c, const float* w, const int64_t* off,
                          const int64_t* cum, int G, int64_t n, int P,
                          const int* region_lo, int nregions, int slices,
                          double* partial, float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP)) return rc;
  if (G < 1) return cudaErrorInvalidValue;
  Regions rg;
  if (int rc = make_regions(region_lo, nregions, P, slices, rg)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = wide_smem_bytes();
  cudaError_t rc = cudaFuncSetAttribute(
      grouped_wide_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  grouped_wide_gram_kernel<<<dim3(rg.count, slices), kThreads, smem, s>>>(
      cols, rg, w, off, cum, G, partial);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int64_t threads = int64_t(G) * rg.count * kRegionEntries;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  grouped_wide_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, cum, G, slices, rg, P, out);
  return cudaGetLastError();
}

}  // extern "C"
