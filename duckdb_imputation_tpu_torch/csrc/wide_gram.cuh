// K7: the masked Gram for wide schemas (P > kMaxP = 88, up to kMaxWideP),
// S = Zᵀ·diag(w)·Z with Z = [1 ‖ x ‖ onehot(codes)], for sm_90a, plain f32
// on the CUDA cores. Included by wide_gram.cu (the Gram alone) and by
// fused_impute_aggregate.cu (the Gram of K2w, the wide fused pass).
//
// Replaces, for P > 88, the Pallas kernels of duckdb_imputation_tpu/ring/
// kernels/sigma_pallas.py that fall to pack = 1 and a wider tile there:
// sigma_pallas, sigma_pallas_fast (the v1 wide fallback of
// sigma_pallas_fast_padded), sigma_pallas_fast2(_cols) and
// sigma_pallas_fast3(_cols).
//
// K1 gives each thread one 4×4 tile of S's whole upper triangle, which
// caps P at 88 (253 tiles ≤ 256 threads). K7 tiles S over the grid:
//
//   1. S's upper triangle is cut into 64×64 regions (I ≤ J). The host
//      plans the list of regions and drops those that are structurally
//      zero: two distinct 64-wide ranges inside the one-hot block of one
//      categorical column never co-occur in a row (at most one code of a
//      column is set), so their products are all zero.
//   2. blockIdx.x is a region, blockIdx.y a row slice (chunks y, y + S, …).
//      A block stages kWideChunk rows at a time, only Z's columns of its
//      two ranges (a code lands in a range iff its sigma index does):
//      threads 0..127 write a row of A = w·Z[:, range I], threads 128..255
//      a row of B = Z[:, range J]. The one-hot never touches device
//      memory.
//   3. Each of the 256 threads owns one 4×4 tile of the 64×64 region and
//      walks every staged row in order: two float4 shared loads feed 16
//      FMAs. After each chunk the f32 tile is added to an f64 tile.
//   4. Each block writes its f64 tile to its own partial; wide_gram_reduce
//      sums a region's slices in slice order in f64 and rounds to f32 once,
//      writing both triangles. Skipped regions stay at the zeros the output
//      was allocated with.
//
// As in K1: no float atomics, so reruns are bit-identical; a thread's f32
// sum spans one chunk (128 rows), everything beyond is f64, so counts are
// exact past 2²⁴ rows; any n < 2³¹ (rows past n stage as zeros).
//
// What bounds it on an H100: every kept region costs 4,096 FMAs a row. At
// the favorita_wide schema (P = 492) 30 of the 36 regions are kept,
// 123k FMAs a row, against 52 bytes a row read from device memory: far
// above the ridge, bound by issuing FMAs and shared loads (67 TFLOP/s f32
// peak: ≥ 37 ms per 10M rows). A row has only 1 + d + c nonzeros, so a
// kernel that walks the nonzeros alone is the way past this floor (later
// work).
#pragma once

#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kWideTile = 64;      // side of a region of S
constexpr int kWideChunk = 128;    // rows staged per step
constexpr int kWideStride = 68;    // floats a staged row: 64 + 4, so the
                                   // float4 stores of 32 rows spread banks
constexpr int kMaxWideP = 1024;
constexpr int kMaxRegions =
    (kMaxWideP / kWideTile) * (kMaxWideP / kWideTile + 1) / 2;  // 136
constexpr int kRegionEntries = kWideTile * kWideTile;            // 4096

// The planned regions: region r covers rows [lo_i[r], lo_i[r] + 64) and
// columns [lo_j[r], lo_j[r] + 64) of S, lo_i ≤ lo_j.
struct Regions {
  int lo_i[kMaxRegions];
  int lo_j[kMaxRegions];
  int count;
};

// 0 or a cudaError_t. region_lo: 2·nregions ints, (lo_i, lo_j) pairs.
inline int make_regions(const int* region_lo, int nregions, int P,
                        int slices, Regions& rg) {
  if (nregions < 1 || nregions > kMaxRegions) return cudaErrorInvalidValue;
  if (slices < 1 || slices > 65535) return cudaErrorInvalidValue;
  rg.count = nregions;
  for (int r = 0; r < nregions; ++r) {
    const int li = region_lo[2 * r], lj = region_lo[2 * r + 1];
    if (li < 0 || li % kWideTile || lj % kWideTile || li > lj || lj >= P)
      return cudaErrorInvalidValue;
    rg.lo_i[r] = li;
    rg.lo_j[r] = lj;
  }
  return 0;
}

// Row `row` of Z restricted to sigma indices [lo, lo + 64), each value
// times wt, into dst[0 .. 64); zeros past n and off the row's nonzeros.
// wt·z rounds as K1's z·w does (the ones become wt exactly).
__device__ __forceinline__ void stage_range_row(float* dst, const Cols& cols,
                                                int64_t row, int64_t n,
                                                int lo, const float* w) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kWideTile / 4; ++q) d4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= n) return;
  const float wt = w ? w[row] : 1.0f;
  const int hi = lo + kWideTile;
  if (lo == 0) dst[0] = wt;
  if (lo <= cols.d)
    for (int j = 0; j < cols.d; ++j) {
      const int idx = 1 + j;
      if (idx >= lo && idx < hi) dst[idx - lo] = cols.x[j][row] * wt;
    }
  for (int j = 0; j < cols.c; ++j) {
    const int off = cols.off[j], size = cols.size[j];
    if (off + size <= lo || off >= hi) continue;   // block misses the range
    const int code = cols.code[j][row];
    if (code < 0 || code >= size) continue;
    const int idx = off + code;
    if (idx >= lo && idx < hi) dst[idx - lo] = wt;
  }
}

__global__ void __launch_bounds__(kThreads)
wide_gram_kernel(const __grid_constant__ Cols cols,
                 const __grid_constant__ Regions rg, int64_t n,
                 const float* __restrict__ w, double* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // [kWideChunk][kWideStride]
  float* B = A + kWideChunk * kWideStride;      // [kWideChunk][kWideStride]
  const int reg = blockIdx.x;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;

  // staging role: threads 0..127 build weighted rows of range I, the rest
  // unweighted rows of range J
  const bool side_a = threadIdx.x < kWideChunk;
  const int srow = threadIdx.x % kWideChunk;
  float* dst = (side_a ? A : B) + srow * kWideStride;
  const int lo = side_a ? rg.lo_i[reg] : rg.lo_j[reg];
  const float* wsrc = side_a ? w : nullptr;

  double acc64[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc64[e] = 0.0;

  const int64_t nchunks = (n + kWideChunk - 1) / kWideChunk;
  for (int64_t ch = slice; ch < nchunks; ch += slices) {
    stage_range_row(dst, cols, ch * kWideChunk + srow, n, lo, wsrc);
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
  double* out = partial + (int64_t(reg) * slices + slice) * kRegionEntries;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      out[(4 * ti + k) * kWideTile + 4 * tj + l] = acc64[k * 4 + l];
}

// One thread per region entry: the region's slices summed in slice order in
// f64, rounded once; writes S[i, j] and S[j, i] for i ≤ j < P.
__global__ void wide_gram_reduce(const double* __restrict__ partial,
                                 int slices, const __grid_constant__ Regions rg,
                                 int P, float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(rg.count) * kRegionEntries) return;
  const int reg = static_cast<int>(t / kRegionEntries);
  const int e = static_cast<int>(t % kRegionEntries);
  const double* p = partial + int64_t(reg) * slices * kRegionEntries + e;
  double s = 0.0;
  for (int k = 0; k < slices; ++k) s += p[int64_t(k) * kRegionEntries];
  const int i = rg.lo_i[reg] + e / kWideTile;
  const int j = rg.lo_j[reg] + e % kWideTile;
  if (i >= P || j >= P || i > j) return;
  const float v = static_cast<float>(s);
  out[int64_t(i) * P + j] = v;
  out[int64_t(j) * P + i] = v;
}

inline size_t wide_smem_bytes() {
  return sizeof(float) * 2 * kWideChunk * kWideStride;
}

// Launches K7 and its reduction on `stream`. partial: f64 scratch of
// rg.count · slices · kRegionEntries; out: f32[P, P], zeroed by the caller.
inline int launch_wide_gram(const Cols& cols, const Regions& rg, int P,
                            int64_t n, int slices, const float* w,
                            double* partial, float* out,
                            cudaStream_t stream) {
  const size_t smem = wide_smem_bytes();
  cudaError_t rc = cudaFuncSetAttribute(
      wide_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const dim3 grid(rg.count, slices);
  wide_gram_kernel<<<grid, kThreads, smem, stream>>>(cols, rg, n, w, partial);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int64_t threads = int64_t(rg.count) * kRegionEntries;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  wide_gram_reduce<<<blocks, kThreads, 0, stream>>>(partial, slices, rg, P,
                                                    out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit
