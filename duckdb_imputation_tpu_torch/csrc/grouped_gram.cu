// K4 and K5: the grouped masked Gram, one S_g = Zᵀ·diag(w·[id = g])·Z per
// group, for sm_90a, plain f32 on the CUDA cores.
//
// K4 (grouped_gram_kernel) takes the rows in any order, with the group id
// riding along as data. It replaces the Pallas kernels of
// duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py that keep all
// G output slabs resident and route rows by inline masks:
// _sigma_pallas_grouped_unsorted (_grouped_unsorted_kernel) and its _fast,
// _fast2 and _fast3 variants. K5 (presorted_gram_kernel) takes rows already
// sorted by group (ring/kernels/sigma_pallas_grouped.py:sort_by_group) and
// the segment offsets. It replaces the sorted-slab kernels that route
// blocks through a prefetched block→group map:
// _sigma_pallas_grouped_padded (_grouped_kernel), _fast2_padded and
// _fast3_padded. The bf16 hi/lo splits, lane packing and per-variant
// layouts exist for the TPU's matrix unit and are dropped.
//
// What bounds them on an H100: as K1 (masked_gram.cu), issuing the
// P(P+1)/2 products of each row and the shared loads that feed them; one
// row reads 4·d + 4·c + 8 bytes (K4) or 4·d + 4·c + 4 (K5). Both keep K1's
// scheme (gram_common.cuh): a row staged once in shared memory, a 4×4
// register tile per thread, f32 within a thread, f64 in a fixed order
// across row groups and blocks, one rounding. No atomics: reruns are
// bit-identical and counts stay exact past 2²⁴ rows.
//
// K4's trouble is the per-group accumulators: G register tiles per thread.
// Testing each row against every group would cost G× the products, and a
// tile indexed by a run-time group would live in local memory. So each
// staged chunk is bucketed by group (bucket.cuh), and a thread walks the
// buckets with the group index fixed by unrolling over a compile-time
// bound GMAX ∈ {2, 4, 8}: every row costs its products once, and the tiles
// stay in registers (16·GMAX floats a thread). GMAX = 8 (128 accumulator
// registers of the 255 a thread may use) is the group limit; the wrapper
// raises past it, and more groups go to K5.
//
// K5's trouble is the block→group routing. Chunks of kChunk rows never
// cross a segment, and each block takes a contiguous run of chunks, so it
// meets groups in order; it writes one partial per (block, group) it
// touched, into slot block + group (unique, since groups do not decrease
// from one block to the next). presorted_reduce then sums each group's
// slots over the blocks that touched it in block order.
#include "bucket.cuh"

namespace dit {
namespace {

constexpr int kMaxUnsortedGroups = 8;

template <int GMAX>
__global__ void __launch_bounds__(kThreads)
grouped_gram_kernel(const __grid_constant__ Cols cols,
                    const __grid_constant__ Geom gm,
                    const float* __restrict__ w,
                    const int32_t* __restrict__ gid, int G,
                    double* __restrict__ partial) {
  extern __shared__ float smem[];
  int* ints = reinterpret_cast<int*>(smem);          // bucket_ints(GMAX)
  float* zs = smem + bucket_ints(GMAX);              // [kChunk][PS]
  float* ws = zs + kChunk * gm.PS;                   // [kChunk]
  const int* bstart = ints + kWarps * G;
  const TileOwner own(gm);
  float acc[GMAX][16];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[g][e] = 0.0f;

  const int64_t nchunks = (gm.n + kChunk - 1) / kChunk;
  for (int64_t ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int64_t row = ch * kChunk + threadIdx.x;
    int grp = -1;
    if (row < gm.n) {
      const int g = gid[row];
      if (g >= 0 && g < G) grp = g;
    }
    const int slot = bucket_slot(grp, G, ints);
    if (slot >= 0) {
      build_row(zs + slot * gm.PS, cols, row, gm.PS);
      ws[slot] = w[row];
    }
    __syncthreads();
    if (own.active) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G)
          accumulate_rows(zs, ws, gm, own.i0, own.j0, bstart[g] + own.g,
                          bstart[g + 1], acc[g]);
    }
    __syncthreads();
  }
  const int64_t E = gm.T * 16;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
      write_block_partial(acc[g], own.active, own.t, own.g, zs, gm,
                          partial + g * E * gridDim.x);
}

// Chunks per block of K5, the same in the kernel and the reduction.
__host__ __device__ __forceinline__ int64_t chunks_per_block(int64_t total,
                                                             int nblocks) {
  const int64_t cpb = (total + nblocks - 1) / nblocks;
  return cpb > 0 ? cpb : 1;
}

// off[g] .. off[g + 1]: group g's rows in the sorted order. cum[g]: its
// first chunk; cum[G]: the chunk count. partial: [E][nblocks + G].
__global__ void __launch_bounds__(kThreads)
presorted_gram_kernel(const __grid_constant__ Cols cols,
                      const __grid_constant__ Geom gm,
                      const float* __restrict__ w,
                      const int64_t* __restrict__ off,
                      const int64_t* __restrict__ cum, int G,
                      double* __restrict__ partial) {
  extern __shared__ float smem[];
  float* zs = smem;                      // [kChunk][PS]
  float* ws = smem + kChunk * gm.PS;     // [kChunk]
  const int64_t total = cum[G];
  const int64_t cpb = chunks_per_block(total, gridDim.x);
  const int64_t c0 = blockIdx.x * cpb;
  const int64_t c1 = c0 + cpb < total ? c0 + cpb : total;
  if (c0 >= c1) return;                  // the whole block: no barrier left
  const int64_t stride = int64_t(gridDim.x) + G;

  // the group of chunk c0: the last g with cum[g] ≤ c0 (skips empty ones)
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (cum[mid] <= c0) lo = mid; else hi = mid - 1;
  }
  int cur = lo;

  const TileOwner own(gm);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
  for (int64_t c = c0; c < c1; ++c) {
    int g = cur;
    while (c >= cum[g + 1]) ++g;
    if (g != cur) {
      write_partial_at(acc, own.active, own.t, own.g, zs, gm, partial,
                       stride, blockIdx.x + cur);
      __syncthreads();  // the scratch is the Z tile staged next
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
      cur = g;
    }
    const int64_t row = off[g] + (c - cum[g]) * kChunk + threadIdx.x;
    float* zr = zs + threadIdx.x * gm.PS;
    if (row < off[g + 1]) {
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
  write_partial_at(acc, own.active, own.t, own.g, zs, gm, partial, stride,
                   blockIdx.x + cur);
}

// One warp per (group, entry): the group's slots over the blocks that
// touched it, in block order, f64, one rounding. Empty groups get zeros.
__global__ void presorted_reduce(const double* __restrict__ partial,
                                 const int64_t* __restrict__ cum, int G,
                                 int nblocks, Geom gm,
                                 float* __restrict__ out) {
  const int64_t warp =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int E = gm.T * 16;
  if (warp >= int64_t(G) * E) return;
  const int g = static_cast<int>(warp / E);
  const int e = static_cast<int>(warp % E);
  const int64_t stride = int64_t(nblocks) + G;
  double s = 0.0;
  if (cum[g + 1] > cum[g]) {
    const int64_t cpb = chunks_per_block(cum[G], nblocks);
    const int64_t b0 = cum[g] / cpb, b1 = (cum[g + 1] - 1) / cpb;
    for (int64_t b = b0 + lane; b <= b1; b += 32)
      s += partial[int64_t(e) * stride + b + g];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane != 0) return;
  int ti, tj;
  tile_coords(e / 16, gm.NT, ti, tj);
  const int i = 4 * ti + (e % 16) / 4;
  const int j = 4 * tj + (e % 16) % 4;
  if (i < gm.P && j < gm.P && i <= j) {
    const float v = static_cast<float>(s);
    float* o = out + int64_t(g) * gm.P * gm.P;
    o[i * gm.P + j] = v;
    o[j * gm.P + i] = v;
  }
}

template <int GMAX>
int launch_grouped(const Cols& cols, const Geom& gm, const float* w,
                   const int32_t* gid, int G, double* partial, int nblocks,
                   cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (bucket_ints(GMAX) + gram_smem_floats(gm));
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        grouped_gram_kernel<GMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  grouped_gram_kernel<GMAX><<<nblocks, kThreads, smem, s>>>(cols, gm, w, gid,
                                                            G, partial);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K4 and its reductions on `stream`: out f32[G, P, P] for
// 1 ≤ G ≤ kMaxUnsortedGroups; ids outside [0, G) add nothing.
// partial: f64 scratch of G · dit_gram_entries(P) · nblocks.
int dit_grouped_gram(const void* const* x_cols, int d,
                     const void* const* code_cols, const int* cat_sizes,
                     int c, const float* w, const int32_t* gid, int G,
                     int64_t n, int P, double* partial, int nblocks,
                     float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (G < 1 || G > kMaxUnsortedGroups) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Geom gm = make_geom(P, n);
  auto s = static_cast<cudaStream_t>(stream);
  int (*launch)(const Cols&, const Geom&, const float*, const int32_t*, int,
                double*, int, cudaStream_t) = launch_grouped<8>;
  if (G <= 4) launch = launch_grouped<4>;
  if (G <= 2) launch = launch_grouped<2>;
  if (int rc = launch(cols, gm, w, gid, G, partial, nblocks, s)) return rc;
  const int64_t per_group = int64_t(gram_entries(gm)) * nblocks;
  for (int g = 0; g < G; ++g)
    launch_gram_reduce(partial + g * per_group, nblocks, gm,
                       out + int64_t(g) * P * P, s);
  return cudaGetLastError();
}

// Launches K5 and its reduction on `stream` over rows sorted by group:
// off i64[G + 1] (group g's rows are off[g] .. off[g + 1]), cum i64[G + 1]
// (cum[g] = Σ_{h<g} ceil((off[h+1] − off[h]) / 256) chunks). out
// f32[G, P, P]; partial: f64 scratch of dit_gram_entries(P) · (nblocks + G).
int dit_presorted_gram(const void* const* x_cols, int d,
                       const void* const* code_cols, const int* cat_sizes,
                       int c, const float* w, const int64_t* off,
                       const int64_t* cum, int G, int64_t n, int P,
                       double* partial, int nblocks, float* out,
                       void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (G < 1) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Geom gm = make_geom(P, n);
  const size_t smem = sizeof(float) * gram_smem_floats(gm);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        presorted_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  auto s = static_cast<cudaStream_t>(stream);
  presorted_gram_kernel<<<nblocks, kThreads, smem, s>>>(cols, gm, w, off,
                                                        cum, G, partial);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  const int64_t warps = int64_t(G) * gram_entries(gm);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  presorted_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, cum, G, nblocks, gm, out);
  return cudaGetLastError();
}

}  // extern "C"
