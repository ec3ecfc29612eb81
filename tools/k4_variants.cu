// Candidates for K4 (the unsorted grouped Gram, csrc/grouped_gram.cu) that
// the package does not keep, timed beside it by tools/k4_variants.py. The
// package's kernels are included whole, so each candidate reuses them and
// differs only where it says.
//
// - k4v_order: K4's group order alone (count, scan, scatter of the row
//   indices).
// - k4v_packed: the order's count and scan, then a copy of its scatter
//   (packed_scatter_kernel) that writes a group-ordered packed copy of the
//   rows (w, x, codes: 4 + 4d + 4c bytes a row) instead of their indices,
//   and K5 over the copy in place.
// - k4v_onepass: one pass over the rows in any order, no order first.
//   Steps of 128 rows as K1's; each step's rows bucketed by group in
//   shared memory (warp ballots and a scan of their counts), each group's
//   run padded to a k16 boundary by zero rows; the warps sum a group's
//   k16 slices into f32 fragments (mma.sync bf16 → f32 over the three
//   bf16 parts, as tc_gram.cuh), then fold them through shared memory
//   into that group's f64 sums of S, which stay in shared memory; at the
//   end each block writes one partial a group, and tc_gram_reduce sums
//   them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -Xcompiler -fPIC -shared -I duckdb_imputation_tpu_torch/csrc
//   tools/k4_variants.cu (tools/k4_variants.py does this).
#include "grouped_gram.cu"

namespace dit {
namespace {

// The order's scatter (grouped_gram.cu: group_scatter_kernel) writing each
// row's values at its place instead of its index: packed[col][place], col
// 0 = w, 1 + j = x_j, 1 + d + j = code_j (ld = n).
__global__ void __launch_bounds__(kThreads)
packed_scatter_kernel(const int32_t* __restrict__ gid, int G, int64_t n,
                      int64_t per, const int64_t* __restrict__ first,
                      const __grid_constant__ Cols cols,
                      const float* __restrict__ w,
                      float* __restrict__ packed) {
  constexpr int kParts = kOrderUnroll * kOrderWarps;
  __shared__ int before[kParts][kMaxUnsortedGroups];
  __shared__ int total[kMaxUnsortedGroups];
  __shared__ int64_t next[kMaxUnsortedGroups];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x < G)
    next[threadIdx.x] = first[int64_t(threadIdx.x) * gridDim.x + blockIdx.x];
  const int64_t r0 = blockIdx.x * per;
  const int64_t end = r0 + per < n ? r0 + per : n;
  for (int64_t base = r0; base < end; base += kOrderUnroll * kChunk) {
    int grp[kOrderUnroll], rank[kOrderUnroll];
#pragma unroll
    for (int k = 0; k < kOrderUnroll; ++k)
      grp[k] = row_group(gid, base + k * kChunk + threadIdx.x, end, G);
#pragma unroll
    for (int k = 0; k < kOrderUnroll; ++k) {
      rank[k] = 0;
      for (int g = 0; g < G; ++g) {
        const unsigned m = __ballot_sync(0xffffffffu, grp[k] == g);
        if (grp[k] == g) rank[k] = __popc(m & below);
        if (lane == 0) before[k * kOrderWarps + warp][g] = __popc(m);
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kOrderWarps) {
      const int a = before[2 * lane][g], b = before[2 * lane + 1][g];
      int incl = a + b;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      before[2 * lane][g] = incl - a - b;
      before[2 * lane + 1][g] = incl - b;
      if (lane == 31) total[g] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOrderUnroll; ++k)
      if (grp[k] >= 0) {
        const int64_t at =
            next[grp[k]] + before[k * kOrderWarps + warp][grp[k]] + rank[k];
        const int64_t row = base + k * kChunk + threadIdx.x;
        packed[at] = w[row];
        for (int j = 0; j < cols.d; ++j)
          packed[(1 + j) * n + at] = cols.x[j][row];
        for (int j = 0; j < cols.c; ++j)
          packed[(1 + cols.d + j) * n + at] =
              __int_as_float(cols.code[j][row]);
      }
    __syncthreads();
    if (threadIdx.x < G) next[threadIdx.x] += total[threadIdx.x];
  }
}

constexpr int kOpWarps = kTcThreads / 32;
constexpr int kOpWidth = 256;              // 128 rows + the runs' padding
constexpr int kOpStride = kOpWidth + 8;    // bf16 column stride of a tile
constexpr int kOpGroups = 8;

// A row (raw values rb[col · kOpWidth]) into the tiles at column `at`: the
// one-hots column `at` held cleared (pv[j · kOpWidth]), its parts written.
// tc_gram.cuh's build_row with this kernel's strides.
__device__ __forceinline__ void op_build(const float* rb,
                                         __nv_bfloat16* left,
                                         __nv_bfloat16* right, short* pv,
                                         const Cols& cols) {
  const int d = cols.d, c = cols.c;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const float wv = rb[0];
  for (int j = 0; j < c; ++j) {
    const int pl = pv[j * kOpWidth], pr = pv[(c + j) * kOpWidth];
    if (pl >= 0) {
      left[pl * kOpStride] = zero;
      left[(pl + 1) * kOpStride] = zero;
      left[(pl + 2) * kOpStride] = zero;
    }
    if (pr >= 0) right[pr * kOpStride] = zero;
  }
  for (int a = 0; a < 1 + d; ++a)
    split3(a == 0 ? wv : rb[a * kOpWidth] * wv, left + 3 * a * kOpStride,
           kOpStride);
  for (int b = 1; b < 1 + d; ++b)
    split3(rb[b * kOpWidth], right + right_feature(b, d) * kOpStride,
           kOpStride);
  right[0] = __float2bfloat16_rn(1.0f);
  for (int j = 0; j < c; ++j) {
    const int code = __float_as_int(rb[(1 + d + j) * kOpWidth]);
    int pl = -1, pr = -1;
    if (code >= 0 && code < cols.size[j]) {
      const int a = cols.off[j] + code;
      pl = 3 * a;
      split3(wv, left + pl * kOpStride, kOpStride);
      pr = right_feature(a, d);
      right[pr * kOpStride] = __float2bfloat16_rn(1.0f);
    }
    pv[j * kOpWidth] = static_cast<short>(pl);
    pv[(c + j) * kOpWidth] = static_cast<short>(pr);
  }
}

inline size_t onepass_smem_bytes(int d, int c) {
  return sizeof(__nv_bfloat16) * (kTcLeft + kTcRight) * kOpStride +
         sizeof(double) * kOpGroups * kTcEntries +
         sizeof(float) * kTcAcc * kTcThreads +
         sizeof(float) * (1 + d + c) * kOpWidth +
         sizeof(short) * 2 * c * kOpWidth +
         sizeof(int) * (kOpWarps * kOpGroups + 2 * (kOpGroups + 1));
}

// partial: [G][kTcEntries][gridDim.x].
__global__ void __launch_bounds__(kTcThreads)
onepass_kernel(const __grid_constant__ Cols cols, int P,
               const float* __restrict__ w, const int32_t* __restrict__ gid,
               int G, int64_t n, double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int d = cols.d, c = cols.c, ncol = 1 + d + c;
  __nv_bfloat16* left = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* right = left + kTcLeft * kOpStride;
  double* gsum = reinterpret_cast<double*>(right + kTcRight * kOpStride);
  float* frag = reinterpret_cast<float*>(gsum + kOpGroups * kTcEntries);
  float* raw = frag + kTcAcc * kTcThreads;             // [ncol][kOpWidth]
  short* prev = reinterpret_cast<short*>(raw + ncol * kOpWidth);
  int* wcnt = reinterpret_cast<int*>(prev + 2 * c * kOpWidth);
  int* bstart = wcnt + kOpWarps * kOpGroups;           // [G + 1]
  int* pstart = bstart + kOpGroups + 1;                // [G + 1], padded
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < (kTcLeft + kTcRight) * kOpStride; e += kTcThreads)
    left[e] = zero;
  for (int e = tid; e < 2 * c * kOpWidth; e += kTcThreads) prev[e] = -1;
  for (int e = tid; e < G * kTcEntries; e += kTcThreads) gsum[e] = 0.0;
  // raw columns kTcRows .. kOpWidth: a zero row, what a padding column builds
  for (int e = tid; e < kOpWidth - kTcRows; e += kTcThreads) {
    const int r = kTcRows + e;
    for (int col = 0; col < ncol; ++col)
      raw[col * kOpWidth + r] = col <= d ? 0.0f : __int_as_float(-1);
  }

  const int64_t nch = (n + kTcRows - 1) / kTcRows;
  for (int64_t ch = blockIdx.x; ch < nch; ch += gridDim.x) {
    // 1. this thread's row, and its group
    const int64_t row = ch * kTcRows + tid;
    int grp = -1;
    if (row < n) {
      const int g = gid[row];
      if (g >= 0 && g < G) grp = g;
    }
    float* rb = raw + tid;
    rb[0] = grp >= 0 ? w[row] : 0.0f;
    for (int j = 0; j < d; ++j)
      rb[(1 + j) * kOpWidth] = grp >= 0 ? cols.x[j][row] : 0.0f;
    for (int j = 0; j < c; ++j)
      rb[(1 + d + j) * kOpWidth] =
          __int_as_float(grp >= 0 ? cols.code[j][row] : -1);
    // 2. its column: rank among the step's rows of its group, each group's
    // run padded to a multiple of 16
    const unsigned below = (1u << lane) - 1u;
    int rank = 0;
    for (int g = 0; g < G; ++g) {
      const unsigned m = __ballot_sync(0xffffffffu, grp == g);
      if (grp == g) rank = __popc(m & below);
      if (lane == 0) wcnt[warp * kOpGroups + g] = __popc(m);
    }
    __syncthreads();   // also: the last step's folds are done
    if (tid == 0) {
      bstart[0] = pstart[0] = 0;
      for (int g = 0; g < G; ++g) {
        int cnt = 0;
        for (int v = 0; v < kOpWarps; ++v) cnt += wcnt[v * kOpGroups + g];
        bstart[g + 1] = bstart[g] + cnt;
        pstart[g + 1] = pstart[g] + (cnt + 15) / 16 * 16;
      }
    }
    __syncthreads();
    if (grp >= 0) {
      int at = pstart[grp] + rank;
      for (int v = 0; v < warp; ++v) at += wcnt[v * kOpGroups + grp];
      op_build(rb, left + at, right + at, prev + at, cols);
    }
    // the padding columns, each built from the zero row
    const int pad = pstart[G] - bstart[G];
    for (int k = tid; k < pad; k += kTcThreads) {
      int g = 0, left_k = k;
      auto pad_of = [&](int h) {
        return (pstart[h + 1] - pstart[h]) - (bstart[h + 1] - bstart[h]);
      };
      while (left_k >= pad_of(g)) left_k -= pad_of(g++);
      const int at = pstart[g] + (bstart[g + 1] - bstart[g]) + left_k;
      op_build(raw + kTcRows + k, left + at, right + at, prev + at, cols);
    }
    __syncthreads();
    // 3. each group's run: the warp's m16 tile over its k16 slices, then
    // the fragments folded into the group's f64 sums
    for (int g = 0; g < G; ++g) {
      const int c0 = pstart[g], c1 = pstart[g + 1];
      if (c0 == c1) continue;   // the same for the whole block
      float acc[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[ni][k] = 0.0f;
      for (int k0 = c0; k0 < c1; k0 += 16) {
        uint32_t af[4], bf[4][2];
        ldmatrix_x4(af, left + (warp * 16 + (lane & 15)) * kOpStride + k0 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t t[4];
          ldmatrix_x4(t, right + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     kOpStride + k0 + ((lane >> 3) & 1) * 8);
          bf[2 * nj][0] = t[0];
          bf[2 * nj][1] = t[1];
          bf[2 * nj + 1][0] = t[2];
          bf[2 * nj + 1][1] = t[3];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[ni], af, bf[ni][0], bf[ni][1]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          frag[(ni * 4 + k) * kTcThreads + tid] = acc[ni][k];
      __syncthreads();
      for (int e = tid; e < kTcEntries; e += kTcThreads) {
        const int a = e / kTcA, b = e % kTcA;
        if (a > b || b >= P) continue;
        const int n0 = right_feature(b, d), nq = right_parts(b, d);
        double sum = 0.0;
        for (int p = 0; p < 3; ++p)
          for (int q = 0; q < nq; ++q) {
            const int m = 3 * a + p, nn = n0 + q;
            const int mr = m & 15, nr = nn & 7;
            const int ln = (mr & 7) * 4 + (nr >> 1);
            const int k = (mr >> 3) * 2 + (nr & 1);
            sum += frag[((nn >> 3) * 4 + k) * kTcThreads + (m >> 4) * 32 + ln];
          }
        gsum[g * kTcEntries + e] += sum;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int e = tid; e < G * kTcEntries; e += kTcThreads)
    partial[int64_t(e) * gridDim.x + blockIdx.x] = gsum[e];
}

}  // namespace
}  // namespace dit

extern "C" {

// K4's group order alone; counts, off_cum and idx as dit_grouped_gram's.
int k4v_order(const int32_t* gid, int G, int64_t n, int rows,
              int64_t* counts, int64_t* off_cum, int32_t* idx, void* stream) {
  using namespace dit;
  auto s = static_cast<cudaStream_t>(stream);
  int B;
  int64_t per;
  order_geometry(n, B, per);
  group_count_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts);
  group_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, G, B, rows, off_cum,
                                               off_cum + G + 1);
  group_scatter_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts, idx);
  return cudaGetLastError();
}

// The order with a packed copy, then K5 over it; packed f32[1 + d + c][n].
int k4v_packed(const void* const* x_cols, int d, const void* const* code_cols,
               const int* cat_sizes, int c, const float* w,
               const int32_t* gid, int G, int64_t n, int P, int64_t* counts,
               int64_t* off_cum, float* packed, double* partial, int nblocks,
               float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  auto s = static_cast<cudaStream_t>(stream);
  int B;
  int64_t per;
  order_geometry(n, B, per);
  int64_t* off = off_cum;
  int64_t* cum = off_cum + G + 1;
  group_count_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts);
  group_scan_kernel<<<1, kScanThreads, 0, s>>>(
      counts, G, B, tc_fits(d, P) ? kTcRows : kChunk, off, cum);
  packed_scatter_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts, cols,
                                               w, packed);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  Cols pc = cols;
  for (int j = 0; j < d; ++j) pc.x[j] = packed + (1 + j) * n;
  for (int j = 0; j < c; ++j)
    pc.code[j] = reinterpret_cast<const int32_t*>(packed + (1 + d + j) * n);
  return launch_presorted(pc, P, packed, off, cum, nullptr, G, n, partial,
                          nblocks, out, s);
}

// The one-pass kernel and G reductions; partial f64[G · 441 · nblocks].
int k4v_onepass(const void* const* x_cols, int d,
                const void* const* code_cols, const int* cat_sizes, int c,
                const float* w, const int32_t* gid, int G, int64_t n, int P,
                double* partial, int nblocks, float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (!tc_fits(d, P) || G < 1 || G > kOpGroups) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = onepass_smem_bytes(d, c);
  cudaError_t rc = cudaFuncSetAttribute(
      onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  onepass_kernel<<<nblocks, kTcThreads, smem, s>>>(cols, P, w, gid, G, n,
                                                   partial);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int blocks = (kTcEntries * 32 + kThreads - 1) / kThreads;
  for (int g = 0; g < G; ++g)
    tc_gram_reduce<<<blocks, kThreads, 0, s>>>(
        partial + int64_t(g) * kTcEntries * nblocks, nblocks, P,
        out + int64_t(g) * P * P);
  return cudaGetLastError();
}

// K5 over positions read through idx (K4's second half alone).
int k4v_k5_through(const void* const* x_cols, int d,
                   const void* const* code_cols, const int* cat_sizes, int c,
                   const float* w, const int64_t* off_cum, const int32_t* idx,
                   int G, int64_t n, int P, double* partial, int nblocks,
                   float* out, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  return launch_presorted(cols, P, w, off_cum, off_cum + G + 1, idx, G, n,
                          partial, nblocks, out,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
