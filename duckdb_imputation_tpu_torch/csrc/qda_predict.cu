// K3: one-pass batched QDA scoring, for sm_90a. Per row, with
// z = [x ‖ onehot(codes)] (m = d + V features) and per class c the factor
// L_c (L_c·L_cᵀ = −quad_c), the linear row lin_c and the intercept b_c:
//
//   y = L_cᵀ·z,   s_c = (b_c + lin_c·z) − ‖y‖²,   pred = first argmax_c s_c
//
// Replaces the Pallas kernel of duckdb_imputation_tpu/ring/kernels/
// qda_pallas.py, _qda_predict_pallas (_qda_kernel), which scores through a
// bf16 hi/lo split operand and selection matrices on the TPU's matrix
// unit. Here the scores are plain f32 on the CUDA cores, added with
// __fadd_rn/__fmul_rn in the order of the plain version
// (ring/kernels/qda_pallas.py:qda_predict_plain), so the two round alike:
// y_i = Σ_j x_j·L[j][i] (j in column order), then each categorical
// column's selected row of L (none for a code outside [0, size)); then
// q = Σ_i y_i² in i order; t = b + Σ_j lin_j·x_j + Σ lin[code]; s = t − q.
// Classes stream with a strict `>`: a tie goes to the lowest class, and a
// NaN score never wins.
//
// What bounds it on an H100: the table is read once (4·d + 4·c bytes a
// row in, 4 out; 32 at BASELINE config 4, ~0.1 ms per 10M rows at
// 3.35 TB/s), but each row costs C·m·(d + c + 2) operations (~1,000 at
// C = 8, m = 20, d = 4, c = 2) and about as many shared-memory loads, so
// the kernel is issue-bound. The C factors (C·m² f32, 12.8 KB at C = 8,
// m = 20), lin and b stay in shared memory for the whole launch; the
// numeric terms read one address across a warp (a broadcast), and a row's
// codes select whole rows of L_c, never a one-hot vector. The row's x
// values and selected rows live in registers: loops over them are
// unrolled to a compile-time bound (MAXD numeric and MAXC categorical
// columns ∈ {4, 8, 16, 32}), so none is indexed at run time.
#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kMaxQdaCols = 32;          // numeric, and categorical, columns
constexpr size_t kMaxQdaSmem = 227 * 1024;  // the H100's per-block maximum

struct QdaGeom {
  int m;     // features d + V
  int C;     // classes
  int64_t n;
};

inline size_t qda_smem_bytes(int m, int C) {
  return sizeof(float) * (size_t(C) * m * m + size_t(C) * m + C);
}

template <int MAXD, int MAXC>
__global__ void __launch_bounds__(kThreads)
qda_kernel(const __grid_constant__ Cols cols, const __grid_constant__ QdaGeom qg,
           const float* __restrict__ L, const float* __restrict__ lin,
           const float* __restrict__ b, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int m = qg.m, C = qg.C;
  float* Ls = smem;                    // [C][m][m]: row k of L_c feeds z_k
  float* lins = Ls + C * m * m;        // [C][m]
  float* bs = lins + C * m;            // [C]
  for (int i = threadIdx.x; i < C * m * m; i += blockDim.x) Ls[i] = L[i];
  for (int i = threadIdx.x; i < C * m; i += blockDim.x) lins[i] = lin[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) bs[i] = b[i];
  __syncthreads();

  const int d = cols.d, c = cols.c;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       row < qg.n; row += int64_t(gridDim.x) * blockDim.x) {
    float x[MAXD];
    int k[MAXC];  // the feature a categorical column selects, or −1
#pragma unroll
    for (int j = 0; j < MAXD; ++j) x[j] = j < d ? cols.x[j][row] : 0.0f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      k[j] = -1;
      if (j < c) {
        const int code = cols.code[j][row];
        if (code >= 0 && code < cols.size[j]) k[j] = cols.off[j] + code;
      }
    }
    float best_v = -INFINITY;
    int best = 0;
    for (int cc = 0; cc < C; ++cc) {
      const float* Lc = Ls + cc * m * m;
      float q = 0.0f;
      for (int i = 0; i < m; ++i) {
        float y = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j)
          if (j < d) y = __fadd_rn(y, __fmul_rn(x[j], Lc[j * m + i]));
#pragma unroll
        for (int j = 0; j < MAXC; ++j)
          if (j < c && k[j] >= 0) y = __fadd_rn(y, Lc[k[j] * m + i]);
        q = __fadd_rn(q, __fmul_rn(y, y));
      }
      const float* lc = lins + cc * m;
      float t = bs[cc];
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < d) t = __fadd_rn(t, __fmul_rn(lc[j], x[j]));
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
        if (j < c && k[j] >= 0) t = __fadd_rn(t, lc[k[j]]);
      const float s = __fsub_rn(t, q);
      if (s > best_v) {
        best_v = s;
        best = cc;
      }
    }
    out[row] = best;
  }
}

template <int MAXD, int MAXC>
int launch_qda(const Cols& cols, const QdaGeom& qg, const float* L,
               const float* lin, const float* b, int32_t* out, int nblocks,
               cudaStream_t s) {
  const size_t smem = qda_smem_bytes(qg.m, qg.C);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        qda_kernel<MAXD, MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  qda_kernel<MAXD, MAXC><<<nblocks, kThreads, smem, s>>>(cols, qg, L, lin, b,
                                                         out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K3 on `stream`. L f32[C, m, m], lin f32[C, m], b f32[C], with
// m = d + Σ cat_sizes; out i32[n]. Returns 0 or a cudaError_t.
int dit_qda_predict(const void* const* x_cols, int d,
                    const void* const* code_cols, const int* cat_sizes,
                    int c, const float* L, const float* lin, const float* b,
                    int C, int m, int64_t n, int32_t* out, int nblocks,
                    void* stream) {
  using namespace dit;
  if (d < 0 || c < 0 || d > kMaxQdaCols || c > kMaxQdaCols || C < 1 ||
      nblocks < 1 || n < 0)
    return cudaErrorInvalidValue;
  int mm = d;
  for (int j = 0; j < c; ++j) {
    if (cat_sizes[j] < 0) return cudaErrorInvalidValue;
    mm += cat_sizes[j];
  }
  if (mm != m || qda_smem_bytes(m, C) > kMaxQdaSmem) return cudaErrorInvalidValue;
  // sigma-layout offsets (1 + d + ...) less the leading constant feature
  Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  for (int j = 0; j < c; ++j) cols.off[j] -= 1;
  const QdaGeom qg{m, C, n};
  auto s = static_cast<cudaStream_t>(stream);
  const int wide = d > c ? d : c;
  int (*launch)(const Cols&, const QdaGeom&, const float*, const float*,
                const float*, int32_t*, int, cudaStream_t) = launch_qda<32, 32>;
  if (wide <= 16) launch = launch_qda<16, 16>;
  if (wide <= 8) launch = launch_qda<8, 8>;
  if (wide <= 4) launch = launch_qda<4, 4>;
  return launch(cols, qg, L, lin, b, out, nblocks, s);
}

}  // extern "C"
