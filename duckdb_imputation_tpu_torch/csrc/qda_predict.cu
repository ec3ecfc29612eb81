// K3 and K3w: one-pass batched QDA scoring, for sm_90a. Per row, with
// z = [x ‖ onehot(codes)] (m = d + V features) and per class c the factor
// L_c f32[m, r] (L_c·L_cᵀ = −quad_c, r ≤ m columns), the linear row lin_c
// and the intercept b_c:
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
// NaN score never wins. `qda_scorers` drops the factor's zero columns
// (r is the largest rank over the classes, rounded up to kQdaRankAlign):
// a zero column adds exactly +0 to q, so no score changes.
//
// K3 (qda_kernel) keeps the C factors (C·m·r f32, 12.8 KB at C = 8,
// m = r = 20), lin and b in shared memory for the whole launch, up to
// kMaxQdaSmem. K3w (qda_wide_kernel) takes the factors that do not fit
// (favorita_classify: 33 classes, m = 458, r ≤ 458: 27.7 MB) and reads
// them from device memory, where they stay in the 50 MB L2: a thread
// walks its row's d numeric rows of L_c (the same address across a warp)
// and c selected rows (one per lane) four columns at a time, as float4
// loads, so y's four entries and their order stay in registers.
//
// What bounds them on an H100: the table is read once (4·d + 4·c bytes a
// row in, 4 out; 32 at BASELINE config 4, ~0.1 ms per 10M rows at
// 3.35 TB/s), but each row costs C·r·(d + c + 1) FMAs (~1,000 at C = 8,
// r = 20, d = 4, c = 2; ~1.8e5 at favorita_classify's 33 classes), so both
// are issue-bound: K3 on FMAs and shared loads, K3w first on the c·r
// scattered factor reads a (row, class) costs through L1 and L2 (14.7 KB
// at c = 8, r = 458), well above its ~54 ms f32 FMA floor per 10M rows.
// The row's x values and selected rows live in registers: loops over them
// are unrolled to a compile-time bound (MAXD numeric and MAXC categorical
// columns ∈ {4, 8, 16, 32}), so none is indexed at run time.
#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kMaxQdaCols = 32;          // numeric, and categorical, columns
constexpr size_t kMaxQdaSmem = 227 * 1024;  // the H100's per-block maximum
constexpr int kQdaRankAlign = 4;         // K3w reads L's columns as float4s

struct QdaGeom {
  int m;     // features d + V
  int r;     // columns of each factor
  int C;     // classes
  int64_t n;
};

inline size_t qda_smem_bytes(int m, int r, int C) {
  return sizeof(float) * (size_t(C) * m * r + size_t(C) * m + C);
}

// The row's numeric values and, per categorical column, the row of L (and
// of lin) its code selects, or −1 for a code outside [0, size).
template <int MAXD, int MAXC>
__device__ __forceinline__ void load_row(const Cols& cols, int64_t row,
                                         float x[MAXD], int k[MAXC]) {
#pragma unroll
  for (int j = 0; j < MAXD; ++j) x[j] = j < cols.d ? cols.x[j][row] : 0.0f;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    k[j] = -1;
    if (j < cols.c) {
      const int code = cols.code[j][row];
      if (code >= 0 && code < cols.size[j]) k[j] = cols.off[j] + code;
    }
  }
}

// b + lin·z in the plain version's order.
template <int MAXD, int MAXC>
__device__ __forceinline__ float linear_term(const Cols& cols, float b,
                                             const float* lc,
                                             const float x[MAXD],
                                             const int k[MAXC]) {
  float t = b;
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
    if (j < cols.d) t = __fadd_rn(t, __fmul_rn(lc[j], x[j]));
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    if (j < cols.c && k[j] >= 0) t = __fadd_rn(t, lc[k[j]]);
  return t;
}

template <int MAXD, int MAXC>
__global__ void __launch_bounds__(kThreads)
qda_kernel(const __grid_constant__ Cols cols, const __grid_constant__ QdaGeom qg,
           const float* __restrict__ L, const float* __restrict__ lin,
           const float* __restrict__ b, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int m = qg.m, r = qg.r, C = qg.C;
  float* Ls = smem;                    // [C][m][r]: row k of L_c feeds z_k
  float* lins = Ls + C * m * r;        // [C][m]
  float* bs = lins + C * m;            // [C]
  for (int i = threadIdx.x; i < C * m * r; i += blockDim.x) Ls[i] = L[i];
  for (int i = threadIdx.x; i < C * m; i += blockDim.x) lins[i] = lin[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) bs[i] = b[i];
  __syncthreads();

  const int d = cols.d, c = cols.c;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       row < qg.n; row += int64_t(gridDim.x) * blockDim.x) {
    float x[MAXD];
    int k[MAXC];
    load_row<MAXD, MAXC>(cols, row, x, k);
    float best_v = -INFINITY;
    int best = 0;
    for (int cc = 0; cc < C; ++cc) {
      const float* Lc = Ls + cc * m * r;
      float q = 0.0f;
      for (int i = 0; i < r; ++i) {
        float y = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j)
          if (j < d) y = __fadd_rn(y, __fmul_rn(x[j], Lc[j * r + i]));
#pragma unroll
        for (int j = 0; j < MAXC; ++j)
          if (j < c && k[j] >= 0) y = __fadd_rn(y, Lc[k[j] * r + i]);
        q = __fadd_rn(q, __fmul_rn(y, y));
      }
      const float s = __fsub_rn(
          linear_term<MAXD, MAXC>(cols, bs[cc], lins + cc * m, x, k), q);
      if (s > best_v) {
        best_v = s;
        best = cc;
      }
    }
    out[row] = best;
  }
}

// K3w: the factors, lin and b stay in device memory (L2). L's rows are
// 16-byte aligned (r a multiple of kQdaRankAlign).
template <int MAXD, int MAXC>
__global__ void __launch_bounds__(kThreads)
qda_wide_kernel(const __grid_constant__ Cols cols,
                const __grid_constant__ QdaGeom qg,
                const float* __restrict__ L, const float* __restrict__ lin,
                const float* __restrict__ b, int32_t* __restrict__ out) {
  const int m = qg.m, r = qg.r, C = qg.C;
  const int d = cols.d, c = cols.c;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       row < qg.n; row += int64_t(gridDim.x) * blockDim.x) {
    float x[MAXD];
    int k[MAXC];
    load_row<MAXD, MAXC>(cols, row, x, k);
    float best_v = -INFINITY;
    int best = 0;
    for (int cc = 0; cc < C; ++cc) {
      const float* Lc = L + int64_t(cc) * m * r;
      float q = 0.0f;
      for (int i = 0; i < r; i += 4) {
        float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < MAXD; ++j)
          if (j < d) {
            const float4 l =
                __ldg(reinterpret_cast<const float4*>(Lc + j * r + i));
            y[0] = __fadd_rn(y[0], __fmul_rn(x[j], l.x));
            y[1] = __fadd_rn(y[1], __fmul_rn(x[j], l.y));
            y[2] = __fadd_rn(y[2], __fmul_rn(x[j], l.z));
            y[3] = __fadd_rn(y[3], __fmul_rn(x[j], l.w));
          }
#pragma unroll
        for (int j = 0; j < MAXC; ++j)
          if (j < c && k[j] >= 0) {
            const float4 l =
                __ldg(reinterpret_cast<const float4*>(Lc + k[j] * r + i));
            y[0] = __fadd_rn(y[0], l.x);
            y[1] = __fadd_rn(y[1], l.y);
            y[2] = __fadd_rn(y[2], l.z);
            y[3] = __fadd_rn(y[3], l.w);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) q = __fadd_rn(q, __fmul_rn(y[e], y[e]));
      }
      const float s = __fsub_rn(
          linear_term<MAXD, MAXC>(cols, __ldg(b + cc), lin + int64_t(cc) * m,
                                  x, k),
          q);
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
  const size_t smem = qda_smem_bytes(qg.m, qg.r, qg.C);
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

template <int MAXD, int MAXC>
int launch_qda_wide(const Cols& cols, const QdaGeom& qg, const float* L,
                    const float* lin, const float* b, int32_t* out,
                    int nblocks, cudaStream_t s) {
  qda_wide_kernel<MAXD, MAXC><<<nblocks, kThreads, 0, s>>>(cols, qg, L, lin,
                                                           b, out);
  return cudaGetLastError();
}

using QdaLaunch = int (*)(const Cols&, const QdaGeom&, const float*,
                          const float*, const float*, int32_t*, int,
                          cudaStream_t);

// Checks shared by both entry points; fills cols (offsets less the
// leading constant feature) and qg. 0 or a cudaError_t.
inline int qda_setup(const void* const* x_cols, int d,
                     const void* const* code_cols, const int* cat_sizes,
                     int c, int C, int m, int r, int64_t n, int nblocks,
                     Cols& cols, QdaGeom& qg) {
  if (d < 0 || c < 0 || d > kMaxQdaCols || c > kMaxQdaCols || C < 1 ||
      nblocks < 1 || n < 0 || r < 0)
    return cudaErrorInvalidValue;
  int mm = d;
  for (int j = 0; j < c; ++j) {
    if (cat_sizes[j] < 0) return cudaErrorInvalidValue;
    mm += cat_sizes[j];
  }
  if (mm != m) return cudaErrorInvalidValue;
  // sigma-layout offsets (1 + d + ...) less the leading constant feature
  cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  for (int j = 0; j < c; ++j) cols.off[j] -= 1;
  qg = QdaGeom{m, r, C, n};
  return 0;
}

// The instances for the wider of d and c: MAXD = MAXC ∈ {4, 8, 16, 32}.
inline QdaLaunch pick_smem(int d, int c) {
  const int wide = d > c ? d : c;
  QdaLaunch launch = launch_qda<32, 32>;
  if (wide <= 16) launch = launch_qda<16, 16>;
  if (wide <= 8) launch = launch_qda<8, 8>;
  if (wide <= 4) launch = launch_qda<4, 4>;
  return launch;
}

inline QdaLaunch pick_wide(int d, int c) {
  const int wide = d > c ? d : c;
  QdaLaunch launch = launch_qda_wide<32, 32>;
  if (wide <= 16) launch = launch_qda_wide<16, 16>;
  if (wide <= 8) launch = launch_qda_wide<8, 8>;
  if (wide <= 4) launch = launch_qda_wide<4, 4>;
  return launch;
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K3 on `stream`. L f32[C, m, r], lin f32[C, m], b f32[C], with
// m = d + Σ cat_sizes, all within kMaxQdaSmem; out i32[n].
// Returns 0 or a cudaError_t.
int dit_qda_predict(const void* const* x_cols, int d,
                    const void* const* code_cols, const int* cat_sizes,
                    int c, const float* L, const float* lin, const float* b,
                    int C, int m, int r, int64_t n, int32_t* out,
                    int nblocks, void* stream) {
  using namespace dit;
  Cols cols;
  QdaGeom qg;
  if (int rc = qda_setup(x_cols, d, code_cols, cat_sizes, c, C, m, r, n,
                         nblocks, cols, qg))
    return rc;
  if (qda_smem_bytes(m, r, C) > kMaxQdaSmem) return cudaErrorInvalidValue;
  return pick_smem(d, c)(cols, qg, L, lin, b, out, nblocks,
                         static_cast<cudaStream_t>(stream));
}

// Launches K3w on `stream`: as dit_qda_predict, any factor size, with r a
// multiple of kQdaRankAlign and L 16-byte aligned.
int dit_qda_predict_wide(const void* const* x_cols, int d,
                         const void* const* code_cols, const int* cat_sizes,
                         int c, const float* L, const float* lin,
                         const float* b, int C, int m, int r, int64_t n,
                         int32_t* out, int nblocks, void* stream) {
  using namespace dit;
  Cols cols;
  QdaGeom qg;
  if (int rc = qda_setup(x_cols, d, code_cols, cat_sizes, c, C, m, r, n,
                         nblocks, cols, qg))
    return rc;
  if (r % kQdaRankAlign || reinterpret_cast<uintptr_t>(L) % 16)
    return cudaErrorInvalidValue;
  return pick_wide(d, c)(cols, qg, L, lin, b, out, nblocks,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
