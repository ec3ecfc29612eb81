// K2: one fused MICE pass, for sm_90a. Per row: score the previous
// column's model, impute it under its null mask, and accumulate the row's
// UPDATED Z, weighted by the next column's observed mask, into the masked
// Gram S = Zᵀ·diag(w)·Z.
//
// Replaces the Pallas kernels of duckdb_imputation_tpu/ring/kernels/
// sigma_fused.py: _fused_impute_aggregate_v3 (_fused3_kernel) and
// _fused_impute_aggregate_v2 (_fused_kernel), with their in-kernel PRNG
// (pltpu.prng_seed / prng_random_bits). Those score through a bf16 hi/lo
// split coefficient operand (pack_lhs) on the matrix unit; here the scores
// are plain f32 on the CUDA cores, added with __fadd_rn/__fmul_rn in the
// order of ring/sum.py's class_score, so the kernel and its plain version
// round identically and their argmaxes agree off NaN. A tie goes to the
// lowest class index, as in class_argmax.
//
// Noise (numeric columns): one counter-based Philox4x32-10 draw keyed by
// (seed) with counter (global row, round, column), then Box-Muller. The
// plain version in sigma_fused.py computes the same bits with int64 torch
// ops; only logf/cosf rounding may differ. Every schema has noise.
//
// What bounds it on an H100: the same as K1 (see masked_gram.cu): one row
// reads 4·d + 4·c + 5 bytes and writes 4, and the Gram phase issues about
// P(P+1)/2 products a row; the scoring adds R·(1 + d + c) products. The
// design reads each input once, scores from a row already staged in
// shared memory, keeps the coefficients in shared memory for the whole
// launch, and reuses K1's deterministic Gram scheme (gram_common.cuh).
//
// Each row is read and written by one thread, but the kernel writes the
// imputed column to a separate output buffer: the inputs stay unchanged.
//
// K2w, the same pass for P > 88 (dit_fused_impute_aggregate_wide), is the
// counterpart of _fused_impute_aggregate_v2 / _v3 at pack = 1. K2 keeps W
// f32[P, R] in shared memory, which at P = 492 and R = 337 would be 663 KB,
// past a block's 227 KB; and K7 (wide_gram.cuh) walks S's nonzeros in
// tasks over the grid. K2w is therefore two launches: an impute kernel
// that reads W from device memory (it stays in L2) and writes the new
// column, then K7 over the columns with the new one in the old one's
// place. Re-scoring the rows in every K7 task instead would cost R·(1 + d
// + c) operations a row per task, more than the Gram itself at R = 337.
// 'cat' takes one warp a row, lanes over classes, so W's reads are
// coalesced across a warp, and a shuffle tree picks the first max; 'num'
// takes one thread a row. Scores, ties and noise are K2's.
#include "wide_gram.cuh"

namespace dit {
namespace {

constexpr int kCat = 0;
constexpr int kNum = 1;

struct Noise {
  int on;
  uint32_t key0, key1;  // the seed
  uint32_t round, column;
  const float* std;     // f32[1] on the device
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += W0;
    k1 += W1;
  }
}

// N(0, 1) for global row `row`: Box-Muller on the first two Philox words,
// each mapped to (0, 1] as ((bits >> 8) + 1) · 2⁻²⁴.
__device__ __forceinline__ float row_normal(const Noise& nz, int64_t row) {
  uint32_t c[4] = {static_cast<uint32_t>(row),
                   static_cast<uint32_t>(static_cast<uint64_t>(row) >> 32),
                   nz.round, nz.column};
  philox4x32_10(c, nz.key0, nz.key1);
  const float u1 = static_cast<float>((c[0] >> 8) + 1u) * 0x1p-24f;
  const float u2 = static_cast<float>((c[1] >> 8) + 1u) * 0x1p-24f;
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318530717958647692f, u2)));
}

// Score of class k for the row staged in zr: (b_k + W₀ₖ), then each
// numeric term, then each categorical column's coefficient (none for an
// out-of-vocab code). W is f32[P, R] in shared memory.
__device__ __forceinline__ float class_score(const float* zr, int k, int R,
                                             const float* Ws,
                                             const float* bs,
                                             const Cols& cols, int64_t row) {
  float s = __fadd_rn(bs[k], Ws[k]);
  for (int j = 0; j < cols.d; ++j)
    s = __fadd_rn(s, __fmul_rn(Ws[(1 + j) * R + k], zr[1 + j]));
  for (int j = 0; j < cols.c; ++j) {
    const int code = cols.code[j][row];
    if (code >= 0 && code < cols.size[j])
      s = __fadd_rn(s, Ws[(cols.off[j] + code) * R + k]);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const __grid_constant__ Cols cols, const __grid_constant__ Geom gm,
             const uint8_t* __restrict__ null_imp,
             const float* __restrict__ w_agg, const float* __restrict__ w_full,
             const float* __restrict__ intercept, int R, int kind,
             int imp_col, void* out_col, const __grid_constant__ Noise nz,
             double* __restrict__ partial) {
  extern __shared__ float smem[];
  float* Ws = smem;                        // [P][R]
  float* bs = Ws + gm.P * R;               // [R]
  float* zs = bs + R;                      // [kChunk][PS], reused as scratch
  float* ws = zs + kChunk * gm.PS;         // [kChunk]
  for (int i = threadIdx.x; i < gm.P * R; i += blockDim.x) Ws[i] = w_full[i];
  for (int i = threadIdx.x; i < R; i += blockDim.x) bs[i] = intercept[i];
  const float noise_std = nz.on ? *nz.std : 0.0f;
  __syncthreads();

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
      const bool impute = null_imp[row] != 0;
      if (kind == kCat) {
        float best_v = -INFINITY;
        int best = 0;
        for (int k = 0; k < R; ++k) {
          const float s = class_score(zr, k, R, Ws, bs, cols, row);
          if (s > best_v) {
            best_v = s;
            best = k;
          }
        }
        const int old = cols.code[imp_col][row];
        const int val = impute ? best : old;
        static_cast<int32_t*>(out_col)[row] = val;
        const int off = cols.off[imp_col], size = cols.size[imp_col];
        if (old >= 0 && old < size) zr[off + old] = 0.0f;
        if (val >= 0 && val < size) zr[off + val] = 1.0f;
      } else {
        float val = zr[1 + imp_col];
        if (impute) {
          val = class_score(zr, 0, R, Ws, bs, cols, row);
          if (nz.on) val = __fadd_rn(val, __fmul_rn(noise_std, row_normal(nz, row)));
        }
        static_cast<float*>(out_col)[row] = val;
        zr[1 + imp_col] = val;
      }
      ws[threadIdx.x] = w_agg[row];
    } else {
      zero_row(zr, gm.PS);
      ws[threadIdx.x] = 0.0f;
    }
    __syncthreads();
    if (own.active) accumulate_chunk(zs, ws, gm, own.i0, own.j0, own.g, acc);
    __syncthreads();
  }
  write_block_partial(acc, own.active, own.t, own.g, zs, gm, partial);
}

// class_score for a row read from the columns themselves; W f32[P, R] and
// b f32[R] in device memory. Same order of __fadd_rn/__fmul_rn.
__device__ __forceinline__ float class_score_cols(const Cols& cols,
                                                  int64_t row, int k, int R,
                                                  const float* __restrict__ W,
                                                  const float* __restrict__ b) {
  float s = __fadd_rn(b[k], W[k]);
  for (int j = 0; j < cols.d; ++j)
    s = __fadd_rn(s, __fmul_rn(W[(1 + j) * R + k], cols.x[j][row]));
  for (int j = 0; j < cols.c; ++j) {
    const int code = cols.code[j][row];
    if (code >= 0 && code < cols.size[j])
      s = __fadd_rn(s, W[(cols.off[j] + code) * R + k]);
  }
  return s;
}

// K2w 'cat': one warp a row. Lane l scores classes l, l + 32, …, keeping
// its first max (strict >); the shuffle tree keeps the larger value and,
// on a tie, the lower class: the first max over all classes, class 0 when
// every score is -inf or NaN, as in K2.
__global__ void __launch_bounds__(kThreads)
impute_cat_wide_kernel(const __grid_constant__ Cols cols, int64_t n,
                       const uint8_t* __restrict__ null_imp,
                       const float* __restrict__ W,
                       const float* __restrict__ b, int R, int imp_col,
                       int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       row < n; row += warps) {
    int val = cols.code[imp_col][row];
    if (null_imp[row] != 0) {
      float best_v = -INFINITY;
      int best = 0;
      for (int k = lane; k < R; k += 32) {
        const float s = class_score_cols(cols, row, k, R, W, b);
        if (s > best_v) {
          best_v = s;
          best = k;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
        const int ok = __shfl_xor_sync(0xffffffffu, best, off);
        if (ov > best_v || (ov == best_v && ok < best)) {
          best_v = ov;
          best = ok;
        }
      }
      val = best;
    }
    if (lane == 0) out[row] = val;
  }
}

// K2w 'num': one thread a row, K2's prediction and noise.
__global__ void __launch_bounds__(kThreads)
impute_num_wide_kernel(const __grid_constant__ Cols cols, int64_t n,
                       const uint8_t* __restrict__ null_imp,
                       const float* __restrict__ W,
                       const float* __restrict__ b, int imp_col,
                       const __grid_constant__ Noise nz,
                       float* __restrict__ out) {
  const float noise_std = nz.on ? *nz.std : 0.0f;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    float val = cols.x[imp_col][row];
    if (null_imp[row] != 0) {
      val = class_score_cols(cols, row, 0, 1, W, b);
      if (nz.on) val = __fadd_rn(val, __fmul_rn(noise_std, row_normal(nz, row)));
    }
    out[row] = val;
  }
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K2 and its cross-block reduction on `stream`. kind: 0 = 'cat'
// (R classes, out_col i32[n]), 1 = 'num' (R = 1, out_col f32[n]).
// noise_std: f32[1] on the device, read only when noise is nonzero.
// partial: f64 scratch of dit_gram_entries(P) · nblocks; sigma: f32[P, P].
// Returns 0 or a cudaError_t.
int dit_fused_impute_aggregate(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const uint8_t* null_imp, const float* w_agg,
    const float* w_full, const float* intercept, int R, int kind,
    int imp_col, void* out_col, int noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t round, const float* noise_std, int64_t n,
    int P, double* partial, int nblocks, float* sigma, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (kind == kCat) {
    if (imp_col < 0 || imp_col >= c || R != cat_sizes[imp_col] || R < 1)
      return cudaErrorInvalidValue;
  } else if (kind == kNum) {
    if (imp_col < 0 || imp_col >= d || R != 1) return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Geom gm = make_geom(P, n);
  const Noise nz{noise, seed_lo, seed_hi, round,
                 static_cast<uint32_t>(imp_col), noise_std};
  const size_t smem = sizeof(float) * (P * R + R + gram_smem_floats(gm));
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  auto s = static_cast<cudaStream_t>(stream);
  fused_kernel<<<nblocks, kThreads, smem, s>>>(
      cols, gm, null_imp, w_agg, w_full, intercept, R, kind, imp_col,
      out_col, nz, partial);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  launch_gram_reduce(partial, nblocks, gm, sigma, s);
  return cudaGetLastError();
}

// Launches K2w on `stream`: the impute kernel of `kind`, then K7 over the
// columns with out_col in column imp_col's place. Arguments as
// dit_fused_impute_aggregate, except any P ≤ kMaxWideP; the plan (slabs ..
// shape) and partial as dit_wide_gram; sigma zeroed by the caller. Returns 0 or a cudaError_t.
int dit_fused_impute_aggregate_wide(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const uint8_t* null_imp, const float* w_agg,
    const float* w_full, const float* intercept, int R, int kind,
    int imp_col, void* out_col, int noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t round, const float* noise_std, int64_t n,
    int P, const int* slabs, const int* warp_begin, const int64_t* task_base,
    const int* stage_cols, const int* entries, const int* shape,
    double* partial, float* sigma, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP)) return rc;
  if (kind == kCat) {
    if (imp_col < 0 || imp_col >= c || R != cat_sizes[imp_col] || R < 1)
      return cudaErrorInvalidValue;
  } else if (kind == kNum) {
    if (imp_col < 0 || imp_col >= d || R != 1) return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  WidePlanArgs plan;
  int slices;
  if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                         shape, plan, slices))
    return rc;
  Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  auto s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (kind == kCat) {
      const int64_t want = (n + kThreads / 32 - 1) / (kThreads / 32);
      const int blocks = static_cast<int>(want < 8192 ? want : 8192);
      impute_cat_wide_kernel<<<blocks, kThreads, 0, s>>>(
          cols, n, null_imp, w_full, intercept, R, imp_col,
          static_cast<int32_t*>(out_col));
    } else {
      const Noise nz{noise, seed_lo, seed_hi, round,
                     static_cast<uint32_t>(imp_col), noise_std};
      const int64_t want = (n + kThreads - 1) / kThreads;
      const int blocks = static_cast<int>(want < 8192 ? want : 8192);
      impute_num_wide_kernel<<<blocks, kThreads, 0, s>>>(
          cols, n, null_imp, w_full, intercept, imp_col, nz,
          static_cast<float*>(out_col));
    }
    if (cudaError_t rc = cudaGetLastError()) return rc;
  }
  if (kind == kCat)
    cols.code[imp_col] = static_cast<const int32_t*>(out_col);
  else
    cols.x[imp_col] = static_cast<const float*>(out_col);
  return launch_wide_gram<false>(cols, plan, P, n, nullptr, nullptr, 1,
                                 slices, w_agg, partial, sigma, s);
}

}  // extern "C"
