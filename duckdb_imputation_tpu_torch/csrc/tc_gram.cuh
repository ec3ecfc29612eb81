// The masked Gram S = Zᵀ·diag(w)·Z on Hopper's tensor cores, exact to f32
// accumulation, for P ≤ kMaxP = 88 (Z = [1 ‖ x ‖ onehot(codes)]): the core
// of K1 (masked_gram.cu), for sm_90a.
//
// The split. The tensor cores take no f32, and TF32 stays off, so every
// f32 value v is cut into three bf16 parts, h = bf16(v), m = bf16(v − h),
// l = bf16(v − h − m). Each residual is exact in f32 (Sterbenz), and each
// part carries the next 8 significant bits, so h + m + l == v exactly for
// every v that is a multiple of 2⁻¹³³ (all normal values of magnitude ≥
// 2⁻¹¹⁰; below, bf16's subnormal step drops less than 2⁻¹³³). A bf16 ×
// bf16 product is exact in f32, so the Gram of the parts carries every
// product exactly; only the f32 accumulation differs from a plain f32 sum.
// All nine part products are kept.
//
//   left  L[r, (a, p)] = part p of f32(w·z_a)   (as gram_common.cuh's z·w), 3P
//   right R[r, b′]     = 1; the 3 parts of x_b; onehot(codes)   1 + 3d + V
//   S[a, b] = Σ_{p, b′ of b} Σ_r L[r, (a, p)]·R[r, b′]
//
// At BASELINE config 5 (d = 4, c = 2, P = 21) that is a 63 × 29 product of
// the parts (padded to 64 × 32): the one output tile this kernel takes,
// P ≤ kTcA = 21 (3P left features ≤ kTcLeft = 64) and 1 + 3d + V ≤ kTcRight
// = 32 (tc_fits). A larger S would need tiles that each stage the rows
// again; tiled so, it lost to masked_gram.cu's CUDA-core kernel at every
// schema measured (PERF.md §6), which therefore takes every larger P.
//
// A block of kTcThreads = 128 threads takes kTcRows = 128 rows a step
// (the grid: at most _build.TC_MAX_BLOCKS = 660 blocks, one wave of 5 an
// SM; ptxas's registers in PERF.md §5):
//   1. Thread t copies row t of a step (w, x, codes: 28 B a row at config
//      5) with cp.async into kTcStages = 4 raw buffers, three steps ahead:
//      its own copies, so its wait_group is all the staging needs.
//   2. Each thread writes its row's parts into the operand tiles, laid out
//      [feature][row] in bf16 (row stride kTcStride = 136: ldmatrix rows
//      272 B apart fall on distinct banks). The one-hot parts are written
//      only at the row's codes into tiles zeroed once, and cleared at the
//      next step; the constant column is written once.
//   3. Warp w takes the m16 tile w of the output (left features 16w ..
//      16w + 15) and all 4 n8 tiles over the step's 128 rows: per k16 step
//      one ldmatrix of the left tile, two of the right and 4
//      mma.sync.m16n8k16 bf16 → f32, into two sets of fragments (even and
//      odd k16 steps: half the chain of dependent products).
//   4. Every kTcFlushSteps = 4 steps (16 products of k16, 256 rows, in an
//      f32 value) each thread adds its fragments to f64 registers. The
//      tensor cores' f32 sums need not round to nearest: their bias grows
//      with the terms summed in f32 (max error of S relative to max|σ| at
//      config 5, 10M rows: 6.3e-8 summing 4 products, 1.3e-7 at 8, 3.1e-7
//      at 16 as built (4.0e-7 general weights, 3.0e-7 at 100M rows),
//      7.5e-7 at 32, 3.6e-6 at 128 (4.7e-6 general), 1.9e-5 with no
//      flush, 2.3e-4 with none at 100M; tools/k1_variants.py, PERF.md).
//   1′. A prologue (tc_gram_prologue_kernel's template argument) may
//      stage more columns of a row, and rewrite the thread's staged row
//      between its wait_group and step 2: K1's does nothing; K2's
//      (fused_impute_aggregate.cu: TcImpute) stages the row's null byte,
//      scores a null row from its staged values and coefficients in shared
//      memory, writes the new value out and puts it in the staged row, so
//      steps 2-5 aggregate the updated row.
//   5. After its last step the block folds S′ into S in f64, in a fixed
//      order (p, then b′), into its partial; tc_gram_reduce sums the
//      blocks in f64 and rounds to f32 once, writing S[a, b] and S[b, a]
//      for a ≤ b.
//   Which rows a step takes, and which slot of the partial it is summed
//   into, is the `Rows` argument of the body: K1's (TcGridRows) are the
//   grid-strided steps of the n rows, one slot a block. The grouped
//   Gram's (grouped_gram.cu: GroupRows) are runs of group-aligned steps,
//   read directly or through a list of row indices, one slot a (run,
//   group); at a step of a new slot the block flushes its fragments,
//   folds S′ into the last slot as in 5., and clears the tiles and sums
//   before it goes on.
// No atomics: reruns are bit-identical; counts are exact (binary weights:
// integer parts, f32 sums of at most 256 rows, f64 beyond).
//
// What bounds it: one read of the inputs is the floor (0.084 ms per 10M
// rows at config 5); the tensor cores' work (32 mma a warp a step) is a
// small part. A step's staging (~3 + 6d + 8c bf16 stores a row, the
// one-hot writes and clears included, and 11 splits at config 5) and its
// products each take about half the kernel's time alone, and the two
// barriers of a step let them overlap only across the 5 blocks of an SM:
// it is bound by the latency of those two phases (PERF.md §6).
#pragma once

#include <cuda_bf16.h>

#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kTcThreads = 128;             // threads of a block, 4 warps
constexpr int kTcRows = 128;                // rows a block stages a step
constexpr int kTcStride = kTcRows + 8;      // bf16 row stride of a tile
constexpr int kTcA = 21;                    // most P: 3 parts of each a
constexpr int kTcLeft = 64;                 // left features: 4 m16 tiles
constexpr int kTcRight = 32;                // right features: 4 n8 tiles
constexpr int kTcAcc = 16;                  // f32 fragment values a thread
constexpr int kTcFlushSteps = 4;            // steps between f64 flushes
constexpr int kTcStages = 4;                // raw buffers: 3 steps ahead
static_assert(3 * kTcA <= kTcLeft, "three parts of each a in the tile");
static_assert(kTcThreads == kTcRows, "one row a thread");
static_assert(kTcLeft == 16 * (kTcThreads / 32), "one m16 tile a warp");

// Right feature of value b: 1 for the constant, 3 parts for each x, 1 for
// each one-hot.
__host__ __device__ __forceinline__ int right_feature(int b, int d) {
  return b == 0 ? 0 : b <= d ? 1 + 3 * (b - 1) : 1 + 3 * d + (b - 1 - d);
}
__host__ __device__ __forceinline__ int right_parts(int b, int d) {
  return b >= 1 && b <= d ? 3 : 1;
}

// Whether S f32[P, P] of d numerics is one output tile: mirrored by
// ring/kernels/_build.py: tc_fits.
inline bool tc_fits(int d, int P) {
  return P <= kTcA && right_feature(P - 1, d) + right_parts(P - 1, d) <=
                          kTcRight;
}

__device__ __forceinline__ void split3(float v, __nv_bfloat16* p, int s) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  p[0] = h;
  p[s] = m;
  p[2 * s] = __float2bfloat16_rn(r1 - __bfloat162float(m));
}

__device__ __forceinline__ void tc_stage4(float* dst, const void* src,
                                          bool valid, float zero) {
  if (valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = zero;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K1's prologue: nothing staged beside w, x and codes, nothing done
// before a row is built.
struct TcNoPrologue {
  static constexpr int kExtraCols = 0;   // staged columns after the codes
  int smem_floats() const { return 0; }
  __device__ __forceinline__ void load(float*) const {}
  __device__ __forceinline__ void stage(float*, int64_t, bool) const {}
  __device__ __forceinline__ void apply(float*, const float*, const Cols&,
                                        int64_t, bool) const {}
};

// Shared memory of a block: the operand tiles (after the last step they
// hold the f64 sums for the fold), kTcStages raw buffers of 1 + d + c
// (+ the prologue's) columns, the one-hot positions each thread wrote
// (left and right, one per column), the prologue's floats.
template <class Pro>
inline size_t tc_smem_bytes(int d, int c, const Pro& pro) {
  return sizeof(__nv_bfloat16) * (kTcLeft + kTcRight) * kTcStride +
         sizeof(float) * kTcStages * (1 + d + c + Pro::kExtraCols) *
             kTcRows +
         sizeof(short) * 2 * c * kTcRows + sizeof(float) * pro.smem_floats();
}
static_assert(sizeof(__nv_bfloat16) * (kTcLeft + kTcRight) * kTcStride >=
                  sizeof(double) * kTcAcc * kTcThreads,
              "the f64 sums fit the operand tiles");

// Entries (a, b) of a block partial.
constexpr int kTcEntries = kTcA * kTcA;

// The rows of one step: positions first + t (t < kTcRows) below end, all
// summed into the block partial's slot `slot`.
struct TcStep {
  int64_t first, end;
  int64_t slot;
};

// K1's rows: block b's step s is the chunk b + s·gridDim.x of the n rows,
// read in place; one partial a block (slot blockIdx.x of gridDim.x). A
// Rows type names the cursor a caller keeps to walk the steps in order
// (here none is needed).
struct TcGridRows {
  static constexpr bool kGrouped = false;
  struct Cursor {};
  int64_t n;
  int steps;      // steps of this block
  __device__ __forceinline__ explicit TcGridRows(int64_t n_) : n(n_) {
    const int64_t nch = (n + kTcRows - 1) / kTcRows;
    steps = blockIdx.x < nch ? static_cast<int>((nch - blockIdx.x +
                                                 gridDim.x - 1) / gridDim.x)
                             : 0;
  }
  __device__ __forceinline__ Cursor cursor() const { return {}; }
  __device__ __forceinline__ TcStep at(int s, Cursor&) const {
    return {(blockIdx.x + int64_t(s) * gridDim.x) * kTcRows, n, blockIdx.x};
  }
  __device__ __forceinline__ int64_t source(int64_t pos) const { return pos; }
  __device__ __forceinline__ int64_t stride() const { return gridDim.x; }
};

// A thread's row (raw column values rb[col·kTcRows]) into the operand
// tiles at its column: the one-hot parts it wrote last step cleared (pv),
// the dense parts, the new one-hot parts at its codes.
__device__ __forceinline__ void build_row(
    const float* __restrict__ rb, __nv_bfloat16* __restrict__ left,
    __nv_bfloat16* __restrict__ right, short* __restrict__ pv,
    const Cols& cols) {
  const int d = cols.d, c = cols.c;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const float wv = rb[0];
  for (int j = 0; j < c; ++j) {
    const int pl = pv[j * kTcRows];
    const int pr = pv[(c + j) * kTcRows];
    if (pl >= 0) {
      left[pl * kTcStride] = zero;
      left[(pl + 1) * kTcStride] = zero;
      left[(pl + 2) * kTcStride] = zero;
    }
    if (pr >= 0) right[pr * kTcStride] = zero;
  }
  for (int a = 0; a < 1 + d; ++a)
    split3(a == 0 ? wv : rb[a * kTcRows] * wv, left + 3 * a * kTcStride,
           kTcStride);
  for (int b = 1; b < 1 + d; ++b)
    split3(rb[b * kTcRows], right + right_feature(b, d) * kTcStride,
           kTcStride);
  for (int j = 0; j < c; ++j) {
    const int code = __float_as_int(rb[(1 + d + j) * kTcRows]);
    int pl = -1, pr = -1;
    if (code >= 0 && code < cols.size[j]) {
      const int a = cols.off[j] + code;
      pl = 3 * a;
      split3(wv, left + pl * kTcStride, kTcStride);
      pr = right_feature(a, d);
      right[pr * kTcStride] = __float2bfloat16_rn(1.0f);
    }
    pv[j * kTcRows] = static_cast<short>(pl);
    pv[(c + j) * kTcRows] = static_cast<short>(pr);
  }
}

// The operand tiles zeroed and no one-hot position on record (the caller
// syncs, then writes the constant).
__device__ __forceinline__ void tc_tiles_clear(__nv_bfloat16* tiles,
                                               short* prev, int c) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = threadIdx.x; e < (kTcLeft + kTcRight) * kTcStride;
       e += kTcThreads)
    tiles[e] = zero;
  for (int e = threadIdx.x; e < 2 * c * kTcRows; e += kTcThreads) prev[e] = -1;
}

// 5.: a thread's f64 sums into shared memory over the operand tiles (the
// caller clears them after, if it goes on), then S′ folded into S[a, b],
// a ≤ b < P, in f64, in a fixed order (p, then b′), into
// partial[e·stride + slot], e = a·kTcA + b.
__device__ __forceinline__ void tc_fold(const double sum64[4][4],
                                        unsigned char* smem, int P, int d,
                                        double* __restrict__ partial,
                                        int64_t stride, int64_t slot) {
  const int tid = threadIdx.x;
  __syncthreads();
  double* acc64 = reinterpret_cast<double*>(smem);   // [kTcAcc][threads]
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc64[(ni * 4 + k) * kTcThreads + tid] = sum64[ni][k];
  __syncthreads();
  for (int e = tid; e < kTcEntries; e += kTcThreads) {
    const int a = e / kTcA, b = e % kTcA;
    double sum = 0.0;
    if (a <= b && b < P) {
      const int n0 = right_feature(b, d), nq = right_parts(b, d);
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < nq; ++q) {
          const int m = 3 * a + p, nn = n0 + q;
          const int mr = m & 15, nr = nn & 7;
          const int ln = (mr & 7) * 4 + (nr >> 1);
          const int k = (mr >> 3) * 2 + (nr & 1);
          const int at = (nn >> 3) * 4 + k;
          sum += acc64[at * kTcThreads + (m >> 4) * 32 + ln];
        }
    }
    partial[int64_t(e) * stride + slot] = sum;
  }
}

// The kernel's body, shared by K1's kernel, the kernels with a prologue,
// which differ only in their __launch_bounds__, and the grouped Gram's
// (grouped_gram.cu), which differs in its Rows.
template <class Pro, class Rows>
__device__ __forceinline__ void tc_gram_steps(const Cols& cols, int P,
                                              const float* __restrict__ w,
                                              const Rows& rows,
                                              double* __restrict__ partial,
                                              const Pro& pro) {
  // a grouped block with no step writes no slot: the whole block leaves
  if (Rows::kGrouped && rows.steps == 0) return;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* left = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* right = left + kTcLeft * kTcStride;
  const int d = cols.d, c = cols.c, ncol = 1 + d + c + Pro::kExtraCols;
  float* raw = reinterpret_cast<float*>(right + kTcRight * kTcStride);
  short* prev = reinterpret_cast<short*>(raw + kTcStages * ncol * kTcRows);
  float* pro_smem = reinterpret_cast<float*>(prev + 2 * c * kTcRows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  tc_tiles_clear(left, prev, c);
  pro.load(pro_smem);
  __syncthreads();
  right[tid] = __float2bfloat16_rn(1.0f);   // the constant

  const int steps = rows.steps;
  // the cursors of the staging (steps ahead) and of the step at hand
  typename Rows::Cursor ahead = rows.cursor(), here = rows.cursor();
  int64_t slot = blockIdx.x;            // the step at hand's slot
  // thread tid copies (and builds) row tid of each step: its own copies,
  // so its wait_group is all the staging needs
  auto stage = [&](int s) {
    if (s < steps) {
      float* buf = raw + (s % kTcStages) * ncol * kTcRows + tid;
      const TcStep st = rows.at(s, ahead);
      const bool valid = st.first + tid < st.end;
      const int64_t row = valid ? rows.source(st.first + tid) : 0;
      tc_stage4(buf, w + row, valid, 0.0f);
      for (int j = 0; j < d; ++j)
        tc_stage4(buf + (1 + j) * kTcRows, cols.x[j] + row, valid, 0.0f);
      for (int j = 0; j < c; ++j)
        tc_stage4(buf + (1 + d + j) * kTcRows, cols.code[j] + row, valid,
                  __int_as_float(-1));
      pro.stage(buf + (1 + d + c) * kTcRows, row, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // two sets of f32 fragments, for even and odd k16 steps: half the chain
  // of dependent products
  float acc[2][4][4];
  double sum64[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[0][ni][k] = acc[1][ni][k] = 0.0f;
      sum64[ni][k] = 0.0;
    }

  // the f32 fragments added into the f64 sums
  auto flush = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sum64[ni][k] += static_cast<double>(acc[h][ni][k]);
          acc[h][ni][k] = 0.0f;
        }
  };

  for (int s = 0; s < kTcStages - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    stage(s + kTcStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 1));
    __syncthreads();   // the last step's products are done

    const TcStep st = rows.at(s, here);
    if constexpr (Rows::kGrouped) {
      const int64_t last = slot;
      slot = st.slot;
      if (s > 0 && slot != last) {   // the same for the whole block
        // S′ into the last slot, then the tiles and sums anew
        flush();
        tc_fold(sum64, tc_smem, P, d, partial, rows.stride(), last);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int k = 0; k < 4; ++k) sum64[ni][k] = 0.0;
        __syncthreads();   // every fold read of the tiles is done
        tc_tiles_clear(left, prev, c);
        __syncthreads();
        right[tid] = __float2bfloat16_rn(1.0f);
      }
    }

    // 1′. the prologue on this thread's staged row, then 2. the row into
    // the operand tiles
    float* rb = raw + (s % kTcStages) * ncol * kTcRows + tid;
    const bool valid = st.first + tid < st.end;
    pro.apply(rb, pro_smem, cols, valid ? rows.source(st.first + tid) : 0,
              valid);
    build_row(rb, left + tid, right + tid, prev + tid, cols);
    __syncthreads();   // every row of this step is in the tiles

    // 3. this warp's m16 tile of the output over the step's rows
#pragma unroll
    for (int k0 = 0; k0 < kTcRows; k0 += 16) {
      uint32_t af[4], bf[4][2];
      ldmatrix_x4(af, left + (warp * 16 + (lane & 15)) * kTcStride + k0 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, right + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   kTcStride + k0 + ((lane >> 3) & 1) * 8);
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[(k0 >> 4) & 1][ni], af, bf[ni][0], bf[ni][1]);
    }

    // 4. flush the f32 fragments into this thread's f64 sums
    if ((s + 1) % kTcFlushSteps == 0 || s + 1 == steps) flush();
  }

  // 5. S′ into the last step's slot
  tc_fold(sum64, tc_smem, P, d, partial, rows.stride(), slot);
}

// K1.
__global__ void __launch_bounds__(kTcThreads)
tc_gram_kernel(const __grid_constant__ Cols cols, int P,
               const float* __restrict__ w, int64_t n,
               double* __restrict__ partial) {
  tc_gram_steps(cols, P, w, TcGridRows(n), partial, TcNoPrologue());
}

// The Gram with the prologue `pro`, at least Pro::kMinBlocks blocks an SM.
template <class Pro>
__global__ void __launch_bounds__(kTcThreads, Pro::kMinBlocks)
tc_gram_prologue_kernel(const __grid_constant__ Cols cols, int P,
                        const float* __restrict__ w, int64_t n,
                        double* __restrict__ partial,
                        const __grid_constant__ Pro pro) {
  tc_gram_steps(cols, P, w, TcGridRows(n), partial, pro);
}

// One warp per entry (a, b): Σ over blocks in f64, a fixed shuffle tree,
// one rounding; writes S[a, b] and S[b, a] for a ≤ b < P.
__global__ void tc_gram_reduce(const double* __restrict__ partial,
                               int nblocks, int P, float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= kTcEntries) return;
  double s = 0.0;
  for (int b = lane; b < nblocks; b += 32)
    s += partial[int64_t(warp) * nblocks + b];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  const int a = warp / kTcA, b = warp % kTcA;
  if (a <= b && b < P) {
    const float v = static_cast<float>(s);
    out[a * P + b] = v;
    out[b * P + a] = v;
  }
}

// The kernel's shared memory allowed, the kernel, then tc_gram_reduce on
// `stream`.
template <class Kernel, class... Pro>
inline int launch_tc(Kernel kernel, size_t smem, const Cols& cols, int P,
                     const float* w, int64_t n, double* partial, int nblocks,
                     float* out, cudaStream_t stream, const Pro&... pro) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  kernel<<<nblocks, kTcThreads, smem, stream>>>(cols, P, w, n, partial,
                                                pro...);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int blocks = (kTcEntries * 32 + kThreads - 1) / kThreads;
  tc_gram_reduce<<<blocks, kThreads, 0, stream>>>(partial, nblocks, P, out);
  return cudaGetLastError();
}

// Launches K1 and its reduction on `stream` for a schema that tc_fits.
// partial: f64 scratch of kTcEntries · nblocks; out: f32[P, P].
inline int launch_tc_gram(const Cols& cols, int P, const float* w, int64_t n,
                          double* partial, int nblocks, float* out,
                          cudaStream_t stream) {
  return launch_tc(tc_gram_kernel,
                   tc_smem_bytes(cols.d, cols.c, TcNoPrologue()), cols, P, w,
                   n, partial, nblocks, out, stream);
}

// The same with the prologue `pro` (tc_gram_prologue_kernel).
template <class Pro>
inline int launch_tc_gram(const Cols& cols, int P, const float* w, int64_t n,
                          double* partial, int nblocks, float* out,
                          cudaStream_t stream, const Pro& pro) {
  return launch_tc(tc_gram_prologue_kernel<Pro>,
                   tc_smem_bytes(cols.d, cols.c, pro), cols, P, w, n,
                   partial, nblocks, out, stream, pro);
}

}  // namespace
}  // namespace dit
