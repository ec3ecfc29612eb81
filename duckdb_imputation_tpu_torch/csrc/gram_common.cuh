// Shared device code of the masked-Gram kernels (masked_gram.cu,
// fused_impute_aggregate.cu and grouped_gram.cu), for sm_90a, plain f32
// on the CUDA cores.
//
// Both kernels compute S = Zᵀ·diag(w)·Z with Z = [1 ‖ x ‖ onehot(codes)],
// P = 1 + d + V, over per-column inputs, in the same deterministic scheme:
//
//   1. A block stages kChunk = 256 rows at a time: one thread per row loads
//      the row's d floats and c codes (coalesced across the block) and
//      writes the row's dense Z (one-hot expanded) into a shared-memory
//      tile. The one-hot never touches device memory. Rows past n are
//      written as zeros with weight 0, so a ragged n needs no padding.
//   2. Each thread owns one 4×4 tile of the upper triangle of S and one
//      group of rows, and accumulates w·z_i·z_j over its rows in f32
//      registers, in a fixed row order.
//   3. After its last chunk the block sums its row groups in f64, in a
//      fixed order, into a per-block partial in device memory.
//   4. gram_reduce sums the partials over blocks in f64, each entry by one
//      warp in a fixed order and shuffle tree, and rounds to f32 once.
//
// No float atomics anywhere, so repeated runs are bit-identical (the LDA
// argmax downstream must not flip between runs). Counts stay exact: a
// thread's f32 count is at most n/(gridDim·G) + 256 rows (below 2²⁴ for
// any n this kernel takes, n < 2³¹), and every sum across threads and
// blocks is in f64, which holds integers exactly up to 2⁵³.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace dit {
namespace {  // internal linkage: each kernel file gets its own copy

constexpr int kThreads = 256;  // threads per block
constexpr int kChunk = 256;    // rows staged per step: one per thread
constexpr int kMaxP = 88;      // ceil(88/4) = 22 → 253 tiles ≤ kThreads
// Columns of each kind the kernel parameter holds: every column of a
// narrow schema (P ≤ kMaxP: d, c ≤ 87), whose kernels index the arrays
// directly; a wide kernel reads column j ≥ kInlineCols from `far`.
constexpr int kInlineCols = kMaxP;

// Per-column inputs, passed by value as a kernel parameter
// (__grid_constant__: device code reads it in place, indexed, no copy).
// Past kInlineCols columns of a kind, `far` (device memory, built once a
// call by the host from the same columns: ring/kernels/_build.py:
// far_table) holds every column, int64 [x (d) | code (c) | size (c) |
// off (c)]; the accessors read the parameter below kInlineCols and `far`
// above, so a schema of at most kInlineCols columns of each kind reads
// only the parameter, as before.
struct Cols {
  const float* x[kInlineCols];
  const int32_t* code[kInlineCols];
  int size[kInlineCols];  // vocab size of categorical column j
  int off[kInlineCols];   // sigma index of its category 0: 1 + d + offsets[j]
  const int64_t* far;     // nullptr when d, c ≤ kInlineCols
  int d, c;

  __device__ __forceinline__ const float* xp(int j) const {
    return j < kInlineCols ? x[j] : reinterpret_cast<const float*>(far[j]);
  }
  __device__ __forceinline__ const int32_t* cp(int j) const {
    return j < kInlineCols ? code[j]
                           : reinterpret_cast<const int32_t*>(far[d + j]);
  }
  __device__ __forceinline__ int sz(int j) const {
    return j < kInlineCols ? size[j] : static_cast<int>(far[d + c + j]);
  }
  __device__ __forceinline__ int of(int j) const {
    return j < kInlineCols ? off[j] : static_cast<int>(far[d + 2 * c + j]);
  }
};

struct Geom {
  int P;     // sigma size
  int NT;    // 4×4 tiles per side, ceil(P / 4)
  int T;     // tiles of the upper triangle, NT(NT+1)/2
  int G;     // row groups, kThreads / T
  int PS;    // shared row stride of the Z tile: 4·NT + 1 (odd: no bank
             // conflicts when 32 threads write 32 rows)
  int64_t n;
};

inline Geom make_geom(int P, int64_t n) {
  Geom g;
  g.P = P;
  g.NT = (P + 3) / 4;
  g.T = g.NT * (g.NT + 1) / 2;
  g.G = kThreads / g.T;
  g.PS = 4 * g.NT + 1;
  g.n = n;
  return g;
}

// Floats of shared memory the Gram phase needs: the Z tile and the row
// weights, or the f32 scratch of the block's row-group sum, if larger.
inline int gram_smem_floats(const Geom& g) {
  int tile = kChunk * g.PS + kChunk;
  int scratch = g.G * g.T * 16;
  return tile > scratch ? tile : scratch;
}

// Entries of a per-block partial: 16 per tile.
inline int gram_entries(const Geom& g) { return g.T * 16; }

// Checks shared by the entry points; 0 or a cudaError_t. max_p: the
// kernel's sigma-size limit (kMaxP here, kMaxWideP for wide_gram.cuh);
// far: the columns' device table, needed past kInlineCols of a kind (a
// narrow kernel, which takes none, so takes at most kInlineCols).
inline int check_cols(int d, int c, const int* cat_sizes, int P, int64_t n,
                      int nblocks, int max_p = kMaxP,
                      const int64_t* far = nullptr) {
  if (d < 0 || c < 0) return cudaErrorInvalidValue;
  if ((d > kInlineCols || c > kInlineCols) && far == nullptr)
    return cudaErrorInvalidValue;
  int64_t p = 1 + d;   // the levels' sum may pass an int before it is checked
  for (int j = 0; j < c; ++j) {
    if (cat_sizes[j] < 0) return cudaErrorInvalidValue;
    p += cat_sizes[j];
  }
  if (p != P || P > max_p) return cudaErrorInvalidValue;
  if (n < 0 || n >= (int64_t(1) << 31) || nblocks < 1) return cudaErrorInvalidValue;
  return 0;
}

// The parameter's columns (the first kInlineCols of each kind) and `far`.
inline Cols make_cols(const void* const* x_cols, int d,
                      const void* const* code_cols, const int* cat_sizes,
                      int c, const int64_t* far = nullptr) {
  Cols cols{};
  cols.d = d;
  cols.c = c;
  cols.far = far;
  int off = 1 + d;
  for (int j = 0; j < d && j < kInlineCols; ++j)
    cols.x[j] = static_cast<const float*>(x_cols[j]);
  for (int j = 0; j < c; ++j) {
    if (j < kInlineCols) {
      cols.code[j] = static_cast<const int32_t*>(code_cols[j]);
      cols.size[j] = cat_sizes[j];
      cols.off[j] = off;
    }
    off += cat_sizes[j];
  }
  return cols;
}

// Tile t of the upper triangle → (ti, tj), ti ≤ tj, row-major.
__device__ __forceinline__ void tile_coords(int t, int NT, int& ti, int& tj) {
  ti = 0;
  while (t >= NT - ti) {
    t -= NT - ti;
    ++ti;
  }
  tj = ti + t;
}

// Dense Z of row `row` into zr[0 .. PS): 1, the d numerics, the one-hots
// (a code outside [0, size) sets nothing), zeros in the padding.
__device__ __forceinline__ void build_row(float* zr, const Cols& cols,
                                          int64_t row, int PS) {
  zr[0] = 1.0f;
  for (int j = 0; j < cols.d; ++j) zr[1 + j] = cols.x[j][row];
  for (int p = 1 + cols.d; p < PS; ++p) zr[p] = 0.0f;
  for (int j = 0; j < cols.c; ++j) {
    int code = cols.code[j][row];
    if (code >= 0 && code < cols.size[j]) zr[cols.off[j] + code] = 1.0f;
  }
}

__device__ __forceinline__ void zero_row(float* zr, int PS) {
  for (int p = 0; p < PS; ++p) zr[p] = 0.0f;
}

// acc += Σ over this thread's rows of the staged chunk (g, g + G, ...) of
// (w·z[i0..i0+4)) ⊗ z[j0..j0+4).
__device__ __forceinline__ void accumulate_chunk(const float* zs,
                                                 const float* ws,
                                                 const Geom& gm, int i0,
                                                 int j0, int g,
                                                 float acc[16]) {
  for (int r = g; r < kChunk; r += gm.G) {
    const float* zr = zs + r * gm.PS;
    const float w = ws[r];
    float a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = zr[i0 + k] * w;
      b[k] = zr[j0 + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[k * 4 + l] += a[k] * b[l];
  }
}

// The block's row groups summed in f64, in group order, into
// partial[e·stride + slot]. `scratch` may alias the Z tile.
__device__ __forceinline__ void write_partial_at(const float acc[16],
                                                 bool active, int t, int g,
                                                 float* scratch,
                                                 const Geom& gm,
                                                 double* partial,
                                                 int64_t stride,
                                                 int64_t slot) {
  __syncthreads();
  if (active)
    for (int e = 0; e < 16; ++e) scratch[(g * gm.T + t) * 16 + e] = acc[e];
  __syncthreads();
  const int E = gm.T * 16;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    double s = 0.0;
    for (int gg = 0; gg < gm.G; ++gg) s += scratch[gg * E + e];
    partial[int64_t(e) * stride + slot] = s;
  }
}

// The same into partial[e·gridDim + blockIdx]: one partial per block.
__device__ __forceinline__ void write_block_partial(const float acc[16],
                                                    bool active, int t,
                                                    int g, float* scratch,
                                                    const Geom& gm,
                                                    double* partial) {
  write_partial_at(acc, active, t, g, scratch, gm, partial, gridDim.x,
                   blockIdx.x);
}

// The Gram phase shared by both kernels: thread → (tile, row group).
struct TileOwner {
  int t, g, i0, j0;
  bool active;
  __device__ __forceinline__ explicit TileOwner(const Geom& gm) {
    t = threadIdx.x % gm.T;
    g = threadIdx.x / gm.T;
    active = g < gm.G;
    int ti, tj;
    tile_coords(t, gm.NT, ti, tj);
    i0 = 4 * ti;
    j0 = 4 * tj;
  }
};

// Cross-block sum: one warp per partial entry, lanes stride over blocks,
// then a fixed shuffle tree; f64 throughout, one rounding to f32. Writes
// both triangles of the full symmetric sigma f32[P, P].
__global__ void gram_reduce(const double* __restrict__ partial, int nblocks,
                            Geom gm, float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= gm.T * 16) return;
  double s = 0.0;
  for (int b = lane; b < nblocks; b += 32) s += partial[int64_t(warp) * nblocks + b];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  int ti, tj;
  tile_coords(warp / 16, gm.NT, ti, tj);
  const int i = 4 * ti + (warp % 16) / 4;
  const int j = 4 * tj + (warp % 16) % 4;
  if (i < gm.P && j < gm.P && i <= j) {
    const float v = static_cast<float>(s);
    out[i * gm.P + j] = v;
    out[j * gm.P + i] = v;
  }
}

inline void launch_gram_reduce(const double* partial, int nblocks,
                               const Geom& gm, float* out,
                               cudaStream_t stream) {
  const int warps = gm.T * 16;
  const int blocks = (warps * 32 + kThreads - 1) / kThreads;
  gram_reduce<<<blocks, kThreads, 0, stream>>>(partial, nblocks, gm, out);
}

}  // namespace
}  // namespace dit
