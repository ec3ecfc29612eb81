// D on the tensor cores: the dense (1+d)×(1+d) block of [1 ‖ x] inside
// the masked Gram S = Zᵀ·diag(w)·Z of K7, K8 and K2w (wide_gram.cuh),
// D[a, b] = Σ_r w_r·z_r[a]·z_r[b] with z = [1 ‖ x], for sm_90a.
//
// Replaces, for schemas of many numeric columns (_build.DENSE_MIN_D and
// up), the D slabs of K7's plan (wide_gram.cuh: kSlabD, one warp a slab of
// at most 32 cells, a butterfly of shuffles and an f64 table add a cell a
// chunk of 32 rows), which computed on the CUDA cores what the Pallas
// kernels of duckdb_imputation_tpu/ring/kernels/sigma_pallas.py
// (_sigma_fast2_cols_kernel and its kin) compute on the matrix unit with
// bf16 splits. The slab plans of those schemas keep K_j and C_jk only
// (_build.dense_route); this kernel supplies D, in K7's one launch, in
// each column window (masked_gram_window and every wrapper that runs
// windows), in K8 (one S_g a group over group-sorted rows) and in K2w's
// Gram (over the columns with the imputed one in place).
//
// The split is K1's (tc_gram.cuh): each f32 value is cut into three bf16
// parts h, m, l with h + m + l == v, a bf16 × bf16 product is exact in
// f32, and all nine part products are kept, so only the f32 accumulation
// differs from an f64 sum. The left operand holds the parts of f32(w·z_a)
// (the value K1 and the slabs form), the right the parts of z_b; z_0 = 1.
//
//   1. The grid is (tile, row slice, group), one dimension, the tiles of a
//      slice side by side. A tile is 64 × 64 cells (a, b)
//      of D, a tile of the upper triangle (I ≤ J, from the host's list:
//      _build.dense_tiles), padded with zero columns past 1 + d. A group's
//      rows off[g] .. off[g + 1] (K7: 0 .. n) are cut into `slices` runs of
//      whole steps of kDgRows = 32 rows; no run crosses a group boundary.
//   2. A block (8 warps) stages a step's rows of the tile's 64 + 64
//      columns and w with cp.async, 16 bytes a copy, into a ring of two
//      stages. x is per-column device pointers (Cols::x, past 88 columns
//      the far table), so a 2-D TMA map does not fit and TMA is not used:
//      each column's run is copied from its 16-byte boundary at or below
//      the step's first row (9 copies of 4 rows; a copy that would pass 0
//      or n falls back to 4-byte copies), its slot shift kept a block.
//   3. Each thread splits 8 rows of a column into one of two buffers of
//      the operand tiles [part][column][row] in bf16 (row stride kDgStride
//      = 40: ldmatrix rows 80 B apart fall on distinct banks), reading and
//      writing 16 bytes at a time where the column's rows allow; rows
//      outside the block's run are written as zeros, whatever the staged
//      bytes held. The steps are pipelined: a step's products are issued
//      from one buffer, then the next step's rows are split into the other
//      while the tensor cores work, the copies of the step after in
//      flight; two barriers a step.
//   4. Warp (wm, wn) takes 32 × 16 cells of the tile: a k16 step loads
//      the three parts of its two m16 left fragments and, part by part,
//      its two n8 right fragments (ldmatrix), and issues the 36
//      mma.sync.m16n8k16 bf16 → f32 of the nine part products: h·h into
//      one set of fragments, the eight smaller products into another, so
//      h·h's f32 sum spans only 16 products between flushes (K1's
//      measured error, 3-4e-7 of max|σ| at 10M rows).
//   5. Every kDgFlushSteps = 8 steps (256 rows, K1's kTcFlushSteps) and
//      after the last, each thread adds its two sets to its cells' f64
//      sums in registers (a cell is one thread's); after its last step it
//      writes them to the partial slot of (group, tile, slice).
//   6. dense_gram_reduce sums each cell's slices in slice order in f64,
//      rounds to f32 once, and writes D[a, b] and D[b, a] from the one
//      a ≤ b value, each where its column lies in the window [lo, lo +
//      width), at out[g·gstride + i·ld + j − lo]: S stays exactly
//      symmetric, and a tile is computed in the same orientation, with the
//      same slices (_build.dense_slices: a function of n, d and G), in
//      every window.
// No float atomics: reruns are bit-identical; counts exact (binary w: the
// parts of w are w, 0, 0; f32 sums of at most 256 rows, f64 beyond). TF32
// plays no part.
//
// What bounds it on an H100: not the tensor cores. The triangle's nine
// products at 989 bf16 TFLOP/s take 11.7 ms at Epsilon's 400k rows; the
// kernel takes ~73 ms there (H100 80GB HBM3, 700.00 W), its first
// design (4 warps, one operand buffer, f64 sums in shared memory) ~110,
// and the same pipeline on wgmma, whose products cost the warps no issue
// slots, ~86 (PERF.md §6; neither kept). What it waits on is
// the CUDA cores' share: each staged value split into three bf16 parts in
// every tile that holds its column (at Epsilon each column is in 32
// tiles), the copies around it, and two barriers a step. Each tile stages
// its 128 columns again, so the bytes are ~2·(1+d)/64 reads of x (at
// Epsilon ~32); the tiles of one row slice are neighbours in the grid, so
// they run together and may share the slice's columns in L2 (the DRAM
// bytes read were not measured: PERF.md §7).
#include <cstddef>

#include "tc_gram.cuh"

namespace dit {
namespace {

constexpr int kDgTile = 64;             // columns of [1 ‖ x] a tile side
constexpr int kDgThreads = 256;         // 8 warps, 2 × 4 of 32 × 16 cells
constexpr int kDgRows = 32;             // rows a step: two k16 products
constexpr int kDgLine = kDgRows + 4;    // f32 slots of a staged column run
constexpr int kDgQuads = kDgLine / 4;   // 16-byte copies a column run
constexpr int kDgStride = kDgRows + 8;  // bf16 row stride of an operand tile
constexpr int kDgFlushSteps = 8;        // steps between f64 flushes
constexpr int kDgCells = kDgTile * kDgTile;
constexpr int kDgStages = 2;            // raw buffers: one step ahead
constexpr int kDgReduceThreads = 256;
constexpr int kDgW = 2 * kDgTile;       // w's run, after the two sides'
constexpr int kDgRuns = kDgW + 1;
static_assert(kDgThreads == 8 * 32, "2 × 4 warps of 32 × 16 cells");
static_assert(kDgRows % 16 == 0 && kDgLine % 4 == 0, "k16 steps, 16 B runs");

struct DgSmem {
  float raw[kDgStages][2][kDgTile][kDgLine];           // staged columns
  float wline[kDgStages][kDgLine];                     // staged w
  // two buffers of the operand tiles: a step's split into one while the
  // last step's products read the other
  uint16_t opa[2][3][kDgTile][kDgStride];              // bf16 parts of w·z_a
  uint16_t opb[2][3][kDgTile][kDgStride];              // bf16 parts of z_b
  // each run (a side's column, then w at kDgW): its column (nullptr: the
  // constant or padding), and the slot of the block's first row in a
  // staged run (rows from the 16-byte boundary at or below it); a step is
  // 32 rows on, so every step's first row has the same slot
  const float* src[kDgRuns];
  int shift[kDgRuns];
};
static_assert(offsetof(DgSmem, raw) == 0 &&
                  offsetof(DgSmem, wline) % 16 == 0 &&
                  offsetof(DgSmem, opa) % 16 == 0 &&
                  offsetof(DgSmem, opb) % 16 == 0 &&
                  (sizeof(float) * kDgLine) % 16 == 0 &&
                  (sizeof(uint16_t) * kDgStride) % 16 == 0,
              "16-byte copies and ldmatrix rows");

__device__ __forceinline__ int64_t dg_min(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The row of src's first 16-byte boundary at or below `row`'s element:
// a column's run of a step starts there, `row` at slot row − that.
__device__ __forceinline__ int dg_shift(const float* src, int64_t row) {
  return static_cast<int>(
      (static_cast<int64_t>(reinterpret_cast<uintptr_t>(src) >> 2) + row) &
      3);
}

// Rows r .. r + 3 of src into dst (16 bytes, aligned at both ends) with
// one copy where all four lie in [0, n), else the ones that do by 4-byte
// copies and zeros for the rest.
__device__ __forceinline__ void dg_stage_quad(float* dst, const float* src,
                                              int64_t r, int64_t n) {
  if (r >= 0 && r + 4 <= n) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + r));
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) tc_stage4(dst + k, src + (r + k), r + k >= 0 &&
                                        r + k < n, 0.0f);
}

__device__ __forceinline__ uint32_t dg_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight values into their three parts (tc_gram.cuh: split3, two values a
// conversion, each rounded to nearest as there) at dst, dst + ps, dst +
// 2·ps, eight rows side by side in each (16 bytes, the first row lowest).
__device__ __forceinline__ void dg_split8(const float v[8], uint16_t* dst,
                                          int ps) {
  uint32_t h[4], m[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 hb =
        __float22bfloat162_rn(make_float2(v[2 * k], v[2 * k + 1]));
    const float2 hf = __bfloat1622float2(hb);
    const float2 r1 = make_float2(v[2 * k] - hf.x, v[2 * k + 1] - hf.y);
    const __nv_bfloat162 mb = __float22bfloat162_rn(r1);
    const float2 mf = __bfloat1622float2(mb);
    h[k] = dg_bits(hb);
    m[k] = dg_bits(mb);
    l[k] = dg_bits(__float22bfloat162_rn(
        make_float2(r1.x - mf.x, r1.y - mf.y)));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(dst + ps) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(dst + 2 * ps) = make_uint4(l[0], l[1], l[2],
                                                       l[3]);
}

// Eight staged floats from p (16-byte aligned where `aligned`: two
// 16-byte loads, else eight).
__device__ __forceinline__ void dg_load8(float v[8], const float* p,
                                         bool aligned) {
  if (aligned) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
  }
}

// Steps 1-5 (the header) for one (tile, slice, group): the tile's f64
// sums into partial[((g·tiles + tile)·slices + slice)·kDgCells + cell],
// cell = (a − 64I)·64 + b − 64J. off: i64[G + 1] of group-sorted rows, or
// nullptr for K7 (rows 0 .. n, G = 1); tiles i32[tiles][2] (I, J).
__global__ void __launch_bounds__(kDgThreads, 2)
dense_gram_kernel(const __grid_constant__ Cols cols,
                  const float* __restrict__ w,
                  const int64_t* __restrict__ off, int64_t n,
                  const int* __restrict__ tiles, int ntiles, int slices,
                  double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char dg_raw_smem[];
  DgSmem& sm = *reinterpret_cast<DgSmem*>(dg_raw_smem);
  // block b: tile b % ntiles of slice (b / ntiles) % slices of group
  // b / (ntiles · slices): one slice's tiles are neighbours in the grid
  const unsigned b = blockIdx.x, bt = b / ntiles;
  const int tile = static_cast<int>(b - bt * ntiles);
  const int slice = static_cast<int>(bt % slices);
  const int g = static_cast<int>(bt / slices);
  const int ti = tiles[2 * tile], tj = tiles[2 * tile + 1];
  const int sides = ti == tj ? 1 : 2;        // a diagonal tile's b = its a
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = 1 + cols.d;

  // the slice's run of whole steps of the group's rows
  const int64_t g0 = off ? off[g] : 0, g1 = off ? off[g + 1] : n;
  const int64_t total = g1 > g0 ? (g1 - g0 + kDgRows - 1) / kDgRows : 0;
  const int64_t sps = (total + slices - 1) / slices;
  const int64_t s0 = dg_min(int64_t(slice) * sps, total);
  const int64_t s1 = dg_min(s0 + sps, total);
  const int64_t r_begin = g0 + s0 * kDgRows;
  const int64_t r_end = dg_min(g0 + s1 * kDgRows, g1);
  const int steps = static_cast<int>(s1 - s0);

  for (int e = tid; e < kDgRuns; e += kDgThreads) {
    const int a = (e < kDgTile ? ti : tj) * kDgTile + e % kDgTile;
    // column a of [1 ‖ x]: the constant (a = 0) and the padding have none
    const float* src = e == kDgW ? w
                       : a >= 1 && a < m ? cols.xp(a - 1) : nullptr;
    sm.shift[e] = src ? dg_shift(src, r_begin) : 0;
    sm.src[e] = src;
  }
  __syncthreads();

  // 2. the copies of step s (then a commit, a group even when empty):
  // each run's 9 quads of rows from its 16-byte boundary
  auto stage = [&](int s) {
    if (s < steps) {
      const int runs = sides * kDgTile + 1;          // + w's
      for (int e = tid; e < runs * kDgQuads; e += kDgThreads) {
        const int j = e / kDgQuads, q = e % kDgQuads;
        const int run = j == sides * kDgTile ? kDgW : j;
        const float* src = sm.src[run];
        if (src == nullptr) continue;
        float* dst = run == kDgW ? sm.wline[s & 1]
                                 : sm.raw[s & 1][run / kDgTile]
                                         [run % kDgTile];
        dg_stage_quad(dst + 4 * q, src, r_begin - sm.shift[run] +
                      int64_t(s) * kDgRows + 4 * q, n);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // 3. step s's rows into the operand tiles: a job 8 rows of a column,
  // read as two 16-byte words where its run's slots are aligned (the
  // column's first row on a 16-byte boundary: every column of a [d, n]
  // block with n a multiple of 4), its parts stored 16 bytes a part
  auto split = [&](int s) {
    const int64_t r0 = r_begin + int64_t(s) * kDgRows;
    const bool whole = r0 + kDgRows <= r_end;     // every row of it valid
    const float* wl = sm.wline[s & 1] + sm.shift[kDgW];
    const bool w_aligned = sm.shift[kDgW] == 0;
    for (int e = tid; e < 2 * kDgTile * (kDgRows / 8); e += kDgThreads) {
      const int side = e / (kDgTile * (kDgRows / 8));
      const int c = (e / (kDgRows / 8)) % kDgTile;
      const int i0 = (e % (kDgRows / 8)) * 8;
      const int a = (side ? tj : ti) * kDgTile + c;   // column of [1 ‖ x]
      const int run = (sides == 1 ? 0 : side) * kDgTile + c;
      const bool has = sm.src[run] != nullptr;
      float x[8], wv[8], v[8];
      if (has)
        dg_load8(x, sm.raw[s & 1][run / kDgTile][c] + sm.shift[run] + i0,
                 sm.shift[run] == 0);
      if (side == 0) dg_load8(wv, wl + i0, w_aligned);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool valid = whole || r0 + i0 + k < r_end;
        const float z = !valid ? 0.0f : a == 0 ? 1.0f : has ? x[k] : 0.0f;
        // left: f32(w·z_a), w for the constant (as K1 and the slabs)
        v[k] = side ? z : !valid ? 0.0f : a == 0 ? wv[k] : z * wv[k];
      }
      dg_split8(v, (side ? &sm.opb[s & 1][0][c][i0]
                         : &sm.opa[s & 1][0][c][i0]),
                kDgTile * kDgStride);
    }
  };

  // 4. warp (wm, wn): cells (32·wm + 16·mi + ·, 16·wn + 8·ni + ·)
  const int wm = warp >> 2, wn = warp & 3;
  float hh[2][2][4], rest[2][2][4];
  double sum64[2][2][4];      // this thread's cells' f64 sums
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hh[mi][ni][k] = rest[mi][ni][k] = 0.0f;
        sum64[mi][ni][k] = 0.0;
      }

  // 5. both sets into this thread's cells' f64 sums
  auto flush = [&]() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sum64[mi][ni][k] += static_cast<double>(hh[mi][ni][k]);
          sum64[mi][ni][k] += static_cast<double>(rest[mi][ni][k]);
          hh[mi][ni][k] = rest[mi][ni][k] = 0.0f;
        }
  };

  // step s's products from operand buffer s & 1
  auto products = [&](int s) {
    const int b = s & 1;
#pragma unroll
    for (int k0 = 0; k0 < kDgRows; k0 += 16) {
      uint32_t af[3][2][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[p][mi], &sm.opa[b][p][32 * wm + 16 * mi +
                                                (lane & 15)]
                                         [k0 + (lane >> 4) * 8]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t bf[2][2];
        {
          uint32_t t[4];
          ldmatrix_x4(t, &sm.opb[b][q][16 * wn + (lane & 7) +
                                       ((lane >> 4) << 3)]
                                      [k0 + ((lane >> 3) & 1) * 8]);
          bf[0][0] = t[0];
          bf[0][1] = t[1];
          bf[1][0] = t[2];
          bf[1][1] = t[3];
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
              if (p == 0 && q == 0)
                mma_bf16(hh[mi][ni], af[p][mi], bf[ni][0], bf[ni][1]);
              else
                mma_bf16(rest[mi][ni], af[p][mi], bf[ni][0], bf[ni][1]);
      }
    }
  };

  // the pipeline: step s's products are issued, then step s + 1's rows are
  // split into the other operand buffer while the tensor cores work, and
  // step s + 2's copies fly (two raw buffers: s + 2's is s's, split before)
  if (steps > 0) {
    stage(0);
    stage(1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();   // step 0's rows staged
    split(0);
    __syncthreads();   // operand buffer 0 written
  }
  for (int s = 0; s < steps; ++s) {
    stage(s + 2);
    products(s);
    if (s + 1 < steps) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();   // step s + 1's rows staged
      split(s + 1);
    }
    if ((s + 1) % kDgFlushSteps == 0 || s + 1 == steps) flush();
    __syncthreads();   // buffer (s + 1) & 1 written; buffer s & 1 read
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  double* dst = partial +
                ((int64_t(g) * ntiles + tile) * slices + slice) * kDgCells;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[(32 * wm + 16 * mi + (lane >> 2) + (k >> 1) * 8) * kDgTile +
            16 * wn + 8 * ni + 2 * (lane & 3) + (k & 1)] = sum64[mi][ni][k];
}

// 6. One thread a (group, tile, cell): the cell's slices in slice order in
// f64, one rounding; D[a, b] and D[b, a] (a ≤ b < m) where their columns
// lie in [lo, lo + width).
__global__ void dense_gram_reduce(const double* __restrict__ partial,
                                  const int* __restrict__ tiles, int ntiles,
                                  int slices, int G, int m, int lo,
                                  int width, int64_t ld, int64_t gstride,
                                  float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(G) * ntiles * kDgCells) return;
  const int cell = static_cast<int>(t % kDgCells);
  const int64_t gt = t / kDgCells;               // g·ntiles + tile
  const int tile = static_cast<int>(gt % ntiles);
  const int g = static_cast<int>(gt / ntiles);
  const int a = tiles[2 * tile] * kDgTile + cell / kDgTile;
  const int b = tiles[2 * tile + 1] * kDgTile + cell % kDgTile;
  if (a > b || b >= m) return;
  const double* p = partial + gt * slices * kDgCells + cell;
  double s = 0.0;
  for (int k = 0; k < slices; ++k) s += p[int64_t(k) * kDgCells];
  const float v = static_cast<float>(s);
  float* o = out + int64_t(g) * gstride;
  if (b >= lo && b < lo + width) o[int64_t(a) * ld + (b - lo)] = v;
  if (a != b && a >= lo && a < lo + width) o[int64_t(b) * ld + (a - lo)] = v;
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches the D kernel and its reduction on `stream`: D's places of the
// column window [lo, lo + width) of S (K7's whole S: lo = 0, width = P) of
// each group g, written to out[g·gstride + i·ld + j − lo]; out's other
// places are not touched. x_cols d × f32[n] (the first kInlineCols; far,
// the columns' table of gram_common.cuh's Cols, past them, else nullptr);
// w f32[n]; off i64[G + 1] of group-sorted rows, or nullptr for one group
// of every row; tiles i32[ntiles][2] on the device (_build.dense_tiles),
// slices the row slices of a group (_build.dense_slices); partial f64
// scratch of G · ntiles · slices · 4,096. Returns 0 or a cudaError_t.
int dit_dense_gram(const void* const* x_cols, int d, const int64_t* far,
                   const float* w, const int64_t* off, int G, int64_t n,
                   int P, const int* tiles, int ntiles, int slices, int lo,
                   int width, int64_t ld, int64_t gstride, double* partial,
                   float* out, void* stream) {
  using namespace dit;
  if (d < 1 || (d > kInlineCols && far == nullptr) || P < 1 + d ||
      n < 0 || n >= (int64_t(1) << 31) || ntiles < 1 || slices < 1 ||
      G < 1 || (G > 1 && off == nullptr) ||
      int64_t(G) * slices * ntiles > 0x7fffffff ||
      lo < 0 || width < 1 || lo > P - width || ld < width ||
      (G > 1 && gstride < int64_t(P) * ld) ||
      int64_t(G) * ntiles * kDgCells >=
          int64_t(0x7fffffff) * kDgReduceThreads)
    return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, nullptr, nullptr, 0, far);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(DgSmem);
  cudaError_t rc = cudaFuncSetAttribute(
      dense_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  dense_gram_kernel<<<static_cast<unsigned>(int64_t(G) * slices * ntiles),
                      kDgThreads, smem, s>>>(cols, w, off, n, tiles, ntiles,
                                             slices, partial);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const int64_t threads = int64_t(G) * ntiles * kDgCells;
  dense_gram_reduce<<<static_cast<unsigned>(
                          (threads + kDgReduceThreads - 1) / kDgReduceThreads),
                      kDgReduceThreads, 0, s>>>(partial, tiles, ntiles,
                                                slices, G, 1 + d, lo, width,
                                                ld, gstride, out);
  return cudaGetLastError();
}

}  // extern "C"
