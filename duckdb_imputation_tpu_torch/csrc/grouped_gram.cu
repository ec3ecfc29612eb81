// K4 and K5: the grouped masked Gram, one S_g = Zᵀ·diag(w·[id = g])·Z per
// group, for sm_90a.
//
// K5 (dit_presorted_gram) takes rows already sorted by group
// (ring/kernels/sigma_pallas_grouped.py:sort_by_group) and the segment
// offsets. It replaces the sorted-slab Pallas kernels of
// duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py that route
// blocks through a prefetched block→group map:
// _sigma_pallas_grouped_padded (_grouped_kernel), _fast2_padded and
// _fast3_padded. K4 (dit_grouped_gram) takes the rows in any order, with
// the group id riding along as data. It replaces the Pallas kernels that
// keep all G output slabs resident and route rows by inline masks:
// _sigma_pallas_grouped_unsorted (_grouped_unsorted_kernel) and its _fast,
// _fast2 and _fast3 variants. The bf16 hi/lo splits, lane packing and
// per-variant layouts of those exist for the TPU's matrix unit and are
// dropped.
//
// K5. Steps of rows never cross a group boundary (`cum`, the group-aligned
// steps of _build.group_chunks), and each block takes a contiguous run of
// steps (GroupRows), so it meets groups in order. It keeps one group's
// sums at a time and writes one f64 partial per (block, group) it meets,
// into slot block + group (unique, since groups do not decrease from one
// block to the next); presorted_reduce then sums each group's slots over
// the blocks that met it, in block order, in f64, and rounds once. A group
// shorter than a step is padded with zero-weight rows; an empty group gets
// zeros. Two bodies, as K1's (masked_gram.cu):
// - the tensor cores where S is tc_gram.cuh's one output tile (tc_fits:
//   P ≤ 21, 1 + 3d + V ≤ 32; BASELINE config 4): K1's body (the three bf16
//   parts of each value, mma.sync bf16 → f32, an f64 flush every
//   kTcFlushSteps steps) over steps of kTcRows = 128 rows; at a step of a
//   new slot the block flushes its fragments, folds S′ into the last slot
//   and clears them (tc_gram_steps);
// - the CUDA cores for any other P ≤ 88 (presorted_gram_kernel): the 4×4
//   register tiles of gram_common.cuh over steps of kChunk = 256 rows.
//
// K4 is a stable group order, then K5's kernels over the rows through the
// order. A block of either body keeps one group's sums: the tensor-core
// body's fragments and f64 sums of one group take 96 registers at five
// blocks an SM, so sums for G groups at once would not fit. The order is
// three small kernels over the group ids alone, on the device, with no
// host sync and no atomics:
//   1. group_count_kernel: each of B order blocks, a contiguous slice of
//      the rows, counts its rows per group (warp ballots);
//   2. group_scan_kernel (one block): the counts scanned in (group, block)
//      order give each block's base in each group, the offsets i64[G + 1]
//      and K5's steps `cum`;
//   3. group_scatter_kernel: each row's index written at its block's base
//      plus its rank among the block's earlier rows of its group (warp
//      ballots and a scan of their counts: the same on every run).
// Rows with an id outside [0, G) never enter the list. K5 then stages each
// row of a step from its index (cp.async gathers of 4 bytes a column: near
// sequential for a hot group; tools/k4_variants.py times a packed copy of
// the rows and a one-pass kernel beside it). Counts stay exact past 2²⁴
// rows: f32 sums of at most kTcFlushSteps · 128 rows (or a thread's
// rows of the CUDA-core route), f64 beyond; reruns are bit-identical.
//
// What bounds them on an H100: the bytes of the rows (4·d + 4·c + 4 a row;
// K4 also reads the ids twice and writes and reads an i32 index) and, on
// the CUDA cores, issuing the P(P+1)/2 products of each row (K1's bounds:
// tc_gram.cuh, gram_common.cuh).
#include "tc_gram.cuh"

namespace dit {
namespace {

constexpr int kMaxUnsortedGroups = 8;   // K4's G: the dispatch's limit
constexpr int kOrderBlocks = 1024;      // most order blocks
constexpr int kOrderMinChunks = 8;      // fewest kChunk steps an order block
constexpr int kOrderUnroll = 8;         // chunks an order step loads at once
constexpr int kOrderWarps = kThreads / 32;

// Chunks per block of K5, the same in the kernels and the reduction.
__host__ __device__ __forceinline__ int64_t chunks_per_block(int64_t total,
                                                             int nblocks) {
  const int64_t cpb = (total + nblocks - 1) / nblocks;
  return cpb > 0 ? cpb : 1;
}

// K5's rows: block b's steps are the group-aligned steps c0 .. c1 of kRows
// rows, a contiguous run (off[g] .. off[g + 1] are group g's positions,
// cum[g] its first step, cum[G] the step count), so the block meets groups
// in order. A position is a row, or with kGather the row idx[position]
// (K4; both K5 bodies are launched with kGather = idx != null). The
// block's partial of group g is slot blockIdx.x + g of gridDim.x + G
// (unique, since groups do not decrease from one block to the next).
template <int kRows, bool kGather>
struct GroupRows {
  static constexpr bool kGrouped = true;
  // a walk over the block's steps in order: the group at hand and its
  // bounds in registers, read again only when the walk enters the next
  // group
  struct Cursor {
    int g;
    int c_end;       // cum[g + 1]
    int64_t base;    // off[g] − cum[g]·kRows: step c's first position
    int64_t end;     // off[g + 1]
  };
  const int64_t* off;
  const int64_t* cum;
  const int32_t* idx;
  int G;
  int c0;          // the block's first step (steps < 2³¹ / kRows)
  int steps;       // its steps
  __device__ __forceinline__ GroupRows(const int64_t* off_,
                                       const int64_t* cum_,
                                       const int32_t* idx_, int G_)
      : off(off_), cum(cum_), idx(idx_), G(G_) {
    const int64_t total = cum[G];
    const int64_t cpb = chunks_per_block(total, gridDim.x);
    const int64_t first = blockIdx.x * cpb;
    c0 = static_cast<int>(first < total ? first : total);
    steps = static_cast<int>(first + cpb < total ? cpb : total - c0);
  }
  __device__ __forceinline__ void enter(Cursor& k, int g) const {
    k.g = g;
    k.c_end = static_cast<int>(cum[g + 1]);
    k.base = off[g] - cum[g] * kRows;
    k.end = off[g + 1];
  }
  // at the group of step c0: the last g with cum[g] ≤ c0 (skips empty ones)
  __device__ __forceinline__ Cursor cursor() const {
    Cursor k{};
    if (steps == 0) return k;
    int lo = 0, hi = G;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (cum[mid] <= c0) lo = mid; else hi = mid - 1;
    }
    enter(k, lo);
    return k;
  }
  // step s of the block, the cursor at the group of an earlier step
  __device__ __forceinline__ TcStep at(int s, Cursor& k) const {
    const int c = c0 + s;
    while (c >= k.c_end) enter(k, k.g + 1);
    return {k.base + int64_t(c) * kRows, k.end,
            int64_t(blockIdx.x) + k.g};
  }
  __device__ __forceinline__ int64_t source(int64_t pos) const {
    return kGather ? idx[pos] : pos;
  }
  __device__ __forceinline__ int64_t stride() const {
    return int64_t(gridDim.x) + G;
  }
};

// K5 on the tensor cores: K1's body over GroupRows (through idx for K4);
// five blocks an SM, as K1 (96 registers).
template <bool kGather>
__global__ void __launch_bounds__(kTcThreads, 5)
tc_presorted_kernel(const __grid_constant__ Cols cols, int P,
                    const float* __restrict__ w,
                    const int64_t* __restrict__ off,
                    const int64_t* __restrict__ cum,
                    const int32_t* __restrict__ idx, int G,
                    double* __restrict__ partial) {
  tc_gram_steps(cols, P, w,
                GroupRows<kTcRows, kGather>(off, cum, idx, G),
                partial, TcNoPrologue());
}

// K5 on the CUDA cores: K1's CUDA-core scheme over GroupRows' steps of
// kChunk rows (through idx for K4). partial: [E][nblocks + G].
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
presorted_gram_kernel(const __grid_constant__ Cols cols,
                      const __grid_constant__ Geom gm,
                      const float* __restrict__ w,
                      const int64_t* __restrict__ off,
                      const int64_t* __restrict__ cum,
                      const int32_t* __restrict__ idx, int G,
                      double* __restrict__ partial) {
  extern __shared__ float smem[];
  float* zs = smem;                      // [kChunk][PS]
  float* ws = smem + kChunk * gm.PS;     // [kChunk]
  const GroupRows<kChunk, kGather> rows(off, cum, idx, G);
  if (rows.steps == 0) return;           // the whole block: no barrier left
  auto here = rows.cursor();
  int64_t slot = -1;
  const TileOwner own(gm);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
  for (int s = 0; s < rows.steps; ++s) {
    const int64_t last = slot;
    const TcStep st = rows.at(s, here);
    slot = st.slot;
    if (s > 0 && slot != last) {
      write_partial_at(acc, own.active, own.t, own.g, zs, gm, partial,
                       rows.stride(), last);
      __syncthreads();  // the scratch is the Z tile staged next
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    }
    const int64_t pos = st.first + threadIdx.x;
    float* zr = zs + threadIdx.x * gm.PS;
    if (pos < st.end) {
      const int64_t row = rows.source(pos);
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
  write_partial_at(acc, own.active, own.t, own.g, zs, gm, partial,
                   rows.stride(), slot);
}

// Entry e of a block partial → (i, j) of S: the 4×4 tiles of the CUDA-core
// route, or a·kTcA + b of the tensor cores'.
struct CoreEntries {
  Geom gm;
  __device__ __forceinline__ bool at(int e, int& i, int& j) const {
    int ti, tj;
    tile_coords(e / 16, gm.NT, ti, tj);
    i = 4 * ti + (e % 16) / 4;
    j = 4 * tj + (e % 16) % 4;
    return i < gm.P && j < gm.P && i <= j;
  }
};
struct TcEntries {
  int P;
  __device__ __forceinline__ bool at(int e, int& i, int& j) const {
    i = e / kTcA;
    j = e % kTcA;
    return i <= j && j < P;
  }
};

// The group's slots over the blocks that met it, in block order, f64, one
// rounding, for each (group, entry): `lanes` = 32 lanes of a warp split the
// blocks (then a fixed shuffle tree), or one lane takes them all in order
// where groups meet few blocks (reduce_lanes). Empty groups get zeros.
template <class Entries>
__global__ void presorted_reduce(const double* __restrict__ partial,
                                 const int64_t* __restrict__ cum, int G,
                                 int nblocks, int E, int P, int lanes,
                                 Entries map, float* __restrict__ out) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t pair = lanes == 32 ? t >> 5 : t;
  const int lane = lanes == 32 ? threadIdx.x & 31 : 0;
  if (pair >= int64_t(G) * E) return;   // whole warps where lanes = 32
  const int g = static_cast<int>(pair / E);
  const int e = static_cast<int>(pair % E);
  const int64_t stride = int64_t(nblocks) + G;
  double s = 0.0;
  if (cum[g + 1] > cum[g]) {
    const int64_t cpb = chunks_per_block(cum[G], nblocks);
    const int64_t b0 = cum[g] / cpb, b1 = (cum[g + 1] - 1) / cpb;
    for (int64_t b = b0 + lane; b <= b1; b += lanes)
      s += partial[int64_t(e) * stride + b + g];
  }
  if (lanes == 32)
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, o);
  int i, j;
  if (lane != 0 || !map.at(e, i, j)) return;
  const float v = static_cast<float>(s);
  float* o = out + int64_t(g) * P * P;
  o[i * P + j] = v;
  o[j * P + i] = v;
}

// Lanes a (group, entry) of presorted_reduce: a warp while groups meet
// many blocks each (about nblocks / G), one lane from 16 or fewer.
inline int reduce_lanes(int G, int nblocks) {
  return int64_t(G) * 16 >= nblocks ? 1 : 32;
}

template <class Entries>
int launch_presorted_reduce(const double* partial, const int64_t* cum, int G,
                            int nblocks, int E, int P, Entries map,
                            float* out, cudaStream_t s) {
  const int lanes = reduce_lanes(G, nblocks);
  const int64_t blocks = (int64_t(G) * E * lanes + kThreads - 1) / kThreads;
  presorted_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      partial, cum, G, nblocks, E, P, lanes, map, out);
  return cudaGetLastError();
}

// K5 and its reduction on `stream`, over rows by position (idx null) or
// through idx; the route by tc_fits. nblocks: _build.tc_grid(n) on the
// tensor cores, _build.grid_blocks(n) on the CUDA cores.
int launch_presorted(const Cols& cols, int P, const float* w,
                     const int64_t* off, const int64_t* cum,
                     const int32_t* idx, int G, int64_t n, double* partial,
                     int nblocks, float* out, cudaStream_t s) {
  if (tc_fits(cols.d, P)) {
    const size_t smem = tc_smem_bytes(cols.d, cols.c, TcNoPrologue());
    auto kernel = idx == nullptr ? tc_presorted_kernel<false>
                                 : tc_presorted_kernel<true>;
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
    kernel<<<nblocks, kTcThreads, smem, s>>>(cols, P, w, off, cum, idx, G,
                                             partial);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    return launch_presorted_reduce(partial, cum, G, nblocks, kTcEntries, P,
                                   TcEntries{P}, out, s);
  }
  const Geom gm = make_geom(P, n);
  const size_t smem = sizeof(float) * gram_smem_floats(gm);
  auto kernel = idx == nullptr ? presorted_gram_kernel<false>
                               : presorted_gram_kernel<true>;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<nblocks, kThreads, smem, s>>>(cols, gm, w, off, cum, idx, G,
                                         partial);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  return launch_presorted_reduce(partial, cum, G, nblocks, gram_entries(gm),
                                 P, CoreEntries{gm}, out, s);
}

// The order's geometry, a function of n only: B blocks of `per` rows (a
// multiple of kChunk), at most kOrderBlocks, each at least kOrderMinChunks
// chunks where n allows. Mirrored by _build.order_geometry.
inline void order_geometry(int64_t n, int& B, int64_t& per) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  int64_t b = (chunks + kOrderMinChunks - 1) / kOrderMinChunks;
  b = b < 1 ? 1 : b > kOrderBlocks ? kOrderBlocks : b;
  per = (chunks + b - 1) / b * kChunk;
  if (per < kChunk) per = kChunk;
  B = static_cast<int>((n + per - 1) / per);
  if (B < 1) B = 1;
}

// The group in [0, G) of row `row` of a slice ending at `end`, or -1.
__device__ __forceinline__ int row_group(const int32_t* __restrict__ gid,
                                         int64_t row, int64_t end, int G) {
  if (row >= end) return -1;
  const int g = gid[row];
  return g >= 0 && g < G ? g : -1;
}

// 1. counts[g·B + b]: rows of group g in block b's slice. A thread loads
// the ids of kOrderUnroll chunks at once: their loads in flight together.
__global__ void __launch_bounds__(kThreads)
group_count_kernel(const int32_t* __restrict__ gid, int G, int64_t n,
                   int64_t per, int64_t* __restrict__ counts) {
  __shared__ int wcnt[kOrderWarps][kMaxUnsortedGroups];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = blockIdx.x * per;
  const int64_t end = r0 + per < n ? r0 + per : n;
  int mine = 0;   // lane g: this warp's rows of group g
  for (int64_t base = r0; base < end; base += kOrderUnroll * kChunk) {
    int grp[kOrderUnroll];
#pragma unroll
    for (int k = 0; k < kOrderUnroll; ++k)
      grp[k] = row_group(gid, base + k * kChunk + threadIdx.x, end, G);
#pragma unroll
    for (int k = 0; k < kOrderUnroll; ++k)
      for (int g = 0; g < G; ++g) {
        const unsigned m = __ballot_sync(0xffffffffu, grp[k] == g);
        if (lane == g) mine += __popc(m);
      }
  }
  if (lane < G) wcnt[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < G) {
    int64_t tot = 0;
    for (int w = 0; w < kOrderWarps; ++w) tot += wcnt[w][threadIdx.x];
    counts[int64_t(threadIdx.x) * gridDim.x + blockIdx.x] = tot;
  }
}

constexpr int kScanThreads = 1024;

// 2. One block: counts[G·B] scanned in place into each (group, block)'s
// first position (exclusive, in (group, block) order); off[g] = the first
// position of group g, off[G] the rows in range; cum[g] = Σ_{h<g}
// ceil((off[h+1] − off[h]) / rows) steps.
__global__ void __launch_bounds__(kScanThreads)
group_scan_kernel(int64_t* __restrict__ counts, int G, int B, int rows,
                  int64_t* __restrict__ off, int64_t* __restrict__ cum) {
  __shared__ int64_t part[kScanThreads];
  const int t = threadIdx.x;
  const int64_t M = int64_t(G) * B;
  const int64_t per = (M + kScanThreads - 1) / kScanThreads;
  const int64_t lo = t * per, hi = lo + per < M ? lo + per : M;
  int64_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += counts[i];
  part[t] = sum;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {   // inclusive, Hillis-Steele
    const int64_t v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int64_t run = part[t] - sum;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t c = counts[i];
    counts[i] = run;
    run += c;
  }
  __syncthreads();
  if (t == 0) {
    cum[0] = 0;
    for (int g = 0; g < G; ++g) {
      off[g] = counts[int64_t(g) * B];
      const int64_t next = g + 1 < G ? counts[int64_t(g + 1) * B]
                                     : part[kScanThreads - 1];
      cum[g + 1] = cum[g] + (next - off[g] + rows - 1) / rows;
    }
    off[G] = part[kScanThreads - 1];
  }
}

// 3. Each row of block b's slice whose group g is in range: its index
// written at idx[first(g, b) + its rank among the slice's earlier rows of
// g]. kOrderUnroll chunks at a time, their ids loaded at once, in row
// order: a row's rank within its warp from a ballot, then for each group a
// scan over the window's (chunk, warp) counts in order. Stable, no
// atomics.
__global__ void __launch_bounds__(kThreads)
group_scatter_kernel(const int32_t* __restrict__ gid, int G, int64_t n,
                     int64_t per, const int64_t* __restrict__ first,
                     int32_t* __restrict__ idx) {
  constexpr int kParts = kOrderUnroll * kOrderWarps;   // (chunk, warp) in order
  static_assert(kParts == 64, "two (chunk, warp) counts a lane in the scan");
  __shared__ int before[kParts][kMaxUnsortedGroups];
  __shared__ int total[kMaxUnsortedGroups];
  __shared__ int64_t next[kMaxUnsortedGroups];   // group g's next position
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
    __syncthreads();   // also: next[] is set
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
      if (grp[k] >= 0)
        idx[next[grp[k]] + before[k * kOrderWarps + warp][grp[k]] +
            rank[k]] = static_cast<int32_t>(base + k * kChunk + threadIdx.x);
    __syncthreads();
    if (threadIdx.x < G) next[threadIdx.x] += total[threadIdx.x];
  }
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K4 on `stream`: the group order of the ids, then K5 over the
// rows through it. out f32[G, P, P] for 1 ≤ G ≤ kMaxUnsortedGroups; ids
// outside [0, G) add nothing. Scratch: counts i64[G · kOrderBlocks],
// off_cum i64[2 (G + 1)] (the offsets, then K5's steps), idx i32[n],
// partial f64[E · (nblocks + G)] (E: 21 · 21 on the tensor cores,
// dit_gram_entries(P) on the CUDA cores; nblocks as K5's:
// _build.presorted_grid).
int dit_grouped_gram(const void* const* x_cols, int d,
                     const void* const* code_cols, const int* cat_sizes,
                     int c, const float* w, const int32_t* gid, int G,
                     int64_t n, int P, int64_t* counts, int64_t* off_cum,
                     int32_t* idx, double* partial, int nblocks, float* out,
                     void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (G < 1 || G > kMaxUnsortedGroups) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  auto s = static_cast<cudaStream_t>(stream);
  int B;
  int64_t per;
  order_geometry(n, B, per);
  int64_t* off = off_cum;
  int64_t* cum = off_cum + G + 1;
  group_count_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  group_scan_kernel<<<1, kScanThreads, 0, s>>>(
      counts, G, B, tc_fits(d, P) ? kTcRows : kChunk, off, cum);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  group_scatter_kernel<<<B, kThreads, 0, s>>>(gid, G, n, per, counts, idx);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  return launch_presorted(cols, P, w, off, cum, idx, G, n, partial, nblocks,
                          out, s);
}

// Launches K5 and its reduction on `stream` over rows sorted by group:
// off i64[G + 1] (group g's rows are off[g] .. off[g + 1]), cum i64[G + 1]
// (_build.group_chunks(off, rows): 128 rows a step on the tensor cores,
// 256 on the CUDA cores). out f32[G, P, P]; partial: f64 scratch of
// E · (nblocks + G), as dit_grouped_gram's.
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
  return launch_presorted(cols, P, w, off, cum, nullptr, G, n, partial,
                          nblocks, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
