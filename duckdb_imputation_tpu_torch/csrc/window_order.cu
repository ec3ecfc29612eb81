// The row order of K7's and K8's keyed windows (wide_gram.cuh, step 5):
// a stable counting sort of the rows by the codes of one keyed column J,
// and a copy of w, x and every code column in that order, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's windows (ring/striped.py:
// sigma_stripe) build a dense Zᵀ a row chunk and read every row for every
// stripe. The port's keyed tasks each walk only the rows of their key
// range of J, so the rows are ordered by code_J once a call
// (ring/kernels/sigma_pallas.py: window_order; its plain version a stable
// torch.sort and a gather of each column, which it equals bit for bit).
//
// The key of row i is code_J[i], and in K8 g·V_J + code_J[i] for the
// row's group g among group-sorted rows (off[g] ≤ i < off[g + 1]); a row
// whose code lies outside [0, V_J), or past off[G], has none: it is not
// copied (it would sort last, where no task reads). Each group's rows are
// cut into S equal segments of consecutive rows (_build.order_segments), a
// warp each, so a segment's keys are its group's V_J codes, whose counts
// (then running positions) the warp keeps in its own V_J ints of shared
// memory:
//   1. order_count_kernel: each warp counts its rows a code (the lanes of
//      one code found by __match_any_sync, the first of them adding their
//      number to the warp's count: no atomics) and writes the counts,
//      segment-major, counts[(g·S + s)·V + u];
//   2. the caller scans them in (key, segment) order (an exclusive cumsum
//      over the counts transposed to [g][u][s]): where segment s's rows of
//      key (g, u) begin, the keys' row offsets and the total of rows with
//      a key; it hands each warp its V positions back segment-major;
//   3. order_scatter_kernel: each warp loads its positions and walks its
//      rows again, 32 at a time in row order, the next chunk's columns
//      staged into shared memory by cp.async while it places this one's
//      (the keyed column's codes are one of them); a row goes to its code's
//      position plus its rank among the chunk's earlier lanes of its code,
//      and the first lane of the code moves the position past them. The
//      row's columns are written there side by side, a row of `stride`
//      ints (64 bytes at favorita_items' 14 columns: two whole 32-byte
//      sectors): each row stored from shared memory by consecutive lanes,
//      16 bytes a lane, so a store writes whole sectors. Reads coalesced,
//      writes whole sectors.
//      (A copy a column wrote one 4-byte value a sector, and the card then
//      reads each sector to merge it: 10 ms a column at 10M rows, PERF.md
//      §6.)
//   3'. order_scatter_pieces_kernel, where two chunks of whole rows do not
//      fit a warp's shared memory beside its V positions (a row of 1 + d + c
//      ints past about 880 − V/64: d = 1,000 beside V = 5,000, _build.py:
//      order_piece): the warp reads its chunk's keyed codes from device
//      memory, places the rows as in 3., then copies their columns a piece
//      of `piece` ints at a time (whole 32-byte sectors), the next piece
//      staged by cp.async while this one is written.
// Stable (a key's rows keep their row order: segments in order, chunks in
// order, lanes in order) and the same on every run.
//
// What bounds it on an H100: the bytes, one read of the key column for the
// count and one read of every column and one write of the rows for the
// scatter (a gather through a sort's order reads a 32-byte sector for
// every 4-byte value, and a radix sort passes over the keys several
// times: PERF.md §6, PR 17), and each warp's chain of dependent steps a
// chunk (its codes, the match, its position in shared memory, its
// columns), so the next chunk's rows are in flight while this one's are
// placed (a lane loading and storing its own row, a chunk at a time, took
// 1.33 ms a column at favorita_items, 10M rows, against 0.15 for the
// count; PERF.md §6).
#include <cstdint>
#include <cuda_runtime.h>

namespace dit {
namespace {

constexpr int kOrderMaxWarps = 1;           // warps of an order block:
                                            // as many as shared memory
                                            // holds share an SM
constexpr int kOrderSmem = 227 * 1024;      // shared memory of a block
// columns the kernel parameter holds: w, and 88 numeric and 88 code
// columns (gram_common.cuh: kInlineCols each); past them `far`
constexpr int kOrderInline = 1 + 88 + 88;

struct OrderCols {
  const int32_t* col[kOrderInline];   // w, x, codes as 4-byte words
  const int64_t* far;   // every column, in device memory, past kOrderInline
  int ncols;
  __device__ __forceinline__ const int32_t* at(int q) const {
    return q < kOrderInline ? col[q]
                            : reinterpret_cast<const int32_t*>(far[q]);
  }
};

// Ints of shared memory an order warp keeps: V counters (positions), and
// in the scatter its chunk's 32 places and two chunks' 32 rows of `stride`
// ints (or two pieces of 32 rows of a row's `stride` = piece ints), each
// padded by a 16-byte word (fewer bank conflicts), 16-byte aligned.
// Mirrored by _build.py: order_warp_ints.
__host__ __device__ inline int64_t order_warp_ints(int V, int stride) {
  return stride ? (V + 3) / 4 * 4 + 32 + 64 * (stride + 4) : V;
}

// Warps of an order block: each keeps order_warp_ints in shared memory.
inline int order_warps(int V, int stride = 0) {
  const int64_t fit = kOrderSmem / (4 * order_warp_ints(V, stride));
  return fit < 1 ? 0 : fit < kOrderMaxWarps ? static_cast<int>(fit)
                                            : kOrderMaxWarps;
}

// The rows of warp `w`'s segment: group w / S, its part w % S of S.
struct OrderSegment {
  int64_t lo, hi;
  __device__ __forceinline__ OrderSegment(const int64_t* off, int64_t n,
                                          int S, int64_t w) {
    const int64_t g = w / S, s = w % S;
    const int64_t a = off ? off[g] : 0, b = off ? off[g + 1] : n;
    const int64_t per = (b - a + S - 1) / S;
    lo = a + s * per;
    lo = lo < b ? lo : b;
    hi = lo + per < b ? lo + per : b;
  }
};

__device__ __forceinline__ int code_at(const int32_t* code, int64_t i,
                                       int64_t hi, int V) {
  const int u = i < hi ? code[i] : -1;
  return u >= 0 && u < V ? u : -1;
}

__global__ void order_count_kernel(const int32_t* __restrict__ code, int V,
                                   const int64_t* __restrict__ off,
                                   int64_t warps, int64_t n, int S,
                                   int* __restrict__ counts) {
  extern __shared__ __align__(16) int order_smem[];
  const int64_t w = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;
  int* hist = order_smem + (threadIdx.x >> 5) * V;
  for (int u = lane; u < V; u += 32) hist[u] = 0;
  __syncwarp();
  const OrderSegment seg(off, n, S, w);
  int u = code_at(code, seg.lo + lane, seg.hi, V);
  for (int64_t at = seg.lo; at < seg.hi; at += 32) {
    const int next = code_at(code, at + 32 + lane, seg.hi, V);
    const unsigned peers = __match_any_sync(0xffffffffu, u);
    if (u >= 0 && __ffs(peers) - 1 == lane) hist[u] += __popc(peers);
    __syncwarp();
    u = next;
  }
  int* out = counts + w * V;
  for (int v = lane; v < V; v += 32) out[v] = hist[v];
}

// 4 bytes global → shared, asynchronously (cp.async).
__device__ __forceinline__ void order_copy4(int* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__global__ void order_scatter_kernel(const int V, const int key_col,
                                     const int64_t* __restrict__ off,
                                     int64_t warps, int64_t n, int S,
                                     const int32_t* __restrict__ start,
                                     const __grid_constant__ OrderCols src,
                                     int stride,
                                     int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int order_smem[];
  const int64_t w = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;
  const int words = stride / 4;   // 16-byte words of a row
  const int pitch = stride + 4;   // ints of a staged row
  int* pos = order_smem + (threadIdx.x >> 5) * order_warp_ints(V, stride);
  int* dest = pos + (V + 3) / 4 * 4;   // [32]: each lane's row, −1: none
  int* rows = dest + 32;               // [2][32][pitch]: two chunks' rows
  const int32_t* mine = start + w * V;
  for (int v = lane; v < V; v += 32) pos[v] = mine[v];
  const OrderSegment seg(off, n, S, w);
  const unsigned below = (1u << lane) - 1u;
  // a lane stages its row of the chunk at `at` into buffer b: its columns
  // (the keyed column's codes among them) by cp.async, zeros past them
  auto stage = [&](int64_t at, int b) {
    int* r = rows + (b * 32 + lane) * pitch;
    const int64_t i = at + lane;
    for (int q = 0; q < stride; ++q) {
      if (q < src.ncols && i < seg.hi) order_copy4(r + q, src.at(q) + i);
      else r[q] = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (seg.lo < seg.hi) stage(seg.lo, 0);
  int b = 0;
  for (int64_t at = seg.lo; at < seg.hi; at += 32, b ^= 1) {
    if (at + 32 < seg.hi) stage(at + 32, b ^ 1);   // the next chunk's rows
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    const int* r = rows + b * 32 * pitch;
    const int code = r[lane * pitch + key_col];
    const int u = at + lane < seg.hi && code >= 0 && code < V ? code : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, u);
    const int first = __ffs(peers) - 1;
    int p = 0;
    if (u >= 0 && first == lane) {
      p = pos[u];
      pos[u] = p + __popc(peers);
    }
    p = __shfl_sync(0xffffffffu, p, first);
    dest[lane] = u >= 0 ? p + __popc(peers & below) : -1;
    __syncwarp();
    // each row written by consecutive lanes, 16 bytes a lane: whole
    // sectors a store
    for (int e = lane; e < 32 * words; e += 32) {
      const int row = e / words, k = e % words, to = dest[row];
      if (to >= 0)
        reinterpret_cast<int4*>(out + int64_t(to) * stride)[k] =
            reinterpret_cast<const int4*>(r + row * pitch)[k];
    }
    __syncwarp();   // buffer b is restaged two chunks on
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Step 3' for rows wider than two chunks of a warp's shared memory: each
// chunk's places as in order_scatter_kernel (its keyed codes read from
// device memory), then the rows' columns [q0, q0 + piece) in turn, staged
// into one of two buffers [32][piece + 4] by cp.async while the previous
// piece is written, 16 bytes a lane as there.
__global__ void order_scatter_pieces_kernel(
    const int V, const int key_col, const int64_t* __restrict__ off,
    int64_t warps, int64_t n, int S, const int32_t* __restrict__ start,
    const __grid_constant__ OrderCols src, int stride, int piece,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int order_smem[];
  const int64_t w = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= warps) return;
  const int pitch = piece + 4;
  int* pos = order_smem + (threadIdx.x >> 5) * order_warp_ints(V, piece);
  int* dest = pos + (V + 3) / 4 * 4;   // [32]: each lane's row, −1: none
  int* rows = dest + 32;               // [2][32][pitch]: two pieces
  const int32_t* mine = start + w * V;
  for (int v = lane; v < V; v += 32) pos[v] = mine[v];
  const OrderSegment seg(off, n, S, w);
  const unsigned below = (1u << lane) - 1u;
  const int32_t* keys = src.at(key_col);
  // a lane stages columns [q0, q0 + piece) of its row of the chunk at `at`
  // into buffer b, zeros past the columns
  auto stage = [&](int64_t at, int q0, int b) {
    int* r = rows + (b * 32 + lane) * pitch;
    const int64_t i = at + lane;
    for (int q = 0; q < piece; ++q) {
      if (q0 + q < src.ncols && i < seg.hi)
        order_copy4(r + q, src.at(q0 + q) + i);
      else r[q] = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int64_t at = seg.lo; at < seg.hi; at += 32) {
    const int code = at + lane < seg.hi ? keys[at + lane] : -1;
    const int u = code >= 0 && code < V ? code : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, u);
    const int first = __ffs(peers) - 1;
    int p = 0;
    if (u >= 0 && first == lane) {
      p = pos[u];
      pos[u] = p + __popc(peers);
    }
    p = __shfl_sync(0xffffffffu, p, first);
    dest[lane] = u >= 0 ? p + __popc(peers & below) : -1;
    stage(at, 0, 0);
    int b = 0;
    for (int q0 = 0; q0 < stride; q0 += piece, b ^= 1) {
      if (q0 + piece < stride) stage(at, q0 + piece, b ^ 1);
      else asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncwarp();
      const int* r = rows + b * 32 * pitch;
      const int words = (stride - q0 < piece ? stride - q0 : piece) / 4;
      for (int e = lane; e < 32 * words; e += 32) {
        const int row = e / words, k = e % words, to = dest[row];
        if (to >= 0)
          reinterpret_cast<int4*>(out + int64_t(to) * stride + q0)[k] =
              reinterpret_cast<const int4*>(r + row * pitch)[k];
      }
      __syncwarp();   // buffer b is restaged two pieces on
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

inline int check_order(int V, const int64_t* off, int G, int64_t n, int S) {
  if (V < 1 || G < 1 || int64_t(G) * V >= (int64_t(1) << 31) || S < 1 ||
      int64_t(G) * S * 32 >= (int64_t(1) << 31) || n < 0 ||
      n >= (int64_t(1) << 31) || (off == nullptr && G != 1) ||
      order_warps(V) < 1)
    return cudaErrorInvalidValue;
  return 0;
}

// Launches `kernel` over G·S warps, order_warps(V, stride) a block, each
// with order_warp_ints of shared memory (stride 0: the count).
template <typename Kernel, typename... Args>
inline int launch_order(Kernel kernel, int V, int stride, int G, int S,
                        cudaStream_t stream, Args... args) {
  const int wb = order_warps(V, stride);
  if (wb < 1) return cudaErrorInvalidValue;
  const size_t smem = size_t(4) * order_warp_ints(V, stride) * wb;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const int64_t warps = int64_t(G) * S;
  const unsigned blocks = static_cast<unsigned>((warps + wb - 1) / wb);
  kernel<<<blocks, 32 * wb, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit

extern "C" {

// Counts the rows of each code in each of the S segments of each group into
// counts i32[G·S·V], segment-major: counts[(g·S + s)·V + u]. code i32[n]:
// the keyed column, V its levels; off i64[G + 1] K8's group offsets of
// group-sorted rows, or nullptr with G = 1 (K7). Returns 0 or a
// cudaError_t.
int dit_order_count(const int32_t* code, int V, const int64_t* off, int G,
                    int64_t n, int S, int* counts, void* stream) {
  using namespace dit;
  if (int rc = check_order(V, off, G, n, S)) return rc;
  return launch_order(order_count_kernel, V, 0, G, S,
                      static_cast<cudaStream_t>(stream), code, V, off,
                      int64_t(G) * S, n, S, counts);
}

// Copies the rows with a key, ncols columns `cols` (4-byte words: w, x,
// codes; cols[key_col] the keyed column's codes), into out i32[n][stride]
// in the order of their keys, stable,
// a row's columns side by side (zeros up to a multiple of 4; stride a
// multiple of 4, ≥ ncols, out 16-byte aligned): start i32[G·S·V],
// segment-major as dit_order_count's counts, the row where segment s's
// rows of key (g, u) begin (the exclusive scan of the counts in (key,
// segment) order); out's rows past the rows with a key are not written.
// far: the `cols` pointers in device memory (int64, `cols`' order; the
// x part of _build.py: far_table), needed past kOrderInline columns. A
// warp stages two chunks of 32 rows of `piece` ints: piece = stride, or
// where that passes a warp's shared memory beside V positions, a multiple
// of 8 below it, the rows copied a piece at a time (_build.py:
// order_piece). Other arguments as dit_order_count. Returns 0 or a
// cudaError_t.
int dit_order_scatter(int key_col, int V, const int64_t* off, int G,
                      int64_t n, int S, const int32_t* start,
                      const void* const* cols, int ncols,
                      const int64_t* far, int stride, int piece,
                      int32_t* out, void* stream) {
  using namespace dit;
  if (int rc = check_order(V, off, G, n, S)) return rc;
  if (ncols < 1 || (ncols > kOrderInline && far == nullptr) ||
      stride < ncols || stride % 4 || piece < 4 || piece > stride ||
      (piece < stride && piece % 8) ||
      key_col < 0 || key_col >= ncols ||
      reinterpret_cast<uintptr_t>(out) % 16 || order_warps(V, piece) < 1)
    return cudaErrorInvalidValue;
  OrderCols src{};
  src.ncols = ncols;
  src.far = far;
  for (int q = 0; q < ncols && q < kOrderInline; ++q)
    src.col[q] = static_cast<const int32_t*>(cols[q]);
  auto s = static_cast<cudaStream_t>(stream);
  if (piece == stride)
    return launch_order(order_scatter_kernel, V, stride, G, S, s, V, key_col,
                        off, int64_t(G) * S, n, S, start, src, stride, out);
  return launch_order(order_scatter_pieces_kernel, V, piece, G, S, s, V,
                      key_col, off, int64_t(G) * S, n, S, start, src, stride,
                      piece, out);
}

}  // extern "C"
