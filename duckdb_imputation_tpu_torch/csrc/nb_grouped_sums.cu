// K6 and K6w: the grouped naive-Bayes sums, for sm_90a: per group g the
// sums over its rows of w·F, F = [1 ‖ x ‖ x² ‖ onehot(codes)] (F = 1 + 2d +
// V features), the whole of an NB aggregate. G = 1 is the ungrouped one.
//
// Replaces the Pallas kernel of duckdb_imputation_tpu/ring/kernels/
// nb_pallas.py, _nb_grouped_pallas, with both of its bodies: _nb_kernel
// (general weights) and _nb_kernel_fast (binary weights through a 3-way
// bf16 split of x and x², for the TPU's matrix unit). Here the sums are
// plain f32 and f64 on the CUDA cores, for any weights. K6 takes F ≤
// kThreads = 256; K6w, the same kernel with more than one feature range on
// blockIdx.y, takes wider F (favorita_classify: F = 462 and 493).
//
// What bounds it on an H100: there is no Gram, only one reduction pass,
// so the kernel is bound by reading its inputs once: 4·d + 4·c + 8 bytes a
// row (56 at BASELINE config 3, d = 8, c = 4; 52 at favorita_classify),
// ~0.16-0.17 ms per 10M rows at 3.35 TB/s. The design reads each input
// once per feature range and per launch of 32 groups, coalesced, and
// builds x² and the one-hot only in registers.
//
// Layout of the work: blockIdx.y picks a range of at most kThreads
// features, f0 = 256·blockIdx.y. A block stages kChunk rows, bucketed by
// group (bucket.cuh). Thread t owns one feature f = f0 + t mod Fr (Fr the
// range's width) and one row group t / Fr, and for each group runs over
// that group's staged rows with an f32 sum, which it adds to its own f64
// slot in shared memory. So x and x² are summed in f32 within a chunk and
// in f64 from there on, in a fixed order; counts (the 1 and one-hot
// features, with binary weights) are exact, since an f32 sum of at most
// kChunk ones is exact and every later sum is in f64. Across blocks, one
// warp per (group, feature) entry sums the blocks' partials in f64 and
// rounds once. No atomics: reruns are bit-identical.
//
// Where trouble is likely: the G × F block of accumulators. Each thread's
// f64 slots take G · kThreads · 8 bytes of shared memory (2 KB a group),
// so one launch takes at most kMaxNbGroups = 32 groups and a block one
// range of kThreads features; the wrapper runs more groups as several
// launches, each over the rows of 32 groups (`gbase`), and the kernel more
// features as more ranges, each reading the table again (K6w: 2 ranges at
// favorita_classify, so 2 table reads a launch).
#include "bucket.cuh"

namespace dit {
namespace {

constexpr int kMaxNbGroups = kMaxBucketGroups;
constexpr int kMaxNbRanges = 65535;  // feature ranges: gridDim.y's limit
constexpr int kStage = kChunk + 1;  // odd row stride: no bank conflicts

struct NbGeom {
  int F;   // features 1 + 2d + V
  int G;   // groups of this launch
  int gbase;  // id of its group 0
  int64_t n;
};

// Shared memory: f64 slots [G][kThreads], staged rows x [d][kStage],
// codes [c][kStage], weights [kChunk], then the bucket ints.
inline size_t nb_smem_bytes(int d, int c, int G) {
  return sizeof(double) * G * kThreads +
         sizeof(float) * ((d + c) * kStage + kChunk + bucket_ints(G));
}

__global__ void __launch_bounds__(kThreads)
nb_kernel(const __grid_constant__ Cols cols, const __grid_constant__ NbGeom nb,
          const float* __restrict__ w, const int32_t* __restrict__ gid,
          double* __restrict__ partial) {
  extern __shared__ double dsmem[];
  double* accs = dsmem;                                      // [G][kThreads]
  float* xs = reinterpret_cast<float*>(accs + nb.G * kThreads);  // [d][kStage]
  int* cs = reinterpret_cast<int*>(xs + cols.d * kStage);    // [c][kStage]
  float* ws = reinterpret_cast<float*>(cs + cols.c * kStage);  // [kChunk]
  int* ints = reinterpret_cast<int*>(ws + kChunk);
  const int* bstart = ints + kWarps * nb.G;
  const int d = cols.d;

  // this block's feature range f0 .. f0 + Fr, its R = kThreads / Fr row
  // groups; this thread's feature: 0 → 1; 1..d → x; d+1..2d → x²; then
  // one-hots
  const int f0 = blockIdx.y * kThreads;
  const int Fr = nb.F - f0 < kThreads ? nb.F - f0 : kThreads;
  const int R = kThreads / Fr;
  const int f = f0 + threadIdx.x % Fr, rg = threadIdx.x / Fr;
  const bool active = rg < R;
  int kind = 0, col = 0, val = 0;
  if (f >= 1 && f <= d) {
    kind = 1;
    col = f - 1;
  } else if (f > d && f <= 2 * d) {
    kind = 2;
    col = f - 1 - d;
  } else if (f > 2 * d) {
    kind = 3;
    int v = f - 1 - 2 * d;
    while (v >= cols.size[col]) v -= cols.size[col++];
    val = v;
  }
  for (int g = 0; g < nb.G; ++g) accs[g * kThreads + threadIdx.x] = 0.0;

  const int64_t nchunks = (nb.n + kChunk - 1) / kChunk;
  for (int64_t ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int64_t row = ch * kChunk + threadIdx.x;
    int grp = -1;
    if (row < nb.n) {
      const int g = gid[row] - nb.gbase;
      if (g >= 0 && g < nb.G) grp = g;
    }
    const int slot = bucket_slot(grp, nb.G, ints);
    if (slot >= 0) {
      for (int j = 0; j < d; ++j) xs[j * kStage + slot] = cols.x[j][row];
      for (int j = 0; j < cols.c; ++j) cs[j * kStage + slot] = cols.code[j][row];
      ws[slot] = w[row];
    }
    __syncthreads();
    if (active) {
      const float* xr = xs + col * kStage;
      const int* cr = cs + col * kStage;
      for (int g = 0; g < nb.G; ++g) {
        const int r1 = bstart[g + 1];
        float s = 0.0f;
        if (kind == 0) {
          for (int r = bstart[g] + rg; r < r1; r += R) s += ws[r];
        } else if (kind == 1) {
          for (int r = bstart[g] + rg; r < r1; r += R) s += ws[r] * xr[r];
        } else if (kind == 2) {
          for (int r = bstart[g] + rg; r < r1; r += R) {
            const float x = xr[r];
            s += ws[r] * (x * x);
          }
        } else {
          for (int r = bstart[g] + rg; r < r1; r += R)
            if (cr[r] == val) s += ws[r];
        }
        accs[g * kThreads + threadIdx.x] += static_cast<double>(s);
      }
    }
    __syncthreads();
  }

  // the block's row groups in a fixed order → partial[(g·F + f)·gridDim.x
  // + blockIdx.x] for the range's features f
  for (int e = threadIdx.x; e < nb.G * Fr; e += blockDim.x) {
    const int g = e / Fr, ff = e % Fr;
    double s = 0.0;
    for (int r = 0; r < R; ++r) s += accs[g * kThreads + r * Fr + ff];
    partial[(int64_t(g) * nb.F + f0 + ff) * gridDim.x + blockIdx.x] = s;
  }
}

// One warp per entry e of [E]: Σ over blocks in f64, one rounding.
__global__ void nb_reduce(const double* __restrict__ partial, int nblocks,
                          int E, float* __restrict__ out) {
  const int64_t warp =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= E) return;
  double s = 0.0;
  for (int b = lane; b < nblocks; b += 32) s += partial[warp * nblocks + b];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[warp] = static_cast<float>(s);
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K6 (F = 1 + 2d + V ≤ 256) or K6w (F above, ceil(F / 256)
// feature ranges) and the reduction on `stream` for the groups gbase ..
// gbase + G − 1 (1 ≤ G ≤ kMaxNbGroups); rows with other ids add nothing.
// out: f32[G, F], the rows of those groups. partial: f64 scratch of
// G · F · nblocks. Returns 0 or a cudaError_t.
int dit_nb_grouped_sums(const void* const* x_cols, int d,
                        const void* const* code_cols, const int* cat_sizes,
                        int c, const float* w, const int32_t* gid, int gbase,
                        int G, int64_t n, double* partial, int nblocks,
                        float* out, void* stream) {
  using namespace dit;
  if (d < 0 || c < 0 || d > kMaxCols || c > kMaxCols) return cudaErrorInvalidValue;
  int F = 1 + 2 * d;
  for (int j = 0; j < c; ++j) {
    if (cat_sizes[j] < 0) return cudaErrorInvalidValue;
    F += cat_sizes[j];
  }
  const int ranges = (F + kThreads - 1) / kThreads;
  if (ranges > kMaxNbRanges || G < 1 || G > kMaxNbGroups || nblocks < 1 ||
      n < 0 || n >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const NbGeom nb{F, G, gbase, n};
  const size_t smem = nb_smem_bytes(d, c, G);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        nb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  auto s = static_cast<cudaStream_t>(stream);
  nb_kernel<<<dim3(nblocks, ranges), kThreads, smem, s>>>(cols, nb, w, gid,
                                                        partial);
  if (cudaError_t rc = cudaGetLastError()) return rc;
  const int E = G * F;
  const int64_t blocks = (int64_t(E) * 32 + kThreads - 1) / kThreads;
  nb_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(partial,
                                                              nblocks, E, out);
  return cudaGetLastError();
}

}  // extern "C"
