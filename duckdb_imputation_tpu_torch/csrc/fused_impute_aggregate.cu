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
// lowest class index, as in class_argmax; a row whose every score is -inf
// or NaN gets class 0.
//
// Noise (numeric columns): one counter-based Philox4x32-10 draw keyed by
// (seed) with counter (global row, round, column), then Box-Muller. The
// plain version in sigma_fused.py computes the same bits with int64 torch
// ops; only logf/cosf rounding may differ. Every schema has noise.
//
// Two routes, as K1's (masked_gram.cu):
// - the tensor cores, for a schema whose S is tc_gram.cuh's one output
//   tile (tc_fits: P ≤ 21, 1 + 3d + V ≤ 32; BASELINE configs 4 and 5):
//   K1's kernel with the prologue TcImpute. Each thread stages its row's
//   null byte beside w, x and codes; after its wait_group it scores a null
//   row from the values it staged and W, b in shared memory (loaded once
//   a launch; 'cat' four classes a 16-byte read), adds the noise, writes the
//   new value to the output column (coalesced) and puts it in its staged
//   row, so the three-way bf16 split and the products aggregate the
//   updated row. What
//   bounds it is K1's (tc_gram.cuh) plus 1 byte read and 4 written a row
//   and R·(1 + d + c) scoring terms a null row;
// - the CUDA cores (fused_kernel), for any other P ≤ 88: each thread
//   stages a dense row of Z in shared memory, scores and imputes it there,
//   and the 4×4 tiles of gram_common.cuh accumulate the chunk.
// Each row is read and written by one thread, but the kernel writes the
// imputed column to a separate output buffer: the inputs stay unchanged.
//
// K2w, the same pass for P > 88 (dit_fused_impute_aggregate_wide), is the
// counterpart of _fused_impute_aggregate_v2 / _v3 at pack = 1: an impute
// kernel, then K7 (wide_gram.cuh) over the columns with the new one in the
// old one's place. Re-scoring the rows in every K7 task instead would cost
// R·(1 + d + c) operations a row per task, more than the Gram itself at
// R = 337. 'num' takes one thread a row (impute_num_wide_kernel: ~0.2 ms
// at 10M rows, near its bytes floor). 'cat' (impute_cat_tiles_kernel)
// works only on the null rows and reads W from shared memory:
//   1. A block owns a contiguous slice of rows (one wave of blocks). Its
//      threads read null_imp and the old code coalesced, 8 rows a thread
//      a step (their loads in flight together), write out = old for the
//      rows not null, and list the null rows in order in a scratch i32[n]
//      (a warp ballot and a block prefix).
//   2. The null rows in batches: each row's terms are staged once in
//      shared memory, its x, then for each
//      categorical column the offset of its code's W row (a code outside
//      [0, size) points at a row of zeros, which adds nothing).
//   3. W[:, k0 .. k0 + ld) and b (the tile) lie in shared memory as
//      [P + 2][ld] (a row of zeros, then b); when W fits whole it is loaded
//      once a launch (R = 33 at P = 492: 65 KB), else its class tiles are
//      streamed past each batch with cp.async, one buffer (two buffers of
//      32 classes lost to one of 64 at R = 337: PERF.md). A warp scores
//      kImpRows rows at once (independent chains of
//      adds), lane l the classes k0 + l + 32i (i < M): words next to each
//      other, no bank conflicts, a row's terms broadcast. A tile's first
//      max is one
//      __reduce_max_sync of an order-preserving key of the scores (NaN
//      lowest, -0 as +0) and one __reduce_min_sync of the classes that
//      reach it; the row's running (key, class) in shared memory takes it
//      only if strictly larger, so the result is the first max over all
//      classes.
// Past kMaxWideP (dit_impute_wide, any P ≤ kMaxWindowP with (P + 2)·ldw <
// 2³¹) W no longer fits
// shared memory (a class tile [P + 2][32] f32 is 588 KB at favorita_items,
// P = 4,592), and a null row needs only its own 1 + d + c rows of W: the
// same kernel (kGlobalW) reads them from device memory, where W padded to
// [P + 2][ldw] (ldw a multiple of the tile, a row of zeros, then b) lies in
// L2 (606 KB at R = 33, 7 MB at R = 337), lane l again the classes
// k0 + l + 32i, a 128-byte read a warp a term; the compaction, the scoring
// order and the first-max merge are the same. Where a batch of 32 rows'
// terms does not fit shared memory beside the class tile (d ≥ 881 at R =
// 33 with W whole; d ≥ 1,801 with W in device memory: Epsilon's 2,000
// columns), a batch row keeps only its codes' offsets, and each x is read
// from device memory as the row is scored (kGlobalX: the same terms in the
// same order, so the same scores). Then the caller runs K7 over
// the column windows of S (dit_wide_gram_window) with the new column in the
// old one's place.
// What bounds K2w's 'cat' impute kernel: one read of the mask and the old
// code and one write of the new code for all rows, x and codes of the null
// rows (bytes: ~0.04 ms at 10M rows); the shared-memory reads of the
// categorical lookups, R·c a null row (the numeric terms can stay in
// registers; ~2M null rows × 9 codes × 337 classes ≈ 6.1G words at
// R = 337; at one 128-byte warp read a clock per SM about 0.73 ms;
// PERF.md).
#include "tc_gram.cuh"
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
  int64_t row_offset;   // global id of local row 0 (a row shard's first)
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

// N(0, 1) for local row `row`, keyed by its global id row + row_offset
// (so a row draws the same number whatever shard holds it): Box-Muller on
// the first two Philox words, each mapped to (0, 1] as ((bits >> 8) + 1)
// · 2⁻²⁴.
__device__ __forceinline__ float row_normal(const Noise& nz, int64_t row) {
  const uint64_t g = static_cast<uint64_t>(row + nz.row_offset);
  uint32_t c[4] = {static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                   nz.round, nz.column};
  philox4x32_10(c, nz.key0, nz.key1);
  const float u1 = static_cast<float>((c[0] >> 8) + 1u) * 0x1p-24f;
  const float u2 = static_cast<float>((c[1] >> 8) + 1u) * 0x1p-24f;
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318530717958647692f, u2)));
}

// Q values of W's row a, classes k0 .. k0 + Q - 1 (W f32[., ld]): one
// 16-byte read for Q = 4 (16-byte aligned: ld and k0 multiples of 4).
// a·ld stays an int: a < P + 2 and (P + 2)·ld < 2³¹ wherever it is read
// (K2's W in shared memory at P ≤ 88, K2w's whole W at P ≤ 1,024, the
// 'num' kernels' ld = 1; K2w's padded W in device memory is read through
// int offsets that launch_impute_cat bounds the same way).
template <int Q>
__device__ __forceinline__ void w_row(const float* W, int a, int ld, int k0,
                                      float v[Q]) {
  const float* p = W + a * ld + k0;
  if constexpr (Q == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = p[q];
  }
}

// The scores of classes k0 .. k0 + Q - 1 of a row whose numeric values
// x(j) and codes code(j) the accessors give, in ring/sum.py:class_score's
// order: (b_k + W₀ₖ), then each numeric term, then each categorical
// column's coefficient (none for an out-of-vocab code). W f32[P, ld],
// b f32[ld]; Q = 4 (classes past R read W's zero padding) lets four chains
// of adds overlap, each term read once for them. Far: a wide kernel's
// columns, read through Cols' accessors (past kInlineCols, from `far`).
template <int Q, bool Far = false, class X, class Code>
__device__ __forceinline__ void class_scores(int k0, int ld, const float* W,
                                             const float* b, const Cols& cols,
                                             X x, Code code, float acc[Q]) {
  float bv[Q], v[Q];
  w_row<Q>(b, 0, ld, k0, bv);
  w_row<Q>(W, 0, ld, k0, v);
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = __fadd_rn(bv[q], v[q]);
  for (int j = 0; j < cols.d; ++j) {
    const float xv = x(j);
    w_row<Q>(W, 1 + j, ld, k0, v);
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(v[q], xv));
  }
  for (int j = 0; j < cols.c; ++j) {
    const int cv = code(j);
    if (cv >= 0 && cv < (Far ? cols.sz(j) : cols.size[j])) {
      w_row<Q>(W, (Far ? cols.of(j) : cols.off[j]) + cv, ld, k0, v);
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = __fadd_rn(acc[q], v[q]);
    }
  }
}

// The staged row of a thread of the tensor-core route: its raw values
// rb[col · kTcRows] (w, x, codes).
struct RawX {
  const float* rb;
  __device__ float operator()(int j) const { return rb[(1 + j) * kTcRows]; }
};
struct RawCode {
  const float* rb;
  int d;
  __device__ int operator()(int j) const {
    return __float_as_int(rb[(1 + d + j) * kTcRows]);
  }
};

// The first max of the R class scores of a staged row, class 0 when every
// score is -inf or NaN: four classes at a time (W[P][ld] and b[ld] with
// ld = R rounded up to 4, zeros past R); a class past R is not compared.
__device__ __forceinline__ int argmax_raw(const float* rb, int R, int ld,
                                          const float* Ws, const float* bs,
                                          const Cols& cols) {
  float best_v = -INFINITY;
  int best = 0;
  for (int k0 = 0; k0 < R; k0 += 4) {
    float acc[4];
    class_scores<4>(k0, ld, Ws, bs, cols, RawX{rb}, RawCode{rb, cols.d}, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k0 + q < R && acc[q] > best_v) {
        best_v = acc[q];
        best = k0 + q;
      }
  }
  return best;
}

// K2's prologue on the tensor-core route (tc_gram.cuh), one kernel for
// each kind: stages the row's null byte, and imputes the staged row
// before it is split. Its shared memory
// (16-byte aligned, tc_gram.cuh): W f32[P, ld], b f32[ld] (ld = R rounded
// up to 4 for 'cat', zeros past R; R = 1 for 'num'), the noise std.
template <int Kind>
struct TcImpute {
  static constexpr int kExtraCols = 1;
  // five blocks an SM, as K1 (96 registers): the scoring of a 'cat' row
  // would take 128 and leave four
  static constexpr int kMinBlocks = 5;
  const uint8_t* null_imp;
  int64_t lo, hi;   // the rows whose aligned word lies in null_imp[0, n)
  const float* w_full;
  const float* intercept;
  int P, R, imp_col;
  void* out_col;
  Noise nz;

  __host__ __device__ int ld() const {
    return Kind == kCat ? (R + 3) & ~3 : R;
  }
  int smem_floats() const { return P * ld() + ld() + 1; }

  // a·R + k < P·R ≤ 21 · 21 here (_build.py: tc_fits)
  __device__ __forceinline__ void load(float* sm) const {
    const int L = ld();
    for (int i = threadIdx.x; i < (P + 1) * L; i += blockDim.x) {
      const int a = i / L, k = i % L;
      sm[i] = k >= R ? 0.0f : a < P ? w_full[a * R + k] : intercept[k];
    }
    if (threadIdx.x == 0) sm[(P + 1) * L] = nz.on ? *nz.std : 0.0f;
  }

  // cp.async copies 4, 8 or 16 aligned bytes: the aligned word holding
  // byte `row` for a row in [lo, hi); else (the first or last bytes of a
  // tensor that does not start or end on a word) the byte itself, by a
  // plain load, in its place in the word.
  __device__ __forceinline__ void stage(float* dst, int64_t row,
                                        bool valid) const {
    const uintptr_t at = reinterpret_cast<uintptr_t>(null_imp + row);
    if (valid && (row < lo || row >= hi)) {
      *reinterpret_cast<uint32_t*>(dst) = uint32_t(null_imp[row])
                                          << (8 * (at & 3));
      return;
    }
    tc_stage4(dst, reinterpret_cast<const void*>(at & ~uintptr_t(3)), valid,
              0.0f);
  }

  __device__ __forceinline__ void apply(float* rb, const float* sm,
                                        const Cols& cols, int64_t row,
                                        bool valid) const {
    if (!valid) return;
    const unsigned word =
        __float_as_uint(rb[(1 + cols.d + cols.c) * kTcRows]);
    const int shift =
        8 * static_cast<int>(reinterpret_cast<uintptr_t>(null_imp + row) & 3);
    const bool impute = ((word >> shift) & 0xffu) != 0;
    const float* Ws = sm;
    const float* bs = sm + P * ld();
    if constexpr (Kind == kCat) {
      float* cp = rb + (1 + cols.d + imp_col) * kTcRows;
      int val = __float_as_int(*cp);
      if (impute) {
        val = argmax_raw(rb, R, ld(), Ws, bs, cols);
        *cp = __int_as_float(val);
      }
      static_cast<int32_t*>(out_col)[row] = val;
    } else {
      float* xp = rb + (1 + imp_col) * kTcRows;
      float val = *xp;
      if (impute) {
        class_scores<1>(0, 1, Ws, bs, cols, RawX{rb}, RawCode{rb, cols.d},
                        &val);
        if (nz.on)
          val = __fadd_rn(val, __fmul_rn(sm[(P + 1) * ld()], row_normal(nz, row)));
        *xp = val;
      }
      static_cast<float*>(out_col)[row] = val;
    }
  }
};

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
      auto x_at = [&](int j) { return zr[1 + j]; };
      auto code_at = [&](int j) { return cols.code[j][row]; };
      if (kind == kCat) {
        float best_v = -INFINITY;
        int best = 0;
        for (int k = 0; k < R; ++k) {
          float s;
          class_scores<1>(k, R, Ws, bs, cols, x_at, code_at, &s);
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
          class_scores<1>(0, R, Ws, bs, cols, x_at, code_at, &val);
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

// K2w 'cat' (see the top of this file). Shared memory, from the host's
// plan (_build.impute_plan): a tile of [P + 2][ld] f32 (W's rows, a row of
// zeros, b), then per batch row its terms (x as f32 bits, then the
// codes' W-row offsets, each part padded to whole 16-byte words), its
// running key and class and its row index, and the counts of a compaction
// step.
constexpr int kImpThreads = 1024;            // threads of a block
constexpr int kImpWarps = kImpThreads / 32;
constexpr int kImpMaxM = 4;                  // most classes a lane a tile
constexpr int kImpRows = 4;                  // rows a warp scores at once
constexpr int kFillRows = 8;                 // rows a thread a compaction step
static_assert(kFillRows * kImpWarps == 8 * 32,
              "a step's counts, 8 a lane of one warp");

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// tile_floats: the class tile [P + 2][ld] in shared memory, 0 when W is
// read from device memory (kGlobalW); x_terms: whether a batch row keeps
// its x (else kGlobalX)
inline size_t impute_smem_bytes(int tile_floats, int d, int c, int batch,
                                bool x_terms) {
  return sizeof(float) * (size_t(round4(tile_floats)) +
                          size_t(batch) * (3 + (x_terms ? round4(d) : 0) +
                                           round4(c)) +
                          kFillRows * kImpWarps + 1);
}

// Whether the plan's batch rows keep their x in shared memory: where it
// fits (mirrored by _build.py: impute_x_terms).
inline bool impute_x_terms(int tile_floats, int d, int c, int batch) {
  return impute_smem_bytes(tile_floats, d, c, batch, true) <=
         size_t(kWideSmem);
}

// An unsigned key in the order of the float scores, so that one
// __reduce_max_sync finds the largest: -0 counted as +0 (they compare
// equal), NaN below every score (it never wins a strict >).
__device__ __forceinline__ uint32_t score_key(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  if (v != v) return 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr uint32_t kKeyNegInf = 0x007FFFFFu;   // score_key(-inf)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// kGlobalW: W is the padded [P + 2][ldw] in device memory (ldw ≥ the
// tiles' classes; row P zeros, row P + 1 b) and b is unused; else W f32[P,
// R] and b f32[R], staged as tiles [P + 2][ld] in shared memory (ldw = ld).
// kGlobalX: a batch row's terms hold only its codes' offsets, and x is
// read from device memory (the row's index in `list`) as it is scored.
template <int M, bool kGlobalW, bool kGlobalX>
__global__ void __launch_bounds__(kImpThreads)
impute_cat_tiles_kernel(const __grid_constant__ Cols cols, int64_t n,
                        int64_t slice, const uint8_t* __restrict__ null_imp,
                        const float* __restrict__ W,
                        const float* __restrict__ b, int P, int R,
                        int imp_col, int ld, int ldw, int batch,
                        int* __restrict__ rows, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char imp_smem[];
  const int d = cols.d, c = cols.c;
  const int cx = kGlobalX ? 0 : round4(d), tsp = cx + round4(c);  // terms
  float* wbuf = reinterpret_cast<float*>(imp_smem);   // the tile
  int* terms =
      reinterpret_cast<int*>(wbuf + (kGlobalW ? 0 : round4((P + 2) * ld)));
  uint32_t* bkey = reinterpret_cast<uint32_t*>(terms + batch * tsp);
  int* bcls = reinterpret_cast<int*>(bkey + batch);
  int* list = bcls + batch;
  int* wsum = list + batch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (R + ld - 1) / ld;

  // row P: the zeros an out-of-range code adds
  if constexpr (!kGlobalW)
    for (int i = tid; i < ld; i += kImpThreads) wbuf[P * ld + i] = 0.0f;
  // tile t: W[:, t·ld ..) into rows 0 .. P - 1 and b into row P + 1, one
  // cp.async group; a warp a row, lanes over classes
  auto load_tile = [&](int t) {
    if constexpr (kGlobalW) return;
    const int k0 = t * ld, kw = min(ld, R - k0);
    for (int a = warp; a <= P; a += kImpWarps) {
      const float* src = a < P ? W + int64_t(a) * R + k0 : b + k0;
      float* row = wbuf + (a < P ? a : P + 1) * ld;
      for (int k = lane; k < kw; k += 32) cp_async4(row + k, src + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int64_t r0 = int64_t(blockIdx.x) * slice < n
                         ? int64_t(blockIdx.x) * slice : n;
  const int64_t r1 = r0 + slice < n ? r0 + slice : n;
  load_tile(0);   // W whole, once a launch, or the first batch's tile 0

  // 1. the slice in steps of kFillRows rows a thread (their loads in
  // flight together): out = old for the rows not null, the null rows
  // listed in order in rows[r0 ..) (a warp ballot and a block prefix)
  const int32_t* old = cols.cp(imp_col);
  int total = 0;
  for (int64_t base = r0; base < r1;
       base += int64_t(kImpThreads) * kFillRows) {
    uint8_t nb[kFillRows];
    int32_t oc[kFillRows];
#pragma unroll
    for (int q = 0; q < kFillRows; ++q) {
      const int64_t row = base + int64_t(q) * kImpThreads + tid;
      nb[q] = row < r1 ? null_imp[row] : 0;
      oc[q] = row < r1 ? old[row] : 0;
    }
    unsigned bal[kFillRows];
#pragma unroll
    for (int q = 0; q < kFillRows; ++q) {
      const int64_t row = base + int64_t(q) * kImpThreads + tid;
      if (row < r1 && nb[q] == 0) out[row] = oc[q];
      bal[q] = __ballot_sync(0xffffffffu, nb[q] != 0);
      if (lane == 0) wsum[q * kImpWarps + warp] = __popc(bal[q]);
    }
    __syncthreads();
    if (warp == 0) {   // exclusive prefix of the counts in (q, warp) order
      int v[8], sum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += (v[k] = wsum[lane * 8 + k]);
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        wsum[lane * 8 + k] = run;
        run += v[k];
      }
      if (lane == 31) wsum[8 * 32] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFillRows; ++q)
      if (nb[q] != 0)
        rows[r0 + total + wsum[q * kImpWarps + warp] +
             __popc(bal[q] & ((1u << lane) - 1u))] =
            static_cast<int>(base + int64_t(q) * kImpThreads + tid);
    total += wsum[8 * 32];
    __syncthreads();
  }

  // 2.-3. the null rows in batches
  for (int b0 = 0; b0 < total; b0 += batch) {
    const int count = min(batch, total - b0);
    if (b0 > 0 && tiles > 1) load_tile(0);   // the buffer is free
    for (int e = tid; e < count; e += kImpThreads)
      list[e] = rows[r0 + b0 + e];
    __syncthreads();
    // 2. the batch's terms, once: x, then each code's W-row offset
    for (int e = tid; e < count; e += kImpThreads) {
      const int row = list[e];
      int* te = terms + e * tsp;
#pragma unroll 4
      for (int j = 0; j < cx; ++j)   // none with kGlobalX
        te[j] = j < d ? __float_as_int(cols.xp(j)[row]) : 0;
#pragma unroll 4
      for (int j = 0; j < c; ++j) {
        const int code = cols.cp(j)[row];
        te[cx + j] =
            (code >= 0 && code < cols.sz(j) ? cols.of(j) + code : P) * ldw;
      }
    }
    for (int e = tid; e < count; e += kImpThreads) {
      bkey[e] = kKeyNegInf;
      bcls[e] = 0;
    }

    // 3. the class tiles past the batch
    // (the buffer is free once the last tile's scoring passed its barrier)
    for (int t = 0; t < tiles; ++t) {
      if (t > 0) load_tile(t);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      const int k0 = t * ld;
      const float* Wt = kGlobalW ? W + k0 + lane : wbuf + lane;
      // b + W₀ and the lane's classes in range, the same for every row
      float bw[M];
      bool in[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        bw[i] = __fadd_rn(Wt[(P + 1) * ldw + 32 * i], Wt[32 * i]);
        in[i] = lane + 32 * i < ld && k0 + lane + 32 * i < R;
      }
      // kImpRows rows at once: independent chains of adds (a row past
      // count repeats the last row and is not merged)
      for (int e0 = warp * kImpRows; e0 < count;
           e0 += kImpWarps * kImpRows) {
        const int* tr[kImpRows];
        int xrow[kImpRows];   // kGlobalX: the rows whose x is read
        float acc[kImpRows][M];
#pragma unroll
        for (int r = 0; r < kImpRows; ++r) {
          tr[r] = terms + min(e0 + r, count - 1) * tsp;
          if constexpr (kGlobalX) xrow[r] = list[min(e0 + r, count - 1)];
#pragma unroll
          for (int i = 0; i < M; ++i) acc[r][i] = bw[i];
        }
        for (int j = 0; j < d; ++j) {
          const float* wr = Wt + (1 + j) * ldw;
          float wv[M];
#pragma unroll
          for (int i = 0; i < M; ++i) wv[i] = wr[32 * i];
          const float* xj = kGlobalX ? cols.xp(j) : nullptr;
#pragma unroll
          for (int r = 0; r < kImpRows; ++r) {
            const float xv = kGlobalX ? __ldg(xj + xrow[r])
                                      : __int_as_float(tr[r][j]);
#pragma unroll
            for (int i = 0; i < M; ++i)
              acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(wv[i], xv));
          }
        }
        int j = cx;
        for (; j + 4 <= cx + c; j += 4) {   // four codes a 16-byte read
#pragma unroll
          for (int r = 0; r < kImpRows; ++r) {
            const int4 o = *reinterpret_cast<const int4*>(tr[r] + j);
#pragma unroll
            for (int i = 0; i < M; ++i) {
              acc[r][i] = __fadd_rn(acc[r][i], Wt[o.x + 32 * i]);
              acc[r][i] = __fadd_rn(acc[r][i], Wt[o.y + 32 * i]);
              acc[r][i] = __fadd_rn(acc[r][i], Wt[o.z + 32 * i]);
              acc[r][i] = __fadd_rn(acc[r][i], Wt[o.w + 32 * i]);
            }
          }
        }
        for (; j < cx + c; ++j)
#pragma unroll
          for (int r = 0; r < kImpRows; ++r) {
            const int o = tr[r][j];
#pragma unroll
            for (int i = 0; i < M; ++i)
              acc[r][i] = __fadd_rn(acc[r][i], Wt[o + 32 * i]);
          }
        // each row's first max of the tile: the lane's (strict >, classes
        // ascending), then the largest key and the lowest class reaching it
#pragma unroll
        for (int r = 0; r < kImpRows; ++r) {
          float best = -INFINITY;
          int cls = 0;
#pragma unroll
          for (int i = 0; i < M; ++i)
            if (in[i] && acc[r][i] > best) {
              best = acc[r][i];
              cls = k0 + lane + 32 * i;
            }
          const uint32_t key = score_key(best);
          const uint32_t top = __reduce_max_sync(0xffffffffu, key);
          const uint32_t first = __reduce_min_sync(
              0xffffffffu, key == top ? uint32_t(cls) : 0xffffffffu);
          const int e = e0 + r;
          if (lane == 0 && e < count && top > bkey[e]) {
            bkey[e] = top;
            bcls[e] = static_cast<int>(first);
          }
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < count; e += kImpThreads) out[list[e]] = bcls[e];
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
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
    float val = cols.xp(imp_col)[row];
    if (null_imp[row] != 0) {
      class_scores<1, true>(0, 1, W, b, cols,
                            [&](int j) { return cols.xp(j)[row]; },
                            [&](int j) { return cols.cp(j)[row]; }, &val);
      if (nz.on) val = __fadd_rn(val, __fmul_rn(noise_std, row_normal(nz, row)));
    }
    out[row] = val;
  }
}

// The kind, imputed column and class count a fused pass takes; 0 or a
// cudaError_t.
inline int check_impute(int kind, int imp_col, int R, int d, int c,
                        const int* cat_sizes) {
  if (kind == kCat) {
    if (imp_col < 0 || imp_col >= c || R != cat_sizes[imp_col] || R < 1)
      return cudaErrorInvalidValue;
  } else if (kind == kNum) {
    if (imp_col < 0 || imp_col >= d || R != 1) return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}

// The 'cat' impute kernel of M classes a lane, W in shared memory or
// device memory (global), x in shared memory or not (kGlobalX).
template <bool kGlobalX>
inline decltype(&impute_cat_tiles_kernel<1, false, false>) pick_impute_cat(
    int M, bool global) {
  return global ? (M == 1 ? impute_cat_tiles_kernel<1, true, kGlobalX>
                   : M == 2 ? impute_cat_tiles_kernel<2, true, kGlobalX>
                   : M == 3 ? impute_cat_tiles_kernel<3, true, kGlobalX>
                            : impute_cat_tiles_kernel<4, true, kGlobalX>)
                : (M == 1 ? impute_cat_tiles_kernel<1, false, kGlobalX>
                   : M == 2 ? impute_cat_tiles_kernel<2, false, kGlobalX>
                   : M == 3 ? impute_cat_tiles_kernel<3, false, kGlobalX>
                            : impute_cat_tiles_kernel<4, false, kGlobalX>);
}

// K2w 'cat': the impute kernel of plan (ld, M, batch), a wave of
// blocks each owning a slice of whole 32-row steps; rows: i32[n] scratch
// for the null rows of each slice.
// global: W is the padded [P + 2][ldw] in device memory (kGlobalW), with
// ld = 32·M and ldw a multiple of ld of at least R; else ldw = ld.
inline int launch_impute_cat(const Cols& cols, int64_t n,
                             const uint8_t* null_imp, const float* W,
                             const float* b, int P, int R, int imp_col,
                             const int* plan, int* rows, int32_t* out,
                             cudaStream_t s, bool global = false,
                             int ldw = 0) {
  const int ld = plan[0], M = plan[1], batch = plan[2];
  if (M < 1 || M > kImpMaxM || ld < 1 || ld > 32 * M || ld <= 32 * (M - 1) ||
      batch < 32 || batch % 32 != 0)
    return cudaErrorInvalidValue;
  // the batch rows' W offsets are ints: W padded to [P + 2][ldw] stays
  // below 2³¹ cells (_build.py: impute_global_plan raises before this)
  if (!global) ldw = ld;
  else if (ld != 32 * M || ldw < R || ldw % ld != 0 ||
           int64_t(P + 2) * ldw > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int tile = global ? 0 : (P + 2) * ld;
  const bool x_terms = impute_x_terms(tile, cols.d, cols.c, batch);
  const size_t smem =
      impute_smem_bytes(tile, cols.d, cols.c, batch, x_terms);
  if (smem > size_t(kWideSmem)) return cudaErrorInvalidValue;
  decltype(&impute_cat_tiles_kernel<1, false, false>) kern =
      !x_terms ? pick_impute_cat<true>(M, global)
               : pick_impute_cat<false>(M, global);
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                     kImpThreads, smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // each row's output stands alone: the grid may follow the card
  const int64_t steps = (n + 31) / 32;
  int64_t blocks = int64_t(sms) * per_sm;
  if (blocks > steps) blocks = steps;
  const int64_t slice = (steps + blocks - 1) / blocks * 32;
  blocks = (n + slice - 1) / slice;
  kern<<<static_cast<int>(blocks), kImpThreads, smem, s>>>(
      cols, n, slice, null_imp, W, b, P, R, imp_col, ld, ldw, batch, rows,
      out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K2 on the tensor cores (the prologue TcImpute over
// tc_gram.cuh) and its cross-block reduction on `stream`, for a schema
// that tc_fits (_build.tc_fits). kind: 0 = 'cat' (R classes, out_col
// i32[n]), 1 = 'num' (R = 1, out_col f32[n]). noise_std: f32[1] on the
// device, read only when noise is nonzero; row_offset: the global id of
// row 0, which the noise is keyed by. partial: f64 scratch of 21 · 21
// · nblocks; sigma: f32[P, P]. Returns 0 or a cudaError_t.
int dit_fused_impute_aggregate(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const uint8_t* null_imp, const float* w_agg,
    const float* w_full, const float* intercept, int R, int kind,
    int imp_col, void* out_col, int noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t round, int64_t row_offset,
    const float* noise_std, int64_t n,
    int P, double* partial, int nblocks, float* sigma, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (int rc = check_impute(kind, imp_col, R, d, c, cat_sizes)) return rc;
  if (!tc_fits(d, P)) return cudaErrorInvalidValue;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Noise nz{noise, seed_lo, seed_hi, round,
                 static_cast<uint32_t>(imp_col), noise_std, row_offset};
  // the rows [lo, hi) whose aligned 4-byte word of null_imp lies inside it
  const int64_t at = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(null_imp) & 3);
  const int64_t lo = (4 - at) & 3, hi = n - ((at + n) & 3);
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == kCat)
    return launch_tc_gram(cols, P, w_agg, n, partial, nblocks, sigma, s,
                          TcImpute<kCat>{null_imp, lo, hi, w_full, intercept,
                                         P, R, imp_col, out_col, nz});
  return launch_tc_gram(cols, P, w_agg, n, partial, nblocks, sigma, s,
                        TcImpute<kNum>{null_imp, lo, hi, w_full, intercept, P,
                                       R, imp_col, out_col, nz});
}

// K2's CUDA-core route and its cross-block reduction on `stream`, for any
// P ≤ kMaxP. Arguments as dit_fused_impute_aggregate, except partial: f64
// scratch of dit_gram_entries(P) · nblocks. Returns 0 or a cudaError_t.
int dit_fused_impute_aggregate_cores(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const uint8_t* null_imp, const float* w_agg,
    const float* w_full, const float* intercept, int R, int kind,
    int imp_col, void* out_col, int noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t round, int64_t row_offset,
    const float* noise_std, int64_t n,
    int P, double* partial, int nblocks, float* sigma, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, nblocks)) return rc;
  if (int rc = check_impute(kind, imp_col, R, d, c, cat_sizes)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c);
  const Geom gm = make_geom(P, n);
  const Noise nz{noise, seed_lo, seed_hi, round,
                 static_cast<uint32_t>(imp_col), noise_std, row_offset};
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
// columns with out_col in column imp_col's place (none where the plan has
// no task, shape[0] = 0: D alone, on the tensor cores, which the caller
// launches after, dense_gram.cu). Arguments as
// dit_fused_impute_aggregate, except any P ≤ kMaxWideP; the plan (slabs ..
// shape) and partial as dit_wide_gram; imp_plan: 3 ints (ld, M, batch:
// _build.impute_plan) of the 'cat' impute kernel, imp_rows
// its i32[n] scratch (unused for 'num'); sigma zeroed by the caller. far:
// the columns' device table past kInlineCols of a kind (gram_common.cuh:
// Cols), else nullptr; far_out: the same with out_col in column imp_col's
// place, what the Gram reads (far itself where imp_col is a parameter
// column). Returns 0 or a cudaError_t.
int dit_fused_impute_aggregate_wide(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const int64_t* far, const int64_t* far_out,
    const uint8_t* null_imp, const float* w_agg,
    const float* w_full, const float* intercept, int R, int kind,
    int imp_col, void* out_col, int noise, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t round, int64_t row_offset,
    const float* noise_std, int64_t n,
    int P, const int* slabs, const int* warp_begin, const int64_t* task_base,
    const int* stage_cols, const int* entries, const int* shape,
    const int* imp_plan, int* imp_rows, double* partial, float* sigma,
    void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWideP, far))
    return rc;
  if (int rc = check_impute(kind, imp_col, R, d, c, cat_sizes)) return rc;
  if (far != nullptr && far_out == nullptr) return cudaErrorInvalidValue;
  const bool gram = shape[0] > 0;
  WidePlanArgs plan;
  int slices = 0;
  if (gram)
    if (int rc = make_plan(slabs, warp_begin, task_base, stage_cols, entries,
                           shape, plan, slices))
      return rc;
  Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  auto s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (kind == kCat) {
      if (int rc = launch_impute_cat(cols, n, null_imp, w_full, intercept, P,
                                     R, imp_col, imp_plan, imp_rows,
                                     static_cast<int32_t*>(out_col), s))
        return rc;
    } else {
      const Noise nz{noise, seed_lo, seed_hi, round,
                     static_cast<uint32_t>(imp_col), noise_std, row_offset};
      const int64_t want = (n + kThreads - 1) / kThreads;
      const int blocks = static_cast<int>(want < 8192 ? want : 8192);
      impute_num_wide_kernel<<<blocks, kThreads, 0, s>>>(
          cols, n, null_imp, w_full, intercept, imp_col, nz,
          static_cast<float*>(out_col));
      if (cudaError_t rc = cudaGetLastError()) return rc;
    }
  }
  if (!gram) return 0;
  cols.far = far_out;
  if (imp_col < kInlineCols) {
    if (kind == kCat)
      cols.code[imp_col] = static_cast<const int32_t*>(out_col);
    else
      cols.x[imp_col] = static_cast<const float*>(out_col);
  }
  return launch_wide_gram<false>(cols, plan, P, n, nullptr, nullptr, 1,
                                 slices, w_agg, partial, sigma, s);
}

// Launches K2w's impute kernel alone on `stream`, for any P ≤ kMaxWindowP
// (the fused pass past kMaxWideP, whose Gram the caller runs as K7 over
// S's column windows). kind 0 ('cat'): w the padded W f32[P + 2][ldw] (rows
// 0 .. P − 1 W's, row P zeros, row P + 1 the intercept; zeros past R),
// imp_plan (ld, M, batch) with ld = 32·M (_build.impute_global_plan) and
// ldw a multiple of ld, imp_rows i32[n] scratch; kind 1 ('num'): w =
// w_full f32[P], intercept f32[1], noise as dit_fused_impute_aggregate.
// out_col as dit_fused_impute_aggregate; far as
// dit_fused_impute_aggregate_wide. Returns 0 or a cudaError_t.
int dit_impute_wide(
    const void* const* x_cols, int d, const void* const* code_cols,
    const int* cat_sizes, int c, const int64_t* far, const uint8_t* null_imp,
    const float* w,
    const float* intercept, int ldw, int R, int kind, int imp_col,
    void* out_col, int noise, uint32_t seed_lo, uint32_t seed_hi,
    uint32_t round, int64_t row_offset, const float* noise_std, int64_t n,
    int P, const int* imp_plan, int* imp_rows, void* stream) {
  using namespace dit;
  if (int rc = check_cols(d, c, cat_sizes, P, n, 1, kMaxWindowP, far))
    return rc;
  if (int rc = check_impute(kind, imp_col, R, d, c, cat_sizes)) return rc;
  const Cols cols = make_cols(x_cols, d, code_cols, cat_sizes, c, far);
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (kind == kCat)
    return launch_impute_cat(cols, n, null_imp, w, nullptr, P, R, imp_col,
                             imp_plan, imp_rows,
                             static_cast<int32_t*>(out_col), s, true, ldw);
  const Noise nz{noise, seed_lo, seed_hi, round,
                 static_cast<uint32_t>(imp_col), noise_std, row_offset};
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  impute_num_wide_kernel<<<blocks, kThreads, 0, s>>>(
      cols, n, null_imp, w, intercept, imp_col, nz,
      static_cast<float*>(out_col));
  return cudaGetLastError();
}

}  // extern "C"
