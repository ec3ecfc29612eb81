// K3 and K3w: one-pass batched QDA scoring over each row's nonzero pairs,
// for sm_90a. With z̃ = [1 ‖ x ‖ onehot(codes)] (P = 1 + d + V) each class
// c scores as one quadratic form in the layout of sigma,
//
//   s_c = z̃ᵀ·A_c·z̃,  A_c = [[b_c, lin_cᵀ/2], [lin_c/2, quad_c]],
//   pred = first argmax_c s_c
//
// Replaces the Pallas kernel of duckdb_imputation_tpu/ring/kernels/
// qda_pallas.py, _qda_predict_pallas (_qda_kernel), which scores through a
// Cholesky factor of −quad as a bf16 hi/lo split operand on the TPU's
// matrix unit. Here no factor exists: a row's z̃ has k = 1 + d + (its
// in-range codes) nonzeros, so s_c is a sum over the row's k(k + 1)/2
// pairs of nonzeros, which are cells of the plan K7 aggregates into
// (ring/kernels/_build.py: WidePlan, qda_plan; wide_gram.cuh): the dense
// block D of [1 ‖ x], the keyed tables K_j (cell (v, a) for code v of
// column j and a ∈ [1 ‖ x], laid out a-major; its a = 0 cell is also v's
// one-hot diagonal, z_v² = z_v) and the cross tables C_jk. The host packs
// A_c into those cells as f32 tables[C][cells] (ring/kernels/
// qda_pallas.py: qda_tables, nb_tables; naive Bayes's plan has no C_jk),
// task after task.
//
// A term is the f32 cell times the row's values (z_a·z_b for D, z_a for
// K, 1 for C), in f64, added in f64 with __dmul_rn/__dadd_rn in the plan's
// order: task, slab, then the slab's cells (D: b ascending; K: a
// ascending); s_c is rounded to f32 once, and classes stream with a strict
// `>`: a tie goes to the lowest class, and a NaN score never wins. The
// plain version (qda_pallas.py: qda_predict_plain) does the same
// operations in the same order, so the two give bit-identical scores.
//
// Layout of the work: a block owns a tile of threads·rows rows, staged
// once in shared memory (x in f64, less an optional per-column shift, and
// each code i16, −1 outside [0, size); i32 where a column has more than
// kQdaShortLevels levels, a US ZIP5 column's 33,791). Naive Bayes's tables are built
// around a centre m (`nb_tables(center=m)`) and score x − m: expanded
// around 0, a class of variance ~1e-9 at a mean of ~1e3 puts ~1e12 in its
// linear cell, which f32 holds only to ~6e4. The block walks the steps
// (group of classes, task) in order; each step's f32 tables (a task's
// cells, at most 4,096 in the scorer's plan) are copied from device
// memory (L2: the tables of all classes are a few MB) into one of two
// shared buffers with cp.async while the block walks the previous
// step's. A thread finds each of its rows' cells once a step and adds it
// into that row's f64 sum for each class of the group, in registers; at a
// group's last task it rounds them and updates its running (best value,
// best class) pairs, also in registers. The argmax is written once: no
// partial scores in device memory, no atomics, so reruns are
// bit-identical. One task (BASELINE config 4: 160 cells) is K3; several
// (favorita_classify: 46,584 cells a class at label family, 12 tasks) K3w.
// Past P = 1,024 (favorita_items: item_nbr's 4,100 levels) the plan keys a
// cross table C_jk whose rows would pass a task on the column of more
// levels (a slab (C, k, j, ...): cell (v − v_lo)·V_j + u), so a slab's row
// holds the narrower column's levels; where even those pass a task
// (Criteo's C7 and C15), it cuts the table by row code too (CB slabs of
// rows [v_lo, v_hi)), and a row reads a CB cell only where its code lies
// in the slab's rows. The kernel reads either key order alike, and takes
// any P of K7's window plans.
//
// What bounds it on an H100: the bytes floor is one read of x and codes
// and one write of the argmax (48 bytes a row at favorita_classify, 0.14
// ms per 10M rows); the work is C multiply-adds for each of a row's cells
// (70 at favorita_classify, 26 at config 4), so 2.3e10 at family over 10M
// rows, 0.69 ms at the f32 rate, whatever computes the function. The
// kernel is bound by shared memory: the K and C lookups at the rows' codes
// and the tables' copies for every tile take most of its time
// (tools/qda_variants.py: its skip_* and no_stage variants). A K or C cell
// sits at the row's code, so a warp's 32 lookups meet in banks; K_j
// a-major spreads them (v-major, its stride 1 + d folded them onto fewer
// banks). The tables are copied again for every tile, so a plan of
// several tasks takes the largest tile shared memory holds beside two
// classes' tables of 4,096 cells; classes a step amortise a row's code
// and x reads. F2F conversions (16 a clock an SM) cost little.
//
// Local plans (_build.py: qda_local, d > 756 with no categorical column:
// Epsilon's 2,000 columns, MNIST's 784): a tile of 32 rows of every numeric
// column in f64 no longer fits beside the tables, so the plan cuts D into
// tiles of 64 × 64 cells (slabs aligned to 32 columns) and K_j into KB
// slabs of 64 columns, each task reading at most 128 numeric columns
// (stage_cols), and the kernel (Local) stages a task's columns of the tile
// at each step, before the step's barrier, in f64 less the shift as
// before; a D or KB slab reads x at the stage slots of its record. The
// terms, their order and the codes are as above, so the scores are still
// bit-identical to the plain version's.
#include "wide_gram.cuh"

namespace dit {
namespace {

constexpr int kQdaThreads = 1024; // most threads of a block
// most P: a class's whole quadratic form in one plan of S (no windows), P²
// cells a class counted in int places; the trainers' f64[C, P, P] forms
// are out of reach past it in either package (_build.py:
// MAX_SCORER_SIGMA_SIZE)
constexpr int kMaxScorerP = 46340;
// most levels of a categorical column whose codes are staged as i16; past
// them every code is staged as i32
constexpr int kQdaShortLevels = 32768;
constexpr int kQdaMaxGroup = 4;   // most classes a step stages
constexpr int kQdaMaxSums = 8;    // most f64 sums a thread keeps: rows · group
// the zero cells after a table of a local plan: a missed KB cell reads one
// of its at most 64 (_build.py: QDA_LOCAL_TILE) columns' zeros
constexpr int kQdaLocalZeros = 128;

// Floats of one staged table's buffer, whole 16-byte words: the largest
// task's cells (a multiple of 4 in the scorer's plan), then 1 + d zero
// cells that a row's missed K and C cells read (kQdaLocalZeros in a local
// plan). Mirrored by ring/kernels/_build.py: qda_smem_bytes.
__host__ __device__ inline int qda_zeros(int d, bool local) {
  return local ? kQdaLocalZeros : (1 + d + 3) & ~3;
}
__host__ __device__ inline int qda_table_stride(int max_cells, int d,
                                                bool local) {
  return max_cells + qda_zeros(d, local);
}

// One 16-byte word from device memory (L2) into shared memory, past L1
// (through L1, `.ca`, was slower on an H100: tools/qda_variants.py).
__device__ __forceinline__ void stage16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// max_x: a local plan's most numeric columns a task (the tile's x), or 0
template <typename Code>
inline size_t qda_smem_bytes(int max_cells, int d, int c, int tile,
                             int group, int max_x) {
  return sizeof(float) * 2 * size_t(group) *
             qda_table_stride(max_cells, d, max_x > 0) +
         size_t(tile) * (sizeof(double) * (max_x > 0 ? max_x : d) +
                         sizeof(Code) * c);
}

struct QdaArgs {
  const float* tables;        // [C][cells]: class c's cells, task after task
  // [S][kWideSlabInts]: kind, p0..p3, off, and a C or CB slab's rows
  // v_lo, v_hi (a C slab's 0, V_k) in place of the task and the warp
  // (qda_pallas.py: _device_plan)
  const int* slabs;
  const int* warp_begin;      // [tasks · kWideWarps + 1]: task t's slabs begin
                              // at warp_begin[t · kWideWarps]
  const int64_t* task_base;   // [tasks + 1]: each task's first cell
  int C, tasks, max_cells;
  int64_t cells, n;
  int diag;                   // naive Bayes's form: of D only row 0 and the
                              // diagonal, of K only row 0 (the rest is zero)
  const float* shift;         // f32[d] subtracted from x as it is staged, or
                              // nullptr (naive Bayes's centred tables)
  // a local plan's stage lists [tasks][width] (nx, nc, the numeric then
  // the code columns each task reads) and its most numeric columns a task;
  // nullptr, 0 for a plan whose tile stages every column
  const int* stage_cols;
  int width, max_x;
};

// ROWS rows a thread, tile = blockDim · ROWS rows a block; a step stages
// the tables of GROUP classes for one task, in 16-byte words (the tables
// and each task's cells start on 16-byte boundaries). A row finds its
// cells once a step and adds them into each class's sum. A cell the row
// misses (a code outside the slab) reads one of the zero cells after the
// table, as the plain version does, so the rows' chains carry no branch
// and interleave.
// Far: the columns past the parameter's kInlineCols of a kind are read
// from the columns' device table (Cols' accessors); else straight from
// the parameter, as a schema of at most kInlineCols columns a kind is.
// Code: the staged codes' type, int16_t, or int32_t past kQdaShortLevels.
// RowCut: the plan has CB slabs, so a C or CB slab reads its rows' range;
// without, a C slab is read as before rows were cut.
// Local: a local plan (its D and KB records carry their stage slots, x of
// a task's columns staged a step); else x of every column staged once a
// tile.
template <int ROWS, int GROUP, bool Far, typename Code, bool RowCut,
          bool Local>
__global__ void __launch_bounds__(kQdaThreads)
qda_kernel(const __grid_constant__ Cols cols, const __grid_constant__ QdaArgs qa,
           int32_t* __restrict__ out) {
  static_assert(ROWS * GROUP <= kQdaMaxSums && GROUP <= kQdaMaxGroup,
                "f64 sums a thread keeps");
  extern __shared__ __align__(16) double qda_smem[];
  const int tid = threadIdx.x, nt = blockDim.x, tile = nt * ROWS;
  const int d = cols.d, c = cols.c;
  const int nz = qda_zeros(d, Local);
  const int stride = qda_table_stride(qa.max_cells, d, Local);
  const int zero = qa.max_cells;            // the zero cells, after a table
  double* xs = qda_smem;                              // [d or max_x][tile]
  float* tab = reinterpret_cast<float*>(xs + (Local ? qa.max_x : d) * tile);
                                                      // [2][GROUP][stride]
  Code* cs = reinterpret_cast<Code*>(tab + 2 * GROUP * stride);  // [c][tile]
  const int groups = (qa.C + GROUP - 1) / GROUP;
  const int steps = groups * qa.tasks;

  for (int e = tid; e < 2 * GROUP * nz; e += nt)
    tab[(e / nz) * stride + zero + e % nz] = 0.0f;

  // step s = (classes GROUP·(s / tasks) + i, task s % tasks): their tables
  // into buffer s & 1
  auto stage_table = [&](int s) {
    const int t = s % qa.tasks, c0 = (s / qa.tasks) * GROUP;
    const int64_t b0 = qa.task_base[t];
    const int nc = static_cast<int>(qa.task_base[t + 1] - b0);
    for (int i = 0; i < GROUP && c0 + i < qa.C; ++i) {
      const float* src = qa.tables + int64_t(c0 + i) * qa.cells + b0;
      float* dst = tab + ((s & 1) * GROUP + i) * stride;
      for (int e = 4 * tid; e < nc; e += 4 * nt) stage16(dst + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int64_t row0 = int64_t(blockIdx.x) * tile; row0 < qa.n;
       row0 += int64_t(gridDim.x) * tile) {
    stage_table(0);
    // a row's x (f64, less the shift) and codes (Code, −1 outside [0,
    // size)); every column in the parameter, or through the accessors
    auto stage_row = [&](int e, auto x_of, auto code_of, auto size_of) {
      const int64_t row = row0 + e;
      const bool valid = row < qa.n;
      for (int j = 0; j < (Local ? 0 : d); ++j) {
        const double sj = qa.shift ? static_cast<double>(qa.shift[j]) : 0.0;
        xs[j * tile + e] =
            valid ? __dsub_rn(static_cast<double>(x_of(j)[row]), sj) : 0.0;
      }
      for (int j = 0; j < c; ++j) {
        const int v = valid ? code_of(j)[row] : -1;
        cs[j * tile + e] =
            static_cast<Code>(v >= 0 && v < size_of(j) ? v : -1);
      }
    };
    for (int e = tid; e < tile; e += nt) {
      if constexpr (Far)
        stage_row(e, [&](int j) { return cols.xp(j); },
                  [&](int j) { return cols.cp(j); },
                  [&](int j) { return cols.sz(j); });
      else
        stage_row(e, [&](int j) { return cols.x[j]; },
                  [&](int j) { return cols.code[j]; },
                  [&](int j) { return cols.size[j]; });
    }
    double acc[GROUP][ROWS];
    float best_v[ROWS];
    int best[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) acc[i][k] = 0.0;
      best_v[k] = -INFINITY;
      best[k] = 0;
    }

    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) stage_table(s + 1);
      else asm volatile("cp.async.commit_group;\n" ::);
      const int t = s % qa.tasks;
      if constexpr (Local) {   // the task's numeric columns of the tile
        const int* tc = qa.stage_cols + int64_t(t) * qa.width;
        for (int e = tid; e < tc[0] * tile; e += nt) {
          const int q = e / tile, r = e - q * tile, j = tc[2 + q];
          const int64_t row = row0 + r;
          const double sj = qa.shift ? static_cast<double>(qa.shift[j]) : 0.0;
          xs[e] = row < qa.n
                      ? __dsub_rn(static_cast<double>(cols.xp(j)[row]), sj)
                      : 0.0;
        }
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      const float* tb = tab + (s & 1) * GROUP * stride;
      const int s1 = qa.warp_begin[(t + 1) * kWideWarps];
      for (int si = qa.warp_begin[t * kWideWarps]; si < s1; ++si) {
        const int* sl = qa.slabs + si * kWideSlabInts;
        const int kind = __ldg(sl), p0 = __ldg(sl + 1), p1 = __ldg(sl + 2);
        const int p2 = __ldg(sl + 3), p3 = __ldg(sl + 4), off = __ldg(sl + 5);
        if (kind == kSlabD) {          // cells (p0, b), b in [p1, p2)
          // x_a at slot sa, x_b at slot sb + b (slot q at xs row q − 1)
          const int sa = Local ? __ldg(sl + 6) : p0;
          const int sb = Local ? __ldg(sl + 7) : 0;
          const double* xa = xs + (p0 ? sa - 1 : 0) * tile + tid;
          double za[ROWS];
#pragma unroll
          for (int k = 0; k < ROWS; ++k) za[k] = p0 ? xa[k * nt] : 1.0;
          for (int b = p1; b < p2; ++b) {
            if (qa.diag && p0 && b != p0) continue;
            const double* xb = xs + (b ? sb + b - 1 : 0) * tile + tid;
            double tv[GROUP];
#pragma unroll
            for (int i = 0; i < GROUP; ++i) tv[i] = tb[i * stride + off + b - p1];
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
              const double zb = b ? xb[k * nt] : 1.0;
              const double z = p0 ? __dmul_rn(za[k], zb) : zb;
#pragma unroll
              for (int i = 0; i < GROUP; ++i)
                acc[i][k] = __dadd_rn(acc[i][k], __dmul_rn(tv[i], z));
            }
          }
        } else if (kind == kSlabK) {   // column p0, keys [p1, p2): cell
          const Code* cj = cs + p0 * tile + tid;  // (v, a) at a·keys + v − p1
          int base[ROWS], step[ROWS];
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            const int v = cj[k * nt];
            const bool hit = v >= p1 && v < p2;
            base[k] = hit ? off + v - p1 : zero;
            step[k] = hit ? p2 - p1 : 1;
#pragma unroll
            for (int i = 0; i < GROUP; ++i)
              acc[i][k] = __dadd_rn(acc[i][k],
                                    static_cast<double>(tb[i * stride + base[k]]));
          }
          for (int a = 1; a <= (qa.diag ? 0 : d); ++a) {
            const double* xr = xs + (a - 1) * tile + tid;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
              const double x = xr[k * nt];
#pragma unroll
              for (int i = 0; i < GROUP; ++i)
                acc[i][k] = __dadd_rn(
                    acc[i][k], __dmul_rn(tb[i * stride + base[k] + a * step[k]], x));
            }
          }
        } else if (Local && kind == kSlabKB) {  // column p0, keys [p1, p2),
          // columns [p3, a_hi) of [1 ‖ x]: cell (v, a) at (a − p3)·keys +
          // v − p1, x_a at slot sx + a
          const int a_hi = __ldg(sl + 6), sx = __ldg(sl + 7);
          const Code* cj = cs + p0 * tile + tid;
          int base[ROWS], step[ROWS];
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            const int v = cj[k * nt];
            const bool hit = v >= p1 && v < p2;
            base[k] = hit ? off + v - p1 : zero;
            step[k] = hit ? p2 - p1 : 1;
          }
          for (int a = p3; a < (qa.diag && p3 == 0 ? 1 : a_hi); ++a) {
            if (a == 0) {
#pragma unroll
              for (int k = 0; k < ROWS; ++k)
#pragma unroll
                for (int i = 0; i < GROUP; ++i)
                  acc[i][k] = __dadd_rn(
                      acc[i][k], static_cast<double>(tb[i * stride + base[k]]));
              continue;
            }
            if (qa.diag) break;
            const double* xr = xs + (sx + a - 1) * tile + tid;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
              const double x = xr[k * nt];
#pragma unroll
              for (int i = 0; i < GROUP; ++i)
                acc[i][k] = __dadd_rn(
                    acc[i][k],
                    __dmul_rn(tb[i * stride + base[k] + (a - p3) * step[k]],
                              x));
            }
          }
        } else {                       // C, CB: key column p0, row column
                                       // p1, keys [p2, p3), rows [v_lo,
                                       // v_hi) (a C slab's 0, V_k: in the
                                       // record, or V_k in the parameter)
          const int vlo = RowCut ? __ldg(sl + 6) : 0;
          const int nv = RowCut ? __ldg(sl + 7) - vlo
                                : Far ? __ldg(sl + 7) : cols.size[p1];
          const Code* cu = cs + p0 * tile + tid;
          const Code* cv = cs + p1 * tile + tid;
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            // a staged code is −1 outside [0, V_k): a C slab's rows hold
            const int u = cu[k * nt], v = cv[k * nt] - vlo;
            const int cell =
                u >= p2 && u < p3 && v >= 0 && (!RowCut || v < nv)
                    ? off + (u - p2) * nv + v
                    : zero;
#pragma unroll
            for (int i = 0; i < GROUP; ++i)
              acc[i][k] = __dadd_rn(acc[i][k],
                                    static_cast<double>(tb[i * stride + cell]));
          }
        }
      }
      if (t == qa.tasks - 1) {        // the group's scores are complete
        const int c0 = (s / qa.tasks) * GROUP;
#pragma unroll
        for (int i = 0; i < GROUP; ++i)
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            const float sc = __double2float_rn(acc[i][k]);
            if (c0 + i < qa.C && sc > best_v[k]) {
              best_v[k] = sc;
              best[k] = c0 + i;
            }
            acc[i][k] = 0.0;
          }
      }
      __syncthreads();   // the buffer is restaged two steps on
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int64_t row = row0 + tid + k * nt;
      if (row < qa.n) out[row] = best[k];
    }
  }
}

template <int ROWS, int GROUP, bool Far, typename Code, bool RowCut,
          bool Local>
int launch_qda(const Cols& cols, const QdaArgs& qa, int threads,
               int32_t* out, cudaStream_t stream) {
  const int tile = threads * ROWS;
  const size_t smem = qda_smem_bytes<Code>(qa.max_cells, cols.d, cols.c,
                                           tile, GROUP, Local ? qa.max_x : 0);
  if (smem > kWideSmem) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      qda_kernel<ROWS, GROUP, Far, Code, RowCut, Local>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const int64_t blocks = qa.n > 0 ? (qa.n + tile - 1) / tile : 1;
  qda_kernel<ROWS, GROUP, Far, Code, RowCut, Local>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(cols, qa,
                                                                  out);
  return cudaGetLastError();
}

using QdaLaunch = int (*)(const Cols&, const QdaArgs&, int, int32_t*,
                          cudaStream_t);

// The instance for rows a thread and classes a step, the shapes
// ring/kernels/_build.py: qda_tile picks: kQdaMaxSums / group rows for
// 2 or 4 classes a step, else 8, 4, 2 or 1 rows for one (nullptr for any
// other shape).
template <bool Far, typename Code, bool RowCut>
inline QdaLaunch pick_qda_of(int rows, int group) {
  switch (rows * 8 + group) {
    case 8 * 8 + 1: return launch_qda<8, 1, Far, Code, RowCut, false>;
    case 4 * 8 + 1: return launch_qda<4, 1, Far, Code, RowCut, false>;
    case 2 * 8 + 1: return launch_qda<2, 1, Far, Code, RowCut, false>;
    case 1 * 8 + 1: return launch_qda<1, 1, Far, Code, RowCut, false>;
    case 4 * 8 + 2: return launch_qda<4, 2, Far, Code, RowCut, false>;
    case 2 * 8 + 4: return launch_qda<2, 4, Far, Code, RowCut, false>;
    default: return nullptr;
  }
}

// A local plan (d > 756 numeric columns) always reads the columns' device
// table (far), d being past kInlineCols, and takes one row a thread and one
// class a step (_build.py: qda_tile).
template <bool Far, typename Code>
inline QdaLaunch pick_qda_cut(int rows, int group, bool row_cut, bool local) {
  if (local) {
    if (!Far || rows != 1 || group != 1) return nullptr;
    if (row_cut) return launch_qda<1, 1, true, Code, true, true>;
    return launch_qda<1, 1, true, Code, false, true>;
  }
  return row_cut ? pick_qda_of<Far, Code, true>(rows, group)
                 : pick_qda_of<Far, Code, false>(rows, group);
}

inline QdaLaunch pick_qda(int rows, int group, bool far, bool wide_codes,
                          bool row_cut, bool local) {
  if (wide_codes)
    return far ? pick_qda_cut<true, int32_t>(rows, group, row_cut, local)
               : pick_qda_cut<false, int32_t>(rows, group, row_cut, local);
  return far ? pick_qda_cut<true, int16_t>(rows, group, row_cut, local)
             : pick_qda_cut<false, int16_t>(rows, group, row_cut, local);
}

}  // namespace
}  // namespace dit

extern "C" {

// Launches K3/K3w on `stream`: tables f32[C][cells], 16-byte aligned, in
// the cells of the scorer's plan (slabs, warp_begin, task_base of
// ring/kernels/_build.py: qda_plan, `tasks` tasks of at most max_cells
// cells, each task's first cell and `cells` multiples of 4); blocks of
// `threads` threads,
// each thread scoring `rows` rows against `group` classes a step ((8, 1),
// (4, 1), (2, 1), (1, 1), (4, 2) or (2, 4); a local plan (1, 1)); diag:
// naive Bayes's tables
// (`nb_tables`), whose other D and K cells are zero and skipped;
// row_cut: whether the plan has CB slabs (the instance that reads a C or
// CB slab's row range; 0 keeps a C slab's read of before); shift:
// f32[d] on the device, taken from each x as it is staged (x − shift in
// f64: the tables of `nb_tables(center=shift)`), or nullptr; far: the
// columns' device table (gram_common.cuh: Cols), needed past kInlineCols
// columns of a kind, else nullptr; out i32[n]. A tile of `threads · rows`
// rows of x in f64 must fit shared memory beside the tables: of every
// numeric column, or with max_x > 0 (a local plan, _build.py: qda_local)
// of at most max_x columns, those of stage_cols [tasks][width] (the plan's
// stage lists) for each task, whose D and KB records carry their stage
// slots in place of the task and the warp. Returns 0 or a cudaError_t.
int dit_qda_predict(const void* const* x_cols, int d,
                    const void* const* code_cols, const int* cat_sizes,
                    int c, const int64_t* far, const float* tables,
                    const int* slabs,
                    const int* warp_begin, const int64_t* task_base, int C,
                    int tasks, int max_cells, int64_t cells, int64_t n,
                    int threads, int rows, int group, int diag,
                    int row_cut, const float* shift, const int* stage_cols,
                    int width, int max_x, int32_t* out, void* stream) {
  using namespace dit;
  if (d < 0 || c < 0) return cudaErrorInvalidValue;
  int64_t P = 1 + d;
  for (int j = 0; j < c; ++j) P += cat_sizes[j];
  if (P > kMaxScorerP) return cudaErrorInvalidValue;
  // codes staged as i16, or as i32 past kQdaShortLevels levels a column
  if (int rc = check_cols(d, c, cat_sizes, static_cast<int>(P), n, 1,
                          kMaxScorerP, far))
    return rc;
  bool wide_codes = false;
  for (int j = 0; j < c; ++j) wide_codes |= cat_sizes[j] > kQdaShortLevels;
  const QdaLaunch launch = pick_qda(rows, group, far != nullptr, wide_codes,
                                    row_cut != 0, max_x > 0);
  if (C < 1 || tasks < 1 || max_cells < 1 || max_cells % 4 || cells % 4 ||
      reinterpret_cast<uintptr_t>(tables) % 16 || cells < max_cells ||
      threads < 32 || threads > kQdaThreads || threads % 32 || !launch ||
      max_x < 0 || max_x > d ||
      (max_x > 0 && (stage_cols == nullptr || width < 2)))
    return cudaErrorInvalidValue;
  const QdaArgs qa{tables, slabs, warp_begin, task_base, C, tasks,
                   max_cells, cells, n, diag != 0, shift, stage_cols,
                   width, max_x};
  return launch(make_cols(x_cols, d, code_cols, cat_sizes, c, far), qa,
                threads, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
