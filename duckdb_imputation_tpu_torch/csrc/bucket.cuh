// In-chunk bucketing by group id, for the unsorted grouped Gram
// (grouped_gram.cu).
//
// A block stages kChunk rows, one per thread. Instead of testing every
// staged row against every group (G× the work), each row is written to a
// slot so that the chunk's rows lie ordered by (group, row): group g owns
// slots [bstart[g], bstart[g + 1]). A thread can then run over one group's
// rows with that group's accumulator fixed. The slots come from warp
// ballots and a prefix sum over warps: no atomics, so the layout, and every
// sum over it, is the same on every run.
#pragma once

#include "gram_common.cuh"

namespace dit {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxBucketGroups = 32;  // one lane per group in the scan

// Ints of shared memory bucket_slot needs for G groups.
__host__ __device__ constexpr int bucket_ints(int G) {
  return kWarps * G + G + 1;
}

// Called by every thread of the block with its row's group in [0, G), or
// -1 for a row that joins no group (past n, or an id outside the range).
// Fills bstart[0 .. G] and returns the row's slot, or -1. `ints` holds
// bucket_ints(G) ints of shared memory. G ≤ kMaxBucketGroups.
__device__ __forceinline__ int bucket_slot(int grp, int G, int* ints) {
  int* wcnt = ints;                 // [kWarps][G]: rows of group g per warp
  int* bstart = ints + kWarps * G;  // [G + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int rank = 0;
  for (int g = 0; g < G; ++g) {
    const unsigned m = __ballot_sync(0xffffffffu, grp == g);
    if (grp == g) rank = __popc(m & below);
    if (lane == 0) wcnt[warp * G + g] = __popc(m);
  }
  __syncthreads();
  if (warp == 0) {
    int tot = 0;
    if (lane < G)
      for (int w = 0; w < kWarps; ++w) tot += wcnt[w * G + lane];
    int incl = tot;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane < G) bstart[lane] = incl - tot;
    if (lane == G - 1) bstart[G] = incl;
  }
  __syncthreads();
  if (grp < 0) return -1;
  int slot = bstart[grp] + rank;
  for (int w = 0; w < warp; ++w) slot += wcnt[w * G + grp];
  return slot;
}

}  // namespace
}  // namespace dit
