// Bucketing of a tile of rows by generator, in shared memory: the stable
// counting sort shared by K1-bf16 (decode_select_mma.cu, groups of 16 rows
// for one mma) and the tiled f32 K1 (decode_select_tiled.cu, groups of R
// rows for one warp).
//
// A block of kWarps warps takes a tile of up to kMaxTile consecutive rows.
// Ballots per 32-row chunk count each generator's rows, warp 0 turns the
// counts into offsets (per generator, buckets padded to kGroup rows), and
// every row is written to its slot, in row order inside its bucket.

#pragma once

#include "decoder_rollout.cuh"

namespace mggan {

template <int kWarps, int kMaxTile, int kGroup>
struct TileBuckets {
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kChunks = kMaxTile / 32;
  static_assert(kMaxTile % 32 == 0 && kChunks % kWarps == 0, "whole chunks per warp");

  int* slots;      // [kMaxTile + kGroup G]: bucketed slot -> row in tile, -1 padding
  int* group_gen;  // [kMaxTile / kGroup + G]: generator of every kGroup slots
  int* count;      // [kChunks][G]: rows of each generator in a 32-row chunk
  int* offset;     // [kChunks][G]: where a chunk's rows of a generator go
  int* groups;     // [1]

  __host__ __device__ static int ints(int num_gens) {
    return kMaxTile + kGroup * num_gens + kMaxTile / kGroup + num_gens + 2 * kChunks * num_gens +
           1;
  }

  __device__ static TileBuckets at(int* p, int num_gens) {
    TileBuckets b;
    b.slots = p;
    b.group_gen = b.slots + kMaxTile + kGroup * num_gens;
    b.count = b.group_gen + kMaxTile / kGroup + num_gens;
    b.offset = b.count + kChunks * num_gens;
    b.groups = b.offset + kChunks * num_gens;
    return b;
  }

  // Bucket the tile's rows [base, base + rows) by generator: slots holds,
  // per generator in order and padded to kGroup, the rows' offsets in the
  // tile (stable), -1 in padding; group_gen the generator of every kGroup
  // slots. Rows with no generator (idx out of [0, G)) are poisoned with NaN
  // here. Ends with __syncthreads. G <= 32 (a lane per generator).
  __device__ void bucket(const int32_t* __restrict__ idx, int64_t base, int rows, int num_gens,
                         int pred_len, float* __restrict__ out_abs,
                         float* __restrict__ out_rel) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int chunks = (rows + 31) / 32;
    for (int i = threadIdx.x; i < kMaxTile + kGroup * num_gens; i += kThreads) slots[i] = -1;
    int gen[kChunks / kWarps];
#pragma unroll
    for (int c = 0; c < kChunks / kWarps; ++c) {
      const int chunk = warp + c * kWarps, i = chunk * 32 + lane;
      gen[c] = chunk < chunks && i < rows ? idx[base + i] : -1;
      if (chunk < chunks && i < rows && (gen[c] < 0 || gen[c] >= num_gens)) {
        const float nan = __int_as_float(0x7fc00000);
        for (int q = 0; q < pred_len * 2; ++q) {
          out_abs[(base + i) * pred_len * 2 + q] = nan;
          out_rel[(base + i) * pred_len * 2 + q] = nan;
        }
      }
      if (chunk < chunks)
        for (int g = 0; g < num_gens; ++g) {
          const int n = __popc(__ballot_sync(kFull, gen[c] == g));
          if (lane == g) count[chunk * num_gens + g] = n;
        }
    }
    __syncthreads();
    if (warp == 0) {  // lane g: offsets of generator g's rows, chunk by chunk
      int total = 0;
      if (lane < num_gens)
        for (int c = 0; c < chunks; ++c) total += count[c * num_gens + lane];
      const int padded = (total + kGroup - 1) / kGroup * kGroup;
      int start = padded;  // exclusive prefix over generators
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, start, d);
        if (lane >= d) start += v;
      }
      start -= padded;
      if (lane < num_gens) {
        int at = start;
        for (int c = 0; c < chunks; ++c) {
          offset[c * num_gens + lane] = at;
          at += count[c * num_gens + lane];
        }
        for (int q = start / kGroup; q < (start + padded) / kGroup; ++q) group_gen[q] = lane;
      }
      if (lane == 31) *groups = (start + padded) / kGroup;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunks / kWarps; ++c) {
      const int chunk = warp + c * kWarps;
      if (chunk >= chunks) continue;
      const bool live = gen[c] >= 0 && gen[c] < num_gens;
      const unsigned same = __match_any_sync(kFull, live ? gen[c] : -1);
      if (live)
        slots[offset[chunk * num_gens + gen[c]] + __popc(same & below)] = chunk * 32 + lane;
    }
    __syncthreads();
  }
};

}  // namespace mggan
