// The tiled fused-selection rollout: K1 in f32 (decode_select_tiled.cu) and,
// on the activation policies of the ablation B1, decode_ablation.cu; and
// K5 (decode_select_tiled.cu), the same with two groups a warp.
//
// A persistent block takes tiles of consecutive rows and buckets each
// tile's rows by generator in shared memory (tile_buckets.cuh: ballots per
// 32-row chunk, then offsets; stable), every bucket padded to R rows (2R
// for K5). Each warp then rolls out R rows of one generator at a time
// (rollout_tile.cuh::rollout_tile; K5 two groups of R rows of one
// generator, rollout_tiles<2>). All G generators' f32 weight blocks
// stay in shared memory in kernel_weights' [k][j][gate] image. Padded rows
// compute on zeros and store nothing; a row with no generator (idx out of
// range) is poisoned with NaN. Row inputs: h0 and idx have N rows, xy0,
// dxdy0 and socb M rows with N % M == 0, and row n reads row n % M.

#pragma once

#include "rollout_tile.cuh"
#include "tile_buckets.cuh"

namespace mggan {

constexpr int kTiledWarps = 8;
constexpr int kTiledThreads = kTiledWarps * 32;
constexpr int kTiledMaxTile = 1024;  // rows of a tile, at most

template <int R>
using TiledBuckets = TileBuckets<kTiledWarps, kTiledMaxTile, R>;

__host__ __device__ inline size_t tiled_smem_floats(int rows_per_warp, int num_gens,
                                                    int per_gen, int h, int t) {
  return (size_t)num_gens * per_gen +
         (size_t)kTiledWarps * tile_stage_floats(rows_per_warp, h, t);
}

template <int R>
__host__ __device__ inline size_t tiled_smem_bytes(int num_gens, int per_gen, int h, int t) {
  return (tiled_smem_floats(R, num_gens, per_gen, h, t) + TiledBuckets<R>::ints(num_gens)) *
         sizeof(float);
}

// A persistent grid; block b takes tiles b, b + gridDim.x, ... of
// tile_rows rows (at most kTiledMaxTile).
template <int R, int kH, int kHid, typename Act>
__global__ void __launch_bounds__(kTiledThreads, 2)
decode_select_tiled_kernel(const float* __restrict__ wpack,  // (G, per_gen)
                           const float* __restrict__ h0,     // (N, H)
                           const float* __restrict__ socb,   // (M, G, hid)
                           const float* __restrict__ xy0,    // (M, 2)
                           const float* __restrict__ dxdy0,  // (M, 2)
                           const int32_t* __restrict__ idx,  // (N,)
                           float* __restrict__ out_abs,      // (N, T, 2)
                           float* __restrict__ out_rel,      // (N, T, 2)
                           int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                           int hid_dim, int in_dim, int pred_len, int fmt, int per_gen,
                           int tile_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage_weights(smem4, wpack, num_gens * per_gen);
  const int H = kH > 0 ? kH : h_dim, hid = kHid > 0 ? kHid : hid_dim;
  const Layout L(H, hid, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = smem + (size_t)num_gens * per_gen + warp * tile_stage_floats(R, H, pred_len);
  const TiledBuckets<R> s = TiledBuckets<R>::at(
      reinterpret_cast<int*>(smem + tiled_smem_floats(R, num_gens, per_gen, H, pred_len)),
      num_gens);
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * tile_rows;
    const int rows = (int)(n_rows - base < tile_rows ? n_rows - base : tile_rows);
    s.bucket(idx, base, rows, num_gens, pred_len, out_abs, out_rel);
    for (int grp = warp; grp < *s.groups; grp += kTiledWarps) {
      const int gen = s.group_gen[grp];
      float h[R], x[R], y[R], dx[R], dy[R], sb[R];
      int64_t out_row[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int slot = s.slots[grp * R + r];
        const bool live = slot >= 0;
        const int64_t row = base + (live ? slot : 0);
        const int64_t m = row % m_rows;
        out_row[r] = live ? row : -1;
        h[r] = live && lane < H ? h0[row * H + lane] : 0.f;
        x[r] = live ? xy0[m * 2] : 0.f;
        y[r] = live ? xy0[m * 2 + 1] : 0.f;
        dx[r] = live ? dxdy0[m * 2] : 0.f;
        dy[r] = live ? dxdy0[m * 2 + 1] : 0.f;
        sb[r] = live && lane < hid ? socb[(m * num_gens + gen) * hid + lane] : 0.f;
      }
      rollout_tile<R, kH, kHid, Act>(smem + (size_t)gen * per_gen, L, lane, stage, h, x, y,
                                     dx, dy, sb, out_row, out_abs, out_rel, nullptr);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

template <typename Act>
using TiledKernel = decltype(&decode_select_tiled_kernel<1, 0, 0, Act>);

template <int R, typename Act, bool kGeneric>
inline TiledKernel<Act> tiled_instance(bool flagship) {
  if (flagship) return decode_select_tiled_kernel<R, 32, 16, Act>;
  if constexpr (kGeneric) return decode_select_tiled_kernel<R, 0, 0, Act>;
  return nullptr;
}

// The instantiation for R rows a warp (1, 2 or 4) at these widths: the
// flagship's H = 32, hid = 16 fixed at compile time, other widths the
// generic one (with kGeneric; null without); null for another R.
template <typename Act, bool kGeneric = true>
inline TiledKernel<Act> tiled_kernel(int rows_per_warp, int h, int hid) {
  const bool flagship = h == 32 && hid == 16;
  switch (rows_per_warp) {
    case 1: return tiled_instance<1, Act, kGeneric>(flagship);
    case 2: return tiled_instance<2, Act, kGeneric>(flagship);
    case 4: return tiled_instance<4, Act, kGeneric>(flagship);
    default: return nullptr;
  }
}

inline size_t tiled_smem(int rows_per_warp, int num_gens, int per_gen, int h, int t) {
  switch (rows_per_warp) {
    case 1: return tiled_smem_bytes<1>(num_gens, per_gen, h, t);
    case 2: return tiled_smem_bytes<2>(num_gens, per_gen, h, t);
    default: return tiled_smem_bytes<4>(num_gens, per_gen, h, t);
  }
}

// The tiled K1 with activations Act on `stream` (see the extern "C" entries
// of decode_select_tiled.cu and decode_ablation.cu): `blocks` persistent
// blocks over tiles of tile_rows rows (1..1024), rows_per_warp (1, 2 or 4)
// rows of one generator a warp; without kGeneric the flagship widths only.
// Returns cudaGetLastError() after the launch.
template <typename Act, bool kGeneric = true>
inline int launch_select_tiled(const void* wpack, const void* h0, const void* socb,
                               const void* xy0, const void* dxdy0, const void* idx,
                               void* out_abs, void* out_rel, long long n_rows, long long m_rows,
                               int num_gens, int h_dim, int hid_dim, int in_dim, int pred_len,
                               int fmt, int per_gen, int rows_per_warp, int tile_rows,
                               int blocks, void* stream) {
  const TiledKernel<Act> kernel = tiled_kernel<Act, kGeneric>(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr || num_gens > 32 || tile_rows < 1 || tile_rows > kTiledMaxTile ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem(rows_per_warp, num_gens, per_gen, h_dim, pred_len);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kTiledThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
      per_gen, tile_rows);
  return (int)cudaGetLastError();
}

// Resident warps per SM of the tiled K1 with activations Act for R =
// rows_per_warp at these widths; returns a CUDA error code.
template <typename Act, bool kGeneric = true>
inline int select_tiled_warps_per_sm(int rows_per_warp, int num_gens, int per_gen, int h_dim,
                                     int hid_dim, int pred_len, int* warps) {
  const TiledKernel<Act> kernel = tiled_kernel<Act, kGeneric>(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kTiledThreads,
                             tiled_smem(rows_per_warp, num_gens, per_gen, h_dim, pred_len),
                             warps);
}

// K5: the tiled K1 with a warp per pair of groups of R rows of one
// generator (rollout_tiles<2>). The tile's buckets are padded to 2R rows,
// so a bucket is whole pairs, and a lone group runs paired with a group of
// padding rows. Two blocks an SM, as K1 (at R = 4 with 72 bytes spilled a
// thread; one block an SM without spills was 1.3x slower, PERF.md).
template <int R>
using PairBuckets = TileBuckets<kTiledWarps, kTiledMaxTile, 2 * R>;

// Floats of the weights and the warps' staging of K5 (two groups a warp);
// the buckets follow.
__host__ __device__ inline size_t ilp_smem_floats(int rows_per_warp, int num_gens, int per_gen,
                                                  int h, int t) {
  return (size_t)num_gens * per_gen +
         (size_t)kTiledWarps * 2 * tile_stage_floats(rows_per_warp, h, t);
}

template <int R>
__host__ __device__ inline size_t ilp_smem_bytes(int num_gens, int per_gen, int h, int t) {
  return (ilp_smem_floats(R, num_gens, per_gen, h, t) + PairBuckets<R>::ints(num_gens)) *
         sizeof(float);
}

template <int R, int kH, int kHid>
__global__ void __launch_bounds__(kTiledThreads, 2)
decode_select_ilp_tiled_kernel(const float* __restrict__ wpack,  // (G, per_gen)
                               const float* __restrict__ h0,     // (N, H)
                               const float* __restrict__ socb,   // (M, G, hid)
                               const float* __restrict__ xy0,    // (M, 2)
                               const float* __restrict__ dxdy0,  // (M, 2)
                               const int32_t* __restrict__ idx,  // (N,)
                               float* __restrict__ out_abs,      // (N, T, 2)
                               float* __restrict__ out_rel,      // (N, T, 2)
                               int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                               int hid_dim, int in_dim, int pred_len, int fmt, int per_gen,
                               int tile_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage_weights(smem4, wpack, num_gens * per_gen);
  const int H = kH > 0 ? kH : h_dim, hid = kHid > 0 ? kHid : hid_dim;
  const Layout L(H, hid, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage =
      smem + (size_t)num_gens * per_gen + warp * 2 * tile_stage_floats(R, H, pred_len);
  const PairBuckets<R> s = PairBuckets<R>::at(
      reinterpret_cast<int*>(smem + ilp_smem_floats(R, num_gens, per_gen, H, pred_len)),
      num_gens);
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * tile_rows;
    const int rows = (int)(n_rows - base < tile_rows ? n_rows - base : tile_rows);
    s.bucket(idx, base, rows, num_gens, pred_len, out_abs, out_rel);
    for (int pair = warp; pair < *s.groups; pair += kTiledWarps) {
      const int gen = s.group_gen[pair];
      float h[2][R], x[2][R], y[2][R], dx[2][R], dy[2][R], sb[2][R];
      int64_t out_row[2][R];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int r = 0; r < R; ++r) {  // slot 2R pair + R p + r of the bucketed tile
          const int slot = s.slots[(2 * pair + p) * R + r];
          const bool live = slot >= 0;
          const int64_t row = base + (live ? slot : 0);
          const int64_t m = row % m_rows;
          out_row[p][r] = live ? row : -1;
          h[p][r] = live && lane < H ? h0[row * H + lane] : 0.f;
          x[p][r] = live ? xy0[m * 2] : 0.f;
          y[p][r] = live ? xy0[m * 2 + 1] : 0.f;
          dx[p][r] = live ? dxdy0[m * 2] : 0.f;
          dy[p][r] = live ? dxdy0[m * 2 + 1] : 0.f;
          sb[p][r] = live && lane < hid ? socb[(m * num_gens + gen) * hid + lane] : 0.f;
        }
      rollout_tiles<2, R, kH, kHid>(smem + (size_t)gen * per_gen, L, lane, stage, h, x, y, dx,
                                    dy, sb, out_row, out_abs, out_rel, nullptr);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

}  // namespace mggan
