// Fused-selection decoder rollout in f32 (K1) for Hopper (sm_90a), with
// rows of one generator tiled per warp.
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_select_kernel (wrapped by
// pallas_decode_select): for each row n with sampled generator g = idx[n]
// it rolls out generator g only,
//
//   gates = te @ Wemb'_g + h @ Whh_g + b_g;  c = sig(f) c + sig(i) tanh(gg)
//   h = sig(o) tanh(c);  hid = LeakyReLU_0.01(h @ W1h_g + socb[m, g])
//   nd = hid @ W2_g + b2_g;  xy += nd;  dxdy = nd
//
// and stores abs = xy and rel = nd of every step, each (N, T, 2) f32. Row
// inputs as in decode_select.cu: h0 and idx have N rows, xy0, dxdy0 and
// socb M rows with N % M == 0, and row n reads row n % M.
//
// Design. A persistent block takes tiles of consecutive rows and buckets
// each tile's rows by generator in shared memory (tile_buckets.cuh: ballots
// per 32-row chunk, then offsets; stable), every bucket padded to R rows.
// Each warp then rolls out R rows of one generator at a time
// (rollout_tile.cuh): lane j owns hidden unit j for the R rows, so each
// 16-byte weight load from shared memory serves R rows' FMAs, and the new h
// of the R rows is broadcast through a per-warp staging buffer. All G
// generators' f32 weight blocks stay in shared memory in kernel_weights'
// [k][j][gate] image. Padded rows compute on zeros and store nothing; a row
// with no generator (idx out of range) is poisoned with NaN. Per row the
// arithmetic is rollout_row's in its order, so the output is bit-identical
// to the warp-per-row K1 (decode_select.cu, mggan_decode_select_warp), which
// stays compiled as the yardstick of this design.
//
// R (1, 2 or 4) and the tile's rows are picked by the wrapper from N and
// the SM count (decoder.py::tiled_launch): R rows a warp where every
// resident warp gets at least 4 groups of R rows, else fewer. H = 32, hid = 16
// (the flagship) are a compile-time instantiation; other widths take the
// generic one.
//
// What bounds it on the H100: the warp-per-row K1 spent ~130 shared-memory
// wavefronts and ~400 warp instructions per row-step, the weight block
// re-read for every row. Here a row-step costs ~160 FMAs, ~100
// instructions of activations, a few of the nd butterfly (split over the
// half-warps at hid = 16) and ~50 wavefronts (at R = 4): instruction issue
// on the FMA and activation work, with 16 warps an SM (118 registers)
// hiding the activations' latency only in part. On an H100 80GB HBM3 at
// 700 W it takes 7.3 ms at 1,310,720 rows, 3.2x the fp32-FMA bound, which
// counts only the products (PERF.md).

#include "rollout_tile.cuh"
#include "tile_buckets.cuh"

namespace {

using namespace mggan;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 1024;  // rows of a tile, at most

template <int R>
using Buckets = TileBuckets<kWarps, kMaxTile, R>;

__host__ __device__ inline size_t smem_floats(int rows_per_warp, int num_gens, int per_gen,
                                              int h, int t) {
  return (size_t)num_gens * per_gen + (size_t)kWarps * tile_stage_floats(rows_per_warp, h, t);
}

template <int R>
__host__ __device__ inline size_t smem_bytes(int num_gens, int per_gen, int h, int t) {
  return (smem_floats(R, num_gens, per_gen, h, t) + Buckets<R>::ints(num_gens)) * sizeof(float);
}

// A persistent grid; block b takes tiles b, b + gridDim.x, ... of
// tile_rows rows (at most kMaxTile).
template <int R, int kH, int kHid>
__global__ void __launch_bounds__(kThreads, 2)
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
  const Buckets<R> s = Buckets<R>::at(
      reinterpret_cast<int*>(smem + smem_floats(R, num_gens, per_gen, H, pred_len)), num_gens);
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * tile_rows;
    const int rows = (int)(n_rows - base < tile_rows ? n_rows - base : tile_rows);
    s.bucket(idx, base, rows, num_gens, pred_len, out_abs, out_rel);
    for (int grp = warp; grp < *s.groups; grp += kWarps) {
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
      rollout_tile<R, kH, kHid>(smem + (size_t)gen * per_gen, L, lane, stage, h, x, y, dx, dy,
                                sb, out_row, out_abs, out_rel, nullptr);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

using Kernel = decltype(&decode_select_tiled_kernel<1, 0, 0>);

// The instantiation for R rows a warp (1, 2 or 4) at these widths (the
// flagship's H = 32, hid = 16 fixed at compile time); null for another R.
inline Kernel tiled_kernel(int rows_per_warp, int h, int hid) {
  const bool flagship = h == 32 && hid == 16;
  switch (rows_per_warp) {
    case 1: return flagship ? decode_select_tiled_kernel<1, 32, 16> : decode_select_tiled_kernel<1, 0, 0>;
    case 2: return flagship ? decode_select_tiled_kernel<2, 32, 16> : decode_select_tiled_kernel<2, 0, 0>;
    case 4: return flagship ? decode_select_tiled_kernel<4, 32, 16> : decode_select_tiled_kernel<4, 0, 0>;
    default: return nullptr;
  }
}

inline size_t tiled_smem(int rows_per_warp, int num_gens, int per_gen, int h, int t) {
  switch (rows_per_warp) {
    case 1: return smem_bytes<1>(num_gens, per_gen, h, t);
    case 2: return smem_bytes<2>(num_gens, per_gen, h, t);
    default: return smem_bytes<4>(num_gens, per_gen, h, t);
  }
}

}  // namespace

extern "C" {

// The tiled K1 on `stream` with the f32 weight image: `blocks` persistent
// blocks over tiles of tile_rows rows (1..1024), rows_per_warp (1, 2 or 4)
// rows of one generator a warp. Returns cudaGetLastError() after the launch
// (0 on success); the caller checks shapes (G <= 32) and picks the launch
// (decoder.py::tiled_launch).
int mggan_decode_select(const void* wpack, const void* h0, const void* socb, const void* xy0,
                        const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
                        long long n_rows, long long m_rows, int num_gens, int h_dim,
                        int hid_dim, int in_dim, int pred_len, int fmt, int per_gen,
                        int rows_per_warp, int tile_rows, int blocks, void* stream) {
  const Kernel kernel = tiled_kernel(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr || num_gens > 32 || tile_rows < 1 || tile_rows > kMaxTile || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem(rows_per_warp, num_gens, per_gen, h_dim, pred_len);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
      per_gen, tile_rows);
  return (int)cudaGetLastError();
}

// Resident warps per SM of the tiled K1 for R = rows_per_warp at these
// widths; returns a CUDA error code.
int mggan_decode_select_tiled_warps_per_sm(int rows_per_warp, int num_gens, int per_gen,
                                           int h_dim, int hid_dim, int pred_len, int* warps) {
  const Kernel kernel = tiled_kernel(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kThreads,
                             tiled_smem(rows_per_warp, num_gens, per_gen, h_dim, pred_len),
                             warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
