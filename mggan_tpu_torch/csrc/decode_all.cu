// All-generator decoder rollout (K2) and its reverse sweep (K3) for Hopper
// (sm_90a).
//
// K2 replaces mggan_tpu/ops/pallas/decoder.py::_fwd_kernel (via _decode_fwd
// and pallas_decode_all). It runs every generator g's rollout on every row n
// (the arithmetic of decoder_rollout.cuh) and stores abs/rel as (G, N, T, 2).
// For training it also stores each step's h and c as hc (G, N, T, 2, H), the
// residuals K3 recomputes the gates from. Its bf16 variant
// (mggan_decode_all_fwd_bf16, the TPU kernel's compute_dtype=bfloat16) runs
// K1-bf16's tensor-core rollout (rollout_mma.cuh) and may save hc too: h as
// the bf16-rounded value the next step's product reads (in f32), c in f32,
// as _fwd_kernel saves h.astype(f32) after .astype(compute_dtype). K3 then
// sweeps in f32 on the f32 weights from those residuals, as _vjp_bwd does
// after a bf16 forward.
//
// K3 replaces decoder.py::_bwd_kernel (via _decode_bwd and _vjp_bwd). From
// the saved hc and outputs and the output cotangents g_abs/g_rel it sweeps
// t = T-1 ... 0 and returns, per (generator, row), the grads of h0, of the
// seed position xy0 and offset dxdy0 and of the hoisted social bias socb,
// and, summed over every row, the grads of the generator's folded weights.
//
// Row inputs: h0 has N rows. xy0, dxdy0 and socb have M rows with
// N % M == 0, and row n reads row n % M (rows are (k, s, p)-major and those
// inputs do not depend on the sample k). The per-row grads stay per row and
// per generator; the caller sums them over generators and over the K copies
// of an M-row input, as the VJP of that broadcast.
//
// Design.
// * K2 in f32 (decode_all_fwd_tiled_kernel): a block per (generator, slice
//   of rows) holds that generator's weights as [k][j][gate] and runs
//   kFwdWarps warps, each on R consecutive rows at a time
//   (rollout_tile.cuh): lane j owns hidden unit j for the R rows, so every
//   weight read from shared memory serves R rows, and the new h reaches the
//   other lanes through a per-warp staging buffer. With hc, each step stores
//   every row's h and c as two coalesced 128-byte rows, in the sweep (the
//   stores do not wait). Per (row, generator) the fmaf chains are those of
//   the warp-per-row K2, so abs, rel and hc are bit-identical to it and K3's
//   recomputed gates pick LeakyReLU's slope as the forward did. The TPU
//   kernel's lane-packed block-diagonal layout was a vector-register choice
//   and is not carried over.
// * K2-bf16 (decode_all_fwd_mma_kernel): a block per (generator, slice of
//   rows) stages only that generator's fragment image (decoder.py::
//   mma_weights, 13 KB) and runs 4 warps, each on groups of 16 consecutive
//   rows on the tensor cores (rollout_mma.cuh::rollout_group, K1-bf16's
//   rollout: the two are bit-identical on the selected rows).
//   With hc, each lane stores its units' h (the bf16 value packed into the
//   next step's A fragment, widened) and c as float2 pairs straight from the
//   accumulator layout, a quad writing one 32-byte sector per row. What
//   paces it is latency: 12 dependent steps of mma chains, activations and
//   a quad butterfly per group, so the launch (decode_all.py::mma_launch)
//   picks the blocks an SM (4, or 5 at 96 registers) that take the groups
//   in the fewest waves. Two groups interleaved per warp were slower.
// * The warp-per-row K2 (decode_all_fwd_kernel: a warp per (row,
//   generator), h broadcast by __shfl_sync, all G generators' weights in
//   shared memory, a persistent grid) stays as the yardstick of both
//   designs, on the f32 image (mggan_decode_all_fwd_warp) and on the bf16
//   one (mggan_decode_all_fwd_bf16_warp); no path launches it.
// * K3 (decode_all_bwd_kernel): a block per (generator, slice of rows)
//   runs 16 warps in lockstep, each on a tile of kBwdRows rows of that
//   generator, so every weight value a lane reads from shared memory serves
//   the whole tile, dgates reach the other lanes through a staging buffer
//   instead of shuffles, and the block sums dWhh^T over all its 64 rows of a
//   step in registers; the residuals stream in by cp.async (see the
//   kernel's note). The warp-per-row sweep it replaced (a warp per row,
//   dgates by 4H shuffles a step, ~50 KB of shared memory re-read per
//   row-step) stays as decode_all_bwd_warp_kernel (mggan_decode_all_bwd_warp)
//   for comparison on the card; no main path launches it.
// * Weight grads without atomics, so two launches on the same inputs give
//   bit-identical sums: the warp-per-row sweep accumulates each warp's
//   partial dW in a warp-private slice of shared memory (dWhh^T and dW1h^T,
//   ~18 KB at H=32) and registers (db, dWemb, dW2, db2), lane k only ever
//   touching column k; the tiled sweep keeps dWhh^T in the registers of the
//   threads that own its entries and the rest in smaller warp slices. At the
//   end the block adds its warps' slices in warp order and writes one
//   partial per block; a second kernel adds the blocks' partials in block
//   order. Rows go to (block, warp) by a fixed rule, so the order of every
//   sum is fixed.
//
// What bounds them on the H100. Both are bound by operations in the roofline
// sense (K2 at 81,920 rows x 4 generators moves ~1.0 GB of hc for ~39 GFLOP;
// K3 reads it back for ~110 GFLOP of fp32 FMA work, 67 TFLOP/s on the CUDA
// cores). The warp-per-row K2 is bound first by the shared-memory/shuffle
// pipe: every row-step re-reads its generator's weights (~17 KB). The
// tiles of K2 and K3 cut the weight reads per row-step R-fold; what is left
// is the FMA issue itself, the activations and the broadcasts of h.

#include "rollout_mma.cuh"
#include "rollout_tile.cuh"

namespace {

using namespace mggan;

constexpr int kFwdThreads = 512;
constexpr int kWarpBwdWarps = 8;  // the warp-per-row baseline's warps per block
constexpr int kWarpBwdThreads = kWarpBwdWarps * 32;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Offsets of the weight-grad image of one generator, in floats:
//   dwhhT [j][k][4] | dwemb [in][j][4] | db [j][4] | dw1T [q][k] | dw2 [q][2] | db2 [2]
struct GradLayout {
  int whh, wemb, b, w1, w2, b2, size;
  __host__ __device__ GradLayout(int h, int hid, int in) {
    whh = 0;
    wemb = whh + h * h * 4;
    b = wemb + in * h * 4;
    w1 = b + h * 4;
    w2 = w1 + hid * h;
    b2 = w2 + hid * 2;
    size = b2 + 2;
  }
};

// K3's shared memory, in floats: the generator's weight block (per_gen),
// whhT [j][k][4], w1T [q][k] (padded to 4), then one grad slice per warp.
__host__ __device__ inline int bwd_weight_floats(int h, int hid, int per_gen) {
  return per_gen + h * h * 4 + round4(hid * h);
}

__host__ __device__ inline size_t warp_bwd_smem_bytes(int h, int hid, int in, int per_gen) {
  return sizeof(float) * ((size_t)bwd_weight_floats(h, hid, per_gen) +
                          (size_t)kWarpBwdWarps * round4(GradLayout(h, hid, in).size));
}

// T = float or __nv_bfloat16: the weight image of decoder_rollout.cuh.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2)
decode_all_fwd_kernel(const float* __restrict__ wpack,
                      const float* __restrict__ h0,      // (N, H)
                      const float* __restrict__ socb,    // (M, G, hid)
                      const float* __restrict__ xy0,     // (M, 2)
                      const float* __restrict__ dxdy0,   // (M, 2)
                      float* __restrict__ out_abs,       // (G, N, T, 2)
                      float* __restrict__ out_rel,       // (G, N, T, 2)
                      float* __restrict__ hc,            // (G, N, T, 2, H) or null
                      int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                      int hid_dim, int in_dim, int pred_len, int fmt, int per_gen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage_weights(smem4, wpack, num_gens * per_gen);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const int64_t items = n_rows * num_gens;

  // item = row * G + g: the G warps of one row read the same row inputs
  for (int64_t item = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       item < items; item += (int64_t)gridDim.x * warps) {
    const int64_t row = item / num_gens;
    const int g = (int)(item % num_gens);
    const int64_t m = row % m_rows;
    const int64_t gn = (int64_t)g * n_rows + row;
    const float sb = lane < hid_dim ? socb[(m * num_gens + g) * hid_dim + lane] : 0.f;
    const float h = lane < h_dim ? h0[row * h_dim + lane] : 0.f;
    rollout_row<T>(smem + (int64_t)g * per_gen, L, lane, h, xy0[m * 2], xy0[m * 2 + 1],
                   dxdy0[m * 2], dxdy0[m * 2 + 1], sb, out_abs + gn * pred_len * 2,
                   out_rel + gn * pred_len * 2,
                   hc == nullptr ? nullptr : hc + gn * pred_len * 2 * h_dim);
  }
}

// K2 in f32 with R rows of one generator per warp. grid (blocks_per_gen,
// G), kFwdThreads threads; block (b, g) holds generator g's weights and
// takes row groups b, b + blocks_per_gen, ... of kFwdWarps * R rows, warp w
// the R rows from (group * kFwdWarps + w) * R. kH, kHid > 0 fix H and hid
// at compile time (the flagship's 32 and 16), 0 takes them from the
// arguments.
constexpr int kFwdWarps = 8;
constexpr int kFwdTiledThreads = kFwdWarps * 32;

template <int R, int kH, int kHid>
__global__ void __launch_bounds__(kFwdTiledThreads, 2)
decode_all_fwd_tiled_kernel(const float* __restrict__ wpack,
                            const float* __restrict__ h0,      // (N, H)
                            const float* __restrict__ socb,    // (M, G, hid)
                            const float* __restrict__ xy0,     // (M, 2)
                            const float* __restrict__ dxdy0,   // (M, 2)
                            float* __restrict__ out_abs,       // (G, N, T, 2)
                            float* __restrict__ out_rel,       // (G, N, T, 2)
                            float* __restrict__ hc,            // (G, N, T, 2, H) or null
                            int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                            int hid_dim, int in_dim, int pred_len, int fmt, int per_gen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.y;
  stage_weights(smem4, wpack + (int64_t)g * per_gen, per_gen);
  const int H = kH > 0 ? kH : h_dim, hid = kHid > 0 ? kHid : hid_dim;
  const Layout L(H, hid, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = smem + per_gen + warp * tile_stage_floats(R, H, pred_len);
  const int64_t groups = (n_rows + kFwdWarps * R - 1) / (kFwdWarps * R);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * kFwdWarps + warp) * R;
    if (row0 >= n_rows) continue;  // the ragged last group: no row for this warp
    float h[R], x[R], y[R], dx[R], dy[R], sb[R];
    int64_t out_row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = row0 + r < n_rows;
      const int64_t row = live ? row0 + r : row0;
      const int64_t m = row % m_rows;
      out_row[r] = live ? (int64_t)g * n_rows + row : -1;
      h[r] = live && lane < H ? h0[row * H + lane] : 0.f;
      x[r] = live ? xy0[m * 2] : 0.f;
      y[r] = live ? xy0[m * 2 + 1] : 0.f;
      dx[r] = live ? dxdy0[m * 2] : 0.f;
      dy[r] = live ? dxdy0[m * 2 + 1] : 0.f;
      sb[r] = live && lane < hid ? socb[(m * num_gens + g) * hid + lane] : 0.f;
    }
    rollout_tile<R, kH, kHid>(smem, L, lane, stage, h, x, y, dx, dy, sb, out_row, out_abs,
                              out_rel, hc);
  }
}

// K2-bf16 on the tensor cores: grid (blocks_per_gen, G), kMmaFwdThreads
// threads, kMinBlocks blocks an SM at least (the register budget). Block
// (b, g) holds generator g's fragment image; warp w of block b rolls out
// the groups of 16 consecutive rows b * kMmaFwdWarps + w, + gridDim.x *
// kMmaFwdWarps, ...
constexpr int kMmaFwdWarps = 4;
constexpr int kMmaFwdThreads = kMmaFwdWarps * 32;

template <int kMinBlocks>
__global__ void __launch_bounds__(kMmaFwdThreads, kMinBlocks)
decode_all_fwd_mma_kernel(const float* __restrict__ wimg,    // (G, kImageWords)
                          const float* __restrict__ h0,      // (N, H)
                          const float* __restrict__ socb,    // (M, G, hid)
                          const float* __restrict__ xy0,     // (M, 2)
                          const float* __restrict__ dxdy0,   // (M, 2)
                          float* __restrict__ out_abs,       // (G, N, T, 2)
                          float* __restrict__ out_rel,       // (G, N, T, 2)
                          float* __restrict__ hc,            // (G, N, T, 2, H) or null
                          int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                          int hid_dim, int in_dim, int pred_len, int fmt) {
  extern __shared__ float4 smem4[];
  const int g = blockIdx.y;
  stage_weights(smem4, wimg + (int64_t)g * kImageWords, kImageWords);
  const uint32_t* W = reinterpret_cast<const uint32_t*>(smem4);
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t groups = (n_rows + kMmaGroup - 1) / kMmaGroup;
  for (int64_t grp = (int64_t)blockIdx.x * kMmaFwdWarps + warp; grp < groups;
       grp += (int64_t)gridDim.x * kMmaFwdWarps) {
    int64_t in_row[2], out_row[2];  // this lane's rows r and r + 8 of the group
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row = grp * kMmaGroup + (lane >> 2) + 8 * i;
      const bool live = row < n_rows;
      in_row[i] = live ? row : 0;
      out_row[i] = live ? (int64_t)g * n_rows + row : -1;
    }
    rollout_group(W, g, in_row, out_row, SelectInputs{h0, socb, xy0, dxdy0, m_rows, num_gens},
                  out_abs, out_rel, hc, L, lane);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

// The warp-per-row reverse sweep (the earlier K3), kept as the baseline the
// tiled sweep below is timed and checked against; no main path launches it.
// grid (blocks_per_gen, G), kWarpBwdThreads threads.
__global__ void __launch_bounds__(kWarpBwdThreads, 1)
decode_all_bwd_warp_kernel(const float* __restrict__ wpack,
                      const float* __restrict__ h0,      // (N, H)
                      const float* __restrict__ socb,    // (M, G, hid)
                      const float* __restrict__ xy0,     // (M, 2)
                      const float* __restrict__ dxdy0,   // (M, 2)
                      const float* __restrict__ out_abs, // (G, N, T, 2)
                      const float* __restrict__ out_rel, // (G, N, T, 2)
                      const float* __restrict__ hc,      // (G, N, T, 2, H)
                      const float* __restrict__ g_abs,   // (G, N, T, 2)
                      const float* __restrict__ g_rel,   // (G, N, T, 2)
                      float* __restrict__ d_h0,          // (G, N, H)
                      float* __restrict__ d_xy0,         // (G, N, 2)
                      float* __restrict__ d_dxdy0,       // (G, N, 2)
                      float* __restrict__ d_socb,        // (N, G, hid)
                      float* __restrict__ partials,      // (G, blocks_per_gen, P)
                      int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                      int hid_dim, int in_dim, int pred_len, int fmt, int per_gen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.y;
  const int H = h_dim, hid = hid_dim;
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const GradLayout GL(h_dim, hid_dim, in_dim);
  const int slice = round4(GL.size);

  // stage the generator's weights, their transposes, and zero the slices
  float* W = smem;
  float* whhT = W + per_gen;
  float* w1T = whhT + H * H * 4;
  float* slices = W + bwd_weight_floats(H, hid, per_gen);
  const float* src = wpack + (int64_t)g * per_gen;
  for (int i = threadIdx.x; i < per_gen; i += blockDim.x) W[i] = src[i];
  for (int i = threadIdx.x; i < H * H * 4; i += blockDim.x) {
    const int j = i / (H * 4), k = (i / 4) % H, gate = i % 4;
    whhT[i] = src[(k * H + j) * 4 + gate];
  }
  for (int i = threadIdx.x; i < hid * H; i += blockDim.x) {
    const int q = i / H, k = i % H;
    w1T[i] = src[L.w1 + k * hid + q];
  }
  for (int i = threadIdx.x; i < kWarpBwdWarps * slice; i += blockDim.x) slices[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool own = lane < H;
  const bool own_hid = lane < hid;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* whh4 = reinterpret_cast<const float4*>(W);
  const float4* wemb4 = reinterpret_cast<const float4*>(W + L.wemb);
  const float4* whhT4 = reinterpret_cast<const float4*>(whhT);
  const float4 bias = own ? reinterpret_cast<const float4*>(W + L.b)[lane] : zero4;
  const float w2x = own_hid ? W[L.w2 + lane * 2] : 0.f;
  const float w2y = own_hid ? W[L.w2 + lane * 2 + 1] : 0.f;
  float* mine = slices + warp * slice;
  float4* d_whhT4 = reinterpret_cast<float4*>(mine + GL.whh);
  float* d_w1T = mine + GL.w1;

  // register partials: db [lane][4], dwemb [in][lane][4], dw2 [lane][2], db2
  float4 acc_db = zero4;
  float4 acc_dwe[4] = {zero4, zero4, zero4, zero4};
  float acc_dw2x = 0.f, acc_dw2y = 0.f, acc_db2x = 0.f, acc_db2y = 0.f;

  for (int64_t row = (int64_t)blockIdx.x * kWarpBwdWarps + warp; row < n_rows;
       row += (int64_t)gridDim.x * kWarpBwdWarps) {
    const int64_t m = row % m_rows;
    const int64_t gn = (int64_t)g * n_rows + row;
    const float* hc_row = hc + gn * pred_len * 2 * H;
    // lane t holds step t's outputs and cotangents
    const bool own_t = lane < pred_len;
    const float2* a2 = reinterpret_cast<const float2*>(out_abs + gn * pred_len * 2);
    const float2* r2 = reinterpret_cast<const float2*>(out_rel + gn * pred_len * 2);
    const float2* ga2 = reinterpret_cast<const float2*>(g_abs + gn * pred_len * 2);
    const float2* gr2 = reinterpret_cast<const float2*>(g_rel + gn * pred_len * 2);
    const float2 zero2 = make_float2(0.f, 0.f);
    const float2 a_l = own_t ? a2[lane] : zero2, r_l = own_t ? r2[lane] : zero2;
    const float2 ga_l = own_t ? ga2[lane] : zero2, gr_l = own_t ? gr2[lane] : zero2;
    const float sb = own_hid ? socb[(m * num_gens + g) * hid + lane] : 0.f;
    const float h_init = own ? h0[row * H + lane] : 0.f;

    float h_t = own ? hc_row[(pred_len - 1) * 2 * H + lane] : 0.f;
    float c_t = own ? hc_row[(pred_len - 1) * 2 * H + H + lane] : 0.f;
    float dh_c = 0.f, dc_c = 0.f, d_sb = 0.f;
    float dxy_cx = 0.f, dxy_cy = 0.f, dnd_nx = 0.f, dnd_ny = 0.f;

    for (int t = pred_len - 1; t >= 0; --t) {
      float h_p = h_init, c_p = 0.f;
      if (t > 0 && own) {
        h_p = hc_row[(t - 1) * 2 * H + lane];
        c_p = hc_row[(t - 1) * 2 * H + H + lane];
      }
      float2 xy_p = make_float2(xy0[m * 2], xy0[m * 2 + 1]);
      float2 nd_p = make_float2(dxdy0[m * 2], dxdy0[m * 2 + 1]);
      const float2 xy_s = shfl2(a_l, t > 0 ? t - 1 : 0);
      const float2 nd_s = shfl2(r_l, t > 0 ? t - 1 : 0);
      if (t > 0) { xy_p = xy_s; nd_p = nd_s; }
      const float2 gxy = shfl2(ga_l, t), gnd = shfl2(gr_l, t);

      const float dxy_x = gxy.x + dxy_cx, dxy_y = gxy.y + dxy_cy;
      const float dnd_x = gnd.x + dxy_x + dnd_nx, dnd_y = gnd.y + dxy_y + dnd_ny;

      // hidden2pos backward, pre-activation recomputed from h_t
      float pre = sb;
      for (int k = 0; k < H; ++k) {
        const float hk = __shfl_sync(kFull, h_t, k);
        if (own_hid) pre = fmaf(hk, W[L.w1 + k * hid + lane], pre);
      }
      const float act = pre > 0.f ? pre : 0.01f * pre;
      const float dhid = dnd_x * w2x + dnd_y * w2y;
      const float dpre = own_hid ? (pre > 0.f ? dhid : 0.01f * dhid) : 0.f;
      if (own_hid) {
        acc_dw2x = fmaf(act, dnd_x, acc_dw2x);
        acc_dw2y = fmaf(act, dnd_y, acc_dw2y);
      }
      acc_db2x += dnd_x;
      acc_db2y += dnd_y;
      d_sb += dpre;
      float dh = dh_c;  // dpre @ W1h^T + carry; dW1h += h_t dpre
      for (int q = 0; q < hid; ++q) {
        const float dq = __shfl_sync(kFull, dpre, q);
        if (own) {
          dh = fmaf(dq, w1T[q * H + lane], dh);
          d_w1T[q * H + lane] = fmaf(h_t, dq, d_w1T[q * H + lane]);
        }
      }

      // LSTM backward, gates recomputed from h_{t-1} as in the forward
      float4 gates = zero4;
      for (int k = 0; k < H; ++k) {
        const float hk = __shfl_sync(kFull, h_p, k);
        if (own) fma4(gates, hk, whh4[k * H + lane]);
      }
      gates.x += bias.x; gates.y += bias.y; gates.z += bias.z; gates.w += bias.w;
      float te[4] = {xy_p.x, xy_p.y, nd_p.x, nd_p.y};  // abs_rel: [x y dx dy]
      if (fmt == kRel) { te[0] = nd_p.x; te[1] = nd_p.y; }
      float4 dg = zero4;
      if (own) {
        add_input<float>(gates, wemb4, L, lane, xy_p.x, xy_p.y, nd_p.x, nd_p.y);
        const float ig = sigmoid(gates.x), fg = sigmoid(gates.y);
        const float gg = tanhf(gates.z), og = sigmoid(gates.w);
        const float tc = tanhf(c_t);
        const float d_o = dh * tc;
        const float dc = dc_c + dh * og * (1.f - tc * tc);
        dc_c = dc * fg;
        dg = make_float4((dc * gg) * ig * (1.f - ig), (dc * c_p) * fg * (1.f - fg),
                         (dc * ig) * (1.f - gg * gg), d_o * og * (1.f - og));
        acc_db.x += dg.x; acc_db.y += dg.y; acc_db.z += dg.z; acc_db.w += dg.w;
        for (int i = 0; i < 4; ++i)
          if (i < in_dim) fma4(acc_dwe[i], te[i], dg);
      }
      // dte = dgates @ Wemb^T: one warp reduction per input column
      float dte[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < 4; ++i)
        if (i < in_dim) dte[i] = warp_sum(own ? dot4(dg, wemb4[i * H + lane]) : 0.f);
      // dh_{t-1} = dgates @ Whh^T; dWhh^T[j][k] += h_{t-1}[k] dgates[j]
      float dhn = 0.f;
      for (int j = 0; j < H; ++j) {
        const float4 dj = make_float4(__shfl_sync(kFull, dg.x, j), __shfl_sync(kFull, dg.y, j),
                                      __shfl_sync(kFull, dg.z, j), __shfl_sync(kFull, dg.w, j));
        if (own) {
          dhn += dot4(dj, whhT4[j * H + lane]);
          float4 acc = d_whhT4[j * H + lane];
          fma4(acc, h_p, dj);
          d_whhT4[j * H + lane] = acc;
        }
      }
      dh_c = dhn;

      // carries into step t-1 through the decoder input
      if (fmt == kRel) {
        dnd_nx = dte[0]; dnd_ny = dte[1];
        dxy_cx = dxy_x; dxy_cy = dxy_y;
      } else if (fmt == kAbs) {
        dxy_cx = dxy_x + dte[0]; dxy_cy = dxy_y + dte[1];
        dnd_nx = 0.f; dnd_ny = 0.f;
      } else {
        dxy_cx = dxy_x + dte[0]; dxy_cy = dxy_y + dte[1];
        dnd_nx = dte[2]; dnd_ny = dte[3];
      }
      h_t = h_p;
      c_t = c_p;
    }
    if (own) d_h0[gn * H + lane] = dh_c;
    if (own_hid) d_socb[(row * num_gens + g) * hid + lane] = d_sb;
    if (lane == 0) {
      reinterpret_cast<float2*>(d_xy0)[gn] = make_float2(dxy_cx, dxy_cy);
      reinterpret_cast<float2*>(d_dxdy0)[gn] = make_float2(dnd_nx, dnd_ny);
    }
  }

  // register partials into the warp's slice, then the block's sum in warp order
  if (own) {
    reinterpret_cast<float4*>(mine + GL.b)[lane] = acc_db;
    for (int i = 0; i < 4; ++i)
      if (i < in_dim) reinterpret_cast<float4*>(mine + GL.wemb)[i * H + lane] = acc_dwe[i];
  }
  if (own_hid) {
    mine[GL.w2 + lane * 2] = acc_dw2x;
    mine[GL.w2 + lane * 2 + 1] = acc_dw2y;
  }
  if (lane == 0) {
    mine[GL.b2] = acc_db2x;
    mine[GL.b2 + 1] = acc_db2y;
  }
  __syncthreads();
  float* out = partials + ((int64_t)g * gridDim.x + blockIdx.x) * GL.size;
  for (int e = threadIdx.x; e < GL.size; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarpBwdWarps; ++w) s += slices[w * slice + e];
    out[e] = s;
  }
}

// ----------------------------------------------------------------------------
// K3, the reverse sweep, with rows of one generator tiled per warp.
//
// A block holds one generator's weights (grid (blocks_per_gen, G)) and runs
// kBwdWarps warps in lockstep, each on its own tile of kBwdRows consecutive
// rows: 64 rows of one generator a step. Lane j owns hidden unit j (lane q
// hidden2pos unit q) for every row of its warp's tile, so each weight value
// a lane reads from shared memory serves the tile's rows from registers:
// per step the gates are recomputed as an (R x H)(H x 4H) product,
// hidden2pos's pre-activation as (R x H)(H x hid), and dh_{t-1} = dgates
// Whh^T as (R x 4H)(4H x H), all in f32 on the CUDA cores (plain TF32 would
// break the 2e-4 limits). dgates and dpre reach the other lanes through
// per-warp staging buffers in shared memory, written once a step and read as
// broadcasts ([r][j] layouts), instead of a shuffle per value.
//
// Weight grads. dWhh^T += h_{t-1}^T dgates is summed by the whole block
// after each step: every thread owns 8 entries (one unit j, 4 inputs k, 2
// gates) in registers for the whole kernel and adds the products of all 64
// rows of the step, read from the warps' staging buffers. dW1h^T, db,
// dWemb, dW2 and db2 are summed over a warp's rows in registers and added to
// the warp's slice once a step. No warp holds a copy of dWhh^T, so 16 warps
// fit in one block's shared memory.
//
// The residuals stream through a three-slot ring per warp filled with
// cp.async: while step t runs on slots t and t-1, step t-2's (h, c) and its
// outputs and cotangents arrive in the third slot. Slot -1 is the rollout's
// start (h0, c = 0, xy0, dxdy0).
//
// Each sum runs in a fixed order (rows in warp and tile order, tiles by a
// fixed (block, warp) rule, warps then blocks in index order) and there are
// no atomics, so two launches give bit-identical weight grads. The gates and
// the pre-activation are recomputed with the forward's fmaf chains (K2,
// decoder_rollout.cuh), so LeakyReLU's slope is picked as the forward did.
// ----------------------------------------------------------------------------

constexpr int kBwdRows = 4;    // R, rows of one warp's tile
constexpr int kBwdWarps = 16;  // warps of a block, in lockstep
constexpr int kBwdThreads = kBwdWarps * 32;

// Floats of one row of a ring slot: h and c, each padded to a multiple of 4
// (16-byte broadcast reads), then abs, rel, g_abs and g_rel of the step.
__host__ __device__ inline int ring_row_floats(int h) { return 2 * round4(h) + 8; }

// Floats of a warp's slice: the weight-grad image from dWemb on (the block
// sums dWhh^T in registers).
__host__ __device__ inline int bwd_slice_floats(int h, int hid, int in) {
  const GradLayout GL(h, hid, in);
  return round4(GL.size - GL.wemb);
}

// Floats of one warp's private area: its slice, the residual ring, the
// dgates staging [r][j][4], the dpre staging [r][q] and the rows' carries
// [r][dxy x, dxy y, dnd x, dnd y] (equal in every lane).
__host__ __device__ inline int bwd_warp_floats(int h, int hid, int in) {
  return bwd_slice_floats(h, hid, in) + 3 * kBwdRows * ring_row_floats(h) +
         kBwdRows * h * 4 + kBwdRows * round4(hid) + kBwdRows * 4;
}

__host__ __device__ inline size_t bwd_smem_bytes(int h, int hid, int in, int per_gen) {
  return sizeof(float) * ((size_t)bwd_weight_floats(h, hid, per_gen) +
                          (size_t)kBwdWarps * bwd_warp_floats(h, hid, in));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct BwdRows {
  const float* hc;       // (G, N, T, 2, H)
  const float* out_abs;  // (G, N, T, 2)
  const float* out_rel;
  const float* g_abs;
  const float* g_rel;
  const float* h0;       // (N, H)
  const float* xy0;      // (M, 2)
  const float* dxdy0;
  int64_t n_rows, m_rows;
  int g, h, t;
};

// Start filling ring slot (s + 3) % 3 with step s of the tile's rows: per
// row [h_s | c_s | abs_s rel_s g_abs_s g_rel_s]; for s = -1 the start
// [h0 | 0 | xy0 dxdy0 0 0]. The lanes first cover every row's (h, c), 16
// bytes a copy when H is a multiple of 4, then one lane per (row, output)
// pair its 8 bytes. Copies go by cp.async, zeros (and rows past n_rows) by
// plain stores; the caller commits the group.
__device__ __forceinline__ void stage_step(float* ring, int s, int64_t row0, const BwdRows& a,
                                           int H, int lane) {
  const int hp = round4(H), rs = ring_row_floats(H);
  const bool vec = (H & 3) == 0;
  const int per_row = vec ? H / 2 : 2 * H;  // copies of a row's 2H floats of (h, c)
  float* slot = ring + ((s + 3) % 3) * kBwdRows * rs;
  for (int e = lane; e < kBwdRows * per_row; e += 32) {
    const int r = e / per_row, f = (e - r * per_row) * (vec ? 4 : 1);
    const int64_t row = row0 + r;
    float* dst = slot + r * rs + (f < H ? f : hp + f - H);
    const float* src = nullptr;
    if (row < a.n_rows && s >= 0)
      src = a.hc + (((int64_t)a.g * a.n_rows + row) * a.t + s) * 2 * H + f;
    else if (row < a.n_rows && f < H)
      src = a.h0 + row * H + f;
    if (vec) {
      if (src != nullptr) cp_async<16>(dst, src);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (src != nullptr) cp_async<4>(dst, src);
      else *dst = 0.f;
    }
  }
  static_assert(kBwdRows * 4 <= 32, "one lane per (row, output) pair");
  if (lane < kBwdRows * 4) {
    const int r = lane >> 2, io = lane & 3;  // io: abs, rel, g_abs, g_rel
    const int64_t row = row0 + r;
    float* dst = slot + r * rs + 2 * hp + 2 * io;
    const float* src = nullptr;
    if (row < a.n_rows && s >= 0) {
      const float* arr = io == 0   ? a.out_abs
                         : io == 1 ? a.out_rel
                         : io == 2 ? a.g_abs
                                   : a.g_rel;
      src = arr + (((int64_t)a.g * a.n_rows + row) * a.t + s) * 2;
    } else if (row < a.n_rows && io < 2) {
      src = (io == 0 ? a.xy0 : a.dxdy0) + (row % a.m_rows) * 2;
    }
    if (src != nullptr) cp_async<8>(dst, src);
    else *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
  }
}

// The sweeps of one step that update a weight-grad slice. The restrict
// qualifiers tell the compiler that the staging buffers, the weights and
// the slice do not overlap, so it may load ahead of the slice's stores.
//
// dh[r][k] += sum_q dpre[r][q] W1h^T[q][k];  dW1h^T[q][k] += sum_r h_t[r][k] dpre[r][q]
__device__ __forceinline__ void sweep_w1(const float* __restrict__ dps,
                                         const float* __restrict__ w1T,
                                         float* __restrict__ d_w1T, const float (&ht)[kBwdRows],
                                         float (&dh)[kBwdRows], int H, int hid, int hidp,
                                         int lane, bool own) {
  int q = 0;
  for (; q + 4 <= hid; q += 4) {
    float w[4], dacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = own ? w1T[(q + i) * H + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(dps + r * hidp + q);
      const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dh[r] = fmaf(dq[i], w[i], dh[r]);
        dacc[i] = fmaf(ht[r], dq[i], dacc[i]);
      }
    }
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d_w1T[(q + i) * H + lane] += dacc[i];
    }
  }
  for (; q < hid; ++q) {
    const float w = own ? w1T[q * H + lane] : 0.f;
    float dacc = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float dq = dps[r * hidp + q];
      dh[r] = fmaf(dq, w, dh[r]);
      dacc = fmaf(ht[r], dq, dacc);
    }
    if (own) d_w1T[q * H + lane] += dacc;
  }
}

// dhn[r][k] = sum_j dgates[r][j] . Whh^T[j][k]
__device__ __forceinline__ void sweep_whh(const float4* __restrict__ dgs,
                                          const float4* __restrict__ whhT4,
                                          float (&dhn)[kBwdRows], int H, int lane, bool own) {
#pragma unroll 4
  for (int j = 0; j < H; ++j) {
    const float4 wT = own ? whhT4[j * H + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) dhn[r] += dot4(dgs[r * H + j], wT);
  }
}

// The block's share of dWhh^T[j][k][gate] += sum over the step's rows of
// h_{t-1}[row][k] dgates[row][j][gate]: thread (j, k block kb, gate pair gp)
// adds the kBwdWarps x kBwdRows rows, warp by warp, into acc[k - 4 kb][gate
// - 2 gp]. `areas` holds the warps' private areas, `prev` and `dgs` the
// offsets of the step's ring slot and staging in each.
__device__ __forceinline__ void block_sum_whh(const float* __restrict__ areas, int per_warp,
                                              int prev, int dgs, int rs, int H, int j, int kb,
                                              int gp, float (&acc)[4][2]) {
#pragma unroll 2
  for (int w = 0; w < kBwdWarps; ++w) {
    const float* area = areas + w * per_warp;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(area + prev + r * rs + 4 * kb);
      const float2 dg = *reinterpret_cast<const float2*>(area + dgs + (r * H + j) * 4 + 2 * gp);
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(h4[i], dg.x, acc[i][0]);
        acc[i][1] = fmaf(h4[i], dg.y, acc[i][1]);
      }
    }
  }
}

// grid (blocks_per_gen, G), kBwdThreads threads; IN = in_dim (2: rel or
// abs input, 4: abs_rel). kH, kHid > 0 fix H and hid at compile time (the
// flagship's 32 and 16: every stride folds into an immediate offset), 0
// takes them from the arguments.
template <int IN, int kH, int kHid>
__global__ void __launch_bounds__(kBwdThreads, 1)
decode_all_bwd_kernel(const float* __restrict__ wpack,
                      const float* __restrict__ h0,      // (N, H)
                      const float* __restrict__ socb,    // (M, G, hid)
                      const float* __restrict__ xy0,     // (M, 2)
                      const float* __restrict__ dxdy0,   // (M, 2)
                      const float* __restrict__ out_abs, // (G, N, T, 2)
                      const float* __restrict__ out_rel, // (G, N, T, 2)
                      const float* __restrict__ hc,      // (G, N, T, 2, H)
                      const float* __restrict__ g_abs,   // (G, N, T, 2)
                      const float* __restrict__ g_rel,   // (G, N, T, 2)
                      float* __restrict__ d_h0,          // (G, N, H)
                      float* __restrict__ d_xy0,         // (G, N, 2)
                      float* __restrict__ d_dxdy0,       // (G, N, 2)
                      float* __restrict__ d_socb,        // (N, G, hid)
                      float* __restrict__ partials,      // (G, blocks_per_gen, P)
                      int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                      int hid_dim, int in_dim, int pred_len, int fmt, int per_gen) {
  constexpr int R = kBwdRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.y;
  const int H = kH > 0 ? kH : h_dim, hid = kHid > 0 ? kHid : hid_dim, T = pred_len;
  const int hp = round4(H), hidp = round4(hid), rs = ring_row_floats(H);
  const Layout L(H, hid, IN, pred_len, fmt);
  const GradLayout GL(H, hid, IN);
  const int per_warp = bwd_warp_floats(H, hid, IN);
  const int slice = bwd_slice_floats(H, hid, IN);
  const int ring_at = slice, dgs_at = ring_at + 3 * R * rs, dps_at = dgs_at + R * H * 4;
  const int carry_at = dps_at + R * hidp;

  // the generator's weights and their transposes; every warp area zeroed
  float* W = smem;
  float* whhT = W + per_gen;
  float* w1T = whhT + H * H * 4;
  float* areas = W + bwd_weight_floats(H, hid, per_gen);
  const float* src = wpack + (int64_t)g * per_gen;
  for (int i = threadIdx.x; i < per_gen; i += blockDim.x) W[i] = src[i];
  for (int i = threadIdx.x; i < H * H * 4; i += blockDim.x) {
    const int j = i / (H * 4), k = (i / 4) % H, gate = i % 4;
    whhT[i] = src[(k * H + j) * 4 + gate];
  }
  for (int i = threadIdx.x; i < hid * H; i += blockDim.x) {
    const int q = i / H, k = i % H;
    w1T[i] = src[L.w1 + k * hid + q];
  }
  for (int i = threadIdx.x; i < kBwdWarps * per_warp; i += blockDim.x) areas[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool own = lane < H;
  const bool own_hid = lane < hid;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* whh4 = reinterpret_cast<const float4*>(W);
  const float4* wemb4 = reinterpret_cast<const float4*>(W + L.wemb);
  const float* w1 = W + L.w1;
  const float4 bias = own ? reinterpret_cast<const float4*>(W + L.b)[lane] : zero4;
  const float w2x = own_hid ? W[L.w2 + lane * 2] : 0.f;
  const float w2y = own_hid ? W[L.w2 + lane * 2 + 1] : 0.f;
  float* mine = areas + warp * per_warp;  // slice: the grad image from GL.wemb on
  float* ring = mine + ring_at;
  float4* dgs = reinterpret_cast<float4*>(mine + dgs_at);  // [r][j]
  float* dps = mine + dps_at;                              // [r][q], q < hidp
  float4* carry = reinterpret_cast<float4*>(mine + carry_at);  // [r]: dxy x, y, dnd x, y
  float4* slice_b = reinterpret_cast<float4*>(mine + GL.b - GL.wemb);
  float4* slice_wemb = reinterpret_cast<float4*>(mine);
  const BwdRows rows{hc, out_abs, out_rel, g_abs, g_rel, h0, xy0, dxdy0, n_rows, m_rows, g, H, T};

  // this thread's entries of dWhh^T (block_sum_whh): unit j, k block kb, gate pair gp
  const int kbs = hp / 4;
  const bool sums = (int)threadIdx.x < H * kbs * 2;
  const int sj = threadIdx.x / (kbs * 2), skb = (threadIdx.x / 2) % kbs, sgp = threadIdx.x % 2;
  float acc_whh[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};

  const int64_t groups = (n_rows + R * kBwdWarps - 1) / (R * kBwdWarps);
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t row0 = (grp * kBwdWarps + warp) * R;
    // per row: the social bias and the grads carried from step to step
    float sb[R], dh_c[R], dc_c[R], d_sb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r;
      sb[r] = own_hid && row < n_rows ? socb[((row % m_rows) * num_gens + g) * hid + lane] : 0.f;
      dh_c[r] = dc_c[r] = d_sb[r] = 0.f;
      if (lane == 0) carry[r] = zero4;
    }
    stage_step(ring, T - 1, row0, rows, H, lane);
    cp_async_commit();
    stage_step(ring, T - 2, row0, rows, H, lane);
    cp_async_commit();

    for (int t = T - 1; t >= 0; --t) {
      if (t >= 1) stage_step(ring, t - 2, row0, rows, H, lane);  // into the free slot
      cp_async_commit();
      cp_async_wait_but_one();  // steps t and t-1 have landed
      __syncwarp();
      const int cur_at = ((t + 3) % 3) * R * rs, prev_at = ((t + 2) % 3) * R * rs;
      const float* cur = ring + cur_at;    // h_t, c_t, outputs, cotangents
      const float* prev = ring + prev_at;  // h_{t-1}, c_{t-1}, abs/rel_{t-1}

      // hidden2pos backward, pre-activation recomputed from h_t with the
      // forward's fmaf chain (lane q)
      float pre[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pre[r] = sb[r];
      int k = 0;
      for (; k + 4 <= H; k += 4) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = own_hid ? w1[(k + i) * hid + lane] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(cur + r * rs + k);
          pre[r] = fmaf(hv.x, w[0], pre[r]);
          pre[r] = fmaf(hv.y, w[1], pre[r]);
          pre[r] = fmaf(hv.z, w[2], pre[r]);
          pre[r] = fmaf(hv.w, w[3], pre[r]);
        }
      }
      for (; k < H; ++k) {
        const float w = own_hid ? w1[k * hid + lane] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) pre[r] = fmaf(cur[r * rs + k], w, pre[r]);
      }
      float s_dw2x = 0.f, s_dw2y = 0.f, s_db2x = 0.f, s_db2y = 0.f;  // this step's sums
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* io = cur + r * rs + 2 * hp;  // abs_t rel_t g_abs_t g_rel_t
        const float4 cr = carry[r];
        const float dxy_x = io[4] + cr.x, dxy_y = io[5] + cr.y;
        const float dnd_x = io[6] + dxy_x + cr.z, dnd_y = io[7] + dxy_y + cr.w;
        const float act = pre[r] > 0.f ? pre[r] : 0.01f * pre[r];
        const float dhid = dnd_x * w2x + dnd_y * w2y;
        const float dpre = own_hid ? (pre[r] > 0.f ? dhid : 0.01f * dhid) : 0.f;
        s_dw2x = fmaf(act, dnd_x, s_dw2x);
        s_dw2y = fmaf(act, dnd_y, s_dw2y);
        s_db2x += dnd_x;
        s_db2y += dnd_y;
        d_sb[r] += dpre;
        if (lane < hidp) dps[r * hidp + lane] = dpre;
      }
      if (own_hid) {
        mine[GL.w2 - GL.wemb + lane * 2] += s_dw2x;
        mine[GL.w2 - GL.wemb + lane * 2 + 1] += s_dw2y;
      }
      if (lane == 0) {
        mine[GL.b2 - GL.wemb] += s_db2x;
        mine[GL.b2 - GL.wemb + 1] += s_db2y;
      }
      __syncwarp();

      // dh = dpre @ W1h^T + carry; dW1h^T += dpre^T h_t (lane k)
      float dh[R], ht[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dh[r] = dh_c[r];
        ht[r] = own ? cur[r * rs + lane] : 0.f;
      }
      sweep_w1(dps, w1T, mine + GL.w1 - GL.wemb, ht, dh, H, hid, hidp, lane, own);

      // LSTM backward, gates recomputed from h_{t-1} as in the forward (lane j)
      float4 gt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) gt[r] = zero4;
      k = 0;
      for (; k + 4 <= H; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = own ? whh4[(k + i) * H + lane] : zero4;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(prev + r * rs + k);
          fma4(gt[r], hv.x, wv[0]);
          fma4(gt[r], hv.y, wv[1]);
          fma4(gt[r], hv.z, wv[2]);
          fma4(gt[r], hv.w, wv[3]);
        }
      }
      for (; k < H; ++k) {
        const float4 wv = own ? whh4[k * H + lane] : zero4;
#pragma unroll
        for (int r = 0; r < R; ++r) fma4(gt[r], prev[r * rs + k], wv);
      }
      float part[R][IN];  // dte partials: dgates . Wemb^T columns, this lane's unit
      float4 s_db = zero4, s_dwe[IN];  // this step's sums over the rows
#pragma unroll
      for (int i = 0; i < IN; ++i) s_dwe[i] = zero4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* pio = prev + r * rs + 2 * hp;  // abs_{t-1} rel_{t-1} (or xy0 dxdy0)
        const float xp = pio[0], yp = pio[1], dxp = pio[2], dyp = pio[3];
        float4 dg = zero4;
        if (own) {
          float4 gates = gt[r];
          gates.x += bias.x; gates.y += bias.y; gates.z += bias.z; gates.w += bias.w;
          add_input<float>(gates, wemb4, L, lane, xp, yp, dxp, dyp);
          const float ig = sigmoid(gates.x), fg = sigmoid(gates.y);
          const float gg = tanhf(gates.z), og = sigmoid(gates.w);
          const float c_t = cur[r * rs + hp + lane], c_p = prev[r * rs + hp + lane];
          const float tc = tanhf(c_t);
          const float d_o = dh[r] * tc;
          const float dc = dc_c[r] + dh[r] * og * (1.f - tc * tc);
          dc_c[r] = dc * fg;
          dg = make_float4((dc * gg) * ig * (1.f - ig), (dc * c_p) * fg * (1.f - fg),
                           (dc * ig) * (1.f - gg * gg), d_o * og * (1.f - og));
          s_db.x += dg.x; s_db.y += dg.y; s_db.z += dg.z; s_db.w += dg.w;
          dgs[r * H + lane] = dg;
        }
        // te: abs_rel [x y dx dy], rel [dx dy], abs [x y]
        const float te[4] = {IN == 2 && fmt == kRel ? dxp : xp, IN == 2 && fmt == kRel ? dyp : yp,
                             dxp, dyp};
#pragma unroll
        for (int i = 0; i < IN; ++i) {
          fma4(s_dwe[i], te[i], dg);
          part[r][i] = own ? dot4(dg, wemb4[i * H + lane]) : 0.f;
        }
      }
      if (own) {
        float4 a = slice_b[lane];
        a.x += s_db.x; a.y += s_db.y; a.z += s_db.z; a.w += s_db.w;
        slice_b[lane] = a;
#pragma unroll
        for (int i = 0; i < IN; ++i) {
          a = slice_wemb[i * H + lane];
          a.x += s_dwe[i].x; a.y += s_dwe[i].y; a.z += s_dwe[i].z; a.w += s_dwe[i].w;
          slice_wemb[i * H + lane] = a;
        }
      }
      // dte = dgates @ Wemb^T: every (row, column) summed over the warp at once
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < IN; ++i) part[r][i] += __shfl_xor_sync(kFull, part[r][i], s);
      }
      __syncwarp();

      // dh_{t-1} = dgates @ Whh^T (lane k)
      float dhn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dhn[r] = 0.f;
      sweep_whh(dgs, reinterpret_cast<const float4*>(whhT), dhn, H, lane, own);

      // carries into step t-1 through the decoder input (lane 0 stores them
      // after every lane has read the old ones)
      float4 next[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dh_c[r] = dhn[r];
        const float* io = cur + r * rs + 2 * hp;
        const float4 cr = carry[r];
        const float dxy_x = io[4] + cr.x, dxy_y = io[5] + cr.y;
        if constexpr (IN == 4) {  // te = [x y dx dy]
          next[r] = make_float4(dxy_x + part[r][0], dxy_y + part[r][1], part[r][2], part[r][3]);
        } else if (fmt == kRel) {
          next[r] = make_float4(dxy_x, dxy_y, part[r][0], part[r][1]);
        } else {
          next[r] = make_float4(dxy_x + part[r][0], dxy_y + part[r][1], 0.f, 0.f);
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) carry[r] = next[r];
      }
      // dWhh^T of the step, summed by the block over its 64 rows
      __syncthreads();
      if (sums)
        block_sum_whh(areas, per_warp, ring_at + prev_at, dgs_at, rs, H, sj, skb, sgp, acc_whh);
      __syncthreads();  // the staging buffers and this step's slots are free again
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r;
      if (row >= n_rows) continue;
      const int64_t gn = (int64_t)g * n_rows + row;
      if (own) d_h0[gn * H + lane] = dh_c[r];
      if (own_hid) d_socb[(row * num_gens + g) * hid + lane] = d_sb[r];
      if (lane == 0) {
        const float4 cr = carry[r];
        reinterpret_cast<float2*>(d_xy0)[gn] = make_float2(cr.x, cr.y);
        reinterpret_cast<float2*>(d_dxdy0)[gn] = make_float2(cr.z, cr.w);
      }
    }
  }

  // the block's sums: dWhh^T from the threads that own its entries, the
  // rest over the warps' slices in warp order
  float* out = partials + ((int64_t)g * gridDim.x + blockIdx.x) * GL.size;
  if (sums) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * skb + i;
      if (k < H) {
        out[(sj * H + k) * 4 + 2 * sgp] = acc_whh[i][0];
        out[(sj * H + k) * 4 + 2 * sgp + 1] = acc_whh[i][1];
      }
    }
  }
  __syncthreads();
  for (int e = GL.wemb + threadIdx.x; e < GL.size; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) s += areas[w * per_warp + e - GL.wemb];
    out[e] = s;
  }
}

// dw[g][e] = sum over b of partials[g][b][e], b in order.
__global__ void decode_all_wgrad_reduce(const float* __restrict__ partials,
                                        float* __restrict__ dw, int blocks_per_gen,
                                        int size, int num_gens) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_gens * size) return;
  const int g = idx / size, e = idx % size;
  const float* p = partials + (int64_t)g * blocks_per_gen * size + e;
  float s = 0.f;
  for (int b = 0; b < blocks_per_gen; ++b) s += p[(int64_t)b * size];
  dw[idx] = s;
}

template <typename T>
int launch_fwd(const void* wpack, const void* h0, const void* socb, const void* xy0,
               const void* dxdy0, void* out_abs, void* out_rel, void* hc, long long n_rows,
               long long m_rows, int num_gens, int h_dim, int hid_dim, int in_dim,
               int pred_len, int fmt, int per_gen, void* stream) {
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = allow_smem(decode_all_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  if ((err = persistent_blocks(decode_all_fwd_kernel<T>, kFwdThreads, smem, n_rows * num_gens,
                               &blocks)) != cudaSuccess)
    return (int)err;
  decode_all_fwd_kernel<T><<<(unsigned)blocks, kFwdThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (float*)out_abs, (float*)out_rel, (float*)hc,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len,
      fmt, per_gen);
  return (int)cudaGetLastError();
}


using FwdKernel = decltype(&decode_all_fwd_tiled_kernel<1, 0, 0>);

// The tiled K2 for R rows a warp (1, 2 or 4), the flagship's widths fixed at
// compile time where they apply; null for another R.
inline FwdKernel fwd_tiled_kernel(int rows_per_warp, int h, int hid) {
  const bool flagship = h == 32 && hid == 16;
  switch (rows_per_warp) {
    case 1: return flagship ? decode_all_fwd_tiled_kernel<1, 32, 16> : decode_all_fwd_tiled_kernel<1, 0, 0>;
    case 2: return flagship ? decode_all_fwd_tiled_kernel<2, 32, 16> : decode_all_fwd_tiled_kernel<2, 0, 0>;
    case 4: return flagship ? decode_all_fwd_tiled_kernel<4, 32, 16> : decode_all_fwd_tiled_kernel<4, 0, 0>;
    default: return nullptr;
  }
}

inline size_t fwd_tiled_smem(int rows_per_warp, int h, int pred_len, int per_gen) {
  return sizeof(float) *
         ((size_t)per_gen + (size_t)kFwdWarps * tile_stage_floats(rows_per_warp, h, pred_len));
}


using MmaFwdKernel = decltype(&decode_all_fwd_mma_kernel<4>);

// K2-bf16's launch variants (decode_all.py::MMA_BLOCKS_PER_SM, in this
// order): the blocks an SM the registers must allow, 4 (118 registers, no
// spill) or 5 (96, a few spilled).
inline MmaFwdKernel mma_fwd_kernel(int variant) {
  switch (variant) {
    case 0: return decode_all_fwd_mma_kernel<4>;
    case 1: return decode_all_fwd_mma_kernel<5>;
    default: return nullptr;
  }
}

using BwdKernel = decltype(&decode_all_bwd_warp_kernel);

// K3's kernel for variant 0 (tiled: the flagship widths' instantiation
// where they apply) or 1 (warp-per-row baseline); null for an input width
// the tiled sweep does not take.
inline BwdKernel bwd_kernel(int variant, int h, int hid, int in) {
  if (variant != 0) return decode_all_bwd_warp_kernel;
  const bool flagship = h == 32 && hid == 16;
  if (in == 2) return flagship ? decode_all_bwd_kernel<2, 32, 16> : decode_all_bwd_kernel<2, 0, 0>;
  if (in == 4) return flagship ? decode_all_bwd_kernel<4, 32, 16> : decode_all_bwd_kernel<4, 0, 0>;
  return nullptr;
}

// Warps a block and shared-memory bytes a block of K3's variant 0 (tiled)
// or 1 (warp-per-row baseline).
inline cudaError_t bwd_config(int variant, int h, int hid, int in, int per_gen, int* warps,
                              long long* smem) {
  if (variant != 0) {
    *warps = kWarpBwdWarps;
    *smem = (long long)warp_bwd_smem_bytes(h, hid, in, per_gen);
    return cudaSuccess;
  }
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *warps = kBwdWarps;
  *smem = (long long)bwd_smem_bytes(h, hid, in, per_gen);
  return *smem <= max_smem ? cudaSuccess : cudaErrorInvalidConfiguration;
}

int launch_bwd(int variant, const void* wpack, const void* h0, const void* socb,
               const void* xy0, const void* dxdy0, const void* out_abs, const void* out_rel,
               const void* hc, const void* g_abs, const void* g_rel, void* d_h0, void* d_xy0,
               void* d_dxdy0, void* d_socb, void* partials, void* dw, long long n_rows,
               long long m_rows, int num_gens, int h_dim, int hid_dim, int in_dim,
               int pred_len, int fmt, int per_gen, int blocks_per_gen, void* stream) {
  int warps = 0;
  long long smem = 0;
  cudaError_t err = bwd_config(variant, h_dim, hid_dim, in_dim, per_gen, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  const BwdKernel kernel = bwd_kernel(variant, h_dim, hid_dim, in_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(kernel, (size_t)smem)) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_per_gen, (unsigned)num_gens);
  kernel<<<grid, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const float*)out_abs, (const float*)out_rel,
      (const float*)hc, (const float*)g_abs, (const float*)g_rel, (float*)d_h0,
      (float*)d_xy0, (float*)d_dxdy0, (float*)d_socb, (float*)partials,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len,
      fmt, per_gen);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int size = GradLayout(h_dim, hid_dim, in_dim).size;
  const int total = num_gens * size, threads = 256;
  decode_all_wgrad_reduce<<<(total + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>((const float*)partials, (float*)dw,
                                                    blocks_per_gen, size, num_gens);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in one generator's weight-grad image (GradLayout above).
int mggan_decode_all_grad_floats(int h_dim, int hid_dim, int in_dim) {
  return GradLayout(h_dim, hid_dim, in_dim).size;
}

// K3's launch shape: variant 0 the tiled sweep (kBwdWarps warps a block),
// 1 the warp-per-row baseline (kWarpBwdWarps). Writes the warps a block, the
// shared-memory bytes a block and the resident warps per SM; returns a CUDA
// error code (cudaErrorInvalidConfiguration if a block does not fit).
int mggan_decode_all_bwd_config(int variant, int h_dim, int hid_dim, int in_dim, int per_gen,
                                int* warps, long long* smem, int* warps_per_sm) {
  cudaError_t err = bwd_config(variant, h_dim, hid_dim, in_dim, per_gen, warps, smem);
  if (err != cudaSuccess) return (int)err;
  const BwdKernel kernel = bwd_kernel(variant, h_dim, hid_dim, in_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, *warps * 32, (size_t)*smem, warps_per_sm);
}

// K2 on `stream` with the f32 weight image: the tiled kernel over
// (blocks_per_gen, G) blocks, rows_per_warp (1, 2 or 4) rows a warp; hc may
// be null (no residuals). Returns cudaGetLastError() after the launch (0 on
// success); the caller checks shapes and picks the launch
// (decode_all.py::fwd_launch).
int mggan_decode_all_fwd(const void* wpack, const void* h0, const void* socb,
                         const void* xy0, const void* dxdy0, void* out_abs,
                         void* out_rel, void* hc, long long n_rows, long long m_rows,
                         int num_gens, int h_dim, int hid_dim, int in_dim,
                         int pred_len, int fmt, int per_gen, int rows_per_warp,
                         int blocks_per_gen, void* stream) {
  const FwdKernel kernel = fwd_tiled_kernel(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr || blocks_per_gen < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_tiled_smem(rows_per_warp, h_dim, pred_len, per_gen);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_per_gen, (unsigned)num_gens);
  kernel<<<grid, kFwdTiledThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (float*)out_abs, (float*)out_rel, (float*)hc, (int64_t)n_rows,
      (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt, per_gen);
  return (int)cudaGetLastError();
}

// Resident warps per SM of the tiled K2 for R = rows_per_warp at these
// widths; returns a CUDA error code.
int mggan_decode_all_fwd_warps_per_sm(int rows_per_warp, int h_dim, int hid_dim, int pred_len,
                                      int per_gen, int* warps) {
  const FwdKernel kernel = fwd_tiled_kernel(rows_per_warp, h_dim, hid_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kFwdTiledThreads,
                             fwd_tiled_smem(rows_per_warp, h_dim, pred_len, per_gen), warps);
}

// The warp-per-row K2 that the tiled one replaced, with the f32 weight
// image (the yardstick; no path launches it); hc may be null.
int mggan_decode_all_fwd_warp(const void* wpack, const void* h0, const void* socb,
                              const void* xy0, const void* dxdy0, void* out_abs,
                              void* out_rel, void* hc, long long n_rows, long long m_rows,
                              int num_gens, int h_dim, int hid_dim, int in_dim,
                              int pred_len, int fmt, int per_gen, void* stream) {
  return launch_fwd<float>(wpack, h0, socb, xy0, dxdy0, out_abs, out_rel, hc, n_rows,
                           m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
                           per_gen, stream);
}

// Resident warps per SM of the warp-per-row K2 with the f32 image.
int mggan_decode_all_fwd_warp_warps_per_sm(int num_gens, int per_gen, int* warps) {
  return (int)resident_warps(decode_all_fwd_kernel<float>, kFwdThreads,
                             (size_t)num_gens * per_gen * sizeof(float), warps);
}

// K2-bf16 (compute_dtype=bfloat16) on `stream` with the fragment image
// `wimg` (G, image words; decoder.py::mma_weights) over (blocks_per_gen, G)
// blocks of launch variant `variant` (mma_fwd_kernel); hc may be null.
// Returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes (H, hid <= 32, in <= 8) and picks the launch
// (decode_all.py::mma_launch).
int mggan_decode_all_fwd_bf16(const void* wimg, const void* h0, const void* socb,
                              const void* xy0, const void* dxdy0, void* out_abs,
                              void* out_rel, void* hc, long long n_rows, long long m_rows,
                              int num_gens, int h_dim, int hid_dim, int in_dim,
                              int pred_len, int fmt, int variant, int blocks_per_gen,
                              void* stream) {
  const MmaFwdKernel kernel = mma_fwd_kernel(variant);
  if (kernel == nullptr || blocks_per_gen < 1 || h_dim > 32 || hid_dim > 32 || in_dim > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kImageWords * sizeof(float);
  const dim3 grid((unsigned)blocks_per_gen, (unsigned)num_gens);
  kernel<<<grid, kMmaFwdThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wimg, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (float*)out_abs, (float*)out_rel, (float*)hc, (int64_t)n_rows,
      (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt);
  return (int)cudaGetLastError();
}

// Resident warps per SM of K2-bf16's launch variant `variant`.
int mggan_decode_all_fwd_bf16_warps_per_sm(int variant, int* warps) {
  const MmaFwdKernel kernel = mma_fwd_kernel(variant);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kMmaFwdThreads, kImageWords * sizeof(float), warps);
}

// The warp-per-row K2 on the bf16 weight image, the kernel K2-bf16's
// tensor-core design replaced (the yardstick; no path launches it); hc may
// be null.
int mggan_decode_all_fwd_bf16_warp(const void* wpack, const void* h0, const void* socb,
                                   const void* xy0, const void* dxdy0, void* out_abs,
                                   void* out_rel, void* hc, long long n_rows, long long m_rows,
                                   int num_gens, int h_dim, int hid_dim, int in_dim,
                                   int pred_len, int fmt, int per_gen, void* stream) {
  return launch_fwd<__nv_bfloat16>(wpack, h0, socb, xy0, dxdy0, out_abs, out_rel, hc,
                                   n_rows, m_rows, num_gens, h_dim, hid_dim, in_dim,
                                   pred_len, fmt, per_gen, stream);
}

// Resident warps per SM of the warp-per-row K2 with the bf16 image.
int mggan_decode_all_fwd_bf16_warp_warps_per_sm(int num_gens, int per_gen, int* warps) {
  return (int)resident_warps(decode_all_fwd_kernel<__nv_bfloat16>, kFwdThreads,
                             (size_t)num_gens * per_gen * sizeof(float), warps);
}

#define MGGAN_BWD_ENTRY(name, variant)                                                        \
  int name(const void* wpack, const void* h0, const void* socb, const void* xy0,              \
           const void* dxdy0, const void* out_abs, const void* out_rel, const void* hc,       \
           const void* g_abs, const void* g_rel, void* d_h0, void* d_xy0, void* d_dxdy0,      \
           void* d_socb, void* partials, void* dw, long long n_rows, long long m_rows,        \
           int num_gens, int h_dim, int hid_dim, int in_dim, int pred_len, int fmt,           \
           int per_gen, int blocks_per_gen, void* stream) {                                   \
    return launch_bwd(variant, wpack, h0, socb, xy0, dxdy0, out_abs, out_rel, hc, g_abs,      \
                      g_rel, d_h0, d_xy0, d_dxdy0, d_socb, partials, dw, n_rows, m_rows,      \
                      num_gens, h_dim, hid_dim, in_dim, pred_len, fmt, per_gen,               \
                      blocks_per_gen, stream);                                                \
  }

// K3 on `stream`: the sweep over (blocks_per_gen, G) blocks into partials
// (G, blocks_per_gen, P), then their fixed-order sum into dw (G, P): the
// tiled sweep (mggan_decode_all_bwd, every main path) or the warp-per-row
// baseline (mggan_decode_all_bwd_warp, for comparison only).
MGGAN_BWD_ENTRY(mggan_decode_all_bwd, 0)
MGGAN_BWD_ENTRY(mggan_decode_all_bwd_warp, 1)

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
