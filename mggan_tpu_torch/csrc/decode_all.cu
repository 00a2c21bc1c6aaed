// All-generator decoder rollout (K2) and its reverse sweep (K3) for Hopper
// (sm_90a).
//
// K2 replaces mggan_tpu/ops/pallas/decoder.py::_fwd_kernel (via _decode_fwd
// and pallas_decode_all). It runs every generator g's rollout on every row n
// (the arithmetic of decoder_rollout.cuh) and stores abs/rel as (G, N, T, 2).
// For training it also stores each step's h and c as hc (G, N, T, 2, H), the
// residuals K3 recomputes the gates from. Its bf16 variant
// (mggan_decode_all_fwd_bf16, the TPU kernel's compute_dtype=bfloat16) runs
// the same template on the bf16 weight image and may save hc too: h as the
// bf16-rounded value the next step's product reads (in f32), c in f32, as
// _fwd_kernel saves h.astype(f32) after .astype(compute_dtype). K3 then
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
// Design (simple, right first).
// * K2: a warp per (row, generator), K1's design with the generator taken
//   from the work index instead of a sampled index: lane j owns hidden unit
//   j, h is broadcast by __shfl_sync, all G generators' folded weights sit in
//   shared memory as [k][j][gate], the grid is persistent. The TPU kernel's
//   lane-packed block-diagonal layout was a vector-register choice and is
//   not carried over. With hc, each step adds two coalesced 128-byte stores.
// * K3: a block per (generator, slice of rows), 8 warps, a warp per row.
//   Each warp recomputes the step's gates from h_{t-1} (lane j's float4 of
//   gate pre-activations, as in the forward) and hidden2pos's pre-activation
//   from h_t, then back-propagates. The products with the transposed weights
//   (dgates @ Whh^T, dpre @ W1h^T) read transposed copies [j][k][gate] and
//   [q][k] built in shared memory at block start, so lane k's loads do not
//   conflict; dgates of lane j reach lane k by shuffles. dgates @ Wemb^T is a
//   warp reduction (in <= 4 values).
// * Weight grads without atomics, so two launches on the same inputs give
//   bit-identical sums: each warp accumulates its own partial dW in a
//   warp-private slice of shared memory (dWhh^T and dW1h^T, ~18 KB at H=32)
//   and registers (db, dWemb, dW2, db2); lane k only ever touches column k,
//   so the slice needs no synchronisation. At the end the block adds its
//   warps' slices in warp order and writes one partial per block; a second
//   kernel adds the blocks' partials in block order. Rows go to (block, warp)
//   by a fixed rule, so the order of every sum is fixed.
//
// What bounds them on the H100. Both are bound by operations in the roofline
// sense (K2 at 81,920 rows x 4 generators moves ~1.0 GB of hc for ~39 GFLOP;
// K3 reads it back for ~110 GFLOP of fp32 FMA work, 67 TFLOP/s on the CUDA
// cores), but this design is bound first by the shared-memory/shuffle pipe:
// every row-step re-reads its generator's weights (K2 ~17 KB, K3 ~50 KB with
// the read-modify-write of the dWhh^T slice) and K3 moves every dgates value
// by shuffle (4H shuffles a step). Reusing each weight load over several rows
// (a warp per group of rows of one generator, or the tensor cores at larger
// batches) is what a later change would do about it.

#include "decoder_rollout.cuh"

namespace {

using namespace mggan;

constexpr int kFwdThreads = 512;
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;

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

__host__ __device__ inline size_t bwd_smem_bytes(int h, int hid, int in, int per_gen) {
  return sizeof(float) * ((size_t)bwd_weight_floats(h, hid, per_gen) +
                          (size_t)kBwdWarps * round4(GradLayout(h, hid, in).size));
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

// grid (blocks_per_gen, G), kBwdThreads threads.
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
  for (int i = threadIdx.x; i < kBwdWarps * slice; i += blockDim.x) slices[i] = 0.f;
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

  for (int64_t row = (int64_t)blockIdx.x * kBwdWarps + warp; row < n_rows;
       row += (int64_t)gridDim.x * kBwdWarps) {
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
    for (int w = 0; w < kBwdWarps; ++w) s += slices[w * slice + e];
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

}  // namespace

extern "C" {

// Floats in one generator's weight-grad image (GradLayout above).
int mggan_decode_all_grad_floats(int h_dim, int hid_dim, int in_dim) {
  return GradLayout(h_dim, hid_dim, in_dim).size;
}

// Bytes of shared memory one K3 block needs.
long long mggan_decode_all_bwd_smem(int h_dim, int hid_dim, int in_dim, int per_gen) {
  return (long long)bwd_smem_bytes(h_dim, hid_dim, in_dim, per_gen);
}

// K2 on `stream` with the f32 weight image; hc may be null (no residuals).
// Returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes beforehand.
int mggan_decode_all_fwd(const void* wpack, const void* h0, const void* socb,
                         const void* xy0, const void* dxdy0, void* out_abs,
                         void* out_rel, void* hc, long long n_rows, long long m_rows,
                         int num_gens, int h_dim, int hid_dim, int in_dim,
                         int pred_len, int fmt, int per_gen, void* stream) {
  return launch_fwd<float>(wpack, h0, socb, xy0, dxdy0, out_abs, out_rel, hc, n_rows,
                           m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
                           per_gen, stream);
}

// K2 with the bf16 weight image (compute_dtype=bfloat16); hc may be null.
int mggan_decode_all_fwd_bf16(const void* wpack, const void* h0, const void* socb,
                              const void* xy0, const void* dxdy0, void* out_abs,
                              void* out_rel, void* hc, long long n_rows, long long m_rows,
                              int num_gens, int h_dim, int hid_dim, int in_dim,
                              int pred_len, int fmt, int per_gen, void* stream) {
  return launch_fwd<__nv_bfloat16>(wpack, h0, socb, xy0, dxdy0, out_abs, out_rel, hc,
                                   n_rows, m_rows, num_gens, h_dim, hid_dim, in_dim,
                                   pred_len, fmt, per_gen, stream);
}

// K3 on `stream`: the sweep over (blocks_per_gen, G) blocks into partials
// (G, blocks_per_gen, P), then their fixed-order sum into dw (G, P).
int mggan_decode_all_bwd(const void* wpack, const void* h0, const void* socb,
                         const void* xy0, const void* dxdy0, const void* out_abs,
                         const void* out_rel, const void* hc, const void* g_abs,
                         const void* g_rel, void* d_h0, void* d_xy0, void* d_dxdy0,
                         void* d_socb, void* partials, void* dw, long long n_rows,
                         long long m_rows, int num_gens, int h_dim, int hid_dim,
                         int in_dim, int pred_len, int fmt, int per_gen,
                         int blocks_per_gen, void* stream) {
  const size_t smem = bwd_smem_bytes(h_dim, hid_dim, in_dim, per_gen);
  cudaError_t err = allow_smem(decode_all_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_per_gen, (unsigned)num_gens);
  decode_all_bwd_kernel<<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
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

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
