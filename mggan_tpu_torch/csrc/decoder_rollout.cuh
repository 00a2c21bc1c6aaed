// One warp's autoregressive decoder rollout, shared by the forward kernels
// decode_select.cu (K1) and decode_all.cu (K2), and the helpers the reverse
// sweep (K3) uses too.
//
// Per-generator weight block in shared memory, in floats (the wrapper packs
// it this way, ops/kernels/decoder.py::kernel_weights):
//   whh  [H][H][4]   recurrent weights, [k][j][gate i,f,g,o]
//   wemb [in][H][4]  spatial embedding folded into the input weights
//   b    [H][4]      fused bias
//   w1   [H][hid]    hidden2pos first layer, h part
//   w2   [hid][2]    hidden2pos second layer
//   b2   [2]
// padded to a multiple of 4 floats (per_gen). Lane j owns hidden unit j
// (H <= 32); lanes >= H or >= hid hold zeros and still join every shuffle.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mggan {

constexpr unsigned kFull = 0xffffffffu;

enum Format { kRel = 0, kAbs = 1, kAbsRel = 2 };

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// Offsets of the parts of one generator's weight block, in floats.
struct Layout {
  int h, hid, in, pred_len, fmt;
  int wemb, b, w1, w2, b2;

  __device__ __forceinline__ Layout(int h_dim, int hid_dim, int in_dim, int t, int f)
      : h(h_dim), hid(hid_dim), in(in_dim), pred_len(t), fmt(f) {
    wemb = h * h * 4;
    b = wemb + in * h * 4;
    w1 = b + h * 4;
    w2 = w1 + h * hid;
    b2 = w2 + hid * 2;
  }
};

// The decoder input te of one step times the folded input weights, added
// into acc: te = dxdy (rel), xy (abs) or [x y dx dy] (abs_rel).
__device__ __forceinline__ void add_input(float4& acc, const float4* wemb4, const Layout& L,
                                          int lane, float x, float y, float dx, float dy) {
  if (L.fmt == kAbsRel) {
    fma4(acc, x, wemb4[lane]);
    fma4(acc, y, wemb4[L.h + lane]);
    fma4(acc, dx, wemb4[2 * L.h + lane]);
    fma4(acc, dy, wemb4[3 * L.h + lane]);
  } else {
    fma4(acc, L.fmt == kRel ? dx : x, wemb4[lane]);
    fma4(acc, L.fmt == kRel ? dy : y, wemb4[L.h + lane]);
  }
}

// Rolls out one row with generator weights W (shared memory):
//   gates = te @ Wemb' + h @ Whh + b;  c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)
//   hid = LeakyReLU_0.01(h @ W1h + sb);  nd = hid @ W2 + b2;  xy += nd;  dxdy = nd
// from h0 = h, c0 = 0, and stores abs = xy and rel = nd of every step at
// abs_row / rel_row (pred_len float2 each). With hc_row it also stores each
// step's h and c there, [t][h | c][H]: two coalesced stores per step.
//
// Lane t keeps step t's outputs, so each row's outputs are one coalesced
// store at the end. One sweep over the new h per step feeds both hidden2pos
// (lanes < hid) and the next step's recurrent gates.
__device__ __forceinline__ void rollout_row(const float* W, const Layout& L, int lane,
                                            float h, float x, float y, float dx, float dy,
                                            float sb, float* abs_row, float* rel_row,
                                            float* hc_row) {
  const bool own = lane < L.h;
  const bool own_hid = lane < L.hid;
  const float4* whh4 = reinterpret_cast<const float4*>(W);
  const float4* wemb4 = reinterpret_cast<const float4*>(W + L.wemb);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bias = own ? reinterpret_cast<const float4*>(W + L.b)[lane] : zero4;
  const float w2x = own_hid ? W[L.w2 + lane * 2] : 0.f;
  const float w2y = own_hid ? W[L.w2 + lane * 2 + 1] : 0.f;
  const float b2x = W[L.b2], b2y = W[L.b2 + 1];
  float c = 0.f;

  // recurrent part of the first step's gates: h0 @ Whh
  float4 rec = zero4;
  for (int k = 0; k < L.h; ++k) {
    const float hk = __shfl_sync(kFull, h, k);
    if (own) fma4(rec, hk, whh4[k * L.h + lane]);
  }

  float keep_x = 0.f, keep_y = 0.f, keep_dx = 0.f, keep_dy = 0.f;
  for (int t = 0; t < L.pred_len; ++t) {
    float4 acc = rec;
    acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
    if (own) {
      add_input(acc, wemb4, L, lane, x, y, dx, dy);
      c = sigmoid(acc.y) * c + sigmoid(acc.x) * tanhf(acc.z);
      h = sigmoid(acc.w) * tanhf(c);
      if (hc_row != nullptr) {
        hc_row[t * 2 * L.h + lane] = h;
        hc_row[t * 2 * L.h + L.h + lane] = c;
      }
    }

    // one sweep over the new h: hidden2pos now, recurrent gates for t + 1
    const bool more = t + 1 < L.pred_len;
    float a = sb;
    rec = zero4;
    for (int k = 0; k < L.h; ++k) {
      const float hk = __shfl_sync(kFull, h, k);
      if (own_hid) a = fmaf(hk, W[L.w1 + k * L.hid + lane], a);
      if (more && own) fma4(rec, hk, whh4[k * L.h + lane]);
    }
    a = a > 0.f ? a : 0.01f * a;
    float px = own_hid ? a * w2x : 0.f;
    float py = own_hid ? a * w2y : 0.f;
    for (int s = 16; s > 0; s >>= 1) {
      px += __shfl_xor_sync(kFull, px, s);
      py += __shfl_xor_sync(kFull, py, s);
    }
    dx = px + b2x;
    dy = py + b2y;
    x += dx;
    y += dy;
    if (lane == t) { keep_x = x; keep_y = y; keep_dx = dx; keep_dy = dy; }
  }
  if (lane < L.pred_len) {
    reinterpret_cast<float2*>(abs_row)[lane] = make_float2(keep_x, keep_y);
    reinterpret_cast<float2*>(rel_row)[lane] = make_float2(keep_dx, keep_dy);
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace mggan
