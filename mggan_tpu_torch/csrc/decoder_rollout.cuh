// One warp's autoregressive decoder rollout, shared by the forward kernels
// decode_select.cu (K1, and K5 as rollout_row2), decode_all.cu (K2),
// decode_sorted.cu (K4) and decode_ablation.cu (B1), and the helpers the
// reverse sweep (K3) uses too.
//
// Per-generator weight block in shared memory (the wrapper packs it this
// way, ops/kernels/decoder.py::kernel_weights), in one of two images:
//
// f32, in floats:
//   whh  [H][H][4]   recurrent weights, [k][j][gate i,f,g,o]
//   wemb [in][H][4]  spatial embedding folded into the input weights
//   b    [H][4]      fused bias
//   w1   [H][hid]    hidden2pos first layer, h part
//   w2   [hid][2]    hidden2pos second layer
//   b2   [2]
// padded to a multiple of 4 floats (per_gen).
//
// bf16 (compute_dtype=bfloat16), in 4-byte words: the matrix operands in
// bf16, in the same orders, then the rest in f32:
//   whh [H][H][4] | wemb [in][H][4] | w1 [H][hid]   bf16, padded to 8 values
//   b [H][4] | w2 [hid][2] | b2 [2]                 f32
// padded to a multiple of 4 words (per_gen). A lane's four gate weights are
// one 8-byte load, and the image is half the f32 one.
//
// Lane j owns hidden unit j (H <= 32); lanes >= H or >= hid hold zeros and
// still join every shuffle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mggan {

constexpr unsigned kFull = 0xffffffffu;

enum Format { kRel = 0, kAbs = 1, kAbsRel = 2 };

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The gate activations of the rollouts (rollout_row, rollout_row2 and
// rollout_tile.cuh::rollout_tile), as policies: the kernels' own
// (ActExact: sigmoid, tanhf) and the two of the activation ablation B1
// (decode_ablation.cu, benchmarks/decode_ablation.py:52-63):
//   ActBf16  in bf16 arithmetic, rounded where the TPU script rounds: the
//            input to bf16, then exp, the add or subtract and the divide
//            each to bf16: sig(x) = 1 / (1 + exp(-x)),
//            tnh(x) = (exp(2x) - 1) / (exp(2x) + 1);
//   ActLin   x * 0.25 + 0.5 and x * 0.5: wrong numerics by design, the
//            rollout with activations that cost one FMA or multiply.
// cell(sf, c, si, tg) is the cell update sf * c + si * tg. ActExact leaves
// its contraction to the compiler, which gives every rollout template the
// same fmaf (the templates agree bit for bit); for the other policies it
// picked differently in two templates, so they spell out one.
struct ActExact {
  static __device__ __forceinline__ float sig(float x) { return sigmoid(x); }
  static __device__ __forceinline__ float tnh(float x) { return tanhf(x); }
  static __device__ __forceinline__ float cell(float sf, float c, float si, float tg) {
    return sf * c + si * tg;
  }
};

// The cell update with one fixed rounding: fmaf(sf, c, si * tg).
__device__ __forceinline__ float cell_fixed(float sf, float c, float si, float tg) {
  return fmaf(sf, c, __fmul_rn(si, tg));
}

struct ActBf16 {
  static __device__ __forceinline__ float sig(float x) {
    const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
    const __nv_bfloat16 e = hexp(__hneg(__float2bfloat16_rn(x)));
    return __bfloat162float(__hdiv(one, __hadd(one, e)));
  }
  static __device__ __forceinline__ float tnh(float x) {
    const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
    const __nv_bfloat16 xb = __float2bfloat16_rn(x);
    const __nv_bfloat16 e = hexp(__hadd(xb, xb));
    return __bfloat162float(__hdiv(__hsub(e, one), __hadd(e, one)));
  }
  static __device__ __forceinline__ float cell(float sf, float c, float si, float tg) {
    return cell_fixed(sf, c, si, tg);
  }
};

struct ActLin {
  static __device__ __forceinline__ float sig(float x) { return x * 0.25f + 0.5f; }
  static __device__ __forceinline__ float tnh(float x) { return x * 0.5f; }
  static __device__ __forceinline__ float cell(float sf, float c, float si, float tg) {
    return cell_fixed(sf, c, si, tg);
  }
};

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// Offsets of the parts of one generator's f32 weight block, in floats.
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

// The matrix operands' type T: float (f32 image) or __nv_bfloat16 (bf16
// image). Quad<T> is a lane's four gate weights as one load.
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f32(const float4& q) { return q; }
// bf16 -> f32 is the 16 bits moved to the top; little-endian, so .x holds
// gates i (low half) and f, .y gates g and o.
__device__ __forceinline__ float4 to_f32(const uint2& q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// An operand of a product with T weights, rounded as the TPU kernels round
// it (``x.astype(compute_dtype)``): unchanged for f32, to the nearest bf16
// (ties to even) for bf16. Products of two bf16 values are exact in f32,
// and fmaf accumulates in f32, as ``preferred_element_type=f32`` does.
template <typename T> __device__ __forceinline__ float operand(float x);
template <> __device__ __forceinline__ float operand<float>(float x) { return x; }
template <> __device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Pointers into one generator's block of either image.
template <typename T>
struct Weights {
  using Q = typename Quad<T>::type;
  const Q* whh;      // [k][j] quads
  const Q* wemb;     // [i][j] quads
  const T* w1;       // [k][q]
  const float4* b;   // [j]
  const float* w2;   // [q][2]
  const float* b2;   // [2]
};

// Words of the bf16 part of the bf16 image: (H*H*4 + in*H*4 + H*hid) values
// padded to 8 (16 bytes), two to a word.
__host__ __device__ __forceinline__ int bf16_part_words(int h, int hid, int in) {
  return ((h * h * 4 + in * h * 4 + h * hid + 7) & ~7) / 2;
}

template <typename T> __device__ Weights<T> weights_at(const float* W, const Layout& L);

template <>
__device__ __forceinline__ Weights<float> weights_at<float>(const float* W, const Layout& L) {
  return {reinterpret_cast<const float4*>(W), reinterpret_cast<const float4*>(W + L.wemb),
          W + L.w1, reinterpret_cast<const float4*>(W + L.b), W + L.w2, W + L.b2};
}

template <>
__device__ __forceinline__ Weights<__nv_bfloat16> weights_at<__nv_bfloat16>(const float* W,
                                                                            const Layout& L) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(W);
  const float* f = W + bf16_part_words(L.h, L.hid, L.in);
  return {reinterpret_cast<const uint2*>(v), reinterpret_cast<const uint2*>(v + L.h * L.h * 4),
          v + (L.h + L.in) * L.h * 4, reinterpret_cast<const float4*>(f), f + L.h * 4,
          f + L.h * 4 + L.hid * 2};
}

// The decoder input te of one step times the folded input weights, added
// into acc: te = dxdy (rel), xy (abs) or [x y dx dy] (abs_rel), each value
// rounded as an operand of T.
template <typename T, typename Q>
__device__ __forceinline__ void add_input(float4& acc, const Q* wemb, const Layout& L,
                                          int lane, float x, float y, float dx, float dy) {
  if (L.fmt == kAbsRel) {
    fma4(acc, operand<T>(x), to_f32(wemb[lane]));
    fma4(acc, operand<T>(y), to_f32(wemb[L.h + lane]));
    fma4(acc, operand<T>(dx), to_f32(wemb[2 * L.h + lane]));
    fma4(acc, operand<T>(dy), to_f32(wemb[3 * L.h + lane]));
  } else {
    fma4(acc, operand<T>(L.fmt == kRel ? dx : x), to_f32(wemb[lane]));
    fma4(acc, operand<T>(L.fmt == kRel ? dy : y), to_f32(wemb[L.h + lane]));
  }
}

// Rolls out one row with generator weights W (shared memory, image of T):
//   gates = te @ Wemb' + h @ Whh + b;  c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)
//   hid = LeakyReLU_0.01(h @ W1h + sb);  nd = hid @ W2 + b2;  xy += nd;  dxdy = nd
// from h0 = h, c0 = 0, and stores abs = xy and rel = nd of every step at
// abs_row / rel_row (pred_len float2 each). With hc_row it also stores each
// step's h and c there, [t][h | c][H]: two coalesced stores per step.
//
// With T = bf16 the operands of the products with bf16 weights (te, h0,
// every step's h, hid) are rounded to bf16 and everything else (c, b, sb,
// W2, b2, the position sums, every accumulation) stays f32: the arithmetic
// of the TPU kernels with compute_dtype=bfloat16.
//
// Lane t keeps step t's outputs, so each row's outputs are one coalesced
// store at the end. One sweep over the new h per step feeds both hidden2pos
// (lanes < hid) and the next step's recurrent gates. Act supplies sig and
// tnh (ActExact: sigmoid and tanhf).
template <typename T, typename Act = ActExact>
__device__ __forceinline__ void rollout_row(const float* W, const Layout& L, int lane,
                                            float h, float x, float y, float dx, float dy,
                                            float sb, float* abs_row, float* rel_row,
                                            float* hc_row) {
  const bool own = lane < L.h;
  const bool own_hid = lane < L.hid;
  const Weights<T> w = weights_at<T>(W, L);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bias = own ? w.b[lane] : zero4;
  const float w2x = own_hid ? w.w2[lane * 2] : 0.f;
  const float w2y = own_hid ? w.w2[lane * 2 + 1] : 0.f;
  const float b2x = w.b2[0], b2y = w.b2[1];
  float c = 0.f;
  h = operand<T>(h);

  // recurrent part of the first step's gates: h0 @ Whh
  float4 rec = zero4;
  for (int k = 0; k < L.h; ++k) {
    const float hk = __shfl_sync(kFull, h, k);
    if (own) fma4(rec, hk, to_f32(w.whh[k * L.h + lane]));
  }

  float keep_x = 0.f, keep_y = 0.f, keep_dx = 0.f, keep_dy = 0.f;
  for (int t = 0; t < L.pred_len; ++t) {
    float4 acc = rec;
    acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
    if (own) {
      add_input<T>(acc, w.wemb, L, lane, x, y, dx, dy);
      c = Act::cell(Act::sig(acc.y), c, Act::sig(acc.x), Act::tnh(acc.z));
      h = operand<T>(Act::sig(acc.w) * Act::tnh(c));
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
      if (own_hid) a = fmaf(hk, to_f32(w.w1[k * L.hid + lane]), a);
      if (more && own) fma4(rec, hk, to_f32(w.whh[k * L.h + lane]));
    }
    a = operand<T>(a > 0.f ? a : 0.01f * a);
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

// rollout_row for two rows r = 0, 1 at once, each on its own generator's
// weights W[r] (K5, the TPU kernel _fwd_select_kernel_ilp): every operation
// of a step is issued for both rows before the next, so the two rows'
// independent shuffles, loads and FMAs interleave and each hides the
// other's latency. Per row, the operations and their order are those of
// rollout_row, so each row's output is bit-identical to it. No hc.
template <typename T, typename Act = ActExact>
__device__ __forceinline__ void rollout_row2(const float* const W[2], const Layout& L, int lane,
                                             const float h0[2], const float x0[2],
                                             const float y0[2], const float dx0[2],
                                             const float dy0[2], const float sb[2],
                                             float* const abs_row[2], float* const rel_row[2]) {
  const bool own = lane < L.h;
  const bool own_hid = lane < L.hid;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  Weights<T> w[2];
  float4 bias[2], rec[2];
  float w2x[2], w2y[2], b2x[2], b2y[2], c[2], h[2], x[2], y[2], dx[2], dy[2];
  float keep_x[2], keep_y[2], keep_dx[2], keep_dy[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w[r] = weights_at<T>(W[r], L);
    bias[r] = own ? w[r].b[lane] : zero4;
    w2x[r] = own_hid ? w[r].w2[lane * 2] : 0.f;
    w2y[r] = own_hid ? w[r].w2[lane * 2 + 1] : 0.f;
    b2x[r] = w[r].b2[0];
    b2y[r] = w[r].b2[1];
    c[r] = 0.f;
    h[r] = operand<T>(h0[r]);
    x[r] = x0[r]; y[r] = y0[r]; dx[r] = dx0[r]; dy[r] = dy0[r];
    keep_x[r] = keep_y[r] = keep_dx[r] = keep_dy[r] = 0.f;
    rec[r] = zero4;
  }
  for (int k = 0; k < L.h; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float hk = __shfl_sync(kFull, h[r], k);
      if (own) fma4(rec[r], hk, to_f32(w[r].whh[k * L.h + lane]));
    }
  }

  for (int t = 0; t < L.pred_len; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float4 acc = rec[r];
      acc.x += bias[r].x; acc.y += bias[r].y; acc.z += bias[r].z; acc.w += bias[r].w;
      if (own) {
        add_input<T>(acc, w[r].wemb, L, lane, x[r], y[r], dx[r], dy[r]);
        c[r] = Act::cell(Act::sig(acc.y), c[r], Act::sig(acc.x), Act::tnh(acc.z));
        h[r] = operand<T>(Act::sig(acc.w) * Act::tnh(c[r]));
      }
    }
    const bool more = t + 1 < L.pred_len;
    float a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = sb[r];
      rec[r] = zero4;
    }
    for (int k = 0; k < L.h; ++k) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float hk = __shfl_sync(kFull, h[r], k);
        if (own_hid) a[r] = fmaf(hk, to_f32(w[r].w1[k * L.hid + lane]), a[r]);
        if (more && own) fma4(rec[r], hk, to_f32(w[r].whh[k * L.h + lane]));
      }
    }
    float px[2], py[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = operand<T>(a[r] > 0.f ? a[r] : 0.01f * a[r]);
      px[r] = own_hid ? a[r] * w2x[r] : 0.f;
      py[r] = own_hid ? a[r] * w2y[r] : 0.f;
    }
    for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        px[r] += __shfl_xor_sync(kFull, px[r], s);
        py[r] += __shfl_xor_sync(kFull, py[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dx[r] = px[r] + b2x[r];
      dy[r] = py[r] + b2y[r];
      x[r] += dx[r];
      y[r] += dy[r];
      if (lane == t) { keep_x[r] = x[r]; keep_y[r] = y[r]; keep_dx[r] = dx[r]; keep_dy[r] = dy[r]; }
    }
  }
  if (lane < L.pred_len) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      reinterpret_cast<float2*>(abs_row[r])[lane] = make_float2(keep_x[r], keep_y[r]);
      reinterpret_cast<float2*>(rel_row[r])[lane] = make_float2(keep_dx[r], keep_dy[r]);
    }
  }
}

// Copy `words` 4-byte words (a multiple of 4) of weights from device
// memory into the block's shared memory, 16 bytes a thread at a time, and
// wait for the whole block.
__device__ __forceinline__ void stage_weights(float4* smem4, const float* src, int words) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) smem4[i] = src4[i];
  __syncthreads();
}

// The fused-selection row loop of K1 (decode_select.cu), also B1's
// (decode_ablation.cu) on other activation policies: stage all G weight
// blocks (num_gens * per_gen 4-byte words, either image of T) into shared
// memory, then warps stride over rows; row n runs its sampled generator
// idx[n] on row n % M of xy0, dxdy0 and socb. A row with no generator
// (idx out of range) is poisoned with NaN.
template <typename T, typename Act = ActExact>
__device__ __forceinline__ void select_rows(float4* smem4, const float* __restrict__ wpack,
                                            const float* __restrict__ h0,
                                            const float* __restrict__ socb,
                                            const float* __restrict__ xy0,
                                            const float* __restrict__ dxdy0,
                                            const int32_t* __restrict__ idx,
                                            float* __restrict__ out_abs,
                                            float* __restrict__ out_rel, int64_t n_rows,
                                            int64_t m_rows, int num_gens, const Layout& L,
                                            int per_gen) {
  float* smem = reinterpret_cast<float*>(smem4);
  stage_weights(smem4, wpack, num_gens * per_gen);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const float nan = __int_as_float(0x7fc00000);

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       row < n_rows; row += (int64_t)gridDim.x * warps) {
    const int g = idx[row];
    const int64_t m = row % m_rows;
    float* abs_row = out_abs + row * L.pred_len * 2;
    float* rel_row = out_rel + row * L.pred_len * 2;
    if (g < 0 || g >= num_gens) {  // no generator selected: poison the row
      for (int q = lane; q < L.pred_len * 2; q += 32) {
        abs_row[q] = nan;
        rel_row[q] = nan;
      }
      continue;
    }
    const float sb = lane < L.hid ? socb[(m * num_gens + g) * L.hid + lane] : 0.f;
    const float h = lane < L.h ? h0[row * L.h + lane] : 0.f;
    rollout_row<T, Act>(smem + (int64_t)g * per_gen, L, lane, h, xy0[m * 2], xy0[m * 2 + 1],
                        dxdy0[m * 2], dxdy0[m * 2 + 1], sb, abs_row, rel_row, nullptr);
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

// Blocks of a persistent grid of `kernel` over `items` warp-sized work
// items: one block per threads / 32 items, at most as many as fit on the
// card at once. Fails if the kernel fits on no SM.
template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem, long long items,
                                     long long* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long warps = threads / 32;
  const long long b = (items + warps - 1) / warps;
  const long long resident = (long long)sms * per_sm;
  *blocks = b > resident ? resident : b;
  return cudaSuccess;
}

// Resident warps per SM of `kernel` at `threads` threads and `smem` bytes
// of dynamic shared memory a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename Kernel>
inline cudaError_t resident_warps(Kernel kernel, int threads, size_t smem, int* warps) {
  int per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *warps = per_sm * (threads / 32);
  return err;
}

}  // namespace mggan
