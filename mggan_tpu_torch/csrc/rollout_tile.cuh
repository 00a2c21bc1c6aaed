// One warp's rollout of R rows of one generator, f32 on the CUDA cores:
// the row loop of the tiled K1 (select_tiled.cuh, decode_select_tiled.cu),
// the tiled K2 (decode_all.cu), the tiled B1 (decode_ablation.cu) and the
// tiled K4 (decode_sorted_tiled.cu); K5 (decode_select_tiled.cu) advances
// two such groups a warp.
//
// Lane j owns hidden unit j (lane q hidden2pos unit q) for all R rows, so
// every weight a lane reads from shared memory (a 16-byte [k][j][gate]
// quad of Whh, a W1h value) serves R rows' FMAs from registers. Each
// step's new h of the R rows goes once into the warp's staging buffer
// [r][k], and the lanes read it back as 16-byte broadcasts instead of a
// shuffle per unit and row.
//
// Per row, every operation is rollout_row's (decoder_rollout.cuh, f32
// image, the same activation policy) in rollout_row's order: the recurrent
// part summed by fma4 over k ascending from zero, then + bias, then
// add_input's FMAs, the gate expressions; hidden2pos summed over k
// ascending from socb, the same LeakyReLU and the same shuffle butterfly
// for nd. So each row's abs, rel and (h, c) are bit-identical to the
// warp-per-row kernels'.

#pragma once

#include "decoder_rollout.cuh"

namespace mggan {

__host__ __device__ inline int round4_floats(int x) { return (x + 3) & ~3; }

// Row stride of the warp's h staging: round4(H) + 4 floats, so that rows
// R/2 apart start 4 or 8 banks apart (the split hidden2pos below reads two
// rows at once, one per half-warp, without a bank conflict).
__host__ __device__ inline int tile_h_stride(int h) { return round4_floats(h) + 4; }

// Floats of one warp's staging area for R rows of H units and T steps:
// the new h [R][tile_h_stride(H)], then each step's (x, y, dx, dy) [R][T].
__host__ __device__ inline int tile_stage_floats(int rows, int h, int t) {
  return rows * tile_h_stride(h) + rows * t * 4;
}

// rec[r] (+)= h[r] @ Whh (kGates) for the R rows, and a[j] (+)= h[prow0 +
// j] @ W1h[:, wcol] for P rows (P = 0: none), over k ascending, h read from
// the staging buffer hs [r][hp]. wcol is the lane's hidden2pos unit (wown:
// it has one). P = R with prow0 = 0 reuses the gates' loads of h.
template <int R, bool kGates, int P>
__device__ __forceinline__ void tile_sweep(const float* __restrict__ hs, int hp,
                                           const float4* __restrict__ whh,
                                           const float* __restrict__ w1, int H, int hid,
                                           int lane, bool own, int wcol, bool wown, int prow0,
                                           float4 (&rec)[R], float (&a)[R]) {
  constexpr bool kShared = P == R;  // hidden2pos on the gates' rows
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = 0;
  for (; k + 4 <= H; k += 4) {
    float4 wg[4];
    float wp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kGates) wg[i] = own ? whh[(k + i) * H + lane] : zero4;
      if (P > 0) wp[i] = wown ? w1[(k + i) * hid + wcol] : 0.f;
    }
    if constexpr (kGates || kShared) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + r * hp + k);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kShared) a[r] = fmaf(hk[i], wp[i], a[r]);
          if (kGates) fma4(rec[r], hk[i], wg[i]);
        }
      }
    }
    if constexpr (P > 0 && !kShared) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (prow0 + j) * hp + k);
        a[j] = fmaf(hv.x, wp[0], a[j]);
        a[j] = fmaf(hv.y, wp[1], a[j]);
        a[j] = fmaf(hv.z, wp[2], a[j]);
        a[j] = fmaf(hv.w, wp[3], a[j]);
      }
    }
  }
  for (; k < H; ++k) {
    const float4 wg = kGates && own ? whh[k * H + lane] : zero4;
    const float wp = P > 0 && wown ? w1[k * hid + wcol] : 0.f;
    if constexpr (kGates || kShared) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hk = hs[r * hp + k];
        if (kShared) a[r] = fmaf(hk, wp, a[r]);
        if (kGates) fma4(rec[r], hk, wg);
      }
    }
    if constexpr (P > 0 && !kShared) {
#pragma unroll
      for (int j = 0; j < P; ++j) a[j] = fmaf(hs[(prow0 + j) * hp + k], wp, a[j]);
    }
  }
}

// Rolls out R rows of the generator whose f32 weight block is W (shared
// memory), the recurrence of rollout_row: from h = h0[r] (this lane's
// unit), c = 0, position (x0, y0) and offset (dx0, dy0), with socb[r] (this
// lane's hidden2pos unit). Row r's abs and rel go to row out_row[r] of
// out_abs / out_rel ((rows, T, 2) each) and, with hc, each step's h and c
// to row out_row[r] of hc ((rows, T, 2, H)); out_row[r] < 0 marks a padding
// row, which computes on whatever it was given and stores nothing.
// kH, kHid > 0 fix H and hid at compile time (0: from L). `stage` is the
// warp's tile_stage_floats(R, H, T) floats of shared memory. Act supplies
// the gate activations sig and tnh (ActExact, K1's and K2's: sigmoid and
// tanhf; B1 in decode_ablation.cu takes the others), applied as
// rollout_row<float, Act> applies them.
//
// With hid = 16 fixed and R even, hidden2pos is split over the half-warps:
// lane l takes unit l % 16 of rows (l / 16) R/2 ... (l / 16) R/2 + R/2 - 1,
// so no lane idles through W1h and each half-warp's butterfly sums one row
// at once. rollout_row's butterfly over 32 lanes first adds the zeros of
// lanes >= hid (x + 0, which turns -0 into +0), then sums within 16 lanes:
// the split adds that zero and runs the same four levels, so every row's
// sum is the same sum.
template <int R, int kH, int kHid, typename Act = ActExact>
__device__ __forceinline__ void rollout_tile(const float* __restrict__ W, const Layout& Lrt,
                                             int lane, float* __restrict__ stage,
                                             const float (&h0)[R], const float (&x0)[R],
                                             const float (&y0)[R], const float (&dx0)[R],
                                             const float (&dy0)[R], const float (&sb)[R],
                                             const int64_t (&out_row)[R],
                                             float* __restrict__ out_abs,
                                             float* __restrict__ out_rel,
                                             float* __restrict__ hc) {
  constexpr bool kSplit = kHid == 16 && R % 2 == 0;
  constexpr int P = kSplit ? R / 2 : R;  // hidden2pos rows of a lane
  const int H = kH > 0 ? kH : Lrt.h, hid = kHid > 0 ? kHid : Lrt.hid, T = Lrt.pred_len;
  const Layout L(H, hid, Lrt.in, T, Lrt.fmt);
  const int hp = tile_h_stride(H);
  const bool own = lane < H;
  const int wcol = kSplit ? lane & 15 : lane;  // the lane's hidden2pos unit
  const bool wown = kSplit || lane < hid;
  const int prow0 = kSplit ? (lane >> 4) * P : 0;  // its first hidden2pos row
  const Weights<float> w = weights_at<float>(W, L);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bias = own ? w.b[lane] : zero4;
  const float w2x = wown ? w.w2[wcol * 2] : 0.f;
  const float w2y = wown ? w.w2[wcol * 2 + 1] : 0.f;
  const float b2x = w.b2[0], b2y = w.b2[1];
  float* hs = stage;                                           // [r][hp]
  float4* os = reinterpret_cast<float4*>(stage + R * hp);      // [r][t]

  float c[R], x[R], y[R], dx[R], dy[R], a[R], sbp[R];
  float4 rec[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c[r] = 0.f;
    x[r] = x0[r]; y[r] = y0[r]; dx[r] = dx0[r]; dy[r] = dy0[r];
    rec[r] = zero4;
    a[r] = 0.f;
    sbp[r] = sb[r];
    if (own) hs[r * hp + lane] = h0[r];
  }
  if constexpr (kSplit) {  // socb of the lane's hidden2pos rows, from the lanes that hold it
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float lo = __shfl_sync(kFull, sb[j], wcol), hi = __shfl_sync(kFull, sb[P + j], wcol);
      sbp[j] = lane >> 4 ? hi : lo;
    }
  }
  __syncwarp();
  // recurrent part of the first step's gates: h0 @ Whh
  tile_sweep<R, true, 0>(hs, hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0, rec, a);

  for (int t = 0; t < T; ++t) {
    float h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4 acc = rec[r];
      acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
      h[r] = 0.f;
      if (own) {
        add_input<float>(acc, w.wemb, L, lane, x[r], y[r], dx[r], dy[r]);
        c[r] = Act::cell(Act::sig(acc.y), c[r], Act::sig(acc.x), Act::tnh(acc.z));
        h[r] = Act::sig(acc.w) * Act::tnh(c[r]);
        if (hc != nullptr && out_row[r] >= 0) {
          float* at = hc + (out_row[r] * T + t) * 2 * H;
          at[lane] = h[r];
          at[H + lane] = c[r];
        }
      }
    }
    __syncwarp();  // every lane has read the previous h
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (own) hs[r * hp + lane] = h[r];
    __syncwarp();

    // one sweep over the new h: hidden2pos now, recurrent gates for t + 1
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = sbp[r];
      rec[r] = zero4;
    }
    if (t + 1 < T)
      tile_sweep<R, true, P>(hs, hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0, rec, a);
    else
      tile_sweep<R, false, P>(hs, hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0, rec, a);
    if constexpr (kSplit) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float ar = a[j] > 0.f ? a[j] : 0.01f * a[j];
        float px = __fadd_rn(ar * w2x, 0.f);  // the first level: + the zero of lane l + 16
        float py = __fadd_rn(ar * w2y, 0.f);
        for (int s = 8; s > 0; s >>= 1) {
          px += __shfl_xor_sync(kFull, px, s);
          py += __shfl_xor_sync(kFull, py, s);
        }
        dx[j] = __shfl_sync(kFull, px, 0) + b2x;
        dy[j] = __shfl_sync(kFull, py, 0) + b2y;
        dx[P + j] = __shfl_sync(kFull, px, 16) + b2x;
        dy[P + j] = __shfl_sync(kFull, py, 16) + b2y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ar = a[r] > 0.f ? a[r] : 0.01f * a[r];
        float px = wown ? ar * w2x : 0.f;
        float py = wown ? ar * w2y : 0.f;
        for (int s = 16; s > 0; s >>= 1) {
          px += __shfl_xor_sync(kFull, px, s);
          py += __shfl_xor_sync(kFull, py, s);
        }
        dx[r] = px + b2x;
        dy[r] = py + b2y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] += dx[r];
      y[r] += dy[r];
      if (lane == 0) os[r * T + t] = make_float4(x[r], y[r], dx[r], dy[r]);
    }
  }
  __syncwarp();
  // lane t stores step t of every row: one coalesced store per row and output
  if (lane < T) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (out_row[r] < 0) continue;
      const float4 v = os[r * T + lane];
      reinterpret_cast<float2*>(out_abs)[out_row[r] * T + lane] = make_float2(v.x, v.y);
      reinterpret_cast<float2*>(out_rel)[out_row[r] * T + lane] = make_float2(v.z, v.w);
    }
  }
  __syncwarp();  // the staging is free for the warp's next rows
}

// Rolls out kG groups of R rows of the generator whose f32 weight block is
// W (shared memory), the recurrence of rollout_row: row r of group s from
// h = h0[s][r] (this lane's unit), c = 0, position (x0, y0) and offset
// (dx0, dy0), with socb sb[s][r] (this lane's hidden2pos unit). Its abs and
// rel go to row out_row[s][r] of out_abs / out_rel ((rows, T, 2) each)
// and, with hc, each step's h and c to row out_row[s][r] of hc ((rows, T,
// 2, H)); out_row[s][r] < 0 marks a padding row, which computes on whatever
// it was given and stores nothing. kH, kHid > 0 fix H and hid at compile
// time (0: from L). `stage` is the warp's kG tile_stage_floats(R, H, T)
// floats of shared memory, group s's at s tile_stage_floats(R, H, T). Act
// supplies the gate activations sig and tnh (ActExact, K1's and K2's:
// sigmoid and tanhf; B1 in decode_ablation.cu takes the others), applied as
// rollout_row<float, Act> applies them.
//
// Each step issues every stage for group 0, then for group 1, ...: the
// gates and activations, the sweep over the new h (hidden2pos and the next
// step's recurrent gates), the nd sums. Groups share nothing but the
// weights, so with kG = 2 (K5, select_tiled.cuh) one group's work can fill
// the other's latency, and each row's operations stay rollout_tile's in
// their order. rollout_tile stays a template of its own: written as
// rollout_tiles<1>, the same operations compiled to other registers for
// the tiled K1, K2 and B1 (123 instead of 118 for K1 at R = 4).
//
// With hid = 16 fixed and R even, hidden2pos is split over the half-warps:
// lane l takes unit l % 16 of rows (l / 16) R/2 ... (l / 16) R/2 + R/2 - 1
// of each group, so no lane idles through W1h and each half-warp's
// butterfly sums one row at once. rollout_row's butterfly over 32 lanes
// first adds the zeros of lanes >= hid (x + 0, which turns -0 into +0),
// then sums within 16 lanes: the split adds that zero and runs the same
// four levels, so every row's sum is the same sum.
template <int kG, int R, int kH, int kHid, typename Act = ActExact>
__device__ __forceinline__ void rollout_tiles(const float* __restrict__ W, const Layout& Lrt,
                                              int lane, float* __restrict__ stage,
                                              const float (&h0)[kG][R],
                                              const float (&x0)[kG][R],
                                              const float (&y0)[kG][R],
                                              const float (&dx0)[kG][R],
                                              const float (&dy0)[kG][R],
                                              const float (&sb)[kG][R],
                                              const int64_t (&out_row)[kG][R],
                                              float* __restrict__ out_abs,
                                              float* __restrict__ out_rel,
                                              float* __restrict__ hc) {
  constexpr bool kSplit = kHid == 16 && R % 2 == 0;
  constexpr int P = kSplit ? R / 2 : R;  // hidden2pos rows of a lane
  const int H = kH > 0 ? kH : Lrt.h, hid = kHid > 0 ? kHid : Lrt.hid, T = Lrt.pred_len;
  const Layout L(H, hid, Lrt.in, T, Lrt.fmt);
  const int hp = tile_h_stride(H);
  const bool own = lane < H;
  const int wcol = kSplit ? lane & 15 : lane;  // the lane's hidden2pos unit
  const bool wown = kSplit || lane < hid;
  const int prow0 = kSplit ? (lane >> 4) * P : 0;  // its first hidden2pos row
  const Weights<float> w = weights_at<float>(W, L);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bias = own ? w.b[lane] : zero4;
  const float w2x = wown ? w.w2[wcol * 2] : 0.f;
  const float w2y = wown ? w.w2[wcol * 2 + 1] : 0.f;
  const float b2x = w.b2[0], b2y = w.b2[1];
  float* hs[kG];   // [r][hp] of each group
  float4* os[kG];  // [r][t] of each group
#pragma unroll
  for (int s = 0; s < kG; ++s) {
    hs[s] = stage + s * tile_stage_floats(R, H, T);
    os[s] = reinterpret_cast<float4*>(hs[s] + R * hp);
  }

  float c[kG][R], x[kG][R], y[kG][R], dx[kG][R], dy[kG][R], a[kG][R], sbp[kG][R];
  float4 rec[kG][R];
#pragma unroll
  for (int s = 0; s < kG; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[s][r] = 0.f;
      x[s][r] = x0[s][r]; y[s][r] = y0[s][r]; dx[s][r] = dx0[s][r]; dy[s][r] = dy0[s][r];
      rec[s][r] = zero4;
      a[s][r] = 0.f;
      sbp[s][r] = sb[s][r];
      if (own) hs[s][r * hp + lane] = h0[s][r];
    }
  if constexpr (kSplit) {  // socb of the lane's hidden2pos rows, from the lanes that hold it
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float lo = __shfl_sync(kFull, sb[s][j], wcol);
        const float hi = __shfl_sync(kFull, sb[s][P + j], wcol);
        sbp[s][j] = lane >> 4 ? hi : lo;
      }
  }
  __syncwarp();
  // recurrent part of the first step's gates: h0 @ Whh
#pragma unroll
  for (int s = 0; s < kG; ++s)
    tile_sweep<R, true, 0>(hs[s], hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0, rec[s],
                           a[s]);

  for (int t = 0; t < T; ++t) {
    float h[kG][R];
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 acc = rec[s][r];
        acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
        h[s][r] = 0.f;
        if (own) {
          add_input<float>(acc, w.wemb, L, lane, x[s][r], y[s][r], dx[s][r], dy[s][r]);
          c[s][r] = Act::cell(Act::sig(acc.y), c[s][r], Act::sig(acc.x), Act::tnh(acc.z));
          h[s][r] = Act::sig(acc.w) * Act::tnh(c[s][r]);
          if (hc != nullptr && out_row[s][r] >= 0) {
            float* at = hc + (out_row[s][r] * T + t) * 2 * H;
            at[lane] = h[s][r];
            at[H + lane] = c[s][r];
          }
        }
      }
    __syncwarp();  // every lane has read the previous h
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (own) hs[s][r * hp + lane] = h[s][r];
    __syncwarp();

    // one sweep over the new h: hidden2pos now, recurrent gates for t + 1
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[s][r] = sbp[s][r];
        rec[s][r] = zero4;
      }
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      if (t + 1 < T)
        tile_sweep<R, true, P>(hs[s], hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0,
                               rec[s], a[s]);
      else
        tile_sweep<R, false, P>(hs[s], hp, w.whh, w.w1, H, hid, lane, own, wcol, wown, prow0,
                                rec[s], a[s]);
    }
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      if constexpr (kSplit) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float ar = a[s][j] > 0.f ? a[s][j] : 0.01f * a[s][j];
          float px = __fadd_rn(ar * w2x, 0.f);  // the first level: + the zero of lane l + 16
          float py = __fadd_rn(ar * w2y, 0.f);
          for (int k = 8; k > 0; k >>= 1) {
            px += __shfl_xor_sync(kFull, px, k);
            py += __shfl_xor_sync(kFull, py, k);
          }
          dx[s][j] = __shfl_sync(kFull, px, 0) + b2x;
          dy[s][j] = __shfl_sync(kFull, py, 0) + b2y;
          dx[s][P + j] = __shfl_sync(kFull, px, 16) + b2x;
          dy[s][P + j] = __shfl_sync(kFull, py, 16) + b2y;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ar = a[s][r] > 0.f ? a[s][r] : 0.01f * a[s][r];
          float px = wown ? ar * w2x : 0.f;
          float py = wown ? ar * w2y : 0.f;
          for (int k = 16; k > 0; k >>= 1) {
            px += __shfl_xor_sync(kFull, px, k);
            py += __shfl_xor_sync(kFull, py, k);
          }
          dx[s][r] = px + b2x;
          dy[s][r] = py + b2y;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[s][r] += dx[s][r];
        y[s][r] += dy[s][r];
        if (lane == 0) os[s][r * T + t] = make_float4(x[s][r], y[s][r], dx[s][r], dy[s][r]);
      }
  }
  __syncwarp();
  // lane t stores step t of every row: one coalesced store per row and output
  if (lane < T) {
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (out_row[s][r] < 0) continue;
        const float4 v = os[s][r * T + lane];
        reinterpret_cast<float2*>(out_abs)[out_row[s][r] * T + lane] = make_float2(v.x, v.y);
        reinterpret_cast<float2*>(out_rel)[out_row[s][r] * T + lane] = make_float2(v.z, v.w);
      }
  }
  __syncwarp();  // the staging is free for the warp's next rows
}

}  // namespace mggan
