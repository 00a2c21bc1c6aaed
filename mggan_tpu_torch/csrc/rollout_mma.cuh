// One warp's bf16 rollout of groups of 16 rows of one generator on the
// tensor cores (mma.sync): the row loop of K1-bf16 (decode_select_mma.cu,
// rows bucketed by generator) and K2-bf16 (decode_all.cu, 16 consecutive
// rows of the block's generator).
//
// Lane (r = lane / 4, q = lane % 4) holds rows r and r + 8 of each group,
// the mma fragments' layout:
// * gates (16 x 4H) = h (16 x 32, bf16) . Whh (32 x 4H) by m16n8k16 and
//   te (16 x 8, bf16) . Wemb' (8 x 4H) by m16n8k8, accumulated in f32 on top
//   of the bias. The gate columns are ordered (unit group u of 8 hidden
//   units, gate, unit): n-tiles 4u..4u+3 hold i, f, g and o of units
//   8u..8u+7, so a lane's accumulators hold all four gates of units 8u+2q
//   and 8u+2q+1 in rows r and r + 8, and the cell update needs no shuffle.
// * The new h of unit group u is, in the accumulator layout, exactly the A
//   fragment the next step's products read (units 16kt..16kt+15 are groups
//   2kt and 2kt+1): h is rounded to bf16 and packed there, in registers.
// * hidden2pos's pre-activation (16 x hid) = h . W1h + socb the same way;
//   LeakyReLU, hid rounded to bf16, . W2 + b2 in f32 on the CUDA cores, each
//   row's sum over hid finished by two shuffles inside a quad.
// The rounding is the TPU kernel's with compute_dtype=bfloat16
// (decoder_rollout.cuh::rollout_row on the bf16 image): te, h0, every step's
// h and hid are rounded to bf16 before their products with the bf16 weights;
// c, b, socb, W2, b2, the position sums and every accumulation stay f32.
// Each accumulator takes its products in one fixed order (bias, te . Wemb',
// then h's k-tiles 0 and 1), so a row's outputs do not depend on the other
// rows of its group, on how the rows were grouped, or on the kernel.
//
// The generator's image sits in shared memory as B fragments in the order
// the lanes read them (decoder.py::mma_weights builds it on the host), so
// each fragment is one conflict-free 16-byte load. H, hid <= 32: hidden
// units and hidden2pos columns beyond them have zero weights and stay zero.

#pragma once

#include "decoder_rollout.cuh"

namespace mggan {

constexpr int kMmaGroup = 16;  // rows of one mma (M)

// One generator's image, in 32-bit words (decoder.py::mma_weights):
//   whh  [u 4][gate 4][lane 32][4]  bf16 pairs: k-tile 0 (b0b1, b2b3), k-tile 1
//   wemb [u 4][lane 32][gate 4]     bf16 pairs: the m16n8k8 fragment of each gate
//   w1   [nt 4][lane 32][4]         bf16 pairs: k-tile 0, k-tile 1
//   bias [u 4][gate 4][8]           f32
//   w2   [32][2]                    f32 (hidden2pos columns padded to 32)
//   b2   [2], padded to 4           f32
constexpr int kWhhWords = 4 * 4 * 32 * 4;
constexpr int kWembWords = 4 * 32 * 4;
constexpr int kW1Words = 4 * 32 * 4;
constexpr int kBiasWords = 4 * 4 * 8;
constexpr int kW2Words = 32 * 2;
constexpr int kImageWords = kWhhWords + kWembWords + kW1Words + kBiasWords + kW2Words + 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// A packed bf16 pair widened to f32: (low half, high half).
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate. Not
// volatile: the compiler may interleave independent products, and each
// accumulator's own chain keeps its order through the data dependence.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) . b (8x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Roll out a group of 16 rows on generator `gen`'s image Wg (shared
// memory). This lane's rows: in_row[i] (i = 0: row r, 1: row r + 8) is the
// row of h0 (its per-agent inputs xy0, dxdy0 and socb at in_row %
// m_rows); out_row[i] the row of out_abs / out_rel ((rows, T, 2) each)
// and, with hc, of hc ((rows, T, 2, H): each step's h as the bf16 value the
// next step's products read, widened to f32, and c in f32); out_row < 0
// marks a padding row, which computes on zeros and stores nothing.
__device__ __forceinline__ void rollout_group(const uint32_t* __restrict__ Wg, int gen,
                                              const int64_t (&in_row)[2],
                                              const int64_t (&out_row)[2],
                                              const float* __restrict__ h0,
                                              const float* __restrict__ socb,
                                              const float* __restrict__ xy0,
                                              const float* __restrict__ dxdy0,
                                              float* __restrict__ out_abs,
                                              float* __restrict__ out_rel,
                                              float* __restrict__ hc, int64_t m_rows,
                                              int num_gens, const Layout& L, int lane) {
  const int q = lane & 3;  // the lane's quad; its rows r = lane / 4 come in in_row
  const int nu = (L.h + 7) / 8, nh = (L.hid + 7) / 8;
  const uint4* whh = reinterpret_cast<const uint4*>(Wg);
  const uint4* wemb = reinterpret_cast<const uint4*>(Wg + kWhhWords);
  const uint4* w1 = reinterpret_cast<const uint4*>(Wg + kWhhWords + kWembWords);
  const float* fw = reinterpret_cast<const float*>(Wg + kWhhWords + kWembWords + kW1Words);
  const float2* bias = reinterpret_cast<const float2*>(fw);
  const float4* w2 = reinterpret_cast<const float4*>(fw + kBiasWords);
  const float b2x = fw[kBiasWords + kW2Words], b2y = fw[kBiasWords + kW2Words + 1];

  bool live[2];
  float x[2], y[2], dx[2], dy[2];
  // pre-activation start of hidden2pos n-tile nt: (row r: cols 2q, 2q+1; row r+8)
  float sb[4][4];
  uint32_t ha[2][4];  // A fragments of h, k-tiles 0 and 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live[i] = out_row[i] >= 0;
    const int64_t row = live[i] ? in_row[i] : 0;
    const int64_t m = row % m_rows;
    x[i] = live[i] ? xy0[m * 2] : 0.f;
    y[i] = live[i] ? xy0[m * 2 + 1] : 0.f;
    dx[i] = live[i] ? dxdy0[m * 2] : 0.f;
    dy[i] = live[i] ? dxdy0[m * 2 + 1] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * q + e;
        sb[nt][2 * i + e] =
            live[i] && col < L.hid ? socb[(m * num_gens + gen) * L.hid + col] : 0.f;
      }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int col = kt * 16 + hi * 8 + 2 * q;
        const float v0 = live[i] && col < L.h ? h0[row * L.h + col] : 0.f;
        const float v1 = live[i] && col + 1 < L.h ? h0[row * L.h + col + 1] : 0.f;
        ha[kt][hi * 2 + i] = pack_bf16(v0, v1);
      }
  }

  float c[4][4] = {};  // cell state of unit group u: (row r: units 8u+2q, +1; row r+8)
  for (int t = 0; t < L.pred_len; ++t) {
    // te as the m16n8k8 A fragment: columns 2q, 2q+1 of rows r and r + 8
    uint32_t ta[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (q == 0) ta[i] = L.fmt == kRel ? pack_bf16(dx[i], dy[i]) : pack_bf16(x[i], y[i]);
      else if (q == 1 && L.fmt == kAbsRel) ta[i] = pack_bf16(dx[i], dy[i]);
    }
    uint32_t hn[2][4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u >= nu) continue;
      // the products stage by stage over the four gates: te . Wemb' on the
      // bias, then h's k-tiles 0 and 1
      float acc[4][4];
      const uint4 we = wemb[u * 32 + lane];
      const uint32_t wes[4] = {we.x, we.y, we.z, we.w};
      uint4 wh[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 b = bias[(u * 4 + gate) * 4 + q];
        wh[gate] = whh[(u * 4 + gate) * 32 + lane];
        acc[gate][0] = b.x; acc[gate][1] = b.y; acc[gate][2] = b.x; acc[gate][3] = b.y;
        mma_k8(acc[gate], ta[0], ta[1], wes[gate]);
      }
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) mma_k16(acc[gate], ha[0], wh[gate].x, wh[gate].y);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) mma_k16(acc[gate], ha[1], wh[gate].z, wh[gate].w);
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[u][e] = sigmoid(acc[1][e]) * c[u][e] + sigmoid(acc[0][e]) * tanhf(acc[2][e]);
        hv[e] = sigmoid(acc[3][e]) * tanhf(c[u][e]);
      }
      hn[u >> 1][(u & 1) * 2] = pack_bf16(hv[0], hv[1]);
      hn[u >> 1][(u & 1) * 2 + 1] = pack_bf16(hv[2], hv[3]);
      if (hc == nullptr) continue;
      // units 8u+2q, 8u+2q+1 of rows r and r + 8: a quad's four lanes
      // write a row's 8 units of h (and of c) as one 32-byte sector
      const int col = 8 * u + 2 * q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live[i] || col >= L.h) continue;
        float* at = hc + (out_row[i] * L.pred_len + t) * 2 * L.h + col;
        const float2 hp = unpack_bf16(hn[u >> 1][(u & 1) * 2 + i]);
        const float2 cp = make_float2(c[u][2 * i], c[u][2 * i + 1]);
        if (col + 1 < L.h && (L.h & 1) == 0) {  // 8-byte aligned: the row holds 2H floats
          *reinterpret_cast<float2*>(at) = hp;
          *reinterpret_cast<float2*>(at + L.h) = cp;
        } else {
          at[0] = hp.x;
          at[L.h] = cp.x;
          if (col + 1 < L.h) {
            at[1] = hp.y;
            at[L.h + 1] = cp.y;
          }
        }
      }
    }

    // hidden2pos: pre = socb + h . W1h (tensor cores), then W2 in f32
    float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nh) continue;
      const uint4 w = w1[nt * 32 + lane];
      const float4 w2q = w2[nt * 4 + q];  // W2 rows 8nt+2q, 8nt+2q+1: (x, y) each
      float pre[4] = {sb[nt][0], sb[nt][1], sb[nt][2], sb[nt][3]};
      mma_k16(pre, hn[0], w.x, w.y);
      mma_k16(pre, hn[1], w.z, w.w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = round_bf16(pre[e] > 0.f ? pre[e] : 0.01f * pre[e]);
        const int i = e >> 1;
        px[i] = fmaf(a, e & 1 ? w2q.z : w2q.x, px[i]);
        py[i] = fmaf(a, e & 1 ? w2q.w : w2q.y, py[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      px[i] += __shfl_xor_sync(kFull, px[i], 1);
      py[i] += __shfl_xor_sync(kFull, py[i], 1);
      px[i] += __shfl_xor_sync(kFull, px[i], 2);
      py[i] += __shfl_xor_sync(kFull, py[i], 2);
      dx[i] = px[i] + b2x;
      dy[i] = py[i] + b2y;
      x[i] += dx[i];
      y[i] += dy[i];
    }
    // lane q stores one of: abs of row r, abs of row r+8, rel of row r, rel
    // of row r+8 (selects, not a runtime index: the arrays stay in registers)
    const bool second = q & 1;
    if (second ? live[1] : live[0]) {
      const int64_t rw = second ? out_row[1] : out_row[0];
      float* out = (q < 2 ? out_abs : out_rel) + (rw * L.pred_len + t) * 2;
      *reinterpret_cast<float2*>(out) =
          q < 2 ? (second ? make_float2(x[1], y[1]) : make_float2(x[0], y[0]))
                : (second ? make_float2(dx[1], dy[1]) : make_float2(dx[0], dy[0]));
    }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) ha[kt][j] = hn[kt][j];
  }
}

}  // namespace mggan
