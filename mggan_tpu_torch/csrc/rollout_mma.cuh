// One warp's bf16 rollout of groups of 16 rows of one generator on the
// tensor cores (mma.sync): the row loop of K1-bf16 and, two groups at a
// time, of K5-bf16 (decode_select_mma.cu, rows bucketed by generator),
// K2-bf16 (decode_all.cu, 16 consecutive rows of the block's generator)
// and K4-bf16 (decode_sorted_mma.cu, a tile of rows sorted by generator).
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

// The row inputs of a rollout, read through an accessor (rollout_groups'
// In): SelectInputs here for K1-bf16, K5-bf16 and K2-bf16, whose h0 has a
// row per rollout and whose socb, xy0 and dxdy0 have a row per agent m =
// row % m_rows; decode_sorted_mma.cu's for a tile of K4's row buffer. An
// accessor gives agent(row), the row of its per-agent inputs; h(row, col);
// sb(m, gen, col); xy(m, k) and dxdy(m, k) (k = 0: x, 1: y); and kOutSteps,
// the rows of out_abs / out_rel being kOutSteps T steps of (x, y) apart.
struct SelectInputs {
  static constexpr int kOutSteps = 1;
  const float* __restrict__ h0;     // (N, H)
  const float* __restrict__ socb;   // (M, G, hid)
  const float* __restrict__ xy0;    // (M, 2)
  const float* __restrict__ dxdy0;  // (M, 2)
  int64_t m_rows;
  int num_gens;

  __device__ __forceinline__ int64_t agent(int64_t row) const { return row % m_rows; }
  __device__ __forceinline__ float h(int64_t row, int col, const Layout& L) const {
    return h0[row * L.h + col];
  }
  __device__ __forceinline__ float sb(int64_t m, int gen, int col, const Layout& L) const {
    return socb[(m * num_gens + gen) * L.hid + col];
  }
  __device__ __forceinline__ float xy(int64_t m, int k) const { return xy0[m * 2 + k]; }
  __device__ __forceinline__ float dxdy(int64_t m, int k) const { return dxdy0[m * 2 + k]; }
};

// Roll out kG groups of 16 rows of generator `gen` at once on its image Wg
// (shared memory): kG = 1 is the row loop of K1-bf16, K2-bf16 and K4-bf16;
// kG = 2 is K5-bf16's, where each stage (te . Wemb', h's k-tile 0, k-tile
// 1, the activations, hidden2pos) is issued for both groups in turn, so
// that one group's mma and SFU work can cover the other's latency. Every
// accumulator keeps one order whatever kG (bias, te . Wemb', k-tile 0,
// k-tile 1), so a row's bits do not depend on kG.
//
// This lane's rows of group s: in_row[s][i] (i = 0: row r, 1: row r + 8)
// is the row of the inputs (`in`); out_row[s][i] the row of out_abs /
// out_rel ((rows, kOutSteps T, 2) each) and, with hc, of hc ((rows, T, 2,
// H): each step's h as the bf16 value the next step's products read,
// widened to f32, and c in f32); out_row < 0 marks a padding row, which
// computes on zeros and stores nothing.
template <int kG, class In>
__device__ __forceinline__ void rollout_groups(const uint32_t* __restrict__ Wg, int gen,
                                               const int64_t (&in_row)[kG][2],
                                               const int64_t (&out_row)[kG][2], const In& in,
                                               float* __restrict__ out_abs,
                                               float* __restrict__ out_rel,
                                               float* __restrict__ hc, const Layout& L,
                                               int lane) {
  const int q = lane & 3;  // the lane's quad; its rows r = lane / 4 come in in_row
  const int nu = (L.h + 7) / 8, nh = (L.hid + 7) / 8;
  const uint4* whh = reinterpret_cast<const uint4*>(Wg);
  const uint4* wemb = reinterpret_cast<const uint4*>(Wg + kWhhWords);
  const uint4* w1 = reinterpret_cast<const uint4*>(Wg + kWhhWords + kWembWords);
  const float* fw = reinterpret_cast<const float*>(Wg + kWhhWords + kWembWords + kW1Words);
  const float2* bias = reinterpret_cast<const float2*>(fw);
  const float4* w2 = reinterpret_cast<const float4*>(fw + kBiasWords);
  const float b2x = fw[kBiasWords + kW2Words], b2y = fw[kBiasWords + kW2Words + 1];

  bool live[kG][2];
  float x[kG][2], y[kG][2], dx[kG][2], dy[kG][2];
  // pre-activation start of hidden2pos n-tile nt: (row r: cols 2q, 2q+1; row r+8)
  float sb[kG][4][4];
  uint32_t ha[kG][2][4];  // A fragments of h, k-tiles 0 and 1
#pragma unroll
  for (int s = 0; s < kG; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      live[s][i] = out_row[s][i] >= 0;
      const int64_t row = live[s][i] ? in_row[s][i] : 0;
      const int64_t m = in.agent(row);
      x[s][i] = live[s][i] ? in.xy(m, 0) : 0.f;
      y[s][i] = live[s][i] ? in.xy(m, 1) : 0.f;
      dx[s][i] = live[s][i] ? in.dxdy(m, 0) : 0.f;
      dy[s][i] = live[s][i] ? in.dxdy(m, 1) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * q + e;
          sb[s][nt][2 * i + e] = live[s][i] && col < L.hid ? in.sb(m, gen, col, L) : 0.f;
        }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = kt * 16 + hi * 8 + 2 * q;
          const float v0 = live[s][i] && col < L.h ? in.h(row, col, L) : 0.f;
          const float v1 = live[s][i] && col + 1 < L.h ? in.h(row, col + 1, L) : 0.f;
          ha[s][kt][hi * 2 + i] = pack_bf16(v0, v1);
        }
    }

  float c[kG][4][4] = {};  // cell state of unit group u: (row r: units 8u+2q, +1; row r+8)
  for (int t = 0; t < L.pred_len; ++t) {
    // te as the m16n8k8 A fragment: columns 2q, 2q+1 of rows r and r + 8
    uint32_t ta[kG][2] = {};
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (q == 0)
          ta[s][i] = L.fmt == kRel ? pack_bf16(dx[s][i], dy[s][i]) : pack_bf16(x[s][i], y[s][i]);
        else if (q == 1 && L.fmt == kAbsRel)
          ta[s][i] = pack_bf16(dx[s][i], dy[s][i]);
      }
    uint32_t hn[kG][2][4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u >= nu) continue;
      // the products stage by stage over the four gates: te . Wemb' on the
      // bias, then h's k-tiles 0 and 1
      float acc[kG][4][4];
      const uint4 we = wemb[u * 32 + lane];
      const uint32_t wes[4] = {we.x, we.y, we.z, we.w};
      uint4 wh[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 b = bias[(u * 4 + gate) * 4 + q];
        wh[gate] = whh[(u * 4 + gate) * 32 + lane];
#pragma unroll
        for (int s = 0; s < kG; ++s) {
          acc[s][gate][0] = b.x; acc[s][gate][1] = b.y;
          acc[s][gate][2] = b.x; acc[s][gate][3] = b.y;
          mma_k8(acc[s][gate], ta[s][0], ta[s][1], wes[gate]);
        }
      }
#pragma unroll
      for (int s = 0; s < kG; ++s)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          mma_k16(acc[s][gate], ha[s][0], wh[gate].x, wh[gate].y);
#pragma unroll
      for (int s = 0; s < kG; ++s)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          mma_k16(acc[s][gate], ha[s][1], wh[gate].z, wh[gate].w);
#pragma unroll
      for (int s = 0; s < kG; ++s) {
        float hv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[s][u][e] = sigmoid(acc[s][1][e]) * c[s][u][e] +
                       sigmoid(acc[s][0][e]) * tanhf(acc[s][2][e]);
          hv[e] = sigmoid(acc[s][3][e]) * tanhf(c[s][u][e]);
        }
        hn[s][u >> 1][(u & 1) * 2] = pack_bf16(hv[0], hv[1]);
        hn[s][u >> 1][(u & 1) * 2 + 1] = pack_bf16(hv[2], hv[3]);
      }
      if (hc == nullptr) continue;
      // units 8u+2q, 8u+2q+1 of rows r and r + 8: a quad's four lanes
      // write a row's 8 units of h (and of c) as one 32-byte sector
      const int col = 8 * u + 2 * q;
#pragma unroll
      for (int s = 0; s < kG; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!live[s][i] || col >= L.h) continue;
          float* at = hc + (out_row[s][i] * L.pred_len + t) * 2 * L.h + col;
          const float2 hp = unpack_bf16(hn[s][u >> 1][(u & 1) * 2 + i]);
          const float2 cp = make_float2(c[s][u][2 * i], c[s][u][2 * i + 1]);
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
    float px[kG][2] = {}, py[kG][2] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nh) continue;
      const uint4 w = w1[nt * 32 + lane];
      const float4 w2q = w2[nt * 4 + q];  // W2 rows 8nt+2q, 8nt+2q+1: (x, y) each
      float pre[kG][4];
#pragma unroll
      for (int s = 0; s < kG; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pre[s][e] = sb[s][nt][e];
        mma_k16(pre[s], hn[s][0], w.x, w.y);
        mma_k16(pre[s], hn[s][1], w.z, w.w);
      }
#pragma unroll
      for (int s = 0; s < kG; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = round_bf16(pre[s][e] > 0.f ? pre[s][e] : 0.01f * pre[s][e]);
          const int i = e >> 1;
          px[s][i] = fmaf(a, e & 1 ? w2q.z : w2q.x, px[s][i]);
          py[s][i] = fmaf(a, e & 1 ? w2q.w : w2q.y, py[s][i]);
        }
    }
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        px[s][i] += __shfl_xor_sync(kFull, px[s][i], 1);
        py[s][i] += __shfl_xor_sync(kFull, py[s][i], 1);
        px[s][i] += __shfl_xor_sync(kFull, px[s][i], 2);
        py[s][i] += __shfl_xor_sync(kFull, py[s][i], 2);
        dx[s][i] = px[s][i] + b2x;
        dy[s][i] = py[s][i] + b2y;
        x[s][i] += dx[s][i];
        y[s][i] += dy[s][i];
      }
    // lane q stores one of: abs of row r, abs of row r+8, rel of row r, rel
    // of row r+8 (selects, not a runtime index: the arrays stay in registers)
    const bool second = q & 1;
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      if (second ? live[s][1] : live[s][0]) {
        const int64_t rw = second ? out_row[s][1] : out_row[s][0];
        float* out = (q < 2 ? out_abs : out_rel) + (rw * L.pred_len * In::kOutSteps + t) * 2;
        *reinterpret_cast<float2*>(out) =
            q < 2 ? (second ? make_float2(x[s][1], y[s][1]) : make_float2(x[s][0], y[s][0]))
                  : (second ? make_float2(dx[s][1], dy[s][1]) : make_float2(dx[s][0], dy[s][0]));
      }
    }
#pragma unroll
    for (int s = 0; s < kG; ++s)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int j = 0; j < 4; ++j) ha[s][kt][j] = hn[s][kt][j];
  }
}

// One group of 16 rows (rollout_groups with kG = 1): this lane's rows
// in_row[i], out_row[i].
template <class In>
__device__ __forceinline__ void rollout_group(const uint32_t* __restrict__ Wg, int gen,
                                              const int64_t (&in_row)[2],
                                              const int64_t (&out_row)[2], const In& in,
                                              float* __restrict__ out_abs,
                                              float* __restrict__ out_rel,
                                              float* __restrict__ hc, const Layout& L,
                                              int lane) {
  const int64_t ir[1][2] = {{in_row[0], in_row[1]}};
  const int64_t orow[1][2] = {{out_row[0], out_row[1]}};
  rollout_groups<1>(Wg, gen, ir, orow, in, out_abs, out_rel, hc, L, lane);
}

}  // namespace mggan
