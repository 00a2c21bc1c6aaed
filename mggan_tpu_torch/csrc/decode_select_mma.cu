// Fused-selection decoder rollout in bf16 on the tensor cores (K1-bf16) for
// Hopper (sm_90a).
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_select_kernel with
// compute_dtype=bfloat16 (pallas_decode_select): for each row n with
// sampled generator g = idx[n] it rolls out generator g only,
//
//   gates = te @ Wemb'_g + h @ Whh_g + b_g;  c = sig(f) c + sig(i) tanh(gg)
//   h = sig(o) tanh(c);  hid = LeakyReLU_0.01(h @ W1h_g + socb[m, g])
//   nd = hid @ W2_g + b2_g;  xy += nd;  dxdy = nd
//
// and stores abs = xy and rel = nd of every step, each (N, T, 2) f32. The
// rounding is the TPU kernel's (decoder_rollout.cuh::rollout_row with a bf16
// image): te, h0, every step's h and hid are rounded to bf16 before their
// products with the bf16 weights Wemb', Whh and W1h; c, b, socb, W2, b2, the
// position sums and every accumulation stay f32. Only the order of
// summation differs from the warp-per-row kernel (decode_select.cu).
//
// Design. A block takes tiles of consecutive rows and buckets each tile's
// rows by generator in shared memory (a stable counting sort: ballots per
// 32-row chunk, then offsets), every bucket padded to 16 rows. A warp then
// rolls out 16 rows of one generator at a time with mma.sync:
// * gates (16 x 4H) = h (16 x 32, bf16) . Whh (32 x 4H) by m16n8k16 and
//   te (16 x 8, bf16) . Wemb' (8 x 4H) by m16n8k8, accumulated in f32 on top
//   of the bias. The gate columns are ordered (unit group u of 8 hidden
//   units, gate, unit): n-tiles 4u..4u+3 hold i, f, g and o of units
//   8u..8u+7, so a thread's accumulators hold all four gates of the same
//   two units in the same two rows, and the cell update needs no shuffle.
// * The new h of unit group u is, in the accumulator layout, exactly the A
//   fragment the next step's products read (units 16kt..16kt+15 are groups
//   2kt and 2kt+1): h is rounded to bf16 and packed there, in registers.
// * hidden2pos's pre-activation (16 x hid) = h . W1h + socb the same way;
//   LeakyReLU, hid rounded to bf16, . W2 + b2 in f32 on the CUDA cores, each
//   row's sum over hid finished by two shuffles inside a quad.
// All G generators' weights sit in shared memory as B fragments in the
// order the lanes read them (decoder.py::mma_weights builds the image on the
// host), so each fragment is one conflict-free 16-byte load. Padded rows of
// a bucket compute on zeros and store nothing; a row with no generator (idx
// out of range) is poisoned with NaN, as in decode_select.cu. H, hid <= 32:
// hidden units and hidden2pos columns beyond them have zero weights and stay
// zero.
//
// What bounds it on the H100: not the tensor cores (the products are ~3 %
// of the issue slots), nor device memory (~0.4 KB a row), but the gate
// activations on the CUDA cores and the SFU: 3 sigmoids (expf, divide) and
// 2 tanhf per hidden unit per row-step, as in the warp kernel, which also
// spent ~12 instructions per weight (shuffle, load, unpack, FMAs) that the
// fragments now replace. Rows of one generator share every weight load and
// every broadcast of h, 16 at a time.

#include "tile_buckets.cuh"

namespace {

using namespace mggan;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;      // rows of one mma (M)
constexpr int kMaxTile = 256;   // rows of a tile, at most
constexpr int kMaxGens = 32;    // generators a block can bucket (a warp's lanes)

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

// The tile's bucketing in shared memory, after the G images (sized for G,
// so that four blocks fit on an SM at G = 4).
using Buckets = TileBuckets<kWarps, kMaxTile, kGroup>;

__host__ __device__ inline size_t smem_bytes(int num_gens) {
  return ((size_t)num_gens * kImageWords + Buckets::ints(num_gens)) * sizeof(float);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) . b (8x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Roll out the 16 rows of one bucketed group on generator image Wg. Lane
// (r = lane / 4, q = lane % 4) holds rows r and r + 8 of the group, the
// mma fragments' layout.
__device__ __forceinline__ void rollout_group(const uint32_t* __restrict__ Wg,
                                              const int* __restrict__ group_slots, int gen,
                                              int64_t base, const float* __restrict__ h0,
                                              const float* __restrict__ socb,
                                              const float* __restrict__ xy0,
                                              const float* __restrict__ dxdy0,
                                              float* __restrict__ out_abs,
                                              float* __restrict__ out_rel, int64_t m_rows,
                                              int num_gens, const Layout& L, int lane) {
  const int r = lane >> 2, q = lane & 3;
  const int nu = (L.h + 7) / 8, nh = (L.hid + 7) / 8;
  const uint4* whh = reinterpret_cast<const uint4*>(Wg);
  const uint4* wemb = reinterpret_cast<const uint4*>(Wg + kWhhWords);
  const uint4* w1 = reinterpret_cast<const uint4*>(Wg + kWhhWords + kWembWords);
  const float* fw = reinterpret_cast<const float*>(Wg + kWhhWords + kWembWords + kW1Words);
  const float2* bias = reinterpret_cast<const float2*>(fw);
  const float4* w2 = reinterpret_cast<const float4*>(fw + kBiasWords);
  const float b2x = fw[kBiasWords + kW2Words], b2y = fw[kBiasWords + kW2Words + 1];

  int64_t row[2];
  bool live[2];
  float x[2], y[2], dx[2], dy[2];
  float sb[4][4];  // pre-activation start of hidden2pos n-tile nt: (row r: cols 2q, 2q+1; row r+8)
  uint32_t ha[2][4];  // A fragments of h, k-tiles 0 and 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = group_slots[r + 8 * i];
    live[i] = slot >= 0;
    row[i] = live[i] ? base + slot : 0;
    const int64_t m = row[i] % m_rows;
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
        const float v0 = live[i] && col < L.h ? h0[row[i] * L.h + col] : 0.f;
        const float v1 = live[i] && col + 1 < L.h ? h0[row[i] * L.h + col + 1] : 0.f;
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
      float acc[4][4];
      const uint4 we = wemb[u * 32 + lane];
      const uint32_t wes[4] = {we.x, we.y, we.z, we.w};
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 b = bias[(u * 4 + gate) * 4 + q];
        acc[gate][0] = b.x; acc[gate][1] = b.y; acc[gate][2] = b.x; acc[gate][3] = b.y;
        mma_k8(acc[gate], ta[0], ta[1], wes[gate]);
        const uint4 wh = whh[(u * 4 + gate) * 32 + lane];
        mma_k16(acc[gate], ha[0], wh.x, wh.y);
        mma_k16(acc[gate], ha[1], wh.z, wh.w);
      }
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[u][e] = sigmoid(acc[1][e]) * c[u][e] + sigmoid(acc[0][e]) * tanhf(acc[2][e]);
        hv[e] = sigmoid(acc[3][e]) * tanhf(c[u][e]);
      }
      hn[u >> 1][(u & 1) * 2] = pack_bf16(hv[0], hv[1]);
      hn[u >> 1][(u & 1) * 2 + 1] = pack_bf16(hv[2], hv[3]);
    }

    // hidden2pos: pre = socb + h . W1h (tensor cores), then W2 in f32
    float px[2] = {0.f, 0.f}, py[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= nh) continue;
      float pre[4] = {sb[nt][0], sb[nt][1], sb[nt][2], sb[nt][3]};
      const uint4 w = w1[nt * 32 + lane];
      mma_k16(pre, hn[0], w.x, w.y);
      mma_k16(pre, hn[1], w.z, w.w);
      const float4 w2q = w2[nt * 4 + q];  // W2 rows 8nt+2q, 8nt+2q+1: (x, y) each
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
    // lane q stores one of: abs of row r, abs of row r+8, rel of row r, rel of row r+8
    const bool second = q & 1;
    if (second ? live[1] : live[0]) {
      const int64_t rw = second ? row[1] : row[0];
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

// A persistent grid; block b takes tiles b, b + gridDim.x, ... of
// tile_rows rows (a multiple of 32, at most kMaxTile).
__global__ void __launch_bounds__(kThreads, 4)
decode_select_mma_kernel(const float* __restrict__ wpack,  // (G, kImageWords)
                         const float* __restrict__ h0,     // (N, H)
                         const float* __restrict__ socb,   // (M, G, hid)
                         const float* __restrict__ xy0,    // (M, 2)
                         const float* __restrict__ dxdy0,  // (M, 2)
                         const int32_t* __restrict__ idx,  // (N,)
                         float* __restrict__ out_abs,      // (N, T, 2)
                         float* __restrict__ out_rel,      // (N, T, 2)
                         int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                         int hid_dim, int in_dim, int pred_len, int fmt, int tile_rows) {
  extern __shared__ float4 smem4[];
  stage_weights(smem4, wpack, num_gens * kImageWords);
  const uint32_t* images = reinterpret_cast<const uint32_t*>(smem4);
  const Buckets s = Buckets::at(
      reinterpret_cast<int*>(reinterpret_cast<float*>(smem4) + (size_t)num_gens * kImageWords),
      num_gens);
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * tile_rows;
    const int rows = (int)(n_rows - base < tile_rows ? n_rows - base : tile_rows);
    s.bucket(idx, base, rows, num_gens, pred_len, out_abs, out_rel);
    for (int grp = warp; grp < *s.groups; grp += kWarps) {
      const int gen = s.group_gen[grp];
      rollout_group(images + (size_t)gen * kImageWords, s.slots + grp * kGroup, gen, base, h0,
                    socb, xy0, dxdy0, out_abs, out_rel, m_rows, num_gens, L, lane);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

}  // namespace

extern "C" {

// 32-bit words of one generator's image (decoder.py::mma_weights checks it).
int mggan_decode_select_mma_image_words() { return kImageWords; }

// K1-bf16 on `stream` with the fragment image `wpack` (G, image words):
// returns cudaGetLastError() after the launch (0 on success); the caller
// checks shapes (H, hid <= 32, in <= 8, G <= 32) and picks tile_rows (a
// multiple of 32, at most 256).
int mggan_decode_select_bf16(const void* wpack, const void* h0, const void* socb,
                             const void* xy0, const void* dxdy0, const void* idx, void* out_abs,
                             void* out_rel, long long n_rows, long long m_rows, int num_gens,
                             int h_dim, int hid_dim, int in_dim, int pred_len, int fmt,
                             int tile_rows, void* stream) {
  const size_t smem = smem_bytes(num_gens);
  cudaError_t err = allow_smem(decode_select_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_select_mma_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n_rows + tile_rows - 1) / tile_rows;
  const long long resident = (long long)sms * per_sm;
  const long long blocks = tiles < resident ? tiles : resident;
  decode_select_mma_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
      tile_rows);
  return (int)cudaGetLastError();
}

// Resident warps per SM of the kernel for `num_gens` generators.
int mggan_decode_select_bf16_warps_per_sm(int num_gens, int* warps) {
  return (int)resident_warps(decode_select_mma_kernel, kThreads, smem_bytes(num_gens), warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
