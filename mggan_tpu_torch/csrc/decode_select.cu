// Fused-selection decoder rollout (K1) for Hopper (sm_90a).
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_select_kernel (wrapped by
// pallas_decode_select). For each row n with sampled generator g = idx[n] it
// runs the autoregressive LSTM rollout of relative_decoder_apply for g only:
//
//   gates = te @ Wemb'_g + h @ Whh_g + b_g          (te = dxdy | xy | [xy dxdy])
//   c = sig(f) c + sig(i) tanh(gg);  h = sig(o) tanh(c)
//   hid = LeakyReLU_0.01(h @ W1h_g + socb[m, g])    (socb hoisted by the caller)
//   nd  = hid @ W2_g + b2_g;  xy += nd;  dxdy = nd
//
// and stores abs = xy and rel = nd for every step, each (N, T, 2) f32. The TPU
// kernel rolls out all G generators at once in lane-packed block-diagonal
// weights and masks the result with a one-hot; here only the selected
// generator runs, 1/G of the arithmetic for the same output.
//
// Two variants, as the TPU kernel's compute_dtype: f32, and bf16
// (mggan_decode_select_bf16_warp), where te, h and hid are rounded to bf16 before
// their products with the bf16 weights Wemb', Whh and W1h, and c, the
// biases, W2 and every sum stay f32 (decoder_rollout.cuh::rollout_row). The
// bf16 weight image is half the f32 one (~40 KB for G=4 at H=32).
//
// Row inputs: h0 and idx have N rows. xy0, dxdy0 and socb have M rows with
// N % M == 0, and row n reads row n % M: the sampling path flattens rows
// (k, s, p)-major and those inputs do not depend on the sample k, so the
// caller passes them once instead of K copies.
//
// Design (a simple one that is right first). One warp per row; lane j owns
// hidden unit j (H <= 32). Each lane keeps its four gate pre-activations in a
// float4 and walks k over the hidden units, taking h_k from lane k with
// __shfl_sync. The same walk over the new h feeds both hidden2pos (lanes
// < hid) and the next step's recurrent gates, so each step does one sweep of
// H shuffles. nd is a warp reduction. Lane t keeps step t's outputs and the
// warp stores them at the end, so each row's output is one coalesced store.
// All G generators' folded weights (~20 KB each at H=32) sit in dynamic
// shared memory, laid out [k][j][gate] so a lane's four gate weights are one
// 16-byte load and a warp's loads are conflict-free. The grid is persistent
// (as many blocks as fit at once) and warps stride over rows, so the weights
// are staged once per block, not once per row.
//
// What bounds it on the H100: not device memory (about 0.4 KB moved per row
// against about 118 kFLOP per row over 12 steps). The arithmetic bound is
// fp32 FMA on the CUDA cores (67 TFLOP/s), but this design is bound first by
// shared-memory bandwidth: every row re-reads its generator's weights every
// step (about 17 KB per row-step at H=32), because rows of one warp belong
// to one row only and rows next to each other have different generators.
// Grouping rows by generator is K4 (decode_sorted.cu: a block holds one
// generator's weights for a tile of rows sorted by generator); reusing each
// weight load over several rows of a warp, or the tensor cores on such
// groups, is the step after it.
// The bf16 instantiation reads half the weight bytes per row-step but does
// the same fp32 FMAs on converted operands, plus the conversions: bound by
// the same pipes, and slower than f32. The bf16 route of decode_select
// therefore runs decode_select_mma.cu (rows grouped by generator inside a
// tile, the products on the tensor cores); this warp-per-row bf16 kernel
// stays as mggan_decode_select_bf16_warp, launched only to compare the two
// on the card, and as the bf16 K5's reference (K5-bf16 equals it bit for
// bit).
//
// K5 (mggan_decode_select_ilp, _bf16) replaces _fwd_select_kernel_ilp
// (pallas_decode_select(ilp=True)): the same function, with one warp
// advancing two rows at once (decoder_rollout.cuh::rollout_row2), so each
// step's shuffles, shared-memory loads and FMAs of one row fill the other's
// latency. Each row keeps K1's operations in K1's order, so the output is
// bit-identical to K1's; with an odd N the last pair has one row. If K5 is
// faster than K1, K1 is bound by latency rather than by an issue pipe.

#include "decoder_rollout.cuh"

namespace {

using namespace mggan;

constexpr int kThreads = 512;

// The per-generator weight block is one of the images decoder_rollout.cuh
// describes (T = float or __nv_bfloat16); all G blocks sit back to back in
// shared memory, per_gen 4-byte words apart.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_select_kernel(const float* __restrict__ wpack,
                     const float* __restrict__ h0,      // (N, H)
                     const float* __restrict__ socb,    // (M, G, hid)
                     const float* __restrict__ xy0,     // (M, 2)
                     const float* __restrict__ dxdy0,   // (M, 2)
                     const int32_t* __restrict__ idx,   // (N,)
                     float* __restrict__ out_abs,       // (N, T, 2)
                     float* __restrict__ out_rel,       // (N, T, 2)
                     int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                     int hid_dim, int in_dim, int pred_len, int fmt,
                     int per_gen) {
  extern __shared__ float4 smem4[];
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  select_rows<T>(smem4, wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows, m_rows,
                 num_gens, L, per_gen);
}

// K5: K1 with a warp per pair of rows (2p, 2p + 1). A pair whose second row
// is missing (odd N) or has no generator runs its rows one by one through
// rollout_row, the same arithmetic. A warp holds two rows' state, so it may
// take twice K1's registers (one block of 16 warps an SM instead of two):
// the rows in flight per SM stay K1's 32, now two to a warp.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_select_ilp_kernel(const float* __restrict__ wpack, const float* __restrict__ h0,
                         const float* __restrict__ socb, const float* __restrict__ xy0,
                         const float* __restrict__ dxdy0, const int32_t* __restrict__ idx,
                         float* __restrict__ out_abs, float* __restrict__ out_rel,
                         int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                         int hid_dim, int in_dim, int pred_len, int fmt, int per_gen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  stage_weights(smem4, wpack, num_gens * per_gen);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const float nan = __int_as_float(0x7fc00000);
  const int64_t n_pairs = (n_rows + 1) / 2;

  for (int64_t pair = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       pair < n_pairs; pair += (int64_t)gridDim.x * warps) {
    int64_t row[2] = {2 * pair, 2 * pair + 1};
    int g[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      g[r] = row[r] < n_rows ? idx[row[r]] : -1;
      live[r] = g[r] >= 0 && g[r] < num_gens;
      if (row[r] < n_rows && !live[r]) {  // no generator selected: poison the row
        for (int q = lane; q < pred_len * 2; q += 32) {
          out_abs[row[r] * pred_len * 2 + q] = nan;
          out_rel[row[r] * pred_len * 2 + q] = nan;
        }
      }
    }
    const float* W[2];
    float h[2], x[2], y[2], dx[2], dy[2], sb[2];
    float* abs_row[2];
    float* rel_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = live[r] ? g[r] : 0;
      const int64_t rr = live[r] ? row[r] : 0;
      const int64_t m = rr % m_rows;
      W[r] = smem + (int64_t)gr * per_gen;
      h[r] = lane < h_dim ? h0[rr * h_dim + lane] : 0.f;
      sb[r] = lane < hid_dim ? socb[(m * num_gens + gr) * hid_dim + lane] : 0.f;
      x[r] = xy0[m * 2];
      y[r] = xy0[m * 2 + 1];
      dx[r] = dxdy0[m * 2];
      dy[r] = dxdy0[m * 2 + 1];
      abs_row[r] = out_abs + rr * pred_len * 2;
      rel_row[r] = out_rel + rr * pred_len * 2;
    }
    if (live[0] && live[1]) {
      rollout_row2<T>(W, L, lane, h, x, y, dx, dy, sb, abs_row, rel_row);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (live[r])
          rollout_row<T>(W[r], L, lane, h[r], x[r], y[r], dx[r], dy[r], sb[r], abs_row[r],
                         rel_row[r], nullptr);
      }
    }
  }
}

// Launch K1 (items = rows) or K5 (items = pairs of rows) as a persistent
// grid on `stream`.
template <typename T, bool kIlp>
int launch(const void* wpack, const void* h0, const void* socb, const void* xy0,
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,
           int in_dim, int pred_len, int fmt, int per_gen, void* stream) {
  auto kernel = decode_select_kernel<T>;
  if (kIlp) kernel = decode_select_ilp_kernel<T>;
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  const long long items = kIlp ? (n_rows + 1) / 2 : n_rows;
  if ((err = persistent_blocks(kernel, kThreads, smem, items, &blocks)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim,
      pred_len, fmt, per_gen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define MGGAN_SELECT_ENTRY(name, T, ilp)                                                      \
  int name(const void* wpack, const void* h0, const void* socb, const void* xy0,              \
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,                  \
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,          \
           int in_dim, int pred_len, int fmt, int per_gen, void* stream) {                    \
    return launch<T, ilp>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows,         \
                          m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt, per_gen,   \
                          stream);                                                            \
  }

// Launch the rollout on `stream`: K1 with the f32 weight image
// (mggan_decode_select) or, warp per row, the bf16 one
// (mggan_decode_select_bf16_warp), and K5, a warp per pair of rows, with
// either (mggan_decode_select_ilp, _ilp_bf16).
// Return cudaGetLastError() after the launch (0 on success); the caller
// checks shapes and sizes beforehand.
MGGAN_SELECT_ENTRY(mggan_decode_select, float, false)
MGGAN_SELECT_ENTRY(mggan_decode_select_bf16_warp, __nv_bfloat16, false)
MGGAN_SELECT_ENTRY(mggan_decode_select_ilp, float, true)
MGGAN_SELECT_ENTRY(mggan_decode_select_ilp_bf16, __nv_bfloat16, true)

// Resident warps per SM of variant 0 (K1), 1 (the warp-per-row bf16 K1), 2 (K5),
// 3 (K5-bf16)
// with `smem` bytes of weights a block; returns a CUDA error code.
int mggan_decode_select_warps_per_sm(int variant, long long smem, int* warps) {
  switch (variant) {
    case 0: return (int)resident_warps(decode_select_kernel<float>, kThreads, smem, warps);
    case 1: return (int)resident_warps(decode_select_kernel<__nv_bfloat16>, kThreads, smem, warps);
    case 2: return (int)resident_warps(decode_select_ilp_kernel<float>, kThreads, smem, warps);
    case 3:
      return (int)resident_warps(decode_select_ilp_kernel<__nv_bfloat16>, kThreads, smem, warps);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
