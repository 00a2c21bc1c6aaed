// Activation ablations of the fused-selection rollout (B1) for Hopper
// (sm_90a).
//
// Replaces benchmarks/decode_ablation.py::variant_kernel(act) (launched by
// run_variant): K1's recurrence, rel input, f32 weights, with the gate
// activations swapped for one of three policies (decoder_rollout.cuh):
//
//   f32   sigmoid and tanhf, K1's own (ActExact): bit-identical to K1;
//   bf16  the activations in bf16 arithmetic (ActBf16: hexp, __hdiv),
//         rounded where decode_ablation.py:52-63 rounds;
//   lin   x * 0.25 + 0.5 and x * 0.5 (ActLin): wrong numerics by design,
//         the rollout with activations that cost one FMA or multiply.
//
// Design. B1 is the tiled K1 (select_tiled.cuh: rows bucketed by generator
// per tile, R rows of one generator a warp, the launch of
// decoder.py::tiled_launch) instantiated on each policy at the flagship
// widths (H = 32, hid = 16, the TPU script's; other widths are refused), so
// only the activations differ from K1, and the time lin saves is the
// activations' share of today's K1. Per row the fmaf chains are rollout_row's, so each
// variant equals its warp-per-row kernel bit for bit; those
// (decode_select_act_kernel<Act>, a warp per row on
// decoder_rollout.cuh::select_rows, the earlier design) stay compiled as the
// yardsticks (the *_warp entries below); no path launches them.
//
// What they measure on the H100: the tiled K1 spends, per row-step, ~160
// FMAs on the products and ~100 instructions on 5 activations per unit
// (3 sigmoids: expf and an IEEE divide; 2 tanhf), issue-bound with 16 warps
// an SM. lin removes the SFU work and the divides; bf16 runs them on bf16
// values (hexp, __hdiv, with their conversions). Bound: as K1's
// (operations; the SFU is not counted).

#include "select_tiled.cuh"

namespace {

using namespace mggan;

constexpr int kWarpThreads = 512;  // a block of the warp-per-row kernels

template <typename Act>
__global__ void __launch_bounds__(kWarpThreads, 2)
decode_select_act_kernel(const float* __restrict__ wpack, const float* __restrict__ h0,
                         const float* __restrict__ socb, const float* __restrict__ xy0,
                         const float* __restrict__ dxdy0, const int32_t* __restrict__ idx,
                         float* __restrict__ out_abs, float* __restrict__ out_rel,
                         int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                         int hid_dim, int pred_len, int per_gen) {
  extern __shared__ float4 smem4[];
  const Layout L(h_dim, hid_dim, 2, pred_len, kRel);
  select_rows<float, Act>(smem4, wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows,
                          m_rows, num_gens, L, per_gen);
}

template <typename Act>
int launch_warp(const void* wpack, const void* h0, const void* socb, const void* xy0,
                const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
                long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,
                int pred_len, int per_gen, void* stream) {
  const auto kernel = decode_select_act_kernel<Act>;
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  if ((err = persistent_blocks(kernel, kWarpThreads, smem, n_rows, &blocks)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)blocks, kWarpThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, pred_len, per_gen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define MGGAN_ACT_ENTRY(name, Act)                                                             \
  int name(const void* wpack, const void* h0, const void* socb, const void* xy0,              \
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,                  \
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,          \
           int in_dim, int pred_len, int fmt, int per_gen, int rows_per_warp, int tile_rows,  \
           int blocks, void* stream) {                                                        \
    return launch_select_tiled<Act, false>(wpack, h0, socb, xy0, dxdy0, idx, out_abs,         \
                                           out_rel, n_rows, m_rows, num_gens, h_dim, hid_dim, \
                                           in_dim, pred_len, fmt, per_gen, rows_per_warp,     \
                                           tile_rows, blocks, stream);                        \
  }

#define MGGAN_ACT_WARP_ENTRY(name, Act)                                                        \
  int name(const void* wpack, const void* h0, const void* socb, const void* xy0,              \
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,                  \
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,          \
           int pred_len, int per_gen, void* stream) {                                         \
    return launch_warp<Act>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows,       \
                            m_rows, num_gens, h_dim, hid_dim, pred_len, per_gen, stream);     \
  }

// B1 on `stream` with the f32 weight image of K1 and K1's tiled launch
// (decoder.py::tiled_launch; the caller passes rel input): the activations
// of K1 (act_f32), in bf16 (act_bf16) or linear (act_lin). Return
// cudaGetLastError() after the launch; the caller checks the arguments.
MGGAN_ACT_ENTRY(mggan_decode_select_act_f32, ActExact)
MGGAN_ACT_ENTRY(mggan_decode_select_act_bf16, ActBf16)
MGGAN_ACT_ENTRY(mggan_decode_select_act_lin, ActLin)

// The warp-per-row B1 kernels the tiled ones replaced (the yardsticks; no
// path launches them), on the same image.
MGGAN_ACT_WARP_ENTRY(mggan_decode_select_act_f32_warp, ActExact)
MGGAN_ACT_WARP_ENTRY(mggan_decode_select_act_bf16_warp, ActBf16)
MGGAN_ACT_WARP_ENTRY(mggan_decode_select_act_lin_warp, ActLin)

// Resident warps per SM of the tiled variant 0 (f32), 1 (bf16), 2 (lin) for
// R = rows_per_warp at these widths; returns a CUDA error code.
int mggan_decode_select_act_tiled_warps_per_sm(int variant, int rows_per_warp, int num_gens,
                                               int per_gen, int h_dim, int hid_dim,
                                               int pred_len, int* warps) {
  switch (variant) {
    case 0: return select_tiled_warps_per_sm<ActExact, false>(rows_per_warp, num_gens, per_gen, h_dim,
                                                       hid_dim, pred_len, warps);
    case 1: return select_tiled_warps_per_sm<ActBf16, false>(rows_per_warp, num_gens, per_gen, h_dim,
                                                      hid_dim, pred_len, warps);
    case 2: return select_tiled_warps_per_sm<ActLin, false>(rows_per_warp, num_gens, per_gen, h_dim,
                                                     hid_dim, pred_len, warps);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident warps per SM of the warp-per-row variant 0 (f32), 1 (bf16), 2
// (lin) with `smem` bytes of weights a block; returns a CUDA error code.
int mggan_decode_select_act_warps_per_sm(int variant, long long smem, int* warps) {
  switch (variant) {
    case 0: return (int)resident_warps(decode_select_act_kernel<ActExact>, kWarpThreads, smem,
                                       warps);
    case 1: return (int)resident_warps(decode_select_act_kernel<ActBf16>, kWarpThreads, smem,
                                       warps);
    case 2: return (int)resident_warps(decode_select_act_kernel<ActLin>, kWarpThreads, smem,
                                       warps);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
