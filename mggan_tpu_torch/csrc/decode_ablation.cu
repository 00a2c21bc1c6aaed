// Activation ablations of the fused-selection rollout (B1) for Hopper
// (sm_90a).
//
// Replaces benchmarks/decode_ablation.py::variant_kernel(act) (launched by
// run_variant): K1's recurrence (decode_select.cu), rel input, f32 weights,
// with the gate activations swapped for one of three policies:
//
//   f32   sigmoid and tanhf, K1's own (ActExact): bit-identical to K1;
//   bf16  the activations in bf16 arithmetic, rounded where
//         decode_ablation.py:52-63 rounds: the input to bf16, then exp, the
//         add or subtract and the divide each to bf16
//           sig(x) = 1 / (1 + exp(-x)),  tnh(x) = (exp(2x) - 1) / (exp(2x) + 1);
//   lin   x * 0.25 + 0.5 and x * 0.5: wrong numerics by design, the rollout
//         with activations that cost one FMA or multiply.
//
// What they measure on the H100: K1 spends, per row-step, 5 activations
// (3 sigmoids, 2 tanhs, each an exp or tanh on the SFU plus a divide) on
// each of H lanes, against ~5 H FMAs and H shuffles per lane. lin removes
// the SFU work and the divides: the time it saves is their share of K1.
// bf16 runs them on bf16 values (hexp, __hdiv): whether cheaper
// transcendentals pay here. The kernels share K1's row loop, block shape
// and launch bounds (decoder_rollout.cuh::select_rows), so only the
// activations differ. Bound: as K1's (operations; the SFU is not counted).

#include "decoder_rollout.cuh"

namespace {

using namespace mggan;

constexpr int kThreads = 512;  // as K1

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
};

struct ActLin {
  static __device__ __forceinline__ float sig(float x) { return x * 0.25f + 0.5f; }
  static __device__ __forceinline__ float tnh(float x) { return x * 0.5f; }
};

template <typename Act>
__global__ void __launch_bounds__(kThreads, 2)
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
int launch(const void* wpack, const void* h0, const void* socb, const void* xy0,
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,
           int pred_len, int per_gen, void* stream) {
  const auto kernel = decode_select_act_kernel<Act>;
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  if ((err = persistent_blocks(kernel, kThreads, smem, n_rows, &blocks)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
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
           int pred_len, int per_gen, void* stream) {                                         \
    return launch<Act>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows, m_rows,    \
                       num_gens, h_dim, hid_dim, pred_len, per_gen, stream);                  \
  }

// B1 on `stream` with the f32 weight image of K1 (rel input): the
// activations of K1 (act_f32), in bf16 (act_bf16) or linear (act_lin).
// Return cudaGetLastError() after the launch; the caller checks the
// arguments beforehand.
MGGAN_ACT_ENTRY(mggan_decode_select_act_f32, ActExact)
MGGAN_ACT_ENTRY(mggan_decode_select_act_bf16, ActBf16)
MGGAN_ACT_ENTRY(mggan_decode_select_act_lin, ActLin)

// Resident warps per SM of variant 0 (f32), 1 (bf16), 2 (lin) with `smem`
// bytes of weights a block; returns a CUDA error code.
int mggan_decode_select_act_warps_per_sm(int variant, long long smem, int* warps) {
  switch (variant) {
    case 0: return (int)resident_warps(decode_select_act_kernel<ActExact>, kThreads, smem, warps);
    case 1: return (int)resident_warps(decode_select_act_kernel<ActBf16>, kThreads, smem, warps);
    case 2: return (int)resident_warps(decode_select_act_kernel<ActLin>, kThreads, smem, warps);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
