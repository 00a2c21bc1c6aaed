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
// (mggan_decode_select_bf16), where te, h and hid are rounded to bf16 before
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
// Grouping rows by generator so a warp can reuse each weight load over
// several rows is the next step (K4's idea); it is left for a later change.
// The bf16 variant reads half the weight bytes per row-step but does the
// same fp32 FMAs on converted operands, plus the conversions: bound by the
// same pipes. Its products on the tensor cores (bf16, 989 TFLOP/s) would
// need rows grouped by generator first, as above.

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
  float* smem = reinterpret_cast<float*>(smem4);
  const int total4 = num_gens * per_gen / 4;
  const float4* wpack4 = reinterpret_cast<const float4*>(wpack);
  for (int i = threadIdx.x; i < total4; i += blockDim.x) smem4[i] = wpack4[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const float nan = __int_as_float(0x7fc00000);

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       row < n_rows; row += (int64_t)gridDim.x * warps) {
    const int g = idx[row];
    const int64_t m = row % m_rows;
    float* abs_row = out_abs + row * pred_len * 2;
    float* rel_row = out_rel + row * pred_len * 2;
    if (g < 0 || g >= num_gens) {  // no generator selected: poison the row
      for (int q = lane; q < pred_len * 2; q += 32) {
        abs_row[q] = nan;
        rel_row[q] = nan;
      }
      continue;
    }
    const float sb = lane < hid_dim ? socb[(m * num_gens + g) * hid_dim + lane] : 0.f;
    const float h = lane < h_dim ? h0[row * h_dim + lane] : 0.f;
    rollout_row<T>(smem + (int64_t)g * per_gen, L, lane, h, xy0[m * 2], xy0[m * 2 + 1],
                   dxdy0[m * 2], dxdy0[m * 2 + 1], sb, abs_row, rel_row, nullptr);
  }
}

template <typename T>
int launch(const void* wpack, const void* h0, const void* socb, const void* xy0,
           const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
           long long n_rows, long long m_rows, int num_gens, int h_dim, int hid_dim,
           int in_dim, int pred_len, int fmt, int per_gen, void* stream) {
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = allow_smem(decode_select_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_select_kernel<T>, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long warps = kThreads / 32;
  long long blocks = (n_rows + warps - 1) / warps;
  const long long resident = (long long)sms * per_sm;
  if (blocks > resident) blocks = resident;
  decode_select_kernel<T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim,
      pred_len, fmt, per_gen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the rollout on `stream`, with the f32 weight image (mggan_decode_select)
// or the bf16 one (mggan_decode_select_bf16). Return cudaGetLastError() after
// the launch (0 on success); the caller checks shapes and sizes beforehand.
int mggan_decode_select(const void* wpack, const void* h0, const void* socb,
                        const void* xy0, const void* dxdy0, const void* idx,
                        void* out_abs, void* out_rel, long long n_rows,
                        long long m_rows, int num_gens, int h_dim, int hid_dim,
                        int in_dim, int pred_len, int fmt, int per_gen,
                        void* stream) {
  return launch<float>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows, m_rows,
                       num_gens, h_dim, hid_dim, in_dim, pred_len, fmt, per_gen, stream);
}

int mggan_decode_select_bf16(const void* wpack, const void* h0, const void* socb,
                             const void* xy0, const void* dxdy0, const void* idx,
                             void* out_abs, void* out_rel, long long n_rows,
                             long long m_rows, int num_gens, int h_dim, int hid_dim,
                             int in_dim, int pred_len, int fmt, int per_gen,
                             void* stream) {
  return launch<__nv_bfloat16>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows,
                               m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
                               per_gen, stream);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
