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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

enum Format { kRel = 0, kAbs = 1, kAbsRel = 2 };

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// Per-generator weight block, in floats (the wrapper packs it the same way):
//   whh  [H][H][4]   recurrent weights, [k][j][gate i,f,g,o]
//   wemb [in][H][4]  embedding folded into the input weights
//   b    [H][4]      fused bias
//   w1   [H][hid]    hidden2pos first layer, h part
//   w2   [hid][2]    hidden2pos second layer
//   b2   [2]
// padded to a multiple of 4 floats (per_gen).
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
  const bool own = lane < h_dim;
  const bool own_hid = lane < hid_dim;
  const int off_wemb = h_dim * h_dim * 4;
  const int off_b = off_wemb + in_dim * h_dim * 4;
  const int off_w1 = off_b + h_dim * 4;
  const int off_w2 = off_w1 + h_dim * hid_dim;
  const int off_b2 = off_w2 + hid_dim * 2;
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
    const float* W = smem + (int64_t)g * per_gen;
    const float4* whh4 = reinterpret_cast<const float4*>(W);
    const float4* wemb4 = reinterpret_cast<const float4*>(W + off_wemb);
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bias = own ? reinterpret_cast<const float4*>(W + off_b)[lane] : zero4;
    const float sb = own_hid ? socb[(m * num_gens + g) * hid_dim + lane] : 0.f;
    const float w2x = own_hid ? W[off_w2 + lane * 2] : 0.f;
    const float w2y = own_hid ? W[off_w2 + lane * 2 + 1] : 0.f;
    const float b2x = W[off_b2], b2y = W[off_b2 + 1];

    float x = xy0[m * 2], y = xy0[m * 2 + 1];
    float dx = dxdy0[m * 2], dy = dxdy0[m * 2 + 1];
    float h = own ? h0[row * h_dim + lane] : 0.f;
    float c = 0.f;

    // recurrent part of the first step's gates: h0 @ Whh
    float4 rec = zero4;
    for (int k = 0; k < h_dim; ++k) {
      const float hk = __shfl_sync(kFull, h, k);
      if (own) fma4(rec, hk, whh4[k * h_dim + lane]);
    }

    float keep_x = 0.f, keep_y = 0.f, keep_dx = 0.f, keep_dy = 0.f;
    for (int t = 0; t < pred_len; ++t) {
      float4 acc = rec;
      acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
      if (own) {
        if (fmt == kAbsRel) {  // te = [x y dx dy]
          fma4(acc, x, wemb4[lane]);
          fma4(acc, y, wemb4[h_dim + lane]);
          fma4(acc, dx, wemb4[2 * h_dim + lane]);
          fma4(acc, dy, wemb4[3 * h_dim + lane]);
        } else {  // te = dxdy (rel) or xy (abs)
          fma4(acc, fmt == kRel ? dx : x, wemb4[lane]);
          fma4(acc, fmt == kRel ? dy : y, wemb4[h_dim + lane]);
        }
        c = sigmoid(acc.y) * c + sigmoid(acc.x) * tanhf(acc.z);
        h = sigmoid(acc.w) * tanhf(c);
      }

      // one sweep over the new h: hidden2pos now, recurrent gates for t + 1
      const bool more = t + 1 < pred_len;
      float a = sb;
      rec = zero4;
      for (int k = 0; k < h_dim; ++k) {
        const float hk = __shfl_sync(kFull, h, k);
        if (own_hid) a = fmaf(hk, W[off_w1 + k * hid_dim + lane], a);
        if (more && own) fma4(rec, hk, whh4[k * h_dim + lane]);
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
    if (lane < pred_len) {
      reinterpret_cast<float2*>(abs_row)[lane] = make_float2(keep_x, keep_y);
      reinterpret_cast<float2*>(rel_row)[lane] = make_float2(keep_dx, keep_dy);
    }
  }
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`. Returns cudaGetLastError() after the
// launch (0 on success); the caller checks shapes and sizes beforehand.
int mggan_decode_select(const void* wpack, const void* h0, const void* socb,
                        const void* xy0, const void* dxdy0, const void* idx,
                        void* out_abs, void* out_rel, long long n_rows,
                        long long m_rows, int num_gens, int h_dim, int hid_dim,
                        int in_dim, int pred_len, int fmt, int per_gen,
                        void* stream) {
  const size_t smem = (size_t)num_gens * per_gen * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_select_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long warps = kThreads / 32;
  long long blocks = (n_rows + warps - 1) / warps;
  const long long resident = (long long)sms * per_sm;
  if (blocks > resident) blocks = resident;
  decode_select_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim,
      pred_len, fmt, per_gen);
  return (int)cudaGetLastError();
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
