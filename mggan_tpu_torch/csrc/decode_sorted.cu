// Sorted-selection decoder rollout (K4) for Hopper (sm_90a).
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_sorted_kernel (wrapped by
// pallas_decode_select_sorted; launched alone by
// benchmarks/sorted_select_ablation.py::kernel_only, B2). The rows come
// grouped by sampled generator, each group padded to whole tiles of kTile
// rows (the wrapper's layout, ops/kernels/decode_sorted.py::sorted_layout),
// and tile_gen[tile] names the generator of every row of the tile. Each
// row runs that generator's rollout (decoder_rollout.cuh::rollout_row, the
// arithmetic of K1) from its gathered inputs, one row of
//   rows (n_buf, H + F + 4) = [h0 | soc | xy | dxdy]
// with socb = soc @ W1s_g + b1_g computed here, as the TPU kernel does
// (socb = b1_g when F = 0), and stores [abs | rel] of every step as
// out (n_buf, 2, T, 2).
//
// Design (a simple one that is right first). One block per tile of kTile
// rows, 8 warps, a warp per row (each warp takes kTile / 8 rows). The block
// stages only its generator's weight block (f32 or the bf16 image of
// kernel_weights, ~20 KB or ~10 KB at H=32), then W1s and b1 (~2 KB at
// F=32), where K1 stages all four generators' (~80 KB). The smaller
// footprint lets more blocks share an SM: the launch bounds ask for 4
// blocks of 256 threads (at most 64 registers a thread, as K1), 32 warps
// an SM if registers allow, with 4 x ~22 KB of shared memory instead of
// K1's 2 x 80 KB. The tile is the CUDA block's rows, not the TPU's 1024:
// padding costs at most G tiles of rows.
//
// What bounds it on the H100: as K1 (operations: the same FMAs per row,
// 67 TFLOP/s fp32), plus each block's staging of ~22 KB from L2. A warp
// still runs one row, so each weight load serves one row: K4 answers
// whether the shared-memory footprint and occupancy limit K1, not yet what
// sharing loads across rows of one generator would give (several rows per
// warp, or mma on such groups, is the next step).

#include "decoder_rollout.cuh"

namespace {

using namespace mggan;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;  // rows per block; decode_sorted.py::TILE

// Words of shared memory after the weight block: W1s [F][hid], b1 [hid],
// padded to a multiple of 4.
__host__ __device__ inline int soc_words(int feat, int hid) { return (feat * hid + hid + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
decode_sorted_kernel(const float* __restrict__ wpack,     // (G, per_gen) image of T
                     const float* __restrict__ w1s,       // (G, F, hid)
                     const float* __restrict__ b1,        // (G, hid)
                     const int32_t* __restrict__ tile_gen,  // (n_buf / kTile,)
                     const float* __restrict__ rows,      // (n_buf, H + F + 4)
                     float* __restrict__ out,             // (n_buf, 2, T, 2)
                     int num_gens, int feat, int h_dim, int hid_dim, int in_dim,
                     int pred_len, int fmt, int per_gen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = tile_gen[blockIdx.x];
  if (g < 0 || g >= num_gens) {  // a tile with no generator: poison its rows
    float* o = out + (int64_t)blockIdx.x * kTile * pred_len * 4;
    for (int i = threadIdx.x; i < kTile * pred_len * 4; i += blockDim.x)
      o[i] = __int_as_float(0x7fc00000);
    return;
  }
  float* w1s_s = smem + per_gen;
  float* b1_s = w1s_s + feat * hid_dim;
  for (int i = threadIdx.x; i < feat * hid_dim; i += blockDim.x)
    w1s_s[i] = w1s[(int64_t)g * feat * hid_dim + i];
  for (int i = threadIdx.x; i < hid_dim; i += blockDim.x) b1_s[i] = b1[g * hid_dim + i];
  stage_weights(smem4, wpack + (int64_t)g * per_gen, per_gen);

  const int lane = threadIdx.x & 31;
  const int width = h_dim + feat + 4;
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  for (int r = threadIdx.x >> 5; r < kTile; r += kWarps) {
    const int64_t row = (int64_t)blockIdx.x * kTile + r;
    const float* in = rows + row * width;
    const float h = lane < h_dim ? in[lane] : 0.f;
    // socb = soc @ W1s + b1: lane f holds soc[f], lane q sums column q
    const float soc = lane < feat ? in[h_dim + lane] : 0.f;
    float sb = 0.f;
    for (int f = 0; f < feat; ++f) {
      const float sf = __shfl_sync(kFull, soc, f);
      if (lane < hid_dim) sb = fmaf(sf, w1s_s[f * hid_dim + lane], sb);
    }
    sb = lane < hid_dim ? sb + b1_s[lane] : 0.f;
    const float* xy = in + h_dim + feat;
    float* o = out + row * pred_len * 4;
    rollout_row<T>(smem, L, lane, h, xy[0], xy[1], xy[2], xy[3], sb, o, o + pred_len * 2,
                   nullptr);
  }
}

size_t smem_bytes(int feat, int hid, int per_gen) {
  return sizeof(float) * ((size_t)per_gen + soc_words(feat, hid));
}

template <typename T>
int launch(const void* wpack, const void* w1s, const void* b1, const void* tile_gen,
           const void* rows, void* out, long long n_buf, int num_gens, int feat, int h_dim,
           int hid_dim, int in_dim, int pred_len, int fmt, int per_gen, void* stream) {
  if (n_buf % kTile) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(feat, hid_dim, per_gen);
  cudaError_t err = allow_smem(decode_sorted_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  decode_sorted_kernel<T><<<(unsigned)(n_buf / kTile), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)w1s, (const float*)b1, (const int32_t*)tile_gen,
      (const float*)rows, (float*)out, num_gens, feat, h_dim, hid_dim, in_dim, pred_len, fmt,
      per_gen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile (one block each).
int mggan_decode_sorted_tile() { return kTile; }

// K4 on `stream` over n_buf / kTile tiles, with the f32 weight image
// (mggan_decode_sorted) or the bf16 one (mggan_decode_sorted_bf16). Returns
// cudaGetLastError() after the launch; the caller checks the arguments.
int mggan_decode_sorted(const void* wpack, const void* w1s, const void* b1,
                        const void* tile_gen, const void* rows, void* out, long long n_buf,
                        int num_gens, int feat, int h_dim, int hid_dim, int in_dim,
                        int pred_len, int fmt, int per_gen, void* stream) {
  return launch<float>(wpack, w1s, b1, tile_gen, rows, out, n_buf, num_gens, feat, h_dim,
                       hid_dim, in_dim, pred_len, fmt, per_gen, stream);
}

int mggan_decode_sorted_bf16(const void* wpack, const void* w1s, const void* b1,
                             const void* tile_gen, const void* rows, void* out,
                             long long n_buf, int num_gens, int feat, int h_dim, int hid_dim,
                             int in_dim, int pred_len, int fmt, int per_gen, void* stream) {
  return launch<__nv_bfloat16>(wpack, w1s, b1, tile_gen, rows, out, n_buf, num_gens, feat,
                               h_dim, hid_dim, in_dim, pred_len, fmt, per_gen, stream);
}

// Shared memory of one block, in bytes.
long long mggan_decode_sorted_smem(int feat, int hid_dim, int per_gen) {
  return (long long)smem_bytes(feat, hid_dim, per_gen);
}

// Resident warps per SM of the f32 (bf16 = 0) or bf16 kernel at `smem`
// bytes a block; returns a CUDA error code.
int mggan_decode_sorted_warps_per_sm(int bf16, long long smem, int* warps) {
  return bf16 ? (int)resident_warps(decode_sorted_kernel<__nv_bfloat16>, kThreads, smem, warps)
              : (int)resident_warps(decode_sorted_kernel<float>, kThreads, smem, warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
