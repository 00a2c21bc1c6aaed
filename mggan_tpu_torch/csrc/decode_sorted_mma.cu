// Sorted-selection decoder rollout in bf16 on the tensor cores (K4-bf16) for
// Hopper (sm_90a).
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_sorted_kernel with
// compute_dtype=bfloat16 (wrapped by pallas_decode_select_sorted). The rows
// come grouped by sampled generator, each group padded to whole tiles of
// kTile rows (the wrapper's layout, ops/kernels/decode_sorted.py::
// sorted_layout), and tile_gen[tile] names the generator of every row of the
// tile. Each row of
//   rows (n_buf, H + F + 4) = [h0 | soc | xy | dxdy]
// runs that generator's bf16 rollout, with socb = soc @ W1s_g + b1_g
// computed here in f32, as the TPU kernel does (decoder.py:385-390; socb =
// b1_g when F = 0), and stores [abs | rel] of every step as out (n_buf, 2,
// T, 2). Every buffer row is written: padding rows roll out their zero
// inputs, as the plain version (sorted_tiles_reference) does; a tile with no
// generator is poisoned with NaN.
//
// Design. One block per tile of kTile = 128 rows, the layout the f32 K4 and
// the route already use. The block stages only its generator's fragment
// image (decoder.py::mma_weights, ~13 KB), W1s and b1 (~2 KB at F = 32,
// hid = 16), then computes the tile's socb into shared memory (kTile x hid
// f32: per row and column an fmaf over f ascending from 0, then + b1, the
// order of the warp-per-row K4). Its warps then roll out the tile's 8 groups
// of 16 rows with K1-bf16's tensor-core rollout (rollout_mma.cuh::
// rollout_group), reading h0, xy and dxdy from the buffer and socb from
// shared memory through SortedInputs. The rows of a tile share a generator
// by construction, so no bucketing is needed, and a group is never padded.
//
// What bounds it on the H100: as K1-bf16 (the gate activations on the CUDA
// cores and the SFU, not the tensor cores or device memory), plus each
// block's staging (~15 KB from L2) and its socb prologue (F FMAs per row and
// hidden2pos column). The launch picks the warps a block
// (decode_sorted.py::MMA_WARPS, from chip_smoke.py --sweep) with 16 warps an
// SM in every variant, as K1-bf16.

#include "rollout_mma.cuh"

namespace {

using namespace mggan;

constexpr int kTile = 128;  // rows per block; decode_sorted.py::TILE
constexpr int kGroups = kTile / kMmaGroup;

// The rows of one tile of K4's buffer as rollout_group reads them (the
// accessor of rollout_mma.cuh): h0, xy and dxdy from the buffer, socb from
// the tile's shared-memory copy; a row is its own agent. out rows hold
// [abs | rel], 2 T steps of (x, y).
struct SortedInputs {
  static constexpr int kOutSteps = 2;
  const float* __restrict__ rows;  // the tile's first row: (kTile, width)
  const float* socb;               // shared memory: (kTile, hid)
  int width;                       // H + F + 4

  __device__ __forceinline__ int64_t agent(int64_t row) const { return row; }
  __device__ __forceinline__ float h(int64_t row, int col, const Layout&) const {
    return rows[row * width + col];
  }
  __device__ __forceinline__ float sb(int64_t m, int, int col, const Layout& L) const {
    return socb[m * L.hid + col];
  }
  __device__ __forceinline__ float xy(int64_t m, int k) const {
    return rows[m * width + (width - 4) + k];
  }
  __device__ __forceinline__ float dxdy(int64_t m, int k) const {
    return rows[m * width + (width - 2) + k];
  }
};

// Shared memory after the image, in 4-byte words: W1s [F][hid], b1 [hid],
// padded to a multiple of 4; then socb [kTile][hid].
__host__ __device__ inline int soc_words(int feat, int hid) { return (feat * hid + hid + 3) & ~3; }

inline size_t smem_bytes(int feat, int hid) {
  return sizeof(float) * ((size_t)kImageWords + soc_words(feat, hid) + (size_t)kTile * hid);
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
decode_sorted_mma_kernel(const float* __restrict__ wimg,       // (G, kImageWords)
                         const float* __restrict__ w1s,        // (G, F, hid)
                         const float* __restrict__ b1,         // (G, hid)
                         const int32_t* __restrict__ tile_gen,  // (n_buf / kTile,)
                         const float* __restrict__ rows,       // (n_buf, H + F + 4)
                         float* __restrict__ out,              // (n_buf, 2, T, 2)
                         int num_gens, int feat, int h_dim, int hid_dim, int in_dim,
                         int pred_len, int fmt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = tile_gen[blockIdx.x];
  if (g < 0 || g >= num_gens) {  // a tile with no generator: poison its rows
    float* o = out + (int64_t)blockIdx.x * kTile * pred_len * 4;
    for (int i = threadIdx.x; i < kTile * pred_len * 4; i += blockDim.x)
      o[i] = __int_as_float(0x7fc00000);
    return;
  }
  float* w1s_s = smem + kImageWords;
  float* b1_s = w1s_s + feat * hid_dim;
  float* socb_s = smem + kImageWords + soc_words(feat, hid_dim);
  for (int i = threadIdx.x; i < feat * hid_dim; i += blockDim.x)
    w1s_s[i] = w1s[(int64_t)g * feat * hid_dim + i];
  for (int i = threadIdx.x; i < hid_dim; i += blockDim.x) b1_s[i] = b1[g * hid_dim + i];
  stage_weights(smem4, wimg + (int64_t)g * kImageWords, kImageWords);  // ends with a barrier

  // socb = soc @ W1s + b1 in f32: a thread per row and 4 columns
  const int width = h_dim + feat + 4;
  const float* tile = rows + (int64_t)blockIdx.x * kTile * width;
  const int quads = (hid_dim + 3) / 4;
  for (int o = threadIdx.x; o < kTile * quads; o += blockDim.x) {
    const int r = o / quads, j0 = 4 * (o % quads);
    const float* soc = tile + r * width + h_dim;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f = 0; f < feat; ++f) {
      const float sf = soc[f];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < hid_dim) acc[e] = fmaf(sf, w1s_s[f * hid_dim + j0 + e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + e < hid_dim) socb_s[r * hid_dim + j0 + e] = acc[e] + b1_s[j0 + e];
  }
  __syncthreads();

  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const SortedInputs in{tile, socb_s, width};
  const uint32_t* W = reinterpret_cast<const uint32_t*>(smem4);
  const int lane = threadIdx.x & 31;
  for (int grp = threadIdx.x >> 5; grp < kGroups; grp += kWarps) {
    int64_t in_row[2], out_row[2];  // this lane's rows r and r + 8 of the group
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      in_row[i] = grp * kMmaGroup + (lane >> 2) + 8 * i;
      out_row[i] = (int64_t)blockIdx.x * kTile + in_row[i];
    }
    rollout_group(W, g, in_row, out_row, in, out, out + pred_len * 2, nullptr, L, lane);
  }
}

using Kernel = decltype(&decode_sorted_mma_kernel<4>);

// The launch variants (decode_sorted.py::MMA_WARPS, in this order): warps a
// block, at 16 warps an SM.
inline Kernel kernel_of(int variant, int* threads) {
  switch (variant) {
    case 0: *threads = 2 * 32; return decode_sorted_mma_kernel<2>;
    case 1: *threads = 4 * 32; return decode_sorted_mma_kernel<4>;
    case 2: *threads = 8 * 32; return decode_sorted_mma_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Rows per tile (one block each).
int mggan_decode_sorted_mma_tile() { return kTile; }

// Shared memory of one block, in bytes.
long long mggan_decode_sorted_mma_smem(int feat, int hid_dim) {
  return (long long)smem_bytes(feat, hid_dim);
}

// K4-bf16 on `stream` over n_buf / kTile tiles with the fragment image
// `wimg` (G, image words) and launch variant `variant` (kernel_of). Returns
// cudaGetLastError() after the launch (0 on success); the caller checks the
// arguments (H, hid <= 32, in <= 8, F <= 32).
int mggan_decode_sorted_bf16(const void* wimg, const void* w1s, const void* b1,
                             const void* tile_gen, const void* rows, void* out,
                             long long n_buf, int num_gens, int feat, int h_dim, int hid_dim,
                             int in_dim, int pred_len, int fmt, int variant, void* stream) {
  int threads = 0;
  const Kernel kernel = kernel_of(variant, &threads);
  if (kernel == nullptr || n_buf % kTile || h_dim > 32 || hid_dim > 32 || in_dim > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(feat, hid_dim);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(n_buf / kTile), threads, smem, (cudaStream_t)stream>>>(
      (const float*)wimg, (const float*)w1s, (const float*)b1, (const int32_t*)tile_gen,
      (const float*)rows, (float*)out, num_gens, feat, h_dim, hid_dim, in_dim, pred_len, fmt);
  return (int)cudaGetLastError();
}

// Resident warps per SM of launch variant `variant` at F = feat, hid_dim.
int mggan_decode_sorted_bf16_warps_per_sm(int variant, int feat, int hid_dim, int* warps) {
  int threads = 0;
  const Kernel kernel = kernel_of(variant, &threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, threads, smem_bytes(feat, hid_dim), warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
