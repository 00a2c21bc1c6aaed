// Sorted-selection decoder rollout in f32 (K4, and B2, its kernel alone) for
// Hopper (sm_90a), with rows of the tile's generator tiled per warp.
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_sorted_kernel (wrapped by
// pallas_decode_select_sorted; launched alone by
// benchmarks/sorted_select_ablation.py::kernel_only, B2). The rows come
// grouped by sampled generator, each group padded to whole tiles of kTile
// rows (the wrapper's layout, ops/kernels/decode_sorted.py::sorted_layout),
// and tile_gen[tile] names the generator of every row of the tile. Each row
// of
//   rows (n_buf, H + F + 4) = [h0 | soc | xy | dxdy]
// runs that generator's rollout, with socb = soc @ W1s_g + b1_g computed
// here, as the TPU kernel does (decoder.py:385-390; socb = b1_g when F = 0),
// and stores [abs | rel] of every step as out (n_buf, 2, T, 2). Every
// buffer row is written: padding rows roll out their zero inputs, as the
// plain version (sorted_tiles_reference) does; a tile with no generator is
// poisoned with NaN.
//
// Design. One block per tile of kTile = 128 rows, the layout of the route.
// The block stages only its generator's f32 weight block (kernel_weights'
// [k][j][gate] image, ~20 KB at H = 32), W1s and b1 (~2 KB at F = 32,
// hid = 16), then computes the tile's socb into shared memory (kTile x hid
// f32: per row and column an fmaf over f ascending from 0, then + b1, the
// order of the warp-per-row K4). Its warps then roll out the tile's 32
// groups of kRows = 4 consecutive rows with the tiled K1's rollout
// (rollout_tile.cuh::rollout_tile): lane j owns hidden unit j for the 4
// rows, so each weight load from shared memory serves 4 rows. The rows of a
// tile share a generator by construction, so no bucketing is needed and no
// group is padded. A row's [abs | rel] are rows 2i and 2i + 1 of out seen
// as (2 n_buf, T, 2), so rollout_tile stores them as they are.
//
// Per row the arithmetic is rollout_row's in its order, and socb's is the
// warp-per-row K4's, so the output equals that kernel's
// (decode_sorted.cu, mggan_decode_sorted_warp, kept as the yardstick) bit
// for bit. H = 32, hid = 16 (the flagship) are a compile-time
// instantiation; other widths take the generic one.
//
// What bounds it on the H100: as the tiled K1 (instruction issue on the
// FMAs and the activations), plus each block's staging (~22 KB from L2) and
// its socb prologue (F FMAs per row and hidden2pos column). The launch
// variants are the warps a block, 8 or 4 (kernel_of, in the order of
// decode_sorted.py::TILED_WARPS), picked by decode_sorted.py::tiled_variant
// from chip_smoke.py --sweep; the launch bounds ask for 16 warps an SM, as
// the tiled K1 (96 registers: 4-warp blocks fit 20). Groups of 1 or 2 rows
// were slower at every row count swept (PERF.md).

#include "rollout_tile.cuh"

namespace {

using namespace mggan;

constexpr int kTile = 128;  // rows per block; decode_sorted.py::TILE
constexpr int kRows = 4;    // rows of a warp's group; decode_sorted.py::TILED_GROUP

// Shared memory after the weight block, in 4-byte words: W1s [F][hid], b1
// [hid], padded to a multiple of 4; then socb [kTile][hid], then the warps'
// staging.
__host__ __device__ inline int soc_words(int feat, int hid) { return (feat * hid + hid + 3) & ~3; }

inline size_t smem_bytes(int warps, int feat, int h, int hid, int t, int per_gen) {
  return sizeof(float) * ((size_t)per_gen + soc_words(feat, hid) + (size_t)kTile * hid +
                          (size_t)warps * tile_stage_floats(kRows, h, t));
}

template <int kWarps, int kH, int kHid>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
decode_sorted_tiled_kernel(const float* __restrict__ wpack,       // (G, per_gen)
                           const float* __restrict__ w1s,         // (G, F, hid)
                           const float* __restrict__ b1,          // (G, hid)
                           const int32_t* __restrict__ tile_gen,  // (n_buf / kTile,)
                           const float* __restrict__ rows,        // (n_buf, H + F + 4)
                           float* __restrict__ out,               // (n_buf, 2, T, 2)
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
  const int H = kH > 0 ? kH : h_dim, hid = kHid > 0 ? kHid : hid_dim;
  float* w1s_s = smem + per_gen;
  float* b1_s = w1s_s + feat * hid;
  float* socb_s = smem + per_gen + soc_words(feat, hid);
  float* stages = socb_s + kTile * hid;
  for (int i = threadIdx.x; i < feat * hid; i += blockDim.x)
    w1s_s[i] = w1s[(int64_t)g * feat * hid + i];
  for (int i = threadIdx.x; i < hid; i += blockDim.x) b1_s[i] = b1[g * hid + i];
  stage_weights(smem4, wpack + (int64_t)g * per_gen, per_gen);  // ends with a barrier

  // socb = soc @ W1s + b1 in f32: a thread per row and 4 columns
  const int width = H + feat + 4;
  const float* tile = rows + (int64_t)blockIdx.x * kTile * width;
  const int quads = (hid + 3) / 4;
  for (int o = threadIdx.x; o < kTile * quads; o += blockDim.x) {
    const int r = o / quads, j0 = 4 * (o % quads);
    const float* soc = tile + r * width + H;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f = 0; f < feat; ++f) {
      const float sf = soc[f];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < hid) acc[e] = fmaf(sf, w1s_s[f * hid + j0 + e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + e < hid) socb_s[r * hid + j0 + e] = acc[e] + b1_s[j0 + e];
  }
  __syncthreads();

  const Layout L(H, hid, in_dim, pred_len, fmt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = stages + warp * tile_stage_floats(kRows, H, pred_len);
  const int64_t first = (int64_t)blockIdx.x * kTile;
  for (int grp = warp; grp < kTile / kRows; grp += kWarps) {
    float h[kRows], x[kRows], y[kRows], dx[kRows], dy[kRows], sb[kRows];
    int64_t out_row[kRows];  // buffer row i's [abs | rel]: rows 2i, 2i + 1 of (2 n_buf, T, 2)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = grp * kRows + r;
      const float* in = tile + i * width;
      h[r] = lane < H ? in[lane] : 0.f;
      sb[r] = lane < hid ? socb_s[i * hid + lane] : 0.f;
      x[r] = in[width - 4];
      y[r] = in[width - 3];
      dx[r] = in[width - 2];
      dy[r] = in[width - 1];
      out_row[r] = 2 * (first + i);
    }
    rollout_tile<kRows, kH, kHid>(smem, L, lane, stage, h, x, y, dx, dy, sb, out_row, out,
                                  out + pred_len * 2, nullptr);
  }
}

using Kernel = decltype(&decode_sorted_tiled_kernel<8, 0, 0>);

template <int kWarps>
inline Kernel instance(bool flagship) {
  return flagship ? decode_sorted_tiled_kernel<kWarps, 32, 16>
                  : decode_sorted_tiled_kernel<kWarps, 0, 0>;
}

// The launch variants (decode_sorted.py::TILED_WARPS, in this order): the
// warps a block.
constexpr int kVariants[] = {8, 4};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

inline Kernel kernel_of(int variant, int h, int hid) {
  const bool flagship = h == 32 && hid == 16;
  switch (variant) {
    case 0: return instance<8>(flagship);
    case 1: return instance<4>(flagship);
    default: return nullptr;
  }
}

inline size_t variant_smem(int variant, int feat, int h, int hid, int t, int per_gen) {
  return smem_bytes(kVariants[variant], feat, h, hid, t, per_gen);
}

}  // namespace

extern "C" {

// Rows per tile (one block each).
int mggan_decode_sorted_tiled_tile() { return kTile; }

// Rows of a warp's group.
int mggan_decode_sorted_tiled_rows() { return kRows; }

// Launch variant `variant`'s warps a block (0 for no such variant).
int mggan_decode_sorted_tiled_warps(int variant) {
  return variant < 0 || variant >= kNumVariants ? 0 : kVariants[variant];
}

// Shared memory of one block of launch variant `variant`, in bytes (0 for
// no such variant).
long long mggan_decode_sorted_tiled_smem(int variant, int feat, int h_dim, int hid_dim,
                                         int pred_len, int per_gen) {
  if (variant < 0 || variant >= kNumVariants) return 0;
  return (long long)variant_smem(variant, feat, h_dim, hid_dim, pred_len, per_gen);
}

// The tiled K4 on `stream` over n_buf / kTile tiles with the f32 weight
// image and launch variant `variant` (kernel_of). Returns
// cudaGetLastError() after the launch (0 on success); the caller checks the
// arguments (H, hid, F, T <= 32).
int mggan_decode_sorted(const void* wpack, const void* w1s, const void* b1,
                        const void* tile_gen, const void* rows, void* out, long long n_buf,
                        int num_gens, int feat, int h_dim, int hid_dim, int in_dim,
                        int pred_len, int fmt, int per_gen, int variant, void* stream) {
  const Kernel kernel = kernel_of(variant, h_dim, hid_dim);
  if (kernel == nullptr || n_buf % kTile) return (int)cudaErrorInvalidValue;
  const size_t smem = variant_smem(variant, feat, h_dim, hid_dim, pred_len, per_gen);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(n_buf / kTile), kVariants[variant] * 32, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)w1s, (const float*)b1, (const int32_t*)tile_gen,
      (const float*)rows, (float*)out, num_gens, feat, h_dim, hid_dim, in_dim, pred_len, fmt,
      per_gen);
  return (int)cudaGetLastError();
}

// Resident warps per SM of launch variant `variant` at these widths;
// returns a CUDA error code.
int mggan_decode_sorted_tiled_warps_per_sm(int variant, int feat, int h_dim, int hid_dim,
                                           int pred_len, int per_gen, int* warps) {
  const Kernel kernel = kernel_of(variant, h_dim, hid_dim);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kVariants[variant] * 32,
                             variant_smem(variant, feat, h_dim, hid_dim, pred_len, per_gen),
                             warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
