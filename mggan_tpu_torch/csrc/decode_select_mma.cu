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
// rolls out 16 rows of one generator at a time with mma.sync
// (rollout_mma.cuh::rollout_group, shared with K2-bf16 in decode_all.cu, so
// the two agree bit for bit on the selected rows). All G generators'
// fragment images sit in shared memory. Padded rows of a bucket compute on
// zeros and store nothing; a row with no generator (idx out of range) is
// poisoned with NaN, as in decode_select.cu.
//
// What bounds it on the H100: not the tensor cores (the products are ~3 %
// of the issue slots), nor device memory (~0.4 KB a row), but the gate
// activations on the CUDA cores and the SFU: 3 sigmoids (expf, divide) and
// 2 tanhf per hidden unit per row-step, as in the warp kernel, which also
// spent ~12 instructions per weight (shuffle, load, unpack, FMAs) that the
// fragments now replace. Rows of one generator share every weight load and
// every broadcast of h, 16 at a time.

#include "rollout_mma.cuh"
#include "tile_buckets.cuh"

namespace {

using namespace mggan;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 256;   // rows of a tile, at most
constexpr int kMaxGens = 32;    // generators a block can bucket (a warp's lanes)

// The tile's bucketing in shared memory, after the G images (sized for G,
// so that four blocks fit on an SM at G = 4).
using Buckets = TileBuckets<kWarps, kMaxTile, kMmaGroup>;

__host__ __device__ inline size_t smem_bytes(int num_gens) {
  return ((size_t)num_gens * kImageWords + Buckets::ints(num_gens)) * sizeof(float);
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
      int64_t in_row[2], out_row[2];  // this lane's rows r and r + 8 of the group
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int slot = s.slots[grp * kMmaGroup + (lane >> 2) + 8 * i];
        in_row[i] = slot >= 0 ? base + slot : 0;
        out_row[i] = slot >= 0 ? base + slot : -1;
      }
      rollout_group(images + (size_t)gen * kImageWords, gen, in_row, out_row, h0, socb, xy0,
                    dxdy0, out_abs, out_rel, nullptr, m_rows, num_gens, L, lane);
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
