// Fused-selection decoder rollout in bf16 on the tensor cores (K1-bf16), and
// its ILP variant (K5-bf16), for Hopper (sm_90a).
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
//
// K5-bf16 (decode_select_mma_ilp_kernel) replaces _fwd_select_kernel_ilp
// with compute_dtype=bfloat16 (pallas_decode_select(ilp=True)): the same
// function, with each warp advancing two groups of 16 rows of one generator
// at once (rollout_mma.cuh::rollout_groups<2>), each stage issued for both
// groups in turn. Buckets are padded to 32 rows, so a bucket is whole pairs
// of groups, and a lone group runs with a group of padding rows: a
// one-group path beside the pairs' made the kernel 1.4x slower at 1,310,720
// rows on an H100 (chip_smoke.py --sweep), the larger code the suspect. Each
// row keeps K1-bf16's products in K1-bf16's order, so the output equals
// K1-bf16's bit for bit. Two groups' state (h fragments, c, socb,
// positions) doubles a warp's registers (~215): the launch takes 2 blocks
// an SM without spills or 3 with (decoder.py::mma_ilp_launch, from the
// sweep), against K1-bf16's 4. If K5-bf16 were faster than K1-bf16,
// K1-bf16 would leave latency to hide.

#include "rollout_mma.cuh"
#include "tile_buckets.cuh"

namespace {

using namespace mggan;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 256;     // rows of a K1-bf16 tile, at most
constexpr int kMaxIlpTile = 1024;  // rows of a K5-bf16 tile, at most
constexpr int kMaxGens = 32;      // generators a block can bucket (a warp's lanes)

// The tile's bucketing in shared memory, after the G images (sized for G,
// so that four blocks fit on an SM at G = 4): groups of 16 rows for
// K1-bf16, pairs of them for K5-bf16.
using Buckets = TileBuckets<kWarps, kMaxTile, kMmaGroup>;
using PairBuckets = TileBuckets<kWarps, kMaxIlpTile, 2 * kMmaGroup>;

template <class B>
__host__ __device__ inline size_t smem_bytes(int num_gens) {
  return ((size_t)num_gens * kImageWords + B::ints(num_gens)) * sizeof(float);
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
      rollout_group(images + (size_t)gen * kImageWords, gen, in_row, out_row,
                    SelectInputs{h0, socb, xy0, dxdy0, m_rows, num_gens}, out_abs, out_rel,
                    nullptr, L, lane);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

// K5-bf16: K1-bf16's grid and tiles (tile_rows a multiple of 32, at most
// kMaxIlpTile), a warp per pair of groups of one generator; kMinBlocks
// blocks an SM at least (the register budget).
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_select_mma_ilp_kernel(const float* __restrict__ wpack, const float* __restrict__ h0,
                             const float* __restrict__ socb, const float* __restrict__ xy0,
                             const float* __restrict__ dxdy0, const int32_t* __restrict__ idx,
                             float* __restrict__ out_abs, float* __restrict__ out_rel,
                             int64_t n_rows, int64_t m_rows, int num_gens, int h_dim,
                             int hid_dim, int in_dim, int pred_len, int fmt, int tile_rows) {
  extern __shared__ float4 smem4[];
  stage_weights(smem4, wpack, num_gens * kImageWords);
  const uint32_t* images = reinterpret_cast<const uint32_t*>(smem4);
  const PairBuckets s = PairBuckets::at(
      reinterpret_cast<int*>(reinterpret_cast<float*>(smem4) + (size_t)num_gens * kImageWords),
      num_gens);
  const Layout L(h_dim, hid_dim, in_dim, pred_len, fmt);
  const SelectInputs in{h0, socb, xy0, dxdy0, m_rows, num_gens};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * tile_rows;
    const int rows = (int)(n_rows - base < tile_rows ? n_rows - base : tile_rows);
    s.bucket(idx, base, rows, num_gens, pred_len, out_abs, out_rel);
    for (int pair = warp; pair < *s.groups; pair += kWarps) {
      const int gen = s.group_gen[pair];
      const int* slots = s.slots + pair * 2 * kMmaGroup;
      int64_t in_row[2][2], out_row[2][2];  // group p's rows r and r + 8 of this lane
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int slot = slots[p * kMmaGroup + (lane >> 2) + 8 * i];
          in_row[p][i] = slot >= 0 ? base + slot : 0;
          out_row[p][i] = slot >= 0 ? base + slot : -1;
        }
      rollout_groups<2>(images + (size_t)gen * kImageWords, gen, in_row, out_row, in, out_abs,
                        out_rel, nullptr, L, lane);
    }
    __syncthreads();  // the next tile's bucketing reuses s
  }
}

using IlpKernel = decltype(&decode_select_mma_ilp_kernel<2>);

// K5-bf16's launch variants (decoder.py::MMA_ILP_BLOCKS_PER_SM, in this
// order): the blocks an SM the registers must allow.
inline IlpKernel ilp_kernel(int variant) {
  switch (variant) {
    case 0: return decode_select_mma_ilp_kernel<2>;
    case 1: return decode_select_mma_ilp_kernel<3>;
    default: return nullptr;
  }
}

// A persistent grid of `kernel` over the tiles of tile_rows rows: one block
// per tile, at most as many as fit on the card at once.
template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, size_t smem, const void* wpack, const void* h0,
                         const void* socb, const void* xy0, const void* dxdy0, const void* idx,
                         void* out_abs, void* out_rel, long long n_rows, long long m_rows,
                         int num_gens, int h_dim, int hid_dim, int in_dim, int pred_len, int fmt,
                         int tile_rows, void* stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (n_rows + tile_rows - 1) / tile_rows;
  const long long resident = (long long)sms * per_sm;
  const long long blocks = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wpack, (const float*)h0, (const float*)socb, (const float*)xy0,
      (const float*)dxdy0, (const int32_t*)idx, (float*)out_abs, (float*)out_rel,
      (int64_t)n_rows, (int64_t)m_rows, num_gens, h_dim, hid_dim, in_dim, pred_len, fmt,
      tile_rows);
  return cudaGetLastError();
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
  if (tile_rows % 32 || tile_rows < 32 || tile_rows > kMaxTile)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tiles(decode_select_mma_kernel, smem_bytes<Buckets>(num_gens), wpack, h0,
                           socb, xy0, dxdy0, idx, out_abs, out_rel, n_rows, m_rows, num_gens,
                           h_dim, hid_dim, in_dim, pred_len, fmt, tile_rows, stream);
}

// K5-bf16 on `stream`, as mggan_decode_select_bf16, with tiles of up to
// kMaxIlpTile rows and launch variant `variant` (ilp_kernel).
int mggan_decode_select_ilp_bf16(const void* wpack, const void* h0, const void* socb,
                                 const void* xy0, const void* dxdy0, const void* idx,
                                 void* out_abs, void* out_rel, long long n_rows,
                                 long long m_rows, int num_gens, int h_dim, int hid_dim,
                                 int in_dim, int pred_len, int fmt, int tile_rows, int variant,
                                 void* stream) {
  const IlpKernel kernel = ilp_kernel(variant);
  if (kernel == nullptr || tile_rows % 32 || tile_rows < 32 || tile_rows > kMaxIlpTile)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tiles(kernel, smem_bytes<PairBuckets>(num_gens), wpack, h0, socb, xy0,
                           dxdy0, idx, out_abs, out_rel, n_rows, m_rows, num_gens, h_dim,
                           hid_dim, in_dim, pred_len, fmt, tile_rows, stream);
}

// Resident warps per SM of K1-bf16 for `num_gens` generators.
int mggan_decode_select_bf16_warps_per_sm(int num_gens, int* warps) {
  return (int)resident_warps(decode_select_mma_kernel, kThreads, smem_bytes<Buckets>(num_gens),
                             warps);
}

// Resident warps per SM of K5-bf16's launch variant `variant` for
// `num_gens` generators.
int mggan_decode_select_ilp_bf16_warps_per_sm(int num_gens, int variant, int* warps) {
  const IlpKernel kernel = ilp_kernel(variant);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)resident_warps(kernel, kThreads, smem_bytes<PairBuckets>(num_gens), warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
