// Fused-selection decoder rollout in f32 (K1) for Hopper (sm_90a), with
// rows of one generator tiled per warp.
//
// Replaces mggan_tpu/ops/pallas/decoder.py::_fwd_select_kernel (wrapped by
// pallas_decode_select): for each row n with sampled generator g = idx[n]
// it rolls out generator g only,
//
//   gates = te @ Wemb'_g + h @ Whh_g + b_g;  c = sig(f) c + sig(i) tanh(gg)
//   h = sig(o) tanh(c);  hid = LeakyReLU_0.01(h @ W1h_g + socb[m, g])
//   nd = hid @ W2_g + b2_g;  xy += nd;  dxdy = nd
//
// and stores abs = xy and rel = nd of every step, each (N, T, 2) f32. Row
// inputs as in decode_select.cu: h0 and idx have N rows, xy0, dxdy0 and
// socb M rows with N % M == 0, and row n reads row n % M.
//
// Design (select_tiled.cuh, where the kernel lives: B1 in
// decode_ablation.cu instantiates it on other activations). A persistent
// block takes tiles of consecutive rows and buckets each tile's rows by
// generator in shared memory (tile_buckets.cuh: ballots per 32-row chunk,
// then offsets; stable), every bucket padded to R rows.
// Each warp then rolls out R rows of one generator at a time
// (rollout_tile.cuh): lane j owns hidden unit j for the R rows, so each
// 16-byte weight load from shared memory serves R rows' FMAs, and the new h
// of the R rows is broadcast through a per-warp staging buffer. All G
// generators' f32 weight blocks stay in shared memory in kernel_weights'
// [k][j][gate] image. Padded rows compute on zeros and store nothing; a row
// with no generator (idx out of range) is poisoned with NaN. Per row the
// arithmetic is rollout_row's in its order, so the output is bit-identical
// to the warp-per-row K1 (decode_select.cu, mggan_decode_select_warp), which
// stays compiled as the yardstick of this design.
//
// R (1, 2 or 4) and the tile's rows are picked by the wrapper from N and
// the SM count (decoder.py::tiled_launch): R rows a warp where every
// resident warp gets at least 4 groups of R rows, else fewer. H = 32, hid = 16
// (the flagship) are a compile-time instantiation; other widths take the
// generic one.
//
// What bounds it on the H100: the warp-per-row K1 spent ~130 shared-memory
// wavefronts and ~400 warp instructions per row-step, the weight block
// re-read for every row. Here a row-step costs ~160 FMAs, ~100
// instructions of activations, a few of the nd butterfly (split over the
// half-warps at hid = 16) and ~50 wavefronts (at R = 4): instruction issue
// on the FMA and activation work, with 16 warps an SM (118 registers)
// hiding the activations' latency only in part. On an H100 80GB HBM3 at
// 700 W it takes 7.3 ms at 1,310,720 rows, 3.2x the fp32-FMA bound, which
// counts only the products (PERF.md).

#include "select_tiled.cuh"

using namespace mggan;

extern "C" {

// The tiled K1 on `stream` with the f32 weight image: `blocks` persistent
// blocks over tiles of tile_rows rows (1..1024), rows_per_warp (1, 2 or 4)
// rows of one generator a warp. Returns cudaGetLastError() after the launch
// (0 on success); the caller checks shapes (G <= 32) and picks the launch
// (decoder.py::tiled_launch).
int mggan_decode_select(const void* wpack, const void* h0, const void* socb, const void* xy0,
                        const void* dxdy0, const void* idx, void* out_abs, void* out_rel,
                        long long n_rows, long long m_rows, int num_gens, int h_dim,
                        int hid_dim, int in_dim, int pred_len, int fmt, int per_gen,
                        int rows_per_warp, int tile_rows, int blocks, void* stream) {
  return launch_select_tiled<ActExact>(wpack, h0, socb, xy0, dxdy0, idx, out_abs, out_rel,
                                       n_rows, m_rows, num_gens, h_dim, hid_dim, in_dim,
                                       pred_len, fmt, per_gen, rows_per_warp, tile_rows, blocks,
                                       stream);
}

// Resident warps per SM of the tiled K1 for R = rows_per_warp at these
// widths; returns a CUDA error code.
int mggan_decode_select_tiled_warps_per_sm(int rows_per_warp, int num_gens, int per_gen,
                                           int h_dim, int hid_dim, int pred_len, int* warps) {
  return select_tiled_warps_per_sm<ActExact>(rows_per_warp, num_gens, per_gen, h_dim, hid_dim,
                                             pred_len, warps);
}

const char* mggan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
