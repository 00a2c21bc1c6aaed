#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mggan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits nonzero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions, so float32 means float32 on both sides of a comparison;
  2. build every kernel from ``mggan_tpu_torch/csrc`` (nvcc, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes its paths give it, with its time, the plain version's time
     and the bound the card allows: K1 (decode_select) at 3, 64 and 4096
     scenes; K2 (decode_all_fwd) and K3 (decode_all_bwd, with a check that
     two launches give bit-identical weight grads) at 3 scenes, the PM
     step's 4,096 rows and the G step's 81,920 rows;
  4. serving path: the flagship model (mgan, 4 generators, h=32, sways
     social, scene CNN; random weights from a seed) served through
     ``ServingModel`` at 1, 8 and 64 scenes of up to 16 peds, k=20, with the
     kernels' launch counts read around it; one request is repeated with
     injected random numbers on the card and on the CPU and compared;
  5. train path: ``init_train_state`` + ``build_train_step`` at the
     flagship batch (256 scenes x 16 peds, K=20), one warm-up step and five
     timed ones, launch counts read around them; one step with injected
     random numbers at 4 scenes on the card and on the CPU, compared;
  6. device profiles of a 64-scene request and of a train step;
  7. bf16 kernels: K1's and K2's bf16 variants against their bf16 plain
     versions on the card (atol 4e-3) at the eval batch's 9,728 rows (x 4
     generators for K2) and K1's at 1,310,720 rows, the tensor-core
     K1-bf16 equal to K2-bf16 on the selected rows bit for bit (one
     rollout, ``csrc/rollout_mma.cuh``), each timed beside its bounds;
  8. eval path: the synthetic dataset (512 windows of up to 16 peds) in
     batches of 32 through ``get_predictions_multi`` with the six
     multi-generator strategies in f32 and ``sampling`` + ``expected`` in
     bf16, then ``evaluate_ade_fde`` and ``evaluate_precision_recall``
     (radius 3) for k = 1..19; ``rejection`` on a one-generator model over
     the first 64 windows; the first 4 batches again on the port's CPU path
     with the same injected draws, compared (rejection: its decodes);
  9. sampling at ``bench.py``'s batch (4,096 scenes x 16 peds, k=20)
     through ``Predictor.predict`` in f32 and in bf16, with K1's share of
     the device time;
 10. ablation kernels: K4's route (``decode_select_sorted``) against its
     plain version in the three input formats, with F=0 and with every row
     on one generator, f32 (atol 1e-4) and bf16 (atol 4e-3) at 4,096 rows;
     at 20,480 rows K5 and B1-f32 equal to the warp-per-row K1 bit for bit
     (K5 also to the tiled K1, K5-bf16 to the tensor-core K1-bf16), K5, B1
     (f32, bf16, lin; the tiled K1 with other activations), K4's route and
     B2 against their plain versions (the bf16 kernels also on average,
     1e-5), each timed beside its plain version and its bound, K4's route
     against K1 (K1-bf16), the f32 route and B2 equal to the kept
     warp-per-row route and kernel bit for bit;
 11. K3 after a bf16 forward at the PM step's 4,096 x 4 rows: K2-bf16's
     (tensor cores) saved (h, c) against the bf16 plain forward's (atol
     4e-3, mean 1e-6,
     h rounded to bf16, c not; the f32 forward's hc must fail), the whole
     route (K2-bf16, then K3) against the plain forward and reverse sweep
     and K3 alone against the plain sweep on the kernel's residuals (kink
     rows, and rows where an h rounding flipped between the two forwards,
     reported apart); the route after the f32 forward must fail those
     limits; ``DecodeAll`` in bf16 gives K3's grads bit for bit;
 12. the ablation path, launch counts read around it: the entry points'
     timings at 1,310,720 rows (``DECODEABL``, ``SORTEDPARTS``, with each
     kernel's resident warps per SM and bounds), the activations' share of
     K1 (1 - B1-lin / K1, both tiled), K5, B1-f32 and the tiled K1 equal to
     the warp-per-row K1 bit for bit there, K5 and the tiled B1-f32 to the
     tiled K1 and K5-bf16 to the tensor-core K1-bf16 (after the counts),
     K4's route within 1e-4 of K1 and equal to the kept warp-per-row route
     bit for bit, its bf16 route within 4e-3 (mean 1e-5) of the tensor-core
     K1-bf16 and of its plain version, where the f32 route must fail both
     limits, a bf16 gradient of ``decode_all``; then B1-bf16, B1-lin, B2
     (also bit for bit against the kept warp-per-row kernel) and K4-bf16
     alone against their plain versions at those rows;
 13. the kernels redesigned for the H100, each against its plain version
     and timed beside the kernel it replaced (kept in the sources for this;
     no path launches it), with registers and resident warps: K3 (rows of
     one generator tiled per warp) at 4,096 x 4 and 81,920 x 4 rows,
     K1-bf16 (tensor cores) at 9,728 and 1,310,720 rows with a mean limit
     and, at 9,728, skewed, partial and missing generator choices; the f32
     K1 and K2 (rows of one generator tiled per warp) at every main-path
     shape (K1: 960, 4,096, 9,728, 20,480 and 1,310,720 rows; K2: 4,096 x 4,
     9,728 x 4 and 81,920 x 4 with hc), bit for bit against the
     warp-per-row kernels; K2-bf16 (tensor cores) at 9,728 x 4 and 4,096 x
     4 with hc, bit for bit against K1-bf16 on the selected rows (and the
     kept warp-per-row K2-bf16 against the warp-per-row K1-bf16); B1 (the
     tiled rollout) at 20,480 and 1,310,720 rows, each variant bit for bit
     against its warp-per-row kernel and B1-f32 against the tiled K1, with
     the activations' share of K1 from the profiler's device times; K5-bf16
     (tensor cores, two groups a warp) at 20,480 and 1,310,720 rows, bit for
     bit against the tensor-core K1-bf16 and timed beside it, and K4-bf16
     (tensor cores) alone on the route's buffer at those rows against its
     plain version (4e-3, mean 1e-5), each timed in turns with the
     warp-per-row kernel it replaced (held to the warp-per-row K1-bf16 bit
     for bit, and to the plain version); K5 (the tiled K1's rollout, two
     groups of rows a warp) at the same rows, bit for bit against the tiled
     and the warp-per-row K1 and timed beside the tiled K1, and the tiled
     K4 alone on the route's buffer and through its route, bit for bit
     against the kept warp-per-row kernel and route and within 1e-4 of the
     plain tiles, each timed in turns with its kept kernel;
 14. a JSON line listing every ported kernel (the replaced f32 K1, K2, K4
     and K5, K2-bf16, B1, K5-bf16 and K4-bf16 under their successors'
     ``baseline``), then the result line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sweep`` instead runs phases 1 and 2 and then
times the tiled K1 and K2, K2-bf16, K5 (rows a group, rows a tile),
K5-bf16 (blocks an SM, rows a tile), K4 and K4-bf16 (warps a block) at
every launch shape their wrappers can pick, at the main paths' row counts
(``SWEEP`` line), the data behind the launch rules.

Imports neither JAX nor the JAX package ``mggan_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores (the
# f32 kernels' operands), bf16 on the tensor cores (the bf16 variants'
# operands: their bound; the fp32-FMA figure is kept beside it, labelled)
# and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Profiler sessions tried before a device-time reading gives up: a session
# now and then comes back without its device records.
PROFILE_TRIES = 3

# Kernel vs plain version, float32 on the same card: summation order and
# expf/tanhf differ; 1e-4 is the repo's tolerance over a 12-step rollout.
KERNEL_ATOL = 1e-4
# Card vs CPU through the whole model (conv, attention, LSTMs, then the
# 12-step rollout), float32 with TF32 off on the card: the repo's rollout
# tolerance again.
E2E_ATOL = 1e-4
# K3's per-row grads against the plain reverse sweep: rtol/atol 2e-4, as
# tests/test_pallas_decoder.py holds the TPU kernel's backward. Its weight
# grads are sums over up to ~10^6 row-steps taken in another order: max abs
# error <= 1e-3 x max |grad|.
GRAD_RTOL = GRAD_ATOL = 2e-4
WGRAD_REL = 1e-3
# Where a hidden2pos pre-activation lies within float rounding of
# LeakyReLU's kink, the slope (1 or 0.01) depends on the last bit: K3
# recomputes it bit for bit as its forward did, the plain version with
# another summation order. Per-row grads of such rows (|pre| < KINK at some
# step of some generator) are counted and reported, not held to the
# tolerance; the check fails if any element beyond it lies elsewhere.
KINK = 1e-5
# Train step card vs CPU: the golden fixtures' atol and rtol 1e-4 on every
# metric (tests/test_golden.py) and atol 1e-4 on every updated parameter,
# but for the conv biases before train-mode BatchNorm: their gradient is
# zero but for float noise, and Adam's first steps move a parameter by
# about lr * sign(g), so there a sign flip may move an element by up to
# 2 * lr per update (G: two updates per step, D: one).
TRAIN_ATOL = TRAIN_RTOL = 1e-4
NOISE_LEAVES = {("scene", "conv1", "b"), ("scene", "conv2", "b")}
# bf16 kernels against their bf16 plain versions on the card: a rounding of
# h to bf16 can land on the other side between two summation orders, and
# the max over rows grows with the row count (on an H100 80GB HBM3 at
# 700 W: 8.1e-4 and 1.2e-3 at 9,728 rows, 1.9e-3 at 1,310,720; PERF.md).
# The wrong variant, the f32 kernel against the bf16 plain version, read
# 9.4e-3 and 1.3e-2 there; every run checks that it lies beyond the limit.
BF16_ATOL = 4e-3
# Eval card vs CPU on the same draws. f32: ADE/FDE and every predicted
# position within 1e-4, the rollout tolerance. bf16: the scene CNN's bf16
# convolutions round differently in cuDNN and on the CPU and the kernels'
# h roundings can flip, each moving a few positions by up to ~1e-3; on an
# H100 80GB HBM3 at 700 W ADE/FDE read 8.6e-7 and positions 6.4e-4 at most
# (PERF.md). The wrong variant, f32 against bf16 on the same draws, reads
# 8.4e-6 on ADE/FDE, 1.6e-3 at most and 1.5e-4 on average on positions for
# ``expected`` (more for ``sampling``, whose picks move). So bf16 is held
# to ADE/FDE within 3e-6, positions within 2e-3, and their mean absolute
# difference within 1e-5; every run also holds a card run in f32 against
# the CPU's bf16 and checks that these limits reject it. Mode thresholds
# each agent's min-FDE at 3 m: agents on the other side are counted.
EVAL_ATOL = 1e-4
EVAL_BF16_METRIC_ATOL = 3e-6
EVAL_BF16_PRED_ATOL = 2e-3
EVAL_BF16_PRED_MEAN_ATOL = 1e-5

# The ablation path (phases 10-12). B1-bf16 against its plain version:
# hexp and __hdiv on the card against torch's exp and division on the same
# bf16 values, and a summation order that moves a bf16 rounding; on an H100
# 80GB HBM3 at 700 W it read 3.9e-4 at 20,480 rows, and K1 (f32
# activations) against B1-bf16's plain version 4.4e-3 (PERF.md). Every run
# checks that K1 lies beyond the limit.
B1_BF16_ATOL = 2e-3
# K2-bf16's saved (h, c) against the bf16 plain forward's (phase 11): a flip
# of one h's bf16 rounding moves it by one bf16 step, up to 2^-8 (3.9e-3)
# below 1, within BF16_ATOL; such flips are rare, and the mean abs
# difference read 1.3e-8 on an H100 80GB HBM3 at 700 W, the f32 forward's
# hc 1.6e-4 (PERF.md). Every run checks that the f32 forward's hc fails.
HC_MEAN_ATOL = 1e-6
# K1-bf16's mean absolute error against its plain version (phase 13): a
# flip of one h's bf16 rounding moves a few positions by up to ~2e-3
# (BF16_ATOL holds the max), and flips are rare, so the mean stays far
# below; eval holds the bf16 positions' mean at the same 1e-5
# (EVAL_BF16_PRED_MEAN_ATOL), where the f32 variant read 1.5e-4. Every run
# checks that the f32 kernel lies beyond it.
BF16_MEAN_ATOL = 1e-5
ABL_ROWS = 20_480  # the ablation kernels against their plain versions
SORTED_AGENTS, SORTED_K = 256, 16  # K4's route cases: 4,096 rows

SEED = 0
NUM = 20
PEDS = 16
BUCKETS = (1, 8, 64)
BENCH_SCENES = 4096  # bench.py's k=20 sampling batch
TRAIN_SCENES = 256  # bench.py's train batch: 256 scenes x 16 peds, K=20
TRAIN_STEPS = 5
EVAL_WINDOWS = 512  # synthetic dataset: windows of up to PEDS peds, seed 2
EVAL_BATCH = 32  # scenes per eval batch: 32 x 16 x 19 = 9,728 rollouts
EVAL_K = 19  # cli/evaluate.py decodes max(range(1, 20)) samples
REJECTION_WINDOWS = 64
CPU_BATCHES = 4  # eval batches repeated on the CPU
F32_STRATEGIES = ("expected", "uniform_expected", "smart_expected", "smart_sampling",
                  "uniform_sampling", "sampling")
BF16_STRATEGIES = ("sampling", "expected")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, reps, warmup=2):
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_query(fields):
    """``nvidia-smi --query-gpu=<fields>`` for the first card, one CSV line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def smi_under_load(fn, reps):
    """The SM clock and power draw, read while ``reps`` calls of ``fn``,
    enqueued ahead of the read, keep the card busy."""
    import torch

    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    sample = smi_query("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return sample


# ------------------------------------------------------------------ phases --
def phase_card():
    import torch

    print(smi_query("name,power.limit"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def phase_build():
    from mggan_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel libraries in {secs:.2f} s")
    for stem in libs:
        for line in build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    return secs


def decode_select_case(n_scenes, gen, num=NUM):
    """Flagship decoder weights and per-row inputs for ``n_scenes`` scenes of
    PEDS peds with ``num`` samples: N = num * n_scenes * PEDS rollouts."""
    import torch

    from mggan_tpu_torch.models import common

    m = n_scenes * PEDS
    stacked = common.stacked_decoders_init(gen, 4, 16, 32, "rel", 32)
    rand = lambda *s: torch.randn(s, generator=gen)
    return {
        "stacked": stacked,
        "xy": rand(m, 2) * 3.0, "dxdy": rand(m, 2) * 0.3,
        "soc": rand(m, 32), "h0": rand(m * num, 32),
        "idx": torch.randint(0, 4, (m * num,), generator=gen, dtype=torch.int32),
    }


def roofline_ms(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """Least time for the work on an H100: max(FLOPs / ``peak_flops``,
    bytes / HBM rate) -> ``(ms, "operations" or "bytes", flops, bytes)``."""
    by_ops, by_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes"), flops, nbytes


def rollout_flops(n, t, h, hid, in_dim):
    """The products of ``n`` single-generator rollouts of ``t`` steps."""
    return n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)


def nbytes_of(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def decode_select_bound_ms(prepared, peak_flops=PEAK_FP32_FLOPS):
    """K1's bound: each input read once and each output written once; the
    gate, hidden2pos and output products of the sampled generator."""
    tensors, dims = prepared["tensors"], prepared["dims"]
    n, _, _, h, hid, in_dim, t = dims[:7]
    return roofline_ms(rollout_flops(n, t, h, hid, in_dim),
                       nbytes_of(*tensors) + 2 * n * t * 2 * 4, peak_flops)


def decode_all_bound_ms(prepared, outputs, peak_flops=PEAK_FP32_FLOPS):
    """K2's bound: the inputs read once, ``outputs`` (abs, rel and, when
    saved, hc) written once; K1's products for every (row, generator)."""
    n, _, g, h, hid, in_dim, t = prepared["dims"][:7]
    return roofline_ms(rollout_flops(g * n, t, h, hid, in_dim),
                       nbytes_of(*prepared["tensors"], *outputs), peak_flops)


def decode_all_bwd_bound_ms(prepared, inputs, outputs):
    """K3's bound: the inputs (K2's, its outputs and hc, the cotangents)
    read once, the per-(generator, row) grads and the weight grads written
    once; per (row, generator, step) the gate recompute, dgates @ [Wemb;
    Whh]^T and the weight-grad outer products (three products of the gate
    width each), and three of hidden2pos's width."""
    n, _, g, h, hid, in_dim, t = prepared["dims"][:7]
    per = 3 * 2 * (in_dim + h) * 4 * h + 3 * 2 * h * hid + 2 * 2 * hid * 2
    return roofline_ms(g * n * t * per,
                    nbytes_of(*prepared["tensors"], *inputs, *outputs))


def phase_kernels():
    import torch

    from mggan_tpu_torch.ops.kernels import decoder as kdec

    dev = torch.device("cuda")
    on = lambda x: ({k: on(v) for k, v in x.items()} if isinstance(x, dict)
                    else x.to(dev))
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for label, scenes, reps in (("small", 3, 20), ("serving", 64, 20),
                                ("bench", BENCH_SCENES, 5)):
        case = on(decode_select_case(scenes, gen))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"],
                case["h0"], case["idx"], 12, "rel")
        prepared = kdec.prepare_decode_select(*args)
        got = kdec.launch_decode_select(prepared)
        torch.cuda.synchronize()
        want = kdec.decode_select_reference(*args)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"decode_select {label}: non-finite output")
        ms = cuda_time_ms(lambda: kdec.launch_decode_select(prepared), reps)
        plain_ms = cuda_time_ms(lambda: kdec.decode_select_reference(*args),
                                max(2, reps // 5), warmup=1)
        bound_ms, bound_by, flops, nbytes = decode_select_bound_ms(prepared)
        n = prepared["dims"][0]
        results[label] = {
            "n_rows": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes,
        }
        if label == "bench":  # about 2 s of kernel work behind the read
            results[label]["smi_under_load"] = smi_under_load(
                lambda: kdec.launch_decode_select(prepared), 120)
            print(f"decode_select[bench] under load: SM clock, power draw = "
                  f"{results[label]['smi_under_load']}")
        print(f"decode_select[{label}] N={n}: max_abs_err={err:.3e} "
              f"(atol {KERNEL_ATOL:g}) kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
              f"{nbytes:.3e} B), library_ms null")
        check(err <= KERNEL_ATOL,
              f"decode_select {label}: max abs err {err:.3e} > {KERNEL_ATOL}")
        del case, args, prepared, got, want
        torch.cuda.empty_cache()
    return results


def decode_all_case(m, k, gen):
    """Flagship decoder weights folded as ``DecodeAll`` takes them, M
    per-agent rows and N = K * M rollout rows, on the card."""
    import torch

    from mggan_tpu_torch.models import common
    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    stacked = common.stacked_decoders_init(gen, 4, 16, 32, "rel", 32)
    rand = lambda *s: torch.randn(s, generator=gen)
    packed = kdec.pack_decoder_params(stacked, "rel")
    soc = rand(m, 32)
    inputs = [packed[key] for key in kda.PACKED] + [
        kdec.social_bias(packed, soc), rand(m * k, 32), rand(m, 2) * 3.0,
        rand(m, 2) * 0.3]
    return [x.contiguous().cuda() for x in inputs]


def kink_rows(inputs, hc):
    """Rows (N,) where hidden2pos's pre-activation ``h_t @ W1h + socb`` lies
    within KINK of zero at some step of some generator."""
    import torch

    from mggan_tpu_torch.ops.kernels import decoder as kdec

    w1h, socb = inputs[3], inputs[6]
    g, n, t, _, h = hc.shape
    sb = kdec.tile_rows(socb, n).transpose(0, 1)  # (G, N, hid)
    pre = torch.bmm(hc[:, :, :, 0].reshape(g, n * t, h), w1h).reshape(g, n, t, -1)
    return (pre + sb[:, :, None]).abs().amin(dim=(0, 2, 3)) < KINK


def grad_errors(got_g, want_g, kink_n, kink_m):
    """K3's grads (``DecodeAll``'s input order) against the plain sweep's:
    weight grads by max abs error over max |grad|; per-row grads by
    rtol/atol, elements of kink rows (``kink_n`` per rollout row,
    ``kink_m`` per agent) counted apart."""
    import torch

    w_err, w_rel, row_err, row_bad, kink_bad, kink_err = 0.0, 0.0, 0.0, 0, 0, 0.0
    for i, (a, w) in enumerate(zip(got_g, want_g)):
        diff = (a - w).abs()
        if i < 6:  # weight grads: sums over the rows
            w_err = max(w_err, float(diff.max()))
            w_rel = max(w_rel, float(diff.max() / w.abs().max().clamp_min(1e-30)))
            continue
        # per-row grads: d_socb, d_xy, d_dxdy per agent (M), d_h0 per row (N)
        kink = (kink_n if i == 7 else kink_m).reshape((-1,) + (1,) * (diff.dim() - 1))
        beyond = diff > GRAD_ATOL + GRAD_RTOL * w.abs()
        row_err = max(row_err, float(torch.where(kink, 0.0, diff).max()))
        kink_err = max(kink_err, float(torch.where(kink, diff, 0.0).max()))
        row_bad += int((beyond & ~kink).sum())
        kink_bad += int((beyond & kink).sum())
    return {"weight_grad_max_abs_err": w_err, "weight_grad_err_over_max": w_rel,
            "row_grad_max_abs_err": row_err, "row_elements_beyond": row_bad,
            "kink_elements_beyond": kink_bad, "kink_max_abs_err": kink_err,
            "ok": row_bad == 0 and w_rel <= WGRAD_REL}


def phase_decode_all_kernels():
    """K2 and K3 against their plain versions on the card, timed, at the
    shapes of the train step's paths: a small case, the PM step's 4,096
    rows (K=1) and the G step's 81,920 rows (K=20, 4,096 agents)."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda

    gen = torch.Generator().manual_seed(SEED + 1)
    fwd, bwd = {}, {}
    for label, m, k, reps in (("small", 3 * PEDS, NUM, 20), ("pm", TRAIN_SCENES * PEDS, 1, 20),
                              ("g", TRAIN_SCENES * PEDS, NUM, 5)):
        inputs = decode_all_case(m, k, gen)
        n = m * k
        prepared = kda.prepare(*inputs, 12, "rel")
        got = kda.launch_fwd(prepared, save_hc=True)
        torch.cuda.synchronize()
        want = kda.decode_all_reference(*inputs, 12, "rel", save_hc=True)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"decode_all_fwd {label}: non-finite output")
        ms_hc = cuda_time_ms(lambda: kda.launch_fwd(prepared, save_hc=True), reps)
        ms = cuda_time_ms(lambda: kda.launch_fwd(prepared, save_hc=False), reps)
        plain_ms = cuda_time_ms(lambda: kda.decode_all_reference(
            *inputs, 12, "rel", save_hc=True), max(2, reps // 5), warmup=1)
        b_hc = decode_all_bound_ms(prepared, got)
        b = decode_all_bound_ms(prepared, got[:2])
        fwd[label] = {"n_rows": n, "max_abs_err": err, "ms": ms, "ms_save_hc": ms_hc,
                      "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                      "bound_ms_save_hc": b_hc[0], "bound_by_save_hc": b_hc[1],
                      "flops": b[2], "bytes": b[3], "bytes_save_hc": b_hc[3]}
        print(f"decode_all_fwd[{label}] N={n} x G=4: max_abs_err={err:.3e} (abs, rel, hc; "
              f"atol {KERNEL_ATOL:g}) kernel {ms:.4f} ms ({ms_hc:.4f} ms saving hc), plain "
              f"(saving hc) {plain_ms:.3f} ms, bound {b[0]:.4f} ms by {b[1]} "
              f"({b_hc[0]:.4f} ms by {b_hc[1]} saving hc), library_ms null")
        check(err <= KERNEL_ATOL, f"decode_all_fwd {label}: max abs err {err:.3e}")

        # K3 on K2's outputs and random cotangents
        out_abs, out_rel, hc = got
        cot = torch.Generator(device="cuda").manual_seed(SEED)
        g_abs = torch.randn(out_abs.shape, generator=cot, device="cuda")
        g_rel = torch.randn(out_rel.shape, generator=cot, device="cuda")
        saved = (*inputs, out_abs, out_rel, hc, g_abs, g_rel)
        got_g = kda.decode_all_bwd(*saved, 12, "rel")
        raw1 = kda.launch_bwd(prepared, out_abs, out_rel, hc, g_abs, g_rel)
        raw2 = kda.launch_bwd(prepared, out_abs, out_rel, hc, g_abs, g_rel)
        torch.cuda.synchronize()
        identical = torch.equal(raw1[4], raw2[4])
        want_g = kda.decode_all_bwd_reference(*saved, 12, "rel")
        kink_n = kink_rows(inputs, hc)  # (N,) bool
        kink_m = kink_n.reshape(k, m).any(0)  # (M,) an agent with a kink row
        ge = grad_errors(got_g, want_g, kink_n, kink_m)
        w_err, w_rel = ge["weight_grad_max_abs_err"], ge["weight_grad_err_over_max"]
        row_err, row_bad = ge["row_grad_max_abs_err"], ge["row_elements_beyond"]
        kink_bad, kink_err = ge["kink_elements_beyond"], ge["kink_max_abs_err"]
        bms = cuda_time_ms(lambda: kda.launch_bwd(prepared, out_abs, out_rel, hc, g_abs,
                                                  g_rel), reps)
        plain_bms = cuda_time_ms(lambda: kda.decode_all_bwd_reference(*saved, 12, "rel"),
                                 max(2, reps // 5), warmup=1)
        bb = decode_all_bwd_bound_ms(prepared, (out_abs, out_rel, hc, g_abs, g_rel), raw1)
        bwd[label] = {"n_rows": n, "max_abs_err": max(w_err, row_err),
                      "row_grad_max_abs_err": row_err, "weight_grad_max_abs_err": w_err,
                      "kink_rows": int(kink_n.sum()), "kink_elements_beyond": kink_bad,
                      "kink_max_abs_err": kink_err,
                      "weight_grad_err_over_max": w_rel, "bit_identical": identical,
                      "ms": bms, "plain_ms": plain_bms, "bound_ms": bb[0],
                      "bound_by": bb[1], "flops": bb[2], "bytes": bb[3]}
        print(f"decode_all_bwd[{label}] N={n} x G=4: per-row grads max_abs_err "
              f"{row_err:.3e} ({row_bad} beyond rtol/atol {GRAD_RTOL:g}); "
              f"{int(kink_n.sum())} rows with a hidden2pos pre-activation within "
              f"{KINK:g} of the LeakyReLU kink: {kink_bad} elements beyond, max abs "
              f"diff {kink_err:.3e}; weight grads "
              f"max_abs_err {w_err:.3e} = {w_rel:.2e} x max|grad| (limit {WGRAD_REL:g}), "
              f"two launches bit-identical: {identical}; kernel (sweep + fixed-order sum) "
              f"{bms:.4f} ms, plain {plain_bms:.3f} ms, bound {bb[0]:.4f} ms by {bb[1]}, "
              f"library_ms null")
        check(row_bad == 0, f"decode_all_bwd {label}: {row_bad} per-row grads beyond tolerance")
        check(w_rel <= WGRAD_REL, f"decode_all_bwd {label}: weight grad error {w_rel:.2e}")
        check(identical, f"decode_all_bwd {label}: weight grads differ between launches")
        del inputs, prepared, got, want, saved, got_g, want_g, raw1, raw2, hc
        torch.cuda.empty_cache()
    return fwd, bwd


def make_request(rng, n_scenes):
    import numpy as np

    peds = rng.randint(1, PEDS + 1, n_scenes)
    obs = [(rng.randn(p, 8, 2).cumsum(1) * 0.4 + rng.randn(1, 1, 2) * 3).astype(np.float32)
           for p in peds]
    pat = [rng.uniform(-1, 1, (p, 33, 33, 4)).astype(np.float32) for p in peds]
    return obs, pat


def phase_main_path():
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import construct_model, tree_to
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.serving.runtime import ServingModel

    cfg = flagship_config()
    params, state, spec = construct_model(cfg, seed=SEED, device="cuda")
    pred = Predictor(cfg, spec, params, state, device="cuda")
    model = ServingModel.from_predictor(pred, "sampling", scenes=BUCKETS[-1],
                                        peds=PEDS, num=NUM, scene_buckets=BUCKETS)
    rng = np.random.RandomState(SEED)
    requests = {b: make_request(rng, b) for b in BUCKETS}

    kernels.launches.clear()
    latency = {}
    for b, (obs, pat) in requests.items():
        times = []
        for rep in range(6):
            t0 = time.perf_counter()
            out = model.predict_batch(obs, pat, seed=rep)
            times.append((time.perf_counter() - t0) * 1e3)
            check(len(out) == b, f"bucket {b}: {len(out)} scenes back")
            for o, ob in zip(out, obs):
                check(o.shape == (NUM, ob.shape[0], 12, 2), f"bucket {b}: shape {o.shape}")
                check(np.isfinite(o).all(), f"bucket {b}: non-finite prediction")
        latency[b] = {"p50_ms": float(np.median(times[1:])), "first_ms": times[0]}
    launches = dict(kernels.launches)
    print("serving path launches:", json.dumps(launches))
    check(launches.get("decode_select", 0) >= 6 * len(BUCKETS),
          f"decode_select launched {launches.get('decode_select', 0)} times on the main path")
    for b, lat in latency.items():
        print(f"serving bucket {b:>2} scenes x {PEDS} peds, k={NUM}: "
              f"p50 {lat['p50_ms']:.3f} ms (first call {lat['first_ms']:.1f} ms)")

    # one request with injected draws: card vs the port's CPU path
    obs, pat = requests[8]
    xy, mask, patches = model.pad_request(obs, pat)
    s = xy.shape[0]
    draws = {
        "uniforms": np.clip(rng.uniform(0, 1, (NUM, s, PEDS, cfg.num_gens)),
                            1e-20, 1 - 2**-24).astype(np.float32),
        "z": rng.randn(NUM, s, 1, cfg.noise_dim).astype(np.float32),
    }
    batch = {"xy": xy, "ped_mask": mask, "patches": patches}
    cpu = Predictor(cfg, spec, tree_to(params, "cpu"), tree_to(state, "cpu"), device="cpu")
    a_gpu = pred.predict(batch, num=NUM, draws=draws)
    a_cpu = cpu.predict(batch, num=NUM, draws=draws)
    check(torch.equal(a_gpu[3].cpu(), a_cpu[3]), "card and CPU sampled different generators")
    e2e_err = float((a_gpu[0].cpu() - a_cpu[0]).abs().max())
    print(f"card vs CPU, 8-scene request with injected draws: max abs err "
          f"{e2e_err:.3e} (atol {E2E_ATOL:g})")
    check(e2e_err <= E2E_ATOL, f"card vs CPU error {e2e_err:.3e} > {E2E_ATOL}")
    return launches, latency, e2e_err, model, requests[BUCKETS[-1]]


def train_batch(n_scenes, seed):
    """``bench.py::_make_batch``: n_scenes x PEDS peds, all real, numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {
        "xy": rng.randn(n_scenes, PEDS, 20, 2).astype(np.float32).cumsum(2) * 0.1,
        "ped_mask": np.ones((n_scenes, PEDS), bool),
        "patches": rng.uniform(-1, 1, (n_scenes, PEDS, 33, 33, 4)).astype(np.float32),
    }


def phase_train():
    """The train path at the flagship batch: random weights from SEED,
    ``init_train_state``, one warm-up step and TRAIN_STEPS timed ones (host
    clock around a step that ends in a synchronize), launch counts read
    around the timed steps."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step
    from mggan_tpu_torch.utils.pytree import tree_items, tree_leaves

    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    g_pack, d_pack = construct_gan(cfg, seed=SEED, device="cuda")
    state = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    step = build_train_step(cfg, g_pack[2], d_pack[2])
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(TRAIN_SCENES, SEED).items()}
    # every leaf moves but the unused prior (zero, zero gradient, zero decay)
    trained = lambda st: [x for path, x in tree_items(st.g_params) if path != ("net_prior",)] \
        + tree_leaves(st.d_params)
    first = [x.clone() for x in trained(state)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3

    kernels.launches.clear()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    values = {k: float(v) for k, v in metrics.items()}
    print("train path launches:", json.dumps(launches))
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    check(not bad, f"train step: non-finite metrics {bad}")
    last = trained(state)
    moved = sum(not torch.equal(a, b) for a, b in zip(first, last))
    check(moved == len(last), f"train step: {len(last) - moved} parameter leaves unchanged")
    need = {"decode_select": 1, "decode_all_fwd": 2, "decode_all_bwd": 1}
    for name, per_step in need.items():
        check(launches.get(name, 0) >= per_step * TRAIN_STEPS,
              f"{name} launched {launches.get(name, 0)} times in {TRAIN_STEPS} train steps")
    p50 = float(np.median(times))
    print(f"train step, {TRAIN_SCENES} scenes x {PEDS} peds, K={NUM}: p50 {p50:.3f} ms "
          f"over {TRAIN_STEPS} steps (min {min(times):.3f}, max {max(times):.3f}; first "
          f"step {first_ms:.1f} ms), peak device memory {peak_gb:.2f} GiB; "
          f"D loss {values['train/discr_loss']:.4f}, L2 {values['train/L2_loss']:.4f}")
    return {"p50_ms": p50, "times_ms": times, "first_ms": first_ms, "peak_gib": peak_gb,
            "launches": launches, "metrics": values}, (state, step, batch)


def phase_train_card_vs_cpu(n_scenes=4):
    """One train step with the same weights and injected random numbers on
    the card (K1, K2, K3) and on the port's CPU path (plain versions)."""
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.models.factory import construct_gan, tree_to
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws
    from mggan_tpu_torch.utils.pytree import tree_items

    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    g_pack, d_pack = construct_gan(cfg, seed=SEED + 2, device="cpu")
    draws = make_draws(torch.Generator().manual_seed(SEED), cfg, n_scenes, PEDS)
    batch = train_batch(n_scenes, SEED + 2)
    results = {}
    for dev in ("cuda", "cpu"):
        on = lambda pack: (tree_to(pack[0], dev), tree_to(pack[1], dev), pack[2])
        g, d = on(g_pack), on(d_pack)
        state = init_train_state(cfg, g, d, seed=SEED)
        results[dev] = build_train_step(cfg, g[2], d[2])(state, batch, draws)
    (s_gpu, m_gpu), (s_cpu, m_cpu) = results["cuda"], results["cpu"]
    metric_err, metric_bad = 0.0, []
    for k, want in m_cpu.items():
        got, want = float(m_gpu[k]), float(want)
        metric_err = max(metric_err, abs(got - want))
        if abs(got - want) > TRAIN_ATOL + TRAIN_RTOL * abs(want):
            metric_bad.append(k)
    param_err, noise_err, param_bad = 0.0, 0.0, []
    for name, a_tree, b_tree, lr, updates in (
            ("g", s_gpu.g_params, s_cpu.g_params, cfg.g_lr, 2),
            ("d", s_gpu.d_params, s_cpu.d_params, cfg.d_lr, 1)):
        flat = dict(tree_items(b_tree))
        for path, a in tree_items(a_tree):
            err = float((a.cpu() - flat[path]).abs().max())
            noisy = path in NOISE_LEAVES
            limit = 2 * lr * updates + TRAIN_ATOL if noisy else TRAIN_ATOL
            if noisy:
                noise_err = max(noise_err, err)
            else:
                param_err = max(param_err, err)
            if err > limit:
                param_bad.append((name, path, err))
    print(f"train step card vs CPU, {n_scenes} scenes x {PEDS} peds, K={NUM}, injected "
          f"draws: metrics max abs diff {metric_err:.3e} (atol/rtol {TRAIN_ATOL:g}), "
          f"parameters max abs diff {param_err:.3e} (atol {TRAIN_ATOL:g}), conv biases "
          f"before train-mode BN {noise_err:.3e} (Adam sign-flip bound 2*lr per update)")
    check(not metric_bad, f"train card vs CPU: metrics beyond tolerance {metric_bad}")
    check(not param_bad, f"train card vs CPU: parameters beyond tolerance {param_bad[:4]}")
    return {"metric_max_abs_diff": metric_err, "param_max_abs_diff": param_err,
            "noise_leaf_max_abs_diff": noise_err}


def device_profile(fn, reps, label, unit):
    """Device time by kernel name over ``reps`` calls of ``fn``
    (torch.profiler) and the device's busy share of the wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for rep in range(reps):
                fn(rep)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                tot, cnt = by_name.get(ev.name, (0.0, 0))
                by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
        if by_name:
            break
        print(f"profile, {label}: the profiler kept no device record; profiling again")
    check(by_name, f"profile, {label}: the profiler kept no device record in "
                   f"{PROFILE_TRIES} sessions")
    busy_ms = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    print(f"profile, {label}, {reps} {unit}s: wall {wall_ms / reps:.3f} ms/{unit}, device "
          f"busy {busy_ms / reps:.3f} ms/{unit} (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{launches / reps:.0f} device ops/{unit}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, cnt) in top:
        print(f"  {tot / reps:8.4f} ms/{unit}  x{cnt // reps:<4d} {name[:90]}")
    return {"wall_ms": wall_ms / reps, "device_busy_ms": busy_ms / reps,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else float(np.nan),
            "device_ops": launches / reps,
            "top": [[name[:60], tot / reps] for name, (tot, _) in top[:5]],
            "by_name_ms": {name: tot / reps for name, (tot, _) in by_name.items()}}


def phase_profile(model, obs, pat, train, reps=5):
    """Where a largest-bucket request's time goes (and its host padding
    time), then where a train step's time goes."""
    t0 = time.perf_counter()
    for _ in range(reps):
        model.pad_request(obs, pat)
    pad_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"host padding of a {len(obs)}-scene request: {pad_ms:.3f} ms")
    serving = device_profile(lambda rep: model.predict_batch(obs, pat, seed=rep), reps,
                             f"{len(obs)} scenes x {PEDS} peds, k={NUM}", "request")
    serving["pad_ms"] = pad_ms
    box = {"state": train[0]}
    step, batch = train[1], train[2]

    def one_step(_):
        box["state"], _m = step(box["state"], batch)

    train_prof = device_profile(one_step, 2, f"train step, {TRAIN_SCENES} scenes x "
                                f"{PEDS} peds, K={NUM}", "step")
    return serving, train_prof

def phase_bf16_kernels():
    """K1's and K2's bf16 variants against their bf16 plain versions on the
    card, at the eval batch (32 scenes x 16 peds x 19 samples = 9,728 rows;
    K2 x 4 generators) and, for K1, at bench.py's 1,310,720 rows; K1-bf16
    against K2-bf16 on the selected rows (bit for bit: both run
    rollout_mma.cuh's tensor-core rollout); the f32 variant against the
    bf16 plain version (must lie beyond the limit); each timed beside the
    f32 variant, its plain version and its bounds (bf16 tensor cores, and
    the fp32-FMA figure beside it)."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    on = lambda x: ({k: on(v) for k, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    gen = torch.Generator().manual_seed(SEED + 3)

    def compare(got, want, what):
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        beyond = sum(int(((a - b).abs() > BF16_ATOL).sum()) for a, b in zip(got, want))
        check(all(bool(torch.isfinite(a).all()) for a in got), f"{what}: non-finite output")
        return err, beyond

    def bounds(b16, b32):
        return {"bound_ms": b16[0], "bound_by": b16[1], "bound_ms_fp32_fma": b32[0],
                "bound_by_fp32_fma": b32[1], "flops": b16[2], "bytes": b16[3]}

    sel, every = {}, {}
    for label, scenes, k, reps in (("eval", EVAL_BATCH, EVAL_K, 20),
                                   ("bench", BENCH_SCENES, NUM, 5)):
        case = on(decode_select_case(scenes, gen, num=k))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"], case["h0"],
                case["idx"], 12, "rel")
        prepared = kdec.prepare_decode_select(*args, compute_dtype=bf16)
        prepared32 = kdec.prepare_decode_select(*args)
        got = kdec.launch_decode_select(prepared)
        got32 = kdec.launch_decode_select(prepared32)
        torch.cuda.synchronize()
        want = kdec.decode_select_reference(*args, compute_dtype=bf16)
        err, beyond = compare(got, want, f"decode_select_bf16 {label}")
        wrong = compare(got32, want, f"decode_select {label}")[0]
        ms = cuda_time_ms(lambda: kdec.launch_decode_select(prepared), reps)
        ms32 = cuda_time_ms(lambda: kdec.launch_decode_select(prepared32), reps)
        plain_ms = cuda_time_ms(lambda: kdec.decode_select_reference(
            *args, compute_dtype=bf16), max(2, reps // 5), warmup=1)
        n = prepared["dims"][0]
        sel[label] = {"n_rows": n, "max_abs_err": err, "elements_beyond_atol": beyond,
                      "f32_kernel_vs_bf16_plain_max_abs": wrong, "ms": ms,
                      "f32_kernel_ms": ms32, "plain_ms": plain_ms,
                      "smem_bytes": nbytes_of(prepared["tensors"][0]),
                      **bounds(decode_select_bound_ms(prepared, PEAK_BF16_FLOPS),
                               decode_select_bound_ms(prepared))}
        r = sel[label]
        print(f"decode_select_bf16[{label}] N={n}: max_abs_err={err:.3e} (atol {BF16_ATOL:g}, "
              f"{beyond} elements beyond), the f32 kernel against the bf16 plain version "
              f"{wrong:.3e}; kernel {ms:.4f} ms (f32 variant {ms32:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} at the bf16 "
              f"tensor-core peak ({r['bound_ms_fp32_fma']:.4f} ms by {r['bound_by_fp32_fma']} "
              f"at the fp32-FMA peak); weight image {r['smem_bytes']} B; library_ms null")
        check(beyond == 0, f"decode_select_bf16 {label}: {beyond} elements beyond {BF16_ATOL}")
        check(wrong > BF16_ATOL, f"decode_select {label}: the f32 kernel passes the bf16 "
              f"limit ({wrong:.3e} <= {BF16_ATOL})")

        if label == "eval":  # K2-bf16 on the same rows, and K1-bf16 == K2-bf16
            packed = kdec.pack_decoder_params(case["stacked"], "rel")
            inputs = [packed[key] for key in kda.PACKED] + [
                kdec.social_bias(packed, case["soc"]), case["h0"], case["xy"], case["dxdy"]]
            inputs = [x.contiguous() for x in inputs]
            kprep = kda.prepare(*inputs, 12, "rel", bf16)
            kprep32 = kda.prepare(*inputs, 12, "rel")
            out = kda.launch_fwd(kprep, save_hc=False)[:2]
            out32 = kda.launch_fwd(kprep32, save_hc=False)[:2]
            torch.cuda.synchronize()
            want_all = kda.decode_all_reference(*inputs, 12, "rel", compute_dtype=bf16)[:2]
            err_all, beyond_all = compare(out, want_all, "decode_all_fwd_bf16")
            wrong_all = compare(out32, want_all, "decode_all_fwd")[0]
            rows = torch.arange(n, device="cuda")
            pick = case["idx"].long()
            # one tensor-core rollout: K1-bf16 equals K2-bf16 on the selected rows
            identical = all(torch.equal(a, b[pick, rows]) for a, b in zip(got, out))
            ms_all = cuda_time_ms(lambda: kda.launch_fwd(kprep, save_hc=False), reps)
            ms_all32 = cuda_time_ms(lambda: kda.launch_fwd(kprep32, save_hc=False), reps)
            plain_all = cuda_time_ms(lambda: kda.decode_all_reference(
                *inputs, 12, "rel", compute_dtype=bf16), 4, warmup=1)
            every[label] = {"n_rows": n, "max_abs_err": err_all,
                            "elements_beyond_atol": beyond_all,
                            "f32_kernel_vs_bf16_plain_max_abs": wrong_all, "ms": ms_all,
                            "f32_kernel_ms": ms_all32, "plain_ms": plain_all,
                            "k1_equals_k2_on_selected_rows": identical,
                            **bounds(decode_all_bound_ms(kprep, out, PEAK_BF16_FLOPS),
                                     decode_all_bound_ms(kprep, out))}
            r = every[label]
            print(f"decode_all_fwd_bf16[{label}] N={n} x G=4: max_abs_err={err_all:.3e} "
                  f"({beyond_all} elements beyond {BF16_ATOL:g}), the f32 kernel against the "
                  f"bf16 plain version {wrong_all:.3e}; the tensor-core K1-bf16 == K2-bf16 on "
                  f"the selected rows bit for bit: {identical}; kernel {ms_all:.4f} ms (f32 "
                  f"variant {ms_all32:.4f} ms), plain {plain_all:.3f} ms, bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']} at the bf16 tensor-core peak "
                  f"({r['bound_ms_fp32_fma']:.4f} ms at the fp32-FMA peak); library_ms null")
            check(beyond_all == 0, f"decode_all_fwd_bf16: {beyond_all} elements beyond tolerance")
            check(wrong_all > BF16_ATOL, f"decode_all_fwd: the f32 kernel passes the bf16 limit "
                  f"({wrong_all:.3e} <= {BF16_ATOL})")
            check(identical, "K1-bf16 and K2-bf16 differ on the selected rows")
            del packed, inputs, kprep, kprep32, out, out32, want_all
        del case, args, prepared, prepared32, got, got32, want
        torch.cuda.empty_cache()
    return sel, every


def first_windows(ds, n):
    """The dataset's first ``n`` windows, as a dataset."""
    import dataclasses

    cut = lambda x: None if x is None else x[:n]
    return dataclasses.replace(ds, trajectories=ds.trajectories[:n],
                               scene_names=ds.scene_names[:n],
                               big_patches=cut(ds.big_patches), ped_ids=cut(ds.ped_ids))


def final_min_fde(ds, preds):
    """Each real agent's running min over samples of its final displacement
    error (the quantity ``Mode`` thresholds): (K, N_valid)."""
    import numpy as np

    gt = ds.pred_traj
    keep = ~np.isnan(gt).any(-1).any(-1)
    fde = np.linalg.norm(preds[-1][:, keep] - gt[keep, -1][None], axis=-1)  # (K, N)
    return np.minimum.accumulate(fde, axis=0)


def compare_eval(ds, card, cpu, ks, bf16):
    """ADE/FDE/Mode and positions of the card's and the CPU's predictions of
    one strategy: max diffs, the Mode flips (agents whose min-FDE lies on
    the other side of 3 m at some k), the limits the diffs are held to and
    whether they hold (``ok``)."""
    import numpy as np

    from mggan_tpu_torch.eval.evaluate import evaluate_ade_fde
    from mggan_tpu_torch.eval.metrics import MODE_THRESH

    m_card, m_cpu = evaluate_ade_fde(ds, card, ks), evaluate_ade_fde(ds, cpu, ks)
    dist = [k for k in m_cpu if not k.startswith("Mode")]
    diff = max(abs(m_card[k] - m_cpu[k]) for k in dist)
    limit, pred_limit, mean_limit = (
        (EVAL_BF16_METRIC_ATOL, EVAL_BF16_PRED_ATOL, EVAL_BF16_PRED_MEAN_ATOL) if bf16
        else (EVAL_ATOL, EVAL_ATOL, EVAL_ATOL))
    a, b = final_min_fde(ds, card), final_min_fde(ds, cpu)
    flips = ((a < MODE_THRESH) != (b < MODE_THRESH)).sum(1)  # (K,)
    n = a.shape[1]
    mode_ok = all(abs(m_card[f"Mode k={k}"] - m_cpu[f"Mode k={k}"]) * n <= flips[k - 1] + 1e-6
                  for k in ks)
    pred_diff = np.abs(card - cpu)
    pred_err, pred_mean = float(pred_diff.max()), float(pred_diff.mean())
    return {"metric_max_abs_diff": diff, "metric_limit": limit, "mode_flips": int(flips.sum()),
            "mode_consistent_with_flips": mode_ok, "pred_max_abs_diff": pred_err,
            "pred_limit": pred_limit, "pred_mean_abs_diff": pred_mean,
            "pred_mean_limit": mean_limit, "pred_scale": float(np.abs(cpu).max()),
            "ok": bool(diff <= limit and pred_err <= pred_limit and pred_mean <= mean_limit
                       and mode_ok)}


def phase_eval():
    """The evaluation path on the card (see the module note), its launch
    counts read around each run, and the card against the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.data.augment import augment_batch
    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.data.synthetic import make_synthetic_dataset
    from mggan_tpu_torch.eval.evaluate import (
        HOST_ONLY, batch_seed, evaluate_ade_fde, get_predictions_multi,
    )
    from mggan_tpu_torch.eval.manifold import evaluate_precision_recall
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import construct_model, tree_to
    from mggan_tpu_torch.ops import kernels

    ds = make_synthetic_dataset(num_windows=EVAL_WINDOWS, max_peds=PEDS, seed=2)
    loader = lambda d: PaddedBatcher(d, batch_size=EVAL_BATCH, max_peds=PEDS)
    ks = list(range(1, EVAL_K + 1))
    n_agents = sum(len(t) for t in ds.trajectories)
    cfg = flagship_config()
    params, state, spec = construct_model(cfg, seed=SEED, device="cuda")
    cfg1 = dataclasses.replace(cfg, num_gens=1)  # the flagship at one generator
    params1, state1, spec1 = construct_model(cfg1, seed=SEED, device="cuda")
    runs = (("f32", cfg, params, state, spec, None, F32_STRATEGIES, ds),
            ("bf16", cfg, params, state, spec, torch.bfloat16, BF16_STRATEGIES, ds),
            ("rejection", cfg1, params1, state1, spec1, None, ("rejection",),
             first_windows(ds, REJECTION_WINDOWS)))
    out, cpu_checks = {}, {}
    for mode, c, prm, st, sp, cd, strats, data in runs:
        pred = Predictor(c, sp, prm, st, device="cuda", compute_dtype=cd)
        # warm-up on one batch: cuDNN's algorithm choice, the first launches
        get_predictions_multi(pred, loader(first_windows(data, EVAL_BATCH)), EVAL_K,
                              strats, seed=SEED)
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        preds = get_predictions_multi(pred, loader(data), EVAL_K, strats, seed=SEED)
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
        t1 = time.perf_counter()
        metrics = {}
        for s_name, p_arr in preds.items():
            check(p_arr.shape == (12, EVAL_K, sum(len(t) for t in data.trajectories), 2),
                  f"eval {mode} {s_name}: shape {p_arr.shape}")
            check(np.isfinite(p_arr).all(), f"eval {mode} {s_name}: non-finite predictions")
            metrics[s_name] = {**evaluate_ade_fde(data, p_arr, ks),
                               **evaluate_precision_recall(data, p_arr, 3.0, ks)}
            bad = [k for k, v in metrics[s_name].items() if not np.isfinite(v)]
            check(not bad, f"eval {mode} {s_name}: non-finite metrics {bad[:3]}")
        metric_s = time.perf_counter() - t1
        out[mode] = {"windows": len(data), "seconds": secs, "ms_per_window": secs / len(data) * 1e3,
                     "metric_seconds": metric_s, "launches": launches,
                     "metrics": {s_name: {k: v for k, v in m.items()
                                          if k.endswith(("k=1", "k=5", "k=19")) or k == "Precision"}
                                 for s_name, m in metrics.items()}}
        print(f"eval {mode}: {len(data)} windows x up to {PEDS} peds in batches of {EVAL_BATCH}, "
              f"k={EVAL_K}, strategies {','.join(strats)}: {secs:.3f} s "
              f"({secs / len(data) * 1e3:.3f} ms per window), metrics on the host "
              f"{metric_s:.3f} s; launches {json.dumps(launches)}")
        for s_name, m in metrics.items():
            print(f"  {s_name:>16}: ADE k=1 {m['ADE k=1']:.4f} k=19 {m['ADE k=19']:.4f}, "
                  f"FDE k=1 {m['FDE k=1']:.4f} k=19 {m['FDE k=19']:.4f}, Mode k=19 "
                  f"{m['Mode k=19']:.4f}, Precision {m['Precision']:.4f}, Recall k=19 "
                  f"{m['Recall k=19']:.4f}")

        # the first batches again on the port's CPU path, same draws
        cpu = Predictor(c, sp, tree_to(prm, "cpu"), tree_to(st, "cpu"), device="cpu",
                        compute_dtype=cd)
        if mode == "rejection":
            batch = next(iter(loader(data)))
            mb = augment_batch({k: v for k, v in batch.items() if k not in HOST_ONLY},
                               train=False, device="cuda")
            draws = cpu.make_draws(torch.Generator().manual_seed(SEED), strats,
                                   EVAL_BATCH, PEDS, EVAL_K)["rejection"]
            d_gpu = pred.rejection_decodes(mb, None, EVAL_K, draws=draws)
            d_cpu = cpu.rejection_decodes(mb, None, EVAL_K, draws=draws)
            errs = {k: float((d_gpu[k].cpu() - d_cpu[k]).abs().max()) for k in ("base", "pert")}
            cpu_checks[mode] = {"decode_max_abs_diff": errs,
                                "rows": int(d_cpu["pert"][..., 0, 0].numel())}
            print(f"  rejection card vs CPU, first batch, same draws: base decode max abs "
                  f"diff {errs['base']:.3e}, perturbed decodes {errs['pert']:.3e} "
                  f"(atol {EVAL_ATOL:g})")
            check(max(errs.values()) <= EVAL_ATOL, f"rejection decodes card vs CPU {errs}")
            continue
        sub = first_windows(data, CPU_BATCHES * EVAL_BATCH)
        draws = [cpu.make_draws(torch.Generator().manual_seed(batch_seed(SEED, i)), strats,
                                EVAL_BATCH, PEDS, EVAL_K) for i in range(CPU_BATCHES)]
        on_card = get_predictions_multi(pred, loader(sub), EVAL_K, strats, draws=draws)
        on_cpu = get_predictions_multi(cpu, loader(sub), EVAL_K, strats, draws=draws)
        cpu_checks[mode] = {s_name: compare_eval(sub, on_card[s_name], on_cpu[s_name], ks,
                                                 cd is not None) for s_name in strats}
        checks = {f"card vs CPU {mode}": cpu_checks[mode]}
        if cd is not None:  # the wrong variant: the card in f32, the CPU in bf16
            pred32 = Predictor(c, sp, prm, st, device="cuda")
            on_card32 = get_predictions_multi(pred32, loader(sub), EVAL_K, strats, draws=draws)
            cpu_checks["f32_card_vs_bf16_cpu"] = {
                s_name: compare_eval(sub, on_card32[s_name], on_cpu[s_name], ks, True)
                for s_name in strats}
            checks["card in f32 vs CPU bf16 (must fail)"] = cpu_checks["f32_card_vs_bf16_cpu"]
            del pred32
        for what, results in checks.items():
            for s_name, r in results.items():
                print(f"  {what} {s_name}, first {CPU_BATCHES} batches, same draws: ADE/FDE "
                      f"max abs diff {r['metric_max_abs_diff']:.3e} (limit "
                      f"{r['metric_limit']:.0e}), Mode flips {r['mode_flips']} (Mode diffs "
                      f"explained by them: {r['mode_consistent_with_flips']}), predictions max "
                      f"abs diff {r['pred_max_abs_diff']:.3e} (limit {r['pred_limit']:.0e}) of "
                      f"max |value| {r['pred_scale']:.2f}, mean abs diff "
                      f"{r['pred_mean_abs_diff']:.3e} (limit {r['pred_mean_limit']:.0e}): "
                      f"within the limits {r['ok']}")
        for s_name, r in cpu_checks[mode].items():
            check(r["ok"], f"eval card vs CPU {mode} {s_name}: {r}")
        for s_name, r in cpu_checks.get("f32_card_vs_bf16_cpu", {}).items():
            check(not r["ok"], f"eval: a card run in f32 passes the bf16 limits ({s_name})")
        del pred, cpu
        torch.cuda.empty_cache()
    need = {"f32": {"decode_all_fwd": 2, "decode_select": 1},
            "bf16": {"decode_all_fwd_bf16": 1, "decode_select_bf16": 1},
            "rejection": {"decode_all_fwd": 2}}
    for mode, per_batch in need.items():
        batches = -(-out[mode]["windows"] // EVAL_BATCH)
        for name, count in per_batch.items():
            got = out[mode]["launches"].get(name, 0)
            check(got >= count * batches, f"eval {mode}: {name} launched {got} times")
    return {"agents": n_agents, "runs": out, "card_vs_cpu": cpu_checks}


def phase_bench_sampling(reps=3):
    """``Predictor.predict`` at bench.py's batch (4,096 scenes x 16 peds,
    k=20; inputs made on the card from a seed) in f32 and in bf16: host
    clock around calls that end in a synchronize, launch counts around the
    timed calls, then one profiled call for K1's share of device time."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import construct_model
    from mggan_tpu_torch.ops import kernels

    cfg = flagship_config()
    params, state, spec = construct_model(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s, p = BENCH_SCENES, PEDS
    batch = {"xy": torch.randn((s, p, 20, 2), generator=gen, device="cuda").cumsum(2) * 0.1,
             "ped_mask": torch.ones((s, p), dtype=torch.bool, device="cuda"),
             "patches": torch.rand((s, p, 33, 33, 4), generator=gen, device="cuda") * 2 - 1}
    out = {}
    for mode, cd, k1 in (("f32", None, "decode_select"),
                         ("bf16", torch.bfloat16, "decode_select_bf16")):
        pred = Predictor(cfg, spec, params, state, device="cuda", compute_dtype=cd)
        g = pred.new_generator(SEED)
        res = pred.predict(batch, g, num=NUM)
        torch.cuda.synchronize()
        check(res[0].shape == (NUM, s, p, 12, 2) and bool(torch.isfinite(res[0]).all()),
              f"bench sampling {mode}: bad output")
        torch.cuda.reset_peak_memory_stats()
        kernels.launches.clear()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pred.predict(batch, g, num=NUM)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(launches.get(k1, 0) >= reps, f"bench sampling {mode}: K1 launched {launches}")
        prof = device_profile(lambda rep: pred.predict(batch, g, num=NUM), 1,
                              f"sampling {mode}, {s} scenes x {p} peds, k={NUM}", "call")
        # one K1 variant runs per mode; the profiler names it by its kernel
        k1_ms = sum(v for name, v in prof["by_name_ms"].items()
                    if any(k in name for k in ("decode_select_kernel", "decode_select_tiled_kernel",
                                               "decode_select_mma_kernel")))
        p50 = float(np.median(times))
        out[mode] = {"p50_ms": p50, "times_ms": times, "traj_per_s": s * p * NUM / p50 * 1e3,
                     "launches": launches, "peak_gib": peak, "k1_device_ms": k1_ms,
                     "device_busy_ms": prof["device_busy_ms"],
                     "k1_share_of_device_time": k1_ms / prof["device_busy_ms"],
                     "idle_share": prof["idle_share"]}
        print(f"bench sampling {mode}: {s} scenes x {p} peds, k={NUM}: p50 {p50:.3f} ms over "
              f"{reps} calls ({out[mode]['traj_per_s']:.4g} trajectories/s), peak device "
              f"memory {peak:.2f} GiB; K1 {k1_ms:.3f} ms of {prof['device_busy_ms']:.3f} ms "
              f"device time ({out[mode]['k1_share_of_device_time']:.3f}); launches "
              f"{json.dumps(launches)}")
        del pred, res
        torch.cuda.empty_cache()
    return out


def sorted_tiles_bound_ms(prepared, peak_flops=PEAK_FP32_FLOPS):
    """K4's kernel (B2, or K4-bf16 alone): the buffer rows, tile generators
    and weights (K4-bf16's fragment image) read once, ``(n_buf, 2, T, 2)``
    written once; per buffer row K1's products and socb's."""
    n_buf, _, feat, h, hid, in_dim, t = prepared["dims"][:7]
    tensors = prepared["tensors"]
    if prepared["bf16"]:
        tensors = (prepared["mma_wpack"],) + tensors[1:]
    flops = rollout_flops(n_buf, t, h, hid, in_dim) + n_buf * 2 * feat * hid
    return roofline_ms(flops, nbytes_of(*tensors) + n_buf * 4 * t * 4, peak_flops)


def sorted_route_bound_ms(args, compute_dtype=None, peak_flops=PEAK_FP32_FLOPS):
    """K4's route as a function: each row's h0, social features, xy, dxdy
    and generator and the weights read once, abs and rel written once; per
    row K1's products and socb's."""
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    stacked, xy, dxdy, soc, h0, idx, t, fmt = args
    packed = kdec.pack_decoder_params(stacked, fmt)
    n, h = h0.shape
    g, in_dim, _ = packed["w_emb"].shape
    hid, feat = packed["w1h"].shape[2], soc.shape[1]
    weights = kdec.kernel_weights(packed, compute_dtype)[0]
    flops = rollout_flops(n, t, h, hid, in_dim) + n * 2 * feat * hid
    nbytes = nbytes_of(h0, soc, xy, dxdy, idx, weights, packed["w1s"], packed["b1"])
    return roofline_ms(flops, nbytes + 2 * n * t * 2 * 4, peak_flops)


def phase_ablation_kernels():
    """The ablation path's kernels against their plain versions on the card
    (launches here are not the path's): K4's route in the three input
    formats, with F=0 and with every row on one generator, f32 and bf16;
    then, on the benchmarks' inputs at ABL_ROWS rows, K5 and B1-f32 against
    the warp-per-row K1 bit for bit (K5 also against the tiled K1) and
    K5-bf16 against the tensor-core K1-bf16, each new kernel against its
    plain version (the bf16 ones also within BF16_MEAN_ATOL on average) and
    timed beside it and its bound, K4's route against K1 (K1-bf16) and B2 on
    grouped rows; the f32 route and B2 bit for bit against the kept
    warp-per-row route and kernel."""
    import torch

    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ablations import sorted_select_ablation as sab
    from mggan_tpu_torch.models import common
    from mggan_tpu_torch.ops.kernels import decode_ablation as kab
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    on = lambda x: ({k: on(v) for k, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    gen = torch.Generator().manual_seed(SEED + 4)

    def compare(got, want, what):
        check(all(bool(torch.isfinite(a).all()) for a in got), f"{what}: non-finite output")
        diffs = [(a - b).abs() for a, b in zip(got, want)]
        return max(float(d.max()) for d in diffs), max(float(d.mean()) for d in diffs)

    cases = {}
    for fmt, feat, skew in (("rel", 32, False), ("abs", 32, False), ("abs_rel", 32, False),
                            ("rel", 0, False), ("rel", 32, True)):
        m, n = SORTED_AGENTS, SORTED_AGENTS * SORTED_K
        rand = lambda *shape: torch.randn(shape, generator=gen)
        idx = (torch.full((n,), 2, dtype=torch.int32) if skew
               else torch.randint(0, 4, (n,), generator=gen, dtype=torch.int32))
        args = (on(common.stacked_decoders_init(gen, 4, 16, 32, fmt, feat)),
                *map(on, (rand(m, 2) * 3.0, rand(m, 2) * 0.3, rand(m, feat), rand(n, 32), idx)),
                12, fmt)
        label = f"{fmt}, F={feat}" + (", every row on generator 2" if skew else "")
        for cd, atol in ((None, KERNEL_ATOL), (bf16, BF16_ATOL)):
            got = ks.decode_select_sorted(*args, compute_dtype=cd)
            torch.cuda.synchronize()
            want = ks.decode_select_sorted_reference(*args, compute_dtype=cd)
            err = compare(got, want, f"decode_sorted {label}")[0]
            cases[f"{label}, {'bf16' if cd else 'f32'}"] = err
            print(f"decode_sorted route [{label}, {'bf16' if cd else 'f32'}] N={n}: max_abs_err "
                  f"{err:.3e} against its plain version (atol {atol:g})")
            check(err <= atol, f"decode_sorted {label}: max abs err {err:.3e} > {atol}")
        if fmt == "rel" and feat and not skew:  # the wrong variant: the f32 route, bf16 plain
            wrong = compare(ks.decode_select_sorted(*args),
                            ks.decode_select_sorted_reference(*args, compute_dtype=bf16),
                            "decode_sorted")[0]
            cases["f32 route against the bf16 plain version"] = wrong
            print(f"  the f32 route against the bf16 plain version: {wrong:.3e} (must exceed "
                  f"{BF16_ATOL:g})")
            check(wrong > BF16_ATOL, f"decode_sorted: the f32 route passes the bf16 limit")

    inp = make_inputs(ABL_ROWS, SEED)
    args, p32, p16 = dab.prepare(inp)
    calls = dab.variants(inp)
    # K5, B1-f32 and K4 keep the warp-per-row rollout's bits: held to the
    # warp-per-row K1 (K5 also to the tiled K1); K5-bf16 and K4-bf16 run
    # K1-bf16's tensor-core rollout
    k1, k1_bf16 = kdec.launch_decode_select_warp(p32), kdec.launch_decode_select(p16)
    k1_tiled = kdec.launch_decode_select(p32)
    torch.cuda.synchronize()
    plain = {"f32": lambda: kdec.decode_select_reference(*args),
             "bf16": lambda: kdec.decode_select_reference(*args, compute_dtype=bf16),
             "act_bf16": lambda: kab.decode_select_act_reference(*args[:7], "bf16"),
             "act_lin": lambda: kab.decode_select_act_reference(*args[:7], "lin")}
    plain_out = {k: f() for k, f in plain.items()}
    plain_ms = {k: cuda_time_ms(f, 4, warmup=1) for k, f in plain.items()}
    b32, b16 = decode_select_bound_ms(p32), decode_select_bound_ms(p16, PEAK_BF16_FLOPS)
    out = {}

    def record(name, call, want_key, atol, bound, equal_to=None, mean_atol=None, **extra):
        got = call()
        torch.cuda.synchronize()
        err, mean = compare(got, plain_out[want_key], name)
        identical = None if equal_to is None else all(
            torch.equal(a, b) for a, b in zip(got, equal_to))
        ms = cuda_time_ms(call, 20)
        out[name] = {"n_rows": ABL_ROWS, "max_abs_err": err, "mean_abs_err": mean,
                     "atol": atol, "ms": ms, "plain_ms": plain_ms[want_key],
                     "bound_ms": bound[0], "bound_by": bound[1], **extra}
        if identical is not None:
            out[name]["equals_k1_bit_for_bit"] = identical
        print(f"{name} N={ABL_ROWS}: max_abs_err {err:.3e} (mean {mean:.3e}; atol {atol:g})"
              + ("" if identical is None else f", equal to K1 bit for bit: {identical}")
              + f"; kernel {ms:.4f} ms, plain {plain_ms[want_key]:.3f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}, library_ms null")
        check(err <= atol, f"{name}: max abs err {err:.3e} > {atol}")
        if mean_atol is not None:
            out[name]["mean_atol"] = mean_atol
            check(mean <= mean_atol, f"{name}: mean abs err {mean:.3e} > {mean_atol}")
        check(identical is not False, f"{name} differs from K1")
        return got

    def same_bits(name, got, want, what):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        key = what.lower().replace(" ", "_").replace("-", "_")
        out[name][f"equals_{key}_bit_for_bit"] = same
        print(f"  {name} equal to the {what} bit for bit: {same}")
        check(same, f"{name} differs from the {what}")

    fp32_fma = lambda b: {"bound_ms_fp32_fma": b[0]}
    ilp = record("decode_select_ilp", calls["kernel_ilp"], "f32", KERNEL_ATOL, b32, k1)
    same_bits("decode_select_ilp", ilp, k1_tiled, "tiled K1")
    record("decode_select_ilp_bf16", calls["kernel_ilp_bf16"], "bf16", BF16_ATOL, b16, k1_bf16,
           mean_atol=BF16_MEAN_ATOL, **fp32_fma(b32))
    record("decode_select_act_f32", calls["kernel_f32"], "f32", KERNEL_ATOL, b32, k1)
    act16 = record("decode_select_act_bf16", calls["kernel_bf16"], "act_bf16", B1_BF16_ATOL, b32)
    # the wrong variant: B1-f32 (K1) against B1-bf16's plain version
    wrong = compare(k1, plain_out["act_bf16"], "decode_select")
    out["decode_select_act_bf16"]["f32_kernel_vs_bf16_plain"] = {"max": wrong[0], "mean": wrong[1]}
    print(f"  K1 against B1-bf16's plain version: max {wrong[0]:.3e}, mean {wrong[1]:.3e} "
          f"(must exceed {B1_BF16_ATOL:g}); B1-bf16 kernel against K1: "
          f"{compare(act16, k1, 'b1')[0]:.3e}")
    check(wrong[0] > B1_BF16_ATOL, "K1 passes B1-bf16's limit")
    record("decode_select_act_lin", calls["kernel_lin"], "act_lin", KERNEL_ATOL, b32)

    # K4's route and B2 at ABL_ROWS rows
    for name, cd, atol, k1_out in (("decode_sorted", None, KERNEL_ATOL, k1),
                                   ("decode_sorted_bf16", bf16, BF16_ATOL, k1_bf16)):
        call = lambda cd=cd: ks.decode_select_sorted(*args, compute_dtype=cd)
        want = ks.decode_select_sorted_reference(*args, compute_dtype=cd)
        plain_out[name] = want
        plain_ms[name] = cuda_time_ms(
            lambda cd=cd: ks.decode_select_sorted_reference(*args, compute_dtype=cd), 4, warmup=1)
        bound = (sorted_route_bound_ms(args, cd, PEAK_BF16_FLOPS) if cd
                 else sorted_route_bound_ms(args))
        extra = ({"bound_ms_fp32_fma": sorted_route_bound_ms(args, cd)[0],
                  "mean_atol": BF16_MEAN_ATOL} if cd else {})
        got = record(name, call, name, atol, bound, **extra)
        vs_k1, vs_k1_mean = compare(got, k1_out, name)
        out[name].update(vs_k1_max_abs=vs_k1, vs_k1_mean_abs=vs_k1_mean)
        print(f"  {name} route against K1{'-bf16' if cd else ''} on the same draws: {vs_k1:.3e} "
              f"(atol {atol:g}), mean {vs_k1_mean:.3e}")
        check(vs_k1 <= atol, f"{name}: the route and K1 differ by {vs_k1:.3e}")
        check(not cd or vs_k1_mean <= BF16_MEAN_ATOL,
              f"{name}: the route and K1-bf16 differ by {vs_k1_mean:.3e} on average")
        if not cd:
            same_bits(name, got, ks.decode_select_sorted_warp(*args), "warp-per-row route")
    packed, rows, tile_gen, prep = sab.grouped_tiles(inp)
    tiles_plain = lambda: (ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, rows, 32, 32,
                                                     12, "rel"),)
    plain_out["sorted_tiles"] = tiles_plain()
    plain_ms["sorted_tiles"] = cuda_time_ms(tiles_plain, 4, warmup=1)
    b2 = record("sorted_tiles", lambda: (ks.launch_sorted_tiles(prep),), "sorted_tiles",
                KERNEL_ATOL, sorted_tiles_bound_ms(prep))
    same_bits("sorted_tiles", b2, (ks.launch_sorted_tiles_warp(prep),), "warp-per-row kernel")
    del inp, calls, plain_out, k1, k1_bf16, k1_tiled, ilp, b2
    torch.cuda.empty_cache()
    return {"sorted_route_cases": cases, "kernels": out}


def hc_checks(got, want):
    """K2-bf16's (abs, rel, hc) against the bf16 plain forward's: max abs
    error, hc's max and mean abs error, whether every saved h is a bf16
    value and the share of saved c that is one (an f32 c lands on a bf16
    value about once in 2^16); ``ok`` if all lie within their limits."""
    import torch

    h, c = got[2][..., 0, :], got[2][..., 1, :]
    r = {"max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
         "hc_max_abs_err": float((got[2] - want[2]).abs().max()),
         "hc_mean_abs_err": float((got[2] - want[2]).abs().mean()),
         "h_is_bf16": bool(torch.equal(h, h.to(torch.bfloat16).float())),
         "c_bf16_share": float((c == c.to(torch.bfloat16).float()).float().mean())}
    r["ok"] = (r["max_abs_err"] <= BF16_ATOL and r["hc_mean_abs_err"] <= HC_MEAN_ATOL
               and r["h_is_bf16"] and r["c_bf16_share"] < 0.01)
    return r


def phase_bf16_backward():
    """K3 after K2-bf16 at the PM step's rows (4,096 x 4). K2-bf16's saved
    (h, c) against the bf16 plain forward's (h rounded to bf16, c in f32;
    the f32 forward's must fail); the whole route (K2-bf16 saving hc, then
    K3) against the plain forward and reverse sweep (kink rows, and rows
    where an h rounding flipped between the two forwards, reported apart
    as in phase 3), and K3 alone against the plain sweep on the kernel's
    residuals; the route on the f32 forward's residuals must fail those
    limits; ``DecodeAll`` in bf16 under autograd gives K3's grads bit for
    bit."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 5)
    m = TRAIN_SCENES * PEDS
    inputs = decode_all_case(m, 1, gen)
    p16, p32 = kda.prepare(*inputs, 12, "rel", bf16), kda.prepare(*inputs, 12, "rel")
    out16 = kda.launch_fwd(p16, save_hc=True)
    out32 = kda.launch_fwd(p32, save_hc=True)
    torch.cuda.synchronize()
    plain16 = kda.decode_all_reference(*inputs, 12, "rel", save_hc=True, compute_dtype=bf16)
    fwd, fwd_wrong = hc_checks(out16, plain16), hc_checks(out32, plain16)
    cot = torch.Generator(device="cuda").manual_seed(SEED + 1)
    g_abs = torch.randn(out16[0].shape, generator=cot, device="cuda")
    g_rel = torch.randn(out16[1].shape, generator=cot, device="cuda")
    after = kda.KERNEL_BWD_AFTER_BF16
    got = kda.decode_all_bwd(*inputs, *out16, g_abs, g_rel, 12, "rel", after)
    wrong = kda.decode_all_bwd(*inputs, *out32, g_abs, g_rel, 12, "rel")
    torch.cuda.synchronize()
    want = kda.decode_all_bwd_reference(*inputs, *plain16, g_abs, g_rel, 12, "rel")
    want_k3 = kda.decode_all_bwd_reference(*inputs, *out16, g_abs, g_rel, 12, "rel")
    kink_n = kink_rows(inputs, out16[2]) | kink_rows(inputs, plain16[2])
    # rows where an h rounding flipped between the two forwards: other
    # residuals, so against the plain route their per-row grads are
    # reported apart, as kink rows are
    flip_n = (out16[2][..., 0, :] != plain16[2][..., 0, :]).flatten(2).any(-1).any(0)
    apart = kink_n | flip_n
    ge, ge_wrong = (grad_errors(x, want, apart, apart) for x in (got, wrong))
    ge_k3 = grad_errors(got, want_k3, kink_n, kink_n)
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    a, r = kda.DecodeAll.apply(*leaves, 12, "rel", bf16)
    route = torch.autograd.grad((a * g_abs).sum() + (r * g_rel).sum(), leaves)
    identical = all(torch.equal(x, y) for x, y in zip(route, got))
    raw = kda.launch_bwd(p32, *out16, g_abs, g_rel, after)
    ms = cuda_time_ms(lambda: kda.launch_bwd(p32, *out16, g_abs, g_rel, after), 20)
    plain_ms = cuda_time_ms(lambda: kda.decode_all_bwd_reference(
        *inputs, *out16, g_abs, g_rel, 12, "rel"), 4, warmup=1)
    bound = decode_all_bwd_bound_ms(p32, (*out16, g_abs, g_rel), raw)
    drop_ok = lambda d: {k: v for k, v in d.items() if k != "ok"}
    res = {"n_rows": m, **drop_ok(ge),
           "max_abs_err": max(ge["weight_grad_max_abs_err"], ge["row_grad_max_abs_err"]),
           "kink_rows": int(kink_n.sum()), "flip_rows": int(flip_n.sum()),
           "forward_vs_plain": fwd,
           "f32_forward_vs_plain": fwd_wrong, "k3_on_kernel_residuals": drop_ok(ge_k3),
           "f32_forward": drop_ok(ge_wrong),
           "route_equals_k3_bit_for_bit": identical, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound[0], "bound_by": bound[1]}
    print(f"decode_all_fwd_bf16 saving hc N={m} x G=4: (abs, rel, hc) max_abs_err "
          f"{fwd['max_abs_err']:.3e} (hc {fwd['hc_max_abs_err']:.3e}; atol {BF16_ATOL:g}), hc "
          f"mean {fwd['hc_mean_abs_err']:.3e} (limit {HC_MEAN_ATOL:g}), saved h all bf16 "
          f"values: {fwd['h_is_bf16']}, share of saved c on bf16 values "
          f"{fwd['c_bf16_share']:.2e}; the f32 forward's hc against the bf16 plain version: "
          f"max {fwd_wrong['hc_max_abs_err']:.3e}, mean {fwd_wrong['hc_mean_abs_err']:.3e}, "
          f"h all bf16 values: {fwd_wrong['h_is_bf16']} (must fail)")
    print(f"decode_all_bwd_after_bf16 N={m} x G=4, the route against the plain route: per-row "
          f"grads max_abs_err {ge['row_grad_max_abs_err']:.3e} ({ge['row_elements_beyond']} "
          f"beyond rtol/atol {GRAD_RTOL:g}); {res['kink_rows']} kink rows and "
          f"{res['flip_rows']} rows with a flipped h rounding, {ge['kink_elements_beyond']} "
          f"elements beyond there, max {ge['kink_max_abs_err']:.3e}; "
          f"weight grads {ge['weight_grad_err_over_max']:.2e} x max|grad| (limit {WGRAD_REL:g}); "
          f"K3 alone on the kernel's residuals: per-row {ge_k3['row_grad_max_abs_err']:.3e} "
          f"({ge_k3['row_elements_beyond']} beyond), weight grads "
          f"{ge_k3['weight_grad_err_over_max']:.2e} x max|grad|; the f32 forward's grads: "
          f"{ge_wrong['row_elements_beyond']} per-row elements beyond, weight grads "
          f"{ge_wrong['weight_grad_err_over_max']:.2e} x max|grad| (must fail); DecodeAll bf16 "
          f"route equals K3 bit for bit: {identical}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]}, library_ms null")
    check(fwd["ok"], f"decode_all_fwd_bf16 saving hc: {fwd}")
    check(fwd_wrong["hc_mean_abs_err"] > HC_MEAN_ATOL and not fwd_wrong["h_is_bf16"],
          f"the f32 forward's hc passes the bf16 forward's checks: {fwd_wrong}")
    check(ge["ok"], f"decode_all_bwd_after_bf16 against the plain route: {ge}")
    check(ge_k3["ok"], f"decode_all_bwd_after_bf16 on the kernel's residuals: {ge_k3}")
    check(not ge_wrong["ok"], "K3 after the f32 forward passes the bf16 backward's limits")
    check(identical, "DecodeAll in bf16 does not give K3's grads on the bf16 residuals")
    return res


def phase_ablation_path(reps=5):
    """The decoder ablation path, launch counts read around it: the two
    entry points' timings at 1,310,720 rows (``DECODEABL``, ``SORTEDPARTS``),
    K5, B1-f32 and the tiled K1 equal to the warp-per-row K1 bit for bit
    there and K5 and the tiled B1-f32 to the tiled K1 (K5-bf16 to the
    tensor-core K1-bf16; after the counts), K4's route within KERNEL_ATOL of
    K1 and equal to the kept warp-per-row route bit for bit, its bf16 route
    within BF16_ATOL (mean BF16_MEAN_ATOL) of K1-bf16 and of its plain
    version, where the f32 route must fail those limits, and a bf16
    gradient of ``decode_all`` at the PM step's rows (K2-bf16, then K3 in
    f32). The activations' share of K1 is 1 - B1-lin / K1 there (B1 is the
    tiled K1 with other activations). Then, outside the counts, B1-bf16,
    B1-lin, B2 (also bit for bit against the kept warp-per-row kernel) and
    K4-bf16 alone against their plain versions at those rows."""
    import torch

    from mggan_tpu_torch.ablations import N, decode_ablation as dab, make_inputs
    from mggan_tpu_torch.ablations import sorted_select_ablation as sab
    from mggan_tpu_torch.models import common
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.ops.kernels import decode_ablation as kab
    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec
    from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map

    inp = make_inputs(N, SEED)
    gen = torch.Generator().manual_seed(SEED + 6)
    m = TRAIN_SCENES * PEDS
    stacked = tree_map(lambda x: x.cuda(), common.stacked_decoders_init(gen, 4, 16, 32, "rel", 32))
    leaves = [x.requires_grad_() for x in tree_leaves(stacked)]
    rows = [torch.randn(s, generator=gen).cuda() for s in ((m, 2), (m, 2), (m, 32), (m, 32))]
    torch.cuda.synchronize()

    kernels.launches.clear()
    t0 = time.perf_counter()
    dec_ms = dab.run(inp, reps)
    sort_ms = sab.run(inp, reps)
    calls = dab.variants(inp)
    k1 = calls["kernel_select"]()
    route = ks.decode_select_sorted(*sab.route_args(inp))
    route16 = ks.decode_select_sorted(*sab.route_args(inp), compute_dtype=torch.bfloat16)
    vs_k1 = max(float((a - b).abs().max()) for a, b in zip(route, k1))
    a, r = kda.decode_all(stacked, rows[0], rows[1] * 0.3, rows[2], rows[3], 12, "rel",
                          compute_dtype=torch.bfloat16)
    grads = torch.autograd.grad(a.sum() + (r * r).sum(), leaves)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)

    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
    warps = {**dab.resident_warps(inp),
             **{f"sorted_{k}": v for k, v in sab.resident_warps(inp).items()}}
    args, p32, p16 = dab.prepare(inp)
    # after the counts: K5, B1-f32 and the tiled K1 against the warp-per-row
    # K1 (the rollout they share), which no path launches, and K4's route
    # against the kept warp-per-row route; K5-bf16 and K4's bf16 route
    # against the tensor-core K1-bf16
    k1_warp = kdec.launch_decode_select_warp(p32)
    equal = {name: all(torch.equal(a, b) for a, b in zip(calls[name](), k1_warp))
             for name in ("kernel_ilp", "kernel_f32", "kernel_select")}
    for name in ("kernel_ilp", "kernel_f32"):
        equal[f"{name}_vs_tiled_k1"] = all(torch.equal(a, b)
                                           for a, b in zip(calls[name](), k1))
    equal["route_vs_warp_route"] = all(torch.equal(a, b) for a, b in zip(
        route, ks.decode_select_sorted_warp(*sab.route_args(inp))))
    k1_bf16 = calls["kernel_select_bf16"]()
    equal["kernel_ilp_bf16"] = all(torch.equal(a, b)
                                   for a, b in zip(calls["kernel_ilp_bf16"](), k1_bf16))
    err = lambda a_, b_: (max(float((x - y).abs().max()) for x, y in zip(a_, b_)),
                          max(float((x - y).abs().mean()) for x, y in zip(a_, b_)))
    route16_plain = ks.decode_select_sorted_reference(*sab.route_args(inp),
                                                      compute_dtype=torch.bfloat16)
    route16_err = {"vs_k1_bf16": err(route16, k1_bf16), "vs_plain": err(route16, route16_plain),
                   "f32_route_vs_plain": err(route, route16_plain)}
    vs_k1_bf16 = route16_err["vs_k1_bf16"][0]
    del route16_plain
    packed, grouped, tile_gen, tiles = sab.grouped_tiles(inp)
    tiles16 = sab.grouped_tiles(inp, compute_dtype=torch.bfloat16)[3]
    # B1-bf16, B1-lin, B2 and K4-bf16 alone against their plain versions at
    # these rows (after the counts were read: these launches are not the path's)
    at_n = {}
    for name, call, plain, atol in (
            ("kernel_bf16", calls["kernel_bf16"],
             lambda: kab.decode_select_act_reference(*args[:7], "bf16"), B1_BF16_ATOL),
            ("kernel_lin", calls["kernel_lin"],
             lambda: kab.decode_select_act_reference(*args[:7], "lin"), KERNEL_ATOL),
            ("kernel_only", lambda: (ks.launch_sorted_tiles(tiles),),
             lambda: (ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, grouped, 32, 32, 12,
                                                "rel"),), KERNEL_ATOL),
            ("kernel_only_bf16", lambda: (ks.launch_sorted_tiles(tiles16),),
             lambda: (ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, grouped, 32, 32, 12,
                                                "rel", torch.bfloat16),), BF16_ATOL)):
        got, want = call(), plain()
        at_n[name] = {"max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                      "atol": atol}
        if name == "kernel_only_bf16":
            at_n[name].update(mean_abs_err=err(got, want)[1], mean_atol=BF16_MEAN_ATOL)
        if name == "kernel_only":  # B2 against the kept warp-per-row kernel
            equal["kernel_only_vs_warp_kernel"] = torch.equal(got[0],
                                                              ks.launch_sorted_tiles_warp(tiles))
        if name == "kernel_bf16":  # K1 must lie beyond B1-bf16's limit here too
            at_n[name]["k1_vs_plain"] = max(float((a - b).abs().max())
                                            for a, b in zip(k1, want))
        del got, want
    bounds = {"kernel_select": decode_select_bound_ms(p32),
              "kernel_select_bf16": decode_select_bound_ms(p16, PEAK_BF16_FLOPS),
              "kernel_only": sorted_tiles_bound_ms(tiles),
              "kernel_only_bf16": sorted_tiles_bound_ms(tiles16, PEAK_BF16_FLOPS),
              "route": sorted_route_bound_ms(args),
              "route_bf16": sorted_route_bound_ms(args, torch.bfloat16, PEAK_BF16_FLOPS)}
    bounds = {k: {"bound_ms": v[0], "bound_by": v[1]} for k, v in bounds.items()}
    share = {act: 1.0 - dec_ms[f"kernel_{act}"] / dec_ms["kernel_select"]
             for act in ("lin", "bf16")}
    print(f"ablation path launches ({secs:.2f} s): {json.dumps(launches)}")
    print("DECODEABL " + json.dumps({"rows": N, "ms": dec_ms, "warps_per_sm": warps}))
    print(f"activations' share of K1 at {N} rows (1 - B1-lin / K1, both tiled): "
          f"{share['lin']:.4f} (K1 {dec_ms['kernel_select']:.4f} ms, B1-f32 "
          f"{dec_ms['kernel_f32']:.4f}, B1-lin {dec_ms['kernel_lin']:.4f}, B1-bf16 "
          f"{dec_ms['kernel_bf16']:.4f}: 1 - B1-bf16 / K1 = {share['bf16']:.4f})")
    print("SORTEDPARTS " + json.dumps({"rows": N, "ms": sort_ms}))
    print(f"ablation path at {N} rows, against the warp-per-row K1: K5 {equal['kernel_ilp']}, "
          f"B1-f32 {equal['kernel_f32']}, the tiled K1 {equal['kernel_select']} (bit for bit); "
          f"K5 == the tiled K1 {equal['kernel_ilp_vs_tiled_k1']}; "
          f"the tiled B1-f32 == the tiled K1 {equal['kernel_f32_vs_tiled_k1']}; "
          f"K5-bf16 == the tensor-core K1-bf16 {equal['kernel_ilp_bf16']}; K4's route "
          f"== the kept warp-per-row route {equal['route_vs_warp_route']}, B2 == the kept "
          f"warp-per-row kernel {equal['kernel_only_vs_warp_kernel']}; K4's route "
          f"against K1 {vs_k1:.3e} (atol {KERNEL_ATOL:g}); its bf16 route (max, mean) against "
          f"K1-bf16 and its plain version, and the f32 route against that plain version (must "
          f"exceed both): {json.dumps(route16_err)} (atol {BF16_ATOL:g}, mean "
          f"{BF16_MEAN_ATOL:g}); bounds {json.dumps(bounds)}; bf16 decode_all grads finite "
          f"{grads_finite}")
    print(f"at {N} rows against their plain versions: {json.dumps(at_n)} (B1-bf16's "
          f"k1_vs_plain must exceed {B1_BF16_ATOL:g})")
    for name, same in equal.items():
        check(same, f"ablation path: {name} is not equal bit for bit at {N} rows")
    check(vs_k1 <= KERNEL_ATOL, f"ablation path: K4's route and K1 differ by {vs_k1:.3e}")
    for key in ("vs_k1_bf16", "vs_plain"):
        mx, mean = route16_err[key]
        check(mx <= BF16_ATOL and mean <= BF16_MEAN_ATOL,
              f"ablation path: K4's bf16 route {key}: max {mx:.3e}, mean {mean:.3e}")
    check(route16_err["f32_route_vs_plain"][0] > BF16_ATOL
          and route16_err["f32_route_vs_plain"][1] > BF16_MEAN_ATOL,
          f"ablation path: the f32 route passes the bf16 limits: {route16_err}")
    for name, r in at_n.items():
        mean_ok = r.get("mean_abs_err", 0.0) <= r.get("mean_atol", float("inf"))
        check(r["max_abs_err"] <= r["atol"] and mean_ok, f"ablation path: {name} at {N} rows: {r}")
    check(at_n["kernel_bf16"]["k1_vs_plain"] > B1_BF16_ATOL,
          f"ablation path: K1 passes B1-bf16's limit at {N} rows")
    check(grads_finite, "ablation path: non-finite bf16 grads")
    del inp, calls, k1, k1_warp, k1_bf16, route, route16, args, p32, p16, packed, grouped, tiles
    del tiles16
    torch.cuda.empty_cache()
    return {"rows": N, "seconds": secs, "launches": launches, "decodeabl_ms": dec_ms,
            "activation_share_of_k1": share["lin"], "bf16_activation_saving": share["bf16"],
            "sortedparts_ms": sort_ms, "warps_per_sm": warps, "bounds_1310720": bounds,
            "equal_to_k1": equal, "route_vs_k1_max_abs": vs_k1,
            "route_bf16_vs_k1_bf16_max_abs": vs_k1_bf16,
            "route_bf16_max_mean": route16_err, "against_plain": at_n}


def ptxas_registers(stem, *needles):
    """Registers per thread and spill bytes (stores, loads) nvcc reported
    for the kernel of ``csrc/<stem>.cu`` whose entry name holds every one of
    ``needles``: ``(registers, "<n> bytes spill stores, <m> bytes spill
    loads")``, or ``(None, None)`` if the report lacks it."""
    import re

    from mggan_tpu_torch.ops.kernels import build

    found, regs, spills = False, None, None
    for line in build.build_log(stem).splitlines():
        if "Compiling entry function" in line:
            found = all(n in line for n in needles)
        elif found and "spill" in line:
            spills = line.strip()
        elif found and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            return regs, spills
    return regs, spills


def alternate_ms(old, new, reps):
    """CUDA-event times of two calls in turns (old, new, new, old):
    ``(old ms, new ms)``, each the mean of its two readings."""
    t = [cuda_time_ms(f, reps) for f in (old, new, new, old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def phase_redesigned():
    """K3 and K1-bf16, each redesigned for the H100, against their plain
    versions and timed beside the kernels they replaced (kept for this
    comparison; no path launches them), with registers and resident warps.
    K3 at the PM step's 4,096 x 4 rows and the G step's 81,920 x 4: per-row
    and weight-grad limits, kink rows reported, two launches bit-identical,
    the baseline's grads within the same limits of the new ones. K1-bf16 at
    eval's 9,728 rows and bench.py's 1,310,720: max (BF16_ATOL) and mean
    (BF16_MEAN_ATOL) abs error, the f32 kernel beyond both, within twice
    BF16_ATOL of the warp-per-row kernel (each lies within BF16_ATOL of the
    plain version); at 9,728 rows also every row on one generator, one
    generator absent, and rows without a generator (NaN)."""
    import torch

    from mggan_tpu_torch.ops.kernels import build
    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 7)
    k3 = {"config": None, "shapes": {}}
    for label, m, k, reps in (("pm", TRAIN_SCENES * PEDS, 1, 20),
                              ("g", TRAIN_SCENES * PEDS, NUM, 5)):
        inputs = decode_all_case(m, k, gen)
        prepared = kda.prepare(*inputs, 12, "rel")
        out_abs, out_rel, hc = kda.launch_fwd(prepared, save_hc=True)
        cot = torch.Generator(device="cuda").manual_seed(SEED + 2)
        g_abs = torch.randn(out_abs.shape, generator=cot, device="cuda")
        g_rel = torch.randn(out_rel.shape, generator=cot, device="cuda")
        saved = (*inputs, out_abs, out_rel, hc, g_abs, g_rel)
        res = (out_abs, out_rel, hc, g_abs, g_rel)
        got_g = kda.decode_all_bwd(*saved, 12, "rel")
        raw1, raw2 = kda.launch_bwd(prepared, *res), kda.launch_bwd(prepared, *res)
        base = kda.launch_bwd_warp(prepared, *res)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(raw1, raw2))
        want_g = kda.decode_all_bwd_reference(*saved, 12, "rel")
        kink_n = kink_rows(inputs, hc)
        kink_m = kink_n.reshape(k, m).any(0)
        ge = grad_errors(got_g, want_g, kink_n, kink_m)
        base_g = kda.grads_from_raw(base, m)
        ge_base = grad_errors(got_g, base_g, kink_n, kink_m)
        old_ms, new_ms = alternate_ms(lambda: kda.launch_bwd_warp(prepared, *res),
                                      lambda: kda.launch_bwd(prepared, *res), reps)
        bb = decode_all_bwd_bound_ms(prepared, res, raw1)
        if k3["config"] is None:
            k3["config"] = {"new": kda.bwd_config(prepared),
                            "warp_baseline": kda.bwd_config(prepared, warp=True)}
        drop_ok = lambda d: {key: v for key, v in d.items() if key != "ok"}
        k3["shapes"][label] = {
            "n_rows": m * k, **drop_ok(ge), "kink_rows": int(kink_n.sum()),
            "bit_identical": identical, "vs_warp_baseline": drop_ok(ge_base),
            "ms": new_ms, "warp_baseline_ms": old_ms, "bound_ms": bb[0], "bound_by": bb[1]}
        print(f"K3 tiled [{label}] N={m * k} x G=4: per-row grads {ge['row_grad_max_abs_err']:.3e} "
              f"({ge['row_elements_beyond']} beyond rtol/atol {GRAD_RTOL:g}; "
              f"{int(kink_n.sum())} kink rows, {ge['kink_elements_beyond']} elements beyond "
              f"there), weight grads {ge['weight_grad_err_over_max']:.2e} x max|grad| (limit "
              f"{WGRAD_REL:g}), two launches bit-identical {identical}; against the warp-per-row "
              f"baseline: per-row {ge_base['row_grad_max_abs_err']:.3e} "
              f"({ge_base['row_elements_beyond']} beyond), weight grads "
              f"{ge_base['weight_grad_err_over_max']:.2e} x max|grad|; kernel {new_ms:.4f} ms, "
              f"baseline {old_ms:.4f} ms (same call, in turns), bound {bb[0]:.4f} ms by {bb[1]}")
        check(ge["ok"], f"K3 tiled {label} against the plain sweep: {ge}")
        check(ge_base["ok"], f"K3 tiled {label} against the warp-per-row baseline: {ge_base}")
        check(identical, f"K3 tiled {label}: two launches differ")
        del inputs, prepared, saved, res, got_g, want_g, raw1, raw2, base, base_g, hc
        torch.cuda.empty_cache()
    regs = {"new": ptxas_registers("decode_all", "decode_all_bwd_kernelILi2ELi32ELi16E"),
            "warp_baseline": ptxas_registers("decode_all", "decode_all_bwd_warp_kernel")}
    for key, cfg in k3["config"].items():
        cfg["registers"], cfg["spills"] = regs[key]
    print(f"K3 launch shapes (registers per thread from nvcc): {json.dumps(k3['config'])}")

    on = lambda x: ({key: on(v) for key, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    sel = {"shapes": {}, "cases": {}}
    for label, scenes, k, reps in (("eval", EVAL_BATCH, EVAL_K, 20),
                                   ("bench", BENCH_SCENES, NUM, 5)):
        case = on(decode_select_case(scenes, gen, num=k))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"], case["h0"],
                case["idx"], 12, "rel")
        p16, p32 = kdec.prepare_decode_select(*args, compute_dtype=bf16), \
            kdec.prepare_decode_select(*args)
        got = kdec.launch_decode_select(p16)
        warp = kdec.launch_decode_select_bf16_warp(p16)
        f32 = kdec.launch_decode_select(p32)
        torch.cuda.synchronize()
        want = kdec.decode_select_reference(*args, compute_dtype=bf16)
        err = lambda a_, b_: (max(float((x - y).abs().max()) for x, y in zip(a_, b_)),
                              max(float((x - y).abs().mean()) for x, y in zip(a_, b_)))
        (mx, mean), (mx32, mean32), (vs_warp, _) = err(got, want), err(f32, want), err(got, warp)
        old_ms, new_ms = alternate_ms(lambda: kdec.launch_decode_select_bf16_warp(p16),
                                      lambda: kdec.launch_decode_select(p16), reps)
        n = p16["dims"][0]
        b16, b32 = decode_select_bound_ms(p16, PEAK_BF16_FLOPS), decode_select_bound_ms(p16)
        sel["shapes"][label] = {"n_rows": n, "max_abs_err": mx, "mean_abs_err": mean,
                                "f32_kernel_max_abs": mx32, "f32_kernel_mean_abs": mean32,
                                "vs_warp_baseline_max_abs": vs_warp, "ms": new_ms,
                                "warp_baseline_ms": old_ms, "bound_ms": b16[0],
                                "bound_by": b16[1], "bound_ms_fp32_fma": b32[0],
                                "tile_rows": kdec.mma_tile_rows(n, torch.cuda.get_device_properties(
                                    0).multi_processor_count)}
        r = sel["shapes"][label]
        print(f"K1-bf16 tensor cores [{label}] N={n} (tiles of {r['tile_rows']} rows): max_abs_err "
              f"{mx:.3e} (atol {BF16_ATOL:g}), mean {mean:.3e} (limit {BF16_MEAN_ATOL:g}); the f32 "
              f"kernel: max {mx32:.3e}, mean {mean32:.3e} (must exceed both); against the "
              f"warp-per-row kernel {vs_warp:.3e}; kernel {new_ms:.4f} ms, warp-per-row "
              f"{old_ms:.4f} ms (same call, in turns), bound {b16[0]:.4f} ms by {b16[1]} "
              f"(bf16 tensor cores; {b32[0]:.4f} ms at the fp32-FMA peak)")
        check(all(bool(torch.isfinite(x).all()) for x in got), f"K1-bf16 {label}: non-finite")
        check(mx <= BF16_ATOL and mean <= BF16_MEAN_ATOL, f"K1-bf16 {label}: {r}")
        check(mx32 > BF16_ATOL and mean32 > BF16_MEAN_ATOL,
              f"K1-bf16 {label}: the f32 kernel passes the bf16 limits: {r}")
        # each kernel lies within BF16_ATOL of the plain version, each with
        # its own rounding flips: apart, they may differ by twice that
        check(vs_warp <= 2 * BF16_ATOL,
              f"K1-bf16 {label}: {vs_warp:.3e} from the warp-per-row kernel")

        if label == "eval":  # launch shapes; skewed and partial generator choices
            sel["config"] = {
                "new": {"warps_per_sm": kdec.mma_warps_per_sm(4),
                        "registers": ptxas_registers("decode_select_mma",
                                                     "decode_select_mma_kernel")},
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_select", "mggan_decode_select_warps_per_sm", 1,
                        nbytes_of(p16["tensors"][0])),
                    "registers": ptxas_registers("decode_select", "decode_select_kernel",
                                                 "bfloat16")}}
            g_count = 4
            n_idx = case["idx"].shape[0]
            nan_rows = torch.arange(0, n_idx, 97, device="cuda")
            variants = {
                "every row on generator 2": torch.full_like(case["idx"], 2),
                "generator 1 absent": torch.where(case["idx"] == 1, 3, case["idx"]),
                "rows without a generator": case["idx"].index_fill(0, nan_rows, -1)
                .index_fill(0, nan_rows[1::2], g_count),
            }
            for name, idx in variants.items():
                a16 = args[:5] + (idx.contiguous(),) + args[6:]
                out = kdec.launch_decode_select(kdec.prepare_decode_select(*a16,
                                                                           compute_dtype=bf16))
                torch.cuda.synchronize()
                bad = (idx < 0) | (idx >= g_count)
                ref = kdec.decode_select_reference(*a16[:5], idx.clamp(0, g_count - 1), *a16[6:],
                                                   compute_dtype=bf16)
                case_err = max(float((x[~bad] - y[~bad]).abs().max()) for x, y in zip(out, ref))
                nan_ok = all(bool(torch.isnan(x[bad]).all()) for x in out)
                finite_ok = all(bool(torch.isfinite(x[~bad]).all()) for x in out)
                sel["cases"][name] = {"max_abs_err": case_err, "rows_without_generator":
                                      int(bad.sum()), "those_rows_nan": nan_ok}
                print(f"  K1-bf16 [{label}, {name}]: max_abs_err {case_err:.3e} (atol "
                      f"{BF16_ATOL:g}); {int(bad.sum())} rows without a generator, all NaN: "
                      f"{nan_ok}")
                check(case_err <= BF16_ATOL and nan_ok and finite_ok,
                      f"K1-bf16 {name}: {sel['cases'][name]}")
        del case, args, p16, p32, got, warp, f32, want
        torch.cuda.empty_cache()
    print(f"K1-bf16 launch shapes (registers per thread from nvcc): {json.dumps(sel['config'])}")
    return {"decode_all_bwd": k3, "decode_select_bf16": sel, **redesigned_tiled(gen),
            "decode_all_fwd_bf16": redesigned_k2_bf16(gen), "decode_select_act": redesigned_b1(gen),
            **redesigned_ablation_bf16(), **redesigned_ablation_f32()}


K1_SWEEP_ROWS = (320, 960, 2_560, 4_096, 9_728, 20_480, 1_310_720)
K2_SWEEP_ROWS = (4_096, 9_728, 81_920)
K2_BF16_SWEEP = ((4_096, True), (9_728, False), (20_480, False), (81_920, False))  # (rows, hc)
ABL_SWEEP_ROWS = (9_728, 20_480, 81_920, 1_310_720)  # K5, K4, K5-bf16 and K4-bf16


def phase_launch_sweep(reps=5):
    """``python3 chip_smoke.py --sweep``: the tiled K1 and K2 timed at
    every launch shape their wrappers can pick, at the main paths' row
    counts (the rule's pick marked), beside the warp-per-row kernels, and
    each launch checked bit for bit against them; K2-bf16 at each launch
    variant and a range of blocks per generator, each launch bit for bit
    against the rule's; K5 at each rows a group and tile size, bit for bit
    against the tiled K1, and K4 at each warps a block, bit for bit against
    the route's; K5-bf16 at each launch
    variant and tile size, bit for bit against K1-bf16, and K4-bf16 at each
    warps a block, bit for bit against the route's. Prints one ``SWEEP``
    JSON line; not part of the default run."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 8)
    on = lambda x: ({key: on(v) for key, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    out = {"k1": {}, "k2": {}, "sms": sms}
    for n in K1_SWEEP_ROWS:
        num = NUM if n % (PEDS * NUM) == 0 else 1  # else one row per agent
        case = on(decode_select_case(n // (PEDS * num), gen, num=num))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"], case["h0"],
                case["idx"], 12, "rel")
        p = kdec.prepare_decode_select(*args)
        base = kdec.launch_decode_select_warp(p)
        warp_ms = cuda_time_ms(lambda: kdec.launch_decode_select_warp(p), reps)
        pick = kdec.tiled_launch(n, sms)
        res = {"warp_ms": warp_ms, "rule": pick, "shapes": {}}
        for r in kdec.TILED_ROWS:
            for tile in kdec.TILED_TILES:
                blocks = max(1, min(-(-n // tile), sms * kdec.TILED_BLOCKS_PER_SM))
                shape = (r, tile, blocks)
                got = kdec.launch_decode_select(p, shape=shape)
                same = all(torch.equal(a, b) for a, b in zip(got, base))
                check(same, f"sweep: tiled K1 {shape} at {n} rows differs from the warp kernel")
                res["shapes"][f"{r}/{tile}"] = cuda_time_ms(
                    lambda: kdec.launch_decode_select(p, shape=shape), reps)
        best = min(res["shapes"], key=res["shapes"].get)
        print(f"sweep K1 N={n}: warp-per-row {warp_ms:.4f} ms; rule R/tile {pick[0]}/{pick[1]} "
              f"{res['shapes'][f'{pick[0]}/{pick[1]}']:.4f} ms; best {best} "
              f"{res['shapes'][best]:.4f} ms")
        out["k1"][n] = res
        del case, args, p, base
    for n in K2_SWEEP_ROWS:
        inputs = decode_all_case(n, 1, gen)
        p = kda.prepare(*inputs, 12, "rel")
        hc = n == K2_SWEEP_ROWS[-1]  # the G step saves (h, c)
        base = kda.launch_fwd_warp(p, hc)
        warp_ms = cuda_time_ms(lambda: kda.launch_fwd_warp(p, hc), reps)
        pick = kda.fwd_launch(n, 4, sms)
        res = {"warp_ms": warp_ms, "save_hc": hc, "rule": pick, "shapes": {}}
        for r in kdec.TILED_ROWS:
            groups = -(-n // (kda.FWD_WARPS * r))
            for per_gen in sorted({max(1, min(groups, b)) for b in (8, 17, 33, 66, 132, 264)}):
                shape = (r, per_gen)
                got = kda.launch_fwd(p, hc, shape=shape)
                same = all(torch.equal(a, b) for a, b in zip(got, base) if a is not None)
                check(same, f"sweep: tiled K2 {shape} at {n} x 4 differs from the warp kernel")
                res["shapes"][f"{r}/{per_gen}"] = cuda_time_ms(
                    lambda: kda.launch_fwd(p, hc, shape=shape), reps)
        best = min(res["shapes"], key=res["shapes"].get)
        print(f"sweep K2 N={n} x 4 (hc {hc}): warp-per-row {warp_ms:.4f} ms; rule R/blocks "
              f"{pick[0]}/{pick[1]} {res['shapes'][f'{pick[0]}/{pick[1]}']:.4f} ms; best {best} "
              f"{res['shapes'][best]:.4f} ms")
        out["k2"][n] = res
        del inputs, p, base
    # K2-bf16: both launch variants, each as one wave of resident blocks
    # striding over the groups (a persistent grid) and as one block per 4
    # groups, each launch bit for bit against the rule's pick
    out["k2_bf16"] = {}
    for n, hc in K2_BF16_SWEEP:
        inputs = decode_all_case(n, 1, gen)
        p = kda.prepare(*inputs, 12, "rel", torch.bfloat16)
        base = kda.launch_fwd(p, hc)
        pick = kda.mma_launch(n, 4, sms)
        res = {"save_hc": hc, "rule": pick, "warp_ms": cuda_time_ms(
            lambda: kda.launch_fwd_warp(p, hc), reps), "shapes": {}}
        for v, per_sm in enumerate(kda.MMA_BLOCKS_PER_SM):
            most = -(-(-(-n // kda.MMA_GROUP)) // kda.MMA_WARPS)
            for per_gen in sorted({max(1, min(most, b)) for b in
                                   (-(-sms * per_sm // 4), most)}):
                shape = (v, per_gen)
                got = kda.launch_fwd(p, hc, shape=shape)
                same = all(torch.equal(a, b) for a, b in zip(got, base) if a is not None)
                check(same, f"sweep: K2-bf16 {shape} at {n} x 4 differs from the rule's launch")
                res["shapes"][f"{v}/{per_gen}"] = cuda_time_ms(
                    lambda: kda.launch_fwd(p, hc, shape=shape), reps)
        best = min(res["shapes"], key=res["shapes"].get)
        print(f"sweep K2-bf16 N={n} x 4 (hc {hc}): warp-per-row {res['warp_ms']:.4f} ms; rule "
              f"variant/blocks {pick[0]}/{pick[1]} {res['shapes'][f'{pick[0]}/{pick[1]}']:.4f} "
              f"ms; best {best} {res['shapes'][best]:.4f} ms")
        out["k2_bf16"][n] = res
        del inputs, p, base
    # K5 and K5-bf16: every launch variant and tile size, each bit for bit
    # against the tiled K1 (the tensor-core K1-bf16); K4 and K4-bf16: every
    # launch variant on the route's buffer, each bit for bit against the
    # route's variant
    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks

    out["k5"], out["k4"], out["k5_bf16"], out["k4_bf16"] = {}, {}, {}, {}
    for n in ABL_SWEEP_ROWS:
        inp = make_inputs(n, SEED)
        _, p32, p16 = dab.prepare(inp)
        k1 = kdec.launch_decode_select(p32)
        res = {"rule": kdec.tiled_ilp_launch(n, sms), "k1_ms": cuda_time_ms(
            lambda: kdec.launch_decode_select(p32), reps), "shapes": {}}
        for r in kdec.TILED_ILP_ROWS:
            for tile in kdec.TILED_ILP_TILES:
                shape = (r, tile, max(1, min(-(-n // tile), sms * kdec.TILED_BLOCKS_PER_SM)))
                got = kdec.launch_decode_select(p32, ilp=True, shape=shape)
                same = all(torch.equal(a, b) for a, b in zip(got, k1))
                check(same, f"sweep: K5 {shape} at {n} rows differs from the tiled K1")
                res["shapes"][f"{r}/{tile}"] = cuda_time_ms(
                    lambda: kdec.launch_decode_select(p32, ilp=True, shape=shape), reps)
        best = min(res["shapes"], key=res["shapes"].get)
        rule = "/".join(map(str, res["rule"][:2]))
        print(f"sweep K5 N={n}: the tiled K1 {res['k1_ms']:.4f} ms; rule R/tile {rule} "
              f"{res['shapes'][rule]:.4f} ms; best {best} {res['shapes'][best]:.4f} ms")
        out["k5"][n] = res
        pt = route_tiles(inp, None)[3]
        base = ks.launch_sorted_tiles(pt)
        res = {"rule": pt["variant"], "warps": {}}
        for v, w in enumerate(ks.TILED_WARPS):
            got = ks.launch_sorted_tiles(pt, variant=v)
            check(torch.equal(got, base), f"sweep: K4 variant {v} at {n} rows differs")
            res["warps"][w] = cuda_time_ms(lambda: ks.launch_sorted_tiles(pt, variant=v), reps)
        best = min(res["warps"], key=res["warps"].get)
        rule = ks.TILED_WARPS[pt["variant"]]
        print(f"sweep K4 N={n}: rule {rule} warps a block {res['warps'][rule]:.4f} ms; best "
              f"{best} {res['warps'][best]:.4f} ms")
        out["k4"][n] = res
        del p32, k1, got, pt, base
        k1 = kdec.launch_decode_select(p16)
        res = {"rule": kdec.mma_ilp_launch(n, sms), "k1_bf16_ms": cuda_time_ms(
            lambda: kdec.launch_decode_select(p16), reps), "shapes": {}}
        for v in range(len(kdec.MMA_ILP_BLOCKS_PER_SM)):
            for tile in kdec.MMA_ILP_TILES:
                got = kdec.launch_decode_select(p16, ilp=True, shape=(v, tile))
                same = all(torch.equal(a, b) for a, b in zip(got, k1))
                check(same, f"sweep: K5-bf16 {(v, tile)} at {n} rows differs from K1-bf16")
                res["shapes"][f"{v}/{tile}"] = cuda_time_ms(
                    lambda: kdec.launch_decode_select(p16, ilp=True, shape=(v, tile)), reps)
        best = min(res["shapes"], key=res["shapes"].get)
        rule = f"{res['rule'][0]}/{res['rule'][1]}"
        print(f"sweep K5-bf16 N={n}: K1-bf16 {res['k1_bf16_ms']:.4f} ms; rule variant/tile {rule} "
              f"{res['shapes'][rule]:.4f} ms; best {best} {res['shapes'][best]:.4f} ms")
        out["k5_bf16"][n] = res
        pt = route_tiles(inp, torch.bfloat16)[3]
        base = ks.launch_sorted_tiles(pt)
        res = {"rule": ks.MMA_VARIANT, "warps": {}}
        for v, w in enumerate(ks.MMA_WARPS):
            got = ks.launch_sorted_tiles(pt, variant=v)
            check(torch.equal(got, base), f"sweep: K4-bf16 variant {v} at {n} rows differs")
            res["warps"][w] = cuda_time_ms(lambda: ks.launch_sorted_tiles(pt, variant=v), reps)
        best = min(res["warps"], key=res["warps"].get)
        print(f"sweep K4-bf16 N={n}: rule {ks.MMA_WARPS[ks.MMA_VARIANT]} warps a block "
              f"{res['warps'][ks.MMA_WARPS[ks.MMA_VARIANT]]:.4f} ms; best {best} "
              f"{res['warps'][best]:.4f} ms")
        out["k4_bf16"][n] = res
        del inp, p16, k1, pt, base
    torch.cuda.empty_cache()
    print("SWEEP " + json.dumps(out))
    return out


def kernel_device_ms(fn, needle, reps=10):
    """Mean device time of one kernel whose name holds ``needle``, over
    ``reps`` calls of ``fn`` that launch one each (torch.profiler): the
    kernel alone, without the host's launch cost, which CUDA events around
    back-to-back calls include once it exceeds the kernel's own time. The
    mean is over the kernel records the profiler kept, which may be fewer
    than ``reps``. A session now and then comes back without the kernel's
    records; after PROFILE_TRIES such sessions the time is taken with CUDA
    events around single synchronised calls instead (the kernel plus the
    device's launch gap), and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and needle in ev.name]
        if us:
            return sum(us) / len(us) / 1e3
    print(f"the profiler kept no record of a kernel named *{needle}* in {PROFILE_TRIES} "
          "sessions; its time is from CUDA events around single calls")
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return sum(ms) / len(ms)


# phase 13's shapes of the tiled f32 K1 and K2: (label, scenes, samples)
# and (label, agents, samples, saving hc), those of the main paths
K1_TILED_SHAPES = (("serving small", 3, NUM), ("D step", TRAIN_SCENES, 1),
                   ("eval", EVAL_BATCH, EVAL_K), ("serving", BUCKETS[-1], NUM),
                   ("bench", BENCH_SCENES, NUM))
K2_TILED_SHAPES = (("pm", TRAIN_SCENES * PEDS, 1, False), ("eval", EVAL_BATCH * PEDS, EVAL_K, False),
                   ("g", TRAIN_SCENES * PEDS, NUM, True))


def redesigned_tiled(gen):
    """Phase 13, the f32 K1 and K2 with rows of one generator tiled per
    warp: at every main-path shape, bit for bit against the warp-per-row
    kernels they replaced (kept for this; no path launches them), max abs
    error against the plain version (KERNEL_ATOL), both timed in turns,
    with the launch the rule picked, registers and resident warps."""
    import torch

    from mggan_tpu_torch.ops.kernels import build
    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    on = lambda x: ({key: on(v) for key, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    err = lambda a_, b_: max(float((x - y).abs().max()) for x, y in zip(a_, b_))
    sel = {"shapes": {}}
    for label, scenes, k in K1_TILED_SHAPES:
        case = on(decode_select_case(scenes, gen, num=k))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"], case["h0"],
                case["idx"], 12, "rel")
        p = kdec.prepare_decode_select(*args)
        n = p["dims"][0]
        got, base = kdec.launch_decode_select(p), kdec.launch_decode_select_warp(p)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, base))
        want = kdec.decode_select_reference(*args)
        e_new, e_old = err(got, want), err(base, want)
        reps = 5 if n > 100_000 else 20
        old_ms, new_ms = alternate_ms(lambda: kdec.launch_decode_select_warp(p),
                                      lambda: kdec.launch_decode_select(p), reps)
        plain_ms = cuda_time_ms(lambda: kdec.decode_select_reference(*args), 2, warmup=1)
        dev_new = kernel_device_ms(lambda: kdec.launch_decode_select(p),
                                   "decode_select_tiled_kernel")
        dev_old = kernel_device_ms(lambda: kdec.launch_decode_select_warp(p),
                                   "decode_select_kernel")
        b = decode_select_bound_ms(p)
        launch = kdec.tiled_launch(n, sms)
        sel["shapes"][label] = {
            "n_rows": n, "bit_identical_to_warp_baseline": same, "max_abs_err": e_new,
            "warp_baseline_max_abs_err": e_old, "ms": new_ms, "warp_baseline_ms": old_ms,
            "device_ms": dev_new, "warp_baseline_device_ms": dev_old,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "rows_per_warp": launch[0], "tile_rows": launch[1], "blocks": launch[2]}
        print(f"K1 tiled [{label}] N={n} (R={launch[0]}, tiles of {launch[1]} rows, "
              f"{launch[2]} blocks): equal to the warp-per-row K1 bit for bit {same}; max_abs_err "
              f"{e_new:.3e} (atol {KERNEL_ATOL:g}; warp-per-row {e_old:.3e}); kernel "
              f"{new_ms:.4f} ms, warp-per-row {old_ms:.4f} ms (same call, in turns; device time "
              f"alone {dev_new:.4f} and {dev_old:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{b[0]:.4f} ms by {b[1]}")
        check(same, f"K1 tiled {label}: differs from the warp-per-row K1")
        check(e_new <= KERNEL_ATOL, f"K1 tiled {label}: max abs err {e_new:.3e}")
        if label == "eval":
            smem = nbytes_of(p["tensors"][0])
            sel["config"] = {
                "new": {f"R={r}": {"warps_per_sm": kdec.tiled_warps_per_sm(p, r),
                                   "registers": ptxas_registers(
                                       "decode_select_tiled",
                                       f"decode_select_tiled_kernelILi{r}ELi32ELi16E")}
                        for r in kdec.TILED_ROWS},
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_select", "mggan_decode_select_warps_per_sm", 0, smem),
                    "registers": ptxas_registers("decode_select", "decode_select_kernelIfE")}}
        del case, args, p, got, base, want
        torch.cuda.empty_cache()
    print(f"K1 tiled launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(sel['config'])}")

    every = {"shapes": {}}
    for label, m, k, save_hc in K2_TILED_SHAPES:
        inputs = decode_all_case(m, k, gen)
        p = kda.prepare(*inputs, 12, "rel")
        n = m * k
        got, base = kda.launch_fwd(p, True), kda.launch_fwd_warp(p, True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, base))
        want = kda.decode_all_reference(*inputs, 12, "rel", save_hc=True)
        e_new, e_old = err(got, want), err(base, want)
        reps = 5 if n > 50_000 else 20
        old_ms, new_ms = alternate_ms(lambda: kda.launch_fwd_warp(p, save_hc),
                                      lambda: kda.launch_fwd(p, save_hc), reps)
        plain_ms = cuda_time_ms(lambda: kda.decode_all_reference(
            *inputs, 12, "rel", save_hc=save_hc), 2, warmup=1)
        dev_new = kernel_device_ms(lambda: kda.launch_fwd(p, save_hc),
                                   "decode_all_fwd_tiled_kernel")
        dev_old = kernel_device_ms(lambda: kda.launch_fwd_warp(p, save_hc),
                                   "decode_all_fwd_kernel")
        b = decode_all_bound_ms(p, got if save_hc else got[:2])
        launch = kda.fwd_launch(n, 4, sms)
        every["shapes"][label] = {
            "n_rows": n, "save_hc": save_hc, "bit_identical_to_warp_baseline": same,
            "max_abs_err": e_new, "warp_baseline_max_abs_err": e_old, "ms": new_ms,
            "warp_baseline_ms": old_ms, "device_ms": dev_new, "warp_baseline_device_ms": dev_old,
            "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "rows_per_warp": launch[0], "blocks_per_gen": launch[1]}
        print(f"K2 tiled [{label}] N={n} x G=4{' saving hc' if save_hc else ''} (R={launch[0]}, "
              f"{launch[1]} blocks per generator): (abs, rel, hc) equal to the warp-per-row K2 "
              f"bit for bit {same}; max_abs_err {e_new:.3e} (atol {KERNEL_ATOL:g}; warp-per-row "
              f"{e_old:.3e}); kernel {new_ms:.4f} ms, warp-per-row {old_ms:.4f} ms (same call, "
              f"in turns; device time alone {dev_new:.4f} and {dev_old:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms by {b[1]}")
        check(same, f"K2 tiled {label}: differs from the warp-per-row K2")
        check(e_new <= KERNEL_ATOL, f"K2 tiled {label}: max abs err {e_new:.3e}")
        if label == "pm":
            every["config"] = {
                "new": {f"R={r}": {"warps_per_sm": kda.fwd_warps_per_sm(p, r),
                                   "registers": ptxas_registers(
                                       "decode_all", f"decode_all_fwd_tiled_kernelILi{r}ELi32ELi16E")}
                        for r in kdec.TILED_ROWS},
                "warp_baseline": {"warps_per_sm": kda.fwd_warps_per_sm(p),
                                  "registers": ptxas_registers("decode_all",
                                                               "decode_all_fwd_kernelIfE")}}
        del inputs, p, got, base, want
        torch.cuda.empty_cache()
    print(f"K2 tiled launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(every['config'])}")
    return {"decode_select": sel, "decode_all_fwd": every}


# phase 13's shapes of K2-bf16: (label, agents, samples, saving hc); and of
# B1: rows (the ablation kernels' checks, the ablation entry points')
K2_BF16_SHAPES = (("eval", EVAL_BATCH * PEDS, EVAL_K, False), ("pm", TRAIN_SCENES * PEDS, 1, True))
B1_ROWS = (ABL_ROWS, 1_310_720)


def redesigned_k2_bf16(gen):
    """Phase 13, K2-bf16 on the tensor cores: at eval's 9,728 x 4 rows and
    the PM step's 4,096 x 4 with hc, against its plain version (BF16_ATOL,
    BF16_MEAN_ATOL; with hc ``hc_checks``), equal to the tensor-core K1-bf16
    on the selected rows bit for bit, the kept warp-per-row K2-bf16 equal to
    the warp-per-row K1-bf16 there, the two designs within twice BF16_ATOL
    of each other; both timed in turns and by the profiler's device time,
    with the launch the rule picked, registers and resident warps."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    on = lambda x: ({key: on(v) for key, v in x.items()} if isinstance(x, dict)
                    else x.to("cuda"))
    err = lambda a_, b_: (max(float((x - y).abs().max()) for x, y in zip(a_, b_)),
                          max(float((x - y).abs().mean()) for x, y in zip(a_, b_)))
    res = {"shapes": {}}
    for label, m, k, save_hc in K2_BF16_SHAPES:
        case = on(decode_select_case(m // PEDS, gen, num=k))
        args = (case["stacked"], case["xy"], case["dxdy"], case["soc"], case["h0"],
                case["idx"], 12, "rel")
        p16 = kdec.prepare_decode_select(*args, compute_dtype=bf16)
        packed = kdec.pack_decoder_params(case["stacked"], "rel")
        inputs = [x.contiguous() for x in [packed[key] for key in kda.PACKED] + [
            kdec.social_bias(packed, case["soc"]), case["h0"], case["xy"], case["dxdy"]]]
        kp = kda.prepare(*inputs, 12, "rel", bf16)
        n = kp["dims"][0]
        got, kept = kda.launch_fwd(kp, save_hc), kda.launch_fwd_warp(kp, save_hc)
        k1, k1_warp = kdec.launch_decode_select(p16), kdec.launch_decode_select_bf16_warp(p16)
        torch.cuda.synchronize()
        rows, pick = torch.arange(n, device="cuda"), case["idx"].long()
        same = all(torch.equal(a, b[pick, rows]) for a, b in zip(k1, got))
        same_kept = all(torch.equal(a, b[pick, rows]) for a, b in zip(k1_warp, kept))
        want = kda.decode_all_reference(*inputs, 12, "rel", save_hc=save_hc, compute_dtype=bf16)
        (mx, mean), (mx_kept, _) = err(got[:2], want[:2]), err(kept[:2], want[:2])
        vs_kept = err(got[:2], kept[:2])[0]
        hc = (hc_checks(got, want), hc_checks(kept, want)) if save_hc else None
        reps = 20
        old_ms, new_ms = alternate_ms(lambda: kda.launch_fwd_warp(kp, save_hc),
                                      lambda: kda.launch_fwd(kp, save_hc), reps)
        plain_ms = cuda_time_ms(lambda: kda.decode_all_reference(
            *inputs, 12, "rel", save_hc=save_hc, compute_dtype=bf16), 2, warmup=1)
        dev_new = kernel_device_ms(lambda: kda.launch_fwd(kp, save_hc),
                                   "decode_all_fwd_mma_kernel")
        dev_old = kernel_device_ms(lambda: kda.launch_fwd_warp(kp, save_hc),
                                   "decode_all_fwd_kernel<__nv_bfloat16>")
        b16 = decode_all_bound_ms(kp, got if save_hc else got[:2], PEAK_BF16_FLOPS)
        b32 = decode_all_bound_ms(kp, got if save_hc else got[:2])
        variant, per_gen = kda.mma_launch(n, 4, sms)
        res["shapes"][label] = {
            "n_rows": n, "save_hc": save_hc, "equals_k1_bf16_on_selected_rows": same,
            "warp_baseline_equals_warp_k1_bf16": same_kept, "max_abs_err": mx,
            "mean_abs_err": mean, "warp_baseline_max_abs_err": mx_kept,
            "vs_warp_baseline_max_abs": vs_kept, "ms": new_ms, "warp_baseline_ms": old_ms,
            "device_ms": dev_new, "warp_baseline_device_ms": dev_old, "plain_ms": plain_ms,
            "bound_ms": b16[0], "bound_by": b16[1], "bound_ms_fp32_fma": b32[0],
            "variant": variant, "blocks_per_sm": kda.MMA_BLOCKS_PER_SM[variant],
            "blocks_per_gen": per_gen}
        if hc is not None:
            res["shapes"][label].update(hc=hc[0], warp_baseline_hc=hc[1])
        if label == "eval":
            res["config"] = {
                "new": {f"variant {v} ({per_sm} blocks an SM)": {
                    "warps_per_sm": kda.mma_warps_per_sm(v),
                    "registers": ptxas_registers("decode_all",
                                                 f"decode_all_fwd_mma_kernelILi{per_sm}E")}
                    for v, per_sm in enumerate(kda.MMA_BLOCKS_PER_SM)},
                "warp_baseline": {"warps_per_sm": kda.fwd_warps_per_sm(kp), "registers":
                                  ptxas_registers("decode_all",
                                                  "decode_all_fwd_kernelI13__nv_bfloat16E")}}
        print(f"K2-bf16 tensor cores [{label}] N={n} x G=4{' saving hc' if save_hc else ''} "
              f"(variant {variant}: {kda.MMA_BLOCKS_PER_SM[variant]} blocks an SM, "
              f"{per_gen} blocks per generator): equal to K1-bf16 on the selected rows bit for "
              f"bit {same}, the kept warp-per-row K2-bf16 to the warp-per-row K1-bf16 "
              f"{same_kept}; max_abs_err {mx:.3e} (atol {BF16_ATOL:g}), mean {mean:.3e} (limit "
              f"{BF16_MEAN_ATOL:g}; warp-per-row {mx_kept:.3e}, between the two {vs_kept:.3e})"
              + ("" if hc is None else f"; hc {json.dumps(hc[0])} (warp-per-row "
                 f"{json.dumps(hc[1])})")
              + f"; kernel {new_ms:.4f} ms, warp-per-row {old_ms:.4f} ms (same call, in turns; "
              f"device time alone {dev_new:.4f} and {dev_old:.4f} ms), plain {plain_ms:.3f} ms, "
              f"bound {b16[0]:.5f} ms by {b16[1]} (bf16 tensor cores; {b32[0]:.4f} ms at the "
              f"fp32-FMA peak)")
        check(all(bool(torch.isfinite(x).all()) for x in got[:2]), f"K2-bf16 {label}: non-finite")
        check(same, f"K2-bf16 {label}: differs from K1-bf16 on the selected rows")
        check(same_kept, f"the kept K2-bf16 {label}: differs from the warp-per-row K1-bf16")
        check(mx <= BF16_ATOL and mean <= BF16_MEAN_ATOL, f"K2-bf16 {label}: {mx:.3e}, {mean:.3e}")
        check(vs_kept <= 2 * BF16_ATOL, f"K2-bf16 {label}: {vs_kept:.3e} from the warp kernel")
        check(hc is None or hc[0]["ok"], f"K2-bf16 {label}: hc {hc and hc[0]}")
        del case, args, p16, packed, inputs, kp, got, kept, k1, k1_warp, want
        torch.cuda.empty_cache()
    print(f"K2-bf16 launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(res['config'])}")
    return res


def redesigned_b1(gen):
    """Phase 13, B1 on the tiled f32 rollout: at the ablation kernels'
    20,480 rows and the entry points' 1,310,720 (the benchmarks' inputs),
    each variant equal to its warp-per-row kernel bit for bit and B1-f32 to
    the tiled K1; each timed in turns with its warp-per-row kernel, the
    tiled K1 beside them, and by the profiler's device time, with registers
    and resident warps; the activations' share of K1 (1 - B1-lin / K1)."""
    import torch

    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ops.kernels import build
    from mggan_tpu_torch.ops.kernels import decode_ablation as kab
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = {"f32": "ActExact", "bf16": "ActBf16", "lin": "ActLin"}
    res = {"shapes": {}}
    for n in B1_ROWS:
        inp = make_inputs(n, SEED)
        args, p32, _ = dab.prepare(inp)
        reps = 5 if n > 100_000 else 20
        k1 = kdec.launch_decode_select(p32)
        k1_ms = cuda_time_ms(lambda: kdec.launch_decode_select(p32), reps)
        k1_dev = kernel_device_ms(lambda: kdec.launch_decode_select(p32),
                                  "decode_select_tiled_kernel")
        bound = decode_select_bound_ms(p32)
        rows, tile, blocks = kdec.tiled_launch(n, sms)
        shape = {"n_rows": n, "k1_ms": k1_ms, "k1_device_ms": k1_dev, "bound_ms": bound[0],
                 "bound_by": bound[1], "rows_per_warp": rows, "tile_rows": tile,
                 "blocks": blocks, "acts": {}}
        for act in kab.ACTS:
            got, kept = kab.launch_act(p32, act), kab.launch_act_warp(p32, act)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, kept))
            same_k1 = act != "f32" or all(torch.equal(a, b) for a, b in zip(got, k1))
            want = kab.decode_select_act_reference(*args[:7], act)
            e_new = max(float((a - b).abs().max()) for a, b in zip(got, want))
            old_ms, new_ms = alternate_ms(lambda: kab.launch_act_warp(p32, act),
                                          lambda: kab.launch_act(p32, act), reps)
            dev_new = kernel_device_ms(lambda: kab.launch_act(p32, act), names[act] + ">")
            dev_old = kernel_device_ms(lambda: kab.launch_act_warp(p32, act),
                                       "decode_select_act_kernel<")
            shape["acts"][act] = {
                "equals_warp_baseline": same, "equals_tiled_k1": same_k1, "max_abs_err": e_new,
                "warp_baseline_max_abs_err": e_new, "ms": new_ms,  # the same bits (checked)
                "warp_baseline_ms": old_ms, "device_ms": dev_new,
                "warp_baseline_device_ms": dev_old}
            print(f"B1-{act} tiled N={n} (R={rows}, tiles of {tile} rows, {blocks} blocks): equal "
                  f"to its warp-per-row kernel bit for bit {same}"
                  + (f", to the tiled K1 {same_k1}" if act == "f32" else "")
                  + f"; max_abs_err {e_new:.3e} against its plain version; kernel {new_ms:.4f} "
                  f"ms, warp-per-row {old_ms:.4f} ms (same call, in turns; device time alone "
                  f"{dev_new:.4f} and {dev_old:.4f} ms); the tiled K1 {k1_ms:.4f} ms (device "
                  f"{k1_dev:.4f}), bound {bound[0]:.4f} ms by {bound[1]}")
            check(same, f"B1-{act} tiled at {n} rows differs from its warp-per-row kernel")
            check(same_k1, f"B1-f32 tiled at {n} rows differs from the tiled K1")
            del got, kept, want
        acts = shape["acts"]
        shape["activation_share_of_k1"] = 1.0 - acts["lin"]["device_ms"] / k1_dev
        print(f"  activations' share of the tiled K1 at {n} rows (device times, 1 - B1-lin / "
              f"K1): {shape['activation_share_of_k1']:.4f}; B1-bf16 / K1 "
              f"{acts['bf16']['device_ms'] / k1_dev:.4f}")
        res["shapes"][n] = shape
        if n == B1_ROWS[-1]:
            smem = nbytes_of(p32["tensors"][0])
            res["config"] = {act: {
                "warps_per_sm": kab.tiled_warps_per_sm(p32, act, rows),
                "registers": ptxas_registers("decode_ablation",
                                             f"decode_select_tiled_kernelILi{rows}ELi32ELi16E",
                                             names[act]),
                "warp_baseline_warps_per_sm": build.warps_per_sm(
                    "decode_ablation", "mggan_decode_select_act_warps_per_sm",
                    kab.ACTS.index(act), smem),
                "warp_baseline_registers": ptxas_registers(
                    "decode_ablation", "decode_select_act_kernel", names[act])}
                for act in kab.ACTS}
        del inp, args, p32, k1
        torch.cuda.empty_cache()
    print(f"B1 tiled launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(res['config'])}")
    return res


# phase 13's rows of K5-bf16 and K4-bf16: the ablation kernels' checks and
# the entry points' (the benchmarks' inputs)
ABL_BF16_ROWS = (ABL_ROWS, 1_310_720)


def route_tiles(inp, compute_dtype):
    """K4's kernel arguments as the route builds them from the benchmarks'
    inputs ``inp`` (layout, row gather): ``(packed, rows, tile_gen,
    prepared)``."""
    from mggan_tpu_torch.ablations import sorted_select_ablation as sab
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    stacked, xy, dxdy, soc, h0, idx, t, fmt = sab.route_args(inp)
    packed = kdec.pack_decoder_params(stacked, fmt)
    _, inv, tile_gen, _ = ks.sorted_layout(idx, packed["w_hh"].shape[0])
    rows = ks.sorted_rows(h0, soc, xy, dxdy, inv)
    return packed, rows, tile_gen, ks.prepare_sorted_tiles(
        packed, rows, tile_gen, h0.shape[1], soc.shape[1], t, fmt, compute_dtype)


def redesigned_ablation_f32():
    """Phase 13, K5 and K4 on the tiled f32 rollout, at the ablation
    kernels' 20,480 rows and the entry points' 1,310,720 (the benchmarks'
    inputs). K5 equal to the tiled K1 and to the warp-per-row K1 bit for
    bit, the kept warp-per-pair K5 to the warp-per-row K1; timed in turns
    with the kept kernel, the tiled K1 beside it (K5's question: does the
    tiled K1 leave latency that a second group a warp hides?). K4 alone on
    the route's buffer equal to the kept warp-per-row kernel bit for bit and
    within KERNEL_ATOL of its plain tiles, its route equal to the kept route
    bit for bit; each timed in turns with the kept one. Device times from
    the profiler, the launch, registers and resident warps."""
    import torch

    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ablations import sorted_select_ablation as sab
    from mggan_tpu_torch.ops.kernels import build
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    same_bits = lambda a_, b_: all(torch.equal(x, y) for x, y in zip(a_, b_))
    max_err = lambda a_, b_: max(float((x - y).abs().max()) for x, y in zip(a_, b_))
    k5, k4 = {"shapes": {}}, {"shapes": {}}
    for n in ABL_BF16_ROWS:
        inp = make_inputs(n, SEED)
        args, p32, _ = dab.prepare(inp)
        reps = 5 if n > 100_000 else 20
        new = lambda: kdec.launch_decode_select(p32, ilp=True)
        kept = lambda: kdec.launch_decode_select_ilp_warp(p32)
        k1 = lambda: kdec.launch_decode_select(p32)
        got, got_kept = new(), kept()
        k1_out, k1_warp = k1(), kdec.launch_decode_select_warp(p32)
        torch.cuda.synchronize()
        same, same_warp = same_bits(got, k1_out), same_bits(got, k1_warp)
        same_kept = same_bits(got_kept, k1_warp)
        want = kdec.decode_select_reference(*args)
        mx, mx_kept = max_err(got, want), max_err(got_kept, want)
        old_ms, new_ms = alternate_ms(kept, new, reps)
        k1_ms = cuda_time_ms(k1, reps)
        dev_new = kernel_device_ms(new, "decode_select_ilp_tiled_kernel")
        dev_old = kernel_device_ms(kept, "decode_select_ilp_kernel<float>")
        dev_k1 = kernel_device_ms(k1, "decode_select_tiled_kernel")
        plain_ms = cuda_time_ms(lambda: kdec.decode_select_reference(*args), 2, warmup=1)
        bound = decode_select_bound_ms(p32)
        rows, tile, blocks = kdec.tiled_ilp_launch(n, sms)
        k5["shapes"][n] = {
            "n_rows": n, "equals_tiled_k1_bit_for_bit": same,
            "equals_warp_k1_bit_for_bit": same_warp,
            "warp_baseline_equals_warp_k1": same_kept, "max_abs_err": mx,
            "warp_baseline_max_abs_err": mx_kept, "ms": new_ms, "warp_baseline_ms": old_ms,
            "k1_ms": k1_ms, "device_ms": dev_new, "warp_baseline_device_ms": dev_old,
            "k1_device_ms": dev_k1, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "rows_per_warp": rows, "tile_rows": tile, "blocks": blocks}
        print(f"K5 tiled N={n} (two groups of {rows} rows a warp, tiles of {tile} rows, {blocks} "
              f"blocks): equal to the tiled K1 bit for bit {same}, to "
              f"the warp-per-row K1 {same_warp}, the kept warp-per-pair K5 to the warp-per-row "
              f"K1 {same_kept}; max_abs_err {mx:.3e} (atol {KERNEL_ATOL:g}; kept {mx_kept:.3e}); "
              f"kernel {new_ms:.4f} ms, kept {old_ms:.4f} ms (same call, in turns; device time "
              f"alone {dev_new:.4f} and {dev_old:.4f} ms), the tiled K1 {k1_ms:.4f} ms (device "
              f"{dev_k1:.4f}; K5 / K1 {dev_new / dev_k1:.3f}), plain {plain_ms:.3f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}")
        check(same and same_warp, f"K5 at {n} rows differs from K1")
        check(same_kept, f"the kept K5 at {n} rows differs from the warp-per-row K1")
        check(mx <= KERNEL_ATOL, f"K5 at {n} rows: {mx:.3e} from its plain version")
        if n == ABL_BF16_ROWS[-1]:
            k1_rows = kdec.tiled_launch(n, sms)[0]
            k5["config"] = {
                "new": {f"R={r}": {
                    "warps_per_sm": kdec.tiled_ilp_warps_per_sm(p32, r),
                    "registers": ptxas_registers(
                        "decode_select_tiled", f"decode_select_ilp_tiled_kernelILi{r}ELi32ELi16E")}
                    for r in kdec.TILED_ILP_ROWS},
                "k1": {"warps_per_sm": kdec.tiled_warps_per_sm(p32, k1_rows),
                       "registers": ptxas_registers(
                           "decode_select_tiled",
                           f"decode_select_tiled_kernelILi{k1_rows}ELi32ELi16E")},
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_select", "mggan_decode_select_warps_per_sm", 2,
                        nbytes_of(p32["tensors"][0])),
                    "registers": ptxas_registers("decode_select", "decode_select_ilp_kernel",
                                                 "IfE")}}
        del got, got_kept, k1_out, k1_warp, want

        packed, rows_buf, tile_gen, pt = route_tiles(inp, None)
        new = lambda: ks.launch_sorted_tiles(pt)
        kept = lambda: ks.launch_sorted_tiles_warp(pt)
        got, got_kept = new(), kept()
        route, route_kept = (ks.decode_select_sorted(*sab.route_args(inp)),
                             ks.decode_select_sorted_warp(*sab.route_args(inp)))
        torch.cuda.synchronize()
        same, same_route = torch.equal(got, got_kept), same_bits(route, route_kept)
        want = ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, rows_buf, 32, 32, 12, "rel")
        mx, mx_kept = max_err((got,), (want,)), max_err((got_kept,), (want,))
        route_plain = lambda: ks.decode_select_sorted_reference(*sab.route_args(inp))
        route_mx = max_err(route, route_plain())
        route_plain_ms = cuda_time_ms(route_plain, 2, warmup=1)
        route_bound = sorted_route_bound_ms(sab.route_args(inp))
        old_ms, new_ms = alternate_ms(kept, new, reps)
        route_old_ms, route_ms = alternate_ms(
            lambda: ks.decode_select_sorted_warp(*sab.route_args(inp)),
            lambda: ks.decode_select_sorted(*sab.route_args(inp)), reps)
        dev_new = kernel_device_ms(new, "decode_sorted_tiled_kernel")
        dev_old = kernel_device_ms(kept, "decode_sorted_kernel<float>")
        plain_ms = cuda_time_ms(lambda: ks.sorted_tiles_reference(
            tile_gen, ks.TILE, packed, rows_buf, 32, 32, 12, "rel"), 2, warmup=1)
        bound = sorted_tiles_bound_ms(pt)
        warps = ks.TILED_WARPS[pt["variant"]]
        k4["shapes"][n] = {
            "n_rows": n, "n_buf": pt["dims"][0], "equals_warp_kernel_bit_for_bit": same,
            "route_equals_warp_route_bit_for_bit": same_route, "max_abs_err": mx,
            "warp_baseline_max_abs_err": mx_kept, "ms": new_ms, "warp_baseline_ms": old_ms,
            "device_ms": dev_new, "warp_baseline_device_ms": dev_old, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "rows_per_warp": ks.TILED_GROUP,
            "warps_per_block": warps, "route": {
                "ms": route_ms, "warp_route_ms": route_old_ms, "max_abs_err": route_mx,
                "plain_ms": route_plain_ms, "bound_ms": route_bound[0],
                "bound_by": route_bound[1]}}
        print(f"K4 tiled alone on the route's buffer, N={n} ({pt['dims'][0]} buffer rows, "
              f"{ks.TILED_GROUP} rows a group, {warps} warps a block): equal to the kept warp-per-row K4 "
              f"bit for bit {same}, its route to the kept route {same_route}; max_abs_err "
              f"{mx:.3e} (atol {KERNEL_ATOL:g}; kept {mx_kept:.3e}); kernel {new_ms:.4f} ms, kept "
              f"{old_ms:.4f} ms (same call, in turns; device time alone {dev_new:.4f} and "
              f"{dev_old:.4f} ms), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]}; route {route_ms:.4f} ms, kept route {route_old_ms:.4f} ms (in turns), "
              f"max_abs_err {route_mx:.3e} against its plain version ({route_plain_ms:.3f} ms), "
              f"bound {route_bound[0]:.4f} ms by {route_bound[1]}")
        check(bool(torch.isfinite(got).all()), f"K4 at {n} rows: non-finite")
        check(same and same_route, f"K4 at {n} rows differs from the kept warp-per-row K4")
        check(mx <= KERNEL_ATOL and route_mx <= KERNEL_ATOL,
              f"K4 at {n} rows: {mx:.3e} from its plain tiles, the route {route_mx:.3e}")
        if n == ABL_BF16_ROWS[-1]:
            k4["config"] = {
                "new": {f"variant {v} ({w} warps a block)": {
                    "warps_per_sm": ks.tiled_warps_per_sm(pt, v),
                    "registers": ptxas_registers(
                        "decode_sorted_tiled", f"decode_sorted_tiled_kernelILi{w}ELi32ELi16E"),
                    "smem_bytes": ks.tiled_smem(pt, v)}
                    for v, w in enumerate(ks.TILED_WARPS)},
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_sorted", "mggan_decode_sorted_warps_per_sm", 0,
                        pt["warp_smem_bytes"]),
                    "registers": ptxas_registers("decode_sorted", "decode_sorted_kernel", "IfE"),
                    "smem_bytes": pt["warp_smem_bytes"]}}
        del inp, args, p32, packed, rows_buf, tile_gen, pt, got, got_kept, want, route, route_kept
        torch.cuda.empty_cache()
    print(f"K5 launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(k5['config'])}")
    print(f"K4 launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(k4['config'])}")
    return {"decode_select_ilp": k5, "sorted_tiles": k4}


def redesigned_ablation_bf16():
    """Phase 13, K5-bf16 and K4-bf16 on the tensor-core rollout, at the
    ablation kernels' 20,480 rows and the entry points' 1,310,720 (the
    benchmarks' inputs). K5-bf16 equal to the tensor-core K1-bf16 bit for
    bit and the kept warp-per-row K5-bf16 to the warp-per-row K1-bf16; K4-bf16
    alone on the route's buffer against its plain version (BF16_ATOL,
    BF16_MEAN_ATOL), the kept warp-per-row K4-bf16 too, the two within twice
    BF16_ATOL of each other. Each timed in turns with the kept kernel and by
    the profiler's device time, K1-bf16 beside K5-bf16, with the launch,
    registers and resident warps."""
    import torch

    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ops.kernels import build
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = lambda a_, b_: (max(float((x - y).abs().max()) for x, y in zip(a_, b_)),
                          max(float((x - y).abs().mean()) for x, y in zip(a_, b_)))
    k5, k4 = {"shapes": {}}, {"shapes": {}}
    for n in ABL_BF16_ROWS:
        inp = make_inputs(n, SEED)
        args, _, p16 = dab.prepare(inp)
        reps = 5 if n > 100_000 else 20
        new = lambda: kdec.launch_decode_select(p16, ilp=True)
        kept = lambda: kdec.launch_decode_select_ilp_bf16_warp(p16)
        got, k1, got_kept, k1_warp = new(), kdec.launch_decode_select(p16), kept(), \
            kdec.launch_decode_select_bf16_warp(p16)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, k1))
        same_kept = all(torch.equal(a, b) for a, b in zip(got_kept, k1_warp))
        want = kdec.decode_select_reference(*args, compute_dtype=bf16)
        (mx, mean), (mx_kept, _) = err(got, want), err(got_kept, want)
        old_ms, new_ms = alternate_ms(kept, new, reps)
        k1_ms = cuda_time_ms(lambda: kdec.launch_decode_select(p16), reps)
        dev_new = kernel_device_ms(new, "decode_select_mma_ilp_kernel")
        dev_old = kernel_device_ms(kept, "decode_select_ilp_kernel<__nv_bfloat16>")
        dev_k1 = kernel_device_ms(lambda: kdec.launch_decode_select(p16),
                                  "decode_select_mma_kernel")
        plain_ms = cuda_time_ms(lambda: kdec.decode_select_reference(
            *args, compute_dtype=bf16), 2, warmup=1)
        b16, b32 = decode_select_bound_ms(p16, PEAK_BF16_FLOPS), decode_select_bound_ms(p16)
        variant, tile = kdec.mma_ilp_launch(n, sms)
        per_sm = kdec.MMA_ILP_BLOCKS_PER_SM[variant]
        k5["shapes"][n] = {
            "n_rows": n, "equals_k1_bf16_bit_for_bit": same,
            "warp_baseline_equals_warp_k1_bf16": same_kept, "max_abs_err": mx,
            "mean_abs_err": mean, "warp_baseline_max_abs_err": mx_kept, "ms": new_ms,
            "warp_baseline_ms": old_ms, "k1_bf16_ms": k1_ms, "device_ms": dev_new,
            "warp_baseline_device_ms": dev_old, "k1_bf16_device_ms": dev_k1,
            "plain_ms": plain_ms, "bound_ms": b16[0], "bound_by": b16[1],
            "bound_ms_fp32_fma": b32[0], "variant": variant,
            "blocks_per_sm": per_sm, "tile_rows": tile}
        print(f"K5-bf16 tensor cores N={n} (variant {variant}: {per_sm} blocks an SM, tiles of "
              f"{tile} rows): equal "
              f"to the tensor-core K1-bf16 bit for bit {same}, the kept warp-per-row K5-bf16 to "
              f"the warp-per-row K1-bf16 {same_kept}; max_abs_err {mx:.3e} (atol {BF16_ATOL:g}), "
              f"mean {mean:.3e} (limit {BF16_MEAN_ATOL:g}; warp-per-row {mx_kept:.3e}); kernel "
              f"{new_ms:.4f} ms, warp-per-row {old_ms:.4f} ms (same call, in turns; device time "
              f"alone {dev_new:.4f} and {dev_old:.4f} ms), K1-bf16 {k1_ms:.4f} ms (device "
              f"{dev_k1:.4f}), plain {plain_ms:.3f} ms, bound {b16[0]:.5f} ms by {b16[1]} (bf16 "
              f"tensor cores; {b32[0]:.4f} ms at the fp32-FMA peak)")
        check(same, f"K5-bf16 at {n} rows differs from the tensor-core K1-bf16")
        check(same_kept, f"the kept K5-bf16 at {n} rows differs from the warp-per-row K1-bf16")
        check(mx <= BF16_ATOL and mean <= BF16_MEAN_ATOL, f"K5-bf16 at {n} rows: {mx}, {mean}")
        if n == ABL_BF16_ROWS[-1]:
            smem = nbytes_of(p16["tensors"][0])
            k5["config"] = {
                "new": {f"variant {v} ({per_sm} blocks an SM)": {
                    "warps_per_sm": kdec.mma_ilp_warps_per_sm(4, v),
                    "registers": ptxas_registers("decode_select_mma",
                                                 f"decode_select_mma_ilp_kernelILi{per_sm}E")}
                    for v, per_sm in enumerate(kdec.MMA_ILP_BLOCKS_PER_SM)},
                "k1_bf16": {"warps_per_sm": kdec.mma_warps_per_sm(4), "registers":
                            ptxas_registers("decode_select_mma", "decode_select_mma_kernel")},
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_select", "mggan_decode_select_warps_per_sm", 3, smem),
                    "registers": ptxas_registers("decode_select", "decode_select_ilp_kernel",
                                                 "bfloat16")}}
        del got, k1, got_kept, k1_warp, want

        packed, rows, tile_gen, pt = route_tiles(inp, bf16)
        new = lambda: ks.launch_sorted_tiles(pt)
        kept = lambda: ks.launch_sorted_tiles_bf16_warp(pt)
        got, got_kept = new(), kept()
        torch.cuda.synchronize()
        want = ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, rows, 32, 32, 12, "rel", bf16)
        (mx, mean), (mx_kept, mean_kept) = err((got,), (want,)), err((got_kept,), (want,))
        vs_kept = err((got,), (got_kept,))[0]
        old_ms, new_ms = alternate_ms(kept, new, reps)
        dev_new = kernel_device_ms(new, "decode_sorted_mma_kernel")
        dev_old = kernel_device_ms(kept, "decode_sorted_kernel<__nv_bfloat16>")
        plain_ms = cuda_time_ms(lambda: ks.sorted_tiles_reference(
            tile_gen, ks.TILE, packed, rows, 32, 32, 12, "rel", bf16), 2, warmup=1)
        b16, b32 = sorted_tiles_bound_ms(pt, PEAK_BF16_FLOPS), sorted_tiles_bound_ms(pt)
        k4["shapes"][n] = {
            "n_rows": n, "n_buf": pt["dims"][0], "max_abs_err": mx, "mean_abs_err": mean,
            "warp_baseline_max_abs_err": mx_kept, "warp_baseline_mean_abs_err": mean_kept,
            "vs_warp_baseline_max_abs": vs_kept, "ms": new_ms, "warp_baseline_ms": old_ms,
            "device_ms": dev_new, "warp_baseline_device_ms": dev_old, "plain_ms": plain_ms,
            "bound_ms": b16[0], "bound_by": b16[1], "bound_ms_fp32_fma": b32[0],
            "warps_per_block": ks.MMA_WARPS[ks.MMA_VARIANT]}
        print(f"K4-bf16 tensor cores alone on the route's buffer, N={n} ({pt['dims'][0]} buffer "
              f"rows, {ks.MMA_WARPS[ks.MMA_VARIANT]} warps a block): max_abs_err {mx:.3e} (atol "
              f"{BF16_ATOL:g}), mean {mean:.3e} (limit {BF16_MEAN_ATOL:g}); the kept warp-per-row "
              f"K4-bf16 {mx_kept:.3e} (mean {mean_kept:.3e}), between the two {vs_kept:.3e}; "
              f"kernel {new_ms:.4f} ms, warp-per-row {old_ms:.4f} ms (same call, in turns; device "
              f"time alone {dev_new:.4f} and {dev_old:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{b16[0]:.5f} ms by {b16[1]} (bf16 tensor cores; {b32[0]:.4f} ms at the fp32-FMA "
              f"peak)")
        check(bool(torch.isfinite(got).all()), f"K4-bf16 at {n} rows: non-finite")
        check(mx <= BF16_ATOL and mean <= BF16_MEAN_ATOL, f"K4-bf16 at {n} rows: {mx}, {mean}")
        check(mx_kept <= BF16_ATOL, f"the kept K4-bf16 at {n} rows: {mx_kept}")
        check(vs_kept <= 2 * BF16_ATOL, f"K4-bf16 at {n} rows: {vs_kept:.3e} from the kept kernel")
        if n == ABL_BF16_ROWS[-1]:
            k4["config"] = {
                "new": {f"variant {v} ({w} warps a block)": {
                    "warps_per_sm": ks.mma_warps_per_sm(pt, v),
                    "registers": ptxas_registers("decode_sorted_mma",
                                                 f"decode_sorted_mma_kernelILi{w}E")}
                    for v, w in enumerate(ks.MMA_WARPS)},
                "smem_bytes": pt["mma_smem_bytes"],
                "warp_baseline": {
                    "warps_per_sm": build.warps_per_sm(
                        "decode_sorted", "mggan_decode_sorted_warps_per_sm", 1,
                        pt["warp_smem_bytes"]),
                    "registers": ptxas_registers("decode_sorted", "decode_sorted_kernel",
                                                 "bfloat16"),
                    "smem_bytes": pt["warp_smem_bytes"]}}
        del inp, args, p16, packed, rows, tile_gen, pt, got, got_kept, want
        torch.cuda.empty_cache()
    print(f"K5-bf16 launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(k5['config'])}")
    print(f"K4-bf16 launch shapes (registers per thread, spills from nvcc): "
          f"{json.dumps(k4['config'])}")
    return {"decode_select_ilp_bf16": k5, "decode_sorted_bf16": k4}


def ablation_entries(checks, bwd16, path, by_path, redesigned):
    """The kernels line's entries of the ablation path's kernels; B1's, K5's
    and K4's (route and alone; redesigned on the tiled rollout), K5-bf16's
    and K4-bf16's (on the tensor-core rollout) carry phase 13's readings
    ``redesigned`` and their kept warp-per-row kernels' entries."""
    b1 = redesigned["decode_select_act"]
    dec_ms, sort_ms, warps = path["decodeabl_ms"], path["sortedparts_ms"], path["warps_per_sm"]
    bounds = path["bounds_1310720"]
    no_library = ("no single PyTorch call runs a rollout that feeds back its own output")
    table = (
        # name, source, replaces, DECODEABL/SORTEDPARTS key, bounds key
        ("decode_select_ilp", "decode_select_tiled.cu", "mggan_tpu/ops/pallas/decoder.py:199",
         ("decodeabl", "kernel_ilp"), "kernel_select"),
        ("decode_select_ilp_bf16", "decode_select_mma.cu",
         "mggan_tpu/ops/pallas/decoder.py:199 (compute_dtype=bfloat16)",
         ("decodeabl", "kernel_ilp_bf16"), "kernel_select_bf16"),
        ("decode_select_act_f32", "decode_ablation.cu", "benchmarks/decode_ablation.py:39 (f32)",
         ("decodeabl", "kernel_f32"), "kernel_select"),
        ("decode_select_act_bf16", "decode_ablation.cu",
         "benchmarks/decode_ablation.py:39 (bf16)", ("decodeabl", "kernel_bf16"),
         "kernel_select"),
        ("decode_select_act_lin", "decode_ablation.cu", "benchmarks/decode_ablation.py:39 (lin)",
         ("decodeabl", "kernel_lin"), "kernel_select"),
        ("decode_sorted", "decode_sorted_tiled.cu", "mggan_tpu/ops/pallas/decoder.py:353",
         ("sortedparts", "route"), "route"),
        ("decode_sorted_bf16", "decode_sorted_mma.cu",
         "mggan_tpu/ops/pallas/decoder.py:353 (compute_dtype=bfloat16)",
         ("sortedparts", "route_bf16"), "route_bf16"),
        ("sorted_tiles", "decode_sorted_tiled.cu", "benchmarks/sorted_select_ablation.py:77",
         ("sortedparts", "kernel_only"), "kernel_only"),
    )
    warps_key = {"route": "sorted_kernel_only", "route_bf16": "sorted_route_bf16",
                 "kernel_only": "sorted_kernel_only"}
    entries = []
    for name, source, replaces, (line, key), bkey in table:
        r = checks["kernels"][name]
        ms_1m = (dec_ms if line == "decodeabl" else sort_ms)[key]
        entries.append({
            "name": name, "status": "ported (ablation path)", "route": "cuda",
            "source": f"mggan_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": sum(by_path(name).values()), "launches_by_path": by_path(name),
            **{k: v for k, v in r.items()},
            "library_ms": None, "library_note": no_library,
            "bench_shape": {"n_rows": path["rows"], "ms": ms_1m, **bounds[bkey],
                            "warps_per_sm": warps[warps_key.get(key, key)],
                            **path["against_plain"].get(key, {})},
        })
        if name.startswith("decode_select_act_"):
            act = name.rsplit("_", 1)[1]
            shapes = {n: {"n_rows": n, "plain_ms": r["plain_ms"] if n == ABL_ROWS else None,
                          "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                          **v["acts"][act]} for n, v in b1["shapes"].items()}
            entries[-1].update(
                redesign={"shapes": shapes, "config": b1["config"][act]},
                baseline=baseline_entry(f"{name}_warp", source, replaces, shapes, ABL_ROWS,
                                        by_path))
        if name in ("decode_select_ilp", "decode_select_ilp_bf16", "decode_sorted_bf16"):
            old_source = "decode_sorted.cu" if name == "decode_sorted_bf16" \
                else "decode_select.cu"
            entries[-1].update(redesign=redesigned[name], baseline=baseline_entry(
                f"{name}_warp", old_source, replaces, redesigned[name]["shapes"], ABL_ROWS,
                by_path))
        if name == "sorted_tiles":
            entries[-1].update(redesign=redesigned[name], baseline=baseline_entry(
                "decode_sorted_warp", "decode_sorted.cu", replaces, redesigned[name]["shapes"],
                ABL_ROWS, by_path))
        if name == "decode_sorted":  # the route on the tiled kernel and on the kept one
            shapes = {n: {"n_rows": n, "ms": v["route"]["ms"],
                          "warp_baseline_ms": v["route"]["warp_route_ms"],
                          # the same bits (checked)
                          "warp_baseline_max_abs_err": v["route"]["max_abs_err"],
                          **{k: v["route"][k] for k in ("max_abs_err", "plain_ms", "bound_ms",
                                                        "bound_by")},
                          "equals_warp_route_bit_for_bit":
                              v["route_equals_warp_route_bit_for_bit"]}
                      for n, v in redesigned["sorted_tiles"]["shapes"].items()}
            entries[-1].update(redesign={"shapes": shapes}, baseline=baseline_entry(
                "decode_sorted_warp", "decode_sorted.cu", replaces, shapes, ABL_ROWS, by_path))
    entries.append({
        "name": "decode_all_bwd_after_bf16", "status": "ported (ablation path)",
        "route": "cuda", "source": "mggan_tpu_torch/csrc/decode_all.cu",
        "replaces": "mggan_tpu/ops/pallas/decoder.py:696 (via _vjp_bwd :968 after _vjp_fwd "
                    ":955 with compute_dtype=bfloat16)",
        "launches": sum(by_path("decode_all_bwd_after_bf16").values()),
        "launches_by_path": by_path("decode_all_bwd_after_bf16"),
        **bwd16, "rtol": GRAD_RTOL, "atol": GRAD_ATOL, "weight_grad_rel": WGRAD_REL,
        "library_ms": None, "library_note": no_library,
    })
    return entries


def baseline_entry(name, source, replaces, shapes, main, by_path):
    """A kept warp-per-row kernel as a kernels-line entry: phase 13's
    readings of it beside its successor (``shapes``), its times at the
    ``main`` shape's row count, launches on the paths (none). ``replaces``:
    a line of ``mggan_tpu/ops/pallas/decoder.py`` or the TPU kernel's
    file:line."""
    r = shapes[main]
    if isinstance(replaces, int):
        replaces = f"mggan_tpu/ops/pallas/decoder.py:{replaces}"
    return {
        "name": name, "status": "replaced design, kept as the yardstick (no path launches it)",
        "route": "cuda", "source": f"mggan_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": sum(by_path(name).values()),
        "max_abs_err": max(v["warp_baseline_max_abs_err"] for v in shapes.values()),
        "ms": r["warp_baseline_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "n_rows": r["n_rows"],
        "shapes": {label: {"n_rows": v["n_rows"], "ms": v["warp_baseline_ms"],
                           "max_abs_err": v["warp_baseline_max_abs_err"]}
                   for label, v in shapes.items()},
    }


def kernel_entries(kern, fwd, bwd, sel16, all16, paths, redesigned):
    """The kernels line: one entry per ported kernel with its launches on
    each main path (``paths``: path -> launch counts) and the numbers
    measured in this run; the redesigned kernels (K3, K1-bf16, K1, K2) also
    carry phase 13's readings, their baselines' times among them, and K1's
    and K2's (and K2-bf16's) the kept warp-per-row kernels' entries
    (``baseline``: on no path, so 0 launches)."""
    by_path = lambda name: {path: c[name] for path, c in paths.items() if c.get(name)}
    serving, bench = kern["serving"], kern["bench"]
    shapes = lambda res: {label: {k: v for k, v in r.items() if k not in ("flops", "bytes")}
                          for label, r in res.items()}
    no_library = ("no single PyTorch call runs a rollout that feeds back its own output")
    entries = [{
        "name": "decode_select",
        "status": "ported (f32)",
        "route": "cuda",
        "source": "mggan_tpu_torch/csrc/decode_select_tiled.cu",
        "replaces": "mggan_tpu/ops/pallas/decoder.py:140",
        "launches": sum(by_path("decode_select").values()),
        "launches_by_path": by_path("decode_select"),
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
        "library_note": no_library,
        "n_rows": serving["n_rows"],
        "atol": KERNEL_ATOL,
        "bench_shape": {k: bench[k] for k in ("n_rows", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "smi_under_load")},
        "redesign": redesigned["decode_select"],
        "baseline": baseline_entry("decode_select_warp", "decode_select.cu", 140,
                                   redesigned["decode_select"]["shapes"], "serving", by_path),
    }]
    for name, res, line, atol in (
            ("decode_all_fwd", fwd, 573, {"atol": KERNEL_ATOL}),
            ("decode_all_bwd", bwd, 696, {"rtol": GRAD_RTOL, "atol": GRAD_ATOL,
                                          "weight_grad_rel": WGRAD_REL})):
        g = res["g"]
        entries.append({
            "name": name,
            "status": "ported (f32)",
            "route": "cuda",
            "source": "mggan_tpu_torch/csrc/decode_all.cu",
            "replaces": f"mggan_tpu/ops/pallas/decoder.py:{line}",
            "launches": sum(by_path(name).values()),
            "launches_by_path": by_path(name),
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "ms": g.get("ms_save_hc", g["ms"]),
            "plain_ms": g["plain_ms"],
            "bound_ms": g.get("bound_ms_save_hc", g["bound_ms"]),
            "bound_by": g.get("bound_by_save_hc", g["bound_by"]),
            "library_ms": None,
            "library_note": no_library,
            "n_rows": g["n_rows"],
            **atol,
            "shapes": shapes(res),
        })
        if name == "decode_all_bwd":
            entries[-1]["redesign"] = redesigned[name]
        else:
            entries[-1].update(redesign=redesigned[name], baseline=baseline_entry(
                "decode_all_fwd_warp", "decode_all.cu", 573, redesigned[name]["shapes"], "g",
                by_path))
    for name, res, source, line in (
            ("decode_select_bf16", sel16, "decode_select.cu", 140),
            ("decode_all_fwd_bf16", all16, "decode_all.cu", 573)):
        main = res["eval"]
        entries.append({
            "name": name,
            "status": "ported (bf16 compute_dtype)",
            "route": "cuda",
            "source": f"mggan_tpu_torch/csrc/{source}",
            "replaces": f"mggan_tpu/ops/pallas/decoder.py:{line} (compute_dtype=bfloat16)",
            "launches": sum(by_path(name).values()),
            "launches_by_path": by_path(name),
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "bound_note": "bound_ms at the bf16 tensor-core peak (bf16 operands); "
                          "bound_ms_fp32_fma at the fp32 CUDA-core peak (the kernel's FMAs)",
            "bound_ms_fp32_fma": main["bound_ms_fp32_fma"],
            "library_ms": None,
            "library_note": no_library,
            "n_rows": main["n_rows"],
            "atol": BF16_ATOL,
            "shapes": shapes(res),
        })
        if name == "decode_select_bf16":
            entries[-1].update(source="mggan_tpu_torch/csrc/decode_select_mma.cu",
                               mean_atol=BF16_MEAN_ATOL, redesign=redesigned[name])
        else:
            entries[-1].update(mean_atol=BF16_MEAN_ATOL, redesign=redesigned[name],
                               baseline=baseline_entry(
                                   "decode_all_fwd_bf16_warp", "decode_all.cu",
                                   "573 (compute_dtype=bfloat16)",
                                   redesigned[name]["shapes"], "eval", by_path))
    return entries


def main():
    if not (HERE / "mggan_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the mggan_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    t_start = time.perf_counter()
    phase_card()
    build_s = phase_build()
    if sys.argv[1:] == ["--sweep"]:
        phase_launch_sweep()
        return 0
    kern = phase_kernels()
    fwd, bwd = phase_decode_all_kernels()
    serving_launches, latency, e2e_err, model, (obs, pat) = phase_main_path()
    train, train_handles = phase_train()
    train_vs_cpu = phase_train_card_vs_cpu()
    profile_serving, profile_train = phase_profile(model, obs, pat, train_handles)
    del model, train_handles
    sel16, all16 = phase_bf16_kernels()
    evaluation = phase_eval()
    bench = phase_bench_sampling()
    abl_checks = phase_ablation_kernels()
    bwd16 = phase_bf16_backward()
    abl_path = phase_ablation_path()
    redesigned = phase_redesigned()
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "mggan_tpu."))
              or m == "mggan_tpu"]
    if loaded:
        print(f"chip_smoke: JAX modules were loaded: {loaded[:5]}", file=sys.stderr)
        return 1

    paths = {"serving": serving_launches, "train": train["launches"],
             **{f"eval_{mode}": r["launches"] for mode, r in evaluation["runs"].items()},
             **{f"bench_sampling_{mode}": r["launches"] for mode, r in bench.items()},
             "ablation": abl_path["launches"]}
    by_path = lambda name: {path: c[name] for path, c in paths.items() if c.get(name)}
    entries = kernel_entries(kern, fwd, bwd, sel16, all16, paths, redesigned)
    entries += ablation_entries(abl_checks, bwd16, abl_path, by_path, redesigned)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was launched on no main path")
    for name in ("decode_select_warp", "decode_all_fwd_warp", "decode_select_bf16_warp",
                 "decode_all_bwd_warp", "decode_all_fwd_bf16_warp", "decode_select_act_f32_warp",
                 "decode_select_act_bf16_warp", "decode_select_act_lin_warp",
                 "decode_select_ilp_bf16_warp", "decode_sorted_bf16_warp",
                 "decode_select_ilp_warp", "decode_sorted_warp"):
        # the kept yardsticks stay off every path
        check(not by_path(name), f"{name} was launched on a path: {by_path(name)}")
    print(json.dumps({
        "build_s": build_s,
        "serving_p50_ms": {str(b): v["p50_ms"] for b, v in latency.items()},
        "card_vs_cpu_max_abs_err": e2e_err,
        "train_step_p50_ms": train["p50_ms"],
        "train_step_times_ms": train["times_ms"],
        "train_peak_gib": train["peak_gib"],
        "train_card_vs_cpu": train_vs_cpu,
        "profile_64_scenes": {k: v for k, v in profile_serving.items() if k != "by_name_ms"},
        "profile_train_step": {k: v for k, v in profile_train.items() if k != "by_name_ms"},
        "eval": evaluation,
        "bench_sampling": bench,
        "ablation": {"sorted_route_cases": abl_checks["sorted_route_cases"],
                     "path": {k: v for k, v in abl_path.items() if k != "launches"}},
        "redesigned": redesigned,
        "total_s": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
