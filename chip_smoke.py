#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mggan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits nonzero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions, so float32 means float32 on both sides of a comparison;
  2. build every kernel from ``mggan_tpu_torch/csrc`` (nvcc, in parallel)
     and the native host ops (g++);
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
 14. train loop: (a) the flagship ``Trainer`` on ``synthetic_memory`` (48
     train and 16 val windows of up to 6 peds, batch 8, 3 epochs, train-time
     augmentation, the device patch bank, validation and a checkpoint every
     epoch), with its launch counts read around it and every epoch's
     metrics, ``checkpoint_best`` and ``best_val`` checked; then
     ``train(until_epoch=1)`` + ``load_from_path`` + ``train()`` against
     the uninterrupted run (parameters within the train step's card-vs-CPU
     tolerance: cuDNN's and the index ops' backward are not deterministic
     on the card); (b) the feed at bench.py's train batch (256 scenes x 16
     peds from 1,024 synthetic windows): the bank's gather against host
     assembly bit for bit, ``augment_batch(train=True)`` on the card against
     the CPU with the same draws (nearest-pixel ties counted), host
     assembly + copy, the gather and the augmentation timed per batch, and
     12 epochs each of the Trainer's loop through ``Prefetcher`` with and
     without the bank, alternated, their median epoch's rate beside the
     bare step's p50 (the spread and the total beside it), with the loop's
     idle share;
 15. real data, CLI pair: (a) which of cv2, pandas and PIL import, the
     native host ops' build time and ``image_io.decoder()``; ``read_rgb``
     and nvJPEG against the committed cv2 decode of the fixture JPEG
     (``mggan_tpu_torch/tools/fixtures``), ``resize_area`` against this
     machine's cv2 where it imports; (b) fixtures in the reference release
     layout in a temporary directory: ``zara1`` (BIWI, 850 / 90 / 90
     frames, 8-15 peds at a time), ``stanford`` (SDD, H_SDD.txt, Biker and
     lost rows, 30 fps) and ``gofp`` (is_active = 0 rows, 10 fps); (c)
     every split parsed with pandas unimportable, with windows, peds and
     parse time, the native host ops equal to their numpy versions on these
     files; (d) ``cli.train`` with ``mggan4_zara1``'s flags (the flagship,
     batch 32) for 2 epochs with augmentation and the patch bank, then
     ``cli.evaluate`` (three strategies, k=1..19, Precision/Recall) on the
     test split, every CSV metric finite, launch counts read around the
     pair (path ``realdata_cli``); (e) the version dir loaded on the card
     and on the CPU, ``sampling`` and ``expected`` on 64 test windows with
     the same draws (atol 1e-4);
 16. train-step families (``training/steps.py``): (a) at the flagship
     widths (h = decoder_h = 32, the scene CNN, 4 generators; gan at 1) on
     the 256 x 16 train batch, K=20, one warm-up and five timed steps each
     of the flagship (the yardstick of the others' times), the four golden
     families (gan / l2, infogan / none, mgan / ml / W, probgan / ml) and
     the CPU tests' cases A-E (MM / endpoint / min_z /
     abs / no global D; LS / mgan compat 0 / mse / sgan; infogan / W /
     min_g_min_z; 2 unrolled D updates gated every 2 steps; the discrete
     generator with the prior; one unconditional generator, gan, no PM, no
     L2), with K1, K2 and K3 launches per step checked and the launch
     counts read around all of them (path ``families``); then each family's
     step at 4 scenes with injected draws on the card and on the CPU
     (metrics and parameters within 1e-4; an element whose gradient is
     float noise, as the conv biases' before train-mode BN, within 2 * lr
     per update, its gradient within 1e-4 of its module's rms:
     ``tools/state_compare.py``); (b) ``cli.train`` with
     ``single_gen_eth``'s flags for 2 epochs on a BIWI ``eth`` split written
     as phase 15's splits are, then ``cli.evaluate`` with Precision/Recall, every CSV
     metric finite (path ``single_gen_cli``);
 17. deployment, on phase 15's ``mggan4_zara1`` version dir, launch counts
     read around (a)-(d) (path ``deployment``: K1 and K2, no kept
     yardstick): (a) ``cli.convert --reverse`` to a reference-format dir and
     ``cli.convert --pth`` back into a port version dir, its parameters and
     BN statistics equal to the original's bit for bit; (b) ``cli.export``
     of ``sampling`` and ``expected`` at ``--scenes 1,8,64 --peds 16 --num
     20`` as ``torch.export`` programs, one per bucket: each program's
     graph holds one ``mggan.decode_select`` (K1) or
     ``mggan.decode_all_fwd`` (K2) node and each call of the loaded
     artifact launches that kernel once, ``from_artifact`` equal to
     ``from_version_dir`` bit for bit at each bucket, one 8-scene request
     with injected draws on the artifact loaded on the card and moved to
     the CPU (atol 1e-4), export seconds per bucket, MB, and the artifact
     call's p50 beside the live ``predict_batch``'s at each bucket; (c)
     ``serving.server.start_background`` over the ``sampling`` artifact:
     zara1's small image registered through ``POST /v1/scenes``, one request
     with ``scene_ids`` equal to ``predict_batch`` on ``crop_patches`` and
     the folded seed bit for bit, the HTTP overhead of 20 one-scene
     requests over ``predict_batch`` at bucket 1, 400 without scene input,
     404 for an unknown path, then 64 client threads of 4 single-scene
     requests (p50, p99, requests/s, batches, mean batch, early
     dispatches; every answer's shape and finiteness); (d) ``cli.serve
     --input`` on the zara1 test txt with the small image as
     ``--scene_img``, over a ``sampling`` artifact exported at as many peds
     as the file's 8-frame windows hold: the npz's windows those of
     ``load_obs_windows``, each equal to ``predict_batch`` on its crops bit
     for bit;
 18. the rest of the single-device surface, with launch counts read around
     each of the paths ``split_step``, ``profiled_loop``, ``sweep`` and
     ``orbax_resume`` (each must launch K1, K2 and K3): (a) the split train
     step (the fused step behind JAX's split-step checks) at the flagship
     batch (256 x 16, K=20), one warm-up and 5 timed steps: finite metrics,
     the p50 beside phase 5's flagship step, and K1, K2 and K3 launched
     1, 2 and 1 times a step, as phase 5's step launches them;     (b) a ``Trainer`` with ``profile_dir`` on
     phase 15's zara1 files (``mggan4_zara1``'s flags, 1 epoch): one trace
     file, holding K1's, K2's and K3's kernel records (``TRACE_NEEDLES``),
     the traced second step's wall time beside the epoch's median untraced
     step; (c) ``cli.sweep --grid '{"num_gens": [2, 4]}'`` on the same files,
     1 epoch a point: both version dirs with a finite metrics.jsonl, the
     seconds of each point; (d) the committed converted JAX orbax checkpoint
     (``mggan_tpu_torch/tools/fixtures/orbax_tiny``) resumed for its second
     epoch on the card and on the CPU with the same draws, the two states
     under phase 16's rule; (e) the legacy Social-GAN at its JAX defaults
     on 64 x 16 (generator: pool_net and spool, pooling every step off and
     on, the latter with noise_dim=0; discriminator: local and global),
     card vs CPU within 1e-4 on the same weights and noise, the p50 of 5
     calls each; it launches none of the repo's kernels;
 19. data and generator parallelism (``mggan_tpu_torch/parallel``): the ranks are child
     processes of this script on the one card, under gloo (the backend rule
     of ``parallel/pod.py``: NCCL only where every local rank has a card of
     its own, so the NCCL route is not run here); a rank that fails or
     outlives RANK_TIMEOUT_S fails the phase. (a) ``dp_step``: the flagship
     step at 256 x 16, K=20 on 2 ranks (128 scene rows each, joined through
     a file:// store), a warm-up and 5 timed steps with injected draws,
     against the single-device step on the same batch and draws run here:
     the first step's metrics (rtol 1e-5), Adam moments (rtol 1e-4 / atol
     1e-6) and parameters (2e-3, float-noise elements under
     ``tools/state_compare.py``'s rule), the single-device step rerun beside
     as its own float noise, the ranks' states equal bit for bit after the
     6 steps, K1 1, K2 2 and K3 1 launches a step on each rank, the DP p50
     beside the single-device p50 (a record: the ranks share one card); (b)
     ``dp_cli``: ``mggan_dp_eth`` as configured (dp=8, batch 256) on 8 ranks
     under ``python -m torch.distributed.run --standalone`` through
     ``cli.train`` for 1 epoch on a BIWI eth split written as phase 16's
     is: one version dir, finite epoch metrics, ``checkpoint_best``, the
     ranks' states alike, then ``cli.evaluate`` of that dir in this process
     on one device (finite ADE/FDE); (c) ``pod``: 2 simulated nodes x 2
     ranks (two launchers, a static rendezvous on 127.0.0.1) on phase 15's
     zara1 files with ``shard_by_process`` and the bank: equal lockstep
     counts and ``max_peds`` on every rank, the bank's gathers equal host
     assembly bit for bit, ``allreduce_sums`` identical on every rank, then
     a ``Trainer`` epoch whose state is bit for bit alike on all 4 ranks;
     (d) ``gp_step``: (a)'s step, batch and draws on dp=2 x gp=2 ranks
     (128 scene rows and 2 of the 4 generators each, with their Adam
     moments), its gathered first step against (a)'s single-device step to
     (a)'s tolerances, the gathered states bit for bit after 6 steps, K1 1,
     K2 2 and K3 1 launches a step on each rank and no kept yardstick, the
     gp p50 beside the single-device p50 (a record, not a scaling figure);
     (e) ``gp_cli``: (b) with ``--dp 1 --gp 2`` on 2 ranks (2 steps of 256
     scenes, validation, ``checkpoint_best`` of the gathered state), then
     ``cli.evaluate`` of its version dir on one device; (f) the row-slice
     kernel checks: K1 (4,096 rows) and K2 (81,920 x 4) on each of 2 row
     slices equal the full launch's rows bit for bit, and so do K3's
     per-row input grads; K3's weight grads summed over the slices within
     SLICE_WGRAD_REL of the full launch's (launch counts of the paths
     ``dp_step``, ``dp_cli``, ``pod``, ``gp_step`` and ``gp_cli`` summed
     over their ranks);
 20. a JSON line listing every ported kernel (the replaced f32 K1, K2, K4
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
import tempfile
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
# Phase 16 holds the float-noise elements of any leaf, and NOISE_LEAVES,
# by their gradients (mggan_tpu_torch/tools/state_compare.py).
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
    """Build the kernels (nvcc, in parallel) and the native host ops (g++);
    returns the kernels' seconds and the host ops' (None when their library
    was built already)."""
    from mggan_tpu_torch import native
    from mggan_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel libraries in {secs:.2f} s")
    for stem in libs:
        for line in build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    host_s = None
    if not native.library_path(native.SRC_DIR / "host_ops.cpp").exists():
        t0 = time.perf_counter()
        native.load()
        host_s = time.perf_counter() - t0
        print(f"build: the native host ops (g++) in {host_s:.2f} s")
    return secs, host_s


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
    param_err, noise_err, param_bad = state_diffs(s_gpu, s_cpu, 2, 1, cfg)
    print(f"train step card vs CPU, {n_scenes} scenes x {PEDS} peds, K={NUM}, injected "
          f"draws: metrics max abs diff {metric_err:.3e} (atol/rtol {TRAIN_ATOL:g}), "
          f"parameters max abs diff {param_err:.3e} (atol {TRAIN_ATOL:g}), conv biases "
          f"before train-mode BN {noise_err:.3e} (Adam sign-flip bound 2*lr per update)")
    check(not metric_bad, f"train card vs CPU: metrics beyond tolerance {metric_bad}")
    check(not param_bad, f"train card vs CPU: parameters beyond tolerance {param_bad[:4]}")
    return {"metric_max_abs_diff": metric_err, "param_max_abs_diff": param_err,
            "noise_leaf_max_abs_diff": noise_err}


# CUDA runtime calls in which the host thread waits for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def device_profile(fn, reps, label, unit):
    """Device time by kernel name over ``reps`` calls of ``fn``
    (torch.profiler), the device's busy share of the wall time and the
    host's waits for the device (HOST_WAITS calls)."""
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
        by_name, syncs = {}, 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                tot, cnt = by_name.get(ev.name, (0.0, 0))
                by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
            elif ev.name in HOST_WAITS:
                syncs += 1
        if by_name:
            break
        print(f"profile, {label}: the profiler kept no device record; profiling again")
    check(by_name, f"profile, {label}: the profiler kept no device record in "
                   f"{PROFILE_TRIES} sessions")
    busy_ms = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    print(f"profile, {label}, {reps} {unit}s: wall {wall_ms / reps:.3f} ms/{unit}, device "
          f"busy {busy_ms / reps:.3f} ms/{unit} (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{launches / reps:.0f} device ops/{unit}, {syncs / reps:.0f} host waits/{unit}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, cnt) in top:
        print(f"  {tot / reps:8.4f} ms/{unit}  x{cnt // reps:<4d} {name[:90]}")
    return {"wall_ms": wall_ms / reps, "device_busy_ms": busy_ms / reps,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else float(np.nan),
            "device_ops": launches / reps, "host_waits": syncs / reps,
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


# the train-loop phase (14): part (a) the Trainer end to end, part (b) the
# feed at bench.py's train batch
LOOP_BATCH = 8  # 48 train windows: 6 steps an epoch; 16 val windows: 2 batches
LOOP_EPOCHS = 3
FEED_WINDOWS = 1024  # 4 steps an epoch of TRAIN_SCENES x PEDS
LOOP_ROUNDS = 6  # rounds of epochs with the bank, without, without, with
# Nearest-pixel patches, card vs CPU on the same draws: a source coordinate
# within float rounding of a half-integer may round the other way when cos
# or sin differ by an ulp; each differing pixel must lie within TIE_PX of
# one, and there may be at most MAX_TIES of them in the 256-scene batch.
TIE_PX = 1e-4
MAX_TIES = 64
# The kept warp-per-row yardsticks: on no path.
WARP_KERNELS = ("decode_select_warp", "decode_all_fwd_warp", "decode_select_bf16_warp",
                "decode_all_bwd_warp", "decode_all_fwd_bf16_warp",
                "decode_select_act_f32_warp", "decode_select_act_bf16_warp",
                "decode_select_act_lin_warp", "decode_select_ilp_bf16_warp",
                "decode_sorted_bf16_warp", "decode_select_ilp_warp", "decode_sorted_warp")


def state_diffs(a, b, g_updates, d_updates, cfg):
    """Largest parameter differences of two train states after
    ``g_updates`` and ``d_updates`` optimizer updates, apart and for
    NOISE_LEAVES, and the leaves beyond TRAIN_ATOL (NOISE_LEAVES: beyond
    2 * lr * updates + TRAIN_ATOL)."""
    from mggan_tpu_torch.utils.pytree import tree_items

    param_err, noise_err, bad = 0.0, 0.0, []
    for name, ta, tb, lr, updates in (("g", a.g_params, b.g_params, cfg.g_lr, g_updates),
                                      ("d", a.d_params, b.d_params, cfg.d_lr, d_updates)):
        flat = dict(tree_items(tb))
        for path, x in tree_items(ta):
            err = float((x - flat[path].to(x.device)).abs().max())
            noisy = path in NOISE_LEAVES
            if noisy:
                noise_err = max(noise_err, err)
            else:
                param_err = max(param_err, err)
            if err > (2 * lr * updates + TRAIN_ATOL if noisy else TRAIN_ATOL):
                bad.append((name, path, err))
    return param_err, noise_err, bad


def epoch_lines(writer):
    return [json.loads(line) for line in
            (writer.dir / "metrics.jsonl").read_text().splitlines()]


def loop_trainer_run(log_dir):
    """Part (a): the flagship Trainer on ``synthetic_memory`` for
    LOOP_EPOCHS epochs with augmentation, the patch bank, validation and a
    checkpoint every epoch, launch counts read around it; then a resume
    (``train(until_epoch=1)``, ``load_from_path``, ``train()``) against it."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    cfg = flagship_config(dataset="synthetic_memory", batch_size=LOOP_BATCH,
                          epochs=LOOP_EPOCHS, val_every=1, save_every=1, augment=1,
                          patch_bank=1, num_samples=NUM, num_expectation_samples=1,
                          seed=SEED, log_dir=log_dir)

    def trainer(version):
        writer = ExperimentWriter(log_dir, cfg.experiment, cfg.name, version=version,
                                  config=cfg, tensorboard=False)
        return Trainer(cfg, writer, device="cuda")

    whole = trainer(1)
    kernels.launches.clear()
    t0 = time.perf_counter()
    whole.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print("train loop launches:", json.dumps(launches))
    lines = epoch_lines(whole.writer)
    check(len(lines) == LOOP_EPOCHS, f"train loop: {len(lines)} epochs logged")
    bad = [(m["epoch"], k) for m in lines for k, v in m.items() if not np.isfinite(v)]
    check(not bad, f"train loop: non-finite epoch metrics {bad[:5]}")
    ckpts = sorted(p.name for p in whole.writer.checkpoint_dir.iterdir())
    check("checkpoint_best" in ckpts, f"train loop: no checkpoint_best in {ckpts}")
    check(np.isfinite(whole.state.best_val), f"train loop: best_val {whole.state.best_val}")
    steps = whole.state.step
    val_batches = LOOP_EPOCHS * -(-16 // LOOP_BATCH)
    check(steps == LOOP_EPOCHS * (48 // LOOP_BATCH), f"train loop: {steps} steps")
    need = {"decode_select": steps + val_batches, "decode_all_fwd": 2 * steps,
            "decode_all_bwd": steps}
    for name, n in need.items():
        check(launches.get(name, 0) >= n,
              f"train loop: {name} launched {launches.get(name, 0)} times, at least {n} due")
    warp = [n for n in WARP_KERNELS if launches.get(n)]
    check(not warp, f"train loop launched kept yardsticks {warp}")
    print(f"train loop, {LOOP_EPOCHS} epochs of {48 // LOOP_BATCH} steps at {LOOP_BATCH} "
          f"scenes + {val_batches // LOOP_EPOCHS} val batches: {secs:.2f} s, best_val "
          f"{whole.state.best_val:.4f}, checkpoints {ckpts}; per epoch: " + "; ".join(
              f"L2 {m['train/L2_loss']:.3f} val ADE {m['val/ADE k=20']:.3f} "
              f"{m['perf/steps_per_sec']:.2f} steps/s" for m in lines))

    part = trainer(2).train(until_epoch=1)
    check(part.state.epoch == 1, f"until_epoch=1 stopped at epoch {part.state.epoch}")
    resumed, _ = Trainer.load_from_path(part.writer.dir, checkpoint="latest", device="cuda")
    check(resumed.state.epoch == 1 and resumed.state.step == steps // LOOP_EPOCHS,
          f"resume: epoch {resumed.state.epoch}, step {resumed.state.step}")
    resumed.train()
    check(resumed.state.step == steps, f"resumed run ended at step {resumed.state.step}")
    param_err, noise_err, bad = state_diffs(whole.state, resumed.state, 2 * steps, steps, cfg)
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("perf/")}
    last_a, last_b = strip(lines[-1]), strip(epoch_lines(resumed.writer)[-1])
    metric_err = max(abs(last_a[k] - last_b[k]) for k in last_a)
    print(f"train loop resume (until_epoch=1, load_from_path, train) vs uninterrupted: "
          f"parameters max abs diff {param_err:.3e} (atol {TRAIN_ATOL:g}), conv biases "
          f"before train-mode BN {noise_err:.3e} (bound 2*lr per update), last epoch's "
          f"metrics max abs diff {metric_err:.3e} (not held); best_val "
          f"{whole.state.best_val:.6f} vs {resumed.state.best_val:.6f}")
    check(not bad, f"train loop resume: parameters beyond tolerance {bad[:4]}")
    return {"seconds": secs, "steps": steps, "val_batches": val_batches,
            "launches": launches, "best_val": whole.state.best_val,
            "epochs": [{k: m[k] for k in ("epoch", "train/L2_loss", "val/ADE k=20",
                                           "perf/steps_per_sec")} for m in lines],
            "resume_param_max_abs_diff": param_err, "resume_noise_leaf_max_abs_diff": noise_err,
            "resume_metric_max_abs_diff": metric_err}


def median_ms(fn, reps):
    """Median host-clock ms of ``fn()`` ending in a synchronize."""
    import numpy as np
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def loop_feed(log_dir, train_p50_ms):
    """Part (b): the feed at bench.py's train batch (TRAIN_SCENES x PEDS,
    K=NUM) from FEED_WINDOWS synthetic windows: the bank against host
    assembly, train-time augmentation card vs CPU, the feed's timings and
    epochs of the Trainer's loop with and without the bank."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.data import augment
    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.data.patch_bank import maybe_build_bank
    from mggan_tpu_torch.data.synthetic import make_synthetic_dataset
    from mggan_tpu_torch.device import host_to_device
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    ds = make_synthetic_dataset(num_windows=FEED_WINDOWS, max_peds=PEDS)
    bank = maybe_build_bank(ds, PEDS, device="cuda")
    check(bank is not None, "feed: the patch bank did not fit its budget")
    batcher = lambda b: PaddedBatcher(ds, TRAIN_SCENES, max_peds=PEDS, shuffle=True,
                                      seed=SEED, patch_bank=b, augment=True)
    host, banked = batcher(None), batcher(bank)
    idx = np.random.RandomState(SEED).permutation(FEED_WINDOWS)[:TRAIN_SCENES]
    h_batch = host.make_batch(idx)
    b_batch = banked.make_batch(idx)
    check(torch.equal(b_batch["big_patches"].cpu(), torch.from_numpy(h_batch["big_patches"])),
          "feed: the bank's gather differs from host assembly")
    part = idx[: TRAIN_SCENES * 25 // 32]  # and pad scenes
    check(torch.equal(banked.make_batch(part)["big_patches"].cpu(),
                      torch.from_numpy(host.make_batch(part)["big_patches"])),
          "feed: the bank's gather of a padded batch differs from host assembly")

    aug_cpu = augment.sample_aug_params(torch.Generator().manual_seed(SEED), TRAIN_SCENES)
    aug_gpu = tuple(a.cuda() for a in aug_cpu)
    got = augment.augment_batch(b_batch, True, device="cuda", aug=aug_gpu)
    want = augment.augment_batch(h_batch, True, device="cpu", aug=aug_cpu)
    traj_err = float(np.nanmax(np.abs(got["xy"].cpu().numpy() - want["xy"].numpy())))
    diff = (got["patches"].cpu() != want["patches"]).any(dim=1).any(dim=-1)
    diff = diff.reshape(TRAIN_SCENES, -1).numpy()
    sx, sy = augment.source_coords(*aug_cpu)
    off = lambda c: np.abs(c.numpy() - np.floor(c.numpy()) - 0.5)
    away = diff & (off(sx) >= TIE_PX) & (off(sy) >= TIE_PX)
    ties = int(diff.sum())
    print(f"feed, {TRAIN_SCENES} x {PEDS}: bank gather equals host assembly bit for bit "
          f"(and a {len(part)}-window batch with {TRAIN_SCENES - len(part)} pad scenes); "
          f"augment_batch(train=True) card vs "
          f"CPU, same draws: trajectories max abs diff {traj_err:.3e} (atol {KERNEL_ATOL:g}), "
          f"nearest patches differ at {ties} of {diff.size} (scene, pixel) positions, "
          f"{int(away.sum())} away from a half-integer tie (limit {MAX_TIES})")
    check(traj_err <= KERNEL_ATOL, f"feed: augmented trajectories differ by {traj_err:.3e}")
    check(not away.any(), "feed: augmented patches differ away from a rounding tie")
    check(ties <= MAX_TIES, f"feed: {ties} tie pixels")

    def host_copy():  # as augment_batch uploads it: through pinned memory
        host_to_device(host.make_batch(idx)["big_patches"], torch.device("cuda"))

    host_ms = median_ms(host_copy, 5)
    gather_ms = cuda_time_ms(lambda: bank.gather(idx), 20)
    aug_ms = cuda_time_ms(lambda: augment.augment_batch(b_batch, True, device="cuda",
                                                        aug=aug_gpu), 10)
    mb = bank.nbytes / 2**20
    batch_mb = h_batch["big_patches"].nbytes / 1e6
    print(f"feed per batch ({TRAIN_SCENES} x {PEDS}, {batch_mb:.1f} MB of uint8 patches): host "
          f"assembly + copy to the card {host_ms:.3f} ms (median of 5), bank gather "
          f"{gather_ms:.4f} ms, augment_batch(train=True) on the card {aug_ms:.3f} ms "
          f"(CUDA events); bank {mb:.1f} MiB")

    cfg = flagship_config(dataset="synthetic_memory", batch_size=TRAIN_SCENES, max_peds=PEDS,
                          epochs=100, augment=1, num_samples=NUM,
                          num_expectation_samples=1, seed=SEED, log_dir=log_dir)
    writer = ExperimentWriter(log_dir, cfg.experiment, "feed", version=1, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cuda")
    for e, loader in enumerate((banked, host)):  # warm-up
        tr.train_epoch(loader, e)
    epochs = {"bank": [], "host": []}
    for e, name in enumerate(("bank", "host", "host", "bank") * LOOP_ROUNDS):
        _, perf = tr.train_epoch(banked if name == "bank" else host, e + 2)
        epochs[name].append(perf)
    rates = {}
    for name, runs in epochs.items():
        # the loop's rate is the median epoch's; the total, which one
        # stalled epoch can move, stands beside it with the spread
        secs = np.array([r["seconds"] for r in runs])
        steps, agents = runs[0]["steps"], runs[0]["agents"]
        med = float(np.median(secs))
        rates[name] = {"steps_per_sec": steps / med, "agents_per_sec": agents / med,
                       "total_steps_per_sec": len(runs) * steps / float(secs.sum()),
                       "median_epoch_s": med, "epoch_s": secs.tolist()}
        print(f"train loop epoch through Prefetcher, {name:>4}: "
              f"{rates[name]['steps_per_sec']:.3f} steps/s, "
              f"{rates[name]['agents_per_sec']:.0f} agents/s by the median of {len(runs)} "
              f"epochs of {steps} steps ({med:.4f} s; min {secs.min():.4f}, max "
              f"{secs.max():.4f}); over all {len(runs)} "
              f"{rates[name]['total_steps_per_sec']:.3f} steps/s; bare step p50 "
              f"{train_p50_ms:.3f} ms = {1e3 / train_p50_ms:.3f} steps/s, the median "
              f"epoch {1e3 * med / steps / train_p50_ms:.4f} x {steps} bare steps")
    profile = device_profile(lambda rep: tr.train_epoch(banked, 10 + rep), 1,
                             f"train loop with the bank, {TRAIN_SCENES} x {PEDS}", "epoch")
    return {"host_assembly_copy_ms": host_ms, "bank_gather_ms": gather_ms,
            "augment_train_ms": aug_ms, "bank_mib": mb, "traj_max_abs_diff": traj_err,
            "tie_pixels": ties, "rates": rates, "bare_step_p50_ms": train_p50_ms,
            "profile": {k: v for k, v in profile.items() if k != "by_name_ms"}}


def phase_train_loop(train_p50_ms):
    """Phase 14: the train loop (see the module note)."""
    import tempfile

    with tempfile.TemporaryDirectory() as log_dir:
        run = loop_trainer_run(log_dir)
        feed = loop_feed(log_dir, train_p50_ms)
    return {**run, "feed": feed}


# --------------------------------------------------- phase 15: real data --
FIXTURES = HERE / "mggan_tpu_torch" / "tools" / "fixtures"
REAL_PHASES = ("train", "val", "test")
# zara1 at about the real split's scale: frames per phase, peds arriving at
# REAL_ARRIVAL a frame and staying 30-60 frames (8-15 present at a time)
ZARA1_FRAMES = {"train": 850, "val": 90, "test": 90}
# eth (BIWI) at reduced frames, for phase 16's single_gen_eth CLI pair
ETH_FRAMES = {"train": 300, "val": 60, "test": 60}
REAL_ARRIVAL = 0.25
SDD_FRAMES = {"train": 240, "val": 60, "test": 60}  # frames kept by the 30 fps subsampling
GOFP_FRAMES = {"train": 120, "val": 50, "test": 50}  # frames kept by the 10 fps subsampling
SDD_RATIO = 0.0367  # m/px of the SDD scene in H_SDD.txt
GOFP_SCENE = "eth"  # registry.GOFP_RATIOS["eth"] / 0.05 = 1.33: the upscaling resize
REAL_CPU_WINDOWS = 64  # zara1 test windows repeated on the CPU
# read_rgb against the committed cv2 decode of the fixture JPEG: (largest
# difference, pixels that differ by more than 1). OpenCV on the card machine
# decodes with libjpeg-turbo, as the fixture's maker did: equal bytes.
# nvJPEG (chroma upsampled by interpolation) converts YCbCr to RGB with its
# own rounding: on an H100 80GB HBM3 at 700 W it read a largest difference
# of 4, 407,063 of 414,720 pixels off by at least 1 and 13,733 by more
# (PERF.md; without the interpolation flag the largest difference was 54),
# so it is held to 4 and 16,000.
CV2_DECODE_LIMITS = (0, 0)
NVJPEG_LIMITS = (4, 16_000)


def write_walkers(rng, frames, arrival, scene_wh_m):
    """Straight walks with a little noise inside a ``scene_wh_m`` scene:
    peds arrive at ``arrival`` a frame and stay 30-60 frames. Returns rows
    (frame, id, x, y), positions in metres."""
    import numpy as np

    w, h = scene_wh_m
    rows, pid = [], 0
    for start in range(-40, frames):
        for _ in range(rng.poisson(arrival)):
            dur = rng.randint(30, 61)
            pos = rng.uniform((0.1 * w, 0.1 * h), (0.9 * w, 0.9 * h))
            vel = rng.normal(0, 1, 2)
            vel *= rng.uniform(0.3, 0.6) / max(float(np.linalg.norm(vel)), 1e-6)
            for f in range(max(start, 0), min(start + dur, frames)):
                x, y = pos + vel * (f - start) + rng.normal(0, 0.02, 2)
                rows.append((f, pid, x, y))
            pid += 1
    return rows


def write_real_fixtures(root):
    """Part (b): ``zara1`` (BIWI layout: frame, ID, y, x in metres),
    ``stanford`` (SDD layout: 12 columns, quoted and bare labels, Biker and
    lost rows, 30 fps, H_SDD.txt) and ``gofp`` (8 columns, is_active = 0
    rows, 10 fps) under ``root``; every scene image is the committed fixture
    JPEG (720 x 576)."""
    import shutil

    import numpy as np

    rng = np.random.RandomState(SEED)
    jpg = FIXTURES / "scene.jpg"
    write_biwi(root, "zara1", ZARA1_FRAMES, rng)
    (root / "stanford").mkdir()
    (root / "stanford" / "H_SDD.txt").write_text(
        f"File\tVersion\tRatio\nsc0.jpg\tA\t{SDD_RATIO}\nsc0.jpg\tB\t0.5\n")
    for phase in REAL_PHASES:
        d = root / "stanford" / phase
        d.mkdir()
        lines = []
        for f, p, x, y in write_walkers(rng, SDD_FRAMES[phase], 0.15,
                                        (720 * SDD_RATIO, 576 * SDD_RATIO)):
            px, py = x / SDD_RATIO, y / SDD_RATIO
            box = f"{px - 10:.0f}\t{py - 20:.0f}\t{px + 10:.0f}\t{py + 20:.0f}"
            label = '"Pedestrian"' if p % 3 == 0 else "Pedestrian"
            xy = f"{px:.2f}\t{py:.2f}"
            lines.append(f"{p}\t{box}\t{12 * f}\t0\t0\t0\t{label}\t{xy}")
            lines.append(f"{p}\t{box}\t{12 * f + 6}\t0\t0\t1\t{label}\t{xy}")  # subsampled out
            if p % 4 == 0:  # filtered out: a biker, a lost box
                lines.append(f"{1000 + p}\t{box}\t{12 * f}\t0\t0\t0\tBiker\t{xy}")
                lines.append(f"{2000 + p}\t{box}\t{12 * f}\t1\t0\t0\tPedestrian\t{xy}")
        (d / f"{phase}_sc0.txt").write_text("\n".join(lines))
        shutil.copy(jpg, d / "sc0.jpg")
    ratio = 0.06668566952360758  # registry.GOFP_RATIOS[GOFP_SCENE]
    for phase in REAL_PHASES:
        d = root / "gofp" / phase
        d.mkdir(parents=True)
        lines = []
        for f, p, x, y in write_walkers(rng, GOFP_FRAMES[phase], 0.15,
                                        (720 * ratio, 576 * ratio)):
            active = 0 if (p % 5 == 0 and f % 10 == 0) else 1
            xy = f"{x / ratio:.2f}\t{y / ratio:.2f}"
            lines.append(f"{4.0 * f}\t{float(p)}\t{xy}\t0\t0\t{p % 3}\t{active}")
            lines.append(f"{4.0 * f + 2}\t{float(p)}\t{xy}\t0\t0\t{p % 3}\t1")  # subsampled out
        (d / f"{phase}_{GOFP_SCENE}.txt").write_text("\n".join(lines))
        shutil.copy(jpg, d / f"{GOFP_SCENE}.jpg")


def write_biwi(root, scene, frames, rng):
    """A BIWI split (frame, ID, y, x in metres; every phase of ``frames``)
    of ``write_walkers``' peds under ``root/<scene>``, with the committed
    fixture JPEG as its scene image."""
    import shutil

    for phase in REAL_PHASES:
        d = root / scene / phase
        d.mkdir(parents=True)
        rows = write_walkers(rng, frames[phase], REAL_ARRIVAL, (720 * 0.05, 576 * 0.05))
        (d / f"{phase}_{scene}.txt").write_text("\n".join(
            f"{float(f)}\t{float(p)}\t{y:.4f}\t{x:.4f}" for f, p, x, y in rows))
        shutil.copy(FIXTURES / "scene.jpg", d / f"{scene}.jpg")


def real_environment(host_build_s):
    """Part (a): which of cv2, pandas and PIL import, the host ops' build
    time (``host_build_s``, phase 2's; None: built here if their library is
    missing) and ``read_rgb``'s decoder; both decoders against the committed
    cv2 decode, and ``resize_area`` against this machine's cv2 where it
    imports."""
    import importlib

    import numpy as np

    from mggan_tpu_torch import native
    from mggan_tpu_torch.data import image_io

    imports = {}
    for mod in ("cv2", "pandas", "PIL"):
        try:
            importlib.import_module(mod)
            imports[mod] = True
        except ImportError:
            imports[mod] = False
    if host_build_s is None and not native.library_path(native.SRC_DIR / "host_ops.cpp").exists():
        t0 = time.perf_counter()
        native.load()
        host_build_s = time.perf_counter() - t0
    built = "not built in this run" if host_build_s is None else f"{host_build_s:.2f} s"
    decoder = image_io.decoder()
    print(f"real data environment: imports cv2 {imports['cv2']}, pandas {imports['pandas']}, "
          f"PIL {imports['PIL']}; host ops' g++ build {built}; image_io.decoder() {decoder}")
    want = np.load(FIXTURES / "scene_cv2.npz")["rgb"]
    limits = {"read_rgb": CV2_DECODE_LIMITS if decoder == "cv2" else NVJPEG_LIMITS,
              "nvjpeg": NVJPEG_LIMITS}
    decode = {}
    for name, fn in (("read_rgb", image_io.read_rgb), ("nvjpeg", image_io.decode_nvjpeg)):
        fn(FIXTURES / "scene.jpg")  # nvJPEG's first call builds the shim and its handle
        t0 = time.perf_counter()
        got = fn(FIXTURES / "scene.jpg")
        ms = (time.perf_counter() - t0) * 1e3
        check(got.shape == want.shape and got.dtype == np.uint8,
              f"{name}: decoded {got.shape} {got.dtype}")
        d = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
        r = decode[name] = {"max_abs": int(d.max()), "pixels": int((d > 0).sum()),
                            "beyond_1": int((d > 1).sum()), "of": int(d.size), "ms": ms,
                            "limits": limits[name]}
        print(f"  {name} ({decoder if name == 'read_rgb' else 'nvjpeg'}) against the committed "
              f"cv2 decode of the fixture: max abs diff {r['max_abs']}, {r['pixels']} of "
              f"{r['of']} pixels differ, {r['beyond_1']} by more than 1 (limits "
              f"{r['limits']}), {ms:.1f} ms")
        check(r["max_abs"] <= r["limits"][0] and r["beyond_1"] <= r["limits"][1],
              f"{name} against the cv2 decode: {r}")
    resize = None
    if imports["cv2"]:
        import cv2

        resize = {}
        for label, size in (("box 2x", (360, 288)), ("area 0.1", (72, 58)),
                            ("area 0.73", (528, 423)), ("upscale 1.33", (960, 768))):
            ref = cv2.resize(want, size, interpolation=cv2.INTER_AREA)
            resize[label] = int((image_io.resize_area(want, size) != ref).sum())
        print(f"  resize_area against this machine's cv2.resize(INTER_AREA), differing bytes: "
              f"{json.dumps(resize)}")
        check(not any(resize.values()), f"resize_area differs from cv2: {resize}")
    return {"imports": imports, "host_build_s": host_build_s, "decoder": decoder,
            "decode": decode, "resize_vs_cv2_bytes": resize}


def real_parse(root):
    """Part (c): every split of the three fixtures parsed with pandas made
    unimportable, and the native host ops held to their numpy versions on
    these files: parsed values, keep matrices and patches equal."""
    import numpy as np

    from mggan_tpu_torch import native
    from mggan_tpu_torch.data import parsing, registry
    from mggan_tpu_torch.data.dataset import BIG_MARGIN
    from mggan_tpu_torch.data.loaders import get_dataset

    saved = sys.modules.get("pandas")
    sys.modules["pandas"] = None  # the port's data path must not need it
    try:
        out, datasets = {}, {}
        for name in ("zara1", "stanford", "gofp"):
            info = registry.get_info(name)
            for phase in REAL_PHASES:
                t0 = time.perf_counter()
                ds = datasets[name, phase] = get_dataset(name, phase, data_root=root)
                ms = (time.perf_counter() - t0) * 1e3
                peds = [len(t) for t in ds.trajectories]
                check(len(ds) > 0, f"{name}/{phase}: no windows")
                for txt in sorted((root / name / phase).glob("*.txt")):
                    a = native.parse_numeric_txt(txt)
                    b = native.parse_numeric_txt_reference(txt)
                    check((a is None) == (b is None) and (a is None or np.array_equal(a, b)),
                          f"parse_numeric_txt differs from numpy on {name}/{txt.name}")
                    check((a is None) == (name == "stanford"),
                          f"{name}/{txt.name}: parse_numeric_txt gave {type(a)}")
                    data = parsing.load_txt(txt, info)
                    _, fi = np.unique(data[:, 0], return_inverse=True)
                    _, pi = np.unique(data[:, 1], return_inverse=True)
                    present = np.zeros((pi.max() + 1, fi.max() + 1), np.uint8)
                    present[pi, fi] = 1
                    check(np.array_equal(native.window_presence(present, 20),
                                         native.window_presence_reference(present, 20)),
                          f"window_presence differs from numpy on {name}/{txt.name}")
                for t, scene, big in zip(ds.trajectories, ds.scene_names, ds.big_patches):
                    centers = (t[:, 7] * ds.px_per_meter).astype(np.int64)
                    ref = native.extract_patches_reference(ds.images[scene]["small"], centers,
                                                           BIG_MARGIN)
                    check(np.array_equal(big, ref), f"{name}/{phase}: patches differ from numpy")
                nan = sum(int(np.isnan(t).any(axis=(1, 2)).sum()) for t in ds.trajectories)
                out[f"{name}/{phase}"] = {"windows": len(ds), "peds": int(sum(peds)),
                                          "max_peds": int(max(peds)), "nan_futures": nan,
                                          "parse_ms": ms}
                print(f"  parsed {name}/{phase}: {len(ds)} windows, {sum(peds)} peds (up to "
                      f"{max(peds)} a window, {nan} with NaN futures) in {ms:.1f} ms")
    finally:
        if saved is None:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = saved
    check(out["gofp/train"]["nan_futures"] > 0, "gofp: no NaN futures")
    print("  the native host ops equal their numpy versions on every file (parsed values, "
          "keep matrices) and every window (patches)")
    return out, datasets


def real_cli_pair(root, log_dir, test_windows):
    """Part (d): ``cli.train`` with the flags of ``mggan4_zara1`` for 2
    epochs, then ``cli.evaluate`` (all strategies, Precision/Recall) on the
    test split, both on the card, launch counts read around the pair."""
    import csv

    import numpy as np
    import torch

    from mggan_tpu_torch.cli import evaluate as evaluate_cli
    from mggan_tpu_torch.cli import train as train_cli
    from mggan_tpu_torch.configs import BENCHMARK_CONFIGS
    from mggan_tpu_torch.ops import kernels

    flags = {**BENCHMARK_CONFIGS["mggan4_zara1"], "epochs": 2, "val_every": 1, "augment": 1,
             "patch_bank": 1, "seed": SEED}
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    argv += ["--name", "mggan4_zara1", "--log_dir", str(log_dir), "--data_root", str(root),
             "--device", "cuda"]
    print("  python -m mggan_tpu_torch.cli.train " + " ".join(argv))
    kernels.launches.clear()
    t0 = time.perf_counter()
    model = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    vdir = model.writer.dir
    lines = epoch_lines(model.writer)
    check(len(lines) == 2, f"cli.train: {len(lines)} epochs logged")
    bad = [(m["epoch"], k) for m in lines for k, v in m.items() if not np.isfinite(v)]
    check(not bad, f"cli.train: non-finite epoch metrics {bad[:5]}")
    check((vdir / "checkpoints" / "checkpoint_best").exists(), "cli.train: no best checkpoint")
    t0 = time.perf_counter()
    csv_path = evaluate_cli.main(["--model_path", str(vdir.parent), "--output_folder",
                                  str(log_dir / "results"), "--phase", "test",
                                  "--pred_strat", "all", "--data_root", str(root),
                                  "--device", "cuda"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    strats = [r["Prediction strategy"] for r in rows]
    check(strats == ["smart_expected", "expected", "sampling"], f"CSV rows {strats}")
    metrics = [c for c in rows[0] if c.startswith(("ADE k=", "FDE k=", "Mode k=", "Precision",
                                                   "Recall k="))]
    check(len(metrics) == 4 * EVAL_K + 1, f"CSV: {len(metrics)} metric columns")
    bad = [(r["Prediction strategy"], c) for r in rows for c in metrics
           if not np.isfinite(float(r[c]))]
    check(not bad, f"CSV: non-finite metrics {bad[:5]}")
    check(int(rows[0]["Generator params"]) == model.config.num_gen_parameters > 0,
          f"CSV: Generator params {rows[0]['Generator params']}")
    need = {"decode_select": 1, "decode_all_fwd": 1, "decode_all_bwd": 1}
    for name, n in need.items():
        check(launches.get(name, 0) >= n, f"realdata_cli: {name} launched "
                                          f"{launches.get(name, 0)} times")
    warp = [n for n in WARP_KERNELS if launches.get(n)]
    check(not warp, f"realdata_cli launched kept yardsticks {warp}")
    return {"version_dir": vdir, "launches": launches, "train_s": train_s, "eval_s": eval_s,
            "steps_per_sec": [m["perf/steps_per_sec"] for m in lines],
            "steps": int(model.state.step),
            "val_ade20": [m["val/ADE k=20"] for m in lines],
            "eval_ms_per_window": eval_s / test_windows * 1e3, "test_windows": test_windows,
            "csv": {r["Prediction strategy"]: {k: float(r[k]) for k in (
                "ADE k=1", "ADE k=19", "FDE k=19", "Mode k=19", "Precision", "Recall k=19")}
                for r in rows}}


def real_card_vs_cpu(vdir, ds):
    """Part (e): the trained version dir loaded on the card and on the CPU,
    ``sampling`` and ``expected`` on the first REAL_CPU_WINDOWS test windows
    with the same injected draws."""
    import torch

    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.eval.evaluate import batch_seed, get_predictions_multi
    from mggan_tpu_torch.training.loop import Trainer

    sub = first_windows(ds, REAL_CPU_WINDOWS)
    loader = lambda: PaddedBatcher(sub, batch_size=EVAL_BATCH)
    card, _ = Trainer.load_from_path(vdir, "best", device="cuda")
    cpu, _ = Trainer.load_from_path(vdir, "best", device="cpu")
    strats = ("sampling", "expected")
    p = loader().max_peds
    draws = [cpu.predictor().make_draws(torch.Generator().manual_seed(batch_seed(SEED, i)),
                                        strats, EVAL_BATCH, p, EVAL_K)
             for i in range(len(loader()))]
    on_card = get_predictions_multi(card.predictor(), loader(), EVAL_K, strats, draws=draws)
    on_cpu = get_predictions_multi(cpu.predictor(), loader(), EVAL_K, strats, draws=draws)
    ks = list(range(1, EVAL_K + 1))
    out = {s: compare_eval(sub, on_card[s], on_cpu[s], ks, False) for s in strats}
    for s, r in out.items():
        print(f"  card vs CPU, {s}, {len(sub)} zara1 test windows, same draws: ADE/FDE max abs "
              f"diff {r['metric_max_abs_diff']:.3e}, predictions {r['pred_max_abs_diff']:.3e} "
              f"(atol {EVAL_ATOL:g}), Mode flips {r['mode_flips']}: within {r['ok']}")
        check(r["ok"], f"realdata card vs CPU {s}: {r}")
    return out


def phase_real_data(tmp, host_build_s=None):
    """Phase 15: real data and the train -> evaluate CLI pair (see the
    module note) in the directory ``tmp``; ``host_build_s``: phase 2's build
    of the host ops. Returns the summary and, for phase 17, the data root,
    the zara1 test split and the trained version dir."""
    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    env = real_environment(host_build_s)
    root = Path(tmp) / "data"
    t0 = time.perf_counter()
    write_real_fixtures(root)
    write_s = time.perf_counter() - t0
    parsed, datasets = real_parse(root)
    test_ds = datasets["zara1", "test"]
    cli = real_cli_pair(root, Path(tmp) / "logs", len(test_ds))
    vdir = cli.pop("version_dir")
    vs_cpu = real_card_vs_cpu(vdir, test_ds)
    parse_ms = sum(r["parse_ms"] for r in parsed.values())
    print(f"real data CLI pair ({card}): cli.train mggan4_zara1, {cli['steps']} steps in 2 "
          f"epochs at batch 32, {cli['train_s']:.2f} s, steps/s per epoch "
          f"{', '.join(f'{r:.3f}' for r in cli['steps_per_sec'])}; cli.evaluate (3 strategies, "
          f"k=1..19, Precision/Recall) {cli['eval_s']:.2f} s, "
          f"{cli['eval_ms_per_window']:.2f} ms per test window ({cli['test_windows']}); host "
          f"parse of all 9 splits {parse_ms:.1f} ms; launches {json.dumps(cli['launches'])}; "
          f"fixtures written in {write_s:.2f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return ({"card": card, "environment": env, "parse": parsed, "parse_ms_total": parse_ms,
             **cli, "card_vs_cpu": vs_cpu, "seconds": time.perf_counter() - t_phase},
            {"root": root, "test_ds": test_ds, "version_dir": vdir})


# Phase 16: the train-step families at the flagship widths (h = decoder_h
# = 32, the scene CNN, 4 generators; gan at 1) on TRAIN_SCENES x PEDS, K =
# NUM: the flagship itself (phase 5's config, the in-phase yardstick of
# the others' step times: the host-bound step runs slower late in a whole
# run than in phase 5), the four golden families and the cases of
# tests/test_torch_port_families_jax_*.py
FAMILIES = {
    "flagship_mgan_ml": {},
    "gan_l2": dict(gan_type="gan", weighting_target="l2", num_gens=1),
    "infogan_none": dict(gan_type="infogan", weighting_target="none"),
    "mgan_ml_W": dict(gan_obj="W"),
    "probgan_ml": dict(gan_type="probgan"),
    "A_MM_endpoint_abs": dict(gan_obj="MM", weighting_target="endpoint", l2_loss_type="min_z",
                              inp_format="abs", global_disc=0),
    "B_LS_mgan0_sgan": dict(gan_obj="LS", weighting_target="mgan", wt_mgan_compat=0,
                            l2_loss_type="mse", pool_type="sgan"),
    "C_infogan_W": dict(gan_type="infogan", gan_obj="W", l2_loss_type="min_g_min_z"),
    "D_unroll2_gated": dict(num_unrolling_steps=2, num_gen_steps=2, keep_gen_steps=1,
                            weighting_target="mgan"),
    "E_discrete": dict(experiment="discrete", unconditional=True),
    "E_uncond_gan": dict(gan_type="gan", weighting_target="none", l2_loss_type="none",
                         unconditional=True, num_gens=1),
}
FAMILY_STEPS = 5
FAMILY_CPU_SCENES = 4


def family_config(name):
    """The flagship config with family ``name``'s settings."""
    from mggan_tpu_torch.config import Config, flagship_config

    base = flagship_config(num_samples=NUM, num_expectation_samples=1).to_dict()
    return Config.from_dict({**base, **FAMILIES[name]})


def family_timing(name, batch):
    """One warm-up and FAMILY_STEPS timed steps of family ``name`` on the
    card (host clock around a step that ends in a synchronize), the
    launches of each kernel per timed step, and the last metrics."""
    import numpy as np
    import torch

    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step

    cfg = family_config(name)
    g_pack, d_pack = construct_gan(cfg, seed=SEED, device="cuda")
    state = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    step = build_train_step(cfg, g_pack[2], d_pack[2])
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    before, times = dict(kernels.launches), []
    for _ in range(FAMILY_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {k: (v - before.get(k, 0)) / FAMILY_STEPS for k, v in kernels.launches.items()
                if v - before.get(k, 0)}
    values = {k: float(v) for k, v in metrics.items()}
    # a gated-out D step reports NaN D metrics (case D's odd steps)
    bad = [k for k, v in values.items() if not np.isfinite(v)
           and not (cfg.num_gen_steps > 1 and ("_D" in k or "/D/" in k or "disc" in k))]
    check(not bad, f"family {name}: non-finite metrics {bad}")
    d_runs = sum(1 for i in range(1, FAMILY_STEPS + 1)
                 if cfg.num_gen_steps <= 1 or i % cfg.num_gen_steps == 0)
    need = {"decode_select": d_runs * (cfg.num_unrolling_steps + 1) / FAMILY_STEPS,
            "decode_all_fwd": 1 + (cfg.weighting_target in ("l2", "endpoint", "ml")),
            "decode_all_bwd": 1}
    for kname, n in need.items():
        check(per_step.get(kname, 0) == n,
              f"family {name}: {kname} {per_step.get(kname, 0)} launches a step, {n} due")
    return {"p50_ms": float(np.median(times)), "times_ms": times, "first_ms": first_ms,
            "launches_per_step": per_step,
            "num_gens": cfg.num_gens,
            "losses": {k: v for k, v in values.items() if k.startswith("train/")
                       and "grad" not in k and "lr_" not in k and np.isfinite(v)}}


def family_card_vs_cpu(name):
    """One step of family ``name`` with the same weights and injected draws
    on the card and on the CPU at FAMILY_CPU_SCENES scenes: metrics within
    TRAIN_ATOL/RTOL, parameters within TRAIN_ATOL but the float-noise
    elements, held by their gradients (``train_state_diffs``)."""
    import math

    import torch

    from mggan_tpu_torch.models.factory import construct_gan, tree_to
    from mggan_tpu_torch.tools.state_compare import train_state_diffs
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws

    cfg = family_config(name)
    g_pack, d_pack = construct_gan(cfg, seed=SEED + 16, device="cpu")
    draws = make_draws(torch.Generator().manual_seed(SEED), cfg, FAMILY_CPU_SCENES, PEDS,
                       g_pack[0], d_pack[0])
    batch = train_batch(FAMILY_CPU_SCENES, SEED + 16)
    results = {}
    for dev in ("cuda", "cpu"):
        on = lambda pack: (tree_to(pack[0], dev), tree_to(pack[1], dev), pack[2])
        g, d = on(g_pack), on(d_pack)
        state = init_train_state(cfg, g, d, seed=SEED)
        results[dev] = build_train_step(cfg, g[2], d[2])(state, batch, draws)
    (s_gpu, m_gpu), (s_cpu, m_cpu) = results["cuda"], results["cpu"]
    check(set(m_gpu) == set(m_cpu), f"family {name}: metric keys differ")
    metric_err, metric_bad = 0.0, []
    for k, want in m_cpu.items():
        got, want = float(m_gpu[k]), float(want)
        if math.isnan(want) and math.isnan(got):
            continue
        metric_err = max(metric_err, abs(got - want))
        if not abs(got - want) <= TRAIN_ATOL + TRAIN_RTOL * abs(want):
            metric_bad.append(k)
    diffs = train_state_diffs(s_gpu, s_cpu, cfg, TRAIN_ATOL, NOISE_LEAVES)
    param_bad = diffs.pop("bad")
    check(not metric_bad, f"family {name} card vs CPU: metrics beyond tolerance {metric_bad}")
    check(not param_bad, f"family {name} card vs CPU: parameters beyond tolerance "
                         f"{param_bad[:4]}")
    return {"metric_max_abs_diff": metric_err, **diffs}


def single_gen_cli(root, log_dir):
    """Part (b): ``cli.train`` with ``single_gen_eth``'s flags (one
    generator, gan, no PM target, batch 32) for 2 epochs with augmentation
    and the patch bank on the eth split, then ``cli.evaluate`` (k=1..19,
    Precision/Recall) on its test split, launch counts read around the
    pair (path ``single_gen_cli``)."""
    import csv

    import numpy as np
    import torch

    from mggan_tpu_torch.cli import evaluate as evaluate_cli
    from mggan_tpu_torch.cli import train as train_cli
    from mggan_tpu_torch.configs import BENCHMARK_CONFIGS
    from mggan_tpu_torch.ops import kernels

    flags = {**BENCHMARK_CONFIGS["single_gen_eth"], "epochs": 2, "val_every": 1,
             "augment": 1, "patch_bank": 1, "seed": SEED}
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    argv += ["--name", "single_gen_eth", "--log_dir", str(log_dir), "--data_root", str(root),
             "--device", "cuda"]
    print("  python -m mggan_tpu_torch.cli.train " + " ".join(argv))
    kernels.launches.clear()
    t0 = time.perf_counter()
    model = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    lines = epoch_lines(model.writer)
    check(len(lines) == 2, f"single_gen_eth: {len(lines)} epochs logged")
    bad = [(m["epoch"], k) for m in lines for k, v in m.items() if not np.isfinite(v)]
    check(not bad, f"single_gen_eth: non-finite epoch metrics {bad[:5]}")
    t0 = time.perf_counter()
    csv_path = evaluate_cli.main(["--model_path", str(model.writer.dir.parent),
                                  "--output_folder", str(log_dir / "results"), "--phase",
                                  "test", "--pred_strat", "all", "--data_root", str(root),
                                  "--device", "cuda"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    check([r["Prediction strategy"] for r in rows] == ["sampling"],
          f"single_gen_eth CSV rows {[r['Prediction strategy'] for r in rows]}")
    metrics = [c for c in rows[0] if c.startswith(("ADE k=", "FDE k=", "Mode k=", "Precision",
                                                   "Recall k="))]
    check(len(metrics) == 4 * EVAL_K + 1, f"single_gen_eth CSV: {len(metrics)} metrics")
    bad = [c for c in metrics if not np.isfinite(float(rows[0][c]))]
    check(not bad, f"single_gen_eth CSV: non-finite metrics {bad[:5]}")
    for kname in ("decode_select", "decode_all_fwd", "decode_all_bwd"):
        check(launches.get(kname, 0) >= 1, f"single_gen_cli: {kname} launched "
                                           f"{launches.get(kname, 0)} times")
    return {"launches": launches, "train_s": train_s, "eval_s": eval_s,
            "steps": int(model.state.step),
            "steps_per_sec": [m["perf/steps_per_sec"] for m in lines],
            "val_ade20": [m["val/ADE k=20"] for m in lines],
            "csv": {k: float(rows[0][k]) for k in ("ADE k=1", "ADE k=19", "FDE k=19",
                                                   "Mode k=19", "Precision", "Recall k=19")}}


def phase_families(flagship_p50_ms):
    """Phase 16: every train-step family on the card (see the module note);
    ``flagship_p50_ms``: phase 5's step p50, printed beside each family's."""
    import tempfile

    import numpy as np
    import torch

    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.tools.state_compare import GRAD_NOISE_REL

    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(TRAIN_SCENES, SEED).items()}
    kernels.launches.clear()
    timing = {name: family_timing(name, batch) for name in FAMILIES}
    launches = dict(kernels.launches)
    print("families launches:", json.dumps(launches))
    warp = [n for n in WARP_KERNELS if launches.get(n)]
    check(not warp, f"families launched kept yardsticks {warp}")
    base = timing["flagship_mgan_ml"]["p50_ms"]
    print(f"train-step families ({card}), {TRAIN_SCENES} scenes x {PEDS} peds, K={NUM}, "
          f"h=32, p50 of {FAMILY_STEPS} steps (host clock, synchronized) beside this "
          f"phase's flagship ({base:.3f} ms; phase 5's {flagship_p50_ms:.3f} ms):")
    for name, r in timing.items():
        r["vs_flagship"] = r["p50_ms"] / base
        print(f"  {name} (G={r['num_gens']}): p50 {r['p50_ms']:.3f} ms "
              f"({r['vs_flagship']:.2f}x), steps {json.dumps(r['times_ms'])} ms, "
              f"first {r['first_ms']:.1f} ms, launches a step "
              f"{json.dumps(r['launches_per_step'])}")
    t_cpu = time.perf_counter()
    vs_cpu = {}
    for name in FAMILIES:
        c = vs_cpu[name] = family_card_vs_cpu(name)
        print(f"  {name} card vs CPU at {FAMILY_CPU_SCENES} scenes, injected draws: metrics "
              f"{c['metric_max_abs_diff']:.3e}, parameters {c['param_max_abs_diff']:.3e} "
              f"(atol {TRAIN_ATOL:g}); {c['noise_elements']} of {c['elements']} elements "
              f"with float-noise gradients: parameters {c['noise_max_abs_diff']:.3e} (bound "
              f"2*lr per update), first moments {c['noise_grad_max_rel_diff']:.3e} of the "
              f"module's rms gradient (bound {GRAD_NOISE_REL:g}; every element "
              f"{c['grad_max_rel_diff']:.3e})")
    cpu_s = time.perf_counter() - t_cpu
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        write_biwi(root, "eth", ETH_FRAMES, np.random.RandomState(SEED + 16))
        cli = single_gen_cli(root, Path(tmp) / "logs")
    print(f"single_gen_eth CLI pair ({card}): cli.train {cli['steps']} steps in 2 epochs at "
          f"batch 32, {cli['train_s']:.2f} s; cli.evaluate (sampling, k=1..19, "
          f"Precision/Recall) {cli['eval_s']:.2f} s; CSV {json.dumps(cli['csv'])}; launches "
          f"{json.dumps(cli['launches'])}")
    secs = time.perf_counter() - t_phase
    print(f"phase 16 (families): {secs:.1f} s, of which card vs CPU {cpu_s:.1f} s")
    return {"card": card, "flagship_p50_ms": flagship_p50_ms, "timing": timing,
            "card_vs_cpu": vs_cpu, "launches": launches, "single_gen_cli": cli,
            "seconds": secs}


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


# ------------------------------------------------ phase 17: deployment --
DEPLOY_CLIENTS = 64  # client threads against the HTTP server
DEPLOY_REQUESTS = 4  # single-scene requests a client
DEPLOY_SEQUENTIAL = 20  # one-scene requests, direct and over HTTP, for the overhead
DEPLOY_TIMED = 20  # artifact and live calls a bucket, alternated, for their p50s
DEPLOY_STATE = ("g_params", "g_state", "d_params", "d_state")


def tree_mismatches(a, b):
    """Paths where two trees differ (a path set of its own, or a leaf not
    equal bit for bit)."""
    import torch

    from mggan_tpu_torch.utils.pytree import tree_items

    ia, ib = list(tree_items(a)), list(tree_items(b))
    if [k for k, _ in ia] != [k for k, _ in ib]:
        return ["the trees' paths differ"]
    return [k for (k, x), (_, y) in zip(ia, ib) if not torch.equal(x.cpu(), y.cpu())]


def deploy_convert(vdir, out):
    """Part (a): ``cli.convert --reverse`` to a reference-format dir and
    ``cli.convert --pth`` back into a port version dir, whose trees must
    equal the original's bit for bit."""
    import torch

    from mggan_tpu_torch.cli import convert as convert_cli
    from mggan_tpu_torch.utils.pytree import tree_leaves

    t0 = time.perf_counter()
    ref = convert_cli.main(["--reverse", "--version_dir", str(vdir), "--out_dir",
                            str(out / "reference"), "--device", "cuda"])
    pth = ref / "checkpoints" / "checkpoint_best.pth"
    conv = convert_cli.main(["--pth", str(pth), "--out_dir", str(out / "converted"),
                             "--device", "cuda"])
    secs = time.perf_counter() - t0
    load = lambda d: torch.load(d / "checkpoints" / "checkpoint_best", map_location="cpu",
                                weights_only=True)
    a, b = load(vdir), load(conv)
    bad = {k: tree_mismatches(a[k], b[k]) for k in DEPLOY_STATE}
    leaves = sum(len(tree_leaves(a[k])) for k in DEPLOY_STATE)
    print(f"  cli.convert --reverse -> {pth.stat().st_size / 1e6:.2f} MB .pth, then "
          f"cli.convert --pth -> a port version dir, {secs:.2f} s: {leaves} leaves of the "
          f"parameters and BN statistics equal bit for bit: {not any(bad.values())}")
    check(not any(bad.values()), f"convert round trip differs: {bad}")
    return conv, {"seconds": secs, "leaves": leaves, "pth_mb": pth.stat().st_size / 1e6}


def deploy_artifacts(conv, out, rng):
    """Part (b): ``cli.export`` of ``sampling`` and ``expected`` at buckets
    1, 8 and 64 as ``torch.export`` programs; each program's graph holds
    the kernel's operator (``mggan.decode_select``, K1, or
    ``mggan.decode_all_fwd``, K2) and a call of the loaded artifact launches
    it; ``from_artifact`` equal to ``from_version_dir`` bit for bit at each
    bucket; one 8-scene request with injected draws on the artifact loaded
    on the card and moved to the CPU; export seconds per bucket, MB, and the
    artifact call's p50 beside the live ``predict_batch``'s at each
    bucket."""
    import numpy as np

    from mggan_tpu_torch.cli import export as export_cli
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.serving.runtime import ServingModel

    ops = {"sampling": ("mggan.decode_select.default", "decode_select"),
           "expected": ("mggan.decode_all_fwd.default", "decode_all_fwd")}
    models, res = {}, {}
    for strat in ("sampling", "expected"):
        path = out / f"{strat}.mgtorch"
        t0 = time.perf_counter()
        export_s = export_cli.main(["--model_dir", str(conv), "--out", str(path), "--strategy",
                                    strat, "--scenes", ",".join(map(str, BUCKETS)), "--peds",
                                    str(PEDS), "--num", str(NUM), "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        header = export_cli.read_artifact(path)[0]
        t0 = time.perf_counter()
        art = models[strat] = ServingModel.from_artifact(path, device="cuda")
        load_s = time.perf_counter() - t0
        live = ServingModel.from_version_dir(conv, strat, scenes=BUCKETS[-1], peds=PEDS,
                                             num=NUM, scene_buckets=BUCKETS, device="cuda")
        check(art.buckets == BUCKETS and (art.peds, art.num) == (PEDS, NUM),
              f"{strat} artifact: buckets {art.buckets}, peds {art.peds}, num {art.num}")
        op, kernel = ops[strat]
        for b in BUCKETS:
            targets = [str(n.target) for n in art._calls[b].program.graph.nodes]
            check(targets.count(op) == 1, f"{strat} program at {b} scenes holds "
                                          f"{targets.count(op)} {op} nodes")
        p50, live_p50 = {}, {}
        for b in BUCKETS:
            obs, pat = make_request(rng, b)
            for seed in (0, 1):
                before = kernels.launches[kernel]
                got = art.predict_batch(obs, pat, seed=seed)
                check(kernels.launches[kernel] == before + 1,
                      f"{strat} artifact at {b} scenes launched {kernel} "
                      f"{kernels.launches[kernel] - before} times")
                want = live.predict_batch(obs, pat, seed=seed)
                check(all(np.array_equal(x, y) for x, y in zip(got, want)),
                      f"{strat} artifact differs from the live model at {b} scenes")
                check(all(np.isfinite(x).all() and x.shape == (NUM, len(o), 12, 2)
                          for x, o in zip(got, obs)), f"{strat} artifact: bad predictions")
            times = {"artifact": [], "live": []}
            for i in range(DEPLOY_TIMED + 2):  # two warm-up calls each, then alternate
                for name, model in (("artifact", art), ("live", live)):
                    t0 = time.perf_counter()
                    model.predict_batch(obs, pat, seed=i)  # ends in the copy to the host
                    times[name].append((time.perf_counter() - t0) * 1e3)
            p50[b] = float(np.percentile(times["artifact"][2:], 50))
            live_p50[b] = float(np.percentile(times["live"][2:], 50))
        cfg = header["config"]
        obs, pat = make_request(rng, 8)
        s = art.pad_request(obs, pat)[0].shape[0]
        draws = {"z": rng.randn(NUM, s, 1, cfg["noise_dim"]).astype(np.float32)}
        if strat == "sampling":
            draws["uniforms"] = np.clip(rng.uniform(0, 1, (NUM, s, PEDS, cfg["num_gens"])),
                                        1e-20, 1 - 2**-24).astype(np.float32)
        cpu = ServingModel.from_artifact(path, device="cpu")
        on_card = art.predict_batch(obs, pat, draws=draws)
        on_cpu = cpu.predict_batch(obs, pat, draws=draws)
        err = max(float(np.abs(x - y).max()) for x, y in zip(on_card, on_cpu))
        res[strat] = {"export_s": cli_s, "export_s_per_bucket": export_s, "load_s": load_s,
                      "mb": path.stat().st_size / 1e6, "card_vs_cpu_max_abs_err": err,
                      "artifact_p50_ms": p50, "live_p50_ms": live_p50, "operator": op}
        print(f"  {strat}: cli.export {cli_s:.2f} s (torch.export + save per bucket "
              + ", ".join(f"{b}: {export_s[b]:.2f} s" for b in BUCKETS)
              + f"), {res[strat]['mb']:.3f} MB, loaded in {load_s:.2f} s; each bucket's "
              f"program holds one {op} node and its call launches {kernel} once; "
              f"from_artifact equal to from_version_dir bit for bit at 1, 8 and 64 scenes "
              f"(2 seeds each); 8 scenes with injected draws, card vs CPU {err:.3e} (atol "
              f"{E2E_ATOL:g})")
        print(f"  {strat}: predict_batch p50 over {DEPLOY_TIMED} calls, artifact vs live: "
              + ", ".join(f"{b} scenes {p50[b]:.3f} / {live_p50[b]:.3f} ms" for b in BUCKETS))
        check(err <= E2E_ATOL, f"{strat} artifact card vs CPU {err:.3e} > {E2E_ATOL}")
    return models, res


def http_json(port, path, payload=None):
    """``(status, JSON body)`` of a GET (``payload`` None) or a POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def deploy_http(model, ds):
    """Part (c): the server over the ``sampling`` artifact with zara1's
    scene registered; one request against the direct call, the overhead of
    one-scene requests, 400 and 404, then DEPLOY_CLIENTS client threads of
    DEPLOY_REQUESTS single-scene requests each."""
    import threading

    import numpy as np

    from mggan_tpu_torch.serving.runtime import fold_seeds
    from mggan_tpu_torch.serving.server import start_background

    scene = ds.scene_names[0]
    small, ppm = ds.images[scene]["small"], ds.px_per_meter
    windows = [t[:, :8].copy() for t in ds.trajectories if len(t) <= PEDS]
    check(len(windows) >= 16, f"zara1 test: {len(windows)} windows of up to {PEDS} peds")
    server, batcher, port = start_background(model)
    try:
        code, body = http_json(port, "/v1/scenes", {"name": scene, "image": small.tolist(),
                                                    "px_per_meter": ppm})
        check(code == 200 and body["scenes"] == [scene], f"/v1/scenes: {code} {body}")
        obs = windows[0]
        code, body = http_json(port, "/v1/predict", {"scenes": [obs.tolist()],
                                                     "scene_ids": [scene], "seed": 5})
        got = np.asarray(body["predictions"][0], np.float32)
        want = model.predict_batch([obs], [model.crop_patches(scene, obs)],
                                   seed=fold_seeds([5]))[0]
        check(code == 200 and np.array_equal(got, want),
              "the HTTP answer differs from predict_batch on crop_patches and the folded seed")
        pat = [model.crop_patches(scene, obs)]
        direct, over_http = [], []
        for i in range(DEPLOY_SEQUENTIAL):
            t0 = time.perf_counter()
            model.predict_batch([obs], pat, seed=i)
            direct.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            code, _ = http_json(port, "/v1/predict", {"scenes": [obs.tolist()],
                                                      "scene_ids": [scene], "seed": i})
            over_http.append((time.perf_counter() - t0) * 1e3)
            check(code == 200, f"sequential request {i}: {code}")
        # the host's JSON work on one answer: the server's tolist + dumps,
        # the client's loads + asarray
        answer = model.predict_batch([obs], pat, seed=0)
        t0 = time.perf_counter()
        for _ in range(DEPLOY_SEQUENTIAL):
            text = json.dumps({"predictions": [a.tolist() for a in answer]})
        dumps_ms = (time.perf_counter() - t0) * 1e3 / DEPLOY_SEQUENTIAL
        t0 = time.perf_counter()
        for _ in range(DEPLOY_SEQUENTIAL):
            np.asarray(json.loads(text)["predictions"][0], np.float32)
        loads_ms = (time.perf_counter() - t0) * 1e3 / DEPLOY_SEQUENTIAL
        codes = {"missing scene": http_json(port, "/v1/predict", {"scenes": [obs.tolist()]}),
                 "unknown path": http_json(port, "/v1/nope", {}),
                 "unknown GET": http_json(port, "/v1/nope")}
        check(codes["missing scene"][0] == 400
              and "MissingSceneInputError" in codes["missing scene"][1]["error"],
              f"missing scene: {codes['missing scene']}")
        check(codes["unknown path"][0] == 404 and codes["unknown GET"][0] == 404,
              f"unknown path: {codes['unknown path'][0]}, {codes['unknown GET'][0]}")

        b0, r0, e0 = batcher.batches_run, batcher.requests_served, batcher.early_dispatches
        latency, errors = [], []

        def client(c):
            for j in range(DEPLOY_REQUESTS):
                i = c * DEPLOY_REQUESTS + j
                w = windows[i % len(windows)]
                t0 = time.perf_counter()
                code, body = http_json(port, "/v1/predict", {
                    "scenes": [w.tolist()], "scene_ids": [scene], "seed": i})
                latency.append((time.perf_counter() - t0) * 1e3)
                p = np.asarray(body.get("predictions", [[]])[0], np.float32)
                if code != 200 or p.shape != (NUM, len(w), 12, 2) or not np.isfinite(p).all():
                    errors.append((i, code, p.shape))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(DEPLOY_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "HTTP clients still running after 300 s")
        n = DEPLOY_CLIENTS * DEPLOY_REQUESTS
        check(not errors and len(latency) == n, f"HTTP clients: {len(latency)} answers, "
                                                f"errors {errors[:4]}")
        batches = batcher.batches_run - b0
        served = batcher.requests_served - r0
        check(served == n, f"the batcher served {served} of {n} requests")
        meta = http_json(port, "/v1/metadata")[1]
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    q = lambda xs, p: float(np.percentile(xs, p))
    res = {"direct_bucket1_p50_ms": q(direct, 50), "http_one_scene_p50_ms": q(over_http, 50),
           "http_overhead_ms": q(over_http, 50) - q(direct, 50),
           "answer_json_bytes": len(text), "answer_dumps_ms": dumps_ms,
           "answer_loads_ms": loads_ms,
           "clients": DEPLOY_CLIENTS, "requests": n, "p50_ms": q(latency, 50),
           "p99_ms": q(latency, 99), "requests_per_s": n / wall, "wall_s": wall,
           "batches_run": batches, "mean_batch": served / batches,
           "early_dispatches": batcher.early_dispatches - e0,
           "metadata_keys": sorted(meta)}
    print(f"  HTTP: one zara1 window ({len(obs)} peds) with scene_ids equal to predict_batch on "
          f"crop_patches and the folded seed bit for bit; {DEPLOY_SEQUENTIAL} sequential "
          f"one-scene requests p50 {res['http_one_scene_p50_ms']:.3f} ms against "
          f"predict_batch's {res['direct_bucket1_p50_ms']:.3f} ms at bucket 1 (overhead "
          f"{res['http_overhead_ms']:.3f} ms; of it the answer's JSON, {len(text)} bytes: "
          f"tolist + dumps {dumps_ms:.3f} ms, loads + asarray {loads_ms:.3f} ms on the host); "
          f"400 without scene input, 404 for an unknown path")
    print(f"  HTTP under {DEPLOY_CLIENTS} clients x {DEPLOY_REQUESTS} single-scene requests: "
          f"p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms, "
          f"{res['requests_per_s']:.1f} requests/s, batches_run {batches}, mean batch "
          f"{res['mean_batch']:.2f} scenes, early_dispatches {res['early_dispatches']}; "
          f"every answer finite and of its shape")
    return res


def deploy_offline(root, conv, ds, out):
    """Part (d): ``cli.serve --input`` on the zara1 test txt with zara1's
    small image as ``--scene_img``, over a ``sampling`` artifact of
    ``conv`` wide enough for the file's windows (an 8-frame window holds
    more peds than a 20-frame one): the npz holds load_obs_windows'
    windows, each equal to the direct call on its crop and its chunk's
    seed."""
    import cv2
    import numpy as np

    from mggan_tpu_torch.cli import export as export_cli
    from mggan_tpu_torch.cli import serve as serve_cli
    from mggan_tpu_torch.data.image_io import read_rgb
    from mggan_tpu_torch.serving.runtime import ServingModel

    scene = ds.scene_names[0]
    small, ppm = ds.images[scene]["small"], ds.px_per_meter
    png = out / "zara1_small.png"
    cv2.imwrite(str(png), cv2.cvtColor(small, cv2.COLOR_RGB2BGR))
    check(np.array_equal(read_rgb(png), small), "read_rgb of the small scene PNG differs")
    txt = root / "zara1" / "test" / "test_zara1.txt"
    scenes, ids = serve_cli.load_obs_windows(txt, "zara1")
    peds = max(max(len(s) for s in scenes), PEDS)
    path = out / "sampling_offline.mgtorch"
    export_cli.main(["--model_dir", str(conv), "--out", str(path), "--scenes",
                     str(BUCKETS[-1]), "--peds", str(peds), "--num", str(NUM),
                     "--device", "cuda"])
    t0 = time.perf_counter()
    npz = serve_cli.main(["--artifact", str(path), "--input", str(txt), "--txt_dataset",
                          "zara1", "--output", str(out / "zara1_test.npz"), "--scene_img",
                          str(png), "--px_per_meter", str(ppm), "--seed", str(SEED),
                          "--device", "cuda"])
    secs = time.perf_counter() - t0
    z = np.load(npz)
    n = len(scenes)
    check(sorted(z.files) == sorted([f"window_{i:05d}" for i in range(n)]
                                    + [f"ped_ids_{i:05d}" for i in range(n)]),
          f"npz keys: {sorted(z.files)[:4]} ... for {n} windows")
    model = ServingModel.from_artifact(path, device="cuda")
    model.register_scene(scene, small, ppm)
    for i in range(0, n, model.scenes):
        chunk = scenes[i:i + model.scenes]
        want = model.predict_batch(chunk, [model.crop_patches(scene, o) for o in chunk],
                                   seed=SEED + i)
        for j, w in enumerate(want):
            got = z[f"window_{i + j:05d}"]
            check(np.isfinite(got).all() and np.array_equal(got, w),
                  f"npz window {i + j} differs from the direct call or is not finite")
            check(np.array_equal(z[f"ped_ids_{i + j:05d}"], ids[i + j]),
                  f"npz ped ids of window {i + j}")
    agents = sum(len(s) for s in scenes)
    widest = max(len(s) for s in scenes)
    print(f"  cli.serve --input test_zara1.txt --scene_img (the small image, {ppm:g} px/m) "
          f"over an artifact at --peds {peds} (the file's 8-frame windows hold up to "
          f"{widest} peds): {n} windows, {agents} agents in {secs:.2f} s, equal to "
          f"load_obs_windows and to predict_batch on their crops bit for bit, every "
          f"prediction finite")
    return {"windows": n, "agents": agents, "max_peds": widest, "seconds": secs}


def phase_deployment(tmp, root, test_ds, version_dir):
    """Phase 17: the deployment surface on phase 15's mggan4_zara1 version
    dir (see the module note); launch counts read around (a)-(d) as path
    ``deployment``."""
    import numpy as np

    from mggan_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    out = tmp / "deployment"
    out.mkdir()
    rng = np.random.RandomState(SEED + 17)
    kernels.launches.clear()
    conv, convert = deploy_convert(version_dir, out)
    models, artifacts = deploy_artifacts(conv, out, rng)
    http = deploy_http(models["sampling"], test_ds)
    offline = deploy_offline(root, conv, test_ds, out)
    launches = dict(kernels.launches)
    print("deployment launches:", json.dumps(launches))
    for name in ("decode_select", "decode_all_fwd"):
        check(launches.get(name, 0) > 0, f"deployment: {name} launched {launches.get(name, 0)} "
                                         "times")
    warp = [n for n in WARP_KERNELS if launches.get(n)]
    check(not warp, f"deployment launched kept yardsticks {warp}")
    secs = time.perf_counter() - t_phase
    print(f"phase 17 (deployment, {card}): {secs:.1f} s")
    return {"card": card, "convert": convert, "artifacts": artifacts, "http": http,
            "offline": offline, "launches": launches, "seconds": secs}


# Phase 18: the rest of the single-device surface. The kernels' names in
# a profiler trace, the needles phase 13's kernel_device_ms finds them by
TRACE_NEEDLES = {"decode_select": "decode_select_tiled_kernel",
                 "decode_all_fwd": "decode_all_fwd_tiled_kernel",
                 "decode_all_bwd": "decode_all_bwd_kernel"}
PATH_KERNELS = ("decode_select", "decode_all_fwd", "decode_all_bwd")
SPLIT_STEPS = 5
ORBAX_FIXTURE = FIXTURES / "orbax_tiny" / "multi_generator" / "tiny" / "version_0"
SGAN_SCENES = 64
SGAN_CALLS = 5
SGAN_ATOL = 1e-4


def check_path_kernels(path, launches):
    """Every kernel of the train path (K1, K2, K3) launched on ``path``, and
    no kept yardstick."""
    for name in PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"{path}: {name} launched "
                                         f"{launches.get(name, 0)} times")
    warp = [n for n in WARP_KERNELS if launches.get(n)]
    check(not warp, f"{path} launched kept yardsticks {warp}")


def surface_split_step():
    """(a) The split step (``build_split_train_step``: the fused step behind
    JAX's split-step checks) at the flagship batch, one warm-up and
    SPLIT_STEPS timed steps (host clock, each ending in a synchronize):
    finite metrics, the p50 and the K1/K2/K3 launches a step, those of
    phase 5's step (path ``split_step``)."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_split_train_step, make_draws

    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    g_pack, d_pack = construct_gan(cfg, seed=SEED, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(TRAIN_SCENES, SEED).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    step = build_split_train_step(cfg, g_pack[2], d_pack[2])
    kernels.launches.clear()
    state, _ = step(state, batch, make_draws(gen, cfg, TRAIN_SCENES, PEDS))
    torch.cuda.synchronize()
    before, times = dict(kernels.launches), []
    for _ in range(SPLIT_STEPS):
        dr = make_draws(gen, cfg, TRAIN_SCENES, PEDS)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, dr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    check_path_kernels("split_step", launches)
    per_step = {k: (v - before.get(k, 0)) / SPLIT_STEPS
                for k, v in launches.items() if v - before.get(k, 0)}
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    check(not bad, f"split step: non-finite metrics {bad}")
    due = {"decode_select": 1, "decode_all_fwd": 2, "decode_all_bwd": 1}  # phase 5's
    check({k: per_step.get(k, 0) for k in due} == due,
          f"split step launches a step {per_step}, {due} due")
    p50 = float(np.median(times))
    print(f"  split step, {TRAIN_SCENES} x {PEDS}, K={NUM}: p50 {p50:.3f} ms of {SPLIT_STEPS} "
          f"steps; launches a step {json.dumps(per_step)}")
    return {"p50_ms": p50, "times_ms": times, "launches_per_step": per_step,
            "launches": launches}


def zara1_config(log_dir, root, **kw):
    """``mggan4_zara1``'s flags through the train CLI's parser, 1 epoch."""
    from mggan_tpu_torch.config import config_from_args, get_parser
    from mggan_tpu_torch.configs import BENCHMARK_CONFIGS

    flags = {**BENCHMARK_CONFIGS["mggan4_zara1"], "epochs": 1, "val_every": 1, "augment": 1,
             "patch_bank": 1, "seed": SEED, "log_dir": log_dir, "data_root": root, **kw}
    return config_from_args(get_parser().parse_args(
        [x for k, v in flags.items() for x in (f"--{k}", str(v))]))


def trace_kernel_records(trace_path):
    """The kernel records of a Chrome trace whose names hold each of
    TRACE_NEEDLES' needles: name -> count."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    kernels_ = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {name: sum(needle in k for k in kernels_) for name, needle in TRACE_NEEDLES.items()}


def surface_profiled_loop(tmp, root):
    """(b) A Trainer with ``profile_dir`` on phase 15's zara1 files, 1
    epoch (path ``profiled_loop``): the trace written, K1, K2 and K3's
    records in it, and the traced step's wall time (host clock, ending in a
    synchronize) against the median untraced step of the epoch."""
    import numpy as np
    import torch

    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    prof_dir = tmp / "profile"
    cfg = zara1_config(tmp / "logs_profiled", root, name="profiled", profile_dir=prof_dir)
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, version=0, config=cfg,
                              tensorboard=False)
    trainer = Trainer(cfg, writer, device="cuda")
    step, times = trainer.train_step, []

    def timed(*args):
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3,
                      torch.autograd.profiler._is_profiler_enabled))
        return out

    trainer.train_step = timed
    kernels.launches.clear()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check_path_kernels("profiled_loop", launches)
    traces = sorted(prof_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"profiled_loop: {len(traces)} trace files in {prof_dir}")
    traced = [i for i, (_, on) in enumerate(times) if on]
    check(traced == [1], f"profiled_loop: traced steps {traced}, the second one due")
    records = trace_kernel_records(traces[0])
    check(all(records.values()), f"profiled_loop: kernel records in the trace {records}")
    untraced = float(np.median([ms for ms, on in times if not on]))
    traced_ms = times[1][0]
    mb = traces[0].stat().st_size / 2**20
    print(f"  profiled Trainer, mggan4_zara1, 1 epoch of {len(times)} steps in {seconds:.2f} s: "
          f"trace {traces[0].name} ({mb:.1f} MiB), kernel records {json.dumps(records)}; "
          f"traced step {traced_ms:.3f} ms against the median untraced {untraced:.3f} ms")
    return {"steps": len(times), "seconds": seconds, "trace_mib": mb,
            "kernel_records": records, "traced_step_ms": traced_ms,
            "untraced_median_ms": untraced, "launches": launches}


def surface_sweep(tmp, root):
    """(c) ``cli.sweep --grid '{"num_gens": [2, 4]}'`` with mggan4_zara1's
    flags, 1 epoch a point (path ``sweep``): both version dirs hold a finite
    metrics.jsonl; seconds per point (host clock around each point's
    ``train``)."""
    import numpy as np
    import torch

    from mggan_tpu_torch.cli import sweep
    from mggan_tpu_torch.configs import BENCHMARK_CONFIGS
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.training.loop import Trainer

    flags = {**BENCHMARK_CONFIGS["mggan4_zara1"], "epochs": 1, "val_every": 1, "augment": 1,
             "patch_bank": 1, "seed": SEED, "log_dir": tmp / "logs_sweep", "data_root": root,
             "name": "sweep", "device": "cuda"}
    argv = ["--grid", json.dumps({"num_gens": [2, 4]})]
    argv += [x for k, v in flags.items() if k != "num_gens" for x in (f"--{k}", str(v))]
    print("  python -m mggan_tpu_torch.cli.sweep " + " ".join(argv))
    train, seconds = Trainer.train, []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = train(self, *a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    kernels.launches.clear()
    Trainer.train = timed
    try:
        trainers = sweep.main(argv)
    finally:
        Trainer.train = train
    launches = dict(kernels.launches)
    check_path_kernels("sweep", launches)
    names = sorted(p.name for p in (tmp / "logs_sweep" / "multi_generator").iterdir())
    check(names == ["sweep_num_gens=2", "sweep_num_gens=4"], f"sweep dirs {names}")
    points = {}
    for t, s in zip(trainers, seconds):
        lines = epoch_lines(t.writer)
        bad = [k for m in lines for k, v in m.items() if not np.isfinite(v)]
        check(len(lines) == 1 and not bad, f"sweep {t.config.name}: {len(lines)} epochs, "
                                           f"non-finite {bad[:4]}")
        points[t.config.name] = {"seconds": s, "steps": int(t.state.step),
                                 "val_ade20": lines[0]["val/ADE k=20"]}
    print(f"  sweep over num_gens 2, 4: {json.dumps(points)}")
    return {"points": points, "launches": launches}


class FixedDraws:
    """The Trainer's draws from CPU generators (``SeededDraws``' rule for
    the augmentation and validation, one CPU generator for the steps), so
    a card and a CPU Trainer get the same numbers."""

    def __init__(self, config, seed):
        import torch

        from mggan_tpu_torch.training.loop import SeededDraws

        self.seeded = SeededDraws(config, "cpu")
        self.config = config
        self.gen = torch.Generator().manual_seed(seed)

    def aug(self, epoch, i, s):
        return self.seeded.aug(epoch, i, s)

    def step(self, state, s, p):
        from mggan_tpu_torch.training.steps import make_draws

        return make_draws(self.gen, self.config, s, p, state.g_params, state.d_params)

    def val(self, i, s, p, num):
        return self.seeded.val(i, s, p, num)


def surface_orbax_resume(tmp):
    """(d) The committed converted JAX checkpoint
    (``mggan_tpu_torch/tools/fixtures/orbax_tiny``) resumed for its second
    epoch on the card (path ``orbax_resume``) and on the CPU with the same
    draws; the two states under phase 16's rule (``train_state_diffs``)."""
    import shutil

    import torch

    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.tools.state_compare import train_state_diffs
    from mggan_tpu_torch.training.loop import Trainer

    out, launches = {}, {}
    for i, dev in enumerate(("cuda", "cpu")):
        vdir = tmp / f"orbax_{i}_{dev}" / "multi_generator" / "tiny" / "version_0"
        shutil.copytree(ORBAX_FIXTURE, vdir)
        trainer, cfg = Trainer.load_from_path(vdir, "latest", device=dev)
        check((trainer.state.step, trainer.state.epoch) == (3, 1),
              f"orbax fixture at step {trainer.state.step}, epoch {trainer.state.epoch}")
        trainer.draws = FixedDraws(cfg, SEED)
        kernels.launches.clear()
        t0 = time.perf_counter()
        trainer.train()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
        out[dev] = (trainer, time.perf_counter() - t0)
    check_path_kernels("orbax_resume", launches)
    (card, card_s), (cpu, cpu_s) = out["cuda"], out["cpu"]
    check(card.state.epoch == cpu.state.epoch == 2, "orbax_resume: epoch 2 not trained")
    diffs = train_state_diffs(card.state, cpu.state, card.config, TRAIN_ATOL, NOISE_LEAVES)
    bad = diffs.pop("bad")
    m_card, m_cpu = epoch_lines(card.writer)[-1], epoch_lines(cpu.writer)[-1]
    metric_diff = max(abs(m_card[k] - v) for k, v in m_cpu.items() if not k.startswith("perf/"))
    print(f"  orbax_resume: the converted checkpoint's epoch 2 ({card.state.step - 3} steps, "
          f"validation) on the card {card_s:.2f} s, on the CPU {cpu_s:.2f} s; card vs CPU "
          f"parameters {diffs['param_max_abs_diff']:.3e} (atol {TRAIN_ATOL:g}), float-noise "
          f"elements {diffs['noise_max_abs_diff']:.3e} (2*lr per update), their first moments "
          f"{diffs['noise_grad_max_rel_diff']:.3e} of the module's rms; epoch metrics max abs "
          f"diff {metric_diff:.3e} (reported); launches {json.dumps(launches)}")
    check(not bad, f"orbax_resume card vs CPU beyond tolerance {bad[:4]}")
    return {"card_s": card_s, "cpu_s": cpu_s, "steps": card.state.step - 3,
            "metric_max_abs_diff": metric_diff, **diffs, "launches": launches}


def surface_sgan():
    """(e) The legacy Social-GAN at its JAX defaults on SGAN_SCENES x PEDS:
    ``generator_apply`` for pool_net and spool with ``pool_every_timestep``
    off and on (on needs noise_dim=0, the one setting where the JAX model
    runs it), ``discriminator_apply`` local and global; card vs CPU on the
    same weights and noise within SGAN_ATOL, the generator's p50 of
    SGAN_CALLS calls; no kernel of the repo launches."""
    import numpy as np
    import torch

    from mggan_tpu_torch.models import social_gan_legacy as sgan
    from mggan_tpu_torch.models.factory import tree_to
    from mggan_tpu_torch.ops import kernels

    data = train_batch(SGAN_SCENES, SEED + 18)
    xy, mask = data["xy"], data["ped_mask"]
    before = dict(kernels.launches)
    out = {}
    gen_cases = [(f"generator {pool}, pool_every_timestep {pet}",
                  sgan.SGANSpec(pooling_type=pool, pool_every_timestep=pet,
                                noise_dim=0 if pet else 8))
                 for pool in ("pool_net", "spool") for pet in (False, True)]
    for label, spec in gen_cases + [(f"discriminator {d}", sgan.SGANSpec(d_type=d))
                                    for d in ("local", "global")]:
        is_gen = label.startswith("generator")
        params = (sgan.generator_init if is_gen else sgan.discriminator_init)(
            torch.Generator().manual_seed(SEED), spec)
        if is_gen:
            z = torch.randn((SGAN_SCENES, 1, spec.noise_dim),
                            generator=torch.Generator().manual_seed(SEED))
            args = (xy[:, :, :8], np.diff(xy[:, :, :8], axis=2), mask)
            fn = lambda p, a, dev: sgan.generator_apply(p, spec, *a, z=z.to(dev))
        else:
            args = (xy, np.diff(xy, axis=2), mask)
            fn = lambda p, a, dev: (sgan.discriminator_apply(p, spec, *a),)
        res = {}
        for dev in ("cuda", "cpu"):
            a = tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev) for x in args)
            res[dev] = [t.cpu() for t in fn(tree_to(params, dev), a, dev)]
            if dev == "cuda":
                on_card = tree_to(params, "cuda")
                ms = []
                for _ in range(SGAN_CALLS):
                    t0 = time.perf_counter()
                    fn(on_card, a, "cuda")
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
        err = max(float((g - c).abs().max()) for g, c in zip(res["cuda"], res["cpu"]))
        finite = all(bool(torch.isfinite(t).all()) for t in res["cuda"])
        out[label] = {"max_abs_err": err, "p50_ms": float(np.median(ms)), "times_ms": ms}
        print(f"  legacy Social-GAN {label}, {SGAN_SCENES} x {PEDS}: card vs CPU {err:.3e} "
              f"(atol {SGAN_ATOL:g}), p50 {out[label]['p50_ms']:.3f} ms of {SGAN_CALLS} calls")
        check(finite and err <= SGAN_ATOL, f"legacy Social-GAN {label}: card vs CPU {err:.3e}")
    check(dict(kernels.launches) == before,
          "the legacy Social-GAN launched a kernel of the repo")
    print("  the legacy Social-GAN launches none of the repo's kernels (plain PyTorch, as it "
          "was plain XLA in JAX)")
    return out


def phase_surface(tmp, root, flagship_p50_ms):
    """Phase 18: the rest of the single-device surface (see the module
    note), with phase 15's zara1 files under ``root``; the launch counts
    of paths split_step, profiled_loop, sweep and orbax_resume."""
    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    tmp = tmp / "surface"
    tmp.mkdir()
    parts = {}
    for name, fn in (("split_step", surface_split_step),
                     ("profiled_loop", lambda: surface_profiled_loop(tmp, root)),
                     ("sweep", lambda: surface_sweep(tmp, root)),
                     ("orbax_resume", lambda: surface_orbax_resume(tmp)),
                     ("legacy_sgan", surface_sgan)):
        t0 = time.perf_counter()
        parts[name] = fn()
        print(f"phase 18 {name}: {time.perf_counter() - t0:.1f} s")
    launches = {k: parts[k].pop("launches") for k in ("split_step", "profiled_loop", "sweep",
                                                      "orbax_resume")}
    secs = time.perf_counter() - t_phase
    print(f"phase 18 (surface, {card}): {secs:.1f} s; phase 5's flagship step p50 "
          f"{flagship_p50_ms:.3f} ms; launches {json.dumps(launches)}")
    return {"card": card, **parts, "launches": launches, "seconds": secs}


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


# Phase 19: data and generator parallelism (mggan_tpu_torch/parallel). The
# ranks are child processes of this script on the one card under gloo
# (pod.backend_for: more ranks than cards), joined through a file:// store
# (a, d) or the launcher that ships with torch (b, c, e); every child has a
# timeout, and a rank that fails or times out fails the phase.
DP_RANKS = 2  # (a): the flagship step on 2 ranks
DP_STEPS = 5
DP_CLI_RANKS = 8  # (b): mggan_dp_eth as configured, dp=8
POD_NODES, POD_LOCAL = 2, 2  # (c): 2 simulated nodes x 2 ranks
GP_DP, GP = 2, 2  # (d): the flagship step on dp=2 x gp=2 ranks, 2 generators each
GP_CLI = 2  # (e): cli.train --dp 1 --gp 2
RANK_TIMEOUT_S = 240
# (f): K3's weight grads summed over row slices against the full launch's,
# each leaf's max abs difference over its max |grad| (summation order only)
SLICE_WGRAD_REL = 1e-5
# (a): tests/test_parallel.py::assert_steps_match, on the first step
DP_METRIC_RTOL, DP_METRIC_ATOL = 1e-5, 1e-7
DP_MOMENT_RTOL, DP_MOMENT_ATOL = 1e-4, 1e-6
DP_PARAM_ATOL = 2e-3
DP_DEVICE = "cuda"


def _state_trees(state):
    """A ``TrainState``'s tensors on the host, and its Adam counts."""
    from mggan_tpu_torch.models.factory import tree_to

    keys = ("g_params", "g_state", "d_params", "d_state")
    out = {k: tree_to(getattr(state, k), "cpu") for k in keys}
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        out[name] = {"count": opt.count, "mu": tree_to(opt.mu, "cpu"),
                     "nu": tree_to(opt.nu, "cpu")}
    return out


def _as_state(trees):
    from mggan_tpu_torch.training.state import AdamState, TrainState

    opt = lambda o: AdamState(o["count"], o["mu"], o["nu"])
    return TrainState(g_params=trees["g_params"], g_state=trees["g_state"],
                      d_params=trees["d_params"], d_state=trees["d_state"],
                      g_opt=opt(trees["g_opt"]), d_opt=opt(trees["d_opt"]), generator=None)


def _params_digest(state):
    """sha256 of every parameter, BN statistic and Adam moment, bit for bit."""
    import hashlib

    from mggan_tpu_torch.utils.pytree import tree_leaves

    h = hashlib.sha256()
    for tree in (state.g_params, state.g_state, state.d_params, state.d_state, state.g_opt.mu,
                 state.g_opt.nu, state.d_opt.mu, state.d_opt.nu):
        for x in tree_leaves(tree):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _moment_diffs(a, b):
    """Max abs difference of two states' Adam moments (``_state_trees``) and
    the leaves beyond (a)'s tolerance: (opt, moment, path, elements beyond,
    worst diff, value)."""
    from mggan_tpu_torch.utils.pytree import tree_items

    bad, err = [], 0.0
    for name in ("g_opt", "d_opt"):
        for which in ("mu", "nu"):
            flat = dict(tree_items(a[name][which]))
            for path, w in tree_items(b[name][which]):
                d = (flat[path] - w).abs()
                err = max(err, float(d.max()))
                beyond = d > DP_MOMENT_ATOL + DP_MOMENT_RTOL * w.abs()
                if bool(beyond.any()):
                    i = int((d - DP_MOMENT_RTOL * w.abs()).argmax())
                    bad.append((name, which, ".".join(path), int(beyond.sum()),
                                float(d.reshape(-1)[i]), float(w.reshape(-1)[i])))
    return err, bad


def compare_steps(got, want, cfg):
    """A data-parallel first step against the single-device one
    (``{"state": _state_trees, "metrics": floats}`` each), to (a)'s
    tolerances: ``metric_err`` and ``bad_metrics``, ``moment_err`` and
    ``moment_bad``, and ``diffs`` (``tools/state_compare.py``)."""
    from mggan_tpu_torch.tools.state_compare import train_state_diffs

    metric_err = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                     for k, v in want["metrics"].items())
    bad_metrics = [k for k, v in want["metrics"].items()
                   if abs(got["metrics"][k] - v) > DP_METRIC_ATOL + DP_METRIC_RTOL * abs(v)]
    moment_err, moment_bad = _moment_diffs(got["state"], want["state"])
    diffs = train_state_diffs(_as_state(got["state"]), _as_state(want["state"]), cfg,
                              DP_PARAM_ATOL, NOISE_LEAVES)
    return {"metric_err": metric_err, "bad_metrics": bad_metrics, "moment_err": moment_err,
            "moment_bad": moment_bad, "diffs": diffs}


def run_ranks(cmds, log_dir, env_of=None, timeout=RANK_TIMEOUT_S):
    """Start every command of ``cmds`` at once (stdout and stderr into
    ``log_dir``), wait for all; any nonzero exit or timeout fails, and every
    process is ended before this returns."""
    import os

    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        log = Path(log_dir) / f"proc{i}.log"
        env = dict(os.environ, **(env_of(i) if env_of else {}))
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, env=env,
                                          cwd=str(HERE)))
        logs.append(log)
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            print(log.read_text()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"{log.name}: exit {p.returncode} (timeout {timeout} s)")


def rank_dp_step(spec_dir, rank, n_dp=DP_RANKS, gp=1, out_dir=None):
    """(a) and (d), one rank of ``n_dp * gp``: the flagship step on this
    rank's rows of the spec's batch (and its ``num_gens / gp`` generators),
    one warm-up step and DP_STEPS timed ones with the spec's draws, into
    ``out_dir``; the states it reports are gathered (the single-device
    layout)."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.models.factory import build_d_spec, build_specs, tree_to
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.parallel import dp, pod
    from mggan_tpu_torch.parallel.mesh import make_mesh
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.utils.pytree import tree_leaves

    spec_dir = Path(spec_dir)
    out_dir = spec_dir if out_dir is None else Path(out_dir)
    spec = torch.load(spec_dir / "spec.pt", weights_only=False)
    pod.init_distributed(f"file://{out_dir / 'store'}", n_dp * gp, rank, device=DP_DEVICE,
                         timeout_s=RANK_TIMEOUT_S)
    grid = make_mesh(n_dp, gp, 1, DP_DEVICE)
    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    w = {k: tree_to(v, grid.device) for k, v in spec["weights"].items()}
    g_pack = (w["g_params"], w["g_state"], build_specs(cfg))
    d_pack = (w["d_params"], w["d_state"], build_d_spec(cfg))
    state = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    step, state = dp.make_parallel_train_step(cfg, g_pack[2], d_pack[2], grid, state)
    local = {k: torch.as_tensor(v, device=grid.device)
             for k, v in dp.shard_batch(grid, spec["batch"]).items()}
    sync = lambda: torch.cuda.synchronize() if grid.device.type == "cuda" else None
    kernels.launches.clear()
    state, metrics = step(state, local, spec["draws"][0])
    sync()
    first = {"state": _state_trees(dp.gather_generators(state, grid)),
             "metrics": {k: float(v) for k, v in metrics.items()}}
    before, times = dict(kernels.launches), []
    for i in range(1, DP_STEPS + 1):
        t0 = time.perf_counter()
        state, metrics = step(state, local, spec["draws"][i])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    per_step = {k: (v - before.get(k, 0)) / DP_STEPS for k, v in launches.items()}
    gens = tree_leaves(state.g_params["decoders"])[0].shape[0]
    digest = _params_digest(dp.gather_generators(state, grid))
    torch.save({"first": first, "times_ms": times, "launches": launches,
                "launches_per_step": per_step, "digest": digest, "gens": int(gens),
                "finite": all(bool(np.isfinite(float(v))) for v in metrics.values()),
                "rows": int(local["ped_mask"].shape[0]), "grid": grid.describe(),
                "backend": grid.backend, "world": pod.world_size()},
               out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def rank_cli(out_dir, argv):
    """(b), one rank under ``torch.distributed.run``: ``cli.train`` with
    ``argv``, its launch counts and version dir written to ``out_dir``."""
    import torch

    from mggan_tpu_torch.cli import train as train_cli
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.parallel import dp, pod

    kernels.launches.clear()
    model = train_cli.main(argv)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    (Path(out_dir) / f"rank{pod.rank()}.json").write_text(json.dumps({
        "rank": pod.rank(), "world": pod.world_size(), "launches": dict(kernels.launches),
        "dir": str(model.writer.dir), "steps": int(model.state.step),
        "digest": _params_digest(dp.gather_generators(model.state, model.grid)),
        "grid": model.grid.describe(), "backend": model.grid.backend}))
    pod.barrier()
    torch.distributed.destroy_process_group()


class FirstBatch:
    """A loader that stops after its first batch: (c)'s one Trainer step."""

    def __init__(self, loader):
        self.loader = loader

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        import itertools

        return itertools.islice(iter(self.loader), 1)


def rank_pod(out_dir, root):
    """(c), one rank of 2 simulated nodes under ``torch.distributed.run``:
    the node's window shard in lockstep, host assembly against the shard's
    bank, ``allreduce_sums``, a ``Trainer`` epoch on zara1, then a fresh
    ``Trainer``'s first step alone."""
    import numpy as np
    import torch

    from mggan_tpu_torch.data.loaders import get_dataloader
    from mggan_tpu_torch.eval.metrics import allreduce_sums
    from mggan_tpu_torch.ops import kernels
    from mggan_tpu_torch.parallel import pod
    from mggan_tpu_torch.parallel.mesh import make_mesh
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    pod.init_distributed(device=DP_DEVICE, timeout_s=RANK_TIMEOUT_S)
    world = pod.world_size()
    cfg = zara1_config(str(Path(out_dir) / "logs"), str(root), dp=world, name="pod_zara1")
    grid = make_mesh(world, 1, 1, DP_DEVICE)
    common = dict(batch_size=cfg.batch_size, data_root=str(root), shard_by_process=True,
                  device=grid.device, grid=grid)
    host = get_dataloader("zara1", "train", **common)
    banked = get_dataloader("zara1", "train", patch_bank=True, **common)
    check(banked.patch_bank is not None, "pod: the bank fell back to host assembly")
    equal, batches = True, 0
    for bh, bb in zip(host, banked):
        equal &= torch.equal(bb["big_patches"].cpu(), torch.from_numpy(bh["big_patches"]))
        batches += 1
    reduced = allreduce_sums({"ADE k=3": (float(pod.rank() + 1), 2.0), "FDE k=3": (10.0, 1.0)})
    kernels.launches.clear()
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device=DP_DEVICE).train()
    # a fresh Trainer's first step, for the comparison on the joined batch
    first = Trainer(cfg, writer, device=DP_DEVICE)
    values, perf = first.train_epoch(FirstBatch(first._loaders()[0]), 0)
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    if pod.rank() == 0:
        torch.save({"state": _state_trees(first.state), "agents": perf["agents"],
                    "metrics": {k: float(v[0]) for k, v in values.items()}},
                   Path(out_dir) / "first_step.pt")
    (Path(out_dir) / f"rank{pod.rank()}.json").write_text(json.dumps({
        "first_digest": _params_digest(first.state),
        "rank": pod.rank(), "node": pod.process_index(), "nodes": pod.process_count(),
        "num_batches": len(host), "batches": batches, "max_peds": int(host.max_peds),
        "shard_windows": host.num_windows(), "rows": host.rows, "bank_equal": bool(equal),
        "reduced": {k: list(v) for k, v in reduced.items()},
        "launches": dict(kernels.launches), "steps": int(tr.state.step),
        "best_val": float(tr.state.best_val), "dir": str(writer.dir),
        "digest": _params_digest(tr.state), "grid": grid.describe(), "backend": grid.backend,
        "finite": bool(np.isfinite(tr.state.best_val))}))
    pod.barrier()
    torch.distributed.destroy_process_group()


def rank_main(args):
    """A child of phase 19: ``--rank dp_step <dir> <rank> [<dp> <gp> <out
    dir>]``, ``--rank cli <dir> -- <cli.train argv>`` or ``--rank pod <dir>
    <data root>``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets it here
    torch.backends.cudnn.allow_tf32 = False
    kind = args[0]
    if kind == "dp_step":
        rank_dp_step(args[1], int(args[2]), *[int(a) for a in args[3:5]], *args[5:6])
    elif kind == "cli":
        rank_cli(args[1], args[args.index("--") + 1:])
    elif kind == "pod":
        rank_pod(args[1], args[2])
    else:
        raise SystemExit(f"unknown rank kind {kind}")
    return 0


def dp_step(tmp, single_p50_ms):
    """(a): the flagship step on DP_RANKS ranks against the single-device
    step on the same batch and draws, both run here."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.models.factory import construct_gan, tree_to
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws

    spec_dir = Path(tmp) / "dp_step"
    spec_dir.mkdir()
    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    g_pack, d_pack = construct_gan(cfg, seed=SEED, device=DP_DEVICE)
    batch = train_batch(TRAIN_SCENES, SEED)
    gen = torch.Generator(device=DP_DEVICE).manual_seed(SEED + 19)
    draws = [make_draws(gen, cfg, TRAIN_SCENES, PEDS) for _ in range(DP_STEPS + 1)]
    torch.save({"weights": {k: tree_to(v, "cpu") for k, v in zip(
        ("g_params", "g_state", "d_params", "d_state"), (*g_pack[:2], *d_pack[:2]))},
        "batch": batch, "draws": [{k: v.cpu() for k, v in d.items()} for d in draws]},
        spec_dir / "spec.pt")
    cmd = lambda r: [sys.executable, str(HERE / "chip_smoke.py"), "--rank", "dp_step",
                     str(spec_dir), str(r)]
    t0 = time.perf_counter()
    # launched by hand: the ranks find their node (this host) from the store
    run_ranks([cmd(r) for r in range(DP_RANKS)], spec_dir)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(spec_dir / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]

    # the single-device step, same weights, batch and draws
    state = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    step = build_train_step(cfg, g_pack[2], d_pack[2])
    dev_batch = {k: torch.as_tensor(v, device=DP_DEVICE) for k, v in batch.items()}
    state, metrics = step(state, dev_batch, draws[0])
    torch.cuda.synchronize()
    single_first = {"state": _state_trees(state),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
    times = []
    for i in range(1, DP_STEPS + 1):
        t0 = time.perf_counter()
        state, metrics = step(state, dev_batch, draws[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    cmp = compare_steps(ranks[0]["first"], single_first, cfg)
    metric_err, bad_metrics = cmp["metric_err"], cmp["bad_metrics"]
    moment_err, moment_bad, diffs = cmp["moment_err"], cmp["moment_bad"], cmp["diffs"]
    # the single-device step's own run-to-run difference (cuDNN's backward
    # is not deterministic), printed beside
    state2 = init_train_state(cfg, g_pack, d_pack, seed=SEED)
    state2, _ = step(state2, dev_batch, draws[0])
    torch.cuda.synchronize()
    floor_err, floor_bad = _moment_diffs(_state_trees(state2), single_first["state"])
    same = len({r["digest"] for r in ranks}) == 1
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    p50, dp_p50 = float(np.median(times)), float(np.median(ranks[0]["times_ms"]))
    for r in ranks:
        print(f"  dp_step {r['grid']}: {r['rows']} scene rows, p50 "
              f"{float(np.median(r['times_ms'])):.3f} ms, launches a step "
              f"{json.dumps(r['launches_per_step'])}")
    print(f"  dp_step first step against the single-device step: metrics max rel diff "
          f"{metric_err:.3e} (rtol {DP_METRIC_RTOL:g}), moments max abs diff "
          f"{moment_err:.3e} (rtol {DP_MOMENT_RTOL:g} / atol {DP_MOMENT_ATOL:g}; beyond: "
          f"{moment_bad[:4]}), parameters {diffs['param_max_abs_diff']:.3e} (atol "
          f"{DP_PARAM_ATOL:g}), {diffs['noise_elements']} float-noise elements "
          f"{diffs['noise_max_abs_diff']:.3e}; ranks bit for bit after {DP_STEPS + 1} steps: "
          f"{same}")
    print(f"  dp_step: the single-device first step run twice: moments max abs diff "
          f"{floor_err:.3e}, beyond tolerance {floor_bad[:4]}")
    print(f"  dp_step p50 over {DP_STEPS} steps, {DP_RANKS} ranks sharing one card (a record, "
          f"not a speed-up): {dp_p50:.3f} ms (rank 0) against the single-device step's "
          f"{p50:.3f} ms here (phase 5's {single_p50_ms:.3f} ms); ranks' wall {ranks_s:.1f} s")
    due = {"decode_select": 1, "decode_all_fwd": 2, "decode_all_bwd": 1}
    for i, r in enumerate(ranks):
        check(f"node 0 of 1, local rank {i} of {DP_RANKS}" in r["grid"],
              f"dp_step: rank {i} placed as {r['grid']}")
        check(r["rows"] == TRAIN_SCENES // DP_RANKS, f"dp_step: {r['rows']} rows on a rank")
        per = {k: r["launches_per_step"].get(k, 0) for k in due}
        check(per == due, f"dp_step rank: launches a step {per}, {due} due")
        check(r["finite"], "dp_step: non-finite metrics")
    check(not bad_metrics, f"dp_step: metrics beyond rtol {DP_METRIC_RTOL:g}: {bad_metrics}")
    check(not moment_bad, f"dp_step: Adam moments beyond tolerance: {moment_bad[:4]}")
    check(not diffs["bad"], f"dp_step: parameters: {diffs['bad'][:4]}")
    check(same, "dp_step: the ranks' states differ after the steps")
    return {"ranks": DP_RANKS, "backend": ranks[0]["backend"], "world": ranks[0]["world"],
            "grids": [r["grid"] for r in ranks], "dp_p50_ms": dp_p50,
            "dp_times_ms": ranks[0]["times_ms"], "single_p50_ms": p50, "single_times_ms": times,
            "metric_max_rel_diff": metric_err, "moment_max_abs_diff": moment_err,
            "single_rerun_moment_max_abs_diff": floor_err,
            "param_max_abs_diff": diffs["param_max_abs_diff"],
            "noise_max_abs_diff": diffs["noise_max_abs_diff"], "ranks_bit_identical": same,
            "launches_per_step": ranks[0]["launches_per_step"], "launches": launches,
            "seconds": ranks_s}, {"spec_dir": spec_dir, "first": single_first, "p50_ms": p50}


def gp_step(tmp, ref):
    """(d): the flagship step on GP_DP x GP ranks, each with its scene rows
    and num_gens / GP generators, against (a)'s single-device step on the
    same spec (``ref``: its spec dir, first step and p50), to (a)'s
    tolerances."""
    import numpy as np
    import torch

    from mggan_tpu_torch.config import flagship_config

    out = Path(tmp) / "gp_step"
    out.mkdir()
    world = GP_DP * GP
    cmd = lambda r: [sys.executable, str(HERE / "chip_smoke.py"), "--rank", "dp_step",
                     str(ref["spec_dir"]), str(r), str(GP_DP), str(GP), str(out)]
    t0 = time.perf_counter()
    run_ranks([cmd(r) for r in range(world)], out)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    cfg = flagship_config(num_samples=NUM, num_expectation_samples=1)
    cmp = compare_steps(ranks[0]["first"], ref["first"], cfg)
    diffs = cmp["diffs"]
    same = len({r["digest"] for r in ranks}) == 1
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    gp_p50 = float(np.median(ranks[0]["times_ms"]))
    for r in ranks:
        print(f"  gp_step {r['grid']}: {r['rows']} scene rows, {r['gens']} generators, p50 "
              f"{float(np.median(r['times_ms'])):.3f} ms, launches a step "
              f"{json.dumps(r['launches_per_step'])}")
    print(f"  gp_step first step (gathered) against the single-device step: metrics max rel "
          f"diff {cmp['metric_err']:.3e} (rtol {DP_METRIC_RTOL:g}), moments max abs diff "
          f"{cmp['moment_err']:.3e} (beyond: {cmp['moment_bad'][:4]}), parameters "
          f"{diffs['param_max_abs_diff']:.3e} (atol {DP_PARAM_ATOL:g}), "
          f"{diffs['noise_elements']} float-noise elements {diffs['noise_max_abs_diff']:.3e}; "
          f"gathered states bit for bit after {DP_STEPS + 1} steps: {same}")
    print(f"  gp_step p50 over {DP_STEPS} steps, {world} ranks (dp={GP_DP} x gp={GP}) sharing "
          f"one card (a record, not a scaling figure): {gp_p50:.3f} ms (rank 0) against the "
          f"single-device step's {ref['p50_ms']:.3f} ms in (a); ranks' wall {ranks_s:.1f} s")
    due = {"decode_select": 1, "decode_all_fwd": 2, "decode_all_bwd": 1}
    for i, r in enumerate(ranks):
        check(f"model rank {i % GP} of {GP}, node 0 of 1, local rank {i} of {world}"
              in r["grid"], f"gp_step: rank {i} placed as {r['grid']}")
        check(r["rows"] == TRAIN_SCENES // GP_DP, f"gp_step: {r['rows']} rows on a rank")
        check(r["gens"] == cfg.num_gens // GP, f"gp_step: {r['gens']} generators on a rank")
        per = {k: r["launches_per_step"].get(k, 0) for k in due}
        check(per == due, f"gp_step rank {i}: launches a step {per}, {due} due")
        check(r["finite"], "gp_step: non-finite metrics")
    check_path_kernels("gp_step", launches)
    check(not cmp["bad_metrics"], f"gp_step: metrics beyond rtol {DP_METRIC_RTOL:g}: "
                                  f"{cmp['bad_metrics']}")
    check(not cmp["moment_bad"], f"gp_step: Adam moments beyond tolerance: "
                                 f"{cmp['moment_bad'][:4]}")
    check(not diffs["bad"], f"gp_step: parameters: {diffs['bad'][:4]}")
    check(same, "gp_step: the ranks' gathered states differ after the steps")
    return {"ranks": world, "dp": GP_DP, "gp": GP, "backend": ranks[0]["backend"],
            "grids": [r["grid"] for r in ranks], "gens_per_rank": ranks[0]["gens"],
            "gp_p50_ms": gp_p50, "gp_times_ms": ranks[0]["times_ms"],
            "single_p50_ms": ref["p50_ms"], "metric_max_rel_diff": cmp["metric_err"],
            "moment_max_abs_diff": cmp["moment_err"],
            "param_max_abs_diff": diffs["param_max_abs_diff"],
            "noise_max_abs_diff": diffs["noise_max_abs_diff"], "ranks_bit_identical": same,
            "launches_per_step": ranks[0]["launches_per_step"], "launches": launches,
            "seconds": ranks_s}


def dp_cli(tmp, name="dp_cli", n_ranks=DP_CLI_RANKS, **flags_over):
    """(b): ``mggan_dp_eth`` as configured (dp=8, batch 256) on DP_CLI_RANKS
    ranks under ``torch.distributed.run`` on a BIWI eth split, 1 epoch; then
    ``cli.evaluate`` of its version dir in this process on the card. (e)
    runs the same with ``flags_over`` (``dp=1, gp=2`` on GP_CLI ranks) as
    path ``name``."""
    import csv

    import numpy as np
    import torch

    from mggan_tpu_torch.cli import evaluate as evaluate_cli
    from mggan_tpu_torch.configs import BENCHMARK_CONFIGS
    from mggan_tpu_torch.ops import kernels

    out = Path(tmp) / name
    out.mkdir()
    root = out / "data"
    write_biwi(root, "eth", ETH_FRAMES, np.random.RandomState(SEED + 16))
    flags = {**BENCHMARK_CONFIGS["mggan_dp_eth"], "epochs": 1, "val_every": 1, "seed": SEED,
             **flags_over}
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    argv += ["--name", "mggan_dp_eth", "--log_dir", str(out / "logs"), "--data_root", str(root),
             "--device", DP_DEVICE]
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(n_ranks), str(HERE / "chip_smoke.py"), "--rank",
              "cli", str(out), "--"]
    print("  python -m torch.distributed.run --standalone --nproc_per_node "
          f"{n_ranks} -m mggan_tpu_torch.cli.train " + " ".join(argv))
    t0 = time.perf_counter()
    run_ranks([launch + argv], out)
    train_s = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n_ranks)]
    dirs = {r["dir"] for r in ranks}
    check(len(dirs) == 1, f"{name}: {len(dirs)} version dirs named by the ranks")
    vdir = Path(dirs.pop())
    listed = sorted((out / "logs").glob("*/*/version_*"))
    check(listed == [vdir], f"{name}: version dirs on disk {listed}")
    check(len({r["digest"] for r in ranks}) == 1, f"{name}: the ranks' states differ")
    lines = [json.loads(line) for line in (vdir / "metrics.jsonl").read_text().splitlines()]
    check(len(lines) == 1, f"{name}: {len(lines)} epochs logged")
    bad = [k for k, v in lines[0].items() if not np.isfinite(v)]
    check(not bad, f"{name}: non-finite epoch metrics {bad}")
    check((vdir / "checkpoints" / "checkpoint_best").is_file(), f"{name}: no checkpoint_best")
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    kernels.launches.clear()
    t0 = time.perf_counter()
    csv_path = evaluate_cli.main(["--model_path", str(vdir.parent), "--output_folder",
                                  str(out / "results"), "--phase", "test", "--data_root",
                                  str(root), "--device", DP_DEVICE])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    for k, v in kernels.launches.items():
        launches[k] = launches.get(k, 0) + v
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    metrics = [c for c in rows[0] if c.startswith(("ADE k=", "FDE k="))]
    bad = [(r["Prediction strategy"], c) for r in rows for c in metrics
           if not np.isfinite(float(r[c]))]
    check(rows and not bad, f"{name} evaluate: non-finite metrics {bad[:5]}")
    check_path_kernels(name, launches)
    gp = flags_over.get("gp", 1)
    for i, r in enumerate(ranks):
        print(f"  {name} {r['grid']}: {r['steps']} steps")
        check(gp == 1 or f"model rank {i % gp} of {gp}" in r["grid"],
              f"{name}: rank {i} placed as {r['grid']}")
    print(f"  {name}: {n_ranks} ranks, backend {ranks[0]['backend']}, world "
          f"{ranks[0]['world']}, one version dir, {ranks[0]['steps']} steps of 256 scenes in "
          f"{train_s:.1f} s (launch included); epoch metrics finite, val/ADE k=20 "
          f"{lines[0].get('val/ADE k=20', float('nan')):.4f}; cli.evaluate on one device "
          f"{eval_s:.1f} s, {len(rows)} strategies finite; launches {json.dumps(launches)}")
    return {"ranks": n_ranks, "backend": ranks[0]["backend"], "world": ranks[0]["world"],
            "grids": [r["grid"] for r in ranks], "steps": ranks[0]["steps"], "train_s": train_s,
            "eval_s": eval_s, "epoch": lines[0], "launches": launches,
            "csv": {k: float(rows[0][k]) for k in ("ADE k=1", "ADE k=19", "FDE k=19")
                    if k in rows[0]}}


def dp_pod(tmp, root):
    """(c): 2 simulated nodes x 2 ranks (two ``torch.distributed.run``
    launchers on this machine, a static rendezvous on 127.0.0.1) on phase
    15's zara1 files with ``shard_by_process`` and the bank; then their
    first step against the single-device one (``pod_first_step``)."""
    import socket

    out = Path(tmp) / "dp_pod"
    out.mkdir()
    with socket.socket() as s:  # a free port on this machine for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launcher = lambda node: [
        sys.executable, "-m", "torch.distributed.run", "--nnodes", str(POD_NODES),
        "--node-rank", str(node), "--nproc-per-node", str(POD_LOCAL), "--rdzv-backend",
        "static", "--master-addr", "127.0.0.1", "--master-port", str(port),
        str(HERE / "chip_smoke.py"), "--rank", "pod", str(out), str(root)]
    t0 = time.perf_counter()
    run_ranks([launcher(n) for n in range(POD_NODES)], out)
    secs = time.perf_counter() - t0
    world = POD_NODES * POD_LOCAL
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    one = lambda key: {json.dumps(r[key]) for r in ranks}
    check(len(one("num_batches")) == 1 and len(one("max_peds")) == 1,
          f"pod: lockstep counts {one('num_batches')}, max_peds {one('max_peds')}")
    check(all(r["batches"] == r["num_batches"] for r in ranks), "pod: a rank ran short")
    check(all(r["bank_equal"] for r in ranks), "pod: bank gathers differ from host assembly")
    check(len(one("reduced")) == 1, f"pod: allreduce_sums differ across ranks {one('reduced')}")
    want = {"ADE k=3": [float(sum(range(1, world + 1))), 2.0 * world],
            "FDE k=3": [10.0 * world, 1.0 * world]}
    check(ranks[0]["reduced"] == want, f"pod: allreduce_sums {ranks[0]['reduced']} != {want}")
    check(len(one("digest")) == 1, "pod: the ranks' states differ after the epoch")
    check(len(one("first_digest")) == 1, "pod: the ranks' states differ after one step")
    step = pod_first_step(out, root)
    check(len(one("dir")) == 1, "pod: the ranks name different version dirs")
    check(sorted(r["node"] for r in ranks) == [0, 0, 1, 1], "pod: nodes")
    check(all(r["finite"] for r in ranks), "pod: non-finite best_val")
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check_path_kernels("pod", launches)
    for r in ranks:
        print(f"  pod {r['grid']}: {r['shard_windows']} windows on its node, "
              f"{r['num_batches']} lockstep batches of {r['rows']} rows, max_peds "
              f"{r['max_peds']}, bank = host assembly {r['bank_equal']}, {r['steps']} steps")
    print(f"  pod: backend {ranks[0]['backend']}, world {world}, allreduce_sums "
          f"{json.dumps(ranks[0]['reduced'])} on every rank, states bit for bit, "
          f"best_val {ranks[0]['best_val']:.4f}; {secs:.1f} s; launches {json.dumps(launches)}")
    return {"first_step": step, "nodes": POD_NODES, "local": POD_LOCAL,
            "backend": ranks[0]["backend"],
            "grids": [r["grid"] for r in ranks], "num_batches": ranks[0]["num_batches"],
            "max_peds": ranks[0]["max_peds"], "steps": ranks[0]["steps"],
            "best_val": ranks[0]["best_val"], "seconds": secs, "launches": launches}


def pod_first_step(out, root):
    """(c)'s first step of the 4 ranks against the single-device step on
    the nodes' first batches laid end to end (each node's window shard,
    assembled on the host), each node's rows augmented with the same draws
    (every node draws them for its own batch) and the step's draws at the
    global shape, to (a)'s tolerances; the agents summed over the ranks."""
    import numpy as np
    import torch

    from mggan_tpu_torch.data.loaders import get_dataloader
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    got = torch.load(out / "first_step.pt", weights_only=False)
    cfg = zara1_config(str(out / "single_logs"), str(root), name="pod_zara1_single")
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device=DP_DEVICE)
    nodes = []
    for n in range(POD_NODES):
        loader = get_dataloader("zara1", "train", batch_size=cfg.batch_size, shuffle=True,
                                seed=cfg.seed, data_root=str(root), shard_by_process=True,
                                process_index=n, process_count=POD_NODES, device=DP_DEVICE)
        loader.set_epoch(0)
        nodes.append(next(iter(loader)))
    joined = {k: np.concatenate([b[k] for b in nodes]) for k in nodes[0]}
    flip, alpha = tr.draws.aug(0, 0, cfg.batch_size)
    model_batch = tr._device_batch(joined, train=True, aug=(torch.cat([flip] * POD_NODES),
                                                            torch.cat([alpha] * POD_NODES)))
    s, p = joined["ped_mask"].shape
    state, metrics = tr.train_step(tr.state, model_batch, tr.draws.step(tr.state, s, p))
    torch.cuda.synchronize()
    want = {"state": _state_trees(state), "metrics": {k: float(v) for k, v in metrics.items()}}
    cmp = compare_steps(got, want, cfg)
    agents = int(joined["ped_mask"].sum())
    diffs = cmp["diffs"]
    print(f"  pod first step ({POD_NODES} x {POD_LOCAL} ranks, {s} scenes) against the "
          f"single-device step on the nodes' batches end to end: metrics max rel diff "
          f"{cmp['metric_err']:.3e}, moments max abs diff {cmp['moment_err']:.3e} (beyond: "
          f"{cmp['moment_bad'][:4]}), parameters {diffs['param_max_abs_diff']:.3e}, "
          f"{diffs['noise_elements']} float-noise elements {diffs['noise_max_abs_diff']:.3e}; "
          f"agents {got['agents']} / {agents}")
    check(got["agents"] == agents, f"pod: {got['agents']} agents counted, {agents} in the batch")
    check(not cmp["bad_metrics"], f"pod first step: metrics {cmp['bad_metrics']}")
    check(not cmp["moment_bad"], f"pod first step: Adam moments {cmp['moment_bad'][:4]}")
    check(not diffs["bad"], f"pod first step: parameters {diffs['bad'][:4]}")
    return {"scenes": s, "metric_max_rel_diff": cmp["metric_err"],
            "moment_max_abs_diff": cmp["moment_err"],
            "param_max_abs_diff": diffs["param_max_abs_diff"],
            "noise_max_abs_diff": diffs["noise_max_abs_diff"], "agents": agents}


def dp_row_slices():
    """(f): K1 and K2 on each of DP_RANKS row slices of the train step's
    shapes equal the full launch's rows bit for bit, K3's per-row input
    grads too; K3's weight grads summed over the slices within
    SLICE_WGRAD_REL of the full launch's (another summation order)."""
    import torch

    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    gen = torch.Generator().manual_seed(SEED + 19)
    out = {}
    # K1 at the D step's rows (one sample a ped: rows are agents)
    c = decode_select_case(TRAIN_SCENES, gen, num=1)
    args = [c["stacked"], c["xy"], c["dxdy"], c["soc"], c["h0"], c["idx"]]
    on = lambda a: {k: on(v) for k, v in a.items()} if isinstance(a, dict) else a.cuda()
    full = kdec.decode_select(*[on(a) for a in args], 12, "rel")
    m = c["xy"].shape[0]
    rows = m // DP_RANKS
    same = True
    for r in range(DP_RANKS):
        sl = slice(r * rows, (r + 1) * rows)
        part = kdec.decode_select(on(args[0]), *[on(a[sl]) for a in args[1:]], 12, "rel")
        same &= all(torch.equal(p, f[sl]) for p, f in zip(part, full))
    out["decode_select"] = {"rows": m, "slices": DP_RANKS, "bit_for_bit": bool(same)}
    check(same, "row slices: K1 differs from the full launch")
    # K2 / K3 at the G step's rows: K samples of every agent, rows sample-major
    k = NUM
    inputs = decode_all_case(TRAIN_SCENES * PEDS, k, gen)  # weights, socb, h0, xy, dxdy
    m = inputs[6].shape[0]
    rows = m // DP_RANKS

    def run(ins):
        prepared = kda.prepare(*ins, 12, "rel")
        a, rel, hc = kda.launch_fwd(prepared, save_hc=True)
        cot = torch.Generator(device="cuda").manual_seed(SEED)
        ga = torch.randn(a.shape, generator=cot, device="cuda")
        gr = torch.randn(rel.shape, generator=cot, device="cuda")
        return a, rel, ga, gr, prepared, hc

    a, rel, ga, gr, prepared, hc = run(inputs)
    grads = kda.grads_from_raw(kda.launch_bwd(prepared, a, rel, hc, ga, gr), m)
    g = a.shape[0]
    per_agent = lambda x, sl: x.reshape((g, k, m) + tuple(x.shape[2:]))[:, :, sl]
    fwd_same, row_same, wsum = True, True, None
    for r in range(DP_RANKS):
        sl = slice(r * rows, (r + 1) * rows)
        h0 = inputs[7].reshape(k, m, -1)[:, sl].reshape(k * rows, -1).contiguous()
        ins = inputs[:6] + [inputs[6][sl].contiguous(), h0, inputs[8][sl].contiguous(),
                            inputs[9][sl].contiguous()]
        prepared_r = kda.prepare(*ins, 12, "rel")
        a_r, rel_r, hc_r = kda.launch_fwd(prepared_r, save_hc=True)
        fwd_same &= torch.equal(a_r.reshape(g, k, rows, 12, 2), per_agent(a, sl)) and \
            torch.equal(rel_r.reshape(g, k, rows, 12, 2), per_agent(rel, sl))
        ga_r = per_agent(ga, sl).reshape(a_r.shape).contiguous()
        gr_r = per_agent(gr, sl).reshape(rel_r.shape).contiguous()
        g_r = kda.grads_from_raw(kda.launch_bwd(prepared_r, a_r, rel_r, hc_r, ga_r, gr_r), rows)
        row_same &= torch.equal(g_r[6], grads[6][sl]) and torch.equal(g_r[8], grads[8][sl]) \
            and torch.equal(g_r[9], grads[9][sl]) and torch.equal(
                g_r[7].reshape(k, rows, -1), grads[7].reshape(k, m, -1)[:, sl])
        wsum = list(g_r[:6]) if wsum is None else [s + x for s, x in zip(wsum, g_r[:6])]
    torch.cuda.synchronize()
    w_rel = max(float((s - f).abs().max() / f.abs().max().clamp_min(1e-30))
                for s, f in zip(wsum, grads[:6]))
    out["decode_all_fwd"] = {"rows": m * k, "slices": DP_RANKS, "bit_for_bit": bool(fwd_same)}
    out["decode_all_bwd"] = {"rows": m * k, "slices": DP_RANKS, "row_grads_bit_for_bit":
                             bool(row_same), "weight_grad_sum_rel_diff": w_rel}
    print(f"  row slices ({DP_RANKS}): K1 at {out['decode_select']['rows']} rows bit for bit "
          f"{same}; K2 at {m * k} rows bit for bit {fwd_same}; K3 per-row grads bit for bit "
          f"{row_same}, weight grads summed over the slices {w_rel:.3e} x max|grad| of the "
          f"full launch's (limit {SLICE_WGRAD_REL:g})")
    check(fwd_same, "row slices: K2 differs from the full launch")
    check(row_same, "row slices: K3's per-row grads differ from the full launch")
    check(w_rel <= SLICE_WGRAD_REL, f"row slices: K3 weight grads {w_rel:.3e}")
    return out


def phase_data_parallel(tmp, root, single_p50_ms):
    """Phase 19 (see the module note): (a) dp_step, (b) dp_cli, (c) pod,
    (d) gp_step, (e) gp_cli, (f) the row-slice kernel checks. Returns the
    summary and the paths' launch counts."""
    import torch

    from mggan_tpu_torch.parallel import pod

    t_phase = time.perf_counter()
    card = smi_query("name,power.limit")
    rule = pod.backend_for("cuda", DP_RANKS)
    print(f"data parallelism ({card}): {torch.cuda.device_count()} card(s); backend rule: NCCL "
          f"when every local rank has a card of its own, else gloo (gloo's all_reduce and "
          f"broadcast take CUDA tensors), the host-side agreements on gloo always; here "
          f"{DP_RANKS} ranks -> {rule}; the NCCL route is not run on one card")
    step, ref = dp_step(tmp, single_p50_ms)
    cli = dp_cli(tmp)
    pod_r = dp_pod(tmp, root)
    gp_r = gp_step(tmp, ref)
    gp_cli = dp_cli(tmp, "gp_cli", GP_CLI, dp=1, gp=GP_CLI)
    slices = dp_row_slices()
    secs = time.perf_counter() - t_phase
    print(f"phase 19 (data and generator parallelism): {secs:.1f} s")
    launches = {"dp_step": step.pop("launches"), "dp_cli": cli.pop("launches"),
                "pod": pod_r.pop("launches"), "gp_step": gp_r.pop("launches"),
                "gp_cli": gp_cli.pop("launches")}
    return {"card": card, "dp_step": step, "dp_cli": cli, "pod": pod_r, "gp_step": gp_r,
            "gp_cli": gp_cli, "row_slices": slices, "seconds": secs}, launches


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
    if sys.argv[1:2] == ["--rank"]:  # a child of phase 19
        return rank_main(sys.argv[2:])
    t_start = time.perf_counter()
    phase_card()
    build_s, host_build_s = phase_build()
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
    loop = phase_train_loop(train["p50_ms"])
    with tempfile.TemporaryDirectory() as tmp:
        real, real_handles = phase_real_data(tmp, host_build_s)
        families = phase_families(train["p50_ms"])
        deployment = phase_deployment(Path(tmp), **real_handles)
        surface = phase_surface(Path(tmp), real_handles["root"], train["p50_ms"])
        data_parallel, dp_launches = phase_data_parallel(tmp, real_handles["root"],
                                                         train["p50_ms"])
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "mggan_tpu."))
              or m == "mggan_tpu"]
    if loaded:
        print(f"chip_smoke: JAX modules were loaded: {loaded[:5]}", file=sys.stderr)
        return 1

    paths = {"serving": serving_launches, "train": train["launches"],
             **{f"eval_{mode}": r["launches"] for mode, r in evaluation["runs"].items()},
             **{f"bench_sampling_{mode}": r["launches"] for mode, r in bench.items()},
             "ablation": abl_path["launches"], "train_loop": loop["launches"],
             "realdata_cli": real["launches"], "families": families["launches"],
             "single_gen_cli": families["single_gen_cli"]["launches"],
             "deployment": deployment["launches"], **surface["launches"], **dp_launches}
    by_path = lambda name: {path: c[name] for path, c in paths.items() if c.get(name)}
    entries = kernel_entries(kern, fwd, bwd, sel16, all16, paths, redesigned)
    entries += ablation_entries(abl_checks, bwd16, abl_path, by_path, redesigned)
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} was launched on no main path")
    for name in WARP_KERNELS:
        # the kept yardsticks stay off every path
        check(not by_path(name), f"{name} was launched on a path: {by_path(name)}")
    print(json.dumps({
        "build_s": build_s,
        "host_ops_build_s": host_build_s,
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
        "train_loop": {k: v for k, v in loop.items() if k != "launches"},
        "realdata_cli": {k: v for k, v in real.items() if k != "launches"},
        "families": {**{k: v for k, v in families.items() if k not in ("launches",
                                                                        "single_gen_cli")},
                     "single_gen_cli": {k: v for k, v in families["single_gen_cli"].items()
                                        if k != "launches"}},
        "deployment": {k: v for k, v in deployment.items() if k != "launches"},
        "surface": {k: v for k, v in surface.items() if k != "launches"},
        "data_parallel": data_parallel,
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
