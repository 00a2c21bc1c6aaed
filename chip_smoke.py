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
  7. a JSON line listing every ported kernel, then the result line
     ``{"ok": true, "device": {...}}``.

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
# kernels here do no tensor-core work) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

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

SEED = 0
NUM = 20
PEDS = 16
BUCKETS = (1, 8, 64)
BENCH_SCENES = 4096  # bench.py's k=20 sampling batch
TRAIN_SCENES = 256  # bench.py's train batch: 256 scenes x 16 peds, K=20
TRAIN_STEPS = 5


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


def decode_select_case(n_scenes, gen):
    """Flagship decoder weights and per-row inputs for ``n_scenes`` scenes of
    PEDS peds with NUM samples: N = NUM * n_scenes * PEDS rollouts."""
    import torch

    from mggan_tpu_torch.models import common

    m = n_scenes * PEDS
    stacked = common.stacked_decoders_init(gen, 4, 16, 32, "rel", 32)
    rand = lambda *s: torch.randn(s, generator=gen)
    return {
        "stacked": stacked,
        "xy": rand(m, 2) * 3.0, "dxdy": rand(m, 2) * 0.3,
        "soc": rand(m, 32), "h0": rand(m * NUM, 32),
        "idx": torch.randint(0, 4, (m * NUM,), generator=gen, dtype=torch.int32),
    }


def roofline_ms(flops, nbytes):
    """Least time for the work on an H100: max(FLOPs / fp32 peak,
    bytes / HBM rate) -> ``(ms, "operations" or "bytes", flops, bytes)``."""
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes"), flops, nbytes


def nbytes_of(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def decode_select_bound_ms(prepared):
    """K1's bound: each input read once and each output written once; the
    gate, hidden2pos and output products of the sampled generator."""
    tensors, dims = prepared["tensors"], prepared["dims"]
    n, _, _, h, hid, in_dim, t = dims[:7]
    flops = n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)
    return roofline_ms(flops, nbytes_of(*tensors) + 2 * n * t * 2 * 4)


def decode_all_bound_ms(prepared, outputs):
    """K2's bound: the inputs read once, ``outputs`` (abs, rel and, when
    saved, hc) written once; K1's products for every (row, generator)."""
    n, _, g, h, hid, in_dim, t = prepared["dims"][:7]
    flops = g * n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)
    return roofline_ms(flops, nbytes_of(*prepared["tensors"], *outputs))


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

    from mggan_tpu_torch.ops.kernels import decode_all as kda

    w1h, socb, h0 = inputs[3], inputs[6], inputs[7]
    g, n, t, _, h = hc.shape
    sb = kda._tile(socb, n).transpose(0, 1)  # (G, N, hid)
    pre = torch.bmm(hc[:, :, :, 0].reshape(g, n * t, h), w1h).reshape(g, n, t, -1)
    return (pre + sb[:, :, None]).abs().amin(dim=(0, 2, 3)) < KINK


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
            "top": [[name[:60], tot / reps] for name, (tot, _) in top[:5]]}


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


def kernel_entries(kern, fwd, bwd, serving_launches, train):
    """The kernels line: one entry per ported kernel with its main-path
    launches and the numbers measured in this run."""
    serving, bench = kern["serving"], kern["bench"]
    train_launches = train["launches"]
    shapes = lambda res: {label: {k: v for k, v in r.items() if k not in ("flops", "bytes")}
                          for label, r in res.items()}
    entries = [{
        "name": "decode_select",
        "status": "ported (f32)",
        "route": "cuda",
        "source": "mggan_tpu_torch/csrc/decode_select.cu",
        "replaces": "mggan_tpu/ops/pallas/decoder.py:140",
        "launches": serving_launches.get("decode_select", 0)
        + train_launches.get("decode_select", 0),
        "launches_by_path": {"serving": serving_launches.get("decode_select", 0),
                             "train": train_launches.get("decode_select", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
        "n_rows": serving["n_rows"],
        "atol": KERNEL_ATOL,
        "bench_shape": {k: bench[k] for k in ("n_rows", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "smi_under_load")},
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
            "launches": train_launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "ms": g.get("ms_save_hc", g["ms"]),
            "plain_ms": g["plain_ms"],
            "bound_ms": g.get("bound_ms_save_hc", g["bound_ms"]),
            "bound_by": g.get("bound_by_save_hc", g["bound_by"]),
            "library_ms": None,
            "library_note": "no single PyTorch call runs a rollout that feeds back "
                            "its own output",
            "n_rows": g["n_rows"],
            **atol,
            "shapes": shapes(res),
        })
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
    kern = phase_kernels()
    fwd, bwd = phase_decode_all_kernels()
    serving_launches, latency, e2e_err, model, (obs, pat) = phase_main_path()
    train, train_handles = phase_train()
    train_vs_cpu = phase_train_card_vs_cpu()
    profile_serving, profile_train = phase_profile(model, obs, pat, train_handles)
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "mggan_tpu."))
              or m == "mggan_tpu"]
    if loaded:
        print(f"chip_smoke: JAX modules were loaded: {loaded[:5]}", file=sys.stderr)
        return 1

    entries = kernel_entries(kern, fwd, bwd, serving_launches, train)
    print(json.dumps({
        "build_s": build_s,
        "serving_p50_ms": {str(b): v["p50_ms"] for b, v in latency.items()},
        "card_vs_cpu_max_abs_err": e2e_err,
        "train_step_p50_ms": train["p50_ms"],
        "train_step_times_ms": train["times_ms"],
        "train_peak_gib": train["peak_gib"],
        "train_card_vs_cpu": train_vs_cpu,
        "profile_64_scenes": profile_serving,
        "profile_train_step": profile_train,
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
