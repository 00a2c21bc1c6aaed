#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mggan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits nonzero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off for matmuls and
     convolutions, so float32 means float32 on both sides of a comparison;
  2. build every kernel from ``mggan_tpu_torch/csrc`` (nvcc);
  3. kernels: each kernel against its plain PyTorch version on the card at
     a small shape, the serving shape and the benchmark shape, with its
     time, the plain version's time and the bound the card allows;
  4. the main path: the flagship model (mgan, 4 generators, h=32, sways
     social, scene CNN; random weights from a seed) served through
     ``ServingModel`` at 1, 8 and 64 scenes of up to 16 peds, k=20, with the
     kernels' launch counts read around it; one request is repeated with
     injected random numbers on the card and on the CPU and compared;
  5. a JSON line listing every ported kernel, then the result line
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

SEED = 0
NUM = 20
PEDS = 16
BUCKETS = (1, 8, 64)
BENCH_SCENES = 4096  # bench.py's k=20 sampling batch


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


def decode_select_bound_ms(prepared):
    """Least time for the work on an H100: max(FLOPs / fp32 peak,
    bytes / HBM rate), each input read once and each output written once."""
    tensors, dims = prepared["tensors"], prepared["dims"]
    n, _, _, h, hid, in_dim, t = dims[:7]
    flops = n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)
    nbytes = sum(x.numel() * x.element_size() for x in tensors) + 2 * n * t * 2 * 4
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes"), flops, nbytes


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
    print("main path launches:", json.dumps(launches))
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


def phase_profile(model, obs, pat, reps=5):
    """Where a largest-bucket request's time goes: device time by kernel
    name over ``reps`` requests (torch.profiler), the device's busy share of
    the wall time, and the host-side padding time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(reps):
        model.pad_request(obs, pat)
    pad_ms = (time.perf_counter() - t0) * 1e3 / reps
    model.predict_batch(obs, pat, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rep in range(reps):
            model.predict_batch(obs, pat, seed=rep)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    print(f"profile, {len(obs)} scenes x {PEDS} peds, k={NUM}, {reps} requests: "
          f"wall {wall_ms / reps:.3f} ms/request, device busy {busy_ms / reps:.3f} "
          f"ms/request (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{launches / reps:.0f} device ops/request, host padding {pad_ms:.3f} ms")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, cnt) in top:
        print(f"  {tot / reps:8.4f} ms/request  x{cnt // reps:<4d} {name[:90]}")
    return {"wall_ms": wall_ms / reps, "device_busy_ms": busy_ms / reps,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else float(np.nan),
            "device_ops": launches / reps, "pad_ms": pad_ms}


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
    launches, latency, e2e_err, model, (obs, pat) = phase_main_path()
    profile = phase_profile(model, obs, pat)
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "mggan_tpu."))
              or m == "mggan_tpu"]
    if loaded:
        print(f"chip_smoke: JAX modules were loaded: {loaded[:5]}", file=sys.stderr)
        return 1

    serving, bench = kern["serving"], kern["bench"]
    entry = {
        "name": "decode_select",
        "status": "ported (f32)",
        "route": "cuda",
        "source": "mggan_tpu_torch/csrc/decode_select.cu",
        "replaces": "mggan_tpu/ops/pallas/decoder.py:140",
        "launches": launches.get("decode_select", 0),
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
    }
    print(json.dumps({
        "build_s": build_s,
        "serving_p50_ms": {str(b): v["p50_ms"] for b, v in latency.items()},
        "card_vs_cpu_max_abs_err": e2e_err,
        "profile_64_scenes": profile,
        "total_s": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
