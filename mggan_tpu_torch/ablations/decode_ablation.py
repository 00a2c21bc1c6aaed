"""K1's ablations on the card: the port of ``benchmarks/decode_ablation.py``.

Times, at the sampling flagship shape (1,310,720 rows, G=4, h=32, social
32, T=12, rel), the fused-selection rollout and the variants that split
its time into causes:

* ``prod_select``: ``decoder.decode_select`` as the sampling path calls it
  (weight folding, the hoisted social bias, K1);
* ``kernel_select``: K1 alone on prepared arguments (the tiled kernel);
* ``kernel_f32`` / ``kernel_bf16`` / ``kernel_lin``: B1, the tiled K1 with
  its gate activations exact, in bf16 arithmetic, or linear (wrong by
  design): beside ``kernel_select``, the activations' share of K1;
* ``kernel_ilp``: K5, the tiled K1 with two groups of R rows of one
  generator a warp (bit-identical to the tiled and the warp-per-row K1);
* ``kernel_select_bf16``: K1-bf16 (the tensor-core kernel of the bf16 route);
* ``kernel_ilp_bf16``: K5-bf16, K1-bf16's tensor-core rollout with two groups
  of 16 rows a warp (bit-identical to K1-bf16).

    python -m mggan_tpu_torch.ablations.decode_ablation [--rows N] [--reps R]

prints the card's name and ``DECODEABL {json}``: mean device ms of each
(CUDA events, ``reps`` launches after one warm-up) and the resident warps
per SM of each kernel.
"""

from __future__ import annotations

import argparse
import json

import torch

from mggan_tpu_torch.ablations import N, T, cuda_time_ms, make_inputs
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.ops.kernels import decode_ablation as kab
from mggan_tpu_torch.ops.kernels import decoder as kdec


def prepare(inputs):
    """K1's arguments, then its checked f32 and bf16 kernel arguments."""
    args = (inputs["stacked"], inputs["xy"], inputs["dxdy"], inputs["soc"], inputs["h0"],
            inputs["idx"], T, "rel")
    return (args, kdec.prepare_decode_select(*args),
            kdec.prepare_decode_select(*args, compute_dtype=torch.bfloat16))


def variants(inputs):
    """Name -> a call that launches it (each returns ``(abs, rel)``)."""
    args, p32, p16 = prepare(inputs)
    calls = {
        "prod_select": lambda: kdec.decode_select(*args),
        "kernel_select": lambda: kdec.launch_decode_select(p32),
        "kernel_ilp": lambda: kdec.launch_decode_select(p32, ilp=True),
        "kernel_select_bf16": lambda: kdec.launch_decode_select(p16),
        "kernel_ilp_bf16": lambda: kdec.launch_decode_select(p16, ilp=True),
    }
    for act in kab.ACTS:
        calls[f"kernel_{act}"] = lambda act=act: kab.launch_act(p32, act)
    return calls


def resident_warps(inputs):
    """Resident warps per SM of each kernel at these shapes."""
    _, p32, p16 = prepare(inputs)
    n, sms = p32["dims"][0], kdec.sm_count(p32["tensors"][1].device)
    rows = kdec.tiled_launch(n, sms)[0]
    return {
        "kernel_select": kdec.tiled_warps_per_sm(p32, rows),
        "kernel_select_bf16": kdec.mma_warps_per_sm(p16["dims"][2]),
        "kernel_ilp": kdec.tiled_ilp_warps_per_sm(p32, kdec.tiled_ilp_launch(n, sms)[0]),
        "kernel_ilp_bf16": kdec.mma_ilp_warps_per_sm(p16["dims"][2],
                                                     kdec.mma_ilp_launch(n, sms)[0]),
        **{f"kernel_{a}": kab.tiled_warps_per_sm(p32, a, rows) for a in kab.ACTS},
    }


def run(inputs, reps: int = 5):
    """Mean device ms of every variant (see the module note)."""
    return {name: cuda_time_ms(fn, reps) for name, fn in variants(inputs).items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=N)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    dev = resolve_device("cuda")
    inputs = make_inputs(opts.rows, opts.seed, dev)
    print(torch.cuda.get_device_name(dev))
    results = {"rows": opts.rows, "ms": run(inputs, opts.reps),
               "warps_per_sm": resident_warps(inputs)}
    print("DECODEABL " + json.dumps(results))
    return results


if __name__ == "__main__":
    main()
