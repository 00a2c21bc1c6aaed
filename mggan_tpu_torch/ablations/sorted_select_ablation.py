"""The sorted-selection route piece by piece on the card: the port of
``benchmarks/sorted_select_ablation.py``.

Times, at 1,310,720 rows (G=4, h=32, social 32, T=12, rel), the parts of
``decode_sorted.decode_select_sorted`` (K4's route) and the primitives its
layout is built from:

* ``bincount``, ``cumsum_oh`` (stable rank from a cumulative sum of the
  one-hot), ``scatter_inv`` (the inverse map), ``argsort`` (the sort the
  layout avoids);
* ``row_gather68``: the gather of the 68-float rows ``[h0 | social | xy |
  dxdy]`` into the buffer's order;
* ``kernel_only``: B2, K4's kernel alone on rows already grouped, with
  ``tile_gen = arange(tiles) * G // tiles`` as the JAX script sets it;
* ``out_gather``: the gather of the 48-float outputs back to row order;
* ``route`` / ``route_bf16``: the whole route, f32 and bf16.

    python -m mggan_tpu_torch.ablations.sorted_select_ablation [--rows N] [--reps R]

prints the card's name and ``SORTEDPARTS {json}``: mean device ms of each
(CUDA events, ``reps`` calls after one warm-up) and the kernel's resident
warps per SM.
"""

from __future__ import annotations

import argparse
import json

import torch

from mggan_tpu_torch.ablations import G, H, N, T, F, cuda_time_ms, make_inputs
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.ops.kernels import build
from mggan_tpu_torch.ops.kernels import decode_sorted as ks
from mggan_tpu_torch.ops.kernels import decoder as kdec


def grouped_tiles(inputs, tile: int = ks.TILE):
    """B2's input: the rows as they are, padded to whole tiles plus G
    tiles, each tile on generator ``tile * G // tiles``; the kernel's
    checked arguments."""
    n = inputs["h0"].shape[0]
    n_buf = -(-n // tile) * tile + G * tile
    rows = torch.cat([inputs["h0"], inputs["soc"], inputs["xy"], inputs["dxdy"]], dim=1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, n_buf - n))
    tiles = n_buf // tile
    tile_gen = (torch.arange(tiles, device=rows.device) * G // tiles).to(torch.int32)
    packed = kdec.pack_decoder_params(inputs["stacked"], "rel")
    return packed, rows, tile_gen, ks.prepare_sorted_tiles(packed, rows, tile_gen, H, F, T, "rel")


def route_args(inputs):
    return (inputs["stacked"], inputs["xy"], inputs["dxdy"], inputs["soc"], inputs["h0"],
            inputs["idx"], T, "rel")


def parts(inputs):
    """Name -> a call that runs that part (see the module note)."""
    idx = inputs["idx"]
    n, dev = idx.shape[0], idx.device
    n_buf = -(-n // ks.TILE) * ks.TILE + G * ks.TILE
    idx_l = idx.long()
    rows68 = torch.cat([inputs["h0"], inputs["soc"], inputs["xy"], inputs["dxdy"]], dim=1)
    ramp = torch.arange(n, device=dev)
    inv_dummy = torch.arange(n_buf, device=dev) % n
    outbuf = torch.zeros((n_buf, T * 4), device=dev)
    prepared = grouped_tiles(inputs)[3]
    args = route_args(inputs)

    def scatter_inv():
        inv = torch.full((n_buf,), n, dtype=torch.long, device=dev)
        inv[ramp] = ramp
        return inv

    return {
        "bincount": lambda: torch.bincount(idx_l, minlength=G),
        "cumsum_oh": lambda: ks.stable_rank(idx_l, G),
        "scatter_inv": scatter_inv,
        "argsort": lambda: torch.argsort(idx, stable=True),
        "row_gather68": lambda: rows68[inv_dummy],
        "kernel_only": lambda: ks.launch_sorted_tiles(prepared),
        "out_gather": lambda: outbuf[ramp],
        "route": lambda: ks.decode_select_sorted(*args),
        "route_bf16": lambda: ks.decode_select_sorted(*args, compute_dtype=torch.bfloat16),
    }


def resident_warps(inputs):
    """Resident warps per SM of K4's kernel (f32 and bf16) at these shapes."""
    packed, rows, tile_gen, p32 = grouped_tiles(inputs)
    p16 = ks.prepare_sorted_tiles(packed, rows, tile_gen, H, F, T, "rel", torch.bfloat16)
    q = lambda v, p: build.warps_per_sm("decode_sorted", "mggan_decode_sorted_warps_per_sm", v,
                                       p["smem_bytes"])
    return {"kernel_only": q(0, p32), "route_bf16": q(1, p16),
            "smem_bytes": p32["smem_bytes"], "smem_bytes_bf16": p16["smem_bytes"]}


def run(inputs, reps: int = 5):
    """Mean device ms of every part (see the module note)."""
    return {name: cuda_time_ms(fn, reps) for name, fn in parts(inputs).items()}


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
    print("SORTEDPARTS " + json.dumps(results))
    return results


if __name__ == "__main__":
    main()
