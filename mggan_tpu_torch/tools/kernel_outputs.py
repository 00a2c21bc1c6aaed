"""Every rollout kernel's outputs on seeded inputs, to hold two trees of
the port to the same bits on the card.

    python mggan_tpu_torch/tools/kernel_outputs.py --tree DIR --out FILE
    python mggan_tpu_torch/tools/kernel_outputs.py --compare FILE_A FILE_B

The first form imports the ``mggan_tpu_torch`` of the checkout ``DIR``,
builds its kernels there, launches each on one card and saves the outputs
(``torch.save``): K1, K1-bf16, K2 and K2-bf16 (with hc), K3, K4's f32 route,
B2, K5, B1 and every kept warp-per-row kernel, at the benchmarks' inputs
(20,480 rows) and at 4,096 x 4 rows for K2 and K3, with the registers and
spills nvcc reported for every kernel entry of the tree's build. The kept
warp-per-row K5-bf16 and K4-bf16, and the kept f32 K5, K4 route and B2,
are taken under their names of either tree (before their successors they
were the kernels of the routes). The second form prints, per kernel,
whether the two files hold the same bits, and per kernel entry built in
both trees whether nvcc reported the same registers and spills; it exits 1
if any differ or either file lacks a kernel's outputs. Run it as a script
(not with ``-m``), so that the package comes from ``DIR``.
"""

from __future__ import annotations

import argparse
import sys


def outputs(tree: str, rows: int = 20_480, seed: int = 0):
    """Name -> tuple of output tensors (on the CPU) of every kernel of the
    port in ``tree``."""
    sys.path.insert(0, tree)
    import torch

    from mggan_tpu_torch.ablations import decode_ablation as dab
    from mggan_tpu_torch.ablations import make_inputs
    from mggan_tpu_torch.ablations import sorted_select_ablation as sab
    from mggan_tpu_torch.models import common
    from mggan_tpu_torch.ops.kernels import decode_ablation as kab
    from mggan_tpu_torch.ops.kernels import decode_all as kda
    from mggan_tpu_torch.ops.kernels import decode_sorted as ks
    from mggan_tpu_torch.ops.kernels import decoder as kdec

    bf16 = torch.bfloat16
    inp = make_inputs(rows, seed)
    args, p32, p16 = dab.prepare(inp)
    tiles32 = sab.grouped_tiles(inp)[3]
    packed, grouped, tile_gen, _ = sab.grouped_tiles(inp)
    tiles16 = ks.prepare_sorted_tiles(packed, grouped, tile_gen, 32, 32, 12, "rel", bf16)
    kept_k5_bf16 = getattr(kdec, "launch_decode_select_ilp_bf16_warp",
                           lambda p: kdec.launch_decode_select(p, ilp=True))
    kept_k4_bf16 = getattr(ks, "launch_sorted_tiles_bf16_warp", ks.launch_sorted_tiles)
    kept_k5 = getattr(kdec, "launch_decode_select_ilp_warp",
                      lambda p: kdec.launch_decode_select(p, ilp=True))
    kept_route = getattr(ks, "decode_select_sorted_warp", ks.decode_select_sorted)
    kept_b2 = getattr(ks, "launch_sorted_tiles_warp", ks.launch_sorted_tiles)
    calls = {
        "k1": lambda: kdec.launch_decode_select(p32),
        "k1_warp": lambda: kdec.launch_decode_select_warp(p32),
        "k1_bf16": lambda: kdec.launch_decode_select(p16),
        "k1_bf16_warp": lambda: kdec.launch_decode_select_bf16_warp(p16),
        "k5": lambda: kdec.launch_decode_select(p32, ilp=True),
        "k5_warp": lambda: kept_k5(p32),
        "k5_bf16_warp": lambda: kept_k5_bf16(p16),
        "k4_route": lambda: ks.decode_select_sorted(*sab.route_args(inp)),
        "k4_route_warp": lambda: kept_route(*sab.route_args(inp)),
        "b2": lambda: (ks.launch_sorted_tiles(tiles32),),
        "b2_warp": lambda: (kept_b2(tiles32),),
        "k4_bf16_warp": lambda: (kept_k4_bf16(tiles16),),
        **{f"b1_{act}": lambda act=act: kab.launch_act(p32, act) for act in kab.ACTS},
        **{f"b1_{act}_warp": lambda act=act: kab.launch_act_warp(p32, act) for act in kab.ACTS},
    }
    out = {name: tuple(x.cpu() for x in call()) for name, call in calls.items()}

    gen = torch.Generator().manual_seed(seed + 1)
    stacked = common.stacked_decoders_init(gen, 4, 16, 32, "rel", 32)
    fold = kdec.pack_decoder_params(stacked, "rel")
    m = 4_096
    rand = lambda *s: torch.randn(s, generator=gen)
    inputs = [x.contiguous().cuda() for x in [fold[key] for key in kda.PACKED] + [
        kdec.social_bias(fold, rand(m, 32)), rand(m, 32), rand(m, 2) * 3.0, rand(m, 2) * 0.3]]
    for cd, tag in ((None, ""), (bf16, "_bf16")):
        p = kda.prepare(*inputs, 12, "rel", cd)
        out[f"k2{tag}"] = tuple(x.cpu() for x in kda.launch_fwd(p, True))
        out[f"k2{tag}_warp"] = tuple(x.cpu() for x in kda.launch_fwd_warp(p, True))
    p = kda.prepare(*inputs, 12, "rel")
    fwd = kda.launch_fwd(p, True)
    cot = torch.Generator(device="cuda").manual_seed(seed + 2)
    res = (*fwd, *(torch.randn(x.shape, generator=cot, device="cuda") for x in fwd[:2]))
    for name, call in (("k3", kda.launch_bwd), ("k3_warp", kda.launch_bwd_warp)):
        out[name] = tuple(x.cpu() for x in call(p, *res) if x is not None)
    torch.cuda.synchronize()
    return out


def registers() -> dict:
    """``{source stem: {kernel entry: "<n> registers; <spill line>"}}``
    from nvcc's ``-Xptxas -v`` report of every library of the imported
    tree's build."""
    import re

    from mggan_tpu_torch.ops.kernels import build

    found = {}
    for src in build.sources():
        entries, entry, spills = {}, None, ""
        for line in build.build_log(src.stem).splitlines():
            if "Compiling entry function" in line:  # an anonymous namespace's name varies
                entry = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                               re.search(r"'([^']+)'", line).group(1))
            elif entry and "spill" in line:
                spills = line.strip()
            elif entry and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                entries[entry] = f"{regs} registers; {spills}"
                entry, spills = None, ""
        found[src.stem] = entries
    return found


def compare(file_a: str, file_b: str) -> bool:
    """Print per kernel whether the two files' outputs are equal bit for
    bit (NaNs equal where both are NaN), and per kernel entry built in both
    trees whether its registers and spills are the same; True if all are."""
    import torch

    a, b = torch.load(file_a), torch.load(file_b)
    same_all = True
    outs_a, outs_b = a["outputs"], b["outputs"]
    for name in sorted(set(outs_a) | set(outs_b)):
        x_, y_ = outs_a.get(name), outs_b.get(name)
        same = x_ is not None and y_ is not None and len(x_) == len(y_) and all(
            x.shape == y.shape and torch.equal(x.nan_to_num(), y.nan_to_num())
            and torch.equal(x.isnan(), y.isnan()) for x, y in zip(x_, y_))
        same_all &= same
        print(f"{name}: {'same bits' if same else 'DIFFERENT'}")
    regs_a, regs_b = a["registers"], b["registers"]
    for stem in sorted(set(regs_a) | set(regs_b)):
        ra, rb = regs_a.get(stem, {}), regs_b.get(stem, {})
        for entry in sorted(set(ra) & set(rb)):
            same = ra[entry] == rb[entry]
            same_all &= same
            print(f"{stem} {entry}: " + (f"same registers ({ra[entry]})" if same else
                                          f"DIFFERENT registers: {ra[entry]} / {rb[entry]}"))
        for entry in sorted(set(ra) ^ set(rb)):
            print(f"{stem} {entry}: only in {file_a if entry in ra else file_b} "
                  f"({ra.get(entry) or rb.get(entry)})")
    return same_all


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree")
    parser.add_argument("--out")
    parser.add_argument("--compare", nargs=2)
    opts = parser.parse_args(argv)
    if opts.compare:
        return 0 if compare(*opts.compare) else 1
    import torch

    torch.save({"outputs": outputs(opts.tree), "registers": registers()}, opts.out)
    print(f"{opts.out}: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
