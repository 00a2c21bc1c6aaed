"""Readings that the cells' limits on ``correct`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control 3]
        [--seconds 2] [--out readings.jsonl]

For each seed, in one process: the program's numbers against the
reference (the lower readings), and for the first ``--control`` seeds the
control's, the reference computed in bfloat16 in the program's place (the
upper readings), with what else the cell's runner reads (its
``readings``). One JSON line per seed. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import bench  # noqa: E402


def readings(cell, seed: int, dev, control: bool, seconds: float) -> dict:
    run = cell.runner().Run(cell, seed, dev)
    t0 = time.perf_counter()
    run.setup()
    out = {"setup_s": time.perf_counter() - t0, **run.readings(seconds, control)}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = bench.Cell(ROOT, args.workload)
    bench.check_card(cell.entry["chips"])
    bench.check_program(ROOT)
    dev = torch.device("cuda")
    print(json.dumps({"card": bench.power_limit(), "torch": torch.__version__}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        line = {"workload": args.workload, "seed": seed,
                **readings(cell, seed, dev, i < args.control, args.seconds)}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    found = bench.loaded_forbidden()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")


if __name__ == "__main__":
    main()
