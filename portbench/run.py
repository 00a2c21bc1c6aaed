"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as the last line of standard output, one JSON
object, after the numbers that decide ``correct`` beside their limits on
standard error. Exits non-zero, with no result, without the cards, when
the measured program is not the checkout's own, or when anything of JAX
was loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import bench  # noqa: E402
from portbench.harness.trace import Tracer  # noqa: E402


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", start: float | None = None) -> tuple[dict, dict]:
    """One run of ``workload``: set-up, the measured window, the traced
    stretch when ``trace``, then the judgement. Returns the result object
    and the compared numbers beside their limits."""
    start = time.perf_counter() if start is None else start
    cell = bench.Cell(root, workload)
    dev = torch.device(device)
    run = cell.runner().Run(cell, seed, dev)
    run.setup()
    setup_s = time.perf_counter() - start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = None
    if trace:
        tracer = Tracer(cell.traffic["trace_skip"], cell.traffic["trace_units"], dev)
    e2e, _ = run.window(seconds, tracer)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    attempted, failed = run.attempted_failed()
    units = tracer.reading() if tracer else None
    unit_sizes = run.trace_units(tracer) if units else []
    run.free()
    numbers, judged_failed = run.correctness()
    failed = max(failed, judged_failed)
    shown, over = bench.compared(numbers, cell.limits)
    failed = max(failed, 1 if over else 0)
    result = {"correct": not over and failed == 0, "attempted": attempted, "failed": failed}
    device_rec = bench.device_record(dev, peak)
    if trace:
        metrics = {}
        if units is not None:
            reading = {"kind": cell.traffic["runner"], "cfg": cell.cfg,
                       "traffic": cell.traffic, "units": unit_sizes,
                       "flops": run.trace_flops(unit_sizes), **units}
            for m in cell.per_layer():
                value = cell.reader(m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_rec.update(busy_s=units["busy_s"], window_s=units["window_s"])
            result["breakdown"] = {"device_ops": units["device_ops"],
                                   "idle_gaps": units["idle_gaps"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}, **e2e}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end()}
    result.update(metrics=metrics, device=device_rec, compared=shown)
    return result, shown


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = bench.Cell(ROOT, args.workload)
    bench.check_card(cell.entry["chips"])
    bench.check_program(ROOT)
    result, shown = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             start=START)
    found = bench.loaded_forbidden()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    bench.emit(result, shown)


if __name__ == "__main__":
    main()
