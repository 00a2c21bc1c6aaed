"""Where the traced predictor calls' device time and idle time go, stage by
stage of the program's spans.

    python3 portbench/stages.py --workload <name> --seed <n> [--seconds 3]
        [--out stages.jsonl]

Sets the cell up as a run does and runs a window of ``--seconds`` with the
traced stretch of a ``--trace 1`` run (the traffic mix's ``trace_skip`` and
``trace_units``), then ties every device operation and idle gap of the
stretch to its span (``harness/spans.py``) and prints one JSON line. Each
number is per traced call, in milliseconds: each stage's device time (the
union of its operations' intervals), the device time under no stage, the
busy union, the idle time inside ``mggan.predict`` and between calls, each
span's host time and instances, each stage's largest device operations,
and the longest idle gaps named by span and host operation. It judges no
output. The benchmark's own runs do not run this: its per-layer metrics
read what ``harness/trace.py::summarize`` passes on, which holds no span.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import bench, spans  # noqa: E402
from portbench.harness.trace import Tracer, summarize  # noqa: E402

ROOT_SPAN = "mggan.predict"
# the stages of a call, each a span directly under ROOT_SPAN
STAGES = ("mggan.inputs", "mggan.traj_encoder", "mggan.scene_cnn", "mggan.social",
          "mggan.pm", "mggan.decoder_h0", "mggan.rollout")


def per_call(events, linked: dict, window_s: float, calls: int) -> dict:
    """The numbers of the module note from a traced stretch of ``calls``
    predictor calls: its ``events`` (``prof.events()``), their links
    (``spans.links``) and its wall time."""
    a = spans.attribute(events, linked)
    ms = lambda s: 1e3 * s / calls  # noqa: E731
    got = lambda name, key: a["spans"].get(name, {}).get(key, 0.0)  # noqa: E731
    out = {f"{name[6:]}_ms": ms(got(name, "device_s")) for name in STAGES}
    outside = [(s, e) for _, s, e, names in a["device"] if not set(names) & set(STAGES)]
    out["unspanned_ms"] = ms(spans.union_s(outside))
    out["stages_sum_ms"] = sum(out.values())
    out["busy_ms"] = ms(a["busy_s"])
    out["window_ms"] = ms(window_s)
    out["call_idle_ms"] = ms(a["idle_by_span"].get(ROOT_SPAN, 0.0))
    out["between_calls_idle_ms"] = ms(a["idle_by_span"].get(spans.NONE, 0.0))
    out["self_device_ms"] = {k: ms(v["self_device_s"]) for k, v in a["spans"].items()}
    out["host_ms"] = {k: ms(v["host_s"]) for k, v in a["spans"].items()}
    out["instances"] = {k: v["count"] / calls for k, v in a["spans"].items()}
    by_op = defaultdict(lambda: defaultdict(float))
    for name, s, e, names in a["device"]:
        stage = next((n for n in names if n in STAGES), spans.NONE)
        by_op[stage][name[:100]] += (e - s) / 1e6
    out["stage_ops_ms"] = {stage: [[k, ms(v)] for k, v in
                                   sorted(ops.items(), key=lambda kv: -kv[1])[:5]]
                           for stage, ops in by_op.items()}
    out["idle_gaps"] = [[name, 1e3 * s] for name, s in spans.name_gaps(events, a["gaps"])]
    return out


def stage_reading(cell, seed: int, dev, seconds: float) -> dict:
    """Set-up, a window of ``seconds`` with the cell's traced stretch, and
    ``per_call`` of that stretch, beside the busy time and the device rows
    that ``trace.summarize`` reads from the same profile."""
    run = cell.runner().Run(cell, seed, dev)
    run.setup()
    tracer = Tracer(cell.traffic["trace_skip"], cell.traffic["trace_units"], dev)
    run.window(seconds, tracer)
    if tracer.window_s is None:
        raise SystemExit(f"the window of {seconds} s ended before the traced stretch")
    calls = len(tracer.args)
    out = per_call(tracer.prof.events(), spans.links(tracer.prof), tracer.window_s, calls)
    old = summarize(tracer.prof, tracer.window_s)
    out["summarize"] = {"busy_ms": 1e3 * old["busy_s"] / calls,
                        "device_rows": len(old["device"]), "device_ops": old["device_ops"][:3]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = bench.Cell(ROOT, args.workload)
    if cell.traffic["runner"] != "predict":
        raise SystemExit(f"{args.workload} runs no predictor calls")
    bench.check_card(cell.entry["chips"])
    bench.check_program(ROOT)
    line = {"workload": args.workload, "seed": args.seed, "card": bench.power_limit(),
            "torch": torch.__version__,
            **stage_reading(cell, args.seed, torch.device("cuda"), args.seconds)}
    if args.out:
        with open(args.out, "a") as sink:
            sink.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
