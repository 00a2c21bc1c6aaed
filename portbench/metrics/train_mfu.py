"""The traced train steps' share of the H100's float32 peak: the
benchmark's own count of the products the steps' real agents need, over
the traced wall time."""

from portbench.harness.roofline import H100_FP32_FLOPS

UNIT, LAYER, MOVES = "%", "train step (training/steps.py, models/)", "train_agents_per_s"


def read(r):
    if r["kind"] != "train" or not r["window_s"]:
        return None
    return 100.0 * r["flops"] / r["window_s"] / H100_FP32_FLOPS
