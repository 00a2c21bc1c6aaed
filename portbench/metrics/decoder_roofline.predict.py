"""The fused-selection decoder kernel's (K1's) share of its roofline in
the traced predictor calls: the least time of the rollouts of the calls'
real agents' samples over the kernel's device time."""

from portbench.harness import roofline

UNIT, LAYER, MOVES = "%", "decoder kernels (ops/kernels/: K1, K2, K3)", "predict_agents_per_s"
PATTERNS = ("decode_select",)


def read(r):
    if r["kind"] != "predict":
        return None
    seconds = sum(e - s for name, s, e in r["device"] if any(p in name for p in PATTERNS)) / 1e6
    if not seconds:
        return None
    num = r["traffic"]["num"]
    least = sum(roofline.select_seconds(r["cfg"], a, num * a) for a, _ in r["units"])
    return 100.0 * least / seconds
