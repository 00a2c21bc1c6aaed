"""The decoder kernels' share of their roofline in the traced train steps:
the least time of the rollouts and reverse sweeps the steps' real agents
need (K1 on one sample in the D step; K2 on K samples of every generator,
saving (h, c), in the G step and on the expectation samples in the PM
step; K3 on the G step's rows) over the kernels' device time."""

from portbench.harness import roofline

UNIT, LAYER, MOVES = "%", "decoder kernels (ops/kernels/: K1, K2, K3)", "train_agents_per_s"
PATTERNS = ("decode_select", "decode_all_fwd", "decode_all_bwd", "decode_all_wgrad")


def read(r):
    if r["kind"] != "train":
        return None
    seconds = sum(e - s for name, s, e in r["device"] if any(p in name for p in PATTERNS)) / 1e6
    if not seconds:
        return None
    cfg = r["cfg"]
    k, ke = cfg["num_samples"], cfg["num_expectation_samples"]
    least = sum(roofline.select_seconds(cfg, a, a)
                + roofline.all_fwd_seconds(cfg, a, k * a, True)
                + roofline.all_fwd_seconds(cfg, a, ke * a, False)
                + roofline.all_bwd_seconds(cfg, a, k * a) for a, _ in r["units"])
    return 100.0 * least / seconds
