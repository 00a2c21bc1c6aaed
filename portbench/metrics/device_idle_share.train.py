"""The share of the traced stretch in which no device operation ran: one
less the union of the operations' intervals over the stretch's wall time."""

UNIT, LAYER, MOVES = "%", "device", "train_agents_per_s"


def read(r):
    if r["kind"] != "train" or not r["device"]:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
