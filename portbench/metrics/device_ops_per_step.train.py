"""Device operations (kernels, copies, fills) launched per traced train
step, from the profiler: the host's dispatch load."""

UNIT, LAYER, MOVES = "ops", "train-step dispatch (training/steps.py)", "train_agents_per_s"


def read(r):
    if r["kind"] != "train" or not r["device"]:
        return None
    return len(r["device"]) / len(r["units"])
