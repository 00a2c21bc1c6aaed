"""One rank of a CPU gloo pod for tests/test_torch_port_{dp,pod}.py.

    python tests/_torch_dp_worker.py <spec.pt> <rank> <world>

``spec.pt`` (``torch.save``) holds ``store`` (a ``file://`` rendezvous,
which needs no port), ``timeout_s`` (the rendezvous' and every
collective's), ``local_world`` (ranks per simulated node, set as the
launcher's ``LOCAL_WORLD_SIZE``; 1 makes every rank a node of its own;
None leaves the place to the manual launch, which puts every rank of this
host on one node) and ``cases``, each a dict with ``kind``:

* ``step``: ``make_parallel_train_step`` on ``weights`` (the port's trees)
  for ``config`` (its ``dp``, ``gp`` and ``slices``), this rank's rows of
  ``batch`` and the global ``draws``, on ``device`` (the CPU unless the
  case names the card); the state comes back gathered (``gathered``) and
  as this rank holds it (``local``, with ``gp > 1``);
* ``trainer``: a ``Trainer`` for ``config`` trained for its epochs, with
  the version dir agreed by the ranks;
* ``epoch``: a ``Trainer`` for ``config`` and one ``train_epoch`` of its
  train loader, no validation;
* ``pod``: the sharded loader's lockstep count and ``max_peds``, the
  shard-local bank against host assembly, ``allreduce_sums``;
* ``mismatch``: ``allreduce_sums`` over key sets that differ by rank;
* ``sums``: ``allreduce_sums`` over the data ranks of the grid of
  ``config``'s ``dp`` and ``gp``;
* ``gp_trainer``: a ``Trainer`` for ``config`` trained for its epochs
  (validation and ``save`` included), then ``load_from_path`` of its
  version dir in the pod, each rank's slice of the restored state.

Writes ``out_<rank>.pt`` beside the spec: one result per case. Imports
neither JAX nor the JAX package.
"""

import os
import sys
import traceback
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

torch.set_num_threads(1)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _state(state):
    return {"g_params": _numpy_tree(state.g_params), "g_state": _numpy_tree(state.g_state),
            "d_params": _numpy_tree(state.d_params), "d_state": _numpy_tree(state.d_state),
            "g_mu": _numpy_tree(state.g_opt.mu), "g_nu": _numpy_tree(state.g_opt.nu),
            "d_mu": _numpy_tree(state.d_opt.mu), "d_nu": _numpy_tree(state.d_opt.nu),
            "step": state.step, "best_val": state.best_val}


def run_step(case):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.models import factory
    from mggan_tpu_torch.models.factory import tree_to
    from mggan_tpu_torch.parallel import dp
    from mggan_tpu_torch.parallel.mesh import make_mesh
    from mggan_tpu_torch.training.state import init_train_state

    cfg = Config(**case["config"])
    grid = make_mesh(cfg.dp, cfg.gp, cfg.slices, device=case.get("device", "cpu"))
    w = {k: tree_to(v, grid.device) for k, v in case["weights"].items()}
    g_pack = (w["g_params"], w["g_state"], factory.build_specs(cfg))
    d_pack = (w["d_params"], w["d_state"], factory.build_d_spec(cfg))
    state = init_train_state(cfg, g_pack, d_pack)
    step, state = dp.make_parallel_train_step(cfg, g_pack[2], d_pack[2], grid, state)
    local = {k: torch.as_tensor(v, device=grid.device)
             for k, v in dp.shard_batch(grid, case["batch"]).items()}
    from mggan_tpu_torch.ops import kernels

    kernels.launches.clear()
    state, metrics = step(state, local, case["draws"])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "rows": int(np.shape(local["ped_mask"])[0]), "grid": grid.describe(),
           "launches": dict(kernels.launches), "state": _state(state)}
    if cfg.gp > 1:
        out["local"], out["state"] = out["state"], _state(dp.gather_generators(state, grid))
    return out


def run_trainer(case):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    cfg = Config(**case["config"])
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu").train()
    return {"state": _state(tr.state), "dir": str(writer.dir), "grid": tr.grid.describe()}


def run_epoch(case):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    cfg = Config(**case["config"])
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu")
    values, perf = tr.train_epoch(tr._loaders()[0], 0)
    return {"state": _state(tr.state), "metrics": values, "agents": perf["agents"],
            "steps": perf["steps"], "grid": tr.grid.describe()}


def run_pod(case):
    from mggan_tpu_torch.data.loaders import get_dataloader
    from mggan_tpu_torch.eval.metrics import allreduce_sums
    from mggan_tpu_torch.parallel import pod

    pid = pod.process_index()
    common = dict(batch_size=case["batch_size"], shard_by_process=True, device="cpu")
    host = get_dataloader("synthetic_memory", "train", **common)
    bank = get_dataloader("synthetic_memory", "train", patch_bank=True, **common)
    assert bank.patch_bank is not None, "the bank fell back to host assembly"
    bank_equal, bank_sum, windows = True, 0, []
    for bh, bb in zip(host, bank):
        got = bb["big_patches"].numpy()
        bank_equal &= bool(np.array_equal(got, bh["big_patches"]))
        bank_sum += int(got.astype(np.int64).sum())
        windows.append(bh["window_idx"].tolist())
    sums = {"ADE k=3": (float(pid + 1), 2.0), "FDE k=3": (10.0, 1.0)}
    return {"process": (pid, pod.process_count()), "num_batches": len(host),
            "batches": sum(1 for _ in host), "max_peds": int(host.max_peds),
            "bank_equal": bank_equal, "bank_sum": bank_sum, "windows": windows,
            "n_windows": host.num_windows(), "reduced": allreduce_sums(sums)}


def run_mismatch(case):
    from mggan_tpu_torch.eval.metrics import allreduce_sums
    from mggan_tpu_torch.parallel import pod

    keys = ["ADE k=3"] + (["FDE k=3"] if pod.rank() == 0 else [])
    try:
        allreduce_sums({k: (1.0, 1.0) for k in keys})
    except ValueError as err:
        return {"raised": str(err)}
    return {"raised": None}


def run_sums(case):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.eval.metrics import allreduce_sums
    from mggan_tpu_torch.parallel.mesh import make_mesh

    cfg = Config(**case["config"])
    grid = make_mesh(cfg.dp, cfg.gp, cfg.slices, device="cpu")
    sums = {"ADE k=3": (float(grid.rank + 1), 2.0), "FDE k=3": (10.0, 1.0)}
    return {"reduced": allreduce_sums(sums, grid.host_group), "grid": grid.describe()}


def run_gp_trainer(case):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    cfg = Config(**case["config"])
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu").train()
    resumed, _ = Trainer.load_from_path(writer.dir, device="cpu")
    return {"local": _state(tr.state), "resumed": _state(resumed.state), "dir": str(writer.dir),
            "grid": tr.grid.describe(), "epoch": resumed.state.epoch}


def launch(tmp_path, world: int, cases: list, local_world: int | None = None,
           timeout_s: float = 120, device="cpu"):
    """Run ``cases`` on ``world`` ranks of this worker; returns each rank's
    results. A rank that fails, or outlives ``timeout_s`` plus a margin,
    fails the call; every process is ended before it returns."""
    import subprocess

    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    spec = tmp_path / "spec.pt"
    torch.save({"store": f"file://{tmp_path / 'store'}", "timeout_s": timeout_s,
                "local_world": local_world, "cases": cases, "device": device}, spec)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(spec), str(r),
                               str(world)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s + 60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    results = [torch.load(tmp_path / f"out_{r}.pt", weights_only=False) for r in range(world)]
    for r, res in enumerate(results):
        errors = [c["error"] for c in res if "error" in c]
        assert not errors, f"rank {r}:\n{errors[0]}"
    return results


def main():
    spec_path, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    spec = torch.load(spec_path, weights_only=False)
    if spec["local_world"] is not None:  # a simulated node, as the launcher sets it
        os.environ["LOCAL_WORLD_SIZE"] = str(spec["local_world"])
        os.environ["LOCAL_RANK"] = str(rank % spec["local_world"])
    from mggan_tpu_torch.parallel import pod

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 on the card
    torch.backends.cudnn.allow_tf32 = False
    pod.init_distributed(spec["store"], world, rank, device=spec.get("device", "cpu"),
                         timeout_s=spec["timeout_s"])
    runners = {"step": run_step, "trainer": run_trainer, "epoch": run_epoch, "pod": run_pod,
               "mismatch": run_mismatch, "sums": run_sums, "gp_trainer": run_gp_trainer}
    out = []
    for case in spec["cases"]:
        try:
            out.append(runners[case["kind"]](case))
        except Exception:
            out.append({"error": traceback.format_exc()})
            break
    torch.save(out, spec_path.parent / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
