"""A small copy of the benchmark's files, for CPU runs of the harness."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# A train cell for the train runner, which no cell of BENCHMARK.json uses
# yet: the mix a train cell would give, at a CPU's size, and its limits
TRAIN_CELL = "mggan4_train_tiny"
TRAIN_MIX = {"runner": "train", "scenes": 16, "batch_scenes": 4, "peds": [1, 4], "max_peds": 4,
             "extent_m": [[15.0, 12.0], [13.0, 10.5]], "px_per_meter": 2.0,
             "speed_m": [0.2, 0.6], "jitter_m": 0.03, "compare_steps": 3, "trace_skip": 1,
             "trace_units": 2}
TRAIN_LIMITS = {"loss_gap": 6e-06, "grad_gap": 5e-05, "change_gap": 0.045, "agents_gap": 0.0}
TRAIN_METRICS = ("train_mfu", "decoder_roofline.train", "device_idle_share.train",
                 "device_ops_per_step.train")


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def add_train_cell(root: Path):
    """``TRAIN_CELL`` with its mix, its limits, its end-to-end metric and
    the train runner's per-layer metrics, in the copy at ``root``."""
    (root / "portbench/traffic/train_tiny.json").write_text(json.dumps(TRAIN_MIX))
    (root / f"portbench/workloads/{TRAIN_CELL}.json").write_text(
        json.dumps({"limits": TRAIN_LIMITS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TRAIN_CELL, "config": "mggan4_zara1",
                              "traffic": "train_tiny", "chips": 1, "why": "the train runner"})
    spec["end_to_end"].insert(0, {"name": "train_agents_per_s", "unit": "agents/s",
                                  "better": "higher", "bound": 0.25, "source": "host_clock",
                                  "workloads": [TRAIN_CELL]})
    for name in TRAIN_METRICS:
        mod = _reader(root, name)
        better = "higher" if mod.UNIT == "%" and "idle" not in name else "lower"
        spec["per_layer"].append({"name": name, "unit": mod.UNIT, "better": better,
                                  "source": "device_trace", "layer": mod.LAYER,
                                  "moves": mod.MOVES, "workloads": [TRAIN_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _reader(root: Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"probe_{name}",
                                                  root / f"portbench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_tiny_root(tmp: Path) -> Path:
    """The benchmark's files with every traffic mix cut to a few scenes of
    up to 4 agents and 3 samples, and the train cell: the same code paths
    at a CPU's size."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (tmp / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(scenes=16, peds=[1, 4], max_peds=4, num=3, distinct_batches=2,
                   trace_skip=1, trace_units=2)
        path.write_text(json.dumps(mix))
    for path in (tmp / "portbench" / "configs").glob("*.json"):
        doc = json.loads(path.read_text())
        doc["config"].update(num_samples=3)
        path.write_text(json.dumps(doc))
    add_train_cell(tmp)
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
