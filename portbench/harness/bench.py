"""What every run shares: the benchmark's files, found by name; the card's
record; the per-layer metrics' readers; the check that nothing of JAX was
loaded; and the result's last line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. ``configs/<config>.json`` holds the configuration as it is
run, ``traffic/<traffic>.json`` the mix's parameters (its ``runner`` names
``runners/<runner>.py``, the general runner that reads them and judges
what the window produced), ``workloads/<cell>.json`` the cell's limits on
the numbers that decide ``correct``, and ``metrics/<metric>.py`` each
per-layer metric's reader. The harness changes none of the program's
settings: PyTorch's switches and thread count stay as the program leaves
them.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "mggan_tpu")


class Cell:
    """One cell's files, read from the checkout at ``root``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name, self.entry, self.spec = name, cells[name], spec
        here = self.root / "portbench"
        self.config_file = json.loads((here / "configs" / f"{self.entry['config']}.json")
                                      .read_text())
        self.cfg = self.config_file["config"]
        self.traffic = json.loads((here / "traffic" / f"{self.entry['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((here / "workloads" / f"{name}.json").read_text())["limits"]
        self.here = here

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        return [m for m in self.spec["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``."""
        return _load(self.here / "metrics" / f"{metric}.py", f"portbench_metric_{metric}")

    def runner(self):
        """The module ``runners/<runner>.py`` that the traffic mix names:
        its ``Run(cell, seed, device)`` sets up, runs the window and judges
        what the window produced."""
        name = self.traffic["runner"]
        return _load(self.here / "runners" / f"{name}.py", f"portbench_runner_{name}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_card(chips: int):
    """Fail, with no result, unless ``chips`` CUDA cards are there."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards; {torch.cuda.device_count()} seen")


def check_program(root: Path):
    """Fail unless the program imported is the checkout's own."""
    import mggan_tpu_torch

    where = Path(mggan_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise SystemExit(f"mggan_tpu_torch comes from {where}, not from {root}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc.__class__.__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unread"


def device_record(device, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak_bytes, "power_limit": power_limit()}


def loaded_forbidden() -> list:
    """Top-level names of ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def compared(numbers: dict, limits: dict) -> tuple[dict, list]:
    """Each limit's number beside it, and the names over it; a number the
    run did not give reads NaN and fails."""
    out, over = {}, []
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        if not (value <= limit):  # NaN fails
            over.append(name)
    return out, over


def emit(result: dict, numbers: dict):
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, v in numbers.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
