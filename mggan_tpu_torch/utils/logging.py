"""Experiment logging (counterpart of ``mggan_tpu/utils/logging.py``):
version dirs, ``meta_tags.csv``, a per-epoch metric CSV and optional
TensorBoard, covering the reference's test_tube Experiment usage
(train.py:678-690, abstract_train.py:193-194). The files have the JAX
package's layout, so either package's ``meta_tags.csv`` loads in the other.

In a data-parallel pod (``parallel/pod.py``) rank 0 draws the random
version and every rank takes it (the JAX package draws one per process,
so each would write a dir of its own), and only rank 0 writes.
"""

from __future__ import annotations

import csv
import json
import random
from pathlib import Path

from mggan_tpu_torch.parallel import pod


class ExperimentWriter:
    """Writes to ``<log_dir>/<experiment>/<name>/version_<V>/``:
    - meta_tags.csv  (config key/value, the reference's format)
    - metrics.csv    (one row per epoch)
    - metrics.jsonl  (the same, one JSON object per epoch)
    - tf/            (TensorBoard events, when tensorboardX is installed)
    - checkpoints/   (``training/checkpoints.py`` files)
    """

    def __init__(self, log_dir, experiment, name, version=None, config=None,
                 tensorboard=True):
        if version is None:
            version = pod.broadcast_object(random.randint(10**10, 10**11 - 1))
        self.version = version
        self.dir = Path(log_dir) / experiment / name / f"version_{version}"
        self.checkpoint_dir = self.dir / "checkpoints"
        # rank 0 writes (every rank of a pod on its own but rank 0 reads)
        self.writes = pod.is_primary()
        if self.writes:
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = self.dir / "metrics.csv"
        self._jsonl_path = self.dir / "metrics.jsonl"
        self._keys = None
        self._tb = None
        if tensorboard and self.writes:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.dir / "tf"))
        if config is not None:
            self.save_config(config)

    def save_config(self, config):
        if not self.writes:
            return
        with open(self.dir / "meta_tags.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["key", "value"])
            for k, v in config.to_dict().items():
                w.writerow([k, v])

    def log(self, metrics: dict, epoch: int):
        if not self.writes:
            return
        metrics = {k: float(v) for k, v in metrics.items()}
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **metrics}) + "\n")
        write_header = not self._metrics_path.exists()
        with open(self._metrics_path, "a", newline="") as f:
            w = csv.writer(f)
            if write_header or self._keys is None:
                self._keys = ["epoch"] + sorted(metrics)
            if write_header:
                w.writerow(self._keys)
            w.writerow([epoch] + [metrics.get(k, "") for k in self._keys[1:]])
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, epoch)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def load_meta_tags(path) -> dict:
    """Parse meta_tags.csv back into a dict (utils.py:97-106 semantics)."""
    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["key"]] = _convert(row["value"])
    return out


def _convert(val: str):
    if val.lower() == "true":
        return True
    if val.lower() == "false":
        return False
    if val in ("", "None"):
        return None
    for c in (int, float):
        try:
            return c(val)
        except ValueError:
            pass
    return val


def checkpoint_epochs(ckpt_dir) -> list:
    """The epochs N of the ``checkpoint_N`` entries in ``ckpt_dir``."""
    epochs = []
    for c in Path(ckpt_dir).iterdir():
        tail = c.name.split("_")[-1]
        if tail.isdigit():
            epochs.append(int(tail))
    return epochs


def get_versions(logs_dir) -> list:
    """``(version, "best" | latest epoch)`` of each version dir under
    ``logs_dir`` with a usable checkpoint (utils.py:202-231)."""
    versions = []
    logs_dir = Path(logs_dir)
    if not logs_dir.is_dir():
        return versions
    for version in logs_dir.iterdir():
        if not version.is_dir() or "version" not in version.name:
            continue
        ckpt_dir = version / "checkpoints"
        if not ckpt_dir.is_dir() or not (version / "meta_tags.csv").is_file():
            continue
        vnum = int(version.stem.split("_")[1])
        if (ckpt_dir / "checkpoint_best").exists():
            versions.append((vnum, "best"))
            continue
        epochs = checkpoint_epochs(ckpt_dir)
        if epochs:
            versions.append((vnum, max(epochs)))
    return versions
