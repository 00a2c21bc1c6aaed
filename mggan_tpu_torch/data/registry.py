"""Dataset registry: schemas, delimiters, homographies, unit conventions
(counterpart of ``mggan_tpu/data/registry.py``, copied: the port imports
nothing of the JAX package).

Mirrors the reference's ``Experiment`` class hierarchy
(data_utils/experiments.py:28-508) as declarative records.  Notable
per-dataset facts preserved:

* BIWI files store columns as (frame, ID, y, x) — x/y swapped
  (experiments.py:185) — already in meters at 0.05 m/px image scaling.
* SDD ("stanford") has the 12-column annotation schema, rows filtered to
  label==Pedestrian and lost==0, frames subsampled to 0.4 s at 30 fps, and
  pixel coords scaled to meters by a per-scene homography ratio read from
  ``H_SDD.txt`` (experiments.py:194-223).
* GOFP is pixel-format at 10 fps with a hardcoded per-scene ratio table and
  an ``is_active`` column that NaN-masks inactive futures
  (experiments.py:476-508).
* The synthetic SDD sets declare framerate 30 in the reference
  (experiments.py:256,291,325,359) but are NOT frame-subsampled: the loader
  subsamples only ``dataset_name in ("stanford", "gofp")``
  (BaseTrajectories.py:145-147), so their registry entries here carry no
  framerate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from mggan_tpu_torch.data import table

BIWI_COLUMNS = ["frame", "ID", "y", "x"]
SDD_COLUMNS = [
    "ID",
    "xmin",
    "ymin",
    "xmax",
    "ymax",
    "frame",
    "lost",
    "occluded",
    "generated",
    "label",
    "x",
    "y",
]
GOFP_COLUMNS = [
    "frame",
    "ID",
    "x",
    "y",
    "moment",
    "old_frame",
    "old_ID",
    "is_active",
]

GOFP_RATIOS = {
    "zara1": 0.03109532180986424,
    "eth": 0.06668566952360758,
    "hotel": 0.0225936169079401,
    "0000": 0.042200689823829046,
    "0400": 0.07905284109247492,
    "0401": 0.0598454105469989,
    "0500": 0.04631904070838066,
    "zara2": 0.03109532180986424,
}


@dataclass
class DatasetInfo:
    name: str
    data_columns: list
    delim: str = "\t"
    fmt: str = "meter"  # "meter" | "pixel"
    img_scaling: float = 0.05  # meters per pixel of the scaled image
    scale: bool = False  # rescale raw coords by per-scene homography ratio
    norm2meters: bool = False
    framerate: Optional[float] = None  # triggers frame subsampling
    homography: str = "none"  # "none" | "sdd_csv" | "gofp_table"
    scaling_small: float = 0.5  # patch-image meters/px (data_loaders.py:30-87)
    scaling_tiny: float = 0.25  # debug-pyramid meters/px (BaseTrajectories.py:41)
    row_filters: dict = field(default_factory=dict)
    extra_columns: list = field(default_factory=list)


def _biwi(name):
    return DatasetInfo(name=name, data_columns=BIWI_COLUMNS, scaling_small=0.5)


REGISTRY = {
    "eth": _biwi("eth"),
    "hotel": _biwi("hotel"),
    "univ": _biwi("univ"),
    "zara1": _biwi("zara1"),
    "zara2": _biwi("zara2"),
    "stanford": DatasetInfo(
        name="stanford",
        data_columns=SDD_COLUMNS,
        fmt="pixel",
        scale=True,
        norm2meters=True,
        framerate=30,
        homography="sdd_csv",
        scaling_small=0.7,
        row_filters={"label": "Pedestrian", "lost": 0},
    ),
    "gofp": DatasetInfo(
        name="gofp",
        data_columns=GOFP_COLUMNS,
        fmt="pixel",
        scale=True,
        norm2meters=True,
        framerate=10,
        homography="gofp_table",
        scaling_small=0.5,
    ),
    "stanford_synthetic": DatasetInfo(
        name="stanford_synthetic",
        data_columns=SDD_COLUMNS + ["_"],
        scaling_small=1.2,
        row_filters={"label": "Pedestrian", "lost": 0},
    ),
    "stanford_synthetic_2": DatasetInfo(
        name="stanford_synthetic_2",
        data_columns=SDD_COLUMNS + ["_"],
        scaling_small=1.2,
        row_filters={"label": "Pedestrian", "lost": 0},
    ),
    "stanford_synthetic_4": DatasetInfo(
        name="stanford_synthetic_4",
        data_columns=SDD_COLUMNS + ["_"],
        scaling_small=1.2,
        row_filters={"label": "Pedestrian", "lost": 0},
    ),
    "social_stanford_synthetic": DatasetInfo(
        name="social_stanford_synthetic",
        data_columns=SDD_COLUMNS + ["_", "other_ped"],
        scaling_small=1.2,
        row_filters={"label": "Pedestrian", "lost": 0},
    ),
}


def get_info(name: str) -> DatasetInfo:
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def phase_dir(data_root, name: str, phase: str) -> Path:
    assert phase in ("train", "val", "test"), phase
    return Path(data_root) / name / phase


def load_sdd_ratios(data_root, name: str) -> dict:
    """Parse H_SDD.txt (File/Version/Ratio table; experiments.py:215-217),
    tab-separated with a header row, without pandas (``data/table.py``)."""
    path = Path(data_root) / name / "H_SDD.txt"
    cols = table.read_table(path, "\t", header=True)
    n = len(next(iter(cols.values()), ()))
    out = {}
    for i in range(n):
        version = cols["Version"][i] if "Version" in cols else "A"
        if str(version) == "A":
            out[str(cols["File"][i]).replace(".jpg", "")] = float(cols["Ratio"][i])
    return out
