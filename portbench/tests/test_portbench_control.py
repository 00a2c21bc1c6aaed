"""The control on the card: the reference computed in bfloat16, put in the
program's place, has to come out as not correct, while the program itself
stays within the limits. Every cell of ``BENCHMARK.json`` at its own size
(the traffic mix as the cell runs it), on one seed.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_control.py

needs a CUDA card and skips without one; ``portbench/calibrate.py`` reads
the same numbers on more seeds.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    from portbench import calibrate
    from portbench.harness import bench

    spec = bench.Cell(REPO, cell)
    got = calibrate.readings(spec, 2**31 + 5, card, True, 1.0)
    assert all(v <= spec.limits[k] for k, v in got["program"].items()), got
    assert any(v > spec.limits[k] for k, v in got["control"].items()), got
