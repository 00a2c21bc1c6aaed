"""Tiny runs of every cell on the CPU: the result's last line, the
judgement, the per-layer metrics found by name, and planted faults that
must come out as not correct."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO, TRAIN_CELL
from portbench import run
from portbench.harness import bench

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS + [TRAIN_CELL])
def test_tiny_run_gives_a_well_formed_correct_result(tiny_root, cell, capsys):
    result, shown = run.run_cell(tiny_root, cell, 2**31 + 11, 0.3, False, device="cpu")
    bench.emit(result, shown)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert err.strip().splitlines()[-len(shown):] == [
        f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    assert KEYS <= set(result) and list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    spec = bench.Cell(tiny_root, cell)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end()}
    for m in spec.end_to_end():
        assert result["metrics"][m["name"]]["unit"] == m["unit"]
        assert result["metrics"][m["name"]]["value"] > 0
    assert set(shown) == set(spec.limits)


def test_without_a_card_there_is_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                          text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_without_the_program_is_refused(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    with pytest.raises(SystemExit):
        bench.check_program(tmp_path)


def test_a_dropped_metric_is_read_with_no_edit_to_the_runner(tiny_root):
    (tiny_root / "portbench/metrics/window_share_probe.py").write_text(
        'UNIT, LAYER, MOVES = "%", "device", "predict_agents_per_s"\n\n\n'
        'def read(r):\n    return 100.0 * r["window_s"] / max(r["window_s"], 1e-9)\n')
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "window_share_probe", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "predict_agents_per_s",
                              "workloads": ["mggan4_sample_b4096"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = run.run_cell(tiny_root, "mggan4_sample_b4096", 3, 0.3, True, device="cpu")
    assert result["metrics"]["window_share_probe"]["value"] == 100.0
    assert "predict_mfu" in result["metrics"]


def test_every_per_layer_entry_is_its_readers():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = bench.Cell(REPO, CELLS[0])
    for m in spec["per_layer"]:
        mod = cell.reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])


# ---------------------------------------------------------- planted faults
def _break_trainer(monkeypatch, fault):
    from portbench.harness import program

    make = program.trainer

    def broken(*args, **kwargs):
        tr = make(*args, **kwargs)
        step = tr.train_step

        def unchanged(state, batch, draws):
            return state.replace(step=state.step + 1), step(state, batch, draws)[1]

        def half(state, batch, draws):
            mask = batch["ped_mask"].clone()
            mask[mask.shape[0] // 2:] = False
            return step(state, dict(batch, ped_mask=mask), draws)

        tr.train_step = {"unchanged": unchanged, "half": half}[fault]
        return tr

    monkeypatch.setattr(program, "trainer", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(tiny_root, monkeypatch, fault):
    _break_trainer(monkeypatch, fault)
    result, _ = run.run_cell(tiny_root, TRAIN_CELL, 17, 0.2, False, device="cpu")
    assert result["correct"] is False and result["failed"] > 0


def _break_predictor(monkeypatch, fault):
    from mggan_tpu_torch.models import generator

    from portbench.harness import program

    if fault == "altered":
        select = generator.decoder_kernel.decode_select

        def altered(*args, **kwargs):
            out_abs, out_rel = select(*args, **kwargs)
            out_abs = out_abs.clone()
            out_abs[0, -1] += 0.5
            return out_abs, out_rel

        monkeypatch.setattr(generator.decoder_kernel, "decode_select", altered)
        return
    make = program.predictor

    def broken(*args, **kwargs):
        pred = make(*args, **kwargs)
        predict = pred.predict

        def half(batch, generator=None, num=20, draws=None):
            s = batch["ped_mask"].shape[0] // 2
            out = predict({k: v[:s] for k, v in batch.items()}, generator, num,
                          {"uniforms": draws["uniforms"][:, :s], "z": draws["z"][:, :s]})
            pad = lambda x, axis: torch.cat([x, torch.zeros_like(x)], axis)  # noqa: E731
            return pad(out[0], 1), pad(out[1], 1), pad(out[2], 0), pad(out[3], 0)

        pred.predict = half
        return pred

    monkeypatch.setattr(program, "predictor", broken)


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_predictor_is_not_correct(tiny_root, monkeypatch, fault):
    _break_predictor(monkeypatch, fault)
    result, _ = run.run_cell(tiny_root, "mggan4_sample_b4096", 19, 0.2, False, device="cpu")
    assert result["correct"] is False and result["failed"] > 0
