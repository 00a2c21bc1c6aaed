"""The train loop and the CLI pair for the families beyond the flagship (CPU).

A probgan ``Trainer`` (12 steps an epoch, so the history is averaged at
steps 0, 10 and 20) resumes across a checkpoint bit for bit, its history
heads and length included, with the gated, unrolled D of the families'
case D in a second run; and ``single_gen_eth``'s flags (one generator,
gan, no PM target) at h = 16 go through ``cli.train`` and
``cli.evaluate`` on tmp-dir BIWI ``eth`` fixtures, as
``test_torch_port_cli.py`` runs the flagship's.
"""

import csv

import numpy as np
import pytest
import torch

from mggan_tpu_torch.cli import evaluate as evaluate_cli
from mggan_tpu_torch.cli import train as train_cli
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.configs import BENCHMARK_CONFIGS
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter
from test_torch_port_cli import _jpg
from test_torch_port_loop import _cfg, _leaves, _metrics

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)


def _port_trainer(tmp_path, version, **kw):
    cfg = Config(**_cfg(tmp_path, **{"epochs": 2, **kw}))
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=version,
                              config=cfg, tensorboard=False)
    return Trainer(cfg, writer, device="cpu")


@pytest.mark.parametrize("kw", [
    {"gan_type": "probgan", "batch_size": 4},
    {"num_unrolling_steps": 1, "num_gen_steps": 2, "keep_gen_steps": 2, "batch_size": 12},
], ids=["probgan", "unrolled-gated"])
def test_resume_replays_an_uninterrupted_run_bit_for_bit(tmp_path, kw):
    whole = _port_trainer(tmp_path, 1, **kw).train()
    part = _port_trainer(tmp_path, 2, **kw).train(until_epoch=1)
    resumed, _ = Trainer.load_from_path(part.writer.dir, checkpoint="latest", device="cpu")
    resumed.train()
    a, b = whole.state, resumed.state
    assert (a.step, a.epoch, a.g_opt.count, a.d_opt.count) == \
        (b.step, b.epoch, b.g_opt.count, b.d_opt.count)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("perf/")}
    assert [strip(m) for m in _metrics(whole.writer)] == \
        [strip(m) for m in _metrics(resumed.writer)]
    if kw.get("gan_type") == "probgan":
        assert a.step == 24 and float(a.d_state["hist"]["len"]) == 4.0
        assert not torch.equal(a.d_state["hist"]["discs"]["lin0"]["w"],
                               a.d_params["discs"]["lin0"]["w"])
    else:  # epoch 1 (state.epoch 1 < keep_gen_steps 2) gates every odd step out
        epochs = _metrics(whole.writer)
        assert a.d_opt.count == 2 * (2 + 4)  # 2 updates per D step: 2 in epoch 1, 4 in 2
        assert all(np.isfinite(m["train/discr_loss"]) for m in epochs)


def _write_eth(root, frames=(120, 60, 60)):
    """BIWI ``eth`` (frame, ID, y, x in metres; consecutive frames), straight
    walkers 3 at a time, and the scene image."""
    rng = np.random.RandomState(0)
    for phase, n in zip(("train", "val", "test"), frames):
        d = root / "eth" / phase
        d.mkdir(parents=True)
        rows = []
        for f in range(n):
            for p in range(3):
                pid = p + 3 * (f // 30)
                x = 2.0 + p * 1.5 + 0.3 * (f % 30) + 0.02 * rng.randn()
                y = 3.0 + 0.1 * (f % 30) + 0.02 * rng.randn()
                rows.append(f"{float(f)}\t{float(pid)}\t{y:.4f}\t{x:.4f}")
        (d / f"{phase}_eth.txt").write_text("\n".join(rows))
        _jpg(d / "eth.jpg", 400)


def test_single_gen_eth_cli_pair(tmp_path):
    """``single_gen_eth``'s flags (h = 16, 1 epoch, batch 8) train and
    evaluate: a finite CSV with one ``sampling`` row (one generator)."""
    root = tmp_path / "data"
    _write_eth(root)
    flags = {**BENCHMARK_CONFIGS["single_gen_eth"], "epochs": 1, "batch_size": 8,
             "h_dim": 16, "decoder_h_dim": 16, "num_samples": 4, "top_k_test": 3,
             "augment": 0}
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    model = train_cli.main(argv + ["--name", "single_gen_eth", "--log_dir",
                                   str(tmp_path / "logs"), "--data_root", str(root),
                                   "--device", "cpu"])
    assert model.config.gan_type == "gan" and model.config.num_gens == 1
    assert model.state.step > 0 and "net_chooser" in model.state.g_params
    lines = _metrics(model.writer)
    assert len(lines) == 1 and np.isfinite(lines[0]["val/ADE k=3"])
    assert "train/net_chooser_loss" not in lines[0]
    csv_path = evaluate_cli.main(["--model_path", str(model.writer.dir.parent),
                                  "--output_folder", str(tmp_path / "results"),
                                  "--phase", "test", "--num_preds", "4", "--pred_strat", "all",
                                  "--data_root", str(root), "--device", "cpu"])
    with open(csv_path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["Prediction strategy"] for r in rows] == ["sampling"]
    metrics = [c for c in rows[0] if c.startswith(("ADE k=", "FDE k=", "Mode k=",
                                                   "Precision", "Recall k="))]
    assert len(metrics) == 4 * 3 + 1
    assert all(np.isfinite(float(rows[0][c])) for c in metrics)
