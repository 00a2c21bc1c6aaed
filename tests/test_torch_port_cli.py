"""The port's train -> evaluate CLI pair on the CPU (``--device cpu``).

The drill of ``tests/test_realdata_drill.py::_run_cli_pair`` through
``mggan_tpu_torch.cli.train`` and ``mggan_tpu_torch.cli.evaluate`` on tmp-dir
fixtures in the SDD and GOFP release layouts, the CSV's columns against the
JAX CLI's (``mggan_tpu/cli/evaluate.py:128-150``, the metric keys from the
JAX metric functions), its bytes against ``pandas.DataFrame.to_csv``, the
generator's parameter count against the JAX factory's, ``--checkpoint``
resume, and the parser and the named configurations against the JAX
package's. No JAX training runs here: the train loop is held to JAX's in
``tests/test_torch_port_loop.py``.
"""

import dataclasses
import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from mggan_tpu import config as jax_config
from mggan_tpu import configs as jax_configs
from mggan_tpu.cli import evaluate as jax_evaluate_cli
from mggan_tpu.eval import evaluate as jax_evaluate
from mggan_tpu.eval import manifold as jax_manifold
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator
from mggan_tpu.utils.pytree import count_parameters
from mggan_tpu_torch import config, configs
from mggan_tpu_torch.cli import evaluate as evaluate_cli
from mggan_tpu_torch.cli import train as train_cli
from mggan_tpu_torch.data import parsing
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

PHASES = ("train", "val", "test")
TRAIN_FLAGS = [
    "--epochs", "1", "--batch_size", "4", "--num_gens", "2",
    "--h_dim", "16", "--decoder_h_dim", "16", "--num_samples", "2",
    "--num_expectation_samples", "1", "--top_k_test", "2",
    "--val_every", "1", "--augment", "0", "--device", "cpu",
]
# mggan_tpu/cli/evaluate.py:128-150, in order (no --eval_set)
META_COLUMNS = ["Model", "# Generators", "Decoder dim", "Generator params",
                "Prediction strategy", "Mode", "Use Classifier", "Prior", "Dataset",
                "Maximization Samples", "Expectation Samples", "L2 loss weight",
                "Clf loss weight", "Sigma"]


def _jpg(path, size):
    img = np.full((size, size, 3), 90, np.uint8)
    img[size // 3: size // 2] = 200
    cv2.imwrite(str(path), img)


def _write_sdd(root: Path):
    (root / "stanford").mkdir(parents=True)
    (root / "stanford" / "H_SDD.txt").write_text("File\tVersion\tRatio\nsc0.jpg\tA\t0.04\n")
    rng = np.random.RandomState(0)
    for pi, phase in enumerate(PHASES):
        d = root / "stanford" / phase
        d.mkdir()
        rows = []
        for f in range(0, 12 * 27, 12):
            for p in range(3):
                x = 100 + p * 40 + f * (0.02 + 0.01 * pi) + rng.rand()
                y = 200 + f * 0.02 + rng.rand()
                rows.append(f"{p}\t0\t0\t0\t0\t{f}\t0\t0\t0\tPedestrian\t{x}\t{y}")
                rows.append(f"{90 + p}\t0\t0\t0\t0\t{f}\t0\t0\t0\tBiker\t{x}\t{y}")
        (d / f"{phase}_sc0.txt").write_text("\n".join(rows))
        _jpg(d / "sc0.jpg", 400)


def _write_gofp(root: Path):
    for phase in PHASES:
        d = root / "gofp" / phase
        d.mkdir(parents=True)
        rows = []
        for f in range(0, 4 * 26, 4):
            for p in range(3):
                active = 0 if (p == 2 and f == 4 * 13) else 1
                rows.append(f"{float(f)}\t{float(p)}\t{60.0 + p * 30 + f * 0.6}\t"
                            f"{80.0 + f * 0.5}\t0\t0\t{p}\t{active}")
        (d / f"{phase}_zara1.txt").write_text("\n".join(rows))
        _jpg(d / "zara1.jpg", 300)


@pytest.mark.parametrize("dataset,precision_recall", [("stanford", False), ("gofp", True)])
def test_cli_pair_drill(tmp_path, dataset, precision_recall):
    """train CLI -> version dir -> evaluate CLI -> a finite CSV with the JAX
    CLI's columns and the JAX generator's parameter count."""
    root = tmp_path / "data"
    (_write_sdd if dataset == "stanford" else _write_gofp)(root)
    log_dir = tmp_path / "logs"
    train_cli.main(["--dataset", dataset, "--data_root", str(root), "--name", "drill",
                    "--log_dir", str(log_dir), *TRAIN_FLAGS])
    model_path = log_dir / "multi_generator" / "drill"
    (version,) = sorted(model_path.glob("version_*"))
    assert (version / "metrics.jsonl").exists()
    assert (version / "checkpoints" / "checkpoint_best").exists()

    out = tmp_path / "results"
    flags = ["--model_path", str(model_path), "--output_folder", str(out),
             "--checkpoint", "best", "--phase", "test", "--num_preds", "3",
             "--pred_strat", "sampling", "--batch_size", "4", "--data_root", str(root),
             "--device", "cpu"]
    csv_path = evaluate_cli.main(flags + ([] if precision_recall else ["--no-precision-recall"]))
    assert csv_path.name == "drill_test_best_all_sampling_radius_3.0.csv"
    assert list(out.glob("*.csv")) == [csv_path]
    df = pd.read_csv(csv_path)
    assert len(df) == 1

    # columns: the index, the JAX CLI's, then the JAX metric functions' keys
    ds = parsing.load_scene_dataset(dataset, "test", data_root=root)
    preds = np.random.RandomState(0).randn(12, 2, sum(len(t) for t in ds.trajectories), 2)
    metric_keys = list(jax_evaluate.evaluate_ade_fde(ds, preds, [1, 2]))
    if precision_recall:
        metric_keys += list(jax_manifold.evaluate_precision_recall(ds, preds, 3.0, [1, 2]))
    assert list(df.columns) == ["Unnamed: 0", *META_COLUMNS, *metric_keys]
    for k in metric_keys:
        assert np.isfinite(float(df[k][0])), k

    # the generator's parameter count, as the JAX factory counts it
    assert TRAIN_FLAGS[-2:] == ["--device", "cpu"]
    jcfg = jax_config.config_from_args(jax_config.get_parser().parse_args(
        ["--dataset", dataset, *TRAIN_FLAGS[:-2]]))
    g_spec, _ = jax_factory.build_specs(jcfg)
    # shapes only: jax.eval_shape traces the initializer without running it
    g_params, _ = jax.eval_shape(lambda k: jax_generator.init(k, g_spec), jax.random.PRNGKey(0))
    assert int(df["Generator params"][0]) == count_parameters(g_params) > 0
    assert (df["Model"][0], int(df["# Generators"][0]), df["Dataset"][0]) == (
        "drill", 2, dataset)


def test_csv_matches_pandas_to_csv(tmp_path):
    """``write_csv`` writes what ``pandas.DataFrame(columns).to_csv`` writes."""
    columns = {
        "Model": ["drill", "a,b"], "# Generators": [4, 4], "Generator params": [15776, 15776],
        "L2 loss weight": [1.0, 1.0], "Sigma": [1.0, 0.5],
        "ADE k=1": [np.float64(2.363115606744305), np.float64(1 / 3)],
        "Mode k=1": [np.float64(0.25), np.float64(1e-5)],
        "Precision": [float("nan"), 0.1 + 0.2],
    }
    evaluate_cli.write_csv(tmp_path / "port.csv", columns)
    pd.DataFrame(columns).to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    with pytest.raises(ValueError, match="same length"):
        evaluate_cli.write_csv(tmp_path / "bad.csv", {"a": [1], "b": [1, 2]})


def test_checkpoint_resume(tmp_path):
    """``--checkpoint <version_dir>`` resumes from the dir's best checkpoint
    (here the latest: no epoch was validated) with ``val_every=1`` and
    trains the remaining epochs."""
    argv = ["--dataset", "synthetic_memory", "--log_dir", str(tmp_path), "--name", "resume",
            *TRAIN_FLAGS]
    argv[argv.index("--epochs") + 1] = "2"
    argv[argv.index("--val_every") + 1] = "2"
    cfg = config.config_from_args(config.get_parser().parse_args(argv))
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    Trainer(cfg, writer, device="cpu").train(until_epoch=1)
    assert len((writer.dir / "metrics.jsonl").read_text().splitlines()) == 1

    model = train_cli.main(["--checkpoint", str(writer.dir), "--device", "cpu"])
    assert model.state.epoch == 2 and model.config.val_every == 1
    epochs = [json.loads(line)["epoch"]
              for line in (writer.dir / "metrics.jsonl").read_text().splitlines()]
    assert epochs == [1, 2]
    assert model.config.num_gen_parameters == cfg.num_gen_parameters > 0
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--checkpoint", str(tmp_path / "nope"), "--device", "cpu"])

    # a checkpoint written on the card restores on the CPU for evaluation;
    # its random stream cannot resume there, so training from it raises
    path = writer.checkpoint_dir / "checkpoint_best"
    blob = torch.load(path, weights_only=True)
    torch.save({**blob, "generator_device": "cuda:0"}, path)
    trainer, _ = Trainer.load_from_path(writer.dir, "best", device="cpu")
    assert trainer.state.generator is None and trainer.state.epoch == 2
    assert set(trainer.test(num_k=2, batch_size=8)) >= {"ADE k=2", "FDE k=2"}
    trainer.config = dataclasses.replace(trainer.config, epochs=3)
    with pytest.raises(ValueError, match="does not train"):
        trainer.train()


def test_parsers_match_jax(monkeypatch, tmp_path):
    ours, theirs = config.get_parser(), jax_config.get_parser()
    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(theirs) <= flags(ours)
    assert flags(ours) - flags(theirs) == {"--device"}
    a, b = vars(ours.parse_args([])), vars(theirs.parse_args([]))
    assert {k: a[k] for k in b} == b
    assert a["device"] == "cuda"
    e_ours, e_theirs = evaluate_cli.get_arg_parser(), jax_evaluate_cli.get_arg_parser()
    assert flags(e_ours) == flags(e_theirs)
    req = ["--model_path", "m", "--output_folder", "o"]
    a, b = vars(e_ours.parse_args(req)), vars(e_theirs.parse_args(req))
    assert a.pop("device") == "cuda" and b.pop("device") == "tpu"
    assert a == b

    # probgan's SGHMC flags reach the Config, at the JAX Config's defaults
    # and away from them
    sghmc = ("sghmc_alpha", "g_noise_loss_lambda", "d_noise_loss_lambda")
    jax_defaults = jax_config.Config()
    assert all(getattr(config.Config(), k) == getattr(jax_defaults, k) for k in sghmc)
    argv = [x for i, k in enumerate(sghmc) for x in (f"--{k}", str(0.5 + i))]
    cfg = config.config_from_args(ours.parse_args(["--dataset", "synthetic_memory", *argv]))
    assert [getattr(cfg, k) for k in sghmc] == [0.5, 1.5, 2.5]
    jcfg = jax_config.config_from_args(theirs.parse_args(["--dataset", "synthetic_memory",
                                                          *argv]))
    assert [getattr(jcfg, k) for k in sghmc] == [0.5, 1.5, 2.5]

    # the JAX-only flags: accepted at their defaults, raise away from them
    base = ["--dataset", "synthetic_memory"]
    cfg = config.config_from_args(ours.parse_args(base + ["--compilation_cache_dir", "x"]))
    assert cfg.dataset == "synthetic_memory" and cfg.data_root == "./data/datasets"
    # the pod flags are launch-time topology (parallel/pod.py): accepted,
    # and no Config field, as in JAX
    for extra in (["--distributed", "1"], ["--coordinator_address", "h:1"],
                  ["--num_processes", "2"], ["--process_id", "0"]):
        assert config.config_from_args(ours.parse_args(base + extra)) == \
            config.config_from_args(ours.parse_args(base))
    for extra, match in ((["--pallas_decoder", "0"], "CUDA"),
                         (["--d_hist_loss_lambda", "2"], "reads it nowhere"),
                         (["--debug"], "reads it nowhere")):
        with pytest.raises(NotImplementedError, match=match):
            config.config_from_args(ours.parse_args(base + extra))
    # the entry points run on the card unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(base + ["--log_dir", str(tmp_path)])


@pytest.mark.parametrize("name", sorted(jax_configs.BENCHMARK_CONFIGS))
def test_benchmark_config_matches_jax(tmp_path, name):
    ours = configs.get_benchmark_config(name, seed=3)
    theirs = jax_configs.get_benchmark_config(name, seed=3).to_dict()
    got = ours.to_dict()
    assert {k: theirs[k] for k in got} == got
    assert ours.use_pinet == theirs["use_pinet"]
    assert configs.BENCHMARK_CONFIGS == jax_configs.BENCHMARK_CONFIGS
    # every config trains; the data-parallel one needs a pod of 8 ranks, so
    # outside one its Trainer raises naming the launch
    cfg = configs.get_benchmark_config(name, h_dim=8, decoder_h_dim=8,
                                       log_dir=str(tmp_path))
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg,
                              tensorboard=False)
    if name == "mggan_dp_eth":
        with pytest.raises(RuntimeError, match="torch.distributed.run --nproc_per_node 8"):
            Trainer(cfg, writer, device="cpu")
    else:
        assert Trainer(cfg, writer, device="cpu").state.step == 0
