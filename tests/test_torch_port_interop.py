"""Checkpoints and artifacts across the two packages (CPU).

* The port's reference-format writer (``models/torch_export.py``) against
  the JAX package's on the same trees, key for key and bit for bit, for
  gan, mgan, infogan, probgan (history heads apart from the live ones),
  the discrete generator and sgan pooling, and back through the strict
  loaders.
* Conversion both ways: a reference dir written by the JAX package's
  ``export_version_dir`` becomes a port version dir (``cli.convert``) with
  the JAX parameters, and the port's ``cli.convert --reverse`` feeds the
  JAX package's ``convert_torch_checkpoint``, which restores the port's
  parameters; ``cli.evaluate`` runs on the converted dir.
* The port's serving artifact (``cli.export``): JAX's header keys, several
  buckets, serving equal to live serving bit for bit, and the refusals.
"""

import csv
import json
import re
import types

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mggan_tpu.cli.convert import convert_torch_checkpoint as jax_convert_torch_checkpoint
from mggan_tpu.cli.export import save_artifact as jax_save_artifact
from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import torch_export as jax_torch_export

from mggan_tpu_torch.cli import convert as convert_cli
from mggan_tpu_torch.cli import evaluate as evaluate_cli
from mggan_tpu_torch.cli import export as export_cli
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import factory, torch_export
from mggan_tpu_torch.models.weights import (
    discriminator_from_jax,
    discriminator_from_state_dict,
    generator_from_jax,
    generator_from_state_dict,
)
from mggan_tpu_torch.serving.runtime import ServingModel
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items, tree_map

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

SIZE = dict(dataset="synthetic_memory", batch_size=4, num_gens=2, h_dim=16,
            decoder_h_dim=16, noise_dim=8, num_samples=3, top_k_test=3, epochs=1)
FAMILIES = {
    "gan": {"gan_type": "gan", "num_gens": 1, "weighting_target": "none"},
    "mgan": {},
    "infogan": {"gan_type": "infogan"},
    "probgan": {"gan_type": "probgan"},
    "discrete": {"experiment": "discrete", "weighting_target": "none"},
    "sgan": {"pool_type": "sgan"},
}
P, K = 3, 5


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _assert_trees_equal(got, want):
    """Same paths; every leaf equal bit for bit (``want`` may hold JAX or
    numpy arrays)."""
    a, b = list(tree_items(got)), list(tree_items(_np_tree(want)))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        assert x.shape == y.shape and np.array_equal(x, y), k


def _jax_trees(kw, seed=3):
    jcfg = JaxConfig(**{**SIZE, **kw})
    (gp, gs, g_spec), (dp, ds, d_spec) = jax_factory.construct_model(
        jcfg, jax.random.PRNGKey(seed))
    return jcfg, (gp, gs, g_spec), (dp, ds, d_spec)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_writer_matches_jax_and_round_trips(family):
    jcfg, (gp, gs, g_spec), (dp, ds, d_spec) = _jax_trees(FAMILIES[family])
    if family == "probgan":  # history heads apart from the live heads
        ds = {**ds, "hist": {"discs": jax.tree.map(lambda x: x + 0.25, ds["hist"]["discs"]),
                             "len": ds["hist"]["len"]}}
    cfg = Config.from_dict(jcfg.to_dict())
    pg_spec, pd_spec = factory.build_specs(cfg), factory.build_d_spec(cfg)
    g = generator_from_jax(_np_tree(gp), _np_tree(gs), pg_spec, device="cpu")
    d = discriminator_from_jax(_np_tree(dp), _np_tree(ds), pd_spec, device="cpu")
    pairs = ((torch_export.export_generator(*g, pg_spec),
              jax_torch_export.export_generator(gp, gs, g_spec)),
             (torch_export.export_discriminator(*d, pd_spec),
              jax_torch_export.export_discriminator(dp, ds, d_spec)))
    for got, want in pairs:
        assert list(got) == list(want)
        for k in want:
            x, y = got[k].numpy(), np.asarray(want[k])
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k
    g_sd, d_sd = pairs[0][0], pairs[1][0]
    if family == "probgan":
        assert sum(k.startswith("discs_hist.") for k in d_sd) == 5 * 4
    elif family == "discrete":
        assert any(k.startswith("one_hot_sample_encoder.") for k in g_sd)
        assert not any(k.startswith("gs.") for k in g_sd)
    elif family == "sgan":
        assert "social.spatial_embedding.weight" in g_sd
    for (params, state), (p2, s2) in ((g, generator_from_state_dict(g_sd, pg_spec, "cpu")),
                                      (d, discriminator_from_state_dict(d_sd, pd_spec, "cpu"))):
        _assert_trees_equal(p2, params)
        _assert_trees_equal(s2, state)  # probgan: JAX's history starts at len 1 too


@pytest.fixture(scope="module")
def mgan_jax():
    return _jax_trees({}, seed=5)


def _csv_rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_jax_reference_dir_converts_into_the_port(mgan_jax, tmp_path):
    """JAX ``export_version_dir`` -> port ``cli.convert``: the version dir
    restores the JAX trees bit for bit, and ``cli.evaluate`` runs on it."""
    jcfg, (gp, gs, g_spec), (dp, ds, d_spec) = mgan_jax
    jcfg = JaxConfig.from_dict({**jcfg.to_dict(), "name": "converted"})
    # BN statistics away from their init, so the state's transfer shows
    gs = jax.tree.map(lambda x: x + 0.5, gs)
    state = types.SimpleNamespace(g_params=gp, g_state=gs, d_params=dp, d_state=ds)
    ref = jax_torch_export.export_version_dir(tmp_path / "ref", jcfg, g_spec, d_spec, state)
    vdir = convert_cli.main(["--pth", str(ref / "checkpoints" / "checkpoint_best.pth"),
                             "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert vdir == tmp_path / "port" / "multi_generator" / "converted" / "version_0"
    trainer, config = Trainer.load_from_path(vdir, "best", device="cpu")
    assert config.num_gens == 2 and config.num_gen_parameters > 0
    for got, want in ((trainer.state.g_params, gp), (trainer.state.g_state, gs),
                      (trainer.state.d_params, dp), (trainer.state.d_state, ds)):
        _assert_trees_equal(got, want)
    assert trainer.state.g_opt.count == 0 and trainer.state.epoch == 0

    csv_path = evaluate_cli.main([
        "--model_path", str(vdir.parent), "--output_folder", str(tmp_path / "results"),
        "--pred_strat", "expected", "--num_preds", "4", "--no-precision-recall",
        "--batch_size", "8", "--device", "cpu"])
    rows = _csv_rows(csv_path)
    assert [r["Prediction strategy"] for r in rows] == ["expected"]
    assert all(np.isfinite(float(rows[0][f"ADE k={k}"])) for k in (1, 2, 3))

    wrong = tmp_path / "wrong_meta.csv"
    wrong.write_text((ref / "meta_tags.csv").read_text().replace("h_dim,16", "h_dim,8"))
    with pytest.raises(ValueError, match="do not match"):
        convert_cli.convert_torch_checkpoint(ref / "checkpoints" / "checkpoint_best.pth",
                                             tmp_path / "bad", meta_tags=wrong, device="cpu")


def _port_version_dir(tmp_path, **kw):
    cfg = Config(**{**SIZE, "name": "port_model", **kw})
    writer = ExperimentWriter(tmp_path / "logs", cfg.experiment, cfg.name, version=1,
                              config=cfg, tensorboard=False)
    trainer = Trainer(cfg, writer, device="cpu")
    writer.save_config(cfg)
    trainer.state = trainer.state.replace(
        g_state=tree_map(lambda x: x + 0.5, trainer.state.g_state),
        d_state=tree_map(lambda x: x - 0.25, trainer.state.d_state))
    trainer.save("checkpoint_best")
    return trainer


def test_port_dir_converts_into_jax(tmp_path):
    """Port ``cli.convert --reverse`` -> JAX ``convert_torch_checkpoint``:
    the JAX version dir holds the port's trees bit for bit."""
    trainer = _port_version_dir(tmp_path)
    ref = convert_cli.main(["--reverse", "--version_dir", str(trainer.writer.dir),
                            "--out_dir", str(tmp_path / "ref"), "--device", "cpu"])
    assert (ref / "meta_tags.csv").is_file()
    jdir = jax_convert_torch_checkpoint(ref / "checkpoints" / "checkpoint_best.pth",
                                        tmp_path / "jax", meta_tags=ref / "meta_tags.csv")
    with ocp.StandardCheckpointer() as ckpt:
        restored = ckpt.restore((jdir / "checkpoints" / "checkpoint_best").absolute())
    for k in ("g_params", "g_state", "d_params", "d_state"):
        _assert_trees_equal(getattr(trainer.state, k), restored[k])


@pytest.mark.parametrize("strategy", ["sampling", "expected"])
def test_artifact_round_trip(tmp_path, strategy):
    """``cli.export`` with several buckets: JAX's header keys, serving from
    the artifact equal to ``from_version_dir`` bit for bit at each bucket;
    a JAX artifact, a foreign file and ``rejection`` are refused."""
    trainer = _port_version_dir(tmp_path)
    vdir = trainer.writer.dir
    out = tmp_path / "m.mgtorch"
    export_cli.main(["--model_dir", str(vdir), "--out", str(out), "--strategy", strategy,
                     "--scenes", "4,1", "--peds", str(P), "--num", str(K),
                     "--device", "cpu"])
    header, _ = export_cli.read_artifact(out)
    assert {"wants_scene", "strategy", "dataset", "model_dir"} <= set(header)
    assert (header["wants_scene"], header["strategy"], header["dataset"]) == \
        (True, strategy, "synthetic_memory")
    assert (header["scene_buckets"], header["peds"], header["num"]) == ([1, 4], P, K)
    art = ServingModel.from_artifact(out, device="cpu")
    live = ServingModel.from_version_dir(vdir, strategy, scenes=4, peds=P, num=K,
                                         scene_buckets=(1, 4), device="cpu")
    assert (art.buckets, art.strategy, art.wants_scene, art.source) == \
        ((1, 4), strategy, True, str(out))
    rng = np.random.RandomState(0)
    for n in (1, 3):
        obs = [rng.randn(P - i % 2, 8, 2).astype(np.float32).cumsum(1) for i in range(n)]
        pat = [rng.uniform(-1, 1, (len(o), 33, 33, 4)).astype(np.float32) for o in obs]
        for a, b in zip(art.predict_batch(obs, pat, seed=9),
                        live.predict_batch(obs, pat, seed=9)):
            np.testing.assert_array_equal(a, b)
    call, _ = export_cli.load_artifact(out, device="cpu")
    xy, mask, pat = art.pad_request(obs, pat)
    assert call(xy, mask, pat, 9).shape == (K, 4, P, 12, 2)

    jax_art = tmp_path / "m.jaxexport"
    jax_save_artifact(types.SimpleNamespace(serialize=lambda: b"stablehlo"), jax_art,
                      {"wants_scene": True, "strategy": strategy})
    with pytest.raises(ValueError, match="JAX package artifact"):
        ServingModel.from_artifact(jax_art, device="cpu")
    head = json.dumps({"format": "mggan_tpu_torch.artifact/1", "strategy": strategy,
                       "model_dir": str(vdir), "scene_buckets": [1, 4]}).encode()
    (tmp_path / "old").write_bytes(b"MGTORCH1\n" + len(head).to_bytes(4, "big") + head)
    with pytest.raises(ValueError, match=f"re-export it: .* --model_dir {re.escape(str(vdir))} "):
        ServingModel.from_artifact(tmp_path / "old", device="cpu")
    (tmp_path / "junk").write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a"):
        export_cli.load_artifact_all(tmp_path / "junk", device="cpu")
    with pytest.raises(ValueError, match="not exportable"):
        export_cli.save_artifact(trainer.predictor(), tmp_path / "r", "rejection", (1,), P, K)
    assert not (tmp_path / "r").exists()
    with pytest.raises(SystemExit):
        export_cli.get_arg_parser().parse_args(["--model_dir", "x", "--out", "y",
                                                "--strategy", "rejection"])
