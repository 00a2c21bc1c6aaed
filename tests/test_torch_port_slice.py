"""The ported sampling slice end to end against the JAX package (CPU).

The flagship generator (mgan, G=4, h=32, sways social, scene CNN) is built
at full width with the JAX factory and moved into the port. Both sides get
the same random numbers: the test draws them with the same ``jax.random``
split as ``Predictor._decode_sampled`` and injects them into the port.
Tolerance: atol 1e-4 over the 12-step rollout (PARITY.md).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.eval.predict import Predictor as JaxPredictor
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator
from mggan_tpu.models import torch_export
from mggan_tpu.serving.runtime import ServingModel as JaxServingModel

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.data.augment import augment_batch
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.models import generator
from mggan_tpu_torch.models.weights import (
    generator_from_jax,
    generator_from_state_dict,
)
from mggan_tpu_torch.serving.runtime import MissingSceneInputError, ServingModel

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
S, P, K = 3, 5, 20


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def flagship():
    cfg = JaxConfig(dataset="synthetic_memory", num_gens=4, gan_type="mgan",
                    weighting_target="ml", h_dim=32, decoder_h_dim=32)
    (g_params, g_state, g_spec), _ = jax_factory.construct_model(
        cfg, jax.random.PRNGKey(0))
    params, state = generator_from_jax(_np_tree(g_params), _np_tree(g_state),
                                       factory.build_specs(Config.from_dict(cfg.to_dict())),
                                       device="cpu")
    port_cfg = Config.from_dict(cfg.to_dict())
    return {
        "jax": JaxPredictor(cfg, g_spec, g_params, g_state),
        "port": Predictor(port_cfg, factory.build_specs(port_cfg), params,
                          state, device="cpu"),
        "jax_params": (g_params, g_state, g_spec),
    }


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((S, P), bool)
    mask[1, 3:] = False  # padded peds
    mask[2, 1:] = False  # a one-ped scene
    return {
        "xy": rng.randn(S, P, 20, 2).astype(np.float32).cumsum(2) * 0.1,
        "ped_mask": mask,
        "patches": rng.uniform(-1, 1, (S, P, 33, 33, 4)).astype(np.float32),
    }


def _jax_draws(seed, s, p, num, num_gens, noise_dim):
    """The random numbers ``_decode_sampled`` draws from PRNGKey(seed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = jax.random.uniform(k2, (num, s, p, num_gens), minval=1e-20, maxval=1.0)
    z = jax.random.normal(k1, (num, s, 1, noise_dim))
    return {"uniforms": np.array(u), "z": np.array(z)}


def test_predictor_sampling_matches_jax_at_flagship_width(flagship):
    batch = _batch()
    out_j = flagship["jax"].predict({k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(11), num=K)
    draws = _jax_draws(11, S, P, K, 4, 8)
    out_p = flagship["port"].predict(batch, num=K, draws=draws)
    np.testing.assert_array_equal(out_p[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_allclose(out_p[2].numpy(), np.asarray(out_j[2]), atol=2e-5)
    np.testing.assert_allclose(out_p[0].numpy(), np.asarray(out_j[0]), atol=ATOL)
    np.testing.assert_allclose(out_p[1].numpy(), np.asarray(out_j[1]), atol=ATOL)
    assert out_p[0].shape == (K, S, P, 12, 2)


def test_serving_padded_bucket_matches_jax(flagship):
    scenes, peds, buckets, seed = 4, 6, (2, 4), 7
    rng = np.random.RandomState(3)
    obs = [rng.randn(n, 8, 2).astype(np.float32).cumsum(1) * 0.1 for n in (5, 2, 6)]
    pat = [rng.uniform(-1, 1, (n, 33, 33, 4)).astype(np.float32) for n in (5, 2, 6)]
    jax_model = JaxServingModel.from_predictor(
        flagship["jax"], "sampling", scenes, peds, K, scene_buckets=buckets)
    port_model = ServingModel.from_predictor(
        flagship["port"], "sampling", scenes, peds, K, scene_buckets=buckets,
        device="cpu")
    want = jax_model.predict_batch(obs, pat, seed=seed)
    # three scenes run in the 4-scene bucket: draws at the bucket's shape
    draws = _jax_draws(seed, 4, peds, K, 4, 8)
    got = port_model.predict_batch(obs, pat, seed=seed, draws=draws)
    for g, w, o in zip(got, want, obs):
        assert g.shape == (K, o.shape[0], 12, 2)
        np.testing.assert_allclose(g, w, atol=ATOL)
    with pytest.raises(MissingSceneInputError):
        port_model.predict_batch(obs)
    own_seed = port_model.predict_batch(obs, pat, seed=seed)
    assert all(np.isfinite(o).all() for o in own_seed)
    one = port_model.predict(obs[1], pat[1], seed=seed)
    assert one.shape == (K, 2, 12, 2) and np.isfinite(one).all()


def test_decode_all_matches_jax(flagship):
    """Every generator on every sample (the decode-all strategies' path)."""
    g_params, _, g_spec = flagship["jax_params"]
    rng = np.random.RandomState(5)
    k = 3
    inputs = (rng.randn(S, P, 2), rng.randn(S, P, 2) * 0.3,
              rng.randn(S, P, g_spec.enc_total), rng.randn(S, P, 32),
              rng.randn(k, S, P, 8))
    inputs = [x.astype(np.float32) for x in inputs]
    want = jax_generator.decode_all(g_params, g_spec, *map(jnp.asarray, inputs))
    port = flagship["port"]
    got = generator.decode_all(port.g_params, port.g_spec,
                               *map(torch.from_numpy, inputs))
    assert got.abs.shape == (k, 4, S, P, 12, 2)
    np.testing.assert_allclose(got.abs.numpy(), np.asarray(want.abs), atol=ATOL)
    np.testing.assert_allclose(got.rel.numpy(), np.asarray(want.rel), atol=ATOL)


def test_reference_state_dict_loads_strictly(flagship):
    g_params, g_state, g_spec = flagship["jax_params"]
    spec = flagship["port"].g_spec
    sd = torch_export.export_generator(g_params, g_state, g_spec)
    params, state = generator_from_state_dict(sd, spec, device="cpu")
    direct = flagship["port"]
    flat = lambda t, pre="": (
        [x for k, v in sorted(t.items()) for x in flat(v, f"{pre}{k}.")]
        if isinstance(t, dict) else [(pre, t)])
    for (ka, a), (kb, b) in zip(flat(params), flat(direct.g_params)):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(flat(params)) == len(flat(direct.g_params))
    for (ka, a), (kb, b) in zip(flat(state), flat(direct.g_state)):
        assert ka == kb and torch.equal(a, b)
    with pytest.raises(KeyError, match="unexpected"):
        generator_from_state_dict({**sd, "extra.weight": np.zeros(1)}, spec, "cpu")
    missing = dict(sd)
    missing.pop("net_prior")
    with pytest.raises(KeyError):
        generator_from_state_dict(missing, spec, "cpu")


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, pkgutil, importlib; sys.modules['jax'] = None\n"
        "import mggan_tpu_torch\n"
        "for m in pkgutil.walk_packages(mggan_tpu_torch.__path__, 'mggan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'mggan_tpu' or m.startswith('mggan_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('data.augment', 'data.loaders', 'data.patch_bank', 'data.prefetch',\n"
        "          'eval.evaluate', 'eval.manifold', 'eval.metrics',\n"
        "          'training.checkpoints', 'training.loop', 'utils.logging',\n"
        "          'utils.trajectory_tools',\n"
        "          'ops.kernels.decode_sorted', 'ops.kernels.decode_ablation',\n"
        "          'ablations.decode_ablation', 'ablations.sorted_select_ablation',\n"
        "          'data.registry', 'data.homography', 'data.parsing', 'data.image_io',\n"
        "          'data.table', 'native', 'configs', 'cli.train', 'cli.evaluate',\n"
        "          'config', 'ops.losses', 'ops.social', 'models.discriminator',\n"
        "          'models.generator', 'models.factory', 'models.weights',\n"
        "          'training.steps', 'training.state', 'eval.predict',\n"
        "          'tools.state_compare', 'serving.server', 'cli.serve', 'cli.export',\n"
        "          'cli.convert', 'models.torch_export', 'cli.sweep', 'viz',\n"
        "          'models.social_gan_legacy', 'utils.profiling', 'data.elastic',\n"
        "          'parallel.pod', 'parallel.mesh', 'parallel.dp', 'parallel.reduce',\n"
        "          'ops.kernels.library', 'utils.roofline'):\n"
        "    assert 'mggan_tpu_torch.' + m in sys.modules, m\n"
        "print(sum(m.startswith('mggan_tpu_torch') for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # the data and eval modules included
    # the kernel operators and the artifact loader stand free of the model code
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['mggan_tpu_torch.models'] = None\n"
        "import torch\n"
        "import mggan_tpu_torch.ops.kernels.library\n"
        "from mggan_tpu_torch.cli.export import load_artifact_all\n"
        "assert torch.ops.mggan.decode_select.default and torch.ops.mggan.decode_all_fwd.default\n"
        "bad = [m for m in sys.modules if m.startswith(('mggan_tpu.', 'mggan_tpu_torch.models.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, flagship, tmp_path):
    # a version dir and an artifact written on the CPU for the deployment
    # entry points below
    from mggan_tpu_torch.cli import convert as convert_cli
    from mggan_tpu_torch.cli import export as export_cli
    from mggan_tpu_torch.cli import serve as serve_cli
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter

    small = Config(dataset="synthetic_memory", num_gens=2, h_dim=8, decoder_h_dim=8,
                   name="small")
    writer = ExperimentWriter(tmp_path, small.experiment, small.name, version=0,
                              config=small, tensorboard=False)
    Trainer(small, writer, device="cpu").save("checkpoint_best")
    vdir, art = writer.dir, tmp_path / "m.mgtorch"
    export_cli.main(["--model_dir", str(vdir), "--out", str(art), "--scenes", "2",
                     "--peds", "3", "--num", "4", "--device", "cpu"])
    ref = convert_cli.main(["--reverse", "--version_dir", str(vdir), "--out_dir",
                            str(tmp_path / "ref"), "--device", "cpu"])
    pth = ref / "checkpoints" / "checkpoint_best.pth"

    from mggan_tpu_torch.cli import sweep as sweep_cli
    from mggan_tpu_torch.models import social_gan_legacy
    from mggan_tpu_torch.training.checkpoints import train_state_from_jax

    sgan_params = {k: v.numpy() for k, v in social_gan_legacy.generator_init(
        torch.Generator(), social_gan_legacy.SGANSpec())["enc_embed"].items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: sweep_cli.main(["--grid", '{"num_gens": [2]}', "--dataset",
                                    "synthetic_memory", "--log_dir", str(tmp_path / "sw")]),
            lambda: social_gan_legacy.params_from_jax(sgan_params),
            lambda: train_state_from_jax({}, small, factory.build_specs(small),
                                         factory.build_d_spec(small)),
            lambda: ServingModel.from_version_dir(vdir),
            lambda: ServingModel.from_artifact(art),
            lambda: export_cli.main(["--model_dir", str(vdir), "--out", str(art)]),
            lambda: convert_cli.main(["--pth", str(pth), "--out_dir", str(tmp_path / "c")]),
            lambda: convert_cli.main(["--reverse", "--version_dir", str(vdir), "--out_dir",
                                      str(tmp_path / "r")]),
            lambda: serve_cli.main(["--artifact", str(art), "--allow_missing_scene"]),
            lambda: serve_cli.main(["--model_dir", str(vdir), "--allow_missing_scene"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "c").exists() and not (tmp_path / "r").exists()
    assert ServingModel.from_artifact(art, device="cpu").device.type == "cpu"
    # an artifact of the earlier weights-and-header format is refused
    head = json.dumps({"format": "mggan_tpu_torch.artifact/1", "strategy": "sampling"}).encode()
    (tmp_path / "old.mgtorch").write_bytes(b"MGTORCH1\n" + len(head).to_bytes(4, "big") + head)
    with pytest.raises(ValueError, match="weights, not programs"):
        ServingModel.from_artifact(tmp_path / "old.mgtorch", device="cpu")
    assert ServingModel.from_version_dir(vdir, scenes=2, peds=3, num=4,
                                         device="cpu").device.type == "cpu"

    cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.construct_model(cfg, seed=0)
    params, state, spec = factory.construct_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, spec, params, state)
    cpu_pred = Predictor(cfg, spec, params, state, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel.from_predictor(cpu_pred, "sampling", 2, 3, 4)
    with pytest.raises(ValueError, match="unknown strategy"):
        cpu_pred.get_predict_func("nope")
    batch = {"xy": np.zeros((1, 2, 20, 2), np.float32),
             "big_patches": np.zeros((1, 2, 49, 49, 3), np.uint8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        augment_batch(batch, train=False)
    assert augment_batch(batch, train=False, device="cpu")["patches"].device.type == "cpu"
