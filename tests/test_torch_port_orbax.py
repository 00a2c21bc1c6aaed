"""JAX orbax checkpoints into the port (CPU).

A JAX ``Trainer`` (h=16, G=2, K=4, no social module and no global D, as
the committed fixture; batch 24: two train steps and one validation batch
an epoch, with train-time augmentation and the patch bank) trains one epoch of two and saves an orbax checkpoint;
``scripts/convert_orbax_checkpoint.py`` converts it into a port version
dir; the JAX ``Trainer`` resumes it (``load_from_path``) for the second
epoch, and so does the port's ``Trainer`` with the JAX Trainer's draws
replayed (``JitJaxDraws``: ``test_torch_port_loop.JaxDraws``'s keys and
draws, each drawn in one jitted function). Three things keep the file's
time down without changing what runs: those jitted draws and the JAX
model's initial weights drawn by the port (``construct_gan``, seed 0) into
the trees that JAX's ``construct_model`` builds, read by ``jax.eval_shape``
(JAX's eager init compiles op by op, ~45 s on the CPU together), and the
resumed JAX ``Trainer`` (its state restored from the orbax store) stepping
with the first one's compiled functions, which its config would compile
anew.
Tolerances: the golden
fixtures' atol/rtol 1e-4 on the resumed epoch's metrics (but ``perf/*``)
and the parameters under ``_assert_params_close`` (atol 1e-4; the
``NOISE_LEAVES`` within 2 * lr per update). A checkpoint saved without
``best_val`` converts with ``inf``.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data.augment import sample_aug_params as jax_sample_aug_params
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.training.loop import Trainer as JaxTrainer
from mggan_tpu.utils.logging import ExperimentWriter as JaxExperimentWriter

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models.factory import construct_gan
from mggan_tpu_torch.training import checkpoints as ckpt
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.pytree import tree_items
from test_torch_port_loop import JaxDraws
from test_torch_port_train import ATOL, RTOL, _assert_params_close

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2  # 48 train windows in batches of 24


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_checkpoint", ROOT / "scripts" / "convert_orbax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_weights_construct_model():
    """``construct_model`` with the port's initial weights (seed 0) in the
    JAX trees: the trees' structure and dtypes from ``jax.eval_shape``,
    which traces and compiles nothing."""
    construct = jax_factory.construct_model

    def build(cfg, key):
        specs = {}

        def arrays(k):
            (gp, gs, g_spec), (dp, ds, d_spec) = construct(cfg, k)
            specs["g"], specs["d"] = g_spec, d_spec
            return (gp, gs), (dp, ds)

        like = jax.eval_shape(arrays, key)
        g_pack, d_pack = construct_gan(Config.from_dict(cfg.to_dict()), seed=0, device="cpu")
        to_jax = lambda want, tree: jax.tree.map(
            lambda w, t: jnp.asarray(t.numpy(), w.dtype), want, tree)
        (gp, gs), (dp, ds) = to_jax(like[0], g_pack[:2]), to_jax(like[1], d_pack[:2])
        return (gp, gs, specs["g"]), (dp, ds, specs["d"])

    return build


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _step_draws(rng, s, p, k, ke, g, z):
    """``test_torch_port_train._jax_draws`` for the step of this file's
    config (NS, no unrolling, no W or probgan draws) as one program."""
    _, kd, kg, kpm = jax.random.split(rng, 4)

    def labels(key):
        kr, kf = jax.random.split(key)
        return jnp.stack([jax.random.uniform(kr, (), minval=0.9, maxval=1.0),
                          jax.random.uniform(kf, (), minval=0.0, maxval=0.1)])

    def sampled(key, n):
        k_noise, k_cat = jax.random.split(key)
        return (jax.random.uniform(k_cat, (n, s, p, g), minval=1e-20, maxval=1.0),
                jax.random.normal(k_noise, (n, s, 1, z)))

    d_lab, d_gen, _ = jax.random.split(kd, 3)
    du, dz = sampled(d_gen, 1)
    g_lab, g_gen = jax.random.split(kg)
    gu, gz = sampled(g_gen, k)
    return {"d_labels": labels(d_lab)[None], "d_uniforms": du[None], "d_z": dz[None],
            "g_labels": labels(g_lab), "g_uniforms": gu, "g_z": gz,
            "pm_z": jax.random.normal(kpm, (ke, s, 1, z))}


class JitJaxDraws(JaxDraws):
    """``JaxDraws`` with each draw one jitted program."""

    def aug(self, epoch, i, s):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(self.cfg.seed + 1), epoch), i)
        flip, alpha = _aug_draws(key, s)
        return np.array(flip), np.array(alpha)

    def step(self, state, s, p):
        while len(self.rngs) <= state.step:
            self.rngs.append(jax.random.split(self.rngs[-1], 4)[0])
        c = self.cfg
        return jax.tree.map(np.array, _step_draws(
            self.rngs[state.step], s, p, c.num_samples, c.num_expectation_samples,
            c.num_gens, c.noise_dim))

    def val(self, i, s, p, num):
        return jax.tree.map(np.array, _val_draws(i, s, p, num, self.cfg.num_gens,
                                                 self.cfg.noise_dim))


_aug_draws = jax.jit(jax_sample_aug_params, static_argnums=1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _val_draws(i, s, p, num, g, z):
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i))
    return {"uniforms": jax.random.uniform(k2, (num, s, p, g), minval=1e-20, maxval=1.0),
            "z": jax.random.normal(k1, (num, s, 1, z))}


def _metrics(writer_dir):
    return [json.loads(line) for line in (Path(writer_dir) / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """JAX: one epoch, an orbax checkpoint, then a resumed epoch; the port:
    the converted checkpoint resumed for the same epoch on the JAX draws."""
    tmp = tmp_path_factory.mktemp("orbax")
    cfg = JaxConfig(dataset="synthetic_memory", batch_size=24, num_gens=2, epochs=2,
                    num_samples=4, h_dim=16, decoder_h_dim=16, n_social_modules=0,
                    global_disc=0, top_k_test=3, augment=1,
                    patch_bank=1, val_every=1, save_every=5, name="tiny",
                    log_dir=str(tmp / "jax"))
    writer = JaxExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, version=0,
                                 config=cfg, tensorboard=False)
    conv = _converter()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_factory, "construct_model", _port_weights_construct_model())
        first = JaxTrainer(cfg, writer)
        init_rng = np.array(first.state.rng)
        first.train(until_epoch=1)
        port_dir = conv.main(["--version_dir", str(writer.dir), "--out_dir",
                              str(tmp / "port")])
        j_tr, _ = JaxTrainer.load_from_path(writer.dir, checkpoint="latest")
    j_tr.train_step, j_tr._augment, j_tr._metric_sums = (
        first.train_step, first._augment, first._metric_sums)
    j_tr.train()
    tr, pcfg = Trainer.load_from_path(port_dir, checkpoint="latest", device="cpu")
    tr.draws = JitJaxDraws(cfg, init_rng)
    before = {"step": tr.state.step, "epoch": tr.state.epoch,
              "g_count": tr.state.g_opt.count, "d_count": tr.state.d_opt.count,
              "best_val": tr.state.best_val, "l2_weight": tr.state.l2_weight}
    tr.train()
    return {"cfg": cfg, "first": first, "jax": j_tr, "port": tr, "before": before,
            "port_dir": port_dir, "jax_dir": writer.dir, "conv": conv, "tmp": tmp}


def test_converted_checkpoint_holds_the_jax_state(resumed):
    """The converted dir: the JAX run's config, checkpoint names, counters
    and best_val, and the generator seeded from the JAX key."""
    first, before, port_dir = resumed["first"], resumed["before"], Path(resumed["port_dir"])
    assert port_dir.parts[-3:] == ("multi_generator", "tiny", "version_0")
    assert sorted(p.name for p in (port_dir / "checkpoints").iterdir()) == \
        ["checkpoint_1", "checkpoint_best"]
    assert before == {"step": STEPS, "epoch": 1, "g_count": 2 * STEPS, "d_count": STEPS,
                      "best_val": float(first.state.best_val), "l2_weight": 1.0}
    assert np.isfinite(before["best_val"])
    blob = torch.load(port_dir / "checkpoints" / "checkpoint_1", weights_only=True)
    assert blob["format"] == ckpt.FORMAT and blob["generator"] is None
    key = np.asarray(first.state.rng)  # checkpoint_1 holds the state the run ended with
    assert blob["generator_seed"] == (int(key[0]) << 32) | int(key[1])


def test_resumed_epoch_matches_jax(resumed):
    cfg, j_tr, tr = resumed["cfg"], resumed["jax"], resumed["port"]
    want, got = _metrics(j_tr.writer.dir)[-1], _metrics(tr.writer.dir)[-1]
    assert want["epoch"] == got["epoch"] == 2
    keys = {k for k in want if not k.startswith("perf/")}
    assert keys == {k for k in got if not k.startswith("perf/")}
    assert {"val/ADE k=3", "train/L2_loss", "train/net_chooser_loss"} <= keys
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    assert tr.state.step == int(j_tr.state.step) == 2 * STEPS and tr.state.epoch == 2
    assert tr.state.g_opt.count == 4 * STEPS and tr.state.d_opt.count == 2 * STEPS
    np.testing.assert_allclose(tr.state.best_val, float(j_tr.state.best_val),
                               atol=ATOL, rtol=RTOL)
    _assert_params_close(tr.state.g_params, j_tr.state.g_params, cfg.g_lr, 4 * STEPS)
    _assert_params_close(tr.state.d_params, j_tr.state.d_params, cfg.d_lr, 2 * STEPS)
    # Adam's moments: the noise leaves' first moments follow gradients of
    # float noise, so they are held to the atol of their parameters' bound
    flat = {("g",) + p: x for p, x in tree_items(tr.state.g_opt.mu)}
    flat.update({("d",) + p: x for p, x in tree_items(tr.state.d_opt.mu)})
    conv = resumed["conv"]
    for side, opt in (("g", j_tr.state.g_opt), ("d", j_tr.state.d_opt)):
        for path, w in tree_items(conv.adam_state(opt)["mu"]):
            if path in {("scene", "conv1", "b"), ("scene", "conv2", "b")}:
                continue
            np.testing.assert_allclose(flat[(side,) + path].numpy(), w, atol=ATOL,
                                       rtol=RTOL, err_msg=str((side,) + path))


def test_checkpoint_without_best_val_converts_with_inf(resumed):
    """A checkpoint saved before ``best_val`` was part of the JAX
    ``TrainState`` restores (in the JAX package) and converts with inf."""
    first, tmp = resumed["first"], resumed["tmp"]
    legacy = tmp / "legacy" / "multi_generator" / "tiny" / "version_3"
    (legacy / "checkpoints").mkdir(parents=True)
    (legacy / "meta_tags.csv").write_bytes((resumed["jax_dir"] / "meta_tags.csv").read_bytes())
    state = jax.device_get(first.state)
    tree = {f: getattr(state, f) for f in ("g_params", "g_state", "d_params", "d_state",
                                           "g_opt", "d_opt", "step", "epoch", "l2_weight",
                                           "rng")}
    with ocp.StandardCheckpointer() as saver:
        saver.save((legacy / "checkpoints" / "checkpoint_1").absolute(), tree)
    out = resumed["conv"].main(["--version_dir", str(legacy), "--out_dir",
                                str(tmp / "legacy_port")])
    tr, _ = Trainer.load_from_path(out, checkpoint="latest", device="cpu")
    assert tr.state.best_val == float("inf")
    assert (tr.state.step, tr.state.epoch) == (STEPS, 1)
    ref = resumed["port"]
    restored = ckpt.restore_checkpoint(Path(resumed["port_dir"]) / "checkpoints",
                                       ref.state, "checkpoint_1")
    a = dict(tree_items(tr.state.g_params))
    assert all(torch.equal(a[p], x) for p, x in tree_items(restored.g_params))


def test_train_state_from_jax_refuses_other_specs(resumed):
    from mggan_tpu_torch.models.factory import build_d_spec, build_specs

    cfg = Config.from_dict(resumed["cfg"].to_dict())
    other = Config.from_dict({**cfg.to_dict(), "num_gens": 3})
    with pytest.raises(ValueError, match="not built from config"):
        ckpt.train_state_from_jax({}, cfg, build_specs(other), build_d_spec(cfg), "cpu")
    assert ckpt.jax_key_seed(np.array([1, 2], np.uint32)) == (1 << 32) | 2
    with pytest.raises(ValueError, match="two uint32 words"):
        ckpt.jax_key_seed(np.zeros(3, np.uint32))


def test_committed_fixture_resumes_on_the_cpu(tmp_path):
    """``mggan_tpu_torch/tools/fixtures/orbax_tiny``, a converted JAX
    checkpoint after epoch 1 of 2, resumes for epoch 2 (3 steps and
    validation) with finite metrics; its file holds a seed, not a
    generator state."""
    import shutil

    src = ROOT / "mggan_tpu_torch" / "tools" / "fixtures" / "orbax_tiny" / "multi_generator"
    shutil.copytree(src, tmp_path / "multi_generator")
    vdir = tmp_path / "multi_generator" / "tiny" / "version_0"
    assert (vdir / "checkpoints" / "checkpoint_1").stat().st_size < 512_000
    tr, cfg = Trainer.load_from_path(vdir, checkpoint="latest", device="cpu")
    assert (cfg.n_social_modules, cfg.num_gens, cfg.h_dim) == (0, 2, 16)
    assert (tr.state.step, tr.state.epoch, tr.state.best_val) == (3, 1, float("inf"))
    tr.train()
    (line,) = _metrics(vdir)
    assert line["epoch"] == 2 and tr.state.step == 6
    assert all(np.isfinite(v) for v in line.values())
    assert np.isfinite(tr.state.best_val)
