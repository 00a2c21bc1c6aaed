"""The port's train loop against the JAX package's (CPU).

One JAX ``Trainer`` epoch (h=16, G=2, K=4, top_k_test=3, batch 16: three
train steps and one validation batch, with train-time augmentation and the
patch bank) and the port's ``Trainer`` on the same weights
(``generator_from_jax`` / ``discriminator_from_jax``) with every JAX draw
replayed: the augmentation keys ``fold_in(fold_in(PRNGKey(seed + 1),
epoch), i)``, the step's four-way split of ``state.rng`` and validation's
``fold_in(PRNGKey(0), i)``. Tolerances: the golden fixtures' atol/rtol 1e-4
on the epoch's metrics (but ``perf/*``, host rates), ``val/ADE k=3`` and
``best_val``; the parameters under ``_assert_params_close`` (atol 1e-4,
the conv biases before train-mode BatchNorm within 2 * lr per update).
On the CPU the port's own resume replays an uninterrupted run bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data.augment import sample_aug_params as jax_sample_aug_params
from mggan_tpu.training.loop import Trainer as JaxTrainer
from mggan_tpu.utils.logging import ExperimentWriter as JaxExperimentWriter

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models.weights import discriminator_from_jax, generator_from_jax
from mggan_tpu_torch.training import checkpoints as ckpt
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items
from test_torch_port_train import ATOL, RTOL, _assert_params_close, _jax_draws

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

STEPS = 3  # 48 train windows in batches of 16


def _cfg(tmp_path, **kw):
    base = dict(dataset="synthetic_memory", batch_size=16, num_gens=2, epochs=1,
                num_samples=4, h_dim=16, decoder_h_dim=16, top_k_test=3, augment=1,
                patch_bank=1, val_every=1, save_every=5, log_dir=str(tmp_path))
    base.update(kw)
    return base


def _metrics(writer):
    return [json.loads(line) for line in (writer.dir / "metrics.jsonl").read_text().splitlines()]


class JaxDraws:
    """The JAX Trainer's random numbers, in the port's draws interface."""

    def __init__(self, cfg: JaxConfig, state_rng):
        self.cfg = cfg
        self.rngs = [state_rng]

    def aug(self, epoch, i, s):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(self.cfg.seed + 1), epoch), i)
        flip, alpha = jax_sample_aug_params(key, s)
        return np.array(flip), np.array(alpha)

    def step(self, state, s, p):
        while len(self.rngs) <= state.step:
            self.rngs.append(jax.random.split(self.rngs[-1], 4)[0])
        return _jax_draws(self.rngs[state.step], self.cfg, s, p)

    def val(self, i, s, p, num):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i))
        return {"uniforms": np.array(jax.random.uniform(
                    k2, (num, s, p, self.cfg.num_gens), minval=1e-20, maxval=1.0)),
                "z": np.array(jax.random.normal(k1, (num, s, 1, self.cfg.noise_dim)))}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the JAX Trainer and of the port's, same weights and draws."""
    tmp = tmp_path_factory.mktemp("loop")
    cfg = JaxConfig(**_cfg(tmp))
    j_writer = JaxExperimentWriter(tmp, cfg.experiment, "jax", version=1, config=cfg,
                                   tensorboard=False)
    j_tr = JaxTrainer(cfg, j_writer)
    init = jax.tree.map(np.array, j_tr.state)
    j_tr.train()

    pcfg = Config.from_dict(cfg.to_dict())
    writer = ExperimentWriter(tmp, pcfg.experiment, "port", version=1, config=pcfg,
                              tensorboard=False)
    tr = Trainer(pcfg, writer, device="cpu", draws=JaxDraws(cfg, init.rng))
    g = generator_from_jax(init.g_params, init.g_state, tr.g_spec, device="cpu")
    d = discriminator_from_jax(init.d_params, init.d_state, tr.d_spec, device="cpu")
    tr.state = init_train_state(pcfg, (*g, tr.g_spec), (*d, tr.d_spec))
    tr.train()
    return {"cfg": cfg, "jax": j_tr, "port": tr}


def test_trainer_epoch_matches_jax(trained):
    j_tr, tr, cfg = trained["jax"], trained["port"], trained["cfg"]
    (want,), (got,) = _metrics(j_tr.writer), _metrics(tr.writer)
    keys = {k for k in want if not k.startswith("perf/")}
    assert keys == {k for k in got if not k.startswith("perf/")}
    assert {"val/ADE k=3", "train/L2_loss", "train/net_chooser_loss"} <= keys
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tr.state.best_val, float(j_tr.state.best_val),
                               atol=ATOL, rtol=RTOL)
    assert tr.state.best_val == got["val/ADE k=3"]
    assert tr.state.step == int(j_tr.state.step) == STEPS and tr.state.epoch == 1
    assert tr.state.g_opt.count == 2 * STEPS and tr.state.d_opt.count == STEPS
    _assert_params_close(tr.state.g_params, j_tr.state.g_params, cfg.g_lr, 2 * STEPS)
    _assert_params_close(tr.state.d_params, j_tr.state.d_params, cfg.d_lr, STEPS)
    # BatchNorm running statistics: the scene CNN's running means carry the
    # conv biases (NOISE_LEAVES) they follow, so they get those leaves' bound
    flat = dict(tree_items(tr.state.g_state))
    for path, w in tree_items(jax.tree.map(np.asarray, j_tr.state.g_state)):
        noisy = path[0] == "scene" and path[-1] == "mean"
        atol = 2 * cfg.g_lr * 2 * STEPS if noisy else 1e-5
        np.testing.assert_allclose(flat[path].numpy(), w, atol=atol, rtol=1e-5,
                                   err_msg=str(path))
    assert (tr.writer.checkpoint_dir / "checkpoint_best").is_file()


def _port_trainer(tmp_path, version, **kw):
    cfg = Config(**_cfg(tmp_path, epochs=2, batch_size=24, **kw))
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=version,
                              config=cfg, tensorboard=False)
    return Trainer(cfg, writer, device="cpu")


def _leaves(state):
    trees = [state.g_params, state.g_state, state.d_params, state.d_state,
             state.g_opt.mu, state.g_opt.nu, state.d_opt.mu, state.d_opt.nu]
    return [x for t in trees for _, x in tree_items(t)]


def test_resume_replays_an_uninterrupted_run_bit_for_bit(tmp_path):
    """train(until_epoch=1) + load_from_path + train() gives the state of one
    uninterrupted two-epoch train(), bit for bit, on the CPU."""
    whole = _port_trainer(tmp_path, 1).train()
    part = _port_trainer(tmp_path, 2).train(until_epoch=1)
    assert part.state.epoch == 1
    resumed, cfg = Trainer.load_from_path(part.writer.dir, checkpoint="latest",
                                          device="cpu")
    # meta_tags.csv reads an empty string back as None (utils.py:97-106)
    assert cfg.to_dict() == {**part.config.to_dict(), "profile_dir": None}
    assert resumed.state.epoch == 1
    resumed.train()
    a, b = whole.state, resumed.state
    assert (a.step, a.epoch, a.g_opt.count, a.d_opt.count) == \
        (b.step, b.epoch, b.g_opt.count, b.d_opt.count)
    assert a.best_val == b.best_val and a.l2_weight == b.l2_weight
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("perf/")}
    assert [strip(m) for m in _metrics(whole.writer)] == \
        [strip(m) for m in _metrics(resumed.writer)]
    assert whole.test(num_k=3) == resumed.test(num_k=3)
    assert set(whole.test(num_k=3)) == {"ADE k=3", "FDE k=3", "Mode k=3"}


def test_resumed_run_keeps_the_better_best_checkpoint(tmp_path):
    """A resumed run whose validation is worse than the checkpointed
    best_val leaves checkpoint_best as it was."""
    tr = _port_trainer(tmp_path, 3).train(until_epoch=1)
    best_file = tr.writer.checkpoint_dir / "checkpoint_best"
    before = best_file.read_bytes()
    ckpt_state = ckpt.restore_checkpoint(tr.writer.checkpoint_dir, tr.state, "checkpoint_1")
    ckpt.save_checkpoint(tr.writer.checkpoint_dir,
                         ckpt_state.replace(best_val=0.0), "checkpoint_1")
    resumed, _ = Trainer.load_from_path(tr.writer.dir, checkpoint="latest", device="cpu")
    assert resumed.state.best_val == 0.0
    resumed.train()
    assert best_file.read_bytes() == before
    assert resumed.state.best_val == 0.0


# Data and generator parallelism are ported (tests/test_torch_port_{dp,gp}.py):
# outside a pod they ask for their launch; disc_scores raises, as in JAX
@pytest.mark.parametrize("kw, err, item", [
    ({"dp": 2, "gp": 2}, RuntimeError, "--nproc_per_node 4 .*--gp 2"),
    ({"gp": 2}, RuntimeError, "--nproc_per_node 2 .*--gp 2"),
    ({"slices": 2, "gp": 2}, RuntimeError, "--nproc_per_node 4 .*--gp 2 --slices 2"),
    ({"split_step": 1, "gp": 2}, ValueError, "mutually exclusive"),
    ({"profile_dir": "prof", "gp": 2}, RuntimeError, "--nproc_per_node 2 .*--gp 2"),
    ({"weighting_target": "disc_scores"}, NotImplementedError, "train.py:602"),
])
def test_unported_settings_raise_naming_their_item(tmp_path, kw, err, item):
    cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8, **kw)
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=1,
                              tensorboard=False)
    with pytest.raises(err, match=item):
        Trainer(cfg, writer, device="cpu")
