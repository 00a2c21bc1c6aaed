"""The split train step against the port's fused step and the JAX
package's split step (CPU).

``build_split_train_step`` is the fused step behind JAX's split-step
checks (the port compiles nothing to split), so on the same state, batch
and draws it gives the fused step's state and metrics bit for bit. Against
JAX's
``build_split_train_step``: the same weights (the port's, moved into JAX
trees) and JAX's own draws (its phases fold ``state.rng`` with the step and
the phase; ``_split_draws``, ``test_torch_port_train._jax_draws_from_keys``
as one jitted program, since eager ``jax.random`` compiles op by op), one
step each
for mgan / ml and probgan / ml, metrics at the golden fixtures' atol/rtol
1e-4 and parameters under ``_assert_params_close`` (the ``NOISE_LEAVES``
within 2 * lr per update). A ``split_step=1`` Trainer epoch equals the
fused Trainer's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.training.state import init_train_state as jax_init_train_state
from mggan_tpu.training.steps import build_split_train_step as jax_build_split

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models.factory import construct_gan
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import (
    build_split_train_step, build_train_step, make_draws,
)
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items, tree_leaves
from test_torch_port_train import (
    ATOL, RTOL, _assert_metrics_close, _assert_params_close, _batch,
)

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

S, P = 3, 4
BASE = dict(dataset="synthetic_memory", num_gens=2, h_dim=16, decoder_h_dim=16,
            num_samples=4)
FAMILIES = {"mgan_ml": {}, "probgan_ml": dict(gan_type="probgan", global_disc=0),
            "gan_none": dict(gan_type="gan", weighting_target="none", num_gens=1)}


def _state_leaves(state):
    trees = [state.g_params, state.g_state, state.d_params, state.d_state,
             state.g_opt.mu, state.g_opt.nu, state.d_opt.mu, state.d_opt.nu]
    return [x for t in trees for _, x in tree_items(t)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_step_equals_the_fused_step(family):
    """Two steps from step 0 (probgan's history average runs at step 0) on
    one batch and the same draws: states and metrics bit for bit."""
    cfg = Config(**{**BASE, **FAMILIES[family]})
    g_pack, d_pack = construct_gan(cfg, seed=3, device="cpu")
    batch = _batch(S, P, seed=7)
    gen = torch.Generator().manual_seed(5)
    draws = [make_draws(gen, cfg, S, P, g_pack[0], d_pack[0]) for _ in range(2)]
    fused, split = build_train_step(cfg, g_pack[2], d_pack[2]), \
        build_split_train_step(cfg, g_pack[2], d_pack[2])
    a = b = start = init_train_state(cfg, g_pack, d_pack, seed=1)
    for dr in draws:
        a, ma = fused(a, batch, dr)
        b, mb = split(b, batch, dr)
        assert list(ma) == list(mb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma), family
    assert (a.step, a.g_opt.count, a.d_opt.count) == (b.step, b.g_opt.count, b.d_opt.count)
    assert all(torch.equal(x, y) for x, y in zip(_state_leaves(a), _state_leaves(b)))
    if family == "probgan_ml":  # the history was averaged once, at step 0
        assert float(b.d_state["hist"]["len"]) == float(start.d_state["hist"]["len"]) + 1


@pytest.mark.parametrize("kw", [{"num_unrolling_steps": 1}, {"num_gen_steps": 2}])
def test_split_step_refuses_gating_and_unrolling(kw):
    cfg = Config(**{**BASE, **kw})
    g_pack, d_pack = construct_gan(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="ungated configuration"):
        build_split_train_step(cfg, g_pack[2], d_pack[2])


def _split_draws(keys, cfg: JaxConfig, s, p, d_params, g_params):
    """``test_torch_port_train._jax_draws_from_keys(*keys, ...)`` for a step
    without unrolling and without W, in one jitted program."""
    rnd = jax.random

    def labels(key):
        kr, kf = rnd.split(key)
        return jnp.stack([rnd.uniform(kr, (), minval=0.9, maxval=1.0),
                          rnd.uniform(kf, (), minval=0.0, maxval=0.1)])

    def sampled(key, k):
        k_noise, k_cat = rnd.split(key)
        return (rnd.uniform(k_cat, (k, s, p, cfg.num_gens), minval=1e-20, maxval=1.0),
                rnd.normal(k_noise, (k, s, 1, cfg.noise_dim)))

    def normals(key, tree):
        # rnd.normal(k, x.shape) for each leaf's key k, drawn under vmap for
        # all the leaves of one size (the same numbers; XLA compiles one
        # generator per size instead of one per leaf)
        leaves, treedef = jax.tree.flatten(tree)
        ks = rnd.split(rnd.fold_in(key, 1729), len(leaves))
        out, sizes = [None] * len(leaves), {}
        for i, x in enumerate(leaves):
            sizes.setdefault(x.size, []).append(i)
        for n, idx in sizes.items():
            drawn = jax.vmap(lambda k, n=n: rnd.normal(k, (n,)))(ks[np.array(idx)])
            for row, i in zip(drawn, idx):
                out[i] = row.reshape(leaves[i].shape)
        return jax.tree.unflatten(treedef, out)

    @jax.jit
    def draws(kd, kg, kpm, dp, gp):
        d_lab, d_gen, _ = rnd.split(kd, 3)
        du, dz = sampled(d_gen, 1)
        g_lab, g_gen = rnd.split(kg)
        gu, gz = sampled(g_gen, cfg.num_samples)
        out = {"d_labels": labels(d_lab)[None], "d_uniforms": du[None], "d_z": dz[None],
               "g_labels": labels(g_lab), "g_uniforms": gu, "g_z": gz,
               "pm_z": rnd.normal(kpm, (cfg.num_expectation_samples, s, 1, cfg.noise_dim))}
        if cfg.gan_type == "probgan":
            out["d_noise"] = jax.tree.map(lambda x: x[None], normals(kd, dp))
            out["g_noise"] = normals(kg, gp)
        return out

    return jax.tree.map(np.array, draws(*keys, d_params, g_params))


def _jax_start(jcfg: JaxConfig):
    """The port's weights for ``jcfg`` in the JAX trees (dtypes of JAX's
    own init) and both frameworks' states at step 0."""
    pcfg = Config.from_dict(jcfg.to_dict())
    g_pack, d_pack = construct_gan(pcfg, seed=3, device="cpu")
    like = jax.eval_shape(lambda k: tuple(x[:2] for x in jax_factory.construct_model(jcfg, k)),
                          jax.random.PRNGKey(0))
    to_jax = lambda want, tree: jax.tree.map(
        lambda w, t: jnp.asarray(t.numpy(), w.dtype), want, tree)
    (jg, jgs), (jd, jds) = to_jax(like[0], g_pack[:2]), to_jax(like[1], d_pack[:2])
    j_g_spec, j_d_spec = jax_factory.build_specs(jcfg)
    rng = jax.random.PRNGKey(11)
    j_state = jax.jit(lambda *t: jax_init_train_state(
        jcfg, (t[0], t[1], j_g_spec), (t[2], t[3], j_d_spec), t[4]))(jg, jgs, jd, jds, rng)
    return pcfg, (g_pack, d_pack), (j_state, j_g_spec, j_d_spec)


def check_split_against_jax(family):
    """One split step of ``family`` in both packages (see the module note)."""
    jcfg = JaxConfig(**{**BASE, **FAMILIES[family]})
    pcfg, (g_pack, d_pack), (j_state, j_g_spec, j_d_spec) = _jax_start(jcfg)
    batch = _batch(S, P, seed=7)
    j_step = jax_build_split(jcfg, j_g_spec, j_d_spec)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the phases' keys (mggan_tpu/training/steps.py:528-541), taken before
    # the step donates the state's buffers
    keys = [jax.random.fold_in(jax.random.fold_in(j_state.rng, j_state.step), i)
            for i in range(3)]
    draws = _split_draws(keys, jcfg, S, P, j_state.d_params, j_state.g_params)
    j_step.precompile(j_state, j_batch)
    j_new, j_metrics = j_step(j_state, j_batch)

    state = init_train_state(pcfg, g_pack, d_pack, seed=1)
    step = build_split_train_step(pcfg, g_pack[2], d_pack[2])
    new, metrics = step(state, batch, draws)
    _assert_metrics_close({k: float(v) for k, v in metrics.items()},
                          {k: float(v) for k, v in j_metrics.items()})
    assert new.step == int(j_new.step) == 1
    _assert_params_close(new.g_params, j_new.g_params, pcfg.g_lr, 2)
    _assert_params_close(new.d_params, j_new.d_params, pcfg.d_lr, 1)
    for (path, got), (_, want) in zip(tree_items(new.d_state),
                                      tree_items(jax.tree.map(np.asarray, j_new.d_state))):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=str(path))


def test_split_step_matches_jax_split_step():
    """mgan / ml (probgan / ml: ``test_torch_port_split_probgan.py``, a file
    of its own for the JAX compile's time)."""
    check_split_against_jax("mgan_ml")


def _trainer(tmp_path, version, **kw):
    cfg = Config(**{**BASE, "batch_size": 24, "epochs": 1, "top_k_test": 3, "augment": 1,
                    "log_dir": str(tmp_path), **kw})
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=version,
                              config=cfg, tensorboard=False)
    return Trainer(cfg, writer, device="cpu")


def test_split_step_trainer_epoch_equals_the_fused_one(tmp_path):
    """A ``split_step=1`` Trainer epoch (2 steps, validation, checkpoints)
    gives the fused Trainer's state and metrics bit for bit."""
    fused = _trainer(tmp_path, 1).train()
    split = _trainer(tmp_path, 2, split_step=1).train()
    a, b = fused.state, split.state
    assert (a.step, a.epoch, a.best_val) == (b.step, b.epoch, b.best_val) == \
        (2, 1, a.best_val)
    assert all(torch.equal(x, y) for x, y in zip(_state_leaves(a), _state_leaves(b)))
    strip = lambda w: [{k: v for k, v in json.loads(line).items() if not k.startswith("perf/")}
                       for line in (w.dir / "metrics.jsonl").read_text().splitlines()]
    assert strip(fused.writer) == strip(split.writer)
    assert np.isfinite(strip(split.writer)[0]["val/ADE k=3"])
    assert len(tree_leaves(b.g_params)) > 0
