"""The ported train step and its parts against the JAX package (CPU).

The same weights (JAX init, moved with ``generator_from_jax`` /
``discriminator_from_jax``) and the same random numbers (replayed from the
JAX step's own key tree and injected as ``draws``) go through both
frameworks. Tolerances: the golden fixtures' atol 1e-4 and rtol 1e-4 on
every metric (tests/test_golden.py); parameters after a step at atol 1e-4,
except where the gradient is zero but for float noise (the conv biases
before train-mode BatchNorm): Adam's first update moves a parameter by
about lr * sign(g), so there a sign flip moves an element by up to 2 * lr
per update (see ``_assert_params_close``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import discriminator as jax_D
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import torch_export
from mggan_tpu.ops import cnn as jax_cnn
from mggan_tpu.training.state import init_train_state as jax_init_train_state
from mggan_tpu.training.state import make_optimizer as jax_make_optimizer
from mggan_tpu.training.state import with_lr
from mggan_tpu.training.steps import build_train_step as jax_build_train_step

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import discriminator, factory
from mggan_tpu_torch.models.weights import (
    discriminator_from_jax,
    discriminator_from_state_dict,
    generator_from_jax,
)
from mggan_tpu_torch.ops import cnn
from mggan_tpu_torch.training.state import init_train_state, make_optimizer
from mggan_tpu_torch.training.steps import batch_views, build_train_step
from mggan_tpu_torch.utils.pytree import tree_items, tree_leaves

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "train_step_mgan_ml_v1.json"
ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_packs(cfg: JaxConfig, key=0):
    """JAX ``construct_model`` packs and the same weights in the port."""
    g_pack, d_pack = jax_factory.construct_model(cfg, jax.random.PRNGKey(key))
    pcfg = Config.from_dict(cfg.to_dict())
    g_spec, d_spec = factory.build_specs(pcfg), factory.build_d_spec(pcfg)
    gp, gs = generator_from_jax(_np(g_pack[0]), _np(g_pack[1]), g_spec, device="cpu")
    dp, ds = discriminator_from_jax(_np(d_pack[0]), _np(d_pack[1]), d_spec, device="cpu")
    return (g_pack, d_pack), pcfg, (gp, gs, g_spec), (dp, ds, d_spec)


def _batch(s, p, seed=11):
    """``tests/test_golden.py::_fixed_batch`` at any size (numpy)."""
    rng = np.random.RandomState(seed)
    xy = rng.randn(s, p, 20, 2).astype(np.float32).cumsum(axis=2)
    mask = np.ones((s, p), bool)
    mask[0, -1] = False  # one padded slot
    xy[~mask] = 0.0
    patches = rng.uniform(-1, 1, (s, p, 33, 33, 4)).astype(np.float32)
    return {"xy": xy, "ped_mask": mask, "patches": patches}


def _jax_draws(rng, cfg: JaxConfig, s, p, d_params=None, g_params=None):
    """The random numbers the JAX step draws from ``state.rng``
    (steps.py:125, 162, 240, 404, 423; sampling.py:15-43;
    losses.gan_labels; trajectory_tools.noise_loss), in ``make_draws``'s
    layout: each D update ``u`` from ``fold_in(kd, u)`` when unrolling, else
    from ``kd``; probgan's normals from ``fold_in(key, 1729)``, one key per
    leaf of ``d_params`` / ``g_params`` (the JAX trees)."""
    _, kd, kg, kpm = jax.random.split(rng, 4)
    return _jax_draws_from_keys(kd, kg, kpm, cfg, s, p, d_params, g_params)


def _jax_draws_from_keys(kd, kg, kpm, cfg: JaxConfig, s, p, d_params=None, g_params=None):
    """``_jax_draws`` from the D, G and PM steps' keys themselves (the split
    step folds them from ``state.rng`` and the step)."""

    def labels(key):
        kr, kf = jax.random.split(key)
        return (float(jax.random.uniform(kr, (), minval=0.9, maxval=1.0)),
                float(jax.random.uniform(kf, (), minval=0.0, maxval=0.1)))

    def sampled(key, k):
        k_noise, k_cat = jax.random.split(key)
        u = jax.random.uniform(k_cat, (k, s, p, cfg.num_gens), minval=1e-20, maxval=1.0)
        return np.array(u), np.array(jax.random.normal(k_noise, (k, s, 1, cfg.noise_dim)))

    def normals(key, tree):
        leaves, treedef = jax.tree.flatten(tree)
        keys = jax.random.split(jax.random.fold_in(key, 1729), len(leaves))
        return jax.tree.unflatten(treedef, [np.array(jax.random.normal(k, x.shape))
                                            for k, x in zip(keys, leaves)])

    unroll = cfg.num_unrolling_steps
    d_keys = [jax.random.fold_in(kd, u) for u in range(unroll + 1)] if unroll else [kd]
    d_units = []
    for key in d_keys:
        d_lab, d_gen, d_gp = jax.random.split(key, 3)
        du, dz = sampled(d_gen, 1)
        d_units.append((labels(d_lab), du, dz, np.array(jax.random.uniform(d_gp, (s, p, 1, 1))),
                        normals(key, d_params) if cfg.gan_type == "probgan" else None))
    g_lab, g_gen = jax.random.split(kg)
    gu, gz = sampled(g_gen, cfg.num_samples)
    pm_z = jax.random.normal(kpm, (cfg.num_expectation_samples, s, 1, cfg.noise_dim))
    draws = {"d_labels": np.array([u[0] for u in d_units]),
             "d_uniforms": np.stack([u[1] for u in d_units]),
             "d_z": np.stack([u[2] for u in d_units]),
             "g_labels": labels(g_lab), "g_uniforms": gu, "g_z": gz,
             "pm_z": np.array(pm_z)}
    if cfg.gan_obj == "W":
        draws["d_alpha"] = np.stack([u[3] for u in d_units])
    if cfg.gan_type == "probgan":
        draws["d_noise"] = jax.tree.map(lambda *xs: np.stack(xs), *[u[4] for u in d_units])
        draws["g_noise"] = normals(kg, g_params)
    return draws


def _port_step(cfg, packs, batch, draws):
    pcfg, g_pack, d_pack = packs
    state = init_train_state(pcfg, g_pack, d_pack)
    return build_train_step(pcfg, g_pack[2], d_pack[2])(state, batch, draws)


def _gsums(state):
    return {
        "gsum/g_params": float(sum(x.abs().sum() for x in tree_leaves(state.g_params))),
        "gsum/d_params": float(sum(x.abs().sum() for x in tree_leaves(state.d_params))),
    }


def _assert_metrics_close(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


# The scene CNNs' conv biases feed train-mode BatchNorm, which subtracts
# the batch mean: their gradient is zero but for float noise in both
# frameworks, so Adam moves them by +-lr of a random sign.
NOISE_LEAVES = {("scene", "conv1", "b"), ("scene", "conv2", "b")}


def _assert_params_close(port_tree, jax_tree, lr, updates):
    """Every element within ATOL, but the zero-gradient leaves NOISE_LEAVES,
    whose Adam step may flip sign: within 2 * lr * updates + ATOL."""
    flat = dict(tree_items(port_tree))
    for path, want in tree_items(_np(jax_tree)):
        atol = 2 * lr * updates + ATOL if path in NOISE_LEAVES else ATOL
        np.testing.assert_allclose(flat[path].numpy(), want, atol=atol, rtol=0,
                                   err_msg=str(path))


def test_discriminator_loaders_and_train_scores_match_jax():
    """``discriminator_from_jax`` and ``discriminator_from_state_dict`` give
    one tree; D.apply with train-mode BN over a masked batch gives JAX's
    scores, branch logits and running statistics."""
    cfg = JaxConfig(dataset="synthetic_memory", num_gens=3, h_dim=16,
                    decoder_h_dim=16, gan_type="mgan")
    (_, (d_params, d_state, jd_spec)), _, _, (dp, ds, d_spec) = _port_packs(cfg)
    sd = torch_export.export_discriminator(d_params, d_state, jd_spec)
    dp2, ds2 = discriminator_from_state_dict(sd, d_spec, device="cpu")
    for tree_a, tree_b in ((dp, dp2), (ds, ds2)):
        items_a, items_b = list(tree_items(tree_a)), list(tree_items(tree_b))
        assert [k for k, _ in items_a] == [k for k, _ in items_b]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(items_a, items_b))
    with pytest.raises(KeyError, match="unexpected"):
        discriminator_from_state_dict({**sd, "extra.bias": np.zeros(1)}, d_spec, "cpu")

    batch = _batch(3, 4, seed=5)
    batch["ped_mask"][2, 1:] = False
    k = 2
    rng = np.random.RandomState(3)
    pred_xy = rng.randn(k, 3, 4, 12, 2).astype(np.float32)
    pred_dxdy = rng.randn(k, 3, 4, 12, 2).astype(np.float32) * 0.3
    bv = batch_views({k_: torch.from_numpy(v) for k_, v in batch.items()})
    args = (bv.in_xy, bv.in_dxdy, torch.from_numpy(pred_xy), torch.from_numpy(pred_dxdy),
            bv.ped_mask, bv.loss_mask, bv.patches)
    got = discriminator.apply(dp2, ds2, d_spec, *args, train=True)
    j_apply = jax.jit(lambda *a: jax_D.apply(d_params, d_state, jd_spec, *a, train=True))
    want = j_apply(*(jnp.asarray(a.numpy()) for a in args))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    for (path, g), (_, w) in zip(tree_items(got[2]), tree_items(_np(want[2]))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_train_batchnorm_matches_jax_bn_apply():
    """Masked train BatchNorm: batch statistics over the kept rows, running
    statistics with momentum 0.1 and the unbiased variance."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5, 5, 3).astype(np.float32) * 2 + 1
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    params = {"scale": rng.rand(3).astype(np.float32) + 0.5,
              "bias": rng.randn(3).astype(np.float32)}
    state = {"mean": rng.randn(3).astype(np.float32),
             "var": rng.rand(3).astype(np.float32) + 0.5}
    want_y, want_state = jax_cnn.bn_apply(params, state, jnp.asarray(x), True,
                                          mask=jnp.asarray(mask))
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    got_y, got_state = cnn.bn_train_nchw(t(params), t(state),
                                         torch.from_numpy(x).permute(0, 3, 1, 2),
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(got_y.permute(0, 2, 3, 1).numpy(), np.asarray(want_y),
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(want_state[k]),
                                   atol=1e-6, rtol=1e-6)
    # through the whole scene CNN, train mode
    pp, ps = jax_cnn.scene_cnn_init(jax.random.PRNGKey(1), channels_cnn=8)
    patches = rng.uniform(-1, 1, (6, 33, 33, 4)).astype(np.float32)
    want_enc, want_st = jax_cnn.scene_cnn_apply(pp, ps, jnp.asarray(patches), True,
                                               mask=jnp.asarray(mask))
    tt = lambda tree: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    got_enc, got_st = cnn.scene_cnn_apply_train(tt(pp), tt(ps), torch.from_numpy(patches),
                                                torch.from_numpy(mask))
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=1e-5)
    for (path, g), (_, w) in zip(tree_items(got_st), tree_items(_np(want_st))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_optimizer_matches_optax_chain():
    """Two updates of clip + AdamW on a tree with a zero-gradient leaf and a
    gradient norm over the clip, against the JAX package's optax chain."""
    rng = np.random.RandomState(4)
    params = {"a": {"w": rng.randn(4, 3).astype(np.float32)},
              "b": rng.randn(5).astype(np.float32),
              "frozen": rng.randn(2).astype(np.float32)}
    grads = [{"a": {"w": rng.randn(4, 3).astype(np.float32) * s},
              "b": rng.randn(5).astype(np.float32) * s,
              "frozen": np.zeros(2, np.float32)} for s in (40.0, 0.3)]
    lrs = (1e-3, 5e-4)
    tx = jax_make_optimizer(1e-3, 0.5, 10.0)
    j_params, j_opt = jax.tree.map(jnp.asarray, params), None
    j_opt = tx.init(j_params)
    tt = lambda tree: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    opt = make_optimizer(1e-3, 0.5, 10.0)
    p_params = tt(params)
    p_opt = opt.init(p_params)
    for g, lr in zip(grads, lrs):
        upd, j_opt = tx.update(jax.tree.map(jnp.asarray, g), with_lr(j_opt, lr), j_params)
        j_params = optax.apply_updates(j_params, upd)
        p_params, p_opt = opt.update(tt(g), p_opt, p_params, lr)
    assert p_opt.count == 2
    for (path, got), (_, want) in zip(tree_items(p_params), tree_items(_np(j_params))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=1e-6, err_msg=str(path))
    assert not np.allclose(p_params["frozen"].numpy(), params["frozen"])


def test_train_step_matches_golden_fixture():
    """The whole step at tests/test_golden.py's mgan/ml config and batch,
    with JAX's weights and random numbers, on all 28 fixture keys."""
    cfg = JaxConfig(dataset="synthetic_memory", batch_size=4, num_gens=2, epochs=2,
                    num_samples=3, num_expectation_samples=2, h_dim=16,
                    decoder_h_dim=16, noise_dim=8, gan_type="mgan",
                    weighting_target="ml", gan_obj="NS")
    _, pcfg, g_pack, d_pack = _port_packs(cfg)
    draws = _jax_draws(jax.random.PRNGKey(1), cfg, 4, 3)
    state, metrics = _port_step(cfg, (pcfg, g_pack, d_pack), _batch(4, 3), draws)
    got = {k: float(v) for k, v in metrics.items()}
    got.update(_gsums(state))
    assert len(got) == 28
    _assert_metrics_close(got, json.loads(GOLDEN.read_text()))
    assert state.step == 1 and state.g_opt.count == 2 and state.d_opt.count == 1


def test_train_step_matches_jax_at_flagship_width():
    """One step of the flagship config (mgan, G=4, h=32, K=20, ml) on a few
    small scenes against the JAX build_train_step, same draws."""
    cfg = JaxConfig(dataset="synthetic_memory", num_gens=4, gan_type="mgan",
                    weighting_target="ml", h_dim=32, decoder_h_dim=32)
    (j_g, j_d), pcfg, g_pack, d_pack = _port_packs(cfg)
    s, p = 2, 5
    batch = _batch(s, p, seed=3)
    j_state = jax_init_train_state(cfg, j_g, j_d, jax.random.PRNGKey(1))
    j_step = jax_build_train_step(cfg, j_g[2], j_d[2])
    j_new, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = _jax_draws(jax.random.PRNGKey(1), cfg, s, p)
    state, metrics = _port_step(cfg, (pcfg, g_pack, d_pack), batch, draws)
    _assert_metrics_close({k: float(v) for k, v in metrics.items()},
                          {k: float(v) for k, v in j_metrics.items()})
    _assert_params_close(state.g_params, j_new.g_params, cfg.g_lr, 2)
    _assert_params_close(state.d_params, j_new.d_params, cfg.d_lr, 1)
    for (path, g), (_, w) in zip(tree_items(state.g_state), tree_items(_np(j_new.g_state))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5, err_msg=str(path))


def test_build_train_step_raises_outside_its_scope():
    """Only what the JAX step refuses raises: the disc_scores PM target.
    The settings that once raised here build a step."""
    for kw in ({"gan_type": "gan"}, {"gan_obj": "W"}, {"weighting_target": "l2"},
               {"num_unrolling_steps": 1}, {"num_gen_steps": 2},
               {"l2_loss_type": "mse"}):
        cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8, **kw)
        assert callable(build_train_step(cfg, factory.build_specs(cfg),
                                         factory.build_d_spec(cfg)))
    cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8, weighting_target="disc_scores")
    with pytest.raises(NotImplementedError, match="disc_scores"):
        build_train_step(cfg, factory.build_specs(cfg), factory.build_d_spec(cfg))
