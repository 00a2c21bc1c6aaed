"""The port's evaluation path against the JAX package (CPU): the synthetic
dataset and its padded batches, the eval-mode patches, the metrics (the
golden fixture at atol 1e-5), the selection twins, the six multi-generator
strategies at flagship width given JAX's random numbers (atol 1e-4 over the
12-step rollout), and rejection on a single-generator model.

Rejection ranks candidates by ``||pert - base||^2 / sigma^2`` with a
perturbation of 1e-6 on positions of metres, so two float32
implementations of the same rollout keep different candidates; its decodes
are compared at 1e-4 and its rank-and-pick step given JAX's estimate, never
its picks end to end.
"""

import json
from math import ceil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data import augment as jax_augment
from mggan_tpu.data.batcher import PaddedBatcher as JaxPaddedBatcher
from mggan_tpu.data.loaders import get_dataloader as jax_get_dataloader
from mggan_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mggan_tpu.eval import evaluate as jax_evaluate
from mggan_tpu.eval import manifold as jax_manifold
from mggan_tpu.eval import metrics as jax_metrics
from mggan_tpu.eval import predict as jax_predict
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator
from mggan_tpu.ops import sampling as jax_sampling
from mggan_tpu.utils.pytree import relative_to_abs as jax_relative_to_abs

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.data import augment, loaders
from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.synthetic import make_synthetic_dataset
from mggan_tpu_torch.eval import evaluate, manifold, metrics, predict
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.models.weights import generator_from_jax
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.utils.pytree import relative_to_abs

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "eval_metrics_v1.json"
ATOL = 1e-4  # 12-step rollout (PARITY.md)
K = 19  # the evaluate CLI decodes max(range(1, 20)) samples
MULTI = ("expected", "uniform_expected", "smart_expected", "smart_sampling",
         "uniform_sampling", "sampling")


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _predictors(num_gens):
    """The JAX flagship generator at full width (h=32, sways social, scene
    CNN) with ``num_gens`` generators, and the port's copy of its weights."""
    cfg = JaxConfig(dataset="synthetic_memory", num_gens=num_gens, gan_type="mgan",
                    weighting_target="ml", h_dim=32, decoder_h_dim=32)
    g_spec, _ = jax_factory.build_specs(cfg)
    g_params, g_state = jax.jit(jax_generator.init, static_argnums=1)(
        jax.random.PRNGKey(0), g_spec)
    port_cfg = Config.from_dict(cfg.to_dict())
    spec = factory.build_specs(port_cfg)
    params, state = generator_from_jax(_np_tree(g_params), _np_tree(g_state), spec,
                                       device="cpu")
    return (jax_predict.Predictor(cfg, g_spec, g_params, g_state),
            predict.Predictor(port_cfg, spec, params, state, device="cpu"))


@pytest.fixture(scope="module")
def flagship():
    return _predictors(4)


def _dataset():
    return make_synthetic_dataset(num_windows=10, max_peds=4, seed=2)


def _jax_draws(key, s, p, num, num_gens, noise_dim=8):
    """The random numbers JAX's predict_multi draws from ``key``: the
    expected family's noise from the key itself, the sampling family's
    noise and Gumbel uniforms from its split."""
    k1, k2 = jax.random.split(key)
    return {
        "expected": {"z": np.array(jax.random.normal(key, (num, s, 1, noise_dim)))},
        "sampling": {
            "z": np.array(jax.random.normal(k1, (num, s, 1, noise_dim))),
            "uniforms": np.array(jax.random.uniform(
                k2, (num, s, p, num_gens), minval=1e-20, maxval=1.0)),
        },
    }


# ------------------------------------------------------------------ data --
def test_synthetic_dataset_and_padded_batches_match_jax():
    kw = dict(num_windows=9, max_peds=5, seed=3, nan_future_frac=0.3)
    ours, theirs = make_synthetic_dataset(**kw), jax_make_synthetic(**kw)
    assert ours.scene_names == theirs.scene_names
    assert ours.seq_start_end == theirs.seq_start_end
    for a, b in zip(ours.trajectories, theirs.trajectories):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.big_patches, theirs.big_patches):
        np.testing.assert_array_equal(a, b)
    for name in theirs.images:
        np.testing.assert_array_equal(ours.images[name]["small"], theirs.images[name]["small"])
    ours_b = list(PaddedBatcher(ours, batch_size=4))
    theirs_b = list(JaxPaddedBatcher(theirs, batch_size=4))
    assert len(ours_b) == len(theirs_b) == 3
    for a, b in zip(ours_b, theirs_b):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the eval-mode patches of the model (identity transform), on the device
    for a in ours_b:
        want = jax_augment.augment_batch(jax.random.PRNGKey(0), dict(a), train=False)
        got = augment.augment_batch(a, train=False, device="cpu")
        assert "big_patches" not in got
        np.testing.assert_array_equal(got["patches"].numpy(), np.asarray(want["patches"]))
        np.testing.assert_array_equal(got["xy"].numpy(), np.asarray(want["xy"]))


def test_loader_matches_jax_and_unported_parts_raise():
    ours = loaders.get_dataloader("synthetic_memory", "test", batch_size=8)
    theirs = jax_get_dataloader("synthetic_memory", "test", batch_size=8)
    for a, b in zip(ours, theirs):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    # the patch bank's loader yields the host loader's batches; its patches
    # are gathered on the device
    banked = loaders.get_dataloader("synthetic_memory", "test", batch_size=8,
                                    patch_bank=True, device="cpu")
    assert banked.patch_bank is not None and not banked.augment
    for a, b in zip(banked, loaders.get_dataloader("synthetic_memory", "test", batch_size=8)):
        assert set(a) == set(b) and torch.is_tensor(a["big_patches"])
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k])
    # train-time augmentation runs: every scene flipped and rotated
    batch = next(iter(ours))
    aug = (np.array([0, 1, 2, 0, 1, 2, 0, 1]), np.full(8, 0.3, np.float32))
    out = augment.augment_batch(batch, train=True, device="cpu", aug=aug)
    assert out["patches"].shape == (8, ours.max_peds, 33, 33, 4)
    assert not torch.equal(out["xy"], torch.from_numpy(batch["xy"]))
    # real datasets parse from the release layout; a missing one says where
    # the files go
    with pytest.raises(FileNotFoundError, match="download the reference data release"):
        loaders.get_dataset("eth", "test", data_root="/nonexistent/datasets")
    # outside a pod the per-node shard is the whole split, in lockstep
    # (tests/test_torch_port_elastic.py holds the shards against JAX's)
    shard = loaders.get_dataloader("synthetic_memory", "test", shard_by_process=True,
                                   device="cpu")
    assert shard.num_windows() == 16 and len(shard) == len(list(shard)) == 2


# --------------------------------------------------------------- metrics --
def test_metrics_reproduce_the_golden_fixture():
    """Built exactly as tests/test_golden.py::test_golden_eval_metrics."""
    ds = make_synthetic_dataset(num_windows=8, max_peds=4, seed=2)
    n = sum(len(t) for t in ds.trajectories)
    rng = np.random.RandomState(5)
    gt = np.concatenate(ds.trajectories)[:, 8:]  # (N, 12, 2)
    preds = gt.transpose(1, 0, 2)[:, None] + 0.3 * rng.randn(12, 5, n, 2)
    preds = preds.astype(np.float32)
    got = {k: float(v) for k, v in evaluate.evaluate_ade_fde(ds, preds, [1, 5]).items()}
    got.update({k: float(v) for k, v in
                manifold.evaluate_precision_recall(ds, preds, 3.0, [5]).items()})
    want = json.loads(GOLDEN.read_text())
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_batch_metrics_and_helpers_match_jax():
    rng = np.random.RandomState(1)
    s, p, k = 3, 4, 6
    pred = rng.randn(k, s, p, 12, 2).astype(np.float32) * 2
    gt = rng.randn(s, p, 12, 2).astype(np.float32) * 2
    mask = rng.rand(s, p) > 0.3
    scale = np.array([1.0, 0.5, 2.0], np.float32)
    want = jax_metrics.batch_metric_sums(jnp.asarray(pred), jnp.asarray(gt),
                                         jnp.asarray(mask), jnp.asarray(scale), [1, 3, 6])
    got = metrics.batch_metric_sums(*map(torch.from_numpy, (pred, gt, mask, scale)), [1, 3, 6])
    assert set(got) == set(want)
    acc_p, acc_j = metrics.MetricAccumulator(), jax_metrics.MetricAccumulator()
    acc_p.update(got)
    acc_j.update(want)
    for key in want:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(list(acc_p.result().values()),
                               list(acc_j.result().values()), rtol=1e-6)
    rel = rng.randn(12, 5, 2)
    assert metrics.pred_diversity(rel) == pytest.approx(jax_metrics.pred_diversity(rel))
    start = rng.randn(3, 2).astype(np.float32)
    rel3 = rng.randn(3, 12, 2).astype(np.float32)
    np.testing.assert_allclose(
        relative_to_abs(torch.from_numpy(rel3), torch.from_numpy(start)).numpy(),
        np.asarray(jax_relative_to_abs(jnp.asarray(rel3), jnp.asarray(start))), atol=1e-6)
    ds = _dataset()
    oracle = manifold.get_oracle_preds(ds, 5, seed=3)
    np.testing.assert_array_equal(oracle, jax_manifold.get_oracle_preds(ds, 5, seed=3))
    # Precision/Recall with same-observation groups (repeated windows) and a
    # NaN future: the same numbers as the JAX package's per-k manifolds
    ds = make_synthetic_dataset(num_windows=12, max_peds=5, seed=4, nan_future_frac=0.2)
    ds.trajectories += ds.trajectories[:4]
    ds.scene_names += ds.scene_names[:4]
    n = sum(len(t) for t in ds.trajectories)
    gt = np.nan_to_num(np.concatenate(ds.trajectories)[:, 8:])
    preds = (gt.transpose(1, 0, 2)[:, None] + 0.15 * rng.randn(12, 7, n, 2)).astype(np.float32)
    ks = list(range(1, 8))
    assert manifold.evaluate_precision_recall(ds, preds, 3.0, ks) == \
        jax_manifold.evaluate_precision_recall(ds, preds, 3.0, ks)
    mask_rm = np.array([0, 1, 1, 0, 1, 0], bool)
    sse = [(0, 2), (2, 5), (5, 6)]
    assert evaluate.adjust_seq_start_end_for_mask(sse, mask_rm) == \
        jax_evaluate.adjust_seq_start_end_for_mask(sse, mask_rm)


# ------------------------------------------------------------- selection --
def _probs(rng, b, g):
    """Row-normalised probabilities with exact ties, one-hots and a
    uniform row, the cases the slot allocation branches on."""
    p = rng.dirichlet(np.ones(g) * 0.5, size=b).astype(np.float32)
    p[0] = 1.0 / g
    p[1] = np.eye(g, dtype=np.float32)[g - 1]
    p[2, :2] = p[2, :2].sum() / 2
    return p


def test_selection_twins_and_gather_match_jax():
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 4, (3, 5, 19)).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.selection_indices(torch.from_numpy(idx)).numpy(),
        np.asarray(jax_sampling.selection_indices(jnp.asarray(idx))))
    for g in (2, 4):
        probs = _probs(rng, 40, g)
        for num in (7, 20):
            np.testing.assert_array_equal(
                predict.expected_selection_torch(torch.from_numpy(probs), num).numpy(),
                np.asarray(jax_predict.expected_selection_jax(jnp.asarray(probs), num)))
            for eps in (0.0, 1.0 / g):
                np.testing.assert_array_equal(
                    predict.uniform_selection_torch(torch.from_numpy(probs), num, eps).numpy(),
                    np.asarray(jax_predict.uniform_selection_jax(jnp.asarray(probs), num, eps)))
    decoded = rng.randn(19, 4, 3, 5, 12, 2).astype(np.float32)
    np.testing.assert_array_equal(
        predict.gather_by_occurrence(torch.from_numpy(decoded), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_predict.gather_by_occurrence(jnp.asarray(decoded), jnp.asarray(idx))))


def test_selection_twins_match_numpy_oracles():
    """A seeded fuzz against the JAX package's numpy oracles: 60 draws of
    (generators, samples, probabilities)."""
    rng = np.random.RandomState(0)
    for _ in range(60):
        g, num = rng.randint(1, 6), rng.randint(1, 22)
        probs = _probs(rng, 12, g) if g > 2 else \
            rng.dirichlet(np.ones(g), size=12).astype(np.float32)
        t = torch.from_numpy(probs)
        np.testing.assert_array_equal(predict.expected_selection_torch(t, num).numpy(),
                                      jax_predict.expected_selection(probs, num))
        for eps in (0.0, 1.0 / g):
            np.testing.assert_array_equal(
                predict.uniform_selection_torch(t, num, eps).numpy(),
                jax_predict.uniform_selection(probs.copy(), num, eps))


# ------------------------------------------------------------ strategies --
def test_predict_multi_matches_jax_at_flagship_width(flagship):
    jax_pred, port = flagship
    batch = next(iter(PaddedBatcher(_dataset(), batch_size=4)))
    jb = jax_augment.augment_batch(jax.random.PRNGKey(0), dict(batch), train=False)
    jb = {k: jb[k] for k in ("xy", "ped_mask", "patches")}
    key = jax.random.PRNGKey(11)
    want = jax_pred.predict_multi(jb, key, MULTI, num=K)
    s, p = batch["ped_mask"].shape
    np_jb = {k: np.array(v) for k, v in jb.items()}
    got = port.predict_multi(np_jb, None, MULTI, num=K, draws=_jax_draws(key, s, p, K, 4))
    for strat in MULTI:
        g, w = got[strat], want[strat]
        assert g[0].shape == (K, s, p, 12, 2)
        np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]), err_msg=strat)
        np.testing.assert_allclose(g[2].numpy(), np.asarray(w[2]), atol=2e-5, err_msg=strat)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), atol=ATOL, err_msg=strat)
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]), atol=ATOL, err_msg=strat)
    with pytest.raises(ValueError, match="Generator"):
        port.predict_multi(np_jb, None, MULTI, num=K)
    # every strategy function takes (batch, generator, num=, draws=)
    gen = port.new_generator(0)
    for strat in predict.STRATEGIES:
        if strat != "rejection":
            out = port.get_predict_func(strat)(np_jb, gen, num=3)
            assert out[0].shape == (3, s, p, 12, 2) and torch.isfinite(out[0]).all()


def test_eval_path_matches_jax(flagship):
    """The loader -> get_predictions_multi -> evaluate_ade_fde /
    evaluate_precision_recall path, with batch i drawing JAX's numbers from
    ``fold_in(PRNGKey(seed), i)``."""
    jax_pred, port = flagship
    ds, seed, strats = _dataset(), 5, ("smart_expected", "sampling")
    loader = PaddedBatcher(ds, batch_size=4)
    want = jax_evaluate.get_predictions_multi(jax_pred, loader, K, strats, seed=seed)
    s, p = 4, loader.max_peds
    draws = [_jax_draws(jax.random.fold_in(jax.random.PRNGKey(seed), i), s, p, K, 4)
             for i in range(len(loader))]
    got = evaluate.get_predictions_multi(port, loader, K, strats, seed=seed, draws=draws)
    ks = list(range(1, K + 1))
    n = sum(len(t) for t in ds.trajectories)
    for strat in strats:
        assert got[strat].shape == (12, K, n, 2)
        np.testing.assert_allclose(got[strat], want[strat], atol=ATOL)
        m_got = {**evaluate.evaluate_ade_fde(ds, got[strat], ks),
                 **manifold.evaluate_precision_recall(ds, got[strat], 3.0, ks)}
        m_want = {**jax_evaluate.evaluate_ade_fde(ds, want[strat], ks),
                  **jax_manifold.evaluate_precision_recall(ds, want[strat], 3.0, ks)}
        assert set(m_got) == set(m_want)
        for key in m_want:
            np.testing.assert_allclose(m_got[key], m_want[key], atol=ATOL, err_msg=key)
    own = evaluate.get_predictions(port, loader, 3, "expected", seed=1)
    assert own.shape == (12, 3, n, 2) and np.isfinite(own).all()
    np.testing.assert_array_equal(
        own, evaluate.get_predictions(port, loader, 3, "expected", seed=1))
    assert evaluate.batch_seed(1, 2) != evaluate.batch_seed(2, 1)


def test_rejection_decodes_and_pick_match_jax(flagship):
    """G=1 at h=32: the decodes (base and perturbed) at 1e-4 given JAX's
    draws; the rank-and-pick step exactly, given JAX's decodes and
    estimate; every returned trajectory one of the agent's candidates."""
    jax_pred, port = _predictors(1)
    batch = next(iter(PaddedBatcher(_dataset(), batch_size=4)))
    jb = jax_augment.augment_batch(jax.random.PRNGKey(0), dict(batch), train=False)
    jb = {k: jb[k] for k in ("xy", "ped_mask", "patches")}
    num, sigma, n_est = 6, 1e-3, 3
    total = num + ceil((1 - 0.7) * num)
    # the decodes of JAX's predict_rejection, line for line (predict.py:278-296)
    k0, k1 = jax.random.split(jax.random.PRNGKey(4))
    abs_all, rel_all, _, noise = jax_pred._decode_all(
        jax_pred.g_params, jax_pred.g_state, jb, k0, total)
    eps = jax.random.normal(k1, (n_est,) + noise.shape)
    pert_noise = (noise[None] + eps * sigma**2).reshape((-1,) + noise.shape[1:])
    pert = jax_pred._decode_with_noise(jax_pred.g_params, jax_pred.g_state, jb,
                                       pert_noise, n_est * total)[:, 0]
    pert = pert.reshape((n_est, total) + pert.shape[1:])
    base = abs_all[:, 0]
    jac = jnp.moveaxis((((pert - base[None]) ** 2).sum((-1, -2)) / sigma**2).mean(0), 0, -1)
    want = jax_pred.predict_rejection(jb, jax.random.PRNGKey(4), num, sigma, n_est)

    s = batch["ped_mask"].shape[0]
    draws = {"z": np.array(jax.random.normal(k0, (total, s, 1, 8))), "eps": np.array(eps)}
    np_jb = {k: np.array(v) for k, v in jb.items()}
    d = port.rejection_decodes(np_jb, None, num, sigma, n_est, draws=draws)
    np.testing.assert_allclose(d["base"].numpy(), np.asarray(base), atol=ATOL)
    np.testing.assert_allclose(d["pert"].numpy(), np.asarray(pert), atol=ATOL)
    picked = predict.rejection_pick(*(torch.from_numpy(np.array(x))
                                      for x in (abs_all, rel_all, jac)), num)
    for a, b in zip(picked, (want[0], want[1], want[3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        predict.rejection_jac(torch.from_numpy(np.array(base)),
                              torch.from_numpy(np.array(pert)), sigma).numpy(),
        np.asarray(jac), rtol=1e-5)

    out = port.predict_rejection(np_jb, None, num, sigma, n_est, draws=draws)
    assert out[0].shape == (num, s, batch["ped_mask"].shape[1], 12, 2)
    assert not out[3].any()
    cand = d["base"].movedim(0, 2)  # (S,P,total,T,2)
    hit = (out[0].movedim(0, 2)[:, :, :, None] == cand[:, :, None]).all(-1).all(-1)
    assert hit.any(-1).all()  # each kept trajectory is one of the agent's candidates
    with pytest.raises(ValueError, match="single generator"):
        flagship[1].predict_rejection(np_jb, None, num, draws=draws)
