"""The port's train-time feed against the JAX package (CPU): augmentation,
the device patch bank, the epoch order, the prefetch thread, checkpoints
and the experiment writer's files.

Tolerances: trajectories within 2e-5 (float32 coordinates of up to ~70 m,
whose ulp is ~8e-6, after a rotation whose cos and sin may differ by an ulp
between XLA and torch); bilinear patches within 1e-5. Nearest patches are
equal but at ties: where an output pixel's source coordinate lies within
float rounding of a half-integer, an ulp of cos or sin picks the other
source pixel. Such pixels are counted, and each must lie within 1e-4 px of
a half-integer.
"""

import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data import augment as jax_augment
from mggan_tpu.data.batcher import PaddedBatcher as JaxPaddedBatcher
from mggan_tpu.data.patch_bank import DevicePatchBank as JaxDevicePatchBank
from mggan_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from mggan_tpu.training.checkpoints import resolve_checkpoint_name as jax_resolve
from mggan_tpu.utils.logging import ExperimentWriter as JaxExperimentWriter

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.data import augment, patch_bank
from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.prefetch import Prefetcher
from mggan_tpu_torch.data.synthetic import make_synthetic_dataset
from mggan_tpu_torch.models.factory import construct_gan
from mggan_tpu_torch.training import checkpoints as ckpt
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import build_train_step
from mggan_tpu_torch.utils.logging import ExperimentWriter, get_versions, load_meta_tags
from mggan_tpu_torch.utils.pytree import tree_items
from mggan_tpu_torch.utils.trajectory_tools import GradNormLogger

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

TRAJ_ATOL = 2e-5
BILINEAR_ATOL = 1e-5
TIE_PX = 1e-4
MAX_TIES = 4  # (scene, output pixel) positions per comparison


def _jax_aug(seed, s):
    flip, alpha = jax_augment.sample_aug_params(jax.random.PRNGKey(seed), s)
    return np.array(flip), np.array(alpha)


def _dataset(n=12, peds=5, seed=3, **kw):
    return make_synthetic_dataset(num_windows=n, max_peds=peds, seed=seed, **kw)


# ---------------------------------------------------------- augmentation --
def test_augment_trajectories_matches_jax():
    """Every flip value, a NaN future and scenes of different extents, with
    JAX's sample_aug_params draws."""
    rng = np.random.RandomState(0)
    s, p = 9, 4
    xy = (rng.rand(s, p, 20, 2) * 60).astype(np.float32)
    xy[2, 1, 8:] = np.nan
    wh_m = np.stack([rng.uniform(20, 70, s), rng.uniform(20, 70, s)], -1).astype(np.float32)
    _, alpha = _jax_aug(5, s)
    flip = np.array([0, 1, 2] * 3, np.int32)
    want = np.asarray(jax_augment.augment_trajectories(
        jnp.asarray(xy), jnp.asarray(wh_m), jnp.asarray(flip), jnp.asarray(alpha)))
    got = augment.augment_trajectories(*(torch.from_numpy(a) for a in (xy, wh_m, flip,
                                                                        alpha))).numpy()
    assert np.isnan(got[2, 1, 8:]).all() and not np.isnan(got[2, 1, :8]).any()
    np.testing.assert_allclose(got, want, atol=TRAJ_ATOL, rtol=0)
    assert np.isnan(want).sum() == np.isnan(got).sum() == 24


def _finish_both(big, flip, alpha, interp):
    want = np.asarray(jax.jit(jax_augment.finish_patches, static_argnums=3)(
        jnp.asarray(big), jnp.asarray(flip), jnp.asarray(alpha), interp))
    got = augment.finish_patches(torch.from_numpy(big), torch.from_numpy(flip),
                                 torch.from_numpy(alpha), interp).numpy()
    return got, want


def _ties(got, want, flip, alpha):
    """(scene, output pixel) positions where nearest patches differ; each
    must sit on a rounding tie of the port's source coordinates."""
    diff = (got != want).any(axis=(1, 4)).reshape(len(flip), -1)  # (S, O)
    sx, sy = augment.source_coords(torch.from_numpy(flip), torch.from_numpy(alpha))
    off = lambda c: np.abs(c.numpy() - np.floor(c.numpy()) - 0.5)
    near = (off(sx) < TIE_PX) | (off(sy) < TIE_PX)
    assert not (diff & ~near).any(), "nearest pixels differ away from a tie"
    return int(diff.sum())


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_finish_patches_matches_jax(interp):
    """Random, zero, right-angle and 45-degree rotations, every flip."""
    rng = np.random.RandomState(1)
    s, p = 8, 3
    big = rng.randint(0, 256, (s, p, 49, 49, 3)).astype(np.uint8)
    _, alpha = _jax_aug(7, s)
    alpha = alpha.copy()
    alpha[:3] = [0.0, np.float32(math.pi / 2), np.float32(math.pi / 4)]
    flip = np.array([0, 1, 2, 0, 1, 2, 1, 0], np.int32)
    got, want = _finish_both(big, flip, alpha, interp)
    assert got.shape == want.shape == (s, p, 33, 33, 4)
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    if interp == "bilinear":
        np.testing.assert_allclose(got, want, atol=BILINEAR_ATOL, rtol=0)
    else:
        assert _ties(got, want, flip, alpha) <= MAX_TIES


def test_zero_transform_is_identity_patches():
    big = np.random.RandomState(2).randint(0, 256, (3, 2, 49, 49, 3)).astype(np.uint8)
    zeros = torch.zeros(3, dtype=torch.int64), torch.zeros(3)
    ident = augment.identity_patches(torch.from_numpy(big))
    for interp in ("nearest", "bilinear"):
        assert torch.equal(augment.finish_patches(torch.from_numpy(big), *zeros, interp), ident)


def test_augment_batch_train_matches_jax():
    ds = _dataset()
    batch = PaddedBatcher(ds, batch_size=4).make_batch(np.arange(4))
    flip, alpha = _jax_aug(3, 4)
    got = augment.augment_batch(batch, train=True, device="cpu", aug=(flip, alpha))
    want = jax_augment.augment_batch(jax.random.PRNGKey(3), dict(batch), train=True)
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]), atol=TRAJ_ATOL)
    assert _ties(got["patches"].numpy(), np.asarray(want["patches"]), flip, alpha) <= MAX_TIES
    assert "big_patches" not in got and got["patches"].shape == (4, 5, 33, 33, 4)
    with pytest.raises(ValueError, match="needs aug"):
        augment.augment_batch(batch, train=True, device="cpu")


# ----------------------------------------------------------- patch bank --
def test_bank_gather_matches_host_assembly_and_jax():
    ds = _dataset(n=10)
    bank = patch_bank.maybe_build_bank(ds, 5, device="cpu")
    assert bank.nbytes == patch_bank.bank_nbytes(10, 5) == bank.arr.numel()
    host = PaddedBatcher(ds, batch_size=4, max_peds=5)
    idx = np.array([7, 0, 3, -1])  # a pad scene at the end
    want = host.make_batch(idx[:3])["big_patches"]
    got = bank.gather(idx)
    assert got.dtype == torch.uint8 and got.shape == (4, 5, 49, 49, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[3].any()
    jax_bank = JaxDevicePatchBank(jax_make_synthetic(num_windows=10, max_peds=5, seed=3), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_bank.gather(idx)))


def test_maybe_build_bank_gates_on_budget_and_patches():
    ds = _dataset(n=6)
    need = patch_bank.bank_nbytes(6, 5)
    gc.collect()
    held = patch_bank.live_bank_bytes()
    assert patch_bank.maybe_build_bank(ds, 5, max_bytes=held + need - 1, device="cpu") is None
    bank = patch_bank.maybe_build_bank(ds, 5, max_bytes=held + need, device="cpu")
    assert bank is not None and patch_bank.live_bank_bytes() == held + need
    ds.big_patches = None
    assert patch_bank.maybe_build_bank(ds, 5, device="cpu") is None


@pytest.mark.parametrize("bank", [False, True])
def test_set_epoch_order_matches_jax(bank):
    """Each epoch's batches are a pure function of (seed, epoch) and equal
    the JAX batcher's, with host patches or the bank's gather."""
    ours_ds = _dataset(n=11, nan_future_frac=0.2)
    theirs_ds = jax_make_synthetic(num_windows=11, max_peds=5, seed=3, nan_future_frac=0.2)
    for seed in (0, 7):
        b = patch_bank.maybe_build_bank(ours_ds, 5, device="cpu") if bank else None
        ours = PaddedBatcher(ours_ds, 4, shuffle=True, seed=seed, patch_bank=b)
        theirs = JaxPaddedBatcher(theirs_ds, 4, shuffle=True, seed=seed)
        for epoch in (3, 0, 3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 3
            for a, w in zip(got, want):
                assert set(a) == set(w)
                for k in w:
                    np.testing.assert_array_equal(np.asarray(a[k]), w[k], err_msg=k)


# -------------------------------------------------------------- prefetch --
def test_prefetcher_keeps_order_and_passes_errors_on():
    assert list(Prefetcher(range(50), depth=3)) == list(range(50))

    def broken():
        yield 1
        yield 2
        raise KeyError("batch 3")

    it = Prefetcher(broken())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match="batch 3"):
        next(it)


def test_prefetcher_close_stops_an_abandoned_worker():
    """A consumer that stops early (a step that raises) leaves no worker
    blocked on the full queue and no batch held."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    with pytest.raises(RuntimeError, match="step failed"):
        with Prefetcher(endless(), depth=2) as it:
            for x in it:
                if x == 3:
                    raise RuntimeError("step failed")
    assert not it._thread.is_alive() and it._q.empty()


# ----------------------------------------------------------- checkpoints --
def _stepped_state():
    cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8, num_samples=3)
    g, d = construct_gan(cfg, seed=1, device="cpu")
    state = init_train_state(cfg, g, d, seed=5)
    ds = _dataset(n=4, peds=3)
    batch = augment.augment_batch(PaddedBatcher(ds, 4).make_batch(np.arange(4)),
                                  train=False, device="cpu")
    batch = {k: batch[k] for k in ("xy", "ped_mask", "patches")}
    state, _ = build_train_step(cfg, g[2], d[2])(state, batch)
    return cfg, g, d, state.replace(epoch=1, best_val=1.25, l2_weight=0.5)


def test_checkpoint_round_trip_is_exact(tmp_path):
    cfg, g, d, state = _stepped_state()
    ckpt.save_checkpoint(tmp_path, state, "checkpoint_1")
    blob = torch.load(tmp_path / "checkpoint_1", weights_only=True)
    assert blob["g_opt"]["count"] == 2 and blob["d_opt"]["count"] == 1
    fresh = init_train_state(cfg, g, d, seed=9)
    back = ckpt.restore_checkpoint(tmp_path, fresh, "checkpoint_1")
    assert (back.step, back.epoch, back.best_val, back.l2_weight) == (1, 1, 1.25, 0.5)
    assert (back.g_opt.count, back.d_opt.count) == (2, 1)
    for name in ("g_params", "g_state", "d_params", "d_state"):
        for (pa, a), (pb, b) in zip(tree_items(getattr(state, name)),
                                    tree_items(getattr(back, name))):
            assert pa == pb and torch.equal(a, b), (name, pa)
    for opt in ("g_opt", "d_opt"):
        for tree in ("mu", "nu"):
            for (_, a), (_, b) in zip(tree_items(getattr(getattr(state, opt), tree)),
                                      tree_items(getattr(getattr(back, opt), tree))):
                assert torch.equal(a, b)
    assert torch.equal(torch.rand(5, generator=state.generator),
                       torch.rand(5, generator=back.generator))
    cut = fresh.replace(g_params={k: v for k, v in fresh.g_params.items() if k != "net_prior"})
    with pytest.raises(KeyError, match="net_prior"):
        ckpt.restore_checkpoint(tmp_path, cut, "checkpoint_1")


def test_resolve_checkpoint_name_matches_jax(tmp_path):
    for name in ("checkpoint_1", "checkpoint_12", "checkpoint_3"):
        (tmp_path / name).write_bytes(b"")
    for which in ("best", "latest", 3, "12"):
        assert ckpt.resolve_checkpoint_name(tmp_path, which) == jax_resolve(tmp_path, which)
    assert ckpt.resolve_checkpoint_name(tmp_path, "best") == "checkpoint_12"
    (tmp_path / "checkpoint_best").write_bytes(b"")
    assert ckpt.resolve_checkpoint_name(tmp_path, "best") == jax_resolve(tmp_path) \
        == "checkpoint_best"
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_checkpoint_name(empty, "latest")


def test_jax_meta_tags_load_into_the_port_config(tmp_path):
    jcfg = JaxConfig(dataset="synthetic_memory", num_gens=3, h_dim=16, top_k_test=7,
                     l2_decay_rate=0.9, patch_interp="bilinear", max_peds=12)
    jw = JaxExperimentWriter(tmp_path, jcfg.experiment, "jax", version=4, config=jcfg,
                             tensorboard=False)
    pcfg = Config.from_dict(load_meta_tags(jw.dir / "meta_tags.csv"))
    want = jcfg.to_dict()
    for k, v in pcfg.to_dict().items():
        if k != "profile_dir":  # "" reads back as None in either package
            assert v == want[k], k
    # and the port's own writer: metrics files and a version with a checkpoint
    pw = ExperimentWriter(tmp_path / "port", "exp", "run", version=2, config=pcfg,
                          tensorboard=False)
    pw.log({"a": 1.0, "b": 2}, 1)
    pw.log({"a": 3.0, "b": 4}, 2)
    assert (pw.dir / "metrics.csv").read_text().splitlines() == ["epoch,a,b", "1,1.0,2.0",
                                                                  "2,3.0,4.0"]
    assert get_versions(pw.dir.parent) == []
    (pw.checkpoint_dir / "checkpoint_2").write_bytes(b"")
    assert get_versions(pw.dir.parent) == [(2, 2)]


def test_grad_norm_logger_drops_nan_and_writes_histograms():
    class Board:
        def __init__(self):
            self.calls = []

        def add_histogram(self, tag, values, step):
            self.calls.append((tag, values.tolist(), step))

    writer = type("Writer", (), {"_tb": Board()})()
    log = GradNormLogger()
    log.update_scalars("G/encoder", [1.5, float("nan"), 2.0])
    log.update_scalars("D/head", np.array([0.25]))
    log.write(writer, 3)
    assert writer._tb.calls == [("gradient_histograms/G/encoder", [1.5, 2.0], 3),
                                ("gradient_histograms/D/head", [0.25], 3)]
    assert not log.grad_norms
    log.write(object(), 4)  # a writer without TensorBoard
