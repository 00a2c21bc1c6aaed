"""The port's data-parallel train step and Trainer (``mggan_tpu_torch/parallel``)
against its single-device step and the JAX package's ``make_parallel_train_step``
(CPU, gloo ranks).

The ranks are processes of ``tests/_torch_dp_worker.py`` on one node,
joined through a ``file://`` store (no port to pick) with a timeout on the
rendezvous, on every collective and on every process. The same weights (the
port's init, moved into JAX through the reference state-dict format), the
same batch (numpy, seeded) and the same random numbers (replayed from the
JAX step's key, ``tests/test_torch_port_train.py::_jax_draws``) go through
every step. Tolerances are ``tests/test_parallel.py::assert_steps_match``'s:
metrics rtol 1e-5, Adam moments rtol 1e-4 / atol 1e-6 (the gradients), and
parameters within 2e-3 (Adam's first update moves a float-noise element by
about lr of a random sign).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data.loaders import get_dataloader as jax_get_dataloader
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models.torch_import import import_discriminator, import_generator
from mggan_tpu.parallel import dp as jax_dp
from mggan_tpu.parallel import mesh as jax_mesh
from mggan_tpu.training.state import init_train_state as jax_init_train_state

from _torch_dp_worker import launch
from test_torch_port_train import _jax_draws

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.models.torch_export import export_discriminator, export_generator
from mggan_tpu_torch.parallel import dp
from mggan_tpu_torch.parallel.mesh import make_mesh
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import build_train_step, make_draws
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items

torch.set_num_threads(1)

CFG = dict(dataset="synthetic_memory", batch_size=8, num_gens=2, num_samples=4, h_dim=16,
           decoder_h_dim=16, gan_type="mgan", weighting_target="ml")
# The step's other reduction sites, each against the single-device step:
# probgan's SGHMC noise losses (counted on one rank), W's gradient penalty
# (its double backward through the BatchNorm statistics' all-reduce),
# infogan's info term, the PM targets mgan (its n_valid), endpoint and l2,
# and an unrolled D step
FAMILIES = {"probgan": {"gan_type": "probgan"}, "W_gp": {"gan_obj": "W"},
            "infogan": {"gan_type": "infogan"}, "mgan_target": {"weighting_target": "mgan"},
            "endpoint_target": {"weighting_target": "endpoint"},
            "l2_target": {"weighting_target": "l2"},
            "unrolled": {"num_unrolling_steps": 1}}
# the scene CNN's conv biases feed train-mode BatchNorm: float-noise gradients
NOISE_LEAVES = {("scene", "conv1", "b"), ("scene", "conv2", "b")}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if torch.is_tensor(tree) else tree)


def _sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _port_state(state):
    """A port ``TrainState`` in the worker's result layout."""
    return {"g_params": _np_tree(state.g_params), "g_state": _np_tree(state.g_state),
            "d_params": _np_tree(state.d_params), "d_state": _np_tree(state.d_state),
            "g_mu": _np_tree(state.g_opt.mu), "g_nu": _np_tree(state.g_opt.nu),
            "d_mu": _np_tree(state.d_opt.mu), "d_nu": _np_tree(state.d_opt.nu)}


def _jax_state(state):
    """A JAX ``TrainState`` in the same layout (the Adam moments of the clip
    + AdamW chain)."""
    out = {k: _np_tree(jax.device_get(getattr(state, k)))
           for k in ("g_params", "g_state", "d_params", "d_state")}
    for name in ("g", "d"):
        adam = [s for s in jax.tree.leaves(getattr(state, f"{name}_opt"),
                                           is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")][0]
        out[f"{name}_mu"] = _np_tree(jax.device_get(adam.mu))
        out[f"{name}_nu"] = _np_tree(jax.device_get(adam.nu))
    return out


def _assert_steps_match(want, want_m, got, got_m, noise_atol=None):
    """``assert_steps_match``'s three levels on the worker's layout.
    ``noise_atol`` (tree -> bound) holds NOISE_LEAVES' parameters instead
    of 2e-3: their gradients are float noise (their moments hold them), and
    Adam moves each such element by up to lr, of a random sign, an update."""
    assert set(got_m) == set(want_m), sorted(set(got_m) ^ set(want_m))
    for k in sorted(want_m):
        np.testing.assert_allclose(got_m[k], float(want_m[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for name in ("g_mu", "g_nu", "d_mu", "d_nu"):
        flat = dict(tree_items(got[name]))
        for path, w in tree_items(want[name]):
            np.testing.assert_allclose(flat[path], w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {path}")
    for name in ("g_params", "d_params", "g_state", "d_state"):
        flat = dict(tree_items(got[name]))
        for path, w in tree_items(want[name]):
            bound = 2e-3
            if noise_atol and path in NOISE_LEAVES and name in noise_atol:
                bound = noise_atol[name]
            worst = float(np.abs(flat[path] - w).max())
            assert worst < bound, (name, path, worst, bound)


def _assert_ranks_equal(results):
    """Every rank's state equal to rank 0's bit for bit."""
    for r, res in enumerate(results[1:], 1):
        for name, tree in res["state"].items():
            if not isinstance(tree, dict):
                assert tree == results[0]["state"][name], (r, name)
                continue
            ref = dict(tree_items(results[0]["state"][name]))
            for path, x in tree_items(tree):
                assert np.array_equal(x, ref[path]), (r, name, path)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The port's DP steps (4 ranks: dp=4 on 8 scenes, dp=4 on 6 scenes,
    slices=2 x dp=2), its single-device steps, and JAX's dp=4 step on the
    8-device virtual mesh, from the same weights, batch and draws."""
    jcfg = JaxConfig(**CFG, dp=4)
    pcfg = Config(**CFG)
    g_pack, d_pack = factory.construct_gan(pcfg, seed=0, device="cpu")
    jg_spec, jd_spec = jax_factory.build_specs(jcfg)
    jg = import_generator(_sd(export_generator(g_pack[0], g_pack[1], g_pack[2])), jg_spec)
    jd = import_discriminator(_sd(export_discriminator(d_pack[0], d_pack[1], d_pack[2])),
                              jd_spec)
    jstate = jax_init_train_state(jcfg, (*jg, jg_spec), (*jd, jd_spec), jax.random.PRNGKey(1))

    loader = jax_get_dataloader(CFG["dataset"], "train", batch_size=8, shuffle=False)
    host = next(iter(loader))
    rng = np.random.RandomState(5)
    batch = {"xy": host["xy"], "ped_mask": host["ped_mask"],
             "patches": rng.uniform(-1, 1, host["xy"].shape[:2] + (33, 33, 4)).astype(
                 np.float32)}
    batch6 = {k: v[:6] for k, v in batch.items()}
    padded6 = dp.pad_scenes_to_multiple(batch6, 4)
    p = batch["ped_mask"].shape[1]
    draws = _jax_draws(jstate.rng, jcfg, 8, p)  # the JAX step's own, at the global shape

    mesh = jax_mesh.make_mesh(dp=4, gp=1)
    j8 = jax.tree.map(jnp.asarray, batch)
    pstep, pstate = jax_dp.make_parallel_train_step(jcfg, jg_spec, jd_spec, mesh, jstate, j8)
    pstate6 = jax.tree.map(lambda x: x.copy(), pstate)  # the step donates its state
    js8, jm8 = pstep(pstate, jax_dp.shard_batch(mesh, j8))
    js6, jm6 = pstep(pstate6, jax_dp.shard_batch(mesh, jax.tree.map(jnp.asarray, batch6)))

    def single_step(cfg, packs, b, draws):
        # init_train_state and the step build new trees: the packs are untouched
        state = init_train_state(cfg, *packs)
        s, m = build_train_step(cfg, packs[0][2], packs[1][2])(state, b, draws)
        return _port_state(s), {k: float(v) for k, v in m.items()}

    def step(cfg, packs, b, draws):
        weights = {"g_params": packs[0][0], "g_state": packs[0][1],
                   "d_params": packs[1][0], "d_state": packs[1][1]}
        return {"kind": "step", "config": {**CFG, **cfg}, "weights": weights, "batch": b,
                "draws": draws}

    packs = (g_pack, d_pack)
    single = {name: single_step(pcfg, packs, b, draws)
              for name, b in (("8", batch), ("6", padded6))}
    cases = [step({"dp": 4}, packs, batch, draws), step({"dp": 4}, packs, batch6, draws),
             step({"dp": 2, "slices": 2}, packs, batch, draws)]
    for i, (name, fam) in enumerate(FAMILIES.items()):
        fcfg = Config(**{**CFG, **fam})
        fpacks = factory.construct_gan(fcfg, seed=i + 1, device="cpu")
        fdraws = make_draws(torch.Generator().manual_seed(i + 11), fcfg, 8, p,
                            fpacks[0][0], fpacks[1][0])
        single[name] = single_step(fcfg, fpacks, batch, fdraws)
        cases.append(step({**fam, "dp": 4}, fpacks, batch, fdraws))
    # launched by hand on one host: the ranks find their node from the store
    ranks = launch(tmp_path_factory.mktemp("dp"), 4, cases)
    return {"ranks": ranks, "single": single,
            "jax": {"8": (_jax_state(js8), {k: float(v) for k, v in jm8.items()}),
                    "6": (_jax_state(js6), {k: float(v) for k, v in jm6.items()})}}


@pytest.mark.parametrize("case, batch", [(0, "8"), (1, "6"), (2, "8")],
                         ids=["dp4", "dp4_uneven_6_scenes", "slices2_dp2"])
def test_dp_step_matches_single_device_and_jax(steps, case, batch):
    """Each rank holds 2 scene rows (6 scenes pad to 8 with empty ones, as
    on both single-device sides); JAX's dp=4 step stands for the (2, 2)
    mesh too, as GSPMD computes one global step whatever the mesh."""
    results = [r[case] for r in steps["ranks"]]
    assert [r["rows"] for r in results] == [2, 2, 2, 2]
    _assert_ranks_equal(results)
    got, got_m = results[0]["state"], results[0]["metrics"]
    _assert_steps_match(*steps["single"][batch], got, got_m)
    _assert_steps_match(*steps["jax"][batch], got, got_m)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dp_step_matches_single_device_across_families(steps, family):
    """The DP=4 step of each family equals the port's single-device step on
    the same global batch and draws (the single-device step of each family
    is held to JAX's in tests/test_torch_port_train.py)."""
    results = [r[3 + list(FAMILIES).index(family)] for r in steps["ranks"]]
    assert [r["rows"] for r in results] == [2, 2, 2, 2]
    _assert_ranks_equal(results)
    _assert_steps_match(*steps["single"][family], results[0]["state"], results[0]["metrics"])


def test_manual_launch_places_ranks_by_host(steps):
    """Four processes launched by hand with no launcher env, on one host:
    one node of four local ranks, in process-id order."""
    for r, res in enumerate(steps["ranks"]):
        assert f"rank {r} of 4" in res[0]["grid"]
        assert f"node 0 of 1, local rank {r} of 4, cpu, backend gloo" in res[0]["grid"]


def test_dp_trainer_epoch_matches_single_device(tmp_path):
    """A dp=2 ``Trainer`` epoch (train-time augmentation, the patch bank,
    validation through ``allreduce_sums``) equals the single-device
    ``Trainer``'s: the CSV's metrics (1e-4), ``best_val`` and the
    parameters (1e-4; the float-noise conv biases 2 * lr per update); both
    ranks agree bit for bit and write one version dir."""
    import csv

    cfg = dict(CFG, batch_size=4, epochs=1, top_k_test=3, augment=1, patch_bank=1)
    single = Config(**cfg, log_dir=str(tmp_path / "single"))
    writer = ExperimentWriter(single.log_dir, single.experiment, single.name, version=1,
                              config=single, tensorboard=False)
    want = Trainer(single, writer, device="cpu").train()
    ranks = launch(tmp_path / "ranks", 2, [{"kind": "trainer", "config": {
        **cfg, "dp": 2, "log_dir": str(tmp_path / "dp")}}])
    results = [r[0] for r in ranks]
    _assert_ranks_equal(results)
    assert results[0]["dir"] == results[1]["dir"]
    assert glob.glob(str(tmp_path / "dp" / "*" / "*" / "version_*")) == [results[0]["dir"]]
    rows = lambda d: list(csv.DictReader(open(f"{d}/metrics.csv")))
    (a,), (b,) = rows(writer.dir), rows(results[0]["dir"])
    keys = [k for k in a if not k.startswith("perf/")]
    assert keys == [k for k in b if not k.startswith("perf/")]
    for k in keys:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert results[0]["state"]["step"] == want.state.step == 12
    np.testing.assert_allclose(results[0]["state"]["best_val"], want.state.best_val,
                               rtol=1e-4)
    updates = {"g": 2 * want.state.step, "d": want.state.step}
    for name in ("g_params", "d_params"):
        lr = single.g_lr if name[0] == "g" else single.d_lr
        flat = dict(tree_items(results[0]["state"][name]))
        for path, w in tree_items(_np_tree(getattr(want.state, name))):
            atol = 2 * lr * updates[name[0]] + 1e-4 if path in NOISE_LEAVES else 1e-4
            np.testing.assert_allclose(flat[path], w, atol=atol, rtol=0,
                                       err_msg=f"{name} {path}")
    assert (tmp_path / results[0]["dir"] / "checkpoints" / "checkpoint_best").is_file()


@pytest.mark.parametrize("kw, err, match", [
    ({"gp": 2}, RuntimeError, "--nproc_per_node 2 .*--gp 2"),
    ({"dp": 2, "gp": 2}, RuntimeError, "--nproc_per_node 4 .*--gp 2"),
    ({"dp": 2, "split_step": 1}, ValueError, "mutually exclusive"),
    ({"dp": 2}, RuntimeError, "torch.distributed.run --nproc_per_node 2"),
    ({"dp": 2, "slices": 2}, RuntimeError, "--nproc_per_node 4"),
])
def test_what_raises_outside_a_pod(tmp_path, kw, err, match):
    """``split_step`` beside dp raises (as in JAX); so does ``dp`` or ``gp``
    above 1 without a pod, naming the launch (tests/test_torch_port_gp.py
    runs gp in one)."""
    cfg = Config(num_gens=2, h_dim=8, decoder_h_dim=8, **kw)
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=1,
                              tensorboard=False)
    with pytest.raises(err, match=match):
        Trainer(cfg, writer, device="cpu")
    if kw.get("gp"):
        with pytest.raises(RuntimeError, match=f"--gp {kw['gp']}"):
            make_mesh(1, kw["gp"], device="cpu")
