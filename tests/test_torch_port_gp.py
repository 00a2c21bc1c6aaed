"""The port's generator-parallel train step and Trainer (``mggan_tpu_torch/parallel``,
``gp > 1``) against its single-device step and the JAX package's
``make_parallel_train_step`` on the (slice=2, data=2, model=2) mesh (CPU,
gloo ranks).

The ranks are processes of ``tests/_torch_dp_worker.py`` on one node,
joined through a ``file://`` store. Each rank of a model group holds
``num_gens / gp`` of the stacked decoders and their Adam moments; the
state compared is the one ``parallel/dp.py::gather_generators`` joins. The
same weights (the port's init, moved into JAX through the reference
state-dict format), the same batch and JAX's replayed draws go through
every step, at ``tests/test_parallel.py::setup(num_gens=4)``'s widths; the
families at ``tests/test_torch_port_dp.py``'s (two generators, one a
rank). Tolerances are ``tests/test_parallel.py::assert_steps_match``'s
(``test_torch_port_dp._assert_steps_match``).
"""

import csv
import glob
from pathlib import Path

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
from test_torch_port_dp import (
    CFG as FAMILY_CFG, FAMILIES, NOISE_LEAVES, _assert_steps_match, _jax_state,
    _port_state, _sd,
)
from test_torch_port_train import _jax_draws

from mggan_tpu_torch.cli import convert
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.models.torch_export import export_discriminator, export_generator
from mggan_tpu_torch.parallel import pod
from mggan_tpu_torch.parallel.mesh import Grid, make_mesh
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import build_train_step, make_draws
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items

torch.set_num_threads(1)

# tests/test_parallel.py::setup(num_gens=4)
CFG = dict(dataset="synthetic_memory", batch_size=8, num_gens=4, num_samples=4, h_dim=16,
           decoder_h_dim=16, gan_type="mgan", weighting_target="ml")
GRIDS = {"dp2_gp2": {"dp": 2, "gp": 2}, "dp1_gp4": {"dp": 1, "gp": 4}}
# each gp=2 family beside tests/test_torch_port_dp.py's, and the discrete G,
# whose one decoder is replicated
GP_FAMILIES = {**FAMILIES, "discrete": {"experiment": "discrete"}}
# NOISE_LEAVES' parameters, whose gradients are float noise (their moments
# are held to the full tolerance): up to lr an Adam update, of a random
# sign, on top of 2e-3 (tests/test_torch_port_pod.py's bound; G updates twice
# a step)
_lr = Config()
NOISE_ATOL = {"g_params": 2 * 2 * _lr.g_lr + 2e-3, "d_params": 2 * _lr.d_lr + 2e-3}


def _batch():
    loader = jax_get_dataloader(CFG["dataset"], "train", batch_size=8, shuffle=False)
    host = next(iter(loader))
    rng = np.random.RandomState(5)
    return {"xy": host["xy"], "ped_mask": host["ped_mask"],
            "patches": rng.uniform(-1, 1, host["xy"].shape[:2] + (33, 33, 4)).astype(
                np.float32)}


def _single_step(cfg, packs, batch, draws):
    # init_train_state and the step build new trees: the packs are untouched
    state = init_train_state(cfg, *packs)
    s, m = build_train_step(cfg, packs[0][2], packs[1][2])(state, batch, draws)
    return _port_state(s), {k: float(v) for k, v in m.items()}


def _case(cfg, packs, batch, draws):
    weights = {"g_params": packs[0][0], "g_state": packs[0][1],
               "d_params": packs[1][0], "d_state": packs[1][1]}
    return {"kind": "step", "config": cfg, "weights": weights, "batch": batch, "draws": draws}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's step on the (2, 2, 2) mesh, the port's single-device steps and
    its generator-parallel steps: (dp=2, gp=2), (dp=1, gp=4), the gp=2
    families and the data-rank sums on 4 ranks, (slices=2, dp=2, gp=2) on
    8 ranks."""
    jcfg = JaxConfig(**CFG, dp=2, gp=2, slices=2)
    pcfg = Config(**CFG)
    g_pack, d_pack = factory.construct_gan(pcfg, seed=0, device="cpu")
    jg_spec, jd_spec = jax_factory.build_specs(jcfg)
    jg = import_generator(_sd(export_generator(g_pack[0], g_pack[1], g_pack[2])), jg_spec)
    jd = import_discriminator(_sd(export_discriminator(d_pack[0], d_pack[1], d_pack[2])),
                              jd_spec)
    jstate = jax_init_train_state(jcfg, (*jg, jg_spec), (*jd, jd_spec), jax.random.PRNGKey(1))
    batch = _batch()
    p = batch["ped_mask"].shape[1]
    draws = _jax_draws(jstate.rng, jcfg, 8, p)  # the JAX step's own, at the global shape

    mesh = jax_mesh.make_mesh(dp=2, gp=2, slices=2)
    j8 = jax.tree.map(jnp.asarray, batch)
    pstep, pstate = jax_dp.make_parallel_train_step(jcfg, jg_spec, jd_spec, mesh, jstate, j8)
    js, jm = pstep(pstate, jax_dp.shard_batch(mesh, j8))

    packs = (g_pack, d_pack)
    single = {"mgan": _single_step(pcfg, packs, batch, draws)}
    cases = [_case({**CFG, **grid}, packs, batch, draws) for grid in GRIDS.values()]
    for i, (name, fam) in enumerate(GP_FAMILIES.items()):
        fcfg = Config(**{**FAMILY_CFG, **fam})
        fpacks = factory.construct_gan(fcfg, seed=i + 1, device="cpu")
        fdraws = make_draws(torch.Generator().manual_seed(i + 11), fcfg, 8, p,
                            fpacks[0][0], fpacks[1][0])
        single[name] = _single_step(fcfg, fpacks, batch, fdraws)
        cases.append(_case({**FAMILY_CFG, **fam, "dp": 2, "gp": 2}, fpacks, batch, fdraws))
    cases.append({"kind": "sums", "config": {**CFG, "dp": 2, "gp": 2}})
    four = launch(tmp_path_factory.mktemp("gp4"), 4, cases)
    eight = launch(tmp_path_factory.mktemp("gp8"), 8,
                   [_case({**CFG, "dp": 2, "gp": 2, "slices": 2}, packs, batch, draws)])
    return {"four": four, "eight": eight, "single": single,
            "jax": (_jax_state(js), {k: float(v) for k, v in jm.items()})}


def _assert_replicated(results, gp):
    """Every leaf but the decoder slices equal on every rank bit for bit,
    each decoder slice equal on the ranks of its model index, and the
    gathered state equal everywhere."""
    for r, res in enumerate(results):
        for key in ("state", "local"):
            for name, tree in res[key].items():
                if not isinstance(tree, dict):
                    assert tree == results[0][key][name], (r, name)
                    continue
                ref = dict(tree_items(results[r % gp if key == "local" else 0][key][name]))
                for path, x in tree_items(tree):
                    assert np.array_equal(x, ref[path]), (r, key, name, path)


def _assert_sliced(results, gp, num_gens):
    """Each rank holds its ``num_gens / gp`` generators of the gathered
    state's decoders and moments, and every other leaf whole."""
    n = num_gens // gp
    for r, res in enumerate(results):
        m = r % gp
        for name in ("g_params", "g_mu", "g_nu"):
            whole = dict(tree_items(res["state"][name]))
            for path, x in tree_items(res["local"][name]):
                want = whole[path][m * n:(m + 1) * n] if path[0] == "decoders" else whole[path]
                assert np.array_equal(x, want), (r, name, path)


@pytest.mark.parametrize("grid", list(GRIDS) + ["slices2_dp2_gp2"])
def test_gp_step_matches_single_device_and_jax(steps, grid):
    """The gathered state and the metrics of each grid against the port's
    single-device step and JAX's (2, 2, 2) step (GSPMD computes one global
    step whatever the mesh); each data rank's model ranks hold its scene
    rows, each its generators."""
    if grid in GRIDS:
        results = [r[list(GRIDS).index(grid)] for r in steps["four"]]
        gp, dp_ = GRIDS[grid]["gp"], GRIDS[grid]["dp"]
    else:
        results, gp, dp_ = [r[0] for r in steps["eight"]], 2, 4
    assert [r["rows"] for r in results] == [8 // dp_] * len(results)
    for r, res in enumerate(results):
        assert f"rank {r // gp} of {dp_}" in res["grid"]
        assert f"model rank {r % gp} of {gp}, node 0 of 1, local rank {r}" in res["grid"]
    _assert_replicated(results, gp)
    _assert_sliced(results, gp, CFG["num_gens"])
    got, got_m = results[0]["state"], results[0]["metrics"]
    _assert_steps_match(*steps["single"]["mgan"], got, got_m, NOISE_ATOL)
    _assert_steps_match(*steps["jax"], got, got_m, NOISE_ATOL)


@pytest.mark.parametrize("family", list(GP_FAMILIES))
def test_gp_step_matches_single_device_across_families(steps, family):
    """The (dp=2, gp=2) step of each family, one generator a rank, equals
    the port's single-device step on the same batch and draws: probgan's
    decoder normals sliced, W's penalty, infogan, the mgan and l2 targets,
    an unrolled D, and the discrete G replicated whole on every rank."""
    results = [r[len(GRIDS) + list(GP_FAMILIES).index(family)] for r in steps["four"]]
    _assert_replicated(results, 1 if family == "discrete" else 2)
    if family == "discrete":
        assert "decoders" not in results[0]["local"]["g_params"]
    else:
        _assert_sliced(results, 2, FAMILY_CFG["num_gens"])
    _assert_steps_match(*steps["single"][family], results[0]["state"], results[0]["metrics"],
                        NOISE_ATOL)


def test_allreduce_sums_counts_each_data_rank_once(steps):
    """``allreduce_sums`` over ``grid.host_group`` on (dp=2, gp=2): the two
    data ranks' pairs once each, not once per model rank."""
    want = {"ADE k=3": (3.0, 4.0), "FDE k=3": (20.0, 2.0)}
    assert [r[-1]["reduced"] for r in steps["four"]] == [want] * 4


def test_gp_trainer_epoch_saves_the_single_device_layout(tmp_path):
    """A (dp=1, gp=2) ``Trainer`` epoch (augmentation, the patch bank,
    validation) equals the single-device ``Trainer``'s: the CSV's metrics
    (1e-4), ``best_val`` and the parameters. Its checkpoint holds the
    gathered state: it loads on one device outside the pod, key for key
    the single-device layout, and in the pod each rank takes its slice
    again."""
    cfg = dict(FAMILY_CFG, batch_size=4, epochs=1, top_k_test=3, augment=1, patch_bank=1)
    single = Config(**cfg, log_dir=str(tmp_path / "single"))
    writer = ExperimentWriter(single.log_dir, single.experiment, single.name, version=1,
                              config=single, tensorboard=False)
    want = Trainer(single, writer, device="cpu").train()
    ranks = launch(tmp_path / "ranks", 2, [{"kind": "gp_trainer", "config": {
        **cfg, "gp": 2, "log_dir": str(tmp_path / "gp")}}])
    results = [r[0] for r in ranks]
    assert results[0]["dir"] == results[1]["dir"]
    vdir = results[0]["dir"]
    assert glob.glob(str(tmp_path / "gp" / "*" / "*" / "version_*")) == [vdir]
    rows = lambda d: list(csv.DictReader(open(f"{d}/metrics.csv")))
    (a,), (b,) = rows(writer.dir), rows(vdir)
    keys = [k for k in a if not k.startswith("perf/")]
    assert keys == [k for k in b if not k.startswith("perf/")]
    for k in keys:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-4, atol=1e-4, err_msg=k)

    loaded, _ = Trainer.load_from_path(vdir, device="cpu")
    assert not pod.is_initialized() and not loaded.grid.active
    assert loaded.state.step == want.state.step == 12
    np.testing.assert_allclose(loaded.state.best_val, want.state.best_val, rtol=1e-4)
    got = _port_state(loaded.state)
    want_s = _port_state(want.state)
    for name, tree in want_s.items():
        assert [(p, x.shape) for p, x in tree_items(tree)] == \
            [(p, x.shape) for p, x in tree_items(got[name])], name
    updates = {"g": 2 * want.state.step, "d": want.state.step}
    for name in ("g_params", "d_params"):
        lr = single.g_lr if name[0] == "g" else single.d_lr
        flat = dict(tree_items(got[name]))
        for path, w in tree_items(want_s[name]):
            atol = 2 * lr * updates[name[0]] + 1e-4 if path in NOISE_LEAVES else 1e-4
            np.testing.assert_allclose(flat[path], w, atol=atol, rtol=0,
                                       err_msg=f"{name} {path}")
    # the file is the single-device Trainer's: the same blob, and the
    # reference-format writer takes it
    blob = lambda d: torch.load(f"{d}/checkpoints/checkpoint_best", weights_only=True)
    assert sorted(blob(vdir)) == sorted(blob(writer.dir))
    ref = convert.main(["--reverse", "--version_dir", vdir, "--out_dir",
                        str(tmp_path / "ref"), "--device", "cpu"])
    assert (Path(ref) / "checkpoints" / "checkpoint_best.pth").is_file()
    # the ranks ended with the file's state, each its slice; resumed, each
    # rank takes its slice of the file again
    for r, res in enumerate(results):
        assert res["epoch"] == 1
        for key in ("local", "resumed"):
            for name in ("g_params", "g_mu", "g_nu", "d_params", "d_mu"):
                flat = dict(tree_items(got[name]))
                for path, x in tree_items(res[key][name]):
                    whole = flat[path]
                    want_x = whole[r:r + 1] if path[0] == "decoders" else whole
                    assert np.array_equal(x, want_x), (r, key, name, path)


@pytest.mark.parametrize("kw, err, match", [
    ({"num_gens": 3, "gp": 2}, ValueError, "does not split over gp=2"),
    ({"gp": 2, "split_step": 1}, ValueError, "mutually exclusive"),
    ({"gp": 2}, RuntimeError, "--nproc_per_node 2 .*--gp 2"),
    ({"dp": 2, "gp": 2, "slices": 2}, RuntimeError, "--nproc_per_node 8 .*--gp 2 --slices 2"),
])
def test_what_raises_under_gp(tmp_path, kw, err, match):
    """A stack that ``gp`` does not split, ``--split_step`` beside ``--gp``
    (as in JAX) and ``gp > 1`` without a pod, naming the launch."""
    cfg = Config(**{"num_gens": 2, "h_dim": 8, "decoder_h_dim": 8, **kw})
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=1,
                              tensorboard=False)
    with pytest.raises(err, match=match):
        Trainer(cfg, writer, device="cpu")


def test_make_mesh_keeps_a_model_group_on_one_node(monkeypatch):
    """Four ranks as four nodes of one rank each cannot hold model groups of
    two: ``make_mesh`` raises before it makes a group; a grid's generator
    slice raises for a stack ``gp`` does not split."""
    for name, value in (("is_initialized", True), ("world_size", 4), ("process_count", 4),
                        ("local_world_size", 1)):
        monkeypatch.setattr(pod, name, lambda value=value: value)
    with pytest.raises(ValueError, match="model group must live on one node"):
        make_mesh(2, 2, device="cpu")
    grid = Grid(1, 1, 2, rank=0, node=0, nodes=1, local_rank=1, local_world=2,
                device=torch.device("cpu"), backend="gloo", model_rank=1)
    assert grid.gen_slice(4) == slice(2, 4) and grid.gens_per_rank(4) == 2
    with pytest.raises(ValueError, match="num_gens=3 does not split over gp=2"):
        grid.gen_slice(3)

