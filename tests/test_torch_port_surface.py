"""The host-side surface against the JAX package (CPU): the trajectory
tools, the manifold's polygons and plots, ``viz``, ``cli.sweep``'s version
dirs and the Trainer's profiler capture.

The trajectory tools, ``get_polygons`` and every plot run on the same
numpy inputs (``make_synthetic_dataset``, seeded) in both packages and
must agree exactly: they are the same host numpy and matplotlib code.
shapely is not installed here, so ``get_polygons`` takes the branch
without a union in both. The plots draw under matplotlib's Agg backend and
are compared line by line (each ``Line2D``'s data). The JAX sweep runs with
its ``Trainer`` replaced by a stub, as only its naming is compared.
"""

import json

import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import record_function

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mggan_tpu import viz as jax_viz  # noqa: E402
from mggan_tpu.cli import sweep as jax_sweep  # noqa: E402
from mggan_tpu.data.synthetic import make_synthetic_dataset as jax_make_dataset  # noqa: E402
from mggan_tpu.eval.manifold import Manifold as JaxManifold  # noqa: E402
from mggan_tpu.utils import trajectory_tools as jax_tt  # noqa: E402

from mggan_tpu_torch import viz  # noqa: E402
from mggan_tpu_torch.cli import sweep  # noqa: E402
from mggan_tpu_torch.config import Config  # noqa: E402
from mggan_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from mggan_tpu_torch.eval.manifold import Manifold  # noqa: E402
from mggan_tpu_torch.training.loop import Trainer  # noqa: E402
from mggan_tpu_torch.utils import profiling, trajectory_tools  # noqa: E402
from mggan_tpu_torch.utils.logging import ExperimentWriter  # noqa: E402

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)


def _datasets(**kw):
    """The same synthetic dataset from both packages, with ped ids that
    repeat across windows (the mining's one-trajectory-per-ped branch)."""
    args = dict(num_windows=16, max_peds=5, seed=3, **kw)
    ds, jds = make_synthetic_dataset(**args), jax_make_dataset(**args)
    for d in (ds, jds):
        d.ped_ids = [np.arange(len(t)) % 3 for t in d.trajectories]
    for a, b in zip(ds.trajectories, jds.trajectories):
        np.testing.assert_array_equal(a, b)
    return ds, jds


def test_get_traj_4d_equals_jax():
    ds, _ = _datasets()
    obs, pred = ds.obs_traj, ds.pred_traj
    for args in ((obs,), (obs, pred)):
        got, want = trajectory_tools.get_traj_4d(*args), jax_tt.get_traj_4d(*args)
        assert len(got) == len(want) == 2 * len(args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filter_hist_colliding", [False, True])
def test_get_similar_trajectories_equals_jax(filter_hist_colliding):
    ds, jds = _datasets(nan_future_frac=0.1)
    kw = dict(distance_threshold=3.0, direction_threshold=0.0, speed_threshold=4.0,
              radius=3.0, filter_hist_colliding=filter_hist_colliding)
    got = trajectory_tools.get_similar_trajectories(ds, **kw)
    want = jax_tt.get_similar_trajectories(jds, **kw)
    assert list(got) == list(want) and len(got) > 10
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert any(len(v) > 1 for v in got.values())
    if filter_hist_colliding:
        unfiltered = trajectory_tools.get_similar_trajectories(
            ds, **{**kw, "filter_hist_colliding": False})
        assert sum(map(len, got.values())) < sum(map(len, unfiltered.values()))


def test_pandas_to_latex_equals_jax():
    cols = pd.MultiIndex.from_product([["ADE", "FDE"], ["k=1", "k=20"]])
    df = pd.DataFrame(np.arange(8.0).reshape(2, 4) / 3, index=["eth", "hotel"], columns=cols)
    for kw in (dict(multicolumn=True, float_format="%.2f"), dict(multicolumn=False)):
        got = trajectory_tools.pandas_to_latex(df, **kw)
        assert got == jax_tt.pandas_to_latex(df, **kw)
    # the reference's rule spans columns start + 2 .. end + 1 (utils.py:251-273)
    assert "\\cmidrule(l){1-2} \\cmidrule(l){3-4}" in trajectory_tools.pandas_to_latex(
        df, multicolumn=True)


def _construct(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 12, 2) * 0.5).cumsum(1).astype(np.float32)


def test_get_polygons_equals_jax():
    data = _construct()
    m, jm = Manifold(data, 1.5), JaxManifold(data, 1.5)
    for time in (11, [3, 11]):
        got, want = m.get_polygons(time), jm.get_polygons(time)
        n_times = len(time) if isinstance(time, list) else 1
        assert len(got) == len(want) == n_times * len(data)  # no union without shapely
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _lines(ax):
    return [np.asarray(line.get_xydata()) for line in ax.lines]


def _same_drawing(ax_a, ax_b):
    la, lb = _lines(ax_a), _lines(ax_b)
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    assert len(ax_a.patches) == len(ax_b.patches)
    assert len(ax_a.collections) == len(ax_b.collections)


@pytest.mark.parametrize("border_only", [False, True])
def test_plot_manifold_draws_as_jax(border_only):
    data = _construct(1)
    axes = []
    for cls in (Manifold, JaxManifold):
        _, ax = plt.subplots()
        cls(data, 1.0).plot_manifold([5, 11] if border_only else 11, axes=ax,
                                     border_only=border_only)
        axes.append(ax)
    a, b = axes
    # two polygons (border, fill) per circle and step, or one circle a trajectory
    assert len(a.patches) == len(b.patches) == len(data) * (4 if border_only else 1)
    for pa, pb in zip(a.patches, b.patches):
        assert type(pa) is type(pb)
        np.testing.assert_array_equal(pa.get_verts(), pb.get_verts())
    assert len(a.collections) == len(b.collections) == (0 if border_only else len(data))
    plt.close("all")


def test_every_viz_function_draws_as_jax():
    """Each of ``viz``'s functions on numpy inputs draws the JAX package's
    lines; tensors give the same drawing as numpy."""
    ds, jds = _datasets()
    rng = np.random.RandomState(0)
    traj = ds.trajectories[0]
    p = len(traj)
    preds = (traj[:, None, 8:] + rng.randn(p, 3, 12, 2) * 0.2).astype(np.float32)
    idxs = rng.randint(0, 4, (p, 3))
    batch = {"xy": np.stack([traj]), "ped_mask": np.ones((1, p), bool)}
    img = rng.uniform(-1, 1, (33, 33, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.re_im(torch.from_numpy(img)), jax_viz.re_im(img))
    man = (Manifold(traj[:, 8:], 1.0), JaxManifold(traj[:, 8:], 1.0))
    calls = [
        lambda v, d, m, t: v.plot_trajectories(t(traj[0, :8]), t(traj[0, 8:]), t(preds[0]),
                                               t(idxs[0]), ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_trajectories(traj[0, :8], scene_img=ds.images[
            ds.scene_names[0]]["small"], px_per_meter=2.0, ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_trajectories_by_idxs(traj[1, :8], traj[1, 8:], preds[1],
                                                       idxs[1], ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_scene(batch, 0, t(preds.transpose(1, 0, 2, 3)), idxs[0],
                                        ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_trajectories_by_idxs_img(
            t(traj[0, :8]), traj[0, 8:], t(preds[0]), idxs[0], img=t(img), scale=2.0,
            ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_trajectories_by_idxs_scene(d, 0, preds, idxs,
                                                             ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_manifold_with_preds(m, t(preds[0]), obs=traj[0, :8],
                                                      ax=plt.subplots()[1]),
        lambda v, d, m, t: v.plot_scene_window(d, 0, ax=plt.subplots()[1]),
    ]
    as_np, as_tensor = (lambda a: a), (lambda a: torch.from_numpy(np.asarray(a)))
    for i, call in enumerate(calls):
        want = call(jax_viz, jds, man[1], as_np)
        for t in (as_np, as_tensor):
            _same_drawing(call(viz, ds, man[0], t), want)
        plt.close("all")
    with pytest.raises(ValueError, match="not a valid image_type"):
        viz.plot_scene_window(ds, 0, image_type="tiny")
    plt.close("all")


def test_sweep_names_version_dirs_as_jax(tmp_path, monkeypatch):
    """The port's sweep trains each point (2 points of 1 epoch on the CPU;
    the config and metrics of each in its version dir); the JAX sweep, its
    Trainer stubbed, makes the same ``<name>_<flag>=<value>`` dirs."""
    grid = json.dumps({"num_gens": [2, 1], "gan_obj": ["LS"]})
    args = ["--grid", grid, "--name", "sw", "--dataset", "synthetic_memory", "--epochs",
            "1", "--batch_size", "24", "--h_dim", "8", "--decoder_h_dim", "8",
            "--num_samples", "2", "--top_k_test", "2"]
    trainers = sweep.main(args + ["--log_dir", str(tmp_path / "port"), "--device", "cpu"])

    class Stub:
        def __init__(self, cfg, writer):
            self.cfg = cfg

        def train(self):
            return self

    monkeypatch.setattr(jax_sweep, "Trainer", Stub)
    jax_sweep.main(args + ["--log_dir", str(tmp_path / "jax")])
    names = lambda root: sorted(p.name for p in (root / "multi_generator").iterdir())
    assert names(tmp_path / "port") == names(tmp_path / "jax") == \
        ["sw_gan_obj=LS_num_gens=1", "sw_gan_obj=LS_num_gens=2"]
    assert [t.config.name for t in trainers] == ["sw_gan_obj=LS_num_gens=2",
                                                  "sw_gan_obj=LS_num_gens=1"]
    for t in trainers:
        (vdir,) = (tmp_path / "port" / "multi_generator" / t.config.name).iterdir()
        (line,) = (vdir / "metrics.jsonl").read_text().splitlines()
        assert np.isfinite(json.loads(line)["train/gen_loss"])
        assert t.config.gan_obj == "LS" and t.state.step == 2


def test_trainer_profile_dir_writes_one_trace(tmp_path):
    """``profile_dir``: the second step of the first epoch traced into a
    Chrome trace with the step's ops, and only that step; a region named
    with ``record_function`` inside ``profiling.trace``."""
    prof = tmp_path / "prof"
    cfg = Config(dataset="synthetic_memory", num_gens=2, h_dim=8, decoder_h_dim=8,
                 num_samples=2, batch_size=16, epochs=2, top_k_test=2, val_every=2,
                 profile_dir=str(prof), log_dir=str(tmp_path))
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=0, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu")
    calls = []
    step = tr.train_step
    tr.train_step = lambda *a: calls.append(torch.autograd.profiler._is_profiler_enabled) \
        or step(*a)
    tr.train()
    assert tr.state.step == 6 and calls == [False, True, False, False, False, False]
    (trace,) = prof.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"aten::conv2d", "aten::bmm", "DecodeAll"} <= names

    with profiling.trace(tmp_path / "p2") as p, record_function("region"):
        torch.ones(2).sum()
    names = {e.get("name") for e in json.loads(p.trace_path.read_text())["traceEvents"]}
    assert "region" in names
