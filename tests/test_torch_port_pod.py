"""The port on a pod of 2 nodes x 1 rank (CPU, gloo): per-node window
shards in lockstep, the shard-local patch bank, ``allreduce_sums`` and a
``Trainer`` epoch, against the JAX package's ``data/elastic.py`` and
``tests/_pod_worker.py``'s sums; and a pod step of 2 nodes x 2 ranks
against the single-device step on the nodes' batches laid end to end.

Each rank is a process of ``tests/_torch_dp_worker.py`` joined with the
explicit pod flags' path (``pod.init_distributed(address, world, rank)``)
through a ``file://`` store, so no port is picked and no coordinator can be
lost; the nodes are simulated on this host by ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE``, as ``torch.distributed.run`` sets them. Every
collective and every process has a timeout.
"""

import glob

import numpy as np
import pytest
import torch

from mggan_tpu.data import elastic as jax_elastic
from mggan_tpu.data.loaders import get_dataloader as jax_get_dataloader

from _torch_dp_worker import launch

from test_torch_port_dp import _assert_steps_match, _port_state

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.eval.metrics import allreduce_sums
from mggan_tpu_torch.parallel import mesh, pod
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter
from mggan_tpu_torch.utils.pytree import tree_items

torch.set_num_threads(1)

BATCH = 4
TRAINER = dict(dataset="synthetic_memory", batch_size=BATCH, num_gens=2, epochs=1,
               num_samples=4, h_dim=8, decoder_h_dim=8, top_k_test=3, gan_type="mgan",
               weighting_target="ml", dp=2, augment=1, patch_bank=1)
# One step a node: 48 train windows, 24 on each of 2 nodes, 12 on each rank
NODES, LOCAL, NODE_BATCH = 2, 2, 24
EPOCH = dict(TRAINER, batch_size=NODE_BATCH)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    return launch(tmp, 2, [{"kind": "pod", "batch_size": BATCH}, {"kind": "mismatch"},
                           {"kind": "trainer", "config": {**TRAINER,
                                                          "log_dir": str(tmp / "logs")}}],
                  local_world=1), tmp


def test_elastic_counts_and_shards_agree_with_jax(nodes):
    """Both nodes run the lockstep count and pad to the split's widest
    scene; each node's batches hold the windows JAX's sharded loader gives
    that process."""
    results = [r[0] for r in nodes[0]]
    total = len(jax_get_dataloader("synthetic_memory", "train").ds)
    steps = jax_elastic.lockstep_batches(total, 2, BATCH)
    for pid, res in enumerate(results):
        assert res["process"] == (pid, 2)
        assert res["num_batches"] == res["batches"] == steps
        theirs = jax_get_dataloader("synthetic_memory", "train", batch_size=BATCH,
                                    shard_by_process=True, process_index=pid,
                                    process_count=2)
        assert res["max_peds"] == theirs.max_peds
        assert res["windows"] == [b["window_idx"].tolist() for b in theirs]
        assert res["n_windows"] == len(theirs.ds)
    assert sum(r["n_windows"] for r in results) == total


def test_shard_local_bank_equals_host_assembly(nodes):
    results = [r[0] for r in nodes[0]]
    assert all(r["bank_equal"] for r in results)
    assert all(r["bank_sum"] > 0 for r in results)


def test_allreduce_sums_over_the_pod_and_alone(nodes):
    """The sums ``tests/_pod_worker.py`` sets up, on every node; the
    identity outside a pod; mismatched key sets raise on every node instead
    of hanging (the launch's timeout bounds the wait)."""
    want = {"ADE k=3": (3.0, 4.0), "FDE k=3": (20.0, 2.0)}
    for res in nodes[0]:
        assert res[0]["reduced"] == want
        assert "key sets differ" in res[1]["raised"]
    alone = {"ADE k=3": (1.0, 2.0)}
    assert not pod.is_initialized()
    assert allreduce_sums(alone) == alone
    assert mesh.make_mesh(1, device="cpu").active is False


def test_pod_trainer_epoch(nodes):
    """A dp=2 ``Trainer`` over 2 nodes, each on its window shard: both end
    with the same state bit for bit, in one version dir with its
    checkpoints."""
    (_, _, a), (_, _, b) = nodes[0]
    assert "node 0 of 2" in a["grid"] and "node 1 of 2" in b["grid"]
    assert a["dir"] == b["dir"]
    assert glob.glob(str(nodes[1] / "logs" / "*" / "*" / "version_*")) == [a["dir"]]
    for name, tree in a["state"].items():
        if isinstance(tree, dict):
            other = dict(tree_items(b["state"][name]))
            assert all(np.array_equal(x, other[p]) for p, x in tree_items(tree)), name
        else:
            assert tree == b["state"][name], name
    assert a["state"]["step"] == 6  # 24 windows a node, 4 a batch
    assert np.isfinite(a["state"]["best_val"])
    assert glob.glob(a["dir"] + "/checkpoints/checkpoint_best")


@pytest.fixture(scope="module")
def pod_epoch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod_epoch")
    return launch(tmp, NODES * LOCAL, [{"kind": "epoch", "config": {
        **EPOCH, "dp": NODES * LOCAL, "log_dir": str(tmp / "logs")}}], local_world=LOCAL), tmp


def test_pod_step_equals_the_single_device_step_on_the_joined_batch(pod_epoch):
    """A ``Trainer`` epoch of one step on 2 nodes x 2 ranks equals the
    single-device step on the nodes' first batches laid end to end (JAX's
    sharded loader, node by node), each node's rows augmented with the
    same draws, as every JAX process folds the same key, and the step's
    draws at the global shape: ``assert_steps_match``'s tolerances (the
    conv biases before train-mode BatchNorm, whose gradients are float
    noise, by Adam's update bound), the agents summed over the ranks, every
    rank bit for bit alike."""
    ranks, tmp = pod_epoch
    results = [r[0] for r in ranks]
    for r, res in enumerate(results):
        assert f"node {r // LOCAL} of {NODES}, local rank {r % LOCAL} of {LOCAL}" in res["grid"]
        assert res["steps"] == 1
    for res in results[1:]:
        for name, tree in res["state"].items():
            if isinstance(tree, dict):
                ref = dict(tree_items(results[0]["state"][name]))
                assert all(np.array_equal(x, ref[p]) for p, x in tree_items(tree)), name

    cfg = Config(**{**EPOCH, "dp": 1}, log_dir=str(tmp / "single"))
    writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, version=1, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu")
    nodes = []
    for n in range(NODES):
        loader = jax_get_dataloader("synthetic_memory", "train", batch_size=NODE_BATCH,
                                    shuffle=True, seed=cfg.seed, shard_by_process=True,
                                    process_index=n, process_count=NODES)
        loader.set_epoch(0)
        nodes.append(next(iter(loader)))
    joined = {k: np.concatenate([b[k] for b in nodes]) for k in nodes[0]}
    flip, alpha = tr.draws.aug(0, 0, NODE_BATCH)
    model_batch = tr._device_batch(joined, train=True, aug=(torch.cat([flip] * NODES),
                                                            torch.cat([alpha] * NODES)))
    s, p = joined["ped_mask"].shape
    draws = tr.draws.step(tr.state, s, p)
    state, metrics = tr.train_step(tr.state, model_batch, draws)
    assert results[0]["agents"] == int(joined["ped_mask"].sum())
    got_m = {k: float(v[0]) for k, v in results[0]["metrics"].items()}
    # the G and PM updates move g_params twice, the D update d_params once
    noise_atol = {"g_params": 2 * 2 * cfg.g_lr + 2e-3, "d_params": 2 * cfg.d_lr + 2e-3}
    _assert_steps_match(_port_state(state), {k: float(v) for k, v in metrics.items()},
                        results[0]["state"], got_m, noise_atol)


def test_place_on_hosts():
    """The manual launch's node and local rank from the ranks' hosts: a
    host's ranks are a node in order of their first rank; ranks of one host
    that are not consecutive raise."""
    hosts = ["a", "a", "b", "b", "b"]
    assert [pod.place_on_hosts(hosts, r) for r in range(5)] == [
        (0, 2, 0), (1, 2, 0), (0, 3, 1), (1, 3, 1), (2, 3, 1)]
    assert pod.place_on_hosts(["x"] * 3, 2) == (2, 3, 0)
    with pytest.raises(ValueError, match="host by host"):
        pod.place_on_hosts(["a", "b", "a"], 0)
