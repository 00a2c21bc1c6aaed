"""The port's per-node dataset shards, lockstep counts, scene padding and the
batcher options of the data-parallel feed against the JAX package's
(``mggan_tpu/data/{elastic,batcher,loaders}.py``, ``parallel/dp.py``), on
the host: no process group, no device.

Both sides read one ``SceneDataset``'s arrays (the JAX package's synthetic
set, handed to the port as its own dataclass), so every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.data import elastic as jax_elastic
from mggan_tpu.data.batcher import PaddedBatcher as JaxBatcher
from mggan_tpu.data.loaders import get_dataloader as jax_get_dataloader
from mggan_tpu.data.loaders import get_dataset as jax_get_dataset
from mggan_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from mggan_tpu.parallel import dp as jax_dp

from mggan_tpu_torch.data import elastic
from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.dataset import SceneDataset
from mggan_tpu_torch.data.loaders import get_dataloader
from mggan_tpu_torch.parallel import dp

torch.set_num_threads(1)


def _both(num_windows=22, seed=0, max_peds=6):
    """One synthetic dataset, as the JAX package's and as the port's."""
    jds = jax_synthetic(num_windows=num_windows, seed=seed, max_peds=max_peds)
    pds = SceneDataset(dataset_name=jds.dataset_name, trajectories=jds.trajectories,
                       scene_names=jds.scene_names, images=jds.images,
                       big_patches=jds.big_patches, format=jds.format,
                       px_per_meter=jds.px_per_meter, ped_ids=jds.ped_ids)
    return jds, pds


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("pc", [1, 3, 4])
def test_shard_windows_equals_jax(interleave, pc):
    jds, pds = _both()
    seen = 0
    for p in range(pc):
        ours = elastic.shard_windows(pds, p, pc, interleave=interleave)
        theirs = jax_elastic.shard_windows(jds, p, pc, interleave=interleave)
        assert [id(t) for t in ours.trajectories] == [id(t) for t in theirs.trajectories]
        assert ours.scene_names == theirs.scene_names
        assert [id(b) for b in ours.big_patches] == [id(b) for b in theirs.big_patches]
        seen += len(ours)
    assert seen == len(pds)
    with pytest.raises(ValueError, match="process_index"):
        elastic.shard_windows(pds, pc, pc)


def test_lockstep_batches_equal_jax():
    for windows in (1, 5, 22, 48, 257):
        for pc in (1, 2, 3, 8):
            for bs in (1, 2, 4, 32):
                assert elastic.lockstep_batches(windows, pc, bs) == \
                    jax_elastic.lockstep_batches(windows, pc, bs)


def test_pad_scenes_to_multiple_equals_jax():
    """The -1 ``window_idx`` sentinel, zero elsewhere, None leaves passed,
    numpy and tensor leaves alike."""
    rng = np.random.RandomState(0)
    batch = {"xy": rng.randn(3, 2, 20, 2).astype(np.float32),
             "ped_mask": np.ones((3, 2), bool), "window_idx": np.arange(3),
             "patches": None}
    theirs = jax_dp.pad_scenes_to_multiple(
        {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}, 4)
    for leaves in (batch, {k: None if v is None else torch.from_numpy(v)
                           for k, v in batch.items()}):
        ours = dp.pad_scenes_to_multiple(leaves, 4)
        assert ours["patches"] is None
        for k in ("xy", "ped_mask", "window_idx"):
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]))
    np.testing.assert_array_equal(np.asarray(ours["window_idx"]), [0, 1, 2, -1])
    assert dp.pad_scenes_to_multiple(batch, 3) is batch


def test_sharded_loader_takes_the_global_max_peds():
    """``max_peds`` comes from the whole split before sharding, as in JAX,
    so every node pads to one shape; each node's batches equal JAX's."""
    loaders = [get_dataloader("synthetic_memory", "train", batch_size=2,
                              shard_by_process=True, process_index=p, process_count=16,
                              device="cpu") for p in range(16)]
    theirs = [jax_get_dataloader("synthetic_memory", "train", batch_size=2,
                                 shard_by_process=True, process_index=p, process_count=16)
              for p in range(16)]
    global_max = max(len(t) for t in jax_get_dataset("synthetic_memory", "train").trajectories)
    assert min(max(len(t) for t in ld.ds.trajectories) for ld in loaders) < global_max
    assert all(ld.max_peds == global_max for ld in loaders)
    assert len(loaders[0]) == len(theirs[0]) == jax_elastic.lockstep_batches(48, 16, 2)
    for ours, jax_loader in zip(loaders[:3], theirs[:3]):
        _assert_batches_equal(ours, jax_loader)


def test_lockstep_padding_is_fully_masked():
    """A node whose shard runs short yields all-masked batches with the -1
    window sentinel, as JAX's batcher does, batch for batch."""
    jds, pds = _both(num_windows=5)
    ours = PaddedBatcher(elastic.shard_windows(pds, 2, 3), batch_size=2, num_batches=3)
    theirs = JaxBatcher(jax_elastic.shard_windows(jds, 2, 3), batch_size=2, num_batches=3)
    batches = list(ours)
    assert len(batches) == 3 and batches[0]["ped_mask"].any()
    for b in batches[1:]:
        assert not b["ped_mask"].any() and (b["window_idx"] == -1).all()
    _assert_batches_equal(batches, theirs)
    with pytest.raises(ValueError, match="lockstep count"):
        len(PaddedBatcher(pds, batch_size=2, num_batches=2))


@pytest.mark.parametrize("batch_size, num_batches", [(3, None), (3, 4), (2, 6), (7, 2)])
def test_batcher_options_match_jax(batch_size, num_batches):
    """The restored ``num_batches`` gives JAX's batches: the data's, then
    all-masked ones up to the count."""
    jds, pds = _both(num_windows=7)
    kw = dict(batch_size=batch_size, num_batches=num_batches)
    ours, theirs = PaddedBatcher(pds, **kw), JaxBatcher(jds, **kw)
    assert len(ours) == len(theirs) == (num_batches or -(-7 // batch_size))
    _assert_batches_equal(ours, theirs)


@pytest.mark.parametrize("node_shards", [2, 3, 4])
def test_batcher_shard_is_the_rank_rows_of_the_padded_batch(node_shards):
    """``PaddedBatcher(shard=(i, n))`` assembles rank i's rows of each batch
    padded with empty scenes to a multiple of n: the whole batch's rows
    where it has them, empty masked scenes with window -1 past its end."""
    _, pds = _both(num_windows=11)
    whole = list(PaddedBatcher(pds, batch_size=6))
    for i in range(node_shards):
        part = list(PaddedBatcher(pds, batch_size=6, shard=(i, node_shards)))
        rows = -(-6 // node_shards)
        assert len(part) == len(whole)
        for a, b in zip(part, whole):
            assert sorted(a) == sorted(b) and a["xy"].shape[0] == rows
            for j in range(rows):
                g = i * rows + j
                if g < 6:
                    for k in b:
                        np.testing.assert_array_equal(a[k][j], b[k][g], err_msg=k)
                else:
                    assert not a["ped_mask"][j].any() and a["window_idx"][j] == -1
