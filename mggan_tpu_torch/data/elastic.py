"""Per-node dataset shards and this rank's rows of a batch (counterpart of
``mggan_tpu/data/elastic.py``).

The reference is single-process: its DataLoader workers read one
filesystem view (data_loaders.py:92-99). On several nodes each node feeds
only its own ranks, and every rank must run the same number of steps an
epoch (a rank that runs out of batches early hangs the others in their
collectives). So:

* ``shard_windows``: a deterministic, balanced, disjoint partition of a
  ``SceneDataset``'s windows over the nodes;
* ``lockstep_batches``: the batch count every node runs, from global
  quantities only;
* ``make_global_batch``: where JAX assembles one global array from every
  process's rows, a rank keeps its own scene rows of its node's batch.

Scenes stay atomic: a window never straddles two nodes or two ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mggan_tpu_torch.data.dataset import SceneDataset
from mggan_tpu_torch.parallel import pod


def shard_windows(ds: SceneDataset, process_index: int | None = None,
                  process_count: int | None = None, interleave: bool = True) -> SceneDataset:
    """The sub-dataset of the windows node ``process_index`` owns.

    Every window belongs to one node and shard sizes differ by at most 1.
    ``interleave`` deals round robin (node p takes windows p, p + P, ...),
    so each node sees every scene; ``False`` gives contiguous blocks. The
    defaults are the live ``pod.process_index()`` / ``process_count()``.
    """
    if process_index is None or process_count is None:
        process_index, process_count = pod.process_index(), pod.process_count()
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    n = len(ds)
    if interleave:
        idxs = list(range(process_index, n, process_count))
    else:
        base, rem = divmod(n, process_count)
        start = process_index * base + min(process_index, rem)
        idxs = list(range(start, start + base + (1 if process_index < rem else 0)))
    return dataclasses.replace(
        ds,
        trajectories=[ds.trajectories[i] for i in idxs],
        scene_names=[ds.scene_names[i] for i in idxs],
        big_patches=[ds.big_patches[i] for i in idxs] if ds.big_patches else None,
        ped_ids=[ds.ped_ids[i] for i in idxs] if ds.ped_ids else None,
    )


def lockstep_batches(global_windows: int, process_count: int, local_batch_size: int) -> int:
    """Batches a node runs an epoch (short shards pad all-masked batches),
    from global quantities only, so every node agrees without talking."""
    max_shard = -(-global_windows // process_count)
    return max(1, -(-max_shard // local_batch_size))


def make_global_batch(local_batch: dict, grid) -> dict:
    """This rank's scene rows of its node's batch, whose scene axis the
    caller has padded to a multiple of ``grid.node_shards``. Leaves may be
    numpy arrays or tensors on any device (a patch bank's gathers); None
    leaves pass."""
    n = next(np.shape(v)[0] for v in local_batch.values() if v is not None)
    if n % grid.node_shards:
        raise ValueError(f"{n} scenes do not split over {grid.node_shards} ranks; pad first")
    rows = n // grid.node_shards
    lo = grid.node_shard * rows
    return {k: None if v is None else v[lo : lo + rows] for k, v in local_batch.items()}
