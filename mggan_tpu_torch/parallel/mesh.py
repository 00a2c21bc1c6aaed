"""The (slice, data, model) process grid (counterpart of
``mggan_tpu/parallel/mesh.py``).

How JAX's topology maps onto ``torch.distributed``:

* **One rank per device.** JAX's devices of one process are here the ranks
  of one host, or node, and JAX's processes are the nodes:
  ``pod.process_index()`` / ``process_count()`` are the node's rank and
  the node count, from the env of ``torch.distributed.run``
  (``GROUP_RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or, launched by
  hand (``--process_id`` / ``--num_processes``), from the host each rank
  posts to the rendezvous store (``pod.py``'s note).
* **World size** ``slices * dp`` (``gp == 1``). Scenes shard over (slice,
  data) jointly and stay atomic: rank r holds scene rows ``[r * n, (r + 1)
  * n)`` of the global batch of ``n * world`` rows. The slice axis is the
  outer factor of the rank (JAX's DCN axis); on one host it changes
  nothing but the rank count, as on a single TPU slice.
* **One node** (JAX's single-process mesh). Every rank builds the same
  global batch, with the same loader, seed, augmentation draws and step
  draws, and keeps its contiguous scene rows, so a ``Trainer`` with
  ``dp=N`` equals the single-device ``Trainer`` step for step.
* **Several nodes** (JAX's pod). Each node loads its
  ``data/elastic.py::shard_windows`` shard with ``lockstep_batches``
  batches, and its local ranks take their rows of the node batch.
* **Device per rank**: ``cuda:local_rank % torch.cuda.device_count()``,
  so ranks share a card when there are more ranks than cards.
* **Backend**: ``pod.py``'s rule, NCCL when each rank has a card of its
  own, else gloo; the host-side agreements always on a gloo group.
* **gp > 1** (the stacked-decoder axis sharded over ``model``) is not
  ported: ``make_mesh`` raises citing ROADMAP.md queue 1 item 13 (b).

On one device (``slices * dp == 1`` and no pod) the grid is inactive and
every reduction of the step is the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.parallel import pod


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (slice, data, model) grid."""

    slices: int
    dp: int
    gp: int
    rank: int  # on the joint (slice, data) axis; the global rank while gp == 1
    node: int
    nodes: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: str | None  # None on one device
    group: object = None  # the data group of the step's reductions

    @property
    def shards(self) -> int:
        """Data shards: ``slices * dp`` (JAX's ``mesh.py::data_shard_count``)."""
        return self.slices * self.dp

    @property
    def active(self) -> bool:
        return self.shards > 1

    @property
    def node_shards(self) -> int:
        """Shards of one node's batch: its local ranks."""
        return self.shards // self.nodes

    @property
    def node_shard(self) -> int:
        """This rank's shard of its node's batch."""
        return self.rank % self.node_shards

    @property
    def ranks_per_device(self) -> int:
        """Local ranks that share this rank's device (all of them on the CPU)."""
        if self.device.type != "cuda":
            return self.local_world
        cards = torch.cuda.device_count()
        return sum(1 for r in range(self.local_world) if r % cards == self.local_rank % cards)

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.shards} (slices={self.slices}, dp={self.dp}), "
                f"node {self.node} of {self.nodes}, local rank {self.local_rank} of "
                f"{self.local_world}, {self.device}, backend {self.backend}")


def launch_command(dp: int, slices: int = 1) -> str:
    return pod.LAUNCH.format(n=dp * slices, dp=dp) + (
        f" --slices {slices}" if slices > 1 else "")


def make_mesh(dp: int | None = None, gp: int = 1, slices: int = 1, device="cuda") -> Grid:
    """This rank's ``Grid`` for ``slices * dp`` data shards.

    ``dp=None`` takes every rank of the pod. Raises ``NotImplementedError``
    for ``gp > 1``, and, naming the launch command, when the pod's world
    size is not ``slices * dp`` (no pod at all for ``dp > 1``). On the card
    the rank's device becomes the current one.
    """
    if gp != 1:
        raise NotImplementedError(
            f"gp={gp}: generator parallelism (the stacked-decoder axis sharded over a "
            "model axis) is not ported yet (ROADMAP.md queue 1 item 13 (b))")
    world = pod.world_size()
    if dp is None:
        dp = world // slices
    shards = slices * dp
    if shards != world:
        if not pod.is_initialized():
            raise RuntimeError(
                f"dp={dp} x slices={slices} needs {shards} ranks, one per device: launch "
                f"with `{launch_command(dp, slices)}`")
        raise ValueError(f"the pod has {world} ranks but dp={dp} x slices={slices} needs "
                         f"{shards}: launch with `{launch_command(dp, slices)}`")
    if world == 1:
        return Grid(slices, dp, gp, rank=0, node=0, nodes=1, local_rank=0, local_world=1,
                    device=resolve_device(device), backend=None)
    nodes, local_world = pod.process_count(), pod.local_world_size()
    if shards % nodes or nodes * local_world != world:
        raise ValueError(f"{world} ranks do not split evenly over {nodes} nodes")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", pod.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Grid(slices, dp, gp, rank=pod.rank(), node=pod.process_index(), nodes=nodes,
                local_rank=pod.local_rank(), local_world=local_world, device=dev,
                backend=dist.get_backend(), group=dist.group.WORLD)

