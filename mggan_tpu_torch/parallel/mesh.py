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
* **World size** ``slices * dp * gp``. The model index is innermost, as
  in JAX's ``reshape(slices, dp, gp)``: global rank ``= rank * gp +
  model_rank``, where ``rank`` is the joint (slice, data) index. Scenes
  shard over (slice, data) and stay atomic: data rank r holds scene rows
  ``[r * n, (r + 1) * n)`` of the global batch of ``n * slices * dp``
  rows, and the ``gp`` model ranks of one data rank hold the same rows.
  The slice axis is the outer factor of the data rank (JAX's DCN axis); on
  one host it changes nothing but the rank count, as on a single TPU slice.
* **Two kinds of group.** A *data group* holds the ranks of one model
  index (the step's batch reductions run over it); a *model group* the
  ``gp`` ranks of one data index, which split the stacked generators
  (``decoders``) between them, ``num_gens / gp`` each, with their Adam
  moments (JAX's ``state_shardings``). A model group lives on one node.
  With ``gp == 1`` the data group is the world and there is no model
  group.
* **One node** (JAX's single-process mesh). Every rank builds the same
  global batch, with the same loader, seed, augmentation draws and step
  draws, and keeps its data rank's contiguous scene rows, so a
  ``Trainer`` with ``dp=N`` (and any ``gp``) equals the single-device
  ``Trainer`` step for step.
* **Several nodes** (JAX's pod). Each node loads its
  ``data/elastic.py::shard_windows`` shard with ``lockstep_batches``
  batches, and its data shards take their rows of the node batch.
* **Device per rank**: ``cuda:local_rank % torch.cuda.device_count()``,
  so ranks share a card when there are more ranks than cards.
* **Backend**: ``pod.py``'s rule, NCCL when each rank has a card of its
  own, else gloo; the host-side agreements always on a gloo group (the
  data groups have gloo twins, ``host_group``, under NCCL).

On one device (``slices * dp * gp == 1`` and no pod) the grid is inactive and
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
    rank: int  # on the joint (slice, data) axis
    node: int
    nodes: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: str | None  # None on one device
    group: object = None  # the data group of the step's reductions
    model_rank: int = 0
    model_group: object = None  # None while gp == 1
    host_group: object = None  # the data group on gloo, for host numbers

    @property
    def shards(self) -> int:
        """Data shards: ``slices * dp`` (JAX's ``mesh.py::data_shard_count``)."""
        return self.slices * self.dp

    @property
    def active(self) -> bool:
        return self.shards * self.gp > 1

    @property
    def node_shards(self) -> int:
        """Data shards of one node's batch."""
        return self.shards // self.nodes

    @property
    def node_shard(self) -> int:
        """This rank's data shard of its node's batch."""
        return self.rank % self.node_shards

    @property
    def ranks_per_device(self) -> int:
        """Local ranks that share this rank's device (all of them on the
        CPU), model ranks included: each holds its own copy of the data."""
        if self.device.type != "cuda":
            return self.local_world
        cards = torch.cuda.device_count()
        return sum(1 for r in range(self.local_world) if r % cards == self.local_rank % cards)

    def gens_per_rank(self, num_gens: int) -> int:
        """Generators of the ``decoders`` stack this rank holds."""
        if num_gens % self.gp:
            raise ValueError(f"num_gens={num_gens} does not split over gp={self.gp} ranks")
        return num_gens // self.gp

    def gen_slice(self, num_gens: int) -> slice:
        """This rank's generators on the stack's leading axis."""
        n = self.gens_per_rank(num_gens)
        return slice(self.model_rank * n, (self.model_rank + 1) * n)

    def describe(self) -> str:
        model = f", model rank {self.model_rank} of {self.gp}" if self.gp > 1 else ""
        return (f"rank {self.rank} of {self.shards} (slices={self.slices}, dp={self.dp})"
                f"{model}, node {self.node} of {self.nodes}, local rank {self.local_rank} of "
                f"{self.local_world}, {self.device}, backend {self.backend}")


def launch_command(dp: int, slices: int = 1, gp: int = 1) -> str:
    flags = (f" --gp {gp}" if gp > 1 else "") + (f" --slices {slices}" if slices > 1 else "")
    return pod.LAUNCH.format(n=slices * dp * gp, dp=dp, flags=flags)


_GROUPS = {}  # (world group, shards, gp) -> this rank's groups, made once


def _groups(shards: int, gp: int, rank: int, model_rank: int, backend: str):
    """This rank's ``(data group, model group, host group)``. Every rank
    makes every group, in the same order (``pod.new_group``)."""
    key = (id(dist.group.WORLD), shards, gp)
    if key not in _GROUPS:
        if gp == 1:
            _GROUPS[key] = (dist.group.WORLD, None, pod.host_group())
        else:
            columns = [[d * gp + m for d in range(shards)] for m in range(gp)]
            data = [pod.new_group(c) for c in columns]
            model = [pod.new_group([d * gp + m for m in range(gp)]) for d in range(shards)]
            host = data if backend == "gloo" else [pod.new_group(c, "gloo") for c in columns]
            _GROUPS[key] = (data[model_rank], model[rank], host[model_rank])
    return _GROUPS[key]


def make_mesh(dp: int | None = None, gp: int = 1, slices: int = 1, device="cuda") -> Grid:
    """This rank's ``Grid`` for ``slices * dp`` data shards of ``gp`` model
    ranks each.

    ``dp=None`` takes every rank of the pod. Raises, naming the launch
    command, when the pod's world size is not ``slices * dp * gp`` (no pod
    at all for a world above 1), and ``ValueError`` when a node's ranks are
    not a multiple of ``gp`` (a model group lives on one node). On the card
    the rank's device becomes the current one.
    """
    world = pod.world_size()
    if dp is None:
        dp = world // (slices * gp)
    shards = slices * dp
    need = shards * gp
    if need != world:
        cmd = launch_command(dp, slices, gp)
        if not pod.is_initialized():
            raise RuntimeError(f"dp={dp} x slices={slices} x gp={gp} needs {need} ranks, one "
                               f"per device: launch with `{cmd}`")
        raise ValueError(f"the pod has {world} ranks but dp={dp} x slices={slices} x gp={gp} "
                         f"needs {need}: launch with `{cmd}`")
    if world == 1:
        return Grid(slices, dp, gp, rank=0, node=0, nodes=1, local_rank=0, local_world=1,
                    device=resolve_device(device), backend=None)
    nodes, local_world = pod.process_count(), pod.local_world_size()
    if local_world % gp:
        raise ValueError(f"a node holds {local_world} ranks, not a multiple of gp={gp}: a "
                         "model group must live on one node")
    if shards % nodes or nodes * local_world != world:
        raise ValueError(f"{world} ranks do not split evenly over {nodes} nodes")
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", pod.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    rank, model_rank = divmod(pod.rank(), gp)
    backend = dist.get_backend()
    group, model_group, host_group = _groups(shards, gp, rank, model_rank, backend)
    return Grid(slices, dp, gp, rank=rank, node=pod.process_index(), nodes=nodes,
                local_rank=pod.local_rank(), local_world=local_world, device=dev,
                backend=backend, group=group, model_rank=model_rank,
                model_group=model_group, host_group=host_group)
