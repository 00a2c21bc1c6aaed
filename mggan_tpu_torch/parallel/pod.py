"""Joining a multi-process pod (counterpart of ``mggan_tpu/parallel/pod.py``).

The JAX package joins a ``jax.distributed`` coordination service before
its first device touch; the port joins a ``torch.distributed`` process
group, one rank per device (``parallel/mesh.py``'s note maps JAX's
topology onto ranks). Launch modes:

* ``python -m torch.distributed.run --nproc_per_node N [--nnodes M
  --node_rank i --master_addr A --master_port P] -m
  mggan_tpu_torch.cli.train --dp D ...``: the launcher's env (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``). ``cli.train`` joins when that env
  names more than one rank; ``--distributed 1`` alone asks for it.
* Manual: ``--coordinator_address host:port --num_processes N
  --process_id i`` on every process (``file://`` addresses work too, as
  the tests use). Number the processes host by host: before the backend
  is chosen, each rank posts its host name to the rendezvous store, and
  the ranks of one host are a node, with its local ranks in process-id
  order. ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, when set, name the place
  instead (that is how several nodes are simulated on one host).

The backend rule: NCCL when every local rank has a card of its own, gloo
when ranks share a card or run on the CPU (gloo's ``all_reduce`` and
``broadcast`` take CUDA tensors). The host-side agreements (the metric
key digest of ``eval/metrics.py::allreduce_sums``, the version dir, the
state's scalars) always run on a gloo group, ``host_group()``. The rule
picks one backend from the launch; nothing falls back to another.

``init_distributed`` is idempotent, so the CLI may call it on every launch.
"""

from __future__ import annotations

import datetime
import os
import socket
from urllib.parse import urlparse

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600
LAUNCH = ("python -m torch.distributed.run --nproc_per_node {n} -m mggan_tpu_torch.cli.train "
          "--dp {dp}{flags} ...")

_HOST_GROUP = None
_TIMEOUT = None  # every collective's, from init_distributed
_PLACE = None  # (local rank, ranks on this node, node) while in a pod


def launcher_env() -> dict | None:
    """The ranks ``torch.distributed.run`` set in the env, or None."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return None
    return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"])}


def backend_for(device_type: str, local_world: int) -> str:
    """The backend rule of the module note."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_world_size() -> int:
    """Ranks on this node (1 off a pod)."""
    return _PLACE[1] if is_initialized() else 1


def local_rank() -> int:
    return _PLACE[0] if is_initialized() else 0


def process_count() -> int:
    """Nodes in the pod (JAX's ``process_count()``: a JAX process holds a
    node's devices, which are the node's ranks here)."""
    return world_size() // local_world_size()


def process_index() -> int:
    """This rank's node (JAX's ``process_index()``)."""
    return _PLACE[2] if is_initialized() else 0


def place_on_hosts(hosts: list[str], rank_: int) -> tuple[int, int, int]:
    """``(local rank, ranks on its host, node)`` of rank ``rank_`` when
    rank ``r`` runs on ``hosts[r]``: a host's ranks are a node, numbered in
    order of their first rank. Raises unless each host's ranks are
    consecutive, as the rows of a node's batch are."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank_]]
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError(f"ranks {mine} share host {hosts[rank_]!r} but are not consecutive: "
                         "number --process_id host by host")
    return mine.index(rank_), len(mine), list(dict.fromkeys(hosts)).index(hosts[rank_])


def _manual_store(address: str, world: int, rank_: int, timeout):
    """The rendezvous store of a ``tcp://host:port`` or ``file://path``
    address."""
    url = urlparse(address)
    if url.scheme == "file":
        store = dist.FileStore(url.path, world)
        store.set_timeout(timeout)
        return store
    if url.scheme != "tcp":
        raise ValueError(f"--coordinator_address {address!r}: host:port, tcp:// or file://")
    return dist.TCPStore(url.hostname, url.port, world, is_master=rank_ == 0,
                         timeout=timeout)


def _place_from_store(store, world: int, rank_: int) -> tuple[int, int, int]:
    """This rank's place from the host names every rank posts to ``store``."""
    store.set(f"mggan_pod_host/{rank_}", socket.gethostname())
    hosts = [store.get(f"mggan_pod_host/{r}").decode() for r in range(world)]
    return place_on_hosts(hosts, rank_)


def host_group():
    """The gloo group of the host-side agreements (None off a pod)."""
    return _HOST_GROUP if is_initialized() else None


def is_primary() -> bool:
    """Rank 0, or no pod: the rank that writes logs and checkpoints."""
    return rank() == 0


def barrier():
    if is_initialized():
        dist.barrier(group=_HOST_GROUP)


def sum_over_ranks(x: float, group=None) -> float:
    """A host number summed over the ranks of the gloo ``group`` (every
    rank by default; itself off a pod)."""
    if not is_initialized():
        return x
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, group=_HOST_GROUP if group is None else group)
    return float(t[0])


def new_group(ranks: list, backend: str | None = None):
    """``dist.new_group(ranks)`` with the pod's timeout. Every rank must
    call it for every group, in the same order, members or not."""
    return dist.new_group(ranks, timeout=_TIMEOUT, backend=backend)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (itself off a pod)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the pod; a no-op once joined.

    With no arguments the ranks come from the launcher's env (see the
    module note); otherwise all three name them. ``device`` (its type) and
    the ranks per node pick the backend; on the card each rank's current
    device becomes ``cuda:local_rank % device_count``. ``timeout_s`` bounds
    the rendezvous and every collective, so a rank that never arrives fails
    the others instead of hanging them.
    """
    global _HOST_GROUP, _PLACE, _TIMEOUT
    if is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    env = launcher_env()
    timeout = datetime.timedelta(seconds=timeout_s)
    store = None
    if all(x is None for x in explicit):
        if env is None:
            raise RuntimeError(
                "no pod to join: launch with `" + LAUNCH.format(n="N", dp="N", flags="")
                + "` or pass --coordinator_address, --num_processes and --process_id")
        world, rank_ = env["world"], env["rank"]
    else:
        if any(x is None for x in explicit):
            raise ValueError("--coordinator_address, --num_processes and --process_id go "
                             "together")
        if env is not None:
            raise ValueError("explicit pod flags under torch.distributed.run: use one")
        address = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
        world, rank_ = int(num_processes), int(process_id)
        store = _manual_store(address, world, rank_, timeout)
    if "LOCAL_WORLD_SIZE" in os.environ:  # the launcher's, or a simulated node's
        local, local_world = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
        node = int(os.environ.get("GROUP_RANK", rank_ // local_world))
    elif store is not None:
        local, local_world, node = _place_from_store(store, world, rank_)
    else:
        local, local_world, node = 0, 1, rank_
    dev_type = torch.device(device).type
    backend = backend_for(dev_type, local_world)
    if dev_type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    rendezvous = {"init_method": "env://"} if store is None else {"store": store}
    dist.init_process_group(backend, world_size=world, rank=rank_, timeout=timeout,
                            **rendezvous)
    _PLACE = (local, local_world, node)
    _TIMEOUT = timeout
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))


def add_pod_args(parser) -> None:
    """The launch-time pod flags. They are runtime topology, not model
    config: ``Config.from_dict`` drops them, so they never reach a version
    dir (a checkpoint trained on 4 nodes restores on 1)."""
    parser.add_argument(
        "--distributed", type=int, default=0,
        help="join a torch.distributed pod before touching the device (1 alone: the "
             "env of torch.distributed.run)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port (or a file:// path) of rank 0's rendezvous")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def maybe_init_from_args(args) -> bool:
    """The CLI's hook, before its first device touch: join the pod when the
    flags ask for it or the launcher's env names more than one rank.
    Returns whether this process is in a pod."""
    explicit = any(getattr(args, k) is not None
                   for k in ("coordinator_address", "num_processes", "process_id"))
    env = launcher_env()
    if args.distributed or explicit or (env is not None and env["world"] > 1):
        init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                         device=getattr(args, "device", "cuda"))
    return is_initialized()
