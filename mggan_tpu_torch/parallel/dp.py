"""The data- and generator-parallel train step (counterpart of
``mggan_tpu/parallel/dp.py``).

JAX runs the single-device program under GSPMD, which partitions it from
the batch's sharding. Here every rank runs ``build_train_step``'s step on
its scene rows, inside ``parallel/reduce.py``'s reductions over the data
group: the losses' counts, the BatchNorm statistics and the parameter
gradients are the global batch's, so the DP step equals the single-device
step on the same global batch and draws. The draws are drawn at the global
batch's shape from the generator every rank holds in the same state, and
each rank keeps its scene rows of them; the draws without a scene axis
(the GAN labels, probgan's SGHMC normals on the replicated parameters) are
the same on every rank.

Every rank ends a step with the same state: the summed gradients, the
global statistics and the summed loss metrics come out of one all-reduce
each, which hands every rank the same result.

With ``gp > 1`` (JAX's ``state_shardings`` on a ``model`` axis) each rank
keeps ``num_gens / gp`` of the stacked generators (every leaf under a
``decoders`` key of ``g_params``) and their Adam moments
(``shard_generators``), and the step runs inside a model group as well
(``reduce.py``'s note); probgan's decoder normals are drawn for every
generator and sliced. Every other leaf is replicated, equal on every rank
bit for bit. ``gather_generators`` joins the slices again, for a
checkpoint or validation. The discrete G has one replicated decoder and
no ``decoders`` stack, so, as in JAX, nothing is sharded; its model
groups are replicas, kept equal bit for bit by ``reduce.sum_grads``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mggan_tpu_torch.data.elastic import make_global_batch
from mggan_tpu_torch.parallel import pod, reduce
from mggan_tpu_torch.parallel.mesh import Grid
from mggan_tpu_torch.training.state import TrainState
from mggan_tpu_torch.training.steps import build_train_step, is_replicated_metric, make_draws
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map

# The scene axis of each draw with one (training/steps.py::make_draws)
DRAW_SCENE_AXIS = {"d_uniforms": 2, "d_z": 2, "d_alpha": 1, "g_uniforms": 1, "g_z": 1,
                   "pm_z": 1}


def pad_scenes_to_multiple(batch: dict, multiple: int) -> dict:
    """Every leaf's scene axis padded with empty scenes to a multiple.

    Padded scenes are zero with ``ped_mask`` False, so they add nothing to
    the global masked reductions; ``window_idx`` pads with its empty-scene
    sentinel -1 (zero would alias window 0); None leaves pass. Leaves may
    be numpy arrays or tensors.
    """
    s = next(np.shape(v)[0] for v in batch.values() if v is not None)
    rem = (-s) % multiple
    if rem == 0:
        return batch

    def pad(k, x):
        fill = -1 if k == "window_idx" else 0
        if torch.is_tensor(x):
            return torch.cat([x, torch.full((rem,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                            device=x.device)])
        x = np.asarray(x)
        return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    return {k: None if v is None else pad(k, v) for k, v in batch.items()}


def shard_batch(grid: Grid, batch: dict) -> dict:
    """This rank's scene rows of ``batch``: the global batch on one node,
    the node's batch on several (``data/elastic.py``), padded first to a
    multiple of the node's ranks. Identity on one device."""
    if not grid.active:
        return batch
    return make_global_batch(pad_scenes_to_multiple(batch, grid.node_shards), grid)


def global_rows(grid: Grid | None, rows: int) -> int:
    """Scene rows of the global batch of which each rank holds ``rows``
    (``rows`` itself on one device)."""
    return rows if grid is None or not grid.active else rows * grid.shards


def own_rows(grid: Grid | None, draws: dict, rows: int, axes: dict) -> dict:
    """This rank's ``rows`` scene rows of each global draw, cut along the
    draw's scene axis in ``axes``; draws without one, or None, pass whole,
    as does every draw on one device."""
    if grid is None or not grid.active:
        return draws
    cut = lambda axis: (slice(None),) * axis + (slice(grid.rank * rows, (grid.rank + 1) * rows),)
    return {k: v[cut(axes[k])] if k in axes and v is not None else v
            for k, v in draws.items()}


def sum_metrics(metrics: dict, grid: Grid) -> dict:
    """The loss metrics summed over the data group (one all-reduce; the
    model ranks of a data rank hold equal ones); the replicated ones
    (``steps.is_replicated_metric``) as they are."""
    keys = [k for k in sorted(metrics) if not is_replicated_metric(k)]
    if not grid.active or not keys:
        return metrics
    flat = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(flat, group=grid.group)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def splits_generators(grid: Grid, g_params) -> bool:
    """Whether ``g_params``' generators are split over ``grid``'s model
    group: ``gp > 1`` and a ``decoders`` stack (not the discrete G)."""
    return grid.gp > 1 and reduce.SHARDED_KEY in g_params


def _map_decoders(tree, fn):
    """``tree`` with ``fn`` applied to each leaf under its ``decoders`` key."""
    if reduce.SHARDED_KEY not in tree:
        return tree
    return {**tree, reduce.SHARDED_KEY: tree_map(fn, tree[reduce.SHARDED_KEY])}


def _own_slice(tree, grid: Grid):
    """``tree`` with its ``decoders`` leaves (tensors or numpy arrays) cut
    to this rank's generators."""
    cut = grid.gen_slice(tree_leaves(tree[reduce.SHARDED_KEY])[0].shape[0])
    return _map_decoders(tree, lambda x: x[cut])


def _gen_trees(state: TrainState):
    return state.g_params, state.g_opt.mu, state.g_opt.nu


def _with_gen_trees(state: TrainState, trees) -> TrainState:
    g_params, mu, nu = trees
    opt = dataclasses.replace(state.g_opt, mu=mu, nu=nu)
    return state.replace(g_params=g_params, g_opt=opt)


def shard_generators(state: TrainState, grid: Grid) -> TrainState:
    """``state`` with this rank's slice of the generators in ``g_params``
    and the G optimizer's moments; the identity unless
    ``splits_generators``. Raises ``ValueError`` if ``num_gens % gp``."""
    if not splits_generators(grid, state.g_params):
        return state
    return _with_gen_trees(state, [_map_decoders(_own_slice(t, grid), torch.clone)
                                   for t in _gen_trees(state)])


def gather_tree(tree, grid: Grid):
    """``tree``'s ``decoders`` slices joined over the model group (every
    rank calls it); the identity unless ``splits_generators``."""
    if not splits_generators(grid, tree):
        return tree
    with reduce.over(None, grid.model_group):
        return _map_decoders(tree, lambda x: reduce.gather_gens(x, dim=0))


def gather_generators(state: TrainState, grid: Grid) -> TrainState:
    """``state`` with every generator in ``g_params`` and its moments, the
    single-device layout (``shard_generators``' inverse)."""
    return _with_gen_trees(state, [gather_tree(t, grid) for t in _gen_trees(state)])


def broadcast_state(state: TrainState, grid: Grid) -> TrainState:
    """Global rank 0's whole state on every rank, then this rank's slice
    of the generators (``shard_generators``): the trees' tensors in one
    broadcast over the world, the scalars and the generator's state over
    the host group."""
    if not grid.active:
        return state
    trees = (state.g_params, state.g_state, state.d_params, state.d_state, state.g_opt.mu,
             state.g_opt.nu, state.d_opt.mu, state.d_opt.nu)
    leaves = [x for t in trees for x in tree_leaves(t)]
    with torch.no_grad():
        flat = torch.cat([x.reshape(-1).float() for x in leaves])
        dist.broadcast(flat, src=0)
        i = 0
        for x in leaves:
            x.copy_(flat[i : i + x.numel()].view_as(x))
            i += x.numel()
    scalars = pod.broadcast_object({
        "step": state.step, "epoch": state.epoch, "l2_weight": state.l2_weight,
        "best_val": state.best_val, "g_count": state.g_opt.count,
        "d_count": state.d_opt.count,
        "generator": None if state.generator is None else state.generator.get_state()})
    if scalars["generator"] is not None:
        state.generator.set_state(scalars["generator"])
    state.g_opt.count, state.d_opt.count = scalars["g_count"], scalars["d_count"]
    state = state.replace(step=scalars["step"], epoch=scalars["epoch"],
                          l2_weight=scalars["l2_weight"], best_val=scalars["best_val"])
    return shard_generators(state, grid)


def own_draws(grid: Grid, draws: dict, rows: int, g_params) -> dict:
    """This rank's share of a global step's ``draws``: its ``rows`` scene
    rows (``own_rows``) and, when the generators are split, its slice of
    probgan's decoder normals ``g_noise``."""
    draws = own_rows(grid, draws, rows, DRAW_SCENE_AXIS)
    if draws.get("g_noise") is None or not splits_generators(grid, g_params):
        return draws
    return {**draws, "g_noise": _own_slice(draws["g_noise"], grid)}


def build_kernels_once(grid: Grid):
    """The card's kernels and host ops built by each node's local rank 0
    while the others wait, not by every rank at once."""
    if not grid.active or grid.device.type != "cuda":
        return
    if grid.local_rank == 0:
        from mggan_tpu_torch import native
        from mggan_tpu_torch.ops.kernels import build

        build.build_all()
        native.load()
    pod.barrier()


def make_parallel_train_step(config, g_spec, d_spec, grid: Grid, state: TrainState):
    """Returns ``(step, state)``: ``state`` broadcast from rank 0 and
    sharded (``broadcast_state``), and ``step(state, batch, draws=None) ->
    (state, metrics)`` where ``batch`` is this rank's scene rows
    (``shard_batch``) and ``draws``, if given, the global step's
    (``make_draws``' layout); without them the global draws come from
    ``state.generator``. The metrics are the global step's, equal on every
    rank. On one device the step is the single-device step."""
    impl = build_train_step(config, g_spec, d_spec)
    if not grid.active:
        return impl, state
    state = broadcast_state(state, grid)
    build_kernels_once(grid)

    def step(state: TrainState, batch, draws=None):
        s, p = np.shape(batch["ped_mask"])
        if draws is None:
            draws = make_draws(state.generator, config, global_rows(grid, s), p,
                               state.g_params, state.d_params)
        draws = own_draws(grid, draws, s, state.g_params)
        with reduce.over(grid.group, grid.model_group):
            state, metrics = impl(state, batch, draws)
        return state, sum_metrics(metrics, grid)

    return step, state
