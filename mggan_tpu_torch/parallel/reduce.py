"""The reductions a train step makes across the data and the model group.

GSPMD gives the JAX step its global masked means, per-generator counts and
BatchNorm statistics for free: a mean over the scene axis of a sharded
batch is a mean over every shard. A torch rank sees only its scene rows,
so each site that reduces over the batch calls one of these functions,
each the identity unless a data group is active (``over(group)``, which
``parallel/dp.py`` enters around the step):

* ``count``: a count (a mask's sum) summed over the group, without
  gradient; every denominator of the losses is one, so each rank's loss is
  its share of the global loss (local numerator over global count) and the
  shares add up to it;
* ``total``: a differentiable sum over the group, as SyncBatchNorm sums
  its statistics (its backward sums the incoming gradients the same way);
* ``on_first_rank``: a term of the loss that reads only parameters
  (probgan's SGHMC noise loss): the group's first rank adds it, the others
  add zero, so the summed gradients count it once;
* ``sum_grads``: the parameter gradients summed over the group, before
  the global-norm clip and Adam.

With generator parallelism (``over(group, model_group)``) each rank of a
model group holds a slice of the stacked generators (``decoders``) and
the same scene rows as the others, and GSPMD's split of the decoder vmap
becomes two conjugate operators around the decoders:

* ``to_model``: the identity forward, an all-reduce sum over the model
  group backward. It sits on the decoders' inputs, so the gradients that
  reach the replicated modules are whole on every model rank;
* ``from_model``: an all-reduce sum forward, the identity backward. It
  sits where the generator axis is contracted (the one-hot gather), each
  rank adding its generators' terms;
* ``gather_gens``: an all-gather along the generator axis, without
  gradient (the PM targets read every generator's rollout);
* ``leaf_sum`` / ``global_norm``: sums over a parameter tree whose
  ``decoders`` terms are summed over the model group first.

The data-group reductions stay on the data group: the model ranks of one
data rank hold equal losses, counts and statistics, and ``sum_grads``
sums the decoder slices and the (already whole) replicated gradients over
the data group alone, then hands every model rank its group's first
rank's replicated gradients. Without a model group every one of these is
the identity, or the plain sum.

The collectives run in the same order on every rank, as every rank runs
the same ops on same-shaped slices; those in a backward pass run in the
autograd engine's order, which the graph fixes.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from mggan_tpu_torch.utils.pytree import tree_items, tree_unflatten

_STATE = threading.local()
SHARDED_KEY = "decoders"  # the parameter subtree split over the model group


def group():
    """The active data group, or None on one device."""
    return getattr(_STATE, "group", None)


def model_group():
    """The active model group, or None without generator parallelism."""
    return getattr(_STATE, "model", None)


@contextlib.contextmanager
def over(data_group, model_group_=None):
    """Reduce over ``data_group`` (None: one device) and split the
    generators over ``model_group_`` (None: every rank holds them all)
    inside the block."""
    prev = group(), model_group()
    _STATE.group, _STATE.model = data_group, model_group_
    try:
        yield
    finally:
        _STATE.group, _STATE.model = prev


def model_rank() -> int:
    """This rank's place in the model group (0 without one)."""
    g = model_group()
    return 0 if g is None else dist.get_rank(g)


def count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, detached (a count has no gradient)."""
    g = group()
    if g is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=g)
    return out


def _all_reduce(x, g):
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=g)
    return out


class _SumOver(torch.autograd.Function):
    """All-reduce sum whose backward is the all-reduce sum of the gradients
    (itself differentiable, for the gradient penalty's double backward)."""

    @staticmethod
    def forward(ctx, x, data_group):
        ctx.data_group = data_group
        return _all_reduce(x, data_group)

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.apply(grad.contiguous(), ctx.data_group), None


class _ToModel(torch.autograd.Function):
    """Identity forward; backward ``_FromModel`` of the gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _FromModel.apply(grad, ctx.g), None


class _FromModel(torch.autograd.Function):
    """All-reduce sum forward; backward ``_ToModel`` of the gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _ToModel.apply(grad, ctx.g), None


def total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, differentiably."""
    g = group()
    return x if g is None else _SumOver.apply(x, g)


def to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group."""
    g = model_group()
    return x if g is None else _ToModel.apply(x, g)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group; its gradient passed as it is."""
    g = model_group()
    return x if g is None else _FromModel.apply(x, g)


@torch.no_grad()
def gather_gens(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` joined along the generator axis ``dim``,
    in model-rank order (no gradient). An all-reduce of each rank's slice
    in place among zeros, exact, as gloo has no ``all_gather`` of CUDA
    tensors."""
    g = model_group()
    if g is None:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * dist.get_world_size(g)
    out = x.new_zeros(shape)
    out.narrow(dim, dist.get_rank(g) * n, n).copy_(x)
    dist.all_reduce(out, group=g)
    return out


def on_first_rank(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the group's first rank, a zero elsewhere (see the note)."""
    g = group()
    if g is None or dist.get_rank(g) == 0:
        return x
    return torch.zeros((), dtype=x.dtype, device=x.device)


def leaf_sum(tree, term):
    """``sum(term(path, leaf))`` over ``tree_items(tree)``, in that order;
    with a model group the ``decoders`` terms (this rank's generators) are
    summed first and then over the group (``from_model``), so the result
    is the whole tree's on every model rank."""
    items = list(tree_items(tree))
    sharded = model_group() is not None
    out = 0.0
    if sharded and any(path[0] == SHARDED_KEY for path, _ in items):
        part = 0.0
        for path, x in items:
            if path[0] == SHARDED_KEY:
                part = part + term(path, x)
        out = from_model(torch.as_tensor(part))
    for path, x in items:
        if not (sharded and path[0] == SHARDED_KEY):
            out = out + term(path, x)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (optax's
    ``global_norm``), the ``decoders`` slices' squares summed over the
    model group."""
    return torch.sqrt(torch.as_tensor(leaf_sum(tree, lambda _, x: (x.float() ** 2).sum())))


def _flat_all(leaves, op):
    """``op`` on the leaves joined into one flat tensor; the leaves back."""
    flat = torch.cat([x.reshape(-1) for x in leaves])
    op(flat)
    out, i = [], 0
    for x in leaves:
        out.append(flat[i : i + x.numel()].view_as(x))
        i += x.numel()
    return out


def sum_grads(grads):
    """A gradient tree (float32 leaves, as every parameter is) summed over
    the data group in one all-reduce. With a model group the replicated
    leaves then take the group's first rank's sum (one broadcast): its
    ranks computed the same gradients, but cuDNN's backward is not
    deterministic, and replicated parameters must stay equal bit for bit."""
    items = list(tree_items(grads))
    leaves = [x for _, x in items]
    g, m = group(), model_group()
    if g is not None and leaves:
        leaves = _flat_all(leaves, lambda flat: dist.all_reduce(flat, group=g))
    rep = [i for i, (path, _) in enumerate(items) if path[0] != SHARDED_KEY]
    if m is not None and rep:
        src = dist.get_global_rank(m, 0)
        got = _flat_all([leaves[i] for i in rep],
                        lambda flat: dist.broadcast(flat, src=src, group=m))
        for i, x in zip(rep, got):
            leaves[i] = x
    return tree_unflatten(grads, leaves)
