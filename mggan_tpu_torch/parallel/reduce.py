"""The reductions a train step makes across the data group.

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
* ``on_first_rank``: a term of the loss that reads only replicated values
  (probgan's SGHMC noise loss): the group's first rank adds it, the others
  add zero, so the summed gradients count it once;
* ``sum_grads``: the parameter gradients summed over the group, before
  the global-norm clip and Adam.

With these, the DP step equals the single-device step on the same global
batch and draws. The collectives run in the same order on every rank, as
every rank runs the same ops on same-shaped slices; those in a backward
pass run in the autograd engine's order, which the graph fixes.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_STATE = threading.local()


def group():
    """The active data group, or None on one device."""
    return getattr(_STATE, "group", None)


@contextlib.contextmanager
def over(data_group):
    """Reduce over ``data_group`` (None: one device) inside the block."""
    prev = group()
    _STATE.group = data_group
    try:
        yield
    finally:
        _STATE.group = prev


def count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, detached (a count has no gradient)."""
    g = group()
    if g is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=g)
    return out


class _SumOver(torch.autograd.Function):
    """All-reduce sum whose backward is the all-reduce sum of the gradients
    (itself differentiable, for the gradient penalty's double backward)."""

    @staticmethod
    def forward(ctx, x, data_group):
        ctx.data_group = data_group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=data_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.apply(grad.contiguous(), ctx.data_group), None


def total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, differentiably."""
    g = group()
    return x if g is None else _SumOver.apply(x, g)


def on_first_rank(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the group's first rank, a zero elsewhere (see the note)."""
    g = group()
    if g is None or dist.get_rank(g) == 0:
        return x
    return torch.zeros((), dtype=x.dtype, device=x.device)


def sum_grads(leaves: list) -> list:
    """Gradient leaves (float32, as every parameter is) summed over the
    data group in one all-reduce."""
    g = group()
    if g is None or not leaves:
        return leaves
    flat = torch.cat([x.reshape(-1) for x in leaves])
    dist.all_reduce(flat, group=g)
    out, i = [], 0
    for x in leaves:
        out.append(flat[i : i + x.numel()].view_as(x))
        i += x.numel()
    return out
