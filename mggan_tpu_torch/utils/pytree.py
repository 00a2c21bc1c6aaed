"""Nested-dict tensor trees (counterpart of ``mggan_tpu/utils/pytree.py``).

Parameter trees are nested dicts of tensors. Leaves are visited in sorted
key order, the order ``jax.tree.leaves`` gives a dict, so a sum over
leaves adds in the same order as the JAX package.
"""

from __future__ import annotations

import torch


def tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs in sorted key order; ``path`` is a tuple of keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def relative_to_abs(rel_traj, start_pos):
    """Cumulative-sum integration (utils.py:70-83): ``rel_traj (..., T, 2)``
    and ``start_pos (..., 2)`` -> absolute ``(..., T, 2)``."""
    return torch.cumsum(rel_traj, dim=-2) + start_pos[..., None, :]
