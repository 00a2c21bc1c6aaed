"""Linear / MLP primitives on plain dicts of tensors.

Counterpart of ``mggan_tpu/ops/linear.py``. Parameters keep the JAX layout:
``w`` is ``(in_features, out_features)`` and forward is ``x @ w + b``, so a
JAX param tree converts leaf by leaf. Initialisation follows PyTorch's
defaults (weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 draws on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (2.0 * bound) - bound


def linear_init(gen: torch.Generator, in_features: int, out_features: int):
    bound = 1.0 / in_features ** 0.5
    return {
        "w": uniform(gen, (in_features, out_features), bound),
        "b": uniform(gen, (out_features,), bound),
    }


def linear_apply(params, x):
    return x @ params["w"] + params["b"]


def _activation(name):
    if name == "relu":
        return F.relu
    if name in ("leaky_relu", "leakyrelu"):
        # torch nn.LeakyReLU default negative_slope=0.01
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "leaky_relu_02":
        return lambda x: F.leaky_relu(x, 0.2)
    if name is None or name == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {name}")


def mlp_init(gen: torch.Generator, dims: Sequence[int]):
    """MLP parameters for ``len(dims)-1`` linear layers."""
    return {
        f"lin{i}": linear_init(gen, dims[i], dims[i + 1])
        for i in range(len(dims) - 1)
    }


def mlp_apply(params, x, activation="relu"):
    """The activation follows every layer except the last (the reference's
    ``make_mlp``, utils.py:134-149)."""
    n = len(params)
    act = _activation(activation)
    for i in range(n):
        x = linear_apply(params[f"lin{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def mlp_apply_per_layer(params, x, activations: Sequence[str]):
    """An MLP with one activation per layer (the scene CNN's ``make_mlp``,
    cnn.py:6-25)."""
    if len(activations) != len(params):
        raise ValueError(f"{len(activations)} activations for {len(params)} layers")
    for i, a in enumerate(activations):
        x = _activation(a)(linear_apply(params[f"lin{i}"], x))
    return x
