"""Noise and categorical-selection ops.

Counterpart of ``mggan_tpu/ops/sampling.py``. Draws come from an explicit
``torch.Generator`` or are injected (``z=`` / ``uniforms=``), so a test can
hand both frameworks the same random numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GUMBEL_U_MIN = 1e-20


def global_noise(num_samples: int, s: int, p: int, dim: int, *,
                 generator=None, z=None, noise_type="gaussian"):
    """Per-scene noise shared by all peds of a scene (utils.py:160-165):
    standard normal for ``noise_type="gaussian"``, uniform in ``[-1, 1)``
    for ``"uniform"``; any other type raises ``ValueError``.

    Drawn at ``(num_samples, S, 1, dim)`` (or taken from ``z``) and broadcast
    to ``(num_samples, S, P, dim)``.
    """
    if noise_type not in ("gaussian", "uniform"):
        raise ValueError(f'Unrecognized noise type "{noise_type}"')
    shape = (num_samples, s, 1, dim)
    if z is None:
        if noise_type == "gaussian":
            z = torch.randn(shape, generator=generator, device=generator.device)
        else:
            z = torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0
    elif tuple(z.shape) != shape:
        raise ValueError(f"z has shape {tuple(z.shape)}, expected {shape}")
    return z.expand(num_samples, s, p, dim)


def categorical(logits, num_samples: int, *, generator=None, uniforms=None):
    """Gumbel-argmax generator draws per (agent, sample) (standard.py:217-225).

    ``uniforms`` of shape ``(num_samples,) + logits.shape`` in
    ``[1e-20, 1)`` replace the generator's draws. Returns int32
    ``(..., num_samples)``.
    """
    shape = (num_samples,) + tuple(logits.shape)
    if uniforms is None:
        r = torch.rand(shape, generator=generator, device=logits.device)
        u = GUMBEL_U_MIN + r * (1.0 - GUMBEL_U_MIN)
    elif tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms have shape {tuple(uniforms.shape)}, expected {shape}")
    else:
        u = uniforms
    gumbel = -torch.log(-torch.log(u))
    idx = torch.argmax(logits[None] + gumbel, dim=-1)
    return torch.movedim(idx, 0, -1).to(torch.int32)


def selection_indices(sampled_idxs):
    """Occurrence counters: ``out[..., k]`` = how many times
    ``sampled_idxs[..., k]`` appeared earlier in the same row
    (utils.py:234-248, vectorised), e.g. ``[1, 2, 3, 1] -> [0, 0, 0, 1]``."""
    k = sampled_idxs.shape[-1]
    same = sampled_idxs[..., :, None] == sampled_idxs[..., None, :]  # (..., k, k)
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=sampled_idxs.device).tril(diagonal=-1)
    return (same & earlier).sum(-1).to(torch.int32)


def gather_samples(decoded, gen_idxs, first: int = 0, num_gens: int | None = None):
    """Pick the sampled generator's rollout per (agent, sample).

    decoded: ``(K, G, S, P, ...)``; gen_idxs: ``(S, P, K)`` int.
    Returns ``(K, S, P, ...)``, as a one-hot contraction like JAX. With
    ``first`` and ``num_gens``, ``decoded`` holds generators ``first`` to
    ``first + G`` of ``num_gens``, and a row whose sampled generator is not
    among them is zero.
    """
    g = decoded.shape[1]
    onehot = F.one_hot(gen_idxs.long(), num_gens or g)[..., first : first + g]
    onehot = onehot.to(decoded.dtype).permute(2, 3, 0, 1)  # (K, G, S, P)
    extra = decoded.dim() - onehot.dim()
    return (decoded * onehot.reshape(onehot.shape + (1,) * extra)).sum(1)
