"""Scenes of pedestrians made from a seed: the general generator that every
traffic mix's parameters drive.

A mix's file sets how many scenes, how many real agents a scene may hold
(``peds``: every count from the first to the last equally often, so each
seed gives the same multiset of sizes in another order), the padded width
``max_peds``, the scenes' extents, the walking speeds and the jitter.
Everything is drawn on the device with one ``torch.Generator`` in a few
large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEQ_LEN, OBS_LEN = 20, 8
PATCH, MARGIN, BIG_MARGIN = 33, 16, 24
BIG_PATCH = 2 * BIG_MARGIN + 1


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed that is a fixed function of the run's seed and
    ``tags``; any whole number is a valid run seed."""
    words = [int(seed) % 2**64] + [int(t) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def scene_sizes(traffic: dict, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` scenes' real agent counts: each count of ``traffic["peds"]``
    (inclusive) equally often, in an order drawn from ``gen``."""
    lo, hi = traffic["peds"]
    counts = hi - lo + 1
    if n % counts:
        raise ValueError(f"{n} scenes do not split evenly over {counts} scene sizes")
    sizes = torch.arange(lo, hi + 1, device=gen.device).repeat(n // counts)
    return sizes[torch.randperm(n, generator=gen, device=gen.device)]


def tracks(traffic: dict, sizes: torch.Tensor, gen: torch.Generator):
    """``(xy (n, P, 20, 2), mask (n, P), scene (n,))``: every real agent
    walks from a start inside its scene's extent along a heading at a steady
    speed, with a random walk of ``jitter_m`` on top; padded rows are 0."""
    dev, n, p = gen.device, sizes.shape[0], traffic["max_peds"]
    extents = torch.tensor(traffic["extent_m"], dtype=torch.float32, device=dev)
    scene = torch.arange(n, device=dev) % extents.shape[0]
    wh = extents[scene][:, None, :]
    u = torch.rand((n, p, 4), generator=gen, device=dev)
    start = (0.2 + 0.6 * u[..., :2]) * wh
    lo, hi = traffic["speed_m"]
    speed = lo + (hi - lo) * u[..., 2]
    heading = 2 * math.pi * u[..., 3]
    vel = torch.stack([torch.cos(heading), torch.sin(heading)], -1) * speed[..., None]
    steps = torch.arange(SEQ_LEN, dtype=torch.float32, device=dev)[None, None, :, None]
    jitter = torch.randn((n, p, SEQ_LEN, 2), generator=gen, device=dev) * traffic["jitter_m"]
    xy = start[:, :, None] + vel[:, :, None] * steps + jitter.cumsum(2)
    mask = torch.arange(p, device=dev)[None] < sizes[:, None]
    return torch.where(mask[..., None, None], xy, 0.0), mask, scene


def big_patches(n: int, p: int, sizes: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """uint8 ``(n, P, 49, 49, 3)`` crops of the scene image around each
    agent; padded rows are 0."""
    dev = gen.device
    crops = torch.randint(0, 256, (n, p, BIG_PATCH, BIG_PATCH, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    mask = torch.arange(p, device=dev)[None] < sizes[:, None]
    return crops * mask[:, :, None, None, None].to(torch.uint8)


def model_patches(n: int, p: int, gen: torch.Generator) -> torch.Tensor:
    """float32 ``(n, P, 33, 33, 4)`` patches as the model reads them: an
    8-bit colour crop scaled to [-1, 1) and the one-hot centre channel."""
    dev = gen.device
    rgb = torch.randint(0, 256, (n, p, PATCH, PATCH, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    out = torch.zeros((n, p, PATCH, PATCH, 4), device=dev)
    out[..., :3] = -1.0 + rgb.float() * (2.0 / 256.0)
    out[:, :, MARGIN, MARGIN, 3] = 1.0
    return out


def scene_extent_px(traffic: dict) -> list:
    """Each scene's image size in pixels ``(h, w)`` at ``px_per_meter``."""
    ppm = traffic["px_per_meter"]
    return [(int(round(h * ppm)), int(round(w * ppm))) for w, h in traffic["extent_m"]]
