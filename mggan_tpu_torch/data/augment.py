"""Batched augmentation and patch finishing on the device (counterpart of
``mggan_tpu/data/augment.py``).

The reference augments per item on the host: a random LR/TB flip and a
rotation of the scene image about its centre, applied to the trajectories
and to the per-ped 33x33 patch crops (trajectories_scene.py:276-317,
BaseTrajectories.py:254-288). Here the host stops at a per-ped 49x49 uint8
"big patch" crop around the last observed position, and the device turns
it into the model's 33x33x4 patch. Rotation is rigid, so rotating the
scene about its centre and cropping at the rotated position equals
rotating the patch about its own centre: the trajectories are flipped and
rotated analytically and the patches resampled, batched over (scenes,
peds).

The resample is a gather of the source pixels each output pixel reads
(one for ``nearest``, four weighted taps for ``bilinear``). The JAX package
writes it as a contraction with one-hot or tap weights for the TPU's
matrix unit; both give each output pixel the same source pixels and
weights, and a tap outside the 49x49 support reads 0.
"""

from __future__ import annotations

import math

import torch

from mggan_tpu_torch.data.dataset import BIG_MARGIN, BIG_PATCH, MARGIN, PATCH
from mggan_tpu_torch.device import host_to_device, resolve_device


def rotate_points(xy, center, alpha):
    """Rotate points about ``center`` (trajectories_scene.py:15-29
    convention: x' = +cos*dx + sin*dy, y' = -sin*dx + cos*dy)."""
    d = xy - center
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    x = d[..., 0] * ca + d[..., 1] * sa
    y = -d[..., 0] * sa + d[..., 1] * ca
    return torch.stack([x, y], -1) + center


def augment_trajectories(xy, wh_m, flip, alpha):
    """Flip, rotate and re-offset scene trajectories.

    ``xy (S,P,T,2)`` metres (NaNs pass through), ``wh_m (S,2)`` the scene
    image's extent in metres, ``flip (S,)`` in {0, 1, 2} (none / LR / TB),
    ``alpha (S,)`` radians. Returns ``(S,P,T,2)`` shifted so the rotated
    image's min corner is at the origin (trajectories_scene.py:300-317).
    """
    w = wh_m[:, 0][:, None, None]
    h = wh_m[:, 1][:, None, None]
    f = flip[:, None, None]
    x = torch.where(f == 1, w - xy[..., 0], xy[..., 0])
    y = torch.where(f == 2, h - xy[..., 1], xy[..., 1])
    rot = rotate_points(torch.stack([x, y], -1), wh_m[:, None, None, :] / 2.0,
                        alpha[:, None, None])
    zero = torch.zeros_like(wh_m[:, 0])
    corners = torch.stack([
        torch.zeros_like(wh_m),
        torch.stack([zero, wh_m[:, 1]], -1),
        wh_m,
        torch.stack([wh_m[:, 0], zero], -1),
    ], dim=1)  # (S, 4, 2)
    offset = rotate_points(corners, wh_m[:, None, :] / 2.0, alpha[:, None]).amin(dim=1)
    return rot - offset[:, None, None, :]


def source_coords(flip, alpha):
    """Each output pixel's source coordinate in the big patch: ``(sx, sy)``,
    each ``(S, 33*33)`` with ``o = y*33 + x``. The inverse of the
    trajectories' rotation, then the flip, in the JAX package's order of
    operations (``finish_patches``)."""
    p = torch.arange(PATCH, dtype=torch.float32, device=alpha.device) - MARGIN
    py, px = torch.meshgrid(p, p, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    ca, sa = torch.cos(alpha)[:, None], torch.sin(alpha)[:, None]
    qx = px[None] * ca - py[None] * sa
    qy = px[None] * sa + py[None] * ca
    qx = torch.where(flip[:, None] == 1, -qx, qx)
    qy = torch.where(flip[:, None] == 2, -qy, qy)
    return BIG_MARGIN + qx, BIG_MARGIN + qy


def _taps(big, iy, ix):
    """``big (S,P,49,49,3)`` read at integer ``(iy, ix)`` of shape
    ``(S, O)``, as float32 ``(S,P,O,3)``; taps outside ``[0, 48]`` read 0."""
    s, p = big.shape[:2]
    inside = (ix >= 0) & (ix < BIG_PATCH) & (iy >= 0) & (iy < BIG_PATCH)
    flat = torch.where(inside, iy * BIG_PATCH + ix, 0)  # (S, O)
    rows = big.reshape(s, p, BIG_PATCH * BIG_PATCH, 3)
    # one index per (scene, pixel), broadcast over peds and channels
    index = flat[:, None, :, None].expand(s, p, flat.shape[1], 3)
    vals = torch.gather(rows, 2, index).float()  # (S, P, O, 3)
    return vals * inside[:, None, :, None]


def finish_patches(big_patches, flip, alpha, interp="nearest"):
    """uint8 ``(S,P,49,49,3)`` -> model patches ``(S,P,33,33,4)`` float32.

    Flips and rotates each scene's patches, normalises to [-1, 1)
    (BaseTrajectories.py:283: ``-1 + raw * 2/256``) and appends the one-hot
    centre channel (BaseTrajectories.py:278-284). ``nearest`` takes the
    source pixel nearest each output pixel's source coordinate, rounding
    half to even as ``jnp.round`` does; ``bilinear`` weighs the four
    neighbours by ``relu(1 - |sx - ix|) * relu(1 - |sy - iy|)``.
    """
    s, p = big_patches.shape[:2]
    sx, sy = source_coords(flip, alpha)
    if interp == "nearest":
        rgb = _taps(big_patches, torch.round(sy).long(), torch.round(sx).long())
    elif interp == "bilinear":
        x0, y0 = torch.floor(sx), torch.floor(sy)
        rgb = 0.0
        for dy in (0, 1):
            wy = torch.clamp(1.0 - torch.abs(sy - (y0 + dy)), min=0.0)
            row = 0.0
            for dx in (0, 1):
                wx = torch.clamp(1.0 - torch.abs(sx - (x0 + dx)), min=0.0)
                tap = _taps(big_patches, (y0 + dy).long(), (x0 + dx).long())
                row = row + wx[:, None, :, None] * tap
            rgb = rgb + wy[:, None, :, None] * row
    else:
        raise ValueError(f"interp must be 'nearest' or 'bilinear', got {interp!r}")
    rgb = -1.0 + rgb.reshape(s, p, PATCH, PATCH, 3) * 2.0 / 256.0
    return torch.cat([rgb, _centre_channel(s, p, big_patches.device)], dim=-1)


def _centre_channel(s, p, device):
    pos = torch.zeros((s, p, PATCH, PATCH, 1), dtype=torch.float32, device=device)
    pos[:, :, MARGIN, MARGIN, 0] = 1.0
    return pos


def sample_aug_params(generator: torch.Generator, s: int):
    """Per-scene augmentation draws (trajectories_scene.py:276-281), on the
    generator's device: ``flip ~ uniform{0,1,2}``, then ``alpha ~ U(0,
    2*pi)`` float32."""
    dev = generator.device
    flip = torch.randint(0, 3, (s,), generator=generator, device=dev)
    alpha = torch.rand((s,), generator=generator, device=dev) * (2.0 * math.pi)
    return flip, alpha


def identity_patches(big_patches):
    """uint8 ``(S,P,49,49,3)`` -> model patches ``(S,P,33,33,4)`` float32:
    the centre 33x33 crop (the zero transform), normalised to [-1, 1) with
    the one-hot centre channel appended."""
    s, p = big_patches.shape[:2]
    off = BIG_MARGIN - MARGIN
    rgb = big_patches[:, :, off : off + PATCH, off : off + PATCH].float()
    rgb = -1.0 + rgb * 2.0 / 256.0
    return torch.cat([rgb, _centre_channel(s, p, big_patches.device)], dim=-1)


def augment_batch(batch, train: bool, device="cuda", interp="nearest", aug=None):
    """Trajectories and finished model patches of a loader batch, as
    tensors on ``device``.

    ``batch``: ``xy (S,P,20,2)``, ``wh_m (S,2)``, ``big_patches
    (S,P,49,49,3)`` uint8 or absent, and the loader's other keys, as numpy
    arrays or tensors (a patch bank's gather is already on the device).
    With ``train=False`` the transform is the identity. With ``train=True``
    every scene is flipped and rotated by ``aug = (flip (S,), alpha (S,))``
    (``sample_aug_params`` draws them); ``interp`` is the patch resampling
    (``Config.patch_interp``).
    """
    device = resolve_device(device)
    out = {k: host_to_device(v, device) for k, v in batch.items() if v is not None}
    big = out.pop("big_patches", None)
    if train:
        if aug is None:
            raise ValueError("augment_batch(train=True) needs aug=(flip, alpha)")
        flip, alpha = (host_to_device(a, device) for a in aug)
        out["xy"] = augment_trajectories(out["xy"], out["wh_m"], flip,
                                         alpha.to(torch.float32))
        if big is not None:
            out["patches"] = finish_patches(big, flip, alpha.to(torch.float32), interp)
    elif big is not None:
        out["patches"] = identity_patches(big)
    return out
