"""Batch views (counterpart of ``mggan_tpu/training/steps.py::batch_views``).

Only the part the sampling slice reads; the train step comes with the
training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mggan_tpu_torch.config import OBS_LEN


class BatchViews(NamedTuple):
    in_xy: torch.Tensor  # (S,P,8,2)
    in_dxdy: torch.Tensor  # (S,P,7,2)
    gt_xy: torch.Tensor  # (S,P,12,2) NaNs zeroed
    gt_dxdy: torch.Tensor  # (S,P,12,2) NaNs zeroed
    ped_mask: torch.Tensor  # (S,P) real agents
    loss_mask: torch.Tensor  # (S,P) real agents with finite futures
    patches: torch.Tensor | None  # (S,P,33,33,4) or None


def batch_views(batch) -> BatchViews:
    """Model inputs and masks from a padded batch dict; ``in_dxdy`` is the
    difference of consecutive observed positions."""
    xy = batch["xy"]
    ped_mask = batch["ped_mask"]
    in_xy = xy[:, :, :OBS_LEN]
    in_dxdy = in_xy[:, :, 1:] - in_xy[:, :, :-1]
    gt_raw = xy[:, :, OBS_LEN:]
    finite = ~torch.isnan(gt_raw).any(dim=-1).any(dim=-1)
    loss_mask = ped_mask & finite
    keep = loss_mask[..., None, None]
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    gt_xy = torch.where(keep, torch.nan_to_num(gt_raw), zero)
    prev = torch.cat([in_xy[:, :, -1:], gt_raw[:, :, :-1]], dim=2)
    gt_dxdy = torch.where(keep, torch.nan_to_num(gt_raw - prev), zero)
    return BatchViews(in_xy, in_dxdy, gt_xy, gt_dxdy, ped_mask, loss_mask,
                      batch.get("patches"))
