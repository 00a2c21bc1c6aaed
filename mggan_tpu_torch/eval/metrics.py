"""ADE/FDE/Mode metrics, batched over padded scenes (counterpart of
``mggan_tpu/eval/metrics.py``).

Reference semantics (metrics.py:6-141, evaluation.py:43-78):
* ADE/FDE at k use the JOINT scene minimum: min over the first k samples of
  the error summed over the scene's valid agents.
* Accumulation is (sum, count) pairs across scenes; ADE's count is
  ``pred_len * n_agents``, FDE's and Mode's is ``n_agents``.
* Mode = fraction of agents whose per-agent min-FDE over k samples is
  < 3 m (the intent of the reference's mode threshold).
* For pixel datasets errors are rescaled per scene by 1/ratio.

``allreduce_sums`` sums the host accumulators' pairs over the data ranks
of a pod, so every rank reads the global metric.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

from mggan_tpu_torch.parallel import pod

MODE_THRESH = 3.0


def displacement_errors(pred_abs, gt_xy, scale):
    """Per-agent ADE-sum and FDE per sample.

    Args:
        pred_abs: (K, S, P, T, 2); gt_xy: (S, P, T, 2) (NaNs zeroed upstream;
            invalid agents are excluded by the mask later).
        scale: (S,) per-scene rescaling.

    Returns:
        (ades (K,S,P) summed over T, fdes (K,S,P)).
    """
    sc = scale[None, :, None, None, None]
    d = torch.linalg.vector_norm((pred_abs - gt_xy[None]) * sc, dim=-1)  # (K,S,P,T)
    return d.sum(-1), d[..., -1]


def batch_metric_sums(pred_abs, gt_xy, loss_mask, scale, ks, pred_len=12):
    """(sum, count) accumulators for one padded batch, all ks at once.

    Returns ``{f"{name} k={k}": (sum, count)}`` with 0-d tensors.
    """
    ades, fdes = displacement_errors(pred_abs, gt_xy, scale)
    m = loss_mask[None].to(ades.dtype)
    ades = ades * m
    fdes = fdes * m
    scene_ade = ades.sum(-1)  # (K, S) summed over valid agents
    scene_fde = fdes.sum(-1)
    total_agents = loss_mask.sum()
    inf = torch.tensor(float("inf"), dtype=fdes.dtype, device=fdes.device)
    out = {}
    for k in ks:
        min_ade = scene_ade[:k].amin(0).sum()
        min_fde = scene_fde[:k].amin(0).sum()
        # per-agent min-FDE over k (metrics.py:136), masked
        agent_min_fde = torch.where(loss_mask, fdes[:k].amin(0), inf)
        mode = (agent_min_fde < MODE_THRESH).sum()
        out[f"ADE k={k}"] = (min_ade, pred_len * total_agents)
        out[f"FDE k={k}"] = (min_fde, total_agents)
        out[f"Mode k={k}"] = (mode.to(torch.float32), total_agents)
    return out


class MetricAccumulator:
    """Host-side (sum, count) accumulation across batches
    (evaluation.py:52-78)."""

    def __init__(self):
        self.sums = {}

    def update(self, batch_sums):
        for key, (v, c) in batch_sums.items():
            v, c = float(v), float(c)
            s, n = self.sums.get(key, (0.0, 0.0))
            self.sums[key] = (s + v, n + c)

    def result(self):
        return {k: (s / n if n else float("nan")) for k, (s, n) in self.sums.items()}


def allreduce_sums(sums: dict, group=None) -> dict:
    """Per-rank ``{key: (sum, count)}`` pairs summed over the ranks of the
    gloo ``group``: a grid's data ranks (``parallel/mesh.py::Grid.host_group``),
    every rank of the pod by default; the identity off a pod.

    Data ranks evaluate disjoint scene rows, so the global metric is the
    sum of their pairs; the model ranks of one data rank evaluate the same
    rows, so a sum over every rank would count them ``gp`` times. The sums are float64 and added in rank order on
    every rank, so each rank gets the same result bit for bit and may
    branch on it (the best-checkpoint save). Every rank must call this
    with the same key set (an empty shard contributes zero counts); the
    key sets' digests are gathered first, so a mismatch raises on every
    rank instead of hanging the collective that would follow.
    """
    if not pod.is_initialized() or pod.world_size() == 1:
        return dict(sums)
    group = pod.host_group() if group is None else group
    world = dist.get_world_size(group)
    keys = sorted(sums)
    digest = torch.tensor([zlib.crc32("\n".join(keys).encode()) & 0x7FFFFFFF, len(keys)],
                          dtype=torch.int64)
    digests = [torch.zeros_like(digest) for _ in range(world)]
    dist.all_gather(digests, digest, group=group)
    if any(not torch.equal(d, digests[0]) for d in digests):
        raise ValueError(
            "allreduce_sums key sets differ across ranks (crc32, count per rank: "
            f"{[d.tolist() for d in digests]}); every rank must contribute the same "
            "metric keys (zero counts for an empty shard)")
    flat = torch.tensor([sums[k] for k in keys], dtype=torch.float64).reshape(-1, 2)
    gathered = [torch.zeros_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat, group=group)
    total = gathered[0].clone()
    for g in gathered[1:]:
        total += g
    return {k: (float(total[i, 0]), float(total[i, 1])) for i, k in enumerate(keys)}


def pred_diversity(preds):
    """Mean 1 - cosine similarity over sample pairs (metrics.py:71-96).

    preds: (T, K, 2) relative predictions for one agent -> scalar in [0, 1].
    """
    k = preds.shape[1]
    flat = np.asarray(preds).transpose(1, 0, 2).reshape(k, -1)
    norm = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-8)
    cos = norm @ norm.T
    off_diag = (cos.sum() - np.trace(cos)) / (k * (k - 1))
    return 1.0 - off_diag
