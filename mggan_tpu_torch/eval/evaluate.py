"""Dataset-level evaluation (counterpart of ``mggan_tpu/eval/evaluate.py``;
reference evaluation.py:14-78 and train.py:215-243 ``get_predictions``).

Predictions cross to the host once per batch in the reference layout
``(pred_len, k, n_agents, 2)``, so the metric code matches the reference's
accumulation exactly (the per-scene pixel rescaling and the NaN-agent
removal with ``seq_start_end`` reindexing included).

Random numbers: batch ``i`` of a run with ``seed`` draws from its own
``torch.Generator`` seeded with ``batch_seed(seed, i)`` on the predictor's
device, the counterpart of JAX's ``fold_in(PRNGKey(seed), i)``; or, for
tests and card-vs-CPU checks, from injected draws.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from mggan_tpu_torch.config import PRED_LEN
from mggan_tpu_torch.data.augment import augment_batch
from mggan_tpu_torch.eval.metrics import MODE_THRESH

HOST_ONLY = ("scale", "window_idx", "wh_m")  # loader keys the model does not read


def batch_seed(seed: int, i: int) -> int:
    """The seed of batch ``i``'s generator: ``seed * 2**32 + i``, distinct
    for every (seed, i) with both below 2**32."""
    return int(seed) * 2**32 + int(i)


def adjust_seq_start_end_for_mask(seq_start_end, remove_mask):
    """Reindex scene boundaries after dropping masked agents
    (evaluation.py:14-27)."""
    offsets = np.concatenate([[0], np.cumsum(remove_mask)])
    return [
        (int(s - offsets[s]), int(e - offsets[e])) for s, e in seq_start_end
    ]


def get_predictions_multi(predictor, loader, num_preds=20,
                          strategies=("sampling",), seed=0, draws=None):
    """Run several strategies over a sequential loader in one pass.

    Returns ``{strategy: (pred_len, k, N, 2) numpy}``. Strategies that share
    random numbers in the JAX package share a decode pass
    (``Predictor.predict_multi``). ``draws``, when given, is a sequence with
    one ``predict_multi`` draws dict per batch (shapes as
    ``eval.predict.make_draws`` gives them) and replaces the generators.

    The loader must be sequential so rows line up with the dataset's
    ``seq_start_end`` (the reference asserts a SequentialSampler,
    train.py:216).
    """
    if loader.shuffle:
        raise ValueError("get_predictions needs a sequential loader")
    out = {s: [] for s in strategies}
    for i, batch in enumerate(loader):
        model_batch = augment_batch(
            {k: v for k, v in batch.items() if k not in HOST_ONLY},
            train=False, device=predictor.device)
        gen = None if draws is not None else predictor.new_generator(batch_seed(seed, i))
        results = predictor.predict_multi(
            model_batch, gen, strategies, num=num_preds,
            draws=None if draws is None else draws[i])
        valid_rows = np.asarray(batch["ped_mask"])
        for s in strategies:
            abs_np = results[s][0].cpu().numpy()  # (K,S,P,T,2)
            # flatten to reference layout: agents of scene 0, scene 1, ...
            sel = abs_np[:, valid_rows]  # (K, N_batch, T, 2)
            out[s].append(np.transpose(sel, (2, 0, 1, 3)))  # (T, K, N, 2)
    return {s: np.concatenate(v, axis=2) for s, v in out.items()}


def get_predictions(predictor, loader, num_preds=20, strategy="sampling", seed=0):
    """Run a strategy over a sequential loader -> (pred_len, k, N, 2) numpy."""
    return get_predictions_multi(
        predictor, loader, num_preds, (strategy,), seed
    )[strategy]


def evaluate_ade_fde(ds, preds, n_preds_list):
    """Reference-exact ADE/FDE/Mode accumulation (evaluation.py:43-78,
    metrics.py:99-141) from a (pred_len, k, N, 2) prediction tensor."""
    gt = ds.pred_traj  # (N, T, 2)
    seq_start_end = ds.seq_start_end
    pred_mask = np.isnan(gt).any(-1).any(-1)
    start_end = adjust_seq_start_end_for_mask(seq_start_end, pred_mask)
    gt = gt[~pred_mask]
    preds = preds[:, :, ~pred_mask]

    sums = defaultdict(lambda: np.zeros(2))
    for scene_idx, (start, end) in enumerate(start_end):
        if start == end:
            continue
        scaling = ds.eval_scaling(scene_idx)
        p = preds[:, :, start:end] * scaling  # (T, k, n, 2)
        g = gt[start:end].transpose(1, 0, 2) * scaling  # (T, n, 2)
        d = np.linalg.norm(p - g[:, None], axis=-1)  # (T, k, n)
        ades = d.sum(0)  # (k, n)
        fdes = d[-1]  # (k, n)
        n = end - start
        for k in n_preds_list:
            min_ade = ades[:k].sum(1).min()
            min_fde = fdes[:k].sum(1).min()
            mode = (fdes[:k].min(0) < MODE_THRESH).sum()
            sums[f"ADE k={k}"] += (min_ade, PRED_LEN * n)
            sums[f"FDE k={k}"] += (min_fde, n)
            sums[f"Mode k={k}"] += (mode, n)
    return {k: v[0] / v[1] for k, v in sums.items()}
