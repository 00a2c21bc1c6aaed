"""Evaluation CLI (counterpart of ``mggan_tpu/cli/evaluate.py``; reference
scripts/evaluate.py:19-169).

    python -m mggan_tpu_torch.cli.evaluate --model_path logs/multi_generator/exp \
        --output_folder results --checkpoint best --phase test

Iterates every ``version_*`` dir under --model_path crossed with the
requested prediction strategies, computes ADE/FDE/Mode for k=1..num_preds-1
plus manifold Precision/Recall, and rewrites one CSV after every row: the
JAX CLI's file name, columns, column order and leading index column,
written with the ``csv`` module the way ``pandas.DataFrame.to_csv`` writes
them (pandas is not needed). Runs on ``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import csv
import math
import numbers
from argparse import ArgumentParser
from collections import defaultdict
from pathlib import Path

from mggan_tpu_torch.data.loaders import get_dataloader
from mggan_tpu_torch.eval.evaluate import evaluate_ade_fde, get_predictions_multi
from mggan_tpu_torch.eval.manifold import evaluate_precision_recall
from mggan_tpu_torch.training.loop import Trainer

STRATEGIES = ["all", "sampling", "expected", "smart_expected", "rejection",
              "uniform_expected", "smart_sampling", "uniform_sampling"]


def get_arg_parser():
    p = ArgumentParser()
    p.add_argument("--split", choices=["upper", "lower", "all"], default="all")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--model_path", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--phase", choices=["train", "val", "test"], default="test")
    p.add_argument("--eval_set", default=None)
    p.add_argument("--num_preds", default=20, type=int)
    # all 7 strategies of the reference dispatch (train.py:553-576)
    p.add_argument("--pred_strat", default="all", choices=STRATEGIES)
    p.add_argument("--no-precision-recall", action="store_true")
    p.add_argument("--compilation_cache_dir", default="",
                   help="a JAX cache; kept for CLI parity and read by nothing")
    p.add_argument("--data_root", default="./data/datasets")
    p.add_argument("--batch_size", default=32, type=int)
    return p


def _cells(values: list) -> list:
    """One column's cells as ``DataFrame.to_csv`` writes them: a column of
    integers as integers, a column holding a float as floats (shortest
    round-trip form, missing and NaN empty), anything else as ``str``."""
    missing = lambda v: v is None or (isinstance(v, float) and math.isnan(v))
    present = [v for v in values if not missing(v)]
    numeric = all(isinstance(v, numbers.Real) and not isinstance(v, bool) for v in present)
    if numeric and present and not all(isinstance(v, numbers.Integral) for v in present):
        return ["" if missing(v) else repr(float(v)) for v in values]
    return ["" if missing(v) else str(v) for v in values]


def write_csv(path, columns: dict):
    """``pandas.DataFrame(columns).to_csv(path)``: a header row led by an
    empty cell, then each row led by its index."""
    if len({len(v) for v in columns.values()}) > 1:
        raise ValueError("All arrays must be of the same length")
    cells = [_cells(list(v)) for v in columns.values()]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["", *columns])
        for i, row in enumerate(zip(*cells)):
            w.writerow([i, *row])


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    num_preds_list = list(range(1, args.num_preds))
    pred_strats = (
        ["smart_expected", "expected", "sampling"]
        if args.pred_strat == "all"
        else [args.pred_strat]
    )
    split = args.split

    model_name = Path(args.model_path).stem
    out_dir = Path(args.output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    output_csv = out_dir / (
        f"{model_name}_{args.phase}_{args.checkpoint}_{split}_"
        f"{args.pred_strat}_radius_{args.radius}.csv"
    )
    print(output_csv)

    model_dirs = [d for d in Path(args.model_path).iterdir() if "version" in d.stem]
    # Dir-major, as in the JAX CLI: each version dir is loaded once, not
    # once per strategy; the CSV's row order is cosmetic.
    all_results = defaultdict(list)
    loaders = {}  # (dataset, phase, split, bank) -> loader; reuse patch banks
    for model_dir in model_dirs:
        try:
            trainer, config = Trainer.load_from_path(model_dir, args.checkpoint,
                                                     device=args.device)
        except (FileNotFoundError, ValueError) as e:
            print(e)
            trainer, config = Trainer.load_from_path(model_dir, "best", device=args.device)

        # strategy applicability (scripts/evaluate.py:119-123)
        strats = [
            s for s in pred_strats
            if not (config.num_gens == 1 and s not in ("sampling", "rejection"))
            and not (config.weighting_target == "none" and "smart" in s)
        ]
        if not strats:
            continue

        dataset = args.eval_set or config.dataset
        loader_key = (dataset, args.phase, split, bool(config.patch_bank))
        if loader_key not in loaders:
            loaders[loader_key] = get_dataloader(
                dataset, args.phase, batch_size=args.batch_size,
                split=None if split == "all" else split,
                data_root=args.data_root, patch_bank=loader_key[-1],
                device=trainer.device,
            )
        loader = loaders[loader_key]

        # one loader pass for all applicable strategies
        preds_by_strat = get_predictions_multi(
            trainer.predictor(), loader, max(num_preds_list), strategies=tuple(strats))

        for pred_strat in strats:
            if args.eval_set is not None:
                all_results["Training dataset"].append(config.dataset)
            all_results["Model"].append(config.name)
            all_results["# Generators"].append(config.num_gens)
            all_results["Decoder dim"].append(config.decoder_h_dim)
            all_results["Generator params"].append(config.num_gen_parameters)
            all_results["Prediction strategy"].append(pred_strat)
            all_results["Mode"].append(config.experiment)
            all_results["Use Classifier"].append(config.gan_type)
            all_results["Prior"].append(config.weighting_target)
            all_results["Dataset"].append(dataset)
            all_results["Maximization Samples"].append(config.num_samples)
            all_results["Expectation Samples"].append(config.num_expectation_samples)
            all_results["L2 loss weight"].append(config.l2_loss_weight)
            all_results["Clf loss weight"].append(config.clf_loss_weight)
            all_results["Sigma"].append(config.sigma)

            preds = preds_by_strat[pred_strat]
            metric_dict = dict(evaluate_ade_fde(loader.ds, preds, num_preds_list))
            if not args.no_precision_recall:
                metric_dict.update(evaluate_precision_recall(
                    loader.ds, preds, args.radius, num_preds_list))
            for k, v in metric_dict.items():
                all_results[k].append(v)

            write_csv(output_csv, all_results)
    return output_csv


if __name__ == "__main__":
    main()
