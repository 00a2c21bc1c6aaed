"""Grid-search sweeps (counterpart of ``mggan_tpu/cli/sweep.py``).

The reference exposes tunable flags through test_tube's
``HyperOptArgumentParser(strategy="grid_search")`` (config.py:5,82-133).
Here a sweep is an explicit command: ``--grid`` is a JSON object of flag ->
list of values, and every combination trains in turn, each in its own
version dir under the name ``<name>_<flag>=<value>_...`` (flags sorted),
as in JAX. The other flags are the train CLI's, ``--device`` included
(``cuda`` by default).

    python -m mggan_tpu_torch.cli.sweep --grid '{"num_gens": [2, 3, 4, 5],
        "gan_obj": ["NS", "LS"]}' --name sweep1 --dataset eth ...
"""

from __future__ import annotations

import dataclasses
import itertools
import json

from mggan_tpu_torch.config import config_from_args, get_parser
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter


def main(argv=None):
    """Train every combination of ``--grid``; returns the trainers, in the
    grid's order."""
    parser = get_parser()
    parser.add_argument(
        "--grid", type=str, required=True,
        help='JSON dict of flag -> list of values, e.g. \'{"num_gens": [2,3]}\'')
    args = parser.parse_args(argv)
    grid = json.loads(args.grid)
    base = config_from_args(args)

    keys = sorted(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))
    print(f"sweep: {len(combos)} configurations over {keys}")
    trainers = []
    for combo in combos:
        overrides = dict(zip(keys, combo))
        tag = "_".join(f"{k}={v}" for k, v in overrides.items())
        cfg = dataclasses.replace(base, **overrides, name=f"{base.name}_{tag}")
        print(f"=== {cfg.name}")
        writer = ExperimentWriter(cfg.log_dir, cfg.experiment, cfg.name, config=cfg)
        trainer = Trainer(cfg, writer, device=args.device)
        writer.save_config(cfg)  # num_gen_parameters filled by the factory
        trainers.append(trainer.train())
    return trainers


if __name__ == "__main__":
    main()
