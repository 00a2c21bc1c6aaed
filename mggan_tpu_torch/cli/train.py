"""Training CLI (counterpart of ``mggan_tpu/cli/train.py``; reference
mggan/model/train.py:665-691).

    python -m mggan_tpu_torch.cli.train --name exp --num_gens 4 --dataset eth ...

Runs on ``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
path). A new run prints its version dir. Resume: ``--checkpoint
<version_dir>`` restores the full train state (epoch included) from the
dir's ``best`` checkpoint and validates every epoch.

Data- and generator-parallel training runs one process a rank under the
launcher that ships with torch, ``slices * dp * gp`` ranks in all:

    python -m torch.distributed.run --nproc_per_node N -m mggan_tpu_torch.cli.train --dp N ...
    python -m torch.distributed.run --nproc_per_node 4 -m mggan_tpu_torch.cli.train --dp 2 --gp 2 ...

(``--gp G`` splits the stacked generators over G ranks of each data
shard, which must sit on one node; add ``--nnodes M --node_rank i
--master_addr A --master_port P`` for M nodes, or pass
``--coordinator_address``, ``--num_processes`` and ``--process_id`` per
process). Each process joins the pod before it touches the device
(``parallel/pod.py``); without a launcher ``--dp`` or ``--gp`` above 1
raises naming the command.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from mggan_tpu_torch.config import config_from_args, get_parser
from mggan_tpu_torch.parallel import pod
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.utils.logging import ExperimentWriter


def main(argv=None):
    args = get_parser().parse_args(argv)
    # join the pod (if any) before any device touch
    pod.maybe_init_from_args(args)
    config = config_from_args(args)

    if config.checkpoint:
        output_dir = Path(config.checkpoint)
        if not output_dir.is_dir():
            raise FileNotFoundError(f"--checkpoint {output_dir} is not a directory")
        model, config = Trainer.load_from_path(output_dir, device=args.device)
        model.config = dataclasses.replace(config, val_every=1)
    else:
        writer = ExperimentWriter(config.log_dir, config.experiment, config.name,
                                  config=config)
        if pod.is_primary():
            print(str(writer.dir.resolve()))
        model = Trainer(config, writer, device=args.device)
        writer.save_config(config)  # num_gen_parameters filled by the factory
    model.train()
    return model


if __name__ == "__main__":
    main()
