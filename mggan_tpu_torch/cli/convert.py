"""Convert between reference PyTorch checkpoints and the port's version dirs
(counterpart of ``mggan_tpu/cli/convert.py``).

Forward: a released reference ``.pth`` (``{"generator": ...,
"discriminator": ..., "g_optim": ..., "d_optim": ...}``, abstract_train.py:
235-244) with its ``meta_tags.csv`` becomes a port version dir that
``cli.evaluate`` and ``ServingModel.from_version_dir`` read:

    python -m mggan_tpu_torch.cli.convert \
        --pth .../checkpoints/checkpoint_best.pth \
        --meta_tags .../meta_tags.csv --out_dir logs_converted
    python -m mggan_tpu_torch.cli.evaluate \
        --model_path logs_converted/<experiment>/<name> ...

Optimizer moments are not converted, and probgan's history length
restarts at 1: the converted dir is for evaluation, serving and
fine-tuning from the weights.

Reverse (``--reverse``): a port version dir becomes a reference-format dir
(``models/torch_export.py``) that the reference's
``PiNetMultiGeneratorGAN.load_from_path`` and the JAX package's converter
read:

    python -m mggan_tpu_torch.cli.convert --reverse \
        --version_dir logs/multi_generator/<name>/version_N --out_dir ref_logs

Both directions run on ``--device`` (``cuda`` by default; ``cpu`` asks for
the CPU).
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import torch

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.utils.pytree import tree_items


def _merge_state(init_tree, imported_tree):
    """Imported model-state leaves (BN running statistics, probgan's
    history) over the freshly initialised state; init values stay for what
    the checkpoint does not carry."""
    if imported_tree is None:
        return init_tree
    if isinstance(init_tree, dict):
        out = dict(init_tree)
        for k, v in imported_tree.items():
            out[k] = _merge_state(init_tree.get(k), v) if k in init_tree else v
        return out
    return imported_tree


def _check_shapes(init_params, imported_params, which):
    init_s = [(p, tuple(x.shape)) for p, x in tree_items(init_params)]
    imp_s = [(p, tuple(x.shape)) for p, x in tree_items(imported_params)]
    if init_s != imp_s:
        raise ValueError(
            f"{which} checkpoint shapes do not match the model built from "
            f"meta_tags.csv (wrong hyperparameters?)\n"
            f"model: {init_s}\ncheckpoint: {imp_s}")


def convert_torch_checkpoint(pth_path, out_dir, meta_tags=None, overrides=None, version=0,
                             checkpoint_name="checkpoint_best", device="cuda"):
    """A reference ``.pth`` -> a port version dir; returns the dir (Path)."""
    from mggan_tpu_torch.models.weights import (
        discriminator_from_state_dict,
        generator_from_state_dict,
    )
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.utils.logging import ExperimentWriter, load_meta_tags

    device = resolve_device(device)  # before anything is written
    tags = dict(load_meta_tags(meta_tags)) if meta_tags else {}
    tags.update(overrides or {})
    config = Config.from_dict(tags)
    writer = ExperimentWriter(Path(out_dir), config.experiment, config.name, version=version,
                              config=config, tensorboard=False)
    trainer = Trainer(config, writer, device=device)
    writer.save_config(config)  # num_gen_parameters filled by the factory
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    g_params, g_state = generator_from_state_dict(obj["generator"], trainer.g_spec,
                                                  device=trainer.device)
    d_params, d_state = discriminator_from_state_dict(obj["discriminator"], trainer.d_spec,
                                                      device=trainer.device)
    _check_shapes(trainer.state.g_params, g_params, "generator")
    _check_shapes(trainer.state.d_params, d_params, "discriminator")
    trainer.state = trainer.state.replace(
        g_params=g_params, g_state=_merge_state(trainer.state.g_state, g_state),
        d_params=d_params, d_state=_merge_state(trainer.state.d_state, d_state))
    trainer.save(checkpoint_name)
    print(f"converted -> {writer.dir}")
    return writer.dir


def export_torch_checkpoint(version_dir, out_dir, checkpoint="best", version=0,
                            checkpoint_name="checkpoint_best", device="cuda"):
    """A port version dir -> a reference-format dir (meta_tags.csv +
    checkpoints/<name>.pth); returns the created dir."""
    from mggan_tpu_torch.models.torch_export import export_version_dir
    from mggan_tpu_torch.training.loop import Trainer

    trainer, config = Trainer.load_from_path(version_dir, checkpoint,
                                             device=resolve_device(device))
    vdir = export_version_dir(out_dir, config, trainer.g_spec, trainer.d_spec, trainer.state,
                              version=version, checkpoint_name=checkpoint_name)
    print(f"exported -> {vdir}")
    return vdir


def get_arg_parser():
    p = ArgumentParser(description=__doc__)
    p.add_argument("--reverse", action="store_true",
                   help="export a port version dir as a reference .pth dir")
    p.add_argument("--version_dir", default=None, help="(--reverse) the port's version dir")
    p.add_argument("--checkpoint", default="best",
                   help="(--reverse) which checkpoint to export")
    p.add_argument("--pth", default=None, help="reference checkpoint_*.pth")
    p.add_argument("--meta_tags", default=None,
                   help="reference meta_tags.csv (default: ../meta_tags.csv beside the "
                        ".pth's checkpoints dir)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--version", type=int, default=0)
    p.add_argument("--checkpoint_name", default="checkpoint_best")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides applied over meta_tags (e.g. --set "
                        "dataset=eth num_gens=4)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    from mggan_tpu_torch.utils.logging import _convert

    args = get_arg_parser().parse_args(argv)
    if args.reverse:
        if not args.version_dir:
            raise SystemExit("--reverse requires --version_dir")
        return export_torch_checkpoint(args.version_dir, args.out_dir,
                                       checkpoint=args.checkpoint, version=args.version,
                                       checkpoint_name=args.checkpoint_name,
                                       device=args.device)
    if not args.pth:
        raise SystemExit("--pth is required (or use --reverse)")
    meta = args.meta_tags
    if meta is None:
        cand = Path(args.pth).parent.parent / "meta_tags.csv"
        meta = cand if cand.is_file() else None
    overrides = {}
    for item in args.set:
        k, _, v = item.partition("=")
        overrides[k] = _convert(v)
    return convert_torch_checkpoint(args.pth, args.out_dir, meta_tags=meta,
                                    overrides=overrides, version=args.version,
                                    checkpoint_name=args.checkpoint_name,
                                    device=args.device)


if __name__ == "__main__":
    main()
