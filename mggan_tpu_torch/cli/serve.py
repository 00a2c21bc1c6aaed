"""Inference CLI (counterpart of ``mggan_tpu/cli/serve.py``): serve an
artifact of ``cli/export.py`` or a version dir over HTTP, or predict
offline over a reference-format trajectory txt.

HTTP serving:
    python -m mggan_tpu_torch.cli.serve --artifact model.mgtorch --port 8000
    python -m mggan_tpu_torch.cli.serve --model_dir logs/.../version_1 \
        --strategy sampling --scenes 1,8,64 --port 8000

Offline (txt in, npz out; observation-only 8-frame windows):
    python -m mggan_tpu_torch.cli.serve --artifact model.mgtorch \
        --input obs.txt --output preds.npz --scene_img scene.png
    # obs.txt rows: frame ped_id x y (reference dataset format,
    # BaseTrajectories.py:130-155; --txt_dataset picks a registry schema)

The npz holds ``window_{i:05d}`` (num, p_i, 12, 2) and ``ped_ids_{i:05d}``.
A scene-conditioned model refuses to predict without scene input: give
--scene_img (the half-resolution "small" scene image, read with
``data/image_io.py::read_rgb``) and --px_per_meter, or opt into degraded
zero-patch predictions with --allow_missing_scene. Over HTTP, clients
register scenes with POST /v1/scenes and name them per request in
"scene_ids" (or send "patches").

Runs on ``--device`` (``cuda`` by default; ``cpu`` asks for the CPU). An
artifact is served as its ``torch.export`` programs, one per scene bucket,
without the model code: ``torch`` and the port's kernel operators
(``ops/kernels/library.py``) run it (see ``cli/export.py``).
"""

from __future__ import annotations

import dataclasses
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from mggan_tpu_torch.config import OBS_LEN


def load_obs_windows(path, dataset: str | None = None):
    """Observation-only scenes of a trajectory txt: 8-frame full-presence
    windows slid over the file (``data/parsing.py::window_scene`` with
    ``inclusive=True``, so the window ending at the newest frame is among
    them). Returns (list of (p_i, 8, 2) float32, list of ped_ids)."""
    from mggan_tpu_torch.data import parsing, registry

    if dataset is not None:
        info = registry.get_info(dataset)
    else:
        # generic whitespace (frame, ID, x, y); real BIWI files store
        # (frame, ID, y, x): pass --txt_dataset eth/hotel/... for them
        info = dataclasses.replace(registry.get_info("eth"),
                                   data_columns=["frame", "ID", "x", "y"], delim=r"\s+")
    data = parsing.load_txt(Path(path), info)
    windows = parsing.window_scene(data, skip=1, seq_len=OBS_LEN, inclusive=True)
    return [w[0] for w in windows], [w[1] for w in windows]


def get_arg_parser():
    p = ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="an artifact file of cli.export")
    src.add_argument("--model_dir", help="a version_* dir (live path)")
    p.add_argument("--strategy", default="sampling",
                   help="prediction strategy (only for --model_dir)")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--scenes", default="64",
                   help="max scenes per device call (--model_dir); a comma list "
                        "(e.g. 1,8,64) serves one bucket per scene count so small "
                        "requests run at small shapes")
    p.add_argument("--peds", type=int, default=16)
    p.add_argument("--num", type=int, default=20, help="samples per scene")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # HTTP mode
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="micro-batching window after the first request")
    # offline mode
    p.add_argument("--input", default=None,
                   help="trajectory txt (frame id x y) -> offline batch mode")
    p.add_argument("--txt_dataset", default=None,
                   help="registry name for the txt column schema and delimiter")
    p.add_argument("--output", default=None, help="output .npz path")
    p.add_argument("--seed", type=int, default=0)
    # scene context
    p.add_argument("--scene_img", default=None,
                   help="half-resolution scene image (the training pipeline's "
                        "'small' resolution); patches are cropped at each ped's "
                        "last observed position")
    p.add_argument("--px_per_meter", type=float, default=2.0,
                   help="pixels per meter of --scene_img (1/scaling_small; BIWI "
                        "small images: 2)")
    p.add_argument("--scene_name", default="scene0", help="registry name for --scene_img")
    p.add_argument("--allow_missing_scene", action="store_true",
                   help="serve a scene-conditioned model WITHOUT scene input "
                        "(degraded zero-patch predictions; off by default: missing "
                        "scene input is an error)")
    return p


def build_model(args):
    from mggan_tpu_torch.serving.runtime import ServingModel

    if args.artifact:
        model = ServingModel.from_artifact(
            args.artifact, allow_missing_scene=args.allow_missing_scene, device=args.device)
    else:
        buckets = sorted({int(s) for s in str(args.scenes).split(",")})
        model = ServingModel.from_version_dir(
            args.model_dir, strategy=args.strategy, scenes=buckets[-1], peds=args.peds,
            num=args.num, checkpoint=args.checkpoint,
            allow_missing_scene=args.allow_missing_scene, scene_buckets=buckets,
            device=args.device)
    if args.scene_img:
        from mggan_tpu_torch.data.image_io import read_rgb

        model.register_scene(args.scene_name, read_rgb(args.scene_img), args.px_per_meter)
    return model


def main(argv=None):
    args = get_arg_parser().parse_args(argv)
    if args.input and not args.output:
        raise SystemExit("--input requires --output")
    model = build_model(args)

    if args.input:  # offline batch mode
        scenes, ped_ids = load_obs_windows(args.input, args.txt_dataset)
        if not scenes:
            raise SystemExit(f"no full-presence {OBS_LEN}-frame windows in {args.input}")
        preds = []
        for i in range(0, len(scenes), model.scenes):
            chunk = scenes[i:i + model.scenes]
            patches = ([model.crop_patches(args.scene_name, obs) for obs in chunk]
                       if args.scene_img else None)
            preds.extend(model.predict_batch(chunk, patches, seed=args.seed + i))
        np.savez(args.output,
                 **{f"window_{i:05d}": p for i, p in enumerate(preds)},
                 **{f"ped_ids_{i:05d}": ids for i, ids in enumerate(ped_ids)})
        print(f"{len(preds)} windows ({sum(p.shape[1] for p in preds)} agents) "
              f"x {model.num} samples -> {args.output}")
        return args.output

    from mggan_tpu_torch.serving.server import serve_forever

    serve_forever(model, host=args.host, port=args.port, max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
