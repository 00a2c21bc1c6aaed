"""Serving export (counterpart of ``mggan_tpu/cli/export.py``): a trained
version dir becomes one self-describing artifact file that
``ServingModel.from_artifact`` serves.

    python -m mggan_tpu_torch.cli.export --model_dir logs/.../version_1 \
        --out model.mgtorch --scenes 1,8,64 --peds 16 --num 20

    calls, meta = load_artifact_all("model.mgtorch", device="cuda")
    pred_abs = calls[64](xy, ped_mask, patches, seed)

What the artifact is: the port's own magic, a JSON header (the JAX
header's keys ``wants_scene``, ``strategy``, ``dataset`` and
``model_dir``, plus ``scene_buckets``, ``peds``, ``num`` and the ``config``
dict that rebuilds the generator's spec), then the generator's
reference-format state dict (``models/torch_export.py``) written with
``torch.save``. Loading rebuilds a ``Predictor`` on the requested device
and one serving call over it, which serves every scene bucket.

What it is not: the JAX package's artifact is StableHLO with the
parameters baked in, callable from any JAX runtime without the model code.
This one holds weights and shapes, not a program: the port's kernels are
ctypes calls outside the PyTorch dispatcher and its tiled routes take
decisions on the host from the data, so ``torch.export`` cannot trace its
serving function. Serving from it needs this package installed at the
endpoint. A JAX ``.jaxexport`` file is recognised by its magic and refused.

Inputs of a call: xy (S,P,20,2) f32 (observed 8 steps used), ped_mask
(S,P) bool, patches (S,P,33,33,4) f32, seed int. Output: pred_abs (num, S,
P, 12, 2) on the artifact's device.
"""

from __future__ import annotations

import io
import json
from argparse import ArgumentParser
from pathlib import Path

import torch

from mggan_tpu_torch.serving.runtime import EXPORTABLE, build_serving_fn

MAGIC = b"MGTORCH1\n"
JAX_MAGIC = b"MGEX1\n"  # mggan_tpu/cli/export.py's artifact container
FORMAT = "mggan_tpu_torch.artifact/1"


def save_artifact(predictor, path, strategy: str, scene_buckets, peds: int, num: int,
                  meta: dict | None = None):
    """Write ``predictor``'s generator as an artifact at ``path``.

    ``meta``: extra header keys (the CLI adds ``dataset`` and
    ``model_dir``)."""
    from mggan_tpu_torch.models.torch_export import export_generator, to_cpu

    build_serving_fn(predictor, strategy, num)  # refuse before writing
    header = {
        "format": FORMAT,
        "wants_scene": predictor.g_spec.scene_dim > 0,
        "strategy": strategy,
        **(meta or {}),
        "scene_buckets": sorted({int(b) for b in scene_buckets}),
        "peds": int(peds),
        "num": int(num),
        "config": predictor.config.to_dict(),
    }
    buf = io.BytesIO()
    sd = export_generator(predictor.g_params, predictor.g_state, predictor.g_spec)
    torch.save({"generator": to_cpu(sd)}, buf)
    head = json.dumps(header).encode()
    Path(path).write_bytes(MAGIC + len(head).to_bytes(4, "big") + head + buf.getvalue())


def read_artifact(path):
    """``(header dict, generator state dict on the CPU)`` of an artifact."""
    data = Path(path).read_bytes()
    if data.startswith(JAX_MAGIC):
        raise ValueError(f"{path} is a JAX package artifact (jax.export StableHLO); load it "
                         "with mggan_tpu.cli.export, not with the PyTorch port")
    if not data.startswith(MAGIC):
        raise ValueError(f"{path} is not a {FORMAT} artifact")
    n = int.from_bytes(data[len(MAGIC):len(MAGIC) + 4], "big")
    start = len(MAGIC) + 4
    header = json.loads(data[start:start + n])
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: header format {header.get('format')!r} is not {FORMAT}")
    payload = torch.load(io.BytesIO(data[start + n:]), map_location="cpu", weights_only=True)
    return header, payload["generator"]


def load_artifact_predictor(path, device="cuda"):
    """``(Predictor, header)``: the artifact's generator rebuilt on
    ``device``."""
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import build_specs
    from mggan_tpu_torch.models.weights import generator_from_state_dict

    header, sd = read_artifact(path)
    config = Config.from_dict(header["config"])
    spec = build_specs(config)
    params, state = generator_from_state_dict(sd, spec, device=device)
    return Predictor(config, spec, params, state, device=device), header


def load_artifact_all(path, device="cuda"):
    """``({bucket: call}, header)``: one serving call over the artifact's
    rebuilt ``Predictor``, which serves every scene bucket it records."""
    predictor, header = load_artifact_predictor(path, device)
    serve = build_serving_fn(predictor, header["strategy"], header["num"])
    return dict.fromkeys(header["scene_buckets"], serve), header


def load_artifact(path, device="cuda"):
    """``(call, header)`` for the largest bucket."""
    calls, header = load_artifact_all(path, device)
    return calls[max(calls)], header


def get_arg_parser():
    p = ArgumentParser()
    p.add_argument("--model_dir", required=True, help="a version_* dir written by training")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--out", required=True)
    p.add_argument("--strategy", default="sampling", choices=EXPORTABLE)
    p.add_argument("--scenes", default="256",
                   help="max scenes per device call; a comma list (e.g. 1,8,64) "
                        "records one bucket per scene count: serving pads a request "
                        "only to the smallest bucket that fits")
    p.add_argument("--peds", type=int, default=16)
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="where the version dir is loaded: cuda (default) or cpu")
    return p


def main(argv=None):
    from mggan_tpu_torch.device import resolve_device
    from mggan_tpu_torch.training.loop import Trainer

    args = get_arg_parser().parse_args(argv)
    trainer, config = Trainer.load_from_path(Path(args.model_dir), args.checkpoint,
                                             device=resolve_device(args.device))
    buckets = sorted({int(s) for s in str(args.scenes).split(",")})
    save_artifact(trainer.predictor(), args.out, args.strategy, buckets, args.peds,
                  args.num, meta={"dataset": config.dataset,
                                  "model_dir": str(args.model_dir)})
    size = Path(args.out).stat().st_size
    print(f"exported {args.strategy} (S={buckets}, P={args.peds}, k={args.num}) -> "
          f"{args.out} ({size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
