"""Serving export (counterpart of ``mggan_tpu/cli/export.py``): a trained
version dir becomes one artifact of ``torch.export`` programs, one per scene
bucket, with the parameters baked in as constants. The artifact is served
with ``torch`` and the port's kernel operators alone, WITHOUT the model
code:

    python -m mggan_tpu_torch.cli.export --model_dir logs/.../version_1 \
        --out model.mgtorch --scenes 1,8,64 --peds 16 --num 20

    calls, meta = load_artifact_all("model.mgtorch", device="cuda")
    pred_abs = calls[64](xy, ped_mask, patches, seed)

The programs trace ``serving/runtime.py::ServingProgram``: the encoder, the
PM net, the selection and the weight folding as ATen operators, the rollout
as one ``mggan::decode_select`` (K1, ``sampling``) or ``mggan::decode_all_fwd``
(K2, the other strategies) node (``ops/kernels/library.py``), which runs the
CUDA kernel on the card and the plain version on the CPU. A program takes
``(xy, ped_mask, patches, *draws)`` and holds no generator: the call around
it (``load_artifact_all``) turns ``seed`` into the draws with a
``torch.Generator`` on the serving device, in the order and shapes in which
the live ``Predictor`` draws them (``runtime.py::draw_specs``), so at one
seed the artifact and the live model give the same tensor. ``draws=``
injects them instead.

The file: the port's magic, a JSON header (the JAX header's
``wants_scene``, ``strategy``, ``dataset`` and ``model_dir``, plus
``scene_buckets``, ``peds``, ``num``, the ``config`` dict, each bucket's
``draws`` as ``[name, dist, shape]``, the ``device`` traced on, the
``torch`` version and the ``payload_lengths``), then each bucket's
``torch.export.save`` payload. Loading on another device than the traced
one moves the programs there (``torch.export.passes.move_to_device_pass``):
a card artifact then runs the CPU implementations, as asked. An artifact is
read by the torch version that wrote it. A JAX ``.jaxexport`` file and a
``mggan_tpu_torch.artifact/1`` file (weights, not programs) are refused.

Inputs of a call: xy (S,P,20,2) f32 (observed 8 steps used), ped_mask
(S,P) bool, patches (S,P,33,33,4) f32, seed int. Output: pred_abs (num, S,
P, 12, 2) on the artifact's device.
"""

from __future__ import annotations

import io
import json
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

MAGIC = b"MGTORCH1\n"
JAX_MAGIC = b"MGEX1\n"  # mggan_tpu/cli/export.py's artifact container
FORMAT = "mggan_tpu_torch.artifact/2"
FORMAT_WEIGHTS = "mggan_tpu_torch.artifact/1"  # weights and a header; refused


def export_predictor(predictor, strategy: str, scenes: int, peds: int, num: int):
    """``torch.export`` the serving function of ``predictor`` for fixed
    shapes on the predictor's device -> ``torch.export.ExportedProgram``."""
    from mggan_tpu_torch.config import PATCH_C, PATCH_HW, SEQ_LEN
    from mggan_tpu_torch.serving.runtime import ServingProgram, draw_specs

    module = ServingProgram(predictor, strategy, num)
    zeros = lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype,
                                                           device=predictor.device)
    args = (zeros((scenes, peds, SEQ_LEN, 2)), zeros((scenes, peds), torch.bool),
            zeros((scenes, peds, PATCH_HW, PATCH_HW, PATCH_C)),
            *(zeros(shape) for _, _, shape in draw_specs(strategy, predictor.config, scenes,
                                                         peds, num)))
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    program.example_inputs = None  # zeros of the bucket's shapes; not worth storing
    return program


def save_artifact(predictor, path, strategy: str, scene_buckets, peds: int, num: int,
                  meta: dict | None = None):
    """Export ``predictor`` at every bucket of ``scene_buckets`` and write
    the artifact at ``path``; ``meta``: extra header keys (the CLI adds
    ``dataset`` and ``model_dir``). Returns each bucket's export seconds.
    Raises for a strategy outside ``EXPORTABLE`` before writing."""
    import time

    from mggan_tpu_torch.serving.runtime import draw_specs

    buckets = sorted({int(b) for b in scene_buckets})
    payloads, seconds = [], {}
    for s in buckets:
        t0 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(export_predictor(predictor, strategy, s, peds, num), buf)
        payloads.append(buf.getvalue())
        seconds[s] = time.perf_counter() - t0
    header = {
        "format": FORMAT,
        "wants_scene": predictor.g_spec.scene_dim > 0,
        "strategy": strategy,
        **(meta or {}),
        "scene_buckets": buckets,
        "peds": int(peds),
        "num": int(num),
        "config": predictor.config.to_dict(),
        "draws": {str(s): [[n, d, list(shape)] for n, d, shape in
                           draw_specs(strategy, predictor.config, s, peds, num)]
                  for s in buckets},
        "device": str(predictor.device),
        "torch": torch.__version__,
        "payload_lengths": [len(b) for b in payloads],
    }
    head = json.dumps(header).encode()
    Path(path).write_bytes(MAGIC + len(head).to_bytes(4, "big") + head + b"".join(payloads))
    return seconds


def read_artifact(path):
    """``(header dict, [each bucket's torch.export.save payload])``."""
    data = Path(path).read_bytes()
    if data.startswith(JAX_MAGIC):
        raise ValueError(f"{path} is a JAX package artifact (jax.export StableHLO); load it "
                         "with mggan_tpu.cli.export, not with the PyTorch port")
    if not data.startswith(MAGIC):
        raise ValueError(f"{path} is not a {FORMAT} artifact")
    n = int.from_bytes(data[len(MAGIC):len(MAGIC) + 4], "big")
    start = len(MAGIC) + 4
    header = json.loads(data[start:start + n])
    if header.get("format") == FORMAT_WEIGHTS:
        raise ValueError(
            f"{path} is a {FORMAT_WEIGHTS} artifact (weights, not programs); re-export it: "
            f"python -m mggan_tpu_torch.cli.export --model_dir "
            f"{header.get('model_dir', '<version dir>')} --out {path} --strategy "
            f"{header.get('strategy', 'sampling')} --scenes "
            f"{','.join(map(str, header.get('scene_buckets', [256])))}")
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: header format {header.get('format')!r} is not {FORMAT}")
    payloads, off = [], start + n
    for ln in header["payload_lengths"]:
        payloads.append(data[off:off + ln])
        off += ln
    return header, payloads


def draws_from_seed(specs, seed: int, device):
    """The draws of ``specs`` (``[name, dist, shape]``, in draw order) from
    a ``torch.Generator`` on ``device`` seeded with ``seed``: what the live
    ``Predictor`` draws at that seed."""
    from mggan_tpu_torch.ops.sampling import GUMBEL_U_MIN

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for _, dist, shape in specs:
        if dist == "normal":
            out.append(torch.randn(shape, generator=gen, device=device))
        else:
            r = torch.rand(shape, generator=gen, device=device)
            out.append(GUMBEL_U_MIN + r * (1.0 - GUMBEL_U_MIN))
    return out


def _on(x, device):
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)


def program_call(program, specs, device):
    """``(xy, ped_mask, patches, seed, draws=None) -> pred_abs`` over one
    loaded program (the call's ``program``); ``draws`` (a dict by name)
    replaces the seed's."""
    names = [name for name, _, _ in specs]

    def call(xy, ped_mask, patches, seed, draws=None):
        rand = (draws_from_seed(specs, seed, device) if draws is None
                else [_on(draws[name], device) for name in names])
        with torch.no_grad():
            return program(_on(xy, device), _on(ped_mask, device), _on(patches, device),
                           *rand)

    call.program = program
    return call


def load_artifact_all(path, device="cuda"):
    """``({bucket: call}, header)``: every bucket program of the artifact on
    ``device``, moved there when it was traced elsewhere. Needs ``torch``
    and the kernel operators (``ops/kernels/library.py``) alone."""
    from torch.export.passes import move_to_device_pass

    from mggan_tpu_torch.device import resolve_device
    from mggan_tpu_torch.ops.kernels import library  # noqa: F401  registers mggan::*

    dev = resolve_device(device)
    header, payloads = read_artifact(path)
    traced_on = torch.device(header["device"])
    calls = {}
    for s, payload in zip(header["scene_buckets"], payloads):
        ep = torch.export.load(io.BytesIO(payload))
        if traced_on != dev:
            ep = move_to_device_pass(ep, dev)
        calls[s] = program_call(ep.module(), header["draws"][str(s)], dev)
    return calls, header


def load_artifact(path, device="cuda"):
    """``(call, header)`` for the largest bucket."""
    calls, header = load_artifact_all(path, device)
    return calls[max(calls)], header


def get_arg_parser():
    from mggan_tpu_torch.serving.runtime import EXPORTABLE

    p = ArgumentParser()
    p.add_argument("--model_dir", required=True, help="a version_* dir written by training")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--out", required=True)
    p.add_argument("--strategy", default="sampling", choices=EXPORTABLE)
    p.add_argument("--scenes", default="256",
                   help="max scenes per device call; a comma list (e.g. 1,8,64) "
                        "exports one program per scene-count bucket: serving pads a "
                        "request only to the smallest bucket that fits")
    p.add_argument("--peds", type=int, default=16)
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="where the version dir is loaded and the programs are traced: "
                        "cuda (default) or cpu")
    return p


def main(argv=None):
    from mggan_tpu_torch.device import resolve_device
    from mggan_tpu_torch.training.loop import Trainer

    args = get_arg_parser().parse_args(argv)
    trainer, config = Trainer.load_from_path(Path(args.model_dir), args.checkpoint,
                                             device=resolve_device(args.device))
    buckets = sorted({int(s) for s in str(args.scenes).split(",")})
    predictor = trainer.predictor()
    seconds = save_artifact(predictor, args.out, args.strategy, buckets, args.peds,
                            args.num, meta={"dataset": config.dataset,
                                            "model_dir": str(args.model_dir)})
    size = Path(args.out).stat().st_size
    print(f"exported {args.strategy} (S={buckets}, P={args.peds}, k={args.num}) on "
          f"{predictor.device} -> {args.out} ({size / 1e6:.2f} MB; export s per bucket "
          f"{ {s: round(t, 2) for s, t in seconds.items()} })")
    return seconds


if __name__ == "__main__":
    main()
