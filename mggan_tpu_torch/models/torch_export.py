"""The port's ``(params, state)`` trees as reference-format PyTorch state
dicts (counterpart of ``mggan_tpu/models/torch_export.py``).

The inverse of ``models/weights.py::generator_from_state_dict`` and
``discriminator_from_state_dict``: the reference's key names and layouts
(standard.py / discriminators.py module tree, saved as abstract_train.py:
235-244 does, ``{"generator": ..., "discriminator": ...}``), plus a
test_tube-style ``meta_tags.csv`` version dir that the reference's
``PiNetMultiGeneratorGAN.load_from_path`` reads.

Layout (the port keeps the JAX layout):
* Linear (in, out) -> torch (out, in): transpose.
* LSTM (in, 4h) / (h, 4h), gate order (i, f, g, o) -> ``weight_*_l0``
  (4h, in): transpose.
* Conv HWIO -> OIHW: permute (3, 2, 0, 1).
* the stacked decoders (leading axis G) -> ``gs.{i}.*``; probgan's history
  heads -> ``discs_hist.{i}.*``.
* BN running statistics come from the state tree; ``num_batches_tracked``
  is 0.

The state dicts hold tensors taken from the trees where they live (views,
no copy through numpy); ``save_torch_checkpoint`` writes compact CPU
copies. Optimizer moments are not exported.
"""

from __future__ import annotations

import csv
from pathlib import Path

import torch


def _lin(p, prefix, out):
    out[f"{prefix}.weight"] = p["w"].T
    out[f"{prefix}.bias"] = p["b"]


def _lstm(p, prefix, out):
    out[f"{prefix}.weight_ih_l0"] = p["w_ih"].T
    out[f"{prefix}.weight_hh_l0"] = p["w_hh"].T
    out[f"{prefix}.bias_ih_l0"] = p["b_ih"]
    out[f"{prefix}.bias_hh_l0"] = p["b_hh"]


def _conv(p, prefix, out):
    out[f"{prefix}.weight"] = p["w"].permute(3, 2, 0, 1)
    out[f"{prefix}.bias"] = p["b"]


def _bn(params, state, prefix, out):
    out[f"{prefix}.weight"] = params["scale"]
    out[f"{prefix}.bias"] = params["bias"]
    out[f"{prefix}.running_mean"] = state["mean"]
    out[f"{prefix}.running_var"] = state["var"]
    out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                       device=state["mean"].device)


def _mlp(p, prefix, torch_indices, out):
    for i, ti in enumerate(torch_indices):
        _lin(p[f"lin{i}"], f"{prefix}.{ti}", out)


def _encoder(p, prefix, out):
    _lstm(p["lstm"], f"{prefix}.encoder", out)
    if "embed" in p:
        _lin(p["embed"], f"{prefix}.embedding", out)


def _scene_cnn(params, state, prefix, out):
    cnn = f"{prefix}.CNN.encoder"
    _conv(params["conv1"], f"{cnn}.ConvBlock_1.Block.Conv_1", out)
    _conv(params["conv2"], f"{cnn}.ConvBlock_2.Block.Conv_1", out)
    _mlp(params["attn"], f"{prefix}.cnn_attention", [0, 2], out)
    _bn(params["bn1"], state["bn1"], f"{cnn}.ConvBlock_1.Block.BN_1", out)
    _bn(params["bn2"], state["bn2"], f"{cnn}.ConvBlock_2.Block.BN_1", out)


def _social(p, prefix, pool_type, out):
    if pool_type == "sways":
        _mlp(p["embed"], f"{prefix}.feature_embedder.fc", [0, 2, 4], out)
        _lin(p["w"], f"{prefix}.attention.W", out)
    else:
        _lin(p["spatial"], f"{prefix}.spatial_embedding", out)
        _mlp(p["pre_pool"], f"{prefix}.mlp_pre_pool", [0, 2], out)


def _decoder(p, prefix, out):
    _lin(p["spatial_embedding"], f"{prefix}.spatial_embedding", out)
    _lstm(p["lstm"], f"{prefix}.decoder", out)
    _mlp(p["hidden2pos"], f"{prefix}.hidden2pos", [0, 2], out)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def export_generator(params, state, spec) -> dict:
    """``(params, state)`` -> the reference ``generator`` state dict."""
    out = {}
    _encoder(params["encoder"], "encoder", out)
    if "scene" in params:
        _scene_cnn(params["scene"], state["scene"], "scene_encoder", out)
    if "social" in params:
        _social(params["social"], "social", spec.pool_type, out)
    if spec.discrete:
        _decoder(params["decoder"], "decoder", out)
        _mlp(params["one_hot_sample_encoder"], "one_hot_sample_encoder", [0, 2], out)
    else:
        for i in range(spec.num_gens):
            _decoder(_unstack(params["decoders"], i), f"gs.{i}", out)
    _mlp(params["enc_to_dec"], "enc_h_to_dec_h", [0], out)
    _mlp(params["net_chooser"], "net_chooser", [0, 2, 4], out)
    out["net_prior"] = params["net_prior"]
    return out


def export_discriminator(params, state, spec) -> dict:
    """``(params, state)`` -> the reference ``discriminator`` state dict."""
    out = {}
    _encoder(params["in_encoder"], "in_encoder", out)
    _mlp(params["in_fc"], "in_encoder_fc", [0, 2], out)
    _mlp(params["pred_encoder"], "pred_encoder", [0, 2], out)
    if "social" in params:
        _social(params["social"], "social", spec.pool_type, out)
    if "scene" in params:
        _scene_cnn(params["scene"], state["scene"], "scene_encoder", out)
    for i in range(spec.num_discs):
        _mlp(_unstack(params["discs"], i), f"discs.{i}", [0, 2], out)
    if spec.gan_type == "mgan":
        _mlp(params["branch"], "gen_id_reconstructor", [0, 2], out)
    elif spec.gan_type == "infogan":
        _mlp(params["branch"], "code_reconstructor", [0, 2], out)
    if spec.gan_type == "probgan" and "hist" in state:
        for i in range(spec.num_discs):
            _mlp(_unstack(state["hist"]["discs"], i), f"discs_hist.{i}", [0, 2], out)
    return out


def to_cpu(sd: dict) -> dict:
    """Compact CPU copies of a state dict's tensors (a view of a stacked or
    transposed leaf is saved as its own storage)."""
    return {k: v.detach().to("cpu").clone(memory_format=torch.contiguous_format)
            for k, v in sd.items()}


def save_torch_checkpoint(path, g_sd: dict, d_sd: dict):
    """Write the two state dicts as a reference ``checkpoint_*.pth``."""
    torch.save({"generator": to_cpu(g_sd), "discriminator": to_cpu(d_sd)}, path)


def export_version_dir(out_dir, config, g_spec, d_spec, state, version=0,
                       checkpoint_name="checkpoint_best"):
    """Write ``<out_dir>/<config.name>/version_<version>/{meta_tags.csv,
    checkpoints/<checkpoint_name>.pth}``, the layout the reference's
    ``load_from_path`` resolves (abstract_train.py:251-253). Returns the
    version dir."""
    vdir = Path(out_dir) / config.name / f"version_{version}"
    (vdir / "checkpoints").mkdir(parents=True, exist_ok=True)
    with open(vdir / "meta_tags.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["key", "value"])
        for k, v in config.to_dict().items():
            w.writerow([k, v])
    g_sd = export_generator(state.g_params, state.g_state, g_spec)
    d_sd = export_discriminator(state.d_params, state.d_state, d_spec)
    save_torch_checkpoint(vdir / "checkpoints" / f"{checkpoint_name}.pth", g_sd, d_sd)
    return vdir
