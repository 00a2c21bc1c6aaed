"""Weights from the JAX package or from reference-format state dicts.

``generator_from_jax`` takes the JAX generator's ``(params, state)`` trees
as nested dicts of numpy arrays (the JAX layout, which the port keeps).
``generator_from_state_dict`` takes the reference PyTorch layout with the
reference key names (what ``mggan_tpu/models/torch_export.py`` writes) and
requires exactly the keys the spec implies.
"""

from __future__ import annotations

import numpy as np
import torch

from mggan_tpu_torch.device import resolve_device


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def _check_keys(tree, expected, where):
    if set(tree) != set(expected):
        raise KeyError(f"{where}: keys {sorted(tree)} != expected {sorted(expected)}")


def generator_from_jax(np_params, np_state, spec, device="cuda"):
    """JAX generator trees (numpy leaves) -> the port's ``(params, state)``."""
    expected = {"encoder", "decoders", "enc_to_dec", "net_chooser", "net_prior"}
    if spec.scene_dim > 0:
        expected.add("scene")
    if spec.social_feat_size > 0:
        expected.add("social")
    _check_keys(np_params, expected, "generator params")
    dev = resolve_device(device)
    return _to_tensors(np_params, dev), _to_tensors(np_state, dev)


# ------------------------------------------------------ reference layout --
class _Reader:
    """Pops reference-format entries, undoing the export's layout changes."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}

    def take(self, key):
        return self.sd.pop(key)

    def lin(self, prefix):
        return {"w": self.take(f"{prefix}.weight").T, "b": self.take(f"{prefix}.bias")}

    def mlp(self, prefix, torch_indices):
        return {f"lin{i}": self.lin(f"{prefix}.{ti}") for i, ti in enumerate(torch_indices)}

    def lstm(self, prefix):
        return {
            "w_ih": self.take(f"{prefix}.weight_ih_l0").T,
            "w_hh": self.take(f"{prefix}.weight_hh_l0").T,
            "b_ih": self.take(f"{prefix}.bias_ih_l0"),
            "b_hh": self.take(f"{prefix}.bias_hh_l0"),
        }

    def conv(self, prefix):
        return {"w": self.take(f"{prefix}.weight").transpose(2, 3, 1, 0),
                "b": self.take(f"{prefix}.bias")}

    def bn(self, prefix):
        self.take(f"{prefix}.num_batches_tracked")
        params = {"scale": self.take(f"{prefix}.weight"),
                  "bias": self.take(f"{prefix}.bias")}
        state = {"mean": self.take(f"{prefix}.running_mean"),
                 "var": self.take(f"{prefix}.running_var")}
        return params, state


def generator_from_state_dict(sd, spec, device="cuda"):
    """Reference-format generator state dict -> ``(params, state)``.

    Strict: every key the spec implies must be present and no other.
    """
    r = _Reader(sd)
    params = {"encoder": {"lstm": r.lstm("encoder.encoder")}}
    if "encoder.embedding.weight" in r.sd:
        params["encoder"]["embed"] = r.lin("encoder.embedding")
    state = {}
    if spec.scene_dim > 0:
        cnn = "scene_encoder.CNN.encoder"
        scene = {
            "conv1": r.conv(f"{cnn}.ConvBlock_1.Block.Conv_1"),
            "conv2": r.conv(f"{cnn}.ConvBlock_2.Block.Conv_1"),
            "attn": r.mlp("scene_encoder.cnn_attention", [0, 2]),
        }
        scene["bn1"], bn1 = r.bn(f"{cnn}.ConvBlock_1.Block.BN_1")
        scene["bn2"], bn2 = r.bn(f"{cnn}.ConvBlock_2.Block.BN_1")
        params["scene"], state["scene"] = scene, {"bn1": bn1, "bn2": bn2}
    if spec.social_feat_size > 0:
        params["social"] = {"embed": r.mlp("social.feature_embedder.fc", [0, 2, 4]),
                            "w": r.lin("social.attention.W")}
    gens = [
        {"spatial_embedding": r.lin(f"gs.{i}.spatial_embedding"),
         "lstm": r.lstm(f"gs.{i}.decoder"),
         "hidden2pos": r.mlp(f"gs.{i}.hidden2pos", [0, 2])}
        for i in range(spec.num_gens)
    ]
    params["decoders"] = _stack(gens)
    params["enc_to_dec"] = r.mlp("enc_h_to_dec_h", [0])
    params["net_chooser"] = r.mlp("net_chooser", [0, 2, 4])
    params["net_prior"] = r.take("net_prior")
    if r.sd:
        raise KeyError(f"unexpected keys in generator state dict: {sorted(r.sd)}")
    dev = resolve_device(device)
    return _to_tensors(params, dev), _to_tensors(state, dev)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
