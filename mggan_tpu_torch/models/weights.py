"""Weights from the JAX package or from reference-format state dicts.

``generator_from_jax``/``discriminator_from_jax`` take the JAX model's
``(params, state)`` trees as nested dicts of numpy arrays (the JAX layout,
which the port keeps). ``generator_from_state_dict`` and
``discriminator_from_state_dict`` take the reference PyTorch layout with
the reference key names (what ``mggan_tpu/models/torch_export.py`` writes)
and require exactly the keys the spec implies.
"""

from __future__ import annotations

import numpy as np
import torch

from mggan_tpu_torch.device import resolve_device


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    # contiguous: a transposed reference weight would keep its strides, and
    # a strided weight takes another matmul path than the live tree's
    return torch.tensor(np.ascontiguousarray(tree, dtype=np.float32), device=device)


def _check_keys(tree, expected, where):
    if set(tree) != set(expected):
        raise KeyError(f"{where}: keys {sorted(tree)} != expected {sorted(expected)}")


def generator_from_jax(np_params, np_state, spec, device="cuda"):
    """JAX generator trees (numpy leaves) -> the port's ``(params, state)``."""
    expected = {"encoder", "enc_to_dec", "net_chooser", "net_prior"}
    expected |= ({"decoder", "one_hot_sample_encoder"} if spec.discrete else {"decoders"})
    if spec.scene_dim > 0:
        expected.add("scene")
    if spec.social_feat_size > 0:
        expected.add("social")
    _check_keys(np_params, expected, "generator params")
    dev = resolve_device(device)
    return _to_tensors(np_params, dev), _to_tensors(np_state, dev)


def discriminator_from_jax(np_params, np_state, spec, device="cuda"):
    """JAX discriminator trees (numpy leaves) -> the port's ``(params, state)``."""
    expected = {"in_encoder", "in_fc", "pred_encoder", "discs"}
    if spec.global_disc:
        expected.add("social")
    if spec.scene_dim > 0:
        expected.add("scene")
    if spec.gan_type in ("mgan", "infogan"):
        expected.add("branch")
    _check_keys(np_params, expected, "discriminator params")
    state_keys = {"scene"} if spec.scene_dim > 0 else set()
    if spec.gan_type == "probgan":
        state_keys.add("hist")
        _check_keys(np_state["hist"], {"discs", "len"}, "discriminator hist")
    _check_keys(np_state, state_keys, "discriminator state")
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

    def scene(self, prefix):
        """The scene CNN's ``(params, state)`` under ``prefix``."""
        cnn = f"{prefix}.CNN.encoder"
        params = {
            "conv1": self.conv(f"{cnn}.ConvBlock_1.Block.Conv_1"),
            "conv2": self.conv(f"{cnn}.ConvBlock_2.Block.Conv_1"),
            "attn": self.mlp(f"{prefix}.cnn_attention", [0, 2]),
        }
        params["bn1"], bn1 = self.bn(f"{cnn}.ConvBlock_1.Block.BN_1")
        params["bn2"], bn2 = self.bn(f"{cnn}.ConvBlock_2.Block.BN_1")
        return params, {"bn1": bn1, "bn2": bn2}

    def social(self, prefix, pool_type):
        if pool_type == "sways":
            return {"embed": self.mlp(f"{prefix}.feature_embedder.fc", [0, 2, 4]),
                    "w": self.lin(f"{prefix}.attention.W")}
        return {"spatial": self.lin(f"{prefix}.spatial_embedding"),
                "pre_pool": self.mlp(f"{prefix}.mlp_pre_pool", [0, 2])}

    def decoder(self, prefix):
        return {"spatial_embedding": self.lin(f"{prefix}.spatial_embedding"),
                "lstm": self.lstm(f"{prefix}.decoder"),
                "hidden2pos": self.mlp(f"{prefix}.hidden2pos", [0, 2])}

    def encoder(self, prefix):
        params = {"lstm": self.lstm(f"{prefix}.encoder")}
        if f"{prefix}.embedding.weight" in self.sd:
            params["embed"] = self.lin(f"{prefix}.embedding")
        return params

    def finish(self, what, params, state, device):
        if self.sd:
            raise KeyError(f"unexpected keys in {what} state dict: {sorted(self.sd)}")
        dev = resolve_device(device)
        return _to_tensors(params, dev), _to_tensors(state, dev)


def generator_from_state_dict(sd, spec, device="cuda"):
    """Reference-format generator state dict -> ``(params, state)``.

    Strict: every key the spec implies must be present and no other.
    """
    r = _Reader(sd)
    params = {"encoder": r.encoder("encoder")}
    state = {}
    if spec.scene_dim > 0:
        params["scene"], state["scene"] = r.scene("scene_encoder")
    if spec.social_feat_size > 0:
        params["social"] = r.social("social", spec.pool_type)
    if spec.discrete:
        params["decoder"] = r.decoder("decoder")
        params["one_hot_sample_encoder"] = r.mlp("one_hot_sample_encoder", [0, 2])
    else:
        params["decoders"] = _stack([r.decoder(f"gs.{i}") for i in range(spec.num_gens)])
    params["enc_to_dec"] = r.mlp("enc_h_to_dec_h", [0])
    params["net_chooser"] = r.mlp("net_chooser", [0, 2, 4])
    params["net_prior"] = r.take("net_prior")
    return r.finish("generator", params, state, device)


def discriminator_from_state_dict(sd, spec, device="cuda"):
    """Reference-format discriminator state dict -> ``(params, state)``.

    Strict: every key the spec implies must be present and no other. A
    probgan D's history heads are ``discs_hist.{i}``; the state dict holds
    no history length, so it restarts at 1, as the JAX import does
    (``torch_import.py:148-154``).
    """
    r = _Reader(sd)
    params = {
        "in_encoder": r.encoder("in_encoder"),
        "in_fc": r.mlp("in_encoder_fc", [0, 2]),
        "pred_encoder": r.mlp("pred_encoder", [0, 2]),
    }
    state = {}
    if spec.global_disc:
        params["social"] = r.social("social", spec.pool_type)
    if spec.scene_dim > 0:
        params["scene"], state["scene"] = r.scene("scene_encoder")
    params["discs"] = _stack([r.mlp(f"discs.{i}", [0, 2])
                              for i in range(spec.num_discs)])
    if spec.gan_type == "mgan":
        params["branch"] = r.mlp("gen_id_reconstructor", [0, 2])
    elif spec.gan_type == "infogan":
        params["branch"] = r.mlp("code_reconstructor", [0, 2])
    if spec.gan_type == "probgan":
        state["hist"] = {"discs": _stack([r.mlp(f"discs_hist.{i}", [0, 2])
                                          for i in range(spec.num_discs)]),
                         "len": np.asarray(1.0, np.float32)}
    return r.finish("discriminator", params, state, device)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
