"""Every place where the benchmark touches the measured program
(``mggan_tpu_torch``): its configuration, its weight loaders, the trainer,
loader and patch bank the train runner drives, the predictor the
sampling runner drives, and the layout of its parameter trees, read only to judge
them. The program is imported inside these functions, after the
harness's checks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import scenes


def config(cfg: dict):
    """The program's ``Config`` for a configuration file's ``config``."""
    from mggan_tpu_torch.config import Config

    return Config(**{k: v for k, v in cfg.items() if k != "dtype"})


def host_state_dict(sd: dict) -> dict:
    """A state dict's entries as numpy arrays, copied from the device once."""
    keys = list(sd)
    flat = torch.cat([sd[k].reshape(-1).float() for k in keys]).cpu().numpy()
    out, pos = {}, 0
    for k in keys:
        n = sd[k].numel()
        out[k] = flat[pos: pos + n].reshape(tuple(sd[k].shape))
        pos += n
    return out


def load_generator(cfg, g_sd_host: dict, device):
    """``(params, state, spec)`` of the program's generator, loaded from a
    reference-layout state dict by the program's own loader."""
    from mggan_tpu_torch.models.factory import build_specs
    from mggan_tpu_torch.models.weights import generator_from_state_dict

    spec = build_specs(cfg)
    params, state = generator_from_state_dict(g_sd_host, spec, device=device)
    return params, state, spec


def load_discriminator(cfg, d_sd_host: dict, device):
    from mggan_tpu_torch.models.factory import build_d_spec
    from mggan_tpu_torch.models.weights import discriminator_from_state_dict

    spec = build_d_spec(cfg)
    params, state = discriminator_from_state_dict(d_sd_host, spec, device=device)
    return params, state, spec


class Draws:
    """The trainer's random numbers, drawn by the benchmark from its seed:
    the augmentation of each batch and every draw of each step, in the
    shapes the program's step takes. The first ``keep`` of each are kept,
    so the reference gets the same numbers."""

    def __init__(self, cfg: dict, device, seed: int, keep: int):
        self.cfg, self.keep = cfg, keep
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.kept_aug, self.kept_steps = [], []

    def aug(self, epoch: int, i: int, s: int):
        dev = self.gen.device
        flip = torch.randint(0, 3, (s,), generator=self.gen, device=dev)
        alpha = torch.rand((s,), generator=self.gen, device=dev) * (2.0 * math.pi)
        if len(self.kept_aug) < self.keep:
            self.kept_aug.append((flip, alpha))
        return flip, alpha

    def step(self, state, s: int, p: int):
        gen, dev, cfg = self.gen, self.gen.device, self.cfg
        g, z, k = cfg["num_gens"], cfg["noise_dim"], cfg["num_samples"]
        uniforms = lambda n: 1e-20 + torch.rand((n, s, p, g), generator=gen,  # noqa: E731
                                                device=dev) * (1.0 - 1e-20)
        noise = lambda n: torch.randn((n, s, 1, z), generator=gen, device=dev)  # noqa: E731

        def labels():
            u = torch.rand(2, generator=gen, device=dev)
            return torch.stack([0.9 + 0.1 * u[0], 0.1 * u[1]])

        draws = {"d_labels": labels()[None], "d_uniforms": uniforms(1)[None],
                 "d_z": noise(1)[None], "g_labels": labels(), "g_uniforms": uniforms(k),
                 "g_z": noise(k), "pm_z": noise(cfg["num_expectation_samples"])}
        if len(self.kept_steps) < self.keep:
            self.kept_steps.append(draws)
        return draws


def scene_dataset(traffic: dict, xy: np.ndarray, sizes: np.ndarray, scene: np.ndarray,
                  big: np.ndarray):
    """The program's ``SceneDataset`` over the benchmark's scenes: each
    window's real agents' tracks and crops (views of the host arrays)."""
    from mggan_tpu_torch.data.dataset import SceneDataset

    names = [f"scene{i}" for i in range(len(traffic["extent_m"]))]
    images = {name: {"ratio": 1.0, "small": np.zeros((h, w, 3), np.uint8)}
              for name, (h, w) in zip(names, scenes.scene_extent_px(traffic))}
    n = len(sizes)
    return SceneDataset(
        dataset_name="portbench", trajectories=[xy[i, :sizes[i]] for i in range(n)],
        scene_names=[names[j] for j in scene], images=images,
        big_patches=[big[i, :sizes[i]] for i in range(n)], format="meter",
        px_per_meter=traffic["px_per_meter"], ped_ids=[np.arange(c) for c in sizes])


def train_loader(traffic: dict, ds, seed: int, device):
    """The program's shuffling, augmenting loader with its device patch
    bank."""
    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.data.patch_bank import maybe_build_bank

    bank = maybe_build_bank(ds, traffic["max_peds"], device=device)
    if bank is None:
        raise RuntimeError("the patch bank did not fit the program's budget")
    return PaddedBatcher(ds, batch_size=traffic["batch_scenes"], max_peds=traffic["max_peds"],
                         shuffle=True, seed=seed, patch_bank=bank, augment=True)


def trainer(cfg_obj, g, d, draws, device, seed: int):
    """The program's ``Trainer`` with the benchmark's weights and draws."""
    from mggan_tpu_torch.training.loop import Trainer
    from mggan_tpu_torch.training.state import init_train_state

    tr = Trainer(cfg_obj, None, device=device, draws=draws)
    tr.state = init_train_state(cfg_obj, g, d, seed=seed)
    return tr


def predictor(cfg_obj, g, device):
    from mggan_tpu_torch.eval.predict import Predictor

    params, state, spec = g
    return Predictor(cfg_obj, spec, params, state, device=device)


# ------------------------------------------------ the parameter trees' layout
_SCENE = {"Conv_1.weight": ("conv", "w"), "Conv_1.bias": ("conv", "b"),
          "BN_1.weight": ("bn", "scale"), "BN_1.bias": ("bn", "bias")}
_LSTM = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh", "bias_ih_l0": "b_ih",
         "bias_hh_l0": "b_hh"}
_TOP = {"encoder": "encoder", "in_encoder": "in_encoder", "in_encoder_fc": "in_fc",
        "pred_encoder": "pred_encoder", "social": "social", "scene_encoder": "scene",
        "enc_h_to_dec_h": "enc_to_dec", "net_chooser": "net_chooser",
        "gen_id_reconstructor": "branch"}


def _lin(tree, index: str, leaf: str):
    return tree[f"lin{int(index) // 2}"]["w" if leaf == "weight" else "b"]


def program_leaf(tree: dict, key: str) -> torch.Tensor:
    """The program's parameter (JAX layout, possibly transposed) behind a
    reference-layout key; norms are the same in either layout."""
    parts = key.split(".")
    if key == "net_prior":
        return tree["net_prior"]
    if parts[0] == "gs":  # one generator of the stacked decoders
        g, sub, rest = int(parts[1]), parts[2], parts[3:]
        dec = tree["decoders"]
        if sub == "spatial_embedding":
            return dec["spatial_embedding"]["w" if rest[0] == "weight" else "b"][g]
        if sub == "decoder":
            return dec["lstm"][_LSTM[rest[0]]][g]
        return _lin(dec["hidden2pos"], rest[0], rest[1])[g]
    if parts[0] == "discs":
        return _lin(tree["discs"], parts[2], parts[3])[int(parts[1])]
    top = tree[_TOP[parts[0]]]
    rest = parts[1:]
    if parts[0] in ("encoder", "in_encoder"):
        if rest[0] == "embedding":
            return top["embed"]["w" if rest[1] == "weight" else "b"]
        return top["lstm"][_LSTM[rest[1]]]
    if parts[0] == "social":
        if rest[0] == "attention":
            return top["w"]["w" if rest[2] == "weight" else "b"]
        return _lin(top["embed"], rest[2], rest[3])
    if parts[0] == "scene_encoder":
        if rest[0] == "cnn_attention":
            return _lin(top["attn"], rest[1], rest[2])
        block = rest[2][-1]  # ConvBlock_<i>
        kind, leaf = _SCENE[".".join(rest[4:])]
        return top[f"{kind}{block}"][leaf]
    return _lin(top, rest[0], rest[1])
