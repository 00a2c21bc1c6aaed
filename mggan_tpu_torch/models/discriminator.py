"""Trajectory discriminator (counterpart of ``mggan_tpu/models/discriminator.py``;
reference discriminators.py:12-263).

Scores K candidate futures per agent: history encoder + ``in_fc``, future
MLP (zeroed for agents without a valid future), the global social context
over the K samples (sways attention or SGAN pooling; none with
``global_disc=0``), the 8-channel scene CNN, and an ensemble of heads,
squashed into ``(EPS_D, 1 - EPS_D)`` for the NS and MM objectives and
unbounded for LS and W (``unbound_output``). Per ``gan_type``:

* mgan: a ``branch`` head classifies which generator made each sample;
* infogan: a ``branch`` head regresses the first 3 noise dimensions;
* probgan: 5 heads, and the Polyak-averaged history copy of them in the
  state (``state["hist"] = {"discs": heads, "len": 0-d tensor}``), scored
  with ``apply(..., use_hist=True)`` and averaged in by ``update_hist``;
* gan: the heads alone.

``inp_format="abs_rel"`` raises in ``apply`` as the JAX and the reference
D do (the 8-step positions and 7-step offsets cannot be concatenated;
PARITY.md deviation 8). Parameters keep the JAX layout; the heads are one
tree with a leading head axis. Everything here is plain PyTorch (no
kernel), so autograd can take the W gradient penalty's double backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops import social as social_ops
from mggan_tpu_torch.ops.cnn import scene_cnn_apply, scene_cnn_apply_train, scene_cnn_init
from mggan_tpu_torch.ops.linear import linear_init, mlp_apply_per_layer, mlp_init
from mggan_tpu_torch.ops.losses import EPS_D
from mggan_tpu_torch.utils.pytree import tree_map

ACTS = ["leaky_relu_02", "none"]


@dataclass(frozen=True)
class DiscriminatorSpec:
    h_dim: int  # already doubled by the factory (= config.h_dim * 2)
    inp_format: str
    pred_len: int
    num_discs: int
    num_gens: int
    gan_type: str
    global_disc: bool
    scene_dim: int
    pool_type: str
    unbound_output: bool

    @property
    def classifier_dim(self) -> int:
        d = self.h_dim * (2 if self.global_disc else 1)
        return d + self.scene_dim


def init(spec: DiscriminatorSpec, generator: torch.Generator):
    """Build ``(params, state)`` from ``generator``'s draws, on its device."""
    gen, h = generator, spec.h_dim
    inp = common.input_size(spec.inp_format)
    params = {
        "in_encoder": common.trajectory_encoder_init(gen, inp, h, h),
        "in_fc": mlp_init(gen, [h, h // 2, h // 2]),
        "pred_encoder": mlp_init(gen, [spec.pred_len * inp, h, h // 2]),
    }
    state = {}
    if spec.global_disc and spec.pool_type == "sways":
        params["social"] = {"embed": mlp_init(gen, [3, 32, 64, h]),
                            "w": linear_init(gen, h, h)}
    elif spec.global_disc:
        # PoolHiddenNet(embedding_dim=16, ...) (discriminators.py:62-67)
        params["social"] = {"spatial": linear_init(gen, 2, 16),
                            "pre_pool": mlp_init(gen, [16 + h, h, h])}
    if spec.scene_dim > 0:
        params["scene"], state["scene"] = scene_cnn_init(gen, channels_cnn=8)
    cd = spec.classifier_dim
    params["discs"] = common.stack_trees(
        [mlp_init(gen, [cd, cd // 2, 1]) for _ in range(spec.num_discs)])
    if spec.gan_type == "mgan":
        params["branch"] = mlp_init(gen, [cd, cd // 2, spec.num_gens])
    elif spec.gan_type == "infogan":
        params["branch"] = mlp_init(gen, [cd, cd // 2, 3])
    if spec.gan_type == "probgan":
        state["hist"] = {"discs": tree_map(torch.clone, params["discs"]),
                         "len": torch.tensor(1.0, device=gen.device)}
    return params, state


def _classifier_input(params, spec, in_xy, in_dxdy, pred_xy, pred_dxdy,
                      ped_mask, future_valid, patches, state, train):
    """Shared encoding path (discriminators.py:113-196) -> ``(K,S,P,CD)``
    and the new BN state."""
    if spec.inp_format == "rel":
        in_inp, pred_inp = in_dxdy, pred_dxdy
    elif spec.inp_format == "abs":
        in_inp, pred_inp = in_xy, pred_xy
    else:
        in_inp = torch.cat([in_xy, in_dxdy], dim=-1)
        pred_inp = torch.cat([pred_xy, pred_dxdy], dim=-1)

    k, s, p = pred_xy.shape[:3]
    in_enc = common.trajectory_encoder_apply(params["in_encoder"], in_inp)
    in_enc = mlp_apply_per_layer(params["in_fc"], in_enc, ACTS)
    pred_enc = mlp_apply_per_layer(params["pred_encoder"],
                                   pred_inp.reshape(k, s, p, -1), ACTS)
    # zero the future encoding of agents without a valid future
    # (discriminators.py:135-138)
    pred_enc = pred_enc * future_valid[None, :, :, None].to(pred_enc.dtype)
    enc = torch.cat([in_enc[None].expand((k,) + tuple(in_enc.shape)), pred_enc],
                    dim=-1)  # (K,S,P,h)

    new_state = dict(state)
    cls = enc
    if spec.global_disc and spec.pool_type == "sways":
        soc = social_ops.social_attention_apply(
            params["social"], in_xy[..., -1, :], in_dxdy[..., -1, :], enc, ped_mask)
        cls = torch.cat([soc, enc], dim=-1)
    elif spec.global_disc:
        soc = social_ops.pool_hidden_net_apply(params["social"], in_xy[..., -1, :], enc,
                                               ped_mask)
        cls = torch.cat([soc, enc], dim=-1)
    if spec.scene_dim > 0 and patches is not None:
        flat = patches.reshape((s * p,) + tuple(patches.shape[2:]))
        if train:
            scene_enc, new_state["scene"] = scene_cnn_apply_train(
                params["scene"], state["scene"], flat, mask=ped_mask.reshape(s * p))
        else:
            scene_enc = scene_cnn_apply(params["scene"], state["scene"], flat)
        scene_enc = scene_enc.reshape(s, p, -1)
        cls = torch.cat([cls, scene_enc[None].expand((k,) + tuple(scene_enc.shape))],
                        dim=-1)
    return cls, new_state


def _head_scores(heads, spec, cls):
    """``(K,S,P,CD)`` -> ``(K,S,P,D)`` per-head scores with the eps squash."""
    num = heads["lin0"]["w"].shape[0]
    out = torch.stack([
        mlp_apply_per_layer(common.unstack_tree(heads, i), cls, ACTS)[..., 0]
        for i in range(num)
    ], dim=-1)
    if not spec.unbound_output:
        out = torch.sigmoid(out) * (1 - 2 * EPS_D) + EPS_D
    return out


def apply(params, state, spec: DiscriminatorSpec, in_xy, in_dxdy, pred_xy,
          pred_dxdy, ped_mask, future_valid, patches=None, train=True,
          return_all=False, use_hist=False):
    """Score (and, for mgan and infogan, branch-classify) K prediction samples.

    in_xy/in_dxdy ``(S,P,8,2)``/``(S,P,7,2)``; pred_xy/pred_dxdy
    ``(K,S,P,12,2)``; ped_mask and future_valid ``(S,P)`` bool.
    ``use_hist`` scores with probgan's history heads (``forward_by_hist``,
    discriminators.py:221-244). Returns ``(scores (K,S,P) or (K,S,P,D)
    with return_all, branch (K,S,P,G) for mgan, (K,S,P,3) for infogan, or
    None, new_state)``.
    """
    cls, new_state = _classifier_input(
        params, spec, in_xy, in_dxdy, pred_xy, pred_dxdy, ped_mask,
        future_valid, patches, state, train)
    heads = state["hist"]["discs"] if use_hist else params["discs"]
    out = _head_scores(heads, spec, cls)
    scores = out if return_all else out.mean(-1)
    branch = None
    if spec.gan_type in ("mgan", "infogan"):
        branch = mlp_apply_per_layer(params["branch"], cls, ACTS)
    return scores, branch, new_state


def update_hist(params, state):
    """Polyak-average the live heads into the history copy
    (discriminators.py:246-263): ``len += 1``; ``hist = hist * (1 - a) +
    live * a`` with ``a = 1 / len``. Returns the new state."""
    hist = state["hist"]
    new_len = hist["len"] + 1.0
    alpha = 1.0 / new_len
    discs = tree_map(lambda old, new: old * (1 - alpha) + new * alpha, hist["discs"],
                     params["discs"])
    return {**state, "hist": {"discs": discs, "len": new_len}}
