"""Scene-patch CNN + channel attention, eval path in float32.

Counterpart of ``mggan_tpu/ops/cnn.py``. The public layout stays NHWC:
patches are ``(B, 33, 33, 4)`` and conv weights are stored HWIO
``(3, 3, I, O)`` as in JAX. ``torch.conv2d`` wants NCHW/OIHW, so the stack
permutes once on the way in, runs NCHW, and permutes back to NHWC before
``attention_head``: its reshape to ``(B, 64, C)`` must see channels last,
or the softmax over channels would mix the 64 spatial cells.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mggan_tpu_torch.ops.linear import mlp_apply_per_layer, mlp_init

BN_EPS = 1e-5


def conv_init(gen: torch.Generator, in_ch, out_ch, ksize=3):
    """Kaiming-normal fan-in init for ReLU (cnn.py:257-261), bias 0.01."""
    std = (2.0 / (in_ch * ksize * ksize)) ** 0.5
    w = torch.randn((ksize, ksize, in_ch, out_ch), generator=gen,
                    device=gen.device) * std
    return {"w": w, "b": torch.full((out_ch,), 0.01, device=gen.device)}


def bn_init(ch, device):
    params = {"scale": torch.ones(ch, device=device),
              "bias": torch.zeros(ch, device=device)}
    state = {"mean": torch.zeros(ch, device=device),
             "var": torch.ones(ch, device=device)}
    return params, state


def scene_cnn_init(gen: torch.Generator, channels_cnn: int, in_channels: int = 4):
    """Two conv blocks + channel-attention MLP (``AttentionGlobal``)."""
    params = {
        "conv1": conv_init(gen, in_channels, channels_cnn),
        "conv2": conv_init(gen, channels_cnn, channels_cnn),
        # attention dims [C, 32, C], activations [leakyrelu, none]
        "attn": mlp_init(gen, [channels_cnn, 32, channels_cnn]),
    }
    params["bn1"], bn1 = bn_init(channels_cnn, gen.device)
    params["bn2"], bn2 = bn_init(channels_cnn, gen.device)
    return params, {"bn1": bn1, "bn2": bn2}


def conv_apply_nchw(params, x):
    """3x3/s1/p1 conv on NCHW input with HWIO weights."""
    w = params["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x, w, params["b"], padding=1)


def bn_eval_nchw(params, state, x):
    """Eval BatchNorm from running statistics."""
    view = lambda v: v[None, :, None, None]
    inv = torch.rsqrt(view(state["var"]) + BN_EPS)
    return (x - view(state["mean"])) * inv * view(params["scale"]) + view(params["bias"])


def max_pool_2x2(x):
    """2x2/s2 max pool on NCHW, floor at the edge (33 -> 16 -> 8)."""
    return F.max_pool2d(x, 2, 2)


def attention_head(params, x):
    """Channel attention over the conv-stack output (cnn.py:109-116):
    NHWC ``(B, 8, 8, C)`` -> ``(B, 64)``."""
    b, hh, ww, c = x.shape
    feats = x.reshape(b, hh * ww, c)
    scores = mlp_apply_per_layer(params["attn"], feats, ["leakyrelu", "none"])
    att = torch.softmax(scores, dim=2)
    return (att * feats).sum(-1)


def scene_cnn_apply(params, state, patches):
    """``(B, 33, 33, 4)`` NHWC patches -> ``(B, 64)`` scene encoding.

    The eval path in float32 (JAX ``train=False, compute_dtype=None``):
    BatchNorm from running statistics. Training statistics and the bf16
    folded-BN path are not ported yet.
    """
    x = patches.permute(0, 3, 1, 2)  # NHWC -> NCHW
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        x = conv_apply_nchw(params[conv], x)
        x = F.relu(bn_eval_nchw(params[bn], state[bn], x))
        x = max_pool_2x2(x)
    x = x.permute(0, 2, 3, 1)  # back to NHWC before the attention reshape
    return attention_head(params, x)
