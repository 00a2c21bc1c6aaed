"""Scene-patch CNN + channel attention: eval (float32, or bf16 with the
BatchNorm folded into the convolutions) and train modes.

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
from mggan_tpu_torch.parallel import reduce

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


def bn_train_nchw(params, state, x, mask=None, momentum=0.1):
    """Train BatchNorm (JAX ``bn_apply(train=True)``): normalise by the
    batch statistics over the rows ``mask (B,)`` keeps, and return the
    running statistics moved by ``momentum`` towards them (the running
    variance unbiased by ``n / (n - 1)``, ``n`` the kept rows times H*W).
    On a data-parallel rank the statistics are the global batch's, summed
    over the data group differentiably (``parallel/reduce.py``), as
    SyncBatchNorm's. Returns ``(y, new_state)``."""
    view = lambda v: v[None, :, None, None]
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    w = mask.to(x.dtype)[:, None, None, None]
    n = torch.clamp(reduce.count(mask.sum().to(x.dtype)) * (x.shape[2] * x.shape[3]),
                    min=1.0)
    mean = reduce.total((x * w).sum((0, 2, 3))) / n
    var = reduce.total((w * (x - view(mean)) ** 2).sum((0, 2, 3))) / n
    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
    new_state = {  # statistics, not parameters: no gradient flows into them
        "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
        "var": (1 - momentum) * state["var"] + momentum * unbiased.detach(),
    }
    y = (x - view(mean)) * torch.rsqrt(view(var) + BN_EPS) * view(params["scale"]) \
        + view(params["bias"])
    return y, new_state


def _scene_cnn(params, patches, bn):
    """The conv stack with ``bn(name, x) -> x`` as its normalisation."""
    x = patches.permute(0, 3, 1, 2)  # NHWC -> NCHW
    for conv, name in (("conv1", "bn1"), ("conv2", "bn2")):
        x = conv_apply_nchw(params[conv], x)
        x = max_pool_2x2(F.relu(bn(name, x)))
    x = x.permute(0, 2, 3, 1)  # back to NHWC before the attention reshape
    return attention_head(params, x)


def fold_bn(params, state):
    """Eval-mode BatchNorm (a per-channel affine) folded into each conv's
    weights and bias: ``{"conv1": {"w", "b"}, "conv2": {"w", "b"}}``."""
    folded = {}
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        g = params[bn]["scale"] * torch.rsqrt(state[bn]["var"] + BN_EPS)
        folded[conv] = {
            "w": params[conv]["w"] * g,  # (3,3,I,O) * (O,)
            "b": (params[conv]["b"] - state[bn]["mean"]) * g + params[bn]["bias"],
        }
    return folded


def scene_cnn_apply(params, state, patches, compute_dtype=None):
    """``(B, 33, 33, 4)`` NHWC patches -> ``(B, 64)`` scene encoding, eval
    mode (BatchNorm from running statistics).

    ``compute_dtype=None`` is the float32 path. With a ``compute_dtype``
    (JAX ``train=False, compute_dtype=...``, ops/cnn.py:151-167) the
    BatchNorm is folded into the conv weights and the conv stack runs in
    that dtype end to end: operands, conv outputs, bias, ReLU and pooling;
    the attention head stays float32. The convolutions stay
    ``F.conv2d``: they were plain XLA in the JAX package.
    """
    if compute_dtype is None:
        return _scene_cnn(params, patches,
                          lambda name, x: bn_eval_nchw(params[name], state[name], x))
    folded = fold_bn(params, state)
    x = patches.permute(0, 3, 1, 2).to(compute_dtype)  # NHWC -> NCHW
    for conv in ("conv1", "conv2"):
        w = folded[conv]["w"].permute(3, 2, 0, 1).to(compute_dtype)  # HWIO -> OIHW
        b = folded[conv]["b"].to(compute_dtype)
        x = F.conv2d(x, w, padding=1) + b[None, :, None, None]
        x = max_pool_2x2(F.relu(x))
    x = x.permute(0, 2, 3, 1)  # back to NHWC before the attention reshape
    return attention_head(params, x.float())


def scene_cnn_apply_train(params, state, patches, mask=None):
    """The train path (JAX ``scene_cnn_apply(..., train=True, mask)``):
    BatchNorm over the batch statistics of the rows ``mask (B,)`` keeps.
    Returns ``(encoding (B, 64), new_state)``, the running statistics
    updated as ``bn_train_nchw`` says."""
    new_state = {}

    def bn(name, x):
        y, new_state[name] = bn_train_nchw(params[name], state[name], x, mask)
        return y

    return _scene_cnn(params, patches, bn), new_state
