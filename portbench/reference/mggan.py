"""MG-GAN in plain PyTorch: the benchmark's reference.

A frozen, self-contained statement of what the measured program computes,
for the family the benchmark's configurations state: the ``mgan`` GAN
with the NS objective, the ``ml`` path-mode target, ``rel`` inputs, sways
social attention, the scene-patch CNN and a global discriminator
(MG-GAN, Dendorfer et al., ICCV 2021, arXiv:2108.09274). It imports
nothing of the measured program and no kernel: every rollout is the plain
12-step loop over each generator's own decoder, in the reference
release's layout of weights (``nn.Linear`` ``(out, in)``, ``nn.LSTM``
``weight_ih_l0`` ..., ``nn.Conv2d`` ``(O, I, 3, 3)``), keyed as its state
dicts are.

``precision()`` turns PyTorch's TF32 switches off around a block and puts
them back afterwards: the reference runs in float32 throughout, finer
than the program needs to be. ``precision(control=True)`` is the control,
the nearest precision below the configurations' float32: the same code
with its products and convolutions in bfloat16 under autocast.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

OBS_LEN, PRED_LEN = 8, 12
PATCH, MARGIN, BIG_MARGIN = 33, 16, 24
BIG_PATCH = 2 * BIG_MARGIN + 1
SCENE_CELLS = 64  # the 8 x 8 map after two 2 x 2 pools
BN_EPS = 1e-5
EPS_D = 1e-7
NEG_INF = -1e9
GUMBEL_U_MIN = 1e-20


@contextlib.contextmanager
def precision(control: bool = False, device_type: str = "cuda"):
    """TF32 off for matmuls and cuDNN inside the block; with ``control``,
    bfloat16 autocast on ``device_type`` as well."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=control):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def check_family(cfg: dict):
    """Raise unless ``cfg`` is of the family this reference states."""
    want = {"gan_type": "mgan", "gan_obj": "NS", "weighting_target": "ml",
            "inp_format": "rel", "pool_type": "sways", "global_disc": 1,
            "l2_loss_type": "min_g_z", "num_unrolling_steps": 0, "num_gen_steps": 1,
            "n_social_modules": 1, "patch_interp": "nearest"}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"the reference states {want}; the configuration has {bad}")


# ------------------------------------------------------------------ weights
def _linear(out: list, key, n_out, n_in):
    bound = 1.0 / math.sqrt(n_in)
    out += [(f"{key}.weight", (n_out, n_in), ("uniform", bound)),
            (f"{key}.bias", (n_out,), ("uniform", bound))]


def _mlp(out, key, dims, first=0):
    for i in range(len(dims) - 1):
        _linear(out, f"{key}.{first + 2 * i}", dims[i + 1], dims[i])


def _lstm(out, key, n_in, h):
    bound = 1.0 / math.sqrt(h)
    out += [(f"{key}.weight_ih_l0", (4 * h, n_in), ("uniform", bound)),
            (f"{key}.weight_hh_l0", (4 * h, h), ("uniform", bound)),
            (f"{key}.bias_ih_l0", (4 * h,), ("uniform", bound)),
            (f"{key}.bias_hh_l0", (4 * h,), ("uniform", bound))]


def _scene(out, key, channels, in_ch=4):
    cnn = f"{key}.CNN.encoder"
    for i, c_in in ((1, in_ch), (2, channels)):
        block = f"{cnn}.ConvBlock_{i}.Block"
        out += [(f"{block}.Conv_1.weight", (channels, c_in, 3, 3),
                 ("normal", math.sqrt(2.0 / (c_in * 9)))),
                (f"{block}.Conv_1.bias", (channels,), ("const", 0.01)),
                (f"{block}.BN_1.weight", (channels,), ("const", 1.0)),
                (f"{block}.BN_1.bias", (channels,), ("const", 0.0)),
                (f"{block}.BN_1.running_mean", (channels,), ("const", 0.0)),
                (f"{block}.BN_1.running_var", (channels,), ("const", 1.0)),
                (f"{block}.BN_1.num_batches_tracked", (), ("const", 0.0))]
    _mlp(out, f"{key}.cnn_attention", [channels, 32, channels])


def _sways(out, key, h, feat):
    _mlp(out, f"{key}.feature_embedder.fc", [3, 32, 64, feat])
    _linear(out, f"{key}.attention.W", feat, h)


def generator_keys(cfg: dict):
    """``(key, shape, init)`` of every generator entry, in a fixed order."""
    h, dh, z, g = cfg["h_dim"], cfg["decoder_h_dim"], cfg["noise_dim"], cfg["num_gens"]
    emb = dh // 2
    enc_total = h + SCENE_CELLS + h
    out = []
    _linear(out, "encoder.embedding", emb, 2)
    _lstm(out, "encoder.encoder", emb, h)
    _scene(out, "scene_encoder", 16)
    _sways(out, "social", h, h)
    for i in range(g):
        _linear(out, f"gs.{i}.spatial_embedding", emb, 2)
        _lstm(out, f"gs.{i}.decoder", emb, dh)
        _mlp(out, f"gs.{i}.hidden2pos", [dh + h, dh // 2, 2])
    _mlp(out, "enc_h_to_dec_h", [enc_total + z, dh])
    _mlp(out, "net_chooser", [enc_total, h // 2, h // 2, g])
    out.append(("net_prior", (1, g), ("const", 0.0)))
    return out


def discriminator_keys(cfg: dict):
    """``(key, shape, init)`` of every discriminator entry (``h_dim``
    doubled, as the model factory does)."""
    h, g = 2 * cfg["h_dim"], cfg["num_gens"]
    cd = 2 * h + SCENE_CELLS
    out = []
    _linear(out, "in_encoder.embedding", h, 2)
    _lstm(out, "in_encoder.encoder", h, h)
    _mlp(out, "in_encoder_fc", [h, h // 2, h // 2])
    _mlp(out, "pred_encoder", [PRED_LEN * 2, h, h // 2])
    _sways(out, "social", h, h)
    _scene(out, "scene_encoder", 8)
    _mlp(out, "discs.0", [cd, cd // 2, 1])
    _mlp(out, "gen_id_reconstructor", [cd, cd // 2, g])
    return out


def make_weights(cfg: dict, generator: torch.Generator):
    """``(g_sd, d_sd)``: the two state dicts, float32 on the generator's
    device, drawn in two calls (one uniform, one normal vector) and cut
    into entries: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for linear and
    LSTM entries, Kaiming-normal for convolutions, BatchNorm as new."""
    specs = [generator_keys(cfg), discriminator_keys(cfg)]
    count = lambda kind: sum(math.prod(s) for spec in specs for _, s, (k, _) in spec
                             if k == kind)
    dev = generator.device
    uni = torch.rand(count("uniform"), generator=generator, device=dev) * 2.0 - 1.0
    nor = torch.randn(count("normal"), generator=generator, device=dev)
    pos = {"uniform": 0, "normal": 0}
    dicts = []
    for spec in specs:
        sd = {}
        for key, shape, (kind, value) in spec:
            n = math.prod(shape)
            if kind == "const":
                sd[key] = torch.full(shape, value, device=dev)
                continue
            src = uni if kind == "uniform" else nor
            sd[key] = src[pos[kind]: pos[kind] + n].reshape(shape) * value
            pos[kind] += n
        dicts.append(sd)
    return dicts[0], dicts[1]


TRAINABLE_SKIP = ("running_mean", "running_var", "num_batches_tracked")


def trainable(sd: dict) -> dict:
    """The entries an optimizer moves (BatchNorm's statistics are not)."""
    return {k: v for k, v in sd.items() if not k.endswith(TRAINABLE_SKIP)}


# ------------------------------------------------------------------ layers
def linear(w, key, x):
    return F.linear(x, w[f"{key}.weight"], w[f"{key}.bias"])


def mlp(w, key, x, n_layers, hidden_act, last_act=None):
    for i in range(n_layers):
        x = linear(w, f"{key}.{2 * i}", x)
        if i < n_layers - 1:
            x = hidden_act(x)
        elif last_act is not None:
            x = last_act(x)
    return x


relu = F.relu
leaky01 = lambda x: F.leaky_relu(x, 0.01)  # noqa: E731
leaky02 = lambda x: F.leaky_relu(x, 0.2)  # noqa: E731


def lstm_cell(w, key, x, h, c):
    gates = (F.linear(x, w[f"{key}.weight_ih_l0"], w[f"{key}.bias_ih_l0"])
             + F.linear(h, w[f"{key}.weight_hh_l0"], w[f"{key}.bias_hh_l0"]))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def encode_track(w, key, seq):
    """``seq (N, T, 2)`` -> the embedding + LSTM's last hidden state."""
    x = linear(w, f"{key}.embedding", seq)
    hdim = w[f"{key}.encoder.weight_hh_l0"].shape[1]
    h = x.new_zeros(x.shape[0], hdim)
    c = torch.zeros_like(h)
    for t in range(x.shape[1]):
        h, c = lstm_cell(w, f"{key}.encoder", x[:, t], h, c)
    return h


def batch_norm_train(w, key, x, mask):
    """BatchNorm on the statistics of the rows ``mask`` keeps."""
    keep = mask.to(x.dtype)[:, None, None, None]
    n = torch.clamp(keep.sum() * x.shape[2] * x.shape[3], min=1.0)
    mean = (x * keep).sum((0, 2, 3)) / n
    var = (keep * (x - mean[None, :, None, None]) ** 2).sum((0, 2, 3)) / n
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var[None, :, None, None] + BN_EPS)
    return y * w[f"{key}.weight"][None, :, None, None] + w[f"{key}.bias"][None, :, None, None]


def batch_norm_eval(w, key, x):
    """BatchNorm on its running statistics."""
    view = lambda name: w[f"{key}.{name}"][None, :, None, None]  # noqa: E731
    return ((x - view("running_mean")) * torch.rsqrt(view("running_var") + BN_EPS)
            * view("weight") + view("bias"))


def scene_cnn(w, key, patches, mask, train=True):
    """NHWC patches ``(B, 33, 33, 4)`` -> ``(B, 64)``; in training the
    BatchNorm takes the statistics of the real rows ``mask (B,)``."""
    x = patches.permute(0, 3, 1, 2)
    for i in (1, 2):
        block = f"{key}.CNN.encoder.ConvBlock_{i}.Block"
        x = F.conv2d(x, w[f"{block}.Conv_1.weight"], w[f"{block}.Conv_1.bias"], padding=1)
        x = (batch_norm_train(w, f"{block}.BN_1", x, mask) if train
             else batch_norm_eval(w, f"{block}.BN_1", x))
        x = F.max_pool2d(F.relu(x), 2, 2)
    feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], SCENE_CELLS, x.shape[1])
    scores = mlp(w, f"{key}.cnn_attention", feats, 2, leaky01)
    return (torch.softmax(scores, dim=2) * feats).sum(-1)


def pair_features(last_xy, last_dxdy, mask):
    """Distance, bearing and distance at closest approach of every pair,
    ``(S, P, P, 3)``, zero where a padded agent takes part."""
    dp = last_xy[:, :, None, :] - last_xy[:, None, :, :]
    dv = last_dxdy[:, :, None, :] - last_dxdy[:, None, :, :]
    dist = torch.linalg.vector_norm(dp, dim=-1)
    v_i = last_dxdy[:, :, None, :]
    bearing = (dp * v_i).sum(-1) / (dist * torch.linalg.vector_norm(v_i, dim=-1) + 1e-6)
    ttca = -(dp * dv).sum(-1) / ((dv * dv).sum(-1) + 1e-6)
    dca = torch.linalg.vector_norm(dp + ttca[..., None] * dv, dim=-1)
    feats = torch.stack([dist, bearing, dca], dim=-1)
    pair = (mask[:, :, None] & mask[:, None, :])[..., None]
    return torch.where(pair, feats, torch.zeros_like(feats))


def sways(w, key, last_xy, last_dxdy, enc, mask):
    """Sways attention of every agent over the other real agents of its
    scene; ``enc (..., S, P, H)`` with leading sample axes."""
    femb = mlp(w, f"{key}.feature_embedder.fc", pair_features(last_xy, last_dxdy, mask), 3,
               relu)
    wh = linear(w, f"{key}.attention.W", enc)
    sigma = torch.einsum("sijf,...sjf->...sij", femb, wh)
    p = enc.shape[-2]
    eye = torch.eye(p, dtype=torch.bool, device=mask.device)[None]
    sigma = torch.where(mask[:, None, :] & ~eye, sigma, torch.full_like(sigma, NEG_INF))
    pooled = torch.einsum("...sij,...sjh->...sih", torch.softmax(sigma, dim=-1), enc)
    keep = (mask.sum(-1)[:, None] > 1) & mask
    return torch.where(keep[..., None], pooled, torch.zeros_like(pooled))


# --------------------------------------------------------------- generator
def views(xy, ped_mask):
    """Observed positions and steps, futures and masks of a padded batch
    ``xy (S, P, 20, 2)`` (NaN futures become masked zeros)."""
    in_xy = xy[:, :, :OBS_LEN]
    in_dxdy = in_xy[:, :, 1:] - in_xy[:, :, :-1]
    gt = xy[:, :, OBS_LEN:]
    loss_mask = ped_mask & ~torch.isnan(gt).any(-1).any(-1)
    keep = loss_mask[..., None, None]
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    gt_xy = torch.where(keep, torch.nan_to_num(gt), zero)
    prev = torch.cat([in_xy[:, :, -1:], gt[:, :, :-1]], dim=2)
    gt_dxdy = torch.where(keep, torch.nan_to_num(gt - prev), zero)
    return {"in_xy": in_xy, "in_dxdy": in_dxdy, "gt_xy": gt_xy, "gt_dxdy": gt_dxdy,
            "ped_mask": ped_mask, "loss_mask": loss_mask}


def g_encode(w, v, patches, train=True):
    """``(enc (S, P, 128), social (S, P, 32))`` of the generator."""
    s, p = v["ped_mask"].shape
    enc_h = encode_track(w, "encoder", v["in_dxdy"].reshape(s * p, OBS_LEN - 1, 2))
    enc_h = enc_h.reshape(s, p, -1)
    scene = scene_cnn(w, "scene_encoder", patches.reshape((s * p,) + patches.shape[2:]),
                      v["ped_mask"].reshape(-1), train).reshape(s, p, -1)
    social = sways(w, "social", v["in_xy"][:, :, -1], v["in_dxdy"][:, :, -1], enc_h,
                   v["ped_mask"])
    return torch.cat([enc_h, scene, social], dim=-1), social


def g_encode_eval(w, v, patches):
    return g_encode(w, v, patches, train=False)


def pm_logits(w, enc):
    return mlp(w, "net_chooser", enc, 3, relu)


def gumbel_choice(logits, uniforms):
    """The generator of each (sample, agent): ``argmax(logits + Gumbel)``
    with the Gumbel draws from ``uniforms (K, S, P, G)`` -> ``(K, S, P)``."""
    return torch.argmax(gumbel_scores(logits, uniforms), dim=-1)


def gumbel_scores(logits, uniforms):
    return logits[None] - torch.log(-torch.log(uniforms))


def decoder_h0(w, enc, z):
    """``enc (S, P, E)``, ``z (K, S, 1, Z)`` -> ``(K, S, P, H)``."""
    k = z.shape[0]
    zz = z.expand(k, enc.shape[0], enc.shape[1], z.shape[-1])
    return linear(w, "enc_h_to_dec_h.0", torch.cat([enc[None].expand(k, *enc.shape), zz], -1))


def rollout(w, gen: int, last_xy, last_dxdy, social, h0):
    """Generator ``gen``'s 12 steps from rows ``last_xy``, ``last_dxdy (N, 2)``,
    ``social (N, 32)``, ``h0 (N, H)`` -> ``(abs, rel)``, each ``(N, 12, 2)``."""
    key = f"gs.{gen}"
    h, c = h0, torch.zeros_like(h0)
    xy, dxdy = last_xy, last_dxdy
    out_abs, out_rel = [], []
    for _ in range(PRED_LEN):
        x = linear(w, f"{key}.spatial_embedding", dxdy)
        h, c = lstm_cell(w, f"{key}.decoder", x, h, c)
        dxdy = mlp(w, f"{key}.hidden2pos", torch.cat([h, social], -1), 2, leaky01)
        xy = xy + dxdy
        out_abs.append(xy)
        out_rel.append(dxdy)
    return torch.stack(out_abs, 1), torch.stack(out_rel, 1)


def decode_chosen(w, v, social, h0, choice, num_gens):
    """Each (sample, agent)'s rollout by its chosen generator: ``h0 (K, S,
    P, H)``, ``choice (K, S, P)`` -> ``(abs, rel)``, each ``(K, S, P, 12, 2)``."""
    k, s, p = choice.shape
    rows = lambda x: x[None].expand(k, *x.shape).reshape(k * s * p, -1)
    last_xy, last_dxdy = rows(v["in_xy"][:, :, -1]), rows(v["in_dxdy"][:, :, -1])
    soc, hh, ch = rows(social), h0.reshape(k * s * p, -1), choice.reshape(-1)
    out_abs = last_xy.new_zeros(k * s * p, PRED_LEN, 2)
    out_rel = torch.zeros_like(out_abs)
    for g in range(num_gens):
        idx = (ch == g).nonzero()[:, 0]
        if idx.numel():
            a, r = rollout(w, g, last_xy[idx], last_dxdy[idx], soc[idx], hh[idx])
            out_abs = out_abs.index_copy(0, idx, a.to(out_abs.dtype))
            out_rel = out_rel.index_copy(0, idx, r.to(out_rel.dtype))
    shape = (k, s, p, PRED_LEN, 2)
    return out_abs.reshape(shape), out_rel.reshape(shape)


def decode_every(w, v, social, h0, num_gens):
    """Every generator on every sample: ``(abs, rel)``, each ``(K, G, S, P,
    12, 2)``."""
    k, s, p = h0.shape[:3]
    rows = lambda x: x[None].expand(k, *x.shape).reshape(k * s * p, -1)
    last_xy, last_dxdy = rows(v["in_xy"][:, :, -1]), rows(v["in_dxdy"][:, :, -1])
    soc, hh = rows(social), h0.reshape(k * s * p, -1)
    outs = [rollout(w, g, last_xy, last_dxdy, soc, hh) for g in range(num_gens)]
    shape = (k, s, p, PRED_LEN, 2)
    return (torch.stack([a.reshape(shape) for a, _ in outs], 1),
            torch.stack([r.reshape(shape) for _, r in outs], 1))


# ----------------------------------------------------------- discriminator
def d_scores(w, v, pred_xy, pred_dxdy, patches):
    """``(scores (K, S, P), branch (K, S, P, G))`` of K candidate futures."""
    k = pred_xy.shape[0]
    s, p = v["ped_mask"].shape
    in_enc = encode_track(w, "in_encoder", v["in_dxdy"].reshape(s * p, OBS_LEN - 1, 2))
    in_enc = mlp(w, "in_encoder_fc", in_enc.reshape(s, p, -1), 2, leaky02)
    pred_enc = mlp(w, "pred_encoder", pred_dxdy.reshape(k, s, p, -1), 2, leaky02)
    pred_enc = pred_enc * v["loss_mask"][None, :, :, None].to(pred_enc.dtype)
    enc = torch.cat([in_enc[None].expand(k, *in_enc.shape), pred_enc], -1)
    soc = sways(w, "social", v["in_xy"][:, :, -1], v["in_dxdy"][:, :, -1], enc,
                v["ped_mask"])
    scene = scene_cnn(w, "scene_encoder", patches.reshape((s * p,) + patches.shape[2:]),
                      v["ped_mask"].reshape(-1)).reshape(s, p, -1)
    cls = torch.cat([soc, enc, scene[None].expand(k, *scene.shape)], -1)
    score = mlp(w, "discs.0", cls, 2, leaky02)[..., 0]
    score = torch.sigmoid(score) * (1 - 2 * EPS_D) + EPS_D
    return score, mlp(w, "gen_id_reconstructor", cls, 2, leaky02)


# ------------------------------------------------------------------ losses
def bce(pred, label):
    return -(label * torch.log(pred) + (1.0 - label) * torch.log(1.0 - pred))


def masked_mean(x, mask):
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def cross_entropy(logits, labels):
    return -torch.gather(torch.log_softmax(logits, -1), -1, labels[..., None])[..., 0]


def count_reweighted_mean(loss, choice, num_gens, valid):
    """Each element over its generator's count of valid samples, then a
    masked mean."""
    v = torch.broadcast_to(valid, choice.shape).to(loss.dtype)
    counts = (F.one_hot(choice, num_gens).to(loss.dtype) * v[..., None]).reshape(
        -1, num_gens).sum(0)
    weight = (1.0 / torch.clamp(counts, min=1.0))[choice] * v
    return (loss * weight).sum() / torch.clamp(v.sum(), min=1.0)


def min_scene_l2(pred_abs, v):
    d = torch.linalg.vector_norm(pred_abs - v["gt_xy"][None], dim=-1).sum(-1)
    per_scene = (d * v["loss_mask"][None]).sum(-1).min(0).values
    return per_scene.sum() / torch.clamp(v["ped_mask"].sum().to(d.dtype), min=1.0)


# ------------------------------------------------------------------ update
class Adam:
    """AdamW (b2 0.999, eps 1e-8, weight decay 0.01) behind a clip of the
    gradients' global norm, moving every entry on every update."""

    def __init__(self, params: dict, lr, beta1, clip):
        self.lr, self.b1, self.clip = lr, beta1, clip
        self.b2, self.eps, self.wd = 0.999, 1e-8, 0.01
        self.count = 0
        self.mu = {k: torch.zeros_like(x) for k, x in params.items()}
        self.nu = {k: torch.zeros_like(x) for k, x in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            out[k] = p - self.lr * (u + self.wd * p)
        return out


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, got)}


def _leaves(sd: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in trainable(sd).items()}


class TrainStep:
    """The D, G and PM updates of one train step of the ``mgan`` / NS /
    ``ml`` family, in the order the measured step runs them, from the
    reference-layout weights ``g_sd``, ``d_sd``."""

    def __init__(self, cfg: dict, g_sd: dict, d_sd: dict, lr_g: float, lr_d: float):
        check_family(cfg)
        self.cfg = cfg
        self.g_fixed = {k: v for k, v in g_sd.items() if k not in trainable(g_sd)}
        self.d_fixed = {k: v for k, v in d_sd.items() if k not in trainable(d_sd)}
        self.g = {k: v.detach().clone() for k, v in trainable(g_sd).items()}
        self.d = {k: v.detach().clone() for k, v in trainable(d_sd).items()}
        self.opt_g = Adam(self.g, lr_g, cfg["beta1"], cfg["clipping_threshold_g"])
        self.opt_d = Adam(self.d, lr_d, cfg["beta1"], cfg["clipping_threshold_d"])

    def _g_forward(self, g, v, patches, uniforms, z):
        enc, social = g_encode(g, v, patches)
        logits = pm_logits(g, enc)
        choice = gumbel_choice(logits, uniforms)
        return enc, social, logits, choice, decoder_h0(g, enc, z)

    def __call__(self, xy, ped_mask, patches, draws) -> dict:
        """One step on a batch; ``draws`` as the measured step takes them.
        Returns the step's losses as floats, and keeps the updated weights
        and the optimizers' state."""
        cfg, ng = self.cfg, self.cfg["num_gens"]
        v = views(xy, ped_mask)
        valid = v["loss_mask"]
        out = {}
        # D step
        d = _leaves(self.d)
        lr_, lf_ = draws["d_labels"][0, 0], draws["d_labels"][0, 1]
        real, _ = d_scores(d, v, v["gt_xy"][None], v["gt_dxdy"][None], patches)
        real_loss = masked_mean(bce(real, lr_), valid[None])
        with torch.no_grad():
            _, social, _, choice, h0 = self._g_forward(
                self.g, v, patches, draws["d_uniforms"][0], draws["d_z"][0])
            f_abs, f_rel = decode_chosen(self.g, v, social, h0, choice, ng)
        fake, branch = d_scores(d, v, f_abs, f_rel, patches)
        fake_loss = masked_mean(bce(fake, lf_), valid[None])
        ce = masked_mean(cross_entropy(branch, choice), valid[None])
        out["train/discr_loss"] = float((real_loss + fake_loss).detach())
        out["train/info_mgan_disc_loss"] = float(ce.detach())
        self.d = self.opt_d.update(self.d, _grads(real_loss + fake_loss + ce, d))
        # G step
        g = _leaves(self.g)
        lr_, lf_ = draws["g_labels"][0], draws["g_labels"][1]
        _, social, _, choice, h0 = self._g_forward(g, v, patches, draws["g_uniforms"],
                                                   draws["g_z"])
        every_abs, every_rel = decode_every(g, v, social, h0, ng)
        pick = F.one_hot(choice, ng).permute(0, 3, 1, 2).to(every_abs.dtype)[..., None, None]
        p_abs, p_rel = (every_abs * pick).sum(1), (every_rel * pick).sum(1)
        l2 = min_scene_l2(p_abs, v)
        scores, branch = d_scores(self.d, v, p_abs, p_rel, patches)
        adv = count_reweighted_mean(bce(scores, lr_), choice, ng, valid[None])
        clf = count_reweighted_mean(cross_entropy(branch, choice), choice, ng, valid[None])
        out["train/L2_loss"] = float(l2.detach())
        out["train/gen_loss"] = float(adv.detach())
        out["train/info_mgan_loss"] = float(clf.detach())
        total = l2 + adv + cfg["clf_loss_weight"] * clf
        self.g = self.opt_g.update(self.g, _grads(total, g))
        # PM step
        g = _leaves(self.g)
        enc, social = g_encode(g, v, patches)
        log_probs = torch.log(torch.softmax(pm_logits(g, enc), -1))
        with torch.no_grad():
            h0 = decoder_h0(g, enc, draws["pm_z"])
            every_abs, _ = decode_every(g, v, social, h0, ng)
        x = (every_abs - v["gt_xy"][None, None]) / cfg["sigma"]
        lp = (-0.5 * x * x - math.log(cfg["sigma"]) - 0.5 * math.log(2 * math.pi)).sum((-1, -2))
        post = torch.softmax(lp.mean(0), dim=0).movedim(0, -1)
        pm = masked_mean(-(post * log_probs).sum(-1), valid)
        out["train/net_chooser_loss"] = float(pm.detach())
        self.g = self.opt_g.update(self.g, _grads(pm * cfg["pi_net_loss_weight"], g))
        return out


# -------------------------------------------------------------- the feed
def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The windows of an epoch in the order a shuffling loader seeded with
    ``seed`` yields them."""
    order = np.arange(n)
    np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1)).shuffle(order)
    return order


def augment_xy(xy, wh_m, flip, alpha):
    """Flip (none / left-right / top-bottom), rotate about the scene's
    centre and shift the rotated scene's corner to the origin."""
    w, h = wh_m[:, 0][:, None, None], wh_m[:, 1][:, None, None]
    f = flip[:, None, None]
    x = torch.where(f == 1, w - xy[..., 0], xy[..., 0])
    y = torch.where(f == 2, h - xy[..., 1], xy[..., 1])
    centre = wh_m / 2.0

    def rotate(px, py, c, a):
        ca, sa = torch.cos(a), torch.sin(a)
        dx, dy = px - c[..., 0], py - c[..., 1]
        return dx * ca + dy * sa + c[..., 0], -dx * sa + dy * ca + c[..., 1]

    rx, ry = rotate(x, y, centre[:, None, None, :], alpha[:, None, None])
    zero = torch.zeros_like(wh_m[:, 0])
    cx = torch.stack([zero, zero, wh_m[:, 0], wh_m[:, 0]], 1)
    cy = torch.stack([zero, wh_m[:, 1], wh_m[:, 1], zero], 1)
    ox, oy = rotate(cx, cy, centre[:, None, :], alpha[:, None])
    return torch.stack([rx - ox.amin(1)[:, None, None], ry - oy.amin(1)[:, None, None]], -1)


def augment_patches(big, flip, alpha):
    """uint8 ``(S, P, 49, 49, 3)`` crops -> ``(S, P, 33, 33, 4)`` float32:
    each output pixel takes the crop's pixel nearest its rotated and
    flipped source (ties to even; 0 outside the crop), scaled to [-1, 1),
    and a one-hot centre channel."""
    s, p = big.shape[:2]
    r = torch.arange(PATCH, dtype=torch.float32, device=big.device) - MARGIN
    py, px = torch.meshgrid(r, r, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    ca, sa = torch.cos(alpha)[:, None], torch.sin(alpha)[:, None]
    qx = px[None] * ca - py[None] * sa
    qy = px[None] * sa + py[None] * ca
    qx = torch.where(flip[:, None] == 1, -qx, qx)
    qy = torch.where(flip[:, None] == 2, -qy, qy)
    ix, iy = torch.round(BIG_MARGIN + qx).long(), torch.round(BIG_MARGIN + qy).long()
    inside = (ix >= 0) & (ix < BIG_PATCH) & (iy >= 0) & (iy < BIG_PATCH)
    flat = torch.where(inside, iy * BIG_PATCH + ix, 0)
    src = big.reshape(s, p, BIG_PATCH * BIG_PATCH, 3).float()
    rgb = torch.stack([src[i][:, flat[i]] for i in range(s)])  # (S, P, O, 3)
    rgb = rgb * inside[:, None, :, None]
    rgb = -1.0 + rgb.reshape(s, p, PATCH, PATCH, 3) * 2.0 / 256.0
    centre = torch.zeros((s, p, PATCH, PATCH, 1), device=big.device)
    centre[:, :, MARGIN, MARGIN] = 1.0
    return torch.cat([rgb, centre], -1)
