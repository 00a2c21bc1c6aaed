"""Multi-generator G: encoder + scene/social context + PM-net + decoders.

Counterpart of ``mggan_tpu/models/generator.py``: the continuous
multi-generator (``MultiGenerator``, standard.py:17-302) with sways social
attention or SGAN pooling, and the discrete-latent ablation
(``DiscreteLatentGenerator``, standard_discrete.py:18-257). Parameters are
nested dicts of tensors in the JAX layout; the continuous G's decoders are
one tree with a leading generator axis.

The discrete G runs one shared decoder once per generator identity: only
its initial state ``h0 = enc_to_dec([enc, embed(one_hot(g)), z])``
depends on the identity. So its rollouts are the same kernels on the one
decoder's weight image (a generator axis of 1): ``decode_all`` stacks the
G identities' rows (``G*K*S*P`` rows, identity-major) through K2 (and K3
in the backward); ``decode_select`` computes each row's ``h0`` from its
sampled identity and rolls out those rows alone through K1. Without a
PM-net (``weighting_target="none"`` or ``unconditional``) the logits are
the learnable prior ``net_prior``.

Under generator parallelism (a model group active in
``parallel/reduce.py``) the continuous G's ``decoders`` hold this rank's
``num_gens / gp`` generators: ``decode_all`` rolls out those alone (K2,
and K3 under autograd), behind ``to_model`` on its inputs, and
``decode_select`` contracts the generator axis over the model group
(``from_model``): each (sample, agent) row is non-zero on the one rank
that holds its sampled generator, so the sum is exact. The discrete G's
one decoder is replicated and needs no model-group operator.
"""

from __future__ import annotations

import math

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mggan_tpu_torch.models import common
from mggan_tpu_torch.models.common import GeneratorOutput
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.ops import social as social_ops
from mggan_tpu_torch.ops.cnn import scene_cnn_apply, scene_cnn_apply_train, scene_cnn_init
from mggan_tpu_torch.ops.kernels import decode_all as decode_all_kernel
from mggan_tpu_torch.ops.kernels import decoder as decoder_kernel
from mggan_tpu_torch.ops.linear import linear_init, mlp_apply, mlp_init
from mggan_tpu_torch.parallel import reduce
from mggan_tpu_torch.utils.profiling import span
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class GeneratorSpec:
    """Static architecture hyper-parameters (subset of Config)."""

    z_size: int
    encoder_h_dim: int
    decoder_h_dim: int
    social_feat_size: int  # 0 disables the social module
    num_gens: int
    pred_len: int
    embedding_dim: int
    inp_format: str
    pool_type: str
    scene_dim: int  # 0 disables the scene CNN
    use_pinet: bool
    discrete: bool = False  # DiscreteLatentGenerator ablation

    @property
    def social_out_dim(self) -> int:
        return self.encoder_h_dim if self.social_feat_size > 0 else 0

    @property
    def enc_total(self) -> int:
        return self.encoder_h_dim + self.scene_dim + self.social_out_dim


def init(spec: GeneratorSpec, generator: torch.Generator):
    """Build ``(params, state)`` from ``generator``'s draws, on its device.
    ``state`` holds the scene CNN's BatchNorm running statistics."""
    gen = generator
    params = {
        "encoder": common.trajectory_encoder_init(
            gen, common.input_size(spec.inp_format), spec.encoder_h_dim,
            spec.embedding_dim,
        )
    }
    state = {}
    if spec.scene_dim > 0:
        params["scene"], state["scene"] = scene_cnn_init(gen, channels_cnn=16)
    h = spec.encoder_h_dim
    if spec.social_feat_size > 0 and spec.pool_type == "sways":
        params["social"] = {
            "embed": mlp_init(gen, [3, 32, 64, spec.social_feat_size]),
            "w": linear_init(gen, h, spec.social_feat_size),
        }
    elif spec.social_feat_size > 0:
        params["social"] = {
            "spatial": linear_init(gen, 2, spec.embedding_dim),
            "pre_pool": mlp_init(gen, [spec.embedding_dim + h, h, h]),
        }
    enc_to_dec_in = spec.enc_total + spec.z_size
    if spec.discrete:
        params["decoder"] = common.relative_decoder_init(
            gen, spec.embedding_dim, spec.decoder_h_dim, spec.inp_format,
            spec.social_out_dim)
        # one-hot -> z embedding (standard_discrete.py:103)
        params["one_hot_sample_encoder"] = mlp_init(
            gen, [spec.num_gens, spec.z_size, spec.z_size])
        enc_to_dec_in += spec.z_size
    else:
        params["decoders"] = common.stacked_decoders_init(
            gen, spec.num_gens, spec.embedding_dim, spec.decoder_h_dim,
            spec.inp_format, spec.social_out_dim,
        )
    params["enc_to_dec"] = mlp_init(gen, [enc_to_dec_in, spec.decoder_h_dim])
    params["net_chooser"] = mlp_init(gen, [spec.enc_total, h // 2, h // 2, spec.num_gens])
    params["net_prior"] = torch.zeros((1, spec.num_gens), device=gen.device)
    return params, state


def encode(params, state, spec: GeneratorSpec, in_xy, in_dxdy, ped_mask,
           patches, train: bool = False, compute_dtype=None):
    """Shared context encoding (standard.py:140-155).

    ``train`` runs the scene CNN's BatchNorm on the batch statistics of the
    real peds (``ped_mask``) and returns its updated running statistics;
    eval mode returns ``state`` as it was. ``compute_dtype`` (eval only,
    e.g. ``torch.bfloat16``) runs the scene CNN's folded-BN conv stack in
    that dtype; the trajectory encoder and the social module stay float32,
    as in JAX.

    Returns ``(enc_h (S, P, E_total), social_feats (S, P, F), new_state)``.
    """
    with span("mggan.traj_encoder"):
        enc_h = common.trajectory_encoder_apply(
            params["encoder"], common.get_input(in_xy, in_dxdy, spec.inp_format)
        )
    feats = [enc_h]
    new_state = dict(state)
    if spec.scene_dim > 0 and patches is not None:
        with span("mggan.scene_cnn"):
            s, p = patches.shape[:2]
            flat = patches.reshape((s * p,) + tuple(patches.shape[2:]))
            if train:
                scene_enc, new_state["scene"] = scene_cnn_apply_train(
                    params["scene"], state["scene"], flat, mask=ped_mask.reshape(s * p))
            else:
                scene_enc = scene_cnn_apply(params["scene"], state["scene"], flat,
                                            compute_dtype)
            feats.append(scene_enc.reshape(s, p, -1))
    with span("mggan.social"):
        if spec.social_feat_size > 0 and spec.pool_type == "sways":
            social_feats = social_ops.social_attention_apply(
                params["social"], in_xy[..., -1, :], in_dxdy[..., -1, :], enc_h,
                ped_mask,
            )
            feats.append(social_feats)
        elif spec.social_feat_size > 0:
            social_feats = social_ops.pool_hidden_net_apply(
                params["social"], in_xy[..., -1, :], enc_h, ped_mask)
            feats.append(social_feats)
        else:
            social_feats = enc_h.new_zeros(enc_h.shape[:-1] + (0,))
    return torch.cat(feats, dim=-1), social_feats, new_state


def pm_logits(params, spec: GeneratorSpec, enc_h):
    """PM-network logits or the (learnable) prior (standard.py:217-225)."""
    with span("mggan.pm"):
        if spec.use_pinet:
            return mlp_apply(params["net_chooser"], enc_h, activation="relu")
        prior = params["net_prior"][0]
        return prior.expand(enc_h.shape[:-1] + (spec.num_gens,))


def _decoder_h0(params, enc_h, noise, onehot=None):
    """``enc_to_dec([enc_h, z])`` for every sample: ``(K*S*P, H)`` rows in
    ``(k, s, p)``-major order. For the discrete G, ``onehot`` (broadcastable
    to ``(K, S, P, G)``) is the generator identity, embedded between the two
    (``enc_to_dec([enc_h, embed(onehot), z])``, standard_discrete.py:168-223)."""
    with span("mggan.decoder_h0"):
        k = noise.shape[0]
        enc_b = enc_h[None].expand((k,) + tuple(enc_h.shape))
        parts = [enc_b, noise]
        if onehot is not None:
            emb = mlp_apply(params["one_hot_sample_encoder"], onehot)
            parts.insert(1, emb.expand(tuple(noise.shape[:-1]) + (emb.shape[-1],)))
        h0 = mlp_apply(params["enc_to_dec"], torch.cat(parts, dim=-1))
        return h0.reshape(-1, h0.shape[-1])


def _one_decoder(params):
    """The discrete G's shared decoder as a stack of one generator."""
    return tree_map(lambda x: x[None], params["decoder"])


def _reshape_samples(x, spec, noise):
    k, s, p, _ = noise.shape
    return x.reshape(k, s, p, spec.pred_len, 2)


def _rows(x):
    """``x (..., F)`` as ``(rows, F)``; also for ``F = 0`` (no social
    module), where ``reshape(-1, 0)`` cannot infer the rows."""
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1])


def _stacked_gens(stacked) -> int:
    """Generators in a ``decoders`` stack (its leading axis)."""
    return tree_leaves(stacked)[0].shape[0]


def _split(spec: GeneratorSpec) -> bool:
    """Whether this rank holds a slice of the generators (see the note)."""
    return not spec.discrete and reduce.model_group() is not None


def decode_all(params, spec: GeneratorSpec, last_xy, last_dxdy, enc_h,
               social_feats, noise, compute_dtype=None, gather: bool = False):
    """Every generator on every noise sample (standard.py:227-265); under
    generator parallelism, every generator this rank holds, or with
    ``gather`` (no gradient) every generator, joined over the model group.

    On CUDA tensors this is the all-generator kernel K2 (and, under
    autograd, its reverse sweep K3), on CPU tensors their plain versions
    (``ops/kernels/decode_all.py``). The per-agent inputs go in once; only
    ``h0`` has a row per sample. ``compute_dtype=torch.bfloat16`` is K2's
    bf16 variant; its gradient is K3 in f32 from the bf16 forward's (h, c),
    as in JAX.

    Returns GeneratorOutput with abs/rel of shape (K, G, S, P, pred_len, 2),
    G this rank's generators.
    """
    k, s, p, _ = noise.shape
    flat = _rows
    if spec.discrete:
        g = spec.num_gens
        # the G identities' h0 stacked identity-major: (G*K*S*P, H), one
        # decoder; the per-agent inputs' rows repeat every S*P rows
        eye = torch.eye(g, dtype=enc_h.dtype, device=enc_h.device)
        h0 = torch.cat([_decoder_h0(params, enc_h, noise, eye[i]) for i in range(g)])
        stacked = _one_decoder(params)
    else:
        # rows are (k, s, p)-major, the order _decoder_h0 produces
        g = _stacked_gens(params["decoders"])
        h0 = _decoder_h0(params, enc_h, noise)
        stacked = params["decoders"]
    with span("mggan.rollout"):
        inputs = (flat(last_xy), flat(last_dxdy), flat(social_feats), h0)
        if _split(spec):
            inputs = tuple(reduce.to_model(x) for x in inputs)
        abs_g, rel_g = decode_all_kernel.decode_all(
            stacked, *inputs, spec.pred_len, spec.inp_format, compute_dtype)
        shape = (g, k, s, p, spec.pred_len, 2)
        reshape = lambda x: x.reshape(shape).transpose(0, 1)
        if gather and _split(spec):
            reshape = lambda x: reduce.gather_gens(x.reshape(shape), dim=0).transpose(0, 1)
        return GeneratorOutput(rel=reshape(rel_g), abs=reshape(abs_g))


def decode_select(params, spec: GeneratorSpec, last_xy, last_dxdy, enc_h,
                  social_feats, noise, gen_idxs, compute_dtype=None,
                  fuse_select: bool = True):
    """Decode only the sampled generator per (sample, agent); under
    generator parallelism each rank decodes the rows of its generators and
    the rows are summed over the model group.

    With ``fuse_select`` (the default, for paths without a gradient) this is
    the fused-selection kernel K1 on CUDA tensors and its plain version on
    CPU tensors (``ops/kernels/decoder.py``): the per-agent inputs go in
    once; only ``h0`` and the generator index have a row per sample. K1 has
    no backward, so a gradient path (the G step) passes
    ``fuse_select=False`` and gets ``decode_all`` followed by the one-hot
    gather (JAX ``generator.py:294-302``). ``compute_dtype=torch.bfloat16``
    selects the kernels' bf16 variants.

    Args:
        noise: (K, S, P, z); gen_idxs: (S, P, K) int.
    Returns:
        GeneratorOutput with abs/rel of shape (K, S, P, pred_len, 2).
    """
    split = _split(spec)
    if not fuse_select:
        out = decode_all(params, spec, last_xy, last_dxdy, enc_h, social_feats,
                         noise, compute_dtype)
        with span("mggan.rollout"):
            first = reduce.model_rank() * out.rel.shape[1] if split else 0
            pick = lambda x: sampling.gather_samples(x, gen_idxs, first, spec.num_gens)
            both = torch.stack([pick(out.rel), pick(out.abs)])
            if split:
                both = reduce.from_model(both)
            return GeneratorOutput(rel=both[0], abs=both[1])
    if spec.discrete:
        # each row's h0 from its sampled identity, then the one decoder
        onehot = F.one_hot(gen_idxs.permute(2, 0, 1).long(), spec.num_gens).to(enc_h.dtype)
        h0, stacked = _decoder_h0(params, enc_h, noise, onehot), _one_decoder(params)
    else:
        h0, stacked = _decoder_h0(params, enc_h, noise), params["decoders"]
    with span("mggan.rollout"):
        flat = lambda x: _rows(x).contiguous()
        # rows are (k, s, p)-major, the order _decoder_h0 produces
        idx = gen_idxs.permute(2, 0, 1).reshape(-1).to(torch.int32).contiguous()
        if spec.discrete:
            idx = torch.zeros_like(idx)
        xy, dxdy, soc, h0 = flat(last_xy), flat(last_dxdy), flat(social_feats), h0.contiguous()
        if not split:
            abs_sel, rel_sel = decoder_kernel.decode_select(
                stacked, xy, dxdy, soc, h0, idx, spec.pred_len, spec.inp_format,
                compute_dtype)
            return GeneratorOutput(rel=_reshape_samples(rel_sel, spec, noise),
                                   abs=_reshape_samples(abs_sel, spec, noise))
        # this rank's rows: those whose sampled generator it holds, each with
        # its own per-agent inputs; a rank with none skips the launch
        g = _stacked_gens(stacked)
        first = reduce.model_rank() * g
        rows = ((idx >= first) & (idx < first + g)).nonzero()[:, 0]
        both = h0.new_zeros((2, idx.shape[0], spec.pred_len, 2))
        if rows.numel():
            agent = rows % xy.shape[0]
            abs_sel, rel_sel = decoder_kernel.decode_select(
                stacked, xy[agent].contiguous(), dxdy[agent].contiguous(),
                soc[agent].contiguous(), h0[rows].contiguous(),
                (idx[rows] - first).contiguous(), spec.pred_len, spec.inp_format,
                compute_dtype)
            both[0, rows], both[1, rows] = rel_sel.to(both.dtype), abs_sel.to(both.dtype)
        both = reduce.from_model(both)
        return GeneratorOutput(rel=_reshape_samples(both[0], spec, noise),
                               abs=_reshape_samples(both[1], spec, noise))
