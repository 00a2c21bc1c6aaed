"""Port ops against their JAX counterparts on the same inputs (CPU).

Inputs come from numpy with a fixed seed, params from the JAX initialisers;
both go through the JAX function and the port's. Tolerance: atol 2e-5 for
single forwards (PARITY.md, loss-value section).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.models import common as jax_common
from mggan_tpu.ops import cnn as jax_cnn
from mggan_tpu.ops import linear as jax_linear
from mggan_tpu.ops import lstm as jax_lstm
from mggan_tpu.ops import sampling as jax_sampling
from mggan_tpu.ops import social as jax_social
from mggan_tpu.training import steps as jax_steps

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops import cnn, linear, lstm, sampling, social
from mggan_tpu_torch.training import steps

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ATOL = 2e-5


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("act", ["relu", "leakyrelu"])
def test_mlp_apply(act):
    params = jax_linear.mlp_init(jax.random.PRNGKey(0), [6, 16, 8, 3])
    x = _randn(_rng(), 5, 4, 6)
    _close(linear.mlp_apply(_t(params), _t(x), activation=act),
           jax_linear.mlp_apply(params, x, activation=act))
    _close(linear.linear_apply(_t(params["lin0"]), _t(x)),
           jax_linear.linear_apply(params["lin0"], x))


def test_mlp_apply_per_layer():
    params = jax_linear.mlp_init(jax.random.PRNGKey(1), [16, 32, 16])
    x = _randn(_rng(1), 7, 16)
    acts = ["leakyrelu", "none"]
    _close(linear.mlp_apply_per_layer(_t(params), _t(x), acts),
           jax_linear.mlp_apply_per_layer(params, x, acts))


def test_lstm_scan_and_cell():
    params = jax_lstm.lstm_init(jax.random.PRNGKey(2), 5, 12)
    rng = _rng(2)
    xs, h0, c0 = _randn(rng, 8, 9, 5), _randn(rng, 9, 12), _randn(rng, 9, 12)
    hs, (h, c) = lstm.lstm_scan(_t(params), _t(xs), _t(h0), _t(c0))
    hs_j, (h_j, c_j) = jax_lstm.lstm_scan(params, xs, h0, c0)
    _close(hs, hs_j)
    _close(h, h_j)
    _close(c, c_j)
    h1, c1 = lstm.lstm_cell(_t(params), _t(xs[0]), _t(h0), _t(c0))
    h1_j, c1_j = jax_lstm.lstm_cell(params, xs[0], h0, c0)
    _close(h1, h1_j)
    _close(c1, c1_j)


@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
def test_trajectory_encoder(inp_format):
    in_size = jax_common.input_size(inp_format)
    params = jax_common.trajectory_encoder_init(
        jax.random.PRNGKey(3), in_size, 16, 8)
    rng = _rng(3)
    in_xy = _randn(rng, 3, 4, 8, 2).cumsum(2)
    in_dxdy = in_xy[:, :, 1:] - in_xy[:, :, :-1]
    inp = common.get_input(_t(in_xy), _t(in_dxdy), inp_format)
    inp_j = jax_common.get_input(in_xy, in_dxdy, inp_format)
    _close(inp, inp_j)
    _close(common.trajectory_encoder_apply(_t(params), inp),
           jax_common.trajectory_encoder_apply(params, inp_j))


def test_social_attention_with_padding_and_single_ped_scene():
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params = {
        "embed": jax_linear.mlp_init(k1, [3, 32, 64, 16]),
        "w": jax_linear.linear_init(k2, 16, 16),
    }
    rng = _rng(4)
    s, p = 3, 5
    last_xy, last_dxdy = _randn(rng, s, p, 2) * 2, _randn(rng, s, p, 2) * 0.3
    enc_h = _randn(rng, s, p, 16)
    mask = np.zeros((s, p), bool)
    mask[0, :5] = True  # full scene
    mask[1, :3] = True  # two padded peds
    mask[2, :1] = True  # one ped: its row is zeroed
    args = (last_xy, last_dxdy, enc_h, mask)
    got = social.social_attention_apply(_t(params), *map(_t, args))
    want = jax_social.social_attention_apply(params, *args)
    _close(got, want)
    assert not got[2].abs().sum() and got[1, 3:].abs().sum() == 0
    _close(social.social_features(_t(last_xy), _t(last_dxdy), _t(mask)),
           jax_social.social_features(last_xy, last_dxdy, mask))


def test_scene_cnn_eval_with_running_stats():
    params, state = jax_cnn.scene_cnn_init(jax.random.PRNGKey(5), channels_cnn=16)
    rng = _rng(5)
    for bn in ("bn1", "bn2"):  # non-trivial BN params and running stats
        params[bn] = {"scale": 1 + 0.2 * _randn(rng, 16), "bias": 0.1 * _randn(rng, 16)}
        state[bn] = {"mean": 0.3 * _randn(rng, 16),
                     "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    patches = rng.uniform(-1, 1, (6, 33, 33, 4)).astype(np.float32)
    got = cnn.scene_cnn_apply(_t(params), _t(state), _t(patches))
    want, _ = jax_cnn.scene_cnn_apply(params, state, patches, False)
    assert got.shape == (6, 64)
    _close(got, want)


def test_categorical_and_global_noise_with_injected_draws():
    rng = _rng(6)
    logits = _randn(rng, 3, 4, 5)
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    num = 20
    want = jax_sampling.categorical(k2, logits, num)
    u = jax.random.uniform(k2, (num,) + logits.shape, minval=1e-20, maxval=1.0)
    got = sampling.categorical(_t(logits), num, uniforms=_t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want_z = jax_sampling.global_noise(k1, num, 3, 4, 8)
    z = jax.random.normal(k1, (num, 3, 1, 8))
    _close(sampling.global_noise(num, 3, 4, 8, z=_t(z)), want_z, atol=0)


def test_generator_draws_have_the_contract_shapes():
    gen = torch.Generator().manual_seed(0)
    idx = sampling.categorical(torch.zeros(2, 3, 4), 7, generator=gen)
    assert idx.shape == (2, 3, 7) and int(idx.min()) >= 0 and int(idx.max()) < 4
    z = sampling.global_noise(5, 2, 3, 8, generator=gen)
    assert z.shape == (5, 2, 3, 8) and torch.equal(z[:, :, 0], z[:, :, 2])


def test_gather_samples():
    rng = _rng(7)
    decoded = _randn(rng, 5, 3, 2, 4, 12, 2)
    idx = rng.randint(0, 3, (2, 4, 5)).astype(np.int32)
    _close(sampling.gather_samples(_t(decoded), _t(idx)),
           jax_sampling.gather_samples(decoded, idx), atol=0)


def test_batch_views_with_nan_futures():
    rng = _rng(8)
    xy = _randn(rng, 2, 3, 20, 2).cumsum(2)
    xy[1, 2, 15] = np.nan
    mask = np.array([[True, True, False], [True, True, True]])
    got = steps.batch_views({"xy": _t(xy), "ped_mask": _t(mask)})
    want = jax_steps.batch_views({"xy": jnp.asarray(xy), "ped_mask": jnp.asarray(mask)})
    for name in ("in_xy", "in_dxdy", "gt_xy", "gt_dxdy"):
        _close(getattr(got, name), getattr(want, name), atol=1e-6)
    for name in ("ped_mask", "loss_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.patches is None
