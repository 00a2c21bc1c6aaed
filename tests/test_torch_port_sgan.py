"""The legacy Social-GAN and the grid pooling against the JAX package (CPU).

Weights are drawn by the port (``generator_init`` / ``discriminator_init``)
and moved into JAX trees, which have the same keys and shapes (JAX's own
init would compile op by op); ``params_from_jax`` brings them back bit for
bit. Every JAX function runs jitted. Inputs come from numpy seeds, the
noise from ``jax.random`` as the JAX generator draws it, injected into the
port. Tolerances (PARITY.md): atol 2e-5 on a single forward (the
discriminator, ``social_pooling_apply``), 1e-4 over the 12-step rollout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.models import social_gan_legacy as jax_sgan
from mggan_tpu.ops import sampling as jax_sampling
from mggan_tpu.ops import social as jax_social

from mggan_tpu_torch.models import social_gan_legacy as sgan
from mggan_tpu_torch.ops import sampling, social
from mggan_tpu_torch.ops.linear import mlp_init
from mggan_tpu_torch.utils.pytree import tree_items, tree_map

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

FORWARD_ATOL = 2e-5
ROLLOUT_ATOL = 1e-4
S, P = 2, 5


def _to_jax(tree):
    return tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def _inputs(seed=0):
    """Observed and whole trajectories of S scenes x P peds (one padded
    ped, one scene of two), as numpy."""
    rng = np.random.RandomState(seed)
    xy = (rng.randn(S, P, 20, 2) * 0.3).cumsum(2).astype(np.float32)
    mask = np.ones((S, P), bool)
    mask[0, -1] = False
    mask[1, 2:] = False
    xy[~mask] = 0.0
    return xy, mask


def _port_and_jax(spec, init, seed):
    params = init(torch.Generator().manual_seed(seed), spec)
    jparams = _to_jax(params)
    back = sgan.params_from_jax(tree_map(lambda x: np.asarray(x), jparams), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(params),
                                                           tree_items(back)))
    return back, jparams


GEN_CASES = [dict(pooling_type=pool, noise_mix_type=mix)
             for pool in ("pool_net", "spool", "none") for mix in ("global", "ped")]
GEN_CASES += [dict(pooling_type="spool", noise_mix_type="ped", user_noise=True),
              dict(pooling_type="pool_net", pool_every_timestep=True, noise_dim=0),
              dict(pooling_type="spool", pool_every_timestep=True, noise_dim=0)]


@pytest.mark.parametrize("case", GEN_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_generator_matches_jax(case):
    case = dict(case)
    user = case.pop("user_noise", False)
    spec = sgan.SGANSpec(**case)
    jspec = jax_sgan.SGANSpec(**case)
    params, jparams = _port_and_jax(spec, sgan.generator_init, 1)
    xy, mask = _inputs()
    in_xy, in_dxdy = xy[:, :, :8], np.diff(xy[:, :, :8], axis=2)
    key = jax.random.PRNGKey(7)
    z = user_noise = None
    if spec.noise_dim:
        # what the JAX generator draws from its key (social_gan_legacy.py:108-115)
        shape = (S, 1 if spec.noise_mix_type == "global" else P, spec.noise_dim)
        z = np.array(jax.random.normal(key, shape))
    if user:
        user_noise = np.random.RandomState(3).randn(S, P, spec.noise_dim).astype(np.float32)
    run = jax.jit(functools.partial(jax_sgan.generator_apply, spec=jspec))
    want = run(jparams, in_xy=in_xy, in_dxdy=in_dxdy, ped_mask=mask, rng=key,
               user_noise=user_noise)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = sgan.generator_apply(params, spec, t(in_xy), t(in_dxdy), t(mask), z=t(z),
                               user_noise=t(user_noise))
    for g, w in zip(got, want):
        assert g.shape == (S, P, 12, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROLLOUT_ATOL, rtol=0)


def test_generator_draws_its_noise_and_refuses_what_jax_cannot_run():
    """Noise from a ``torch.Generator`` at the mixing's shape (standard
    normal whatever ``noise_type`` says, as in JAX); pooling every step
    with noise refused, where JAX fails on the shapes."""
    xy, mask = _inputs(1)
    in_xy, in_dxdy = torch.from_numpy(xy[:, :, :8]), torch.from_numpy(np.diff(xy[:, :, :8], axis=2))
    spec = sgan.SGANSpec(noise_type="uniform", noise_mix_type="global")
    params = sgan.generator_init(torch.Generator().manual_seed(0), spec)
    a = sgan.generator_apply(params, spec, in_xy, in_dxdy, torch.from_numpy(mask),
                             generator=torch.Generator().manual_seed(4))
    z = torch.randn((S, 1, spec.noise_dim), generator=torch.Generator().manual_seed(4))
    b = sgan.generator_apply(params, spec, in_xy, in_dxdy, torch.from_numpy(mask), z=z)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="expected"):
        sgan.generator_apply(params, spec, in_xy, in_dxdy, torch.from_numpy(mask),
                             z=torch.zeros(S, P, spec.noise_dim))
    bad = dict(pooling_type="pool_net", pool_every_timestep=True)
    with pytest.raises(ValueError, match="noise_dim=0"):
        sgan.generator_apply(sgan.generator_init(torch.Generator(), sgan.SGANSpec(**bad)),
                             sgan.SGANSpec(**bad), in_xy, in_dxdy, torch.from_numpy(mask),
                             generator=torch.Generator())
    jspec = jax_sgan.SGANSpec(**bad)
    with pytest.raises(TypeError):
        jax_sgan.generator_apply(_to_jax(sgan.generator_init(torch.Generator(),
                                                             sgan.SGANSpec(**bad))),
                                 jspec, in_xy.numpy(), in_dxdy.numpy(), mask,
                                 jax.random.PRNGKey(0))


@pytest.mark.parametrize("d_type", ["local", "global"])
def test_discriminator_matches_jax(d_type):
    spec, jspec = sgan.SGANSpec(d_type=d_type), jax_sgan.SGANSpec(d_type=d_type)
    params, jparams = _port_and_jax(spec, sgan.discriminator_init, 2)
    xy, mask = _inputs(2)
    dxdy = np.diff(xy, axis=2)
    want = jax.jit(functools.partial(jax_sgan.discriminator_apply, spec=jspec))(
        jparams, traj_xy=xy, traj_dxdy=dxdy, ped_mask=mask)
    got = sgan.discriminator_apply(params, spec, *map(torch.from_numpy, (xy, dxdy, mask)))
    assert got.shape == (S, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FORWARD_ATOL, rtol=0)


def test_social_pooling_matches_jax_on_cell_edges_and_out_of_bounds():
    """Peers on cell edges (multiples of 2 m / 8), on the grid's bounds
    (+-1 m: in at the left and top edge of the cell range, out at the right
    and bottom), outside it, a padded ped, a one-ped scene; and a random
    scene. The pooled output within 2e-5 of JAX's."""
    h = 6
    params = {"pool": mlp_init(torch.Generator().manual_seed(0), [64 * h, 5])}
    edges = np.array([[[0.0, 0.0], [0.25, 0.25], [-1.0, 1.0], [1.0, -1.0], [0.75, -0.5],
                       [-1.0, -0.99], [3.0, 0.0], [0.0, 0.0]],
                      [[5.0, 5.0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0]]],
                     np.float32)
    mask = np.zeros((2, 8), bool)
    mask[0, :7] = True
    mask[1, 0] = True
    rng = np.random.RandomState(5)
    scenes = [(edges, mask),
              ((rng.randn(3, 8, 2) * 0.8).astype(np.float32), rng.rand(3, 8) > 0.2)]
    jparams = _to_jax(params)
    run = jax.jit(jax_social.social_pooling_apply)
    for xy, m in scenes:
        enc = rng.randn(xy.shape[0], xy.shape[1], h).astype(np.float32)
        want = run(jparams, xy, enc, m)
        got = social.social_pooling_apply(params, *map(torch.from_numpy, (xy, enc, m)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FORWARD_ATOL, rtol=0)
        assert not got[~torch.from_numpy(m)].any()
    # the edge scene exercises both sides of the bounds: by the grid rule,
    # ped 0's grid holds peds 1, 2, 4 and 5 (5 in the bottom row), not 3
    # (x = +1 m) or 6
    rel = edges[0, :, None] - edges[0, None, :]  # pos_i - pos_j, so -rel[0] is pos_j - pos_0
    cx = np.floor((-rel[0, :, 0] + 1.0) / 2.0 * 8)
    cy = np.floor((1.0 + rel[0, :, 1]) / 2.0 * 8)
    inside = (cx >= 0) & (cx < 8) & (cy >= 0) & (cy < 8)
    assert inside[[1, 2, 4, 5]].all() and not inside[[3, 6]].any()


def test_uniform_global_noise_matches_jax_rule():
    """``noise_type="uniform"`` draws in [-1, 1), broadcast over peds;
    another type raises JAX's ValueError text in both packages."""
    z = sampling.global_noise(4, 3, 5, 8, generator=torch.Generator().manual_seed(0),
                              noise_type="uniform")
    assert z.shape == (4, 3, 5, 8) and float(z.min()) >= -1.0 and float(z.max()) < 1.0
    assert torch.equal(z[:, :, :1].expand_as(z), z)
    jz = jax_sampling.global_noise(jax.random.PRNGKey(0), 4, 3, 5, 8, noise_type="uniform")
    assert float(jnp.min(jz)) >= -1.0 and float(jnp.max(jz)) < 1.0
    given = torch.rand(2, 3, 1, 4)
    assert torch.equal(sampling.global_noise(2, 3, 5, 4, z=given, noise_type="uniform"),
                       given.expand(2, 3, 5, 4))
    for fn in (lambda: sampling.global_noise(1, 1, 1, 2, generator=torch.Generator(),
                                             noise_type="laplace"),
               lambda: jax_sampling.global_noise(jax.random.PRNGKey(0), 1, 1, 1, 2,
                                                 noise_type="laplace")):
        with pytest.raises(ValueError, match='Unrecognized noise type "laplace"'):
            fn()
