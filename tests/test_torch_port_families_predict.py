"""Inference for the families beyond the flagship against the JAX package (CPU).

Models without a PM-net (the learnable prior's logits): one gan
generator with no PM target, and the discrete generator with sgan pooling
and ``abs`` input, at the golden size with JAX's weights:
``Predictor.predict`` (PM-categorical sampling; the fused selection, K1's
plain version) on the JAX Predictor's replayed draws, and
``decode_all`` (K2's plain version; the discrete generator's rows
identity-major on its one decoder) on the same noise. Tolerances: the
sampled generators equal, everything else atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.eval.predict import Predictor as JaxPredictor
from mggan_tpu.models import generator as jax_G
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import generator as G_mod
from mggan_tpu_torch.training.steps import batch_views
from test_torch_port_families import GOLDEN_SIZE
from test_torch_port_slice import _jax_draws as _jax_predict_draws
from test_torch_port_train import _batch, _port_packs

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    {"gan_type": "gan", "weighting_target": "none", "unconditional": True, "num_gens": 1},
    {"experiment": "discrete", "unconditional": True, "pool_type": "sgan",
     "inp_format": "abs"},
], ids=["gan-none-uncond-G1", "discrete-uncond-sgan-abs"])
def test_predictor_matches_jax(kw):
    """Models without a PM-net (the prior's logits: one gan generator with
    no PM target; the discrete generator with sgan pooling and ``abs``
    input) sample through ``Predictor`` as the JAX Predictor does on the
    same draws (generators equal, positions within 1e-4), and
    ``decode_all`` (every generator; the discrete one's identity-major
    rows) equals JAX's."""
    cfg = JaxConfig(**{**GOLDEN_SIZE, **kw})
    (g_pack, _), pcfg, (gp, gs, g_spec), _ = _port_packs(cfg)
    s, p, num = 3, 4, 5
    batch = _batch(s, p, seed=2)
    out_j = JaxPredictor(cfg, g_pack[2], g_pack[0], g_pack[1]).predict(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(11), num=num)
    draws = _jax_predict_draws(11, s, p, num, cfg.num_gens, cfg.noise_dim)
    out_p = Predictor(pcfg, g_spec, gp, gs, device="cpu").predict(batch, num=num, draws=draws)
    np.testing.assert_array_equal(out_p[3].numpy(), np.asarray(out_j[3]))
    for got, want in zip(out_p[:3], out_j[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    bv = batch_views({k: torch.from_numpy(v) for k, v in batch.items()})
    j_args = [jnp.asarray(x.numpy()) for x in (bv.in_xy, bv.in_dxdy, bv.ped_mask, bv.patches)]
    enc_j, soc_j, _ = jax_G.encode(g_pack[0], g_pack[1], g_pack[2], *j_args, train=False)
    z = np.random.RandomState(4).randn(2, s, 1, cfg.noise_dim).astype(np.float32)
    noise = np.broadcast_to(z, (2, s, p, cfg.noise_dim))
    want = jax_G.decode_all(g_pack[0], g_pack[2], j_args[0][:, :, -1], j_args[1][:, :, -1],
                            enc_j, soc_j, jnp.asarray(noise))
    enc_p, soc_p, _ = G_mod.encode(gp, gs, g_spec, bv.in_xy, bv.in_dxdy, bv.ped_mask,
                                   bv.patches)
    got = G_mod.decode_all(gp, g_spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1], enc_p,
                           soc_p, torch.from_numpy(noise.copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
