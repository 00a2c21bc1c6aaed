"""Train-step families against the JAX step, part D: case C and the PM
target both steps refuse (CPU).

As ``test_torch_port_families_jax_a.py`` (``run_case``), for case C:
infogan under the W objective (the gradient penalty's double backward
beside the code regression) with ``min_g_min_z``. Then
``weighting_target="disc_scores"``, which the JAX step refuses when it is
traced (steps.py:382) and the port's ``build_train_step`` when it is built.
"""

import jax
import jax.numpy as jnp
import pytest

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.training.state import init_train_state as jax_init_train_state
from mggan_tpu.training.steps import build_train_step as jax_build_train_step
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.training.steps import build_train_step
from test_torch_port_families import GOLDEN_SIZE, run_case
from test_torch_port_train import _batch

CASE_C = dict(gan_type="infogan", gan_obj="W", l2_loss_type="min_g_min_z")


def test_train_step_matches_jax():
    (metrics,) = run_case(CASE_C)
    assert {"train/disc_info_loss", "train/info_loss"} <= set(metrics)


def test_disc_scores_raises_in_both_steps():
    cfg = JaxConfig(weighting_target="disc_scores", **GOLDEN_SIZE)
    g_pack, d_pack = jax_factory.construct_model(cfg, jax.random.PRNGKey(0))
    j_state = jax_init_train_state(cfg, g_pack, d_pack, jax.random.PRNGKey(1))
    batch = {k: jnp.asarray(v) for k, v in _batch(4, 3).items()}
    with pytest.raises(NotImplementedError):
        jax_build_train_step(cfg, g_pack[2], d_pack[2])(j_state, batch)
    pcfg = Config.from_dict(cfg.to_dict())
    with pytest.raises(NotImplementedError, match="disc_scores"):
        build_train_step(pcfg, factory.build_specs(pcfg), factory.build_d_spec(pcfg))
