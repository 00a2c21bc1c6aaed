"""Train-step families against the JAX step, part B: case E (CPU).

As ``test_torch_port_families_jax_a.py`` (``run_case``), for:

* E-discrete: the discrete-latent generator (one decoder, the identity in
  h0; K1 on the sampled rows, K2 and K3 on every identity's rows) with the
  learnable prior in place of the PM-net (``unconditional``);
* E-uncond: one generator, gan, no PM target, no L2 loss, ``unconditional``.

Case D (unrolling and gating) is in ``test_torch_port_families_jax_c.py``.
"""

import pytest

from test_torch_port_families import run_case

CASES = {
    "E-discrete": dict(experiment="discrete", unconditional=True),
    "E-uncond": dict(gan_type="gan", weighting_target="none", l2_loss_type="none",
                     unconditional=True, num_gens=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    (metrics,) = run_case(CASES[case])
    if case == "E-uncond":
        assert "train/L2_loss" not in metrics and "train/net_chooser_loss" not in metrics
