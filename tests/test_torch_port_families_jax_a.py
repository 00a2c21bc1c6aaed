"""Train-step families against the JAX step, part A: cases A and B (CPU).

Each case is one compiled JAX step (``test_torch_port_families.run_case``:
the same weights and replayed draws at the golden size; metrics and the
parameters after the step at atol/rtol 1e-4, the conv biases before
train-mode BN within 2 * lr per update) covering several settings:

* A: the MM objective, the endpoint PM target, ``min_z``, ``inp_format=abs``
  (K1, K2 and K3 on positions) and no global D context (``global_disc=0``);
* B: the LS objective (unbounded heads), the mgan PM target with
  ``wt_mgan_compat=0`` (a D call on the ground truth), ``mse`` and SGAN
  pooling in G and D;

Case C is in ``test_torch_port_families_jax_d.py``, E in ``_jax_b.py`` and
D in ``_jax_c.py`` (one file each, to keep each file's JAX compiles under
about 90 s).
"""

import pytest

from test_torch_port_families import run_case

CASES = {
    "A": dict(gan_obj="MM", weighting_target="endpoint", l2_loss_type="min_z",
              inp_format="abs", global_disc=0),
    "B": dict(gan_obj="LS", weighting_target="mgan", wt_mgan_compat=0,
              l2_loss_type="mse", pool_type="sgan"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    run_case(CASES[case])
