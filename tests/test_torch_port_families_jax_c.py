"""Train-step families against the JAX step, part C: case D (CPU).

As ``test_torch_port_families_jax_a.py`` (``run_case``), for unrolling
and gating (``num_unrolling_steps=2``, ``num_gen_steps=2``,
``keep_gen_steps=1``) with the mgan PM target in its reference-literal
form (``wt_mgan_compat=1``), two steps from epoch 0: the first runs three
D updates on ``fold_in(kd, u)`` draws, G and PM against the unrolled D,
then ``d_params`` back to the first update's (the D optimizer state and
BN statistics stay unrolled, as in JAX); the second is gated out and
reports every D metric as NaN.
"""

import math

from test_torch_port_families import run_case

CASE_D = dict(num_unrolling_steps=2, num_gen_steps=2, keep_gen_steps=1,
              weighting_target="mgan", wt_mgan_compat=1)


def test_train_step_matches_jax():
    first, second = run_case(CASE_D, n_steps=2)
    d_keys = [k for k in first if k.startswith("gradnorm/D/") or k in (
        "train/discr_loss", "train/info_mgan_disc_loss", "train/grad_norm_D", "train/lr_D")]
    assert len(d_keys) > 4 and all(math.isfinite(first[k]) for k in d_keys)
    assert set(second) == set(first)  # the gated-out step names every D metric
    assert all(math.isnan(second[k]) for k in d_keys)
    assert all(math.isfinite(v) for k, v in second.items() if k not in d_keys)
