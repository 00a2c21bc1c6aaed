"""probgan / ml's split train step against the JAX package's (CPU): one
step on the same weights and JAX's own draws, as
``test_torch_port_split.py`` holds mgan / ml (its module note has the
tolerances; probgan there has no global D, which shortens JAX's compile).
A file of its own: JAX compiles the probgan phases (five D heads, the
history and the SGHMC noise) for ~30 s on the CPU."""

import torch

from test_torch_port_split import check_split_against_jax

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)


def test_probgan_split_step_matches_jax_split_step():
    check_split_against_jax("probgan_ml")
