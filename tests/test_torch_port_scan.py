"""JAX's decoder scan in torch ops (``mggan_tpu_torch/models/common.py``)
against ``mggan_tpu/models/common.py``'s ``lax.scan`` (CPU).

The port's ``relative_decoder_apply`` / ``stacked_decoders_apply`` copy
JAX's scan step by step, with its bf16 rounding under ``compute_dtype``.
They are the reference the kernels' plain versions are held against, and
no entry point runs them. Held here against JAX on the same weights and
inputs (h = 16, 2 generators):

* the rollouts in f32 within atol 1e-4; in bf16 (``jnp.bfloat16`` /
  ``torch.bfloat16``) positions within 4e-3 and 1e-5 on average. JAX's
  side is compiled with ``xla_allow_excess_precision`` off, so XLA's CPU
  backend rounds every bf16 value the scan's source rounds; with it on
  (XLA's default) the CPU keeps some of them in f32 and the two read up to
  1.6e-2 apart (9e-4 on average) at these shapes;
* the gradient of a loss through the f32 scan against ``jax.grad`` within
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.models import common as jax_common

from mggan_tpu_torch.models import common
from mggan_tpu_torch.utils.pytree import tree_items, tree_map

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

G, N, EMB, H, F, T = 2, 24, 8, 16, 8, 12
ATOL = 1e-4
BF16_ATOL, BF16_MEAN_ATOL = 4e-3, 1e-5
NO_EXCESS = {"xla_allow_excess_precision": False}


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _case(fmt, seed=0):
    """JAX-initialised stacked decoders and numpy row inputs."""
    stacked = _np_tree(jax_common.stacked_decoders_init(jax.random.PRNGKey(seed), G, EMB, H,
                                                        fmt, F))
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    return stacked, (f32(N, 2) * 3.0, f32(N, 2) * 0.3, f32(N, F), f32(N, H))


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x, dtype=np.float32)), tree)


@pytest.mark.parametrize("fmt", ["rel", "abs_rel"])
@pytest.mark.parametrize("bf16", [False, True])
def test_scan_matches_jax_scan(fmt, bf16):
    """``stacked_decoders_apply`` against JAX's on the CPU, f32 and bf16."""
    stacked, rows = _case(fmt)
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    fn = lambda p, *a: jax_common.stacked_decoders_apply(p, *a, T, fmt, jcd)
    want = jax.jit(fn).lower(stacked, *rows).compile(compiler_options=NO_EXCESS)(stacked,
                                                                                 *rows)
    got = common.stacked_decoders_apply(_torch(stacked), *(torch.from_numpy(r) for r in rows),
                                        T, fmt, tcd)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (G, N, T, 2) and g.dtype == np.float32
        assert np.isfinite(g).all()
        if bf16:
            err = np.abs(g - w)
            assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN_ATOL, \
                (err.max(), err.mean())
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fmt", ["rel", "abs_rel"])
def test_scan_gradient_matches_jax_grad(fmt):
    """The gradient of a loss through the f32 scan w.r.t. the decoders, the
    social features and h0, against ``jax.grad`` of the same loss."""
    stacked, (xy, dxdy, soc, h0) = _case(fmt, seed=1)
    rng = np.random.RandomState(2)
    wa, wr = rng.randn(G, N, T, 2).astype(np.float32), rng.randn(G, N, T, 2).astype(np.float32)

    def jax_loss(p, s, h):
        a, r = jax_common.stacked_decoders_apply(p, xy, dxdy, s, h, T, fmt)
        return jnp.sum(a * wa) + jnp.sum(r * wr)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(stacked, soc, h0)
    leaf = lambda x: x.detach().clone().requires_grad_(True)
    params = tree_map(leaf, _torch(stacked))
    s, h = leaf(torch.from_numpy(soc)), leaf(torch.from_numpy(h0))
    a, r = common.stacked_decoders_apply(params, torch.from_numpy(xy), torch.from_numpy(dxdy),
                                         s, h, T, fmt)
    ((a * torch.from_numpy(wa)).sum() + (r * torch.from_numpy(wr)).sum()).backward()
    got = dict(tree_items(params))
    for path, w in tree_items(_np_tree(want[0])):
        np.testing.assert_allclose(got[path].grad.numpy(), w, atol=ATOL, rtol=ATOL,
                                   err_msg=str(path))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want[1]), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want[2]), atol=ATOL, rtol=ATOL)
