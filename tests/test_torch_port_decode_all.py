"""Port of the all-generator rollout (K2) and its reverse sweep (K3): the
plain versions and ``DecodeAll`` held against the JAX Pallas kernels in
interpret mode, forward and gradients.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``). Tolerances: forward atol 1e-4 (the
repo's 12-step rollout tolerance); gradients rtol/atol 2e-4, as
``tests/test_pallas_decoder.py`` holds the TPU kernel's backward; the
reverse sweep against autograd in float64 at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.models import common as jax_common
from mggan_tpu.ops.pallas import decoder as jax_dec

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.ops.sampling import gather_samples
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

T = 12
ATOL = 1e-4
FORMATS = ["rel", "abs", "abs_rel"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_dec.INTERPRET = True
    yield
    jax_dec.INTERPRET = False


def make_case(inp_format, G=2, M=10, K=4, EMB=8, H=16, F=4, seed=2):
    """JAX-initialised decoders and numpy per-agent inputs: M rows of
    xy/dxdy/social, N = K*M rows of h0 (rollout n reads agent n % M)."""
    stacked = jax.tree.map(np.asarray, jax_common.stacked_decoders_init(
        jax.random.PRNGKey(seed), G, EMB, H, inp_format, F))
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    return stacked, (f32(M, 2), f32(M, 2) * 0.3, f32(M, F), f32(K * M, H))


def _torch(tree, dtype=torch.float32):
    return tree_map(lambda x: torch.tensor(np.asarray(x), dtype=dtype), tree)


def _tiled(rows):
    """The JAX kernel takes one row of every input per rollout."""
    xy, dxdy, soc, h0 = rows
    k = h0.shape[0] // xy.shape[0]
    tile = lambda x: jnp.asarray(np.tile(x, (k, 1)))
    return tile(xy), tile(dxdy), tile(soc), jnp.asarray(h0)


def _weighted(a, r, xp):
    """The loss of test_pallas_decoder.py: asymmetric weights so abs/rel
    cotangents differ per element."""
    wa = xp.linspace(0.5, 1.5, a.size if xp is jnp else a.numel()).reshape(a.shape)
    wr = xp.linspace(-1.0, 1.0, r.size if xp is jnp else r.numel()).reshape(r.shape)
    return (a * wa).sum() + (r * wr).sum()


@pytest.mark.parametrize("inp_format", FORMATS)
def test_forward_matches_pallas_decode_all(inp_format):
    stacked, rows = make_case(inp_format)
    want = jax_dec.pallas_decode_all(stacked, *_tiled(rows), T, inp_format)
    st, xy, dxdy, soc, h0 = _torch(stacked), *map(torch.from_numpy, rows)
    got_fn = kda.decode_all(st, xy, dxdy, soc, h0, T, inp_format)
    packed = kdec.pack_decoder_params(st, inp_format)
    got_ref = kda.decode_all_reference(
        *(packed[k] for k in kda.PACKED), kdec.social_bias(packed, soc), h0, xy,
        dxdy, T, inp_format, save_hc=True)
    assert got_ref[2].shape == (2, h0.shape[0], T, 2, 16)
    for got in (got_fn, got_ref[:2]):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # the all-generator rollout is stacked_decoders_apply on tiled rows
    tile = lambda x: x.repeat(h0.shape[0] // xy.shape[0], 1)
    scan = common.stacked_decoders_apply(st, tile(xy), tile(dxdy), tile(soc), h0,
                                         T, inp_format)
    for g, w in zip(got_fn, scan):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


@pytest.mark.parametrize("inp_format", FORMATS)
@pytest.mark.parametrize("k", [1, 4])  # M == N, and M-row inputs broadcast
def test_grads_match_pallas_vjp(inp_format, k):
    """DecodeAll's gradients w.r.t. the stacked params and every input equal
    jax.grad through pallas_decode_all (the TPU kernel K3, interpret mode);
    the grads of the M-row inputs are JAX's summed over the K copies."""
    stacked, rows = make_case(inp_format, K=k)

    def loss(p, *r):
        return _weighted(*jax_dec.pallas_decode_all(p, *r, T, inp_format), jnp)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(stacked, *_tiled(rows))
    st = _torch(stacked)
    ins = [torch.from_numpy(x) for x in rows]
    leaves = [x.requires_grad_() for x in tree_leaves(st) + ins]
    a, r = kda.decode_all(st, *ins, T, inp_format)
    pg = torch.autograd.grad(_weighted(a, r, torch), leaves, allow_unused=True)
    pg = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, pg)]
    n_par = len(tree_leaves(st))
    want = tree_leaves(_torch(jg[0])) + [
        torch.from_numpy(np.array(g)).reshape((k, -1) + tuple(g.shape[1:])).sum(0)
        for g in jg[1:4]] + [torch.from_numpy(np.array(jg[4]))]
    assert len(pg) == len(want) == n_par + 4
    for g, w in zip(pg, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("inp_format", FORMATS)
def test_bwd_reference_matches_autograd_in_float64(inp_format):
    """The explicit reverse sweep (K3's plain version) equals PyTorch
    autograd through the plain forward, in float64."""
    stacked, rows = make_case(inp_format, G=3, M=5, K=3, H=8, F=3, seed=7)
    f64 = torch.float64
    st = _torch(stacked, f64)
    packed = kdec.pack_decoder_params(st, inp_format)
    xy, dxdy, soc, h0 = (torch.tensor(x, dtype=f64) for x in rows)
    inputs = [packed[k].detach() for k in kda.PACKED]
    inputs += [kdec.social_bias(packed, soc).detach(), h0, xy, dxdy]
    for x in inputs:
        x.requires_grad_()
    a, r, hc = kda.decode_all_reference(*inputs, T, inp_format, save_hc=True)
    rng = np.random.RandomState(0)
    g_abs = torch.tensor(rng.randn(*a.shape), dtype=f64)
    g_rel = torch.tensor(rng.randn(*r.shape), dtype=f64)
    want = torch.autograd.grad((a * g_abs).sum() + (r * g_rel).sum(), inputs,
                               allow_unused=True)
    got = kda.decode_all_bwd_reference(*(x.detach() for x in inputs), a.detach(),
                                       r.detach(), hc.detach(), g_abs, g_rel, T,
                                       inp_format)
    for g, w, x in zip(got, want, inputs):
        w = torch.zeros_like(x) if w is None else w
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


def test_weight_grad_image_layout():
    """``weight_grads_from_image`` reads K3's per-generator grad image
    (dWhh^T [j][k][gate] | dWemb [in][j][gate] | db [j][gate] | dW1h^T
    [q][k] | dW2 | db2) into the folded weights' gate-major layout."""
    g, h, hid, in_dim = 2, 3, 2, 4
    w_emb = torch.randn(g, in_dim, 4 * h)
    w_hh = torch.randn(g, h, 4 * h)
    b, w1h = torch.randn(g, 4 * h), torch.randn(g, h, hid)
    w2, b2 = torch.randn(g, hid, 2), torch.randn(g, 2)
    gate = lambda w, gi, j: w[..., gi * h + j]
    image = []
    for gg in range(g):
        row = [gate(w_hh[gg, k], c, j) for j in range(h) for k in range(h) for c in range(4)]
        row += [gate(w_emb[gg, i], c, j) for i in range(in_dim) for j in range(h)
                for c in range(4)]
        row += [gate(b[gg], c, j) for j in range(h) for c in range(4)]
        row += [w1h[gg, k, q] for q in range(hid) for k in range(h)]
        row += list(w2[gg].reshape(-1)) + list(b2[gg])
        image.append(torch.stack(row))
    got = kda.weight_grads_from_image(torch.stack(image), h, hid, in_dim)
    for a, w in zip(got, (w_emb, w_hh, b, w1h, w2, b2)):
        assert torch.equal(a, w)


def test_decode_select_refuses_autograd_and_decode_all_gather_replaces_it():
    """K1 has no backward: under autograd it raises rather than train the
    decoders with no signal; decode-all + gather is the gradient path and
    gives the same rollouts."""
    stacked, rows = make_case("rel", G=3, M=6, K=2)
    st = _torch(stacked)
    xy, dxdy, soc, h0 = map(torch.from_numpy, rows)
    idx = torch.tensor(np.random.RandomState(1).randint(0, 3, h0.shape[0]),
                       dtype=torch.int32)
    want = kdec.decode_select(st, xy, dxdy, soc, h0, idx, T, "rel")
    st_g = tree_unflatten(st, [x.clone().requires_grad_() for x in tree_leaves(st)])
    with pytest.raises(RuntimeError, match="no backward"):
        kdec.decode_select(st_g, xy, dxdy, soc, h0, idx, T, "rel")
    with torch.no_grad():
        kdec.decode_select(st_g, xy, dxdy, soc, h0, idx, T, "rel")
    a, r = kda.decode_all(st_g, xy, dxdy, soc, h0, T, "rel")  # (G, N, T, 2)
    pick = lambda x: gather_samples(x[None, :, None], idx.reshape(1, -1, 1))[0, 0]
    np.testing.assert_allclose(pick(a).detach().numpy(), want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(pick(r).detach().numpy(), want[1].numpy(), atol=ATOL)
    grads = torch.autograd.grad(pick(r).sum(), tree_leaves(st_g))
    assert all(torch.isfinite(g).all() for g in grads)
