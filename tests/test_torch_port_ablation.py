"""The port's decoder ablation path against the JAX package (CPU).

Plain versions of the kernels of the ablation path held against the JAX
Pallas kernels in interpret mode, inputs from a numpy seed:

* K4's route (``decode_sorted.decode_select_sorted``: layout, the per-tile
  plain rollout, the gathers) against ``pallas_decode_select_sorted``;
* B2's plain version (``sorted_tiles_reference``) against
  ``_fwd_sorted_kernel`` launched alone, as ``kernel_only`` does;
* B1's activation variants against ``benchmarks/decode_ablation.py``'s
  ``variant_kernel(act)``;
* K5 (``decode_select(ilp=True)``) against ``pallas_decode_select(ilp=True)``;
* ``DecodeAll`` in bf16 (K2-bf16 forward, K3 in f32) against ``jax.grad``
  of ``pallas_decode_all(..., compute_dtype=bfloat16)``.

Tolerances: f32 atol 1e-4 (the repo's 12-step rollout tolerance); bf16
forward atol 2e-3 (as tests/test_torch_port_bf16.py: a bf16 rounding of h
can land on the other side between two summation orders); the bf16
gradients and B1-bf16 are stated at their tests, from the readings.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mggan_tpu.models import common as jax_common
from mggan_tpu.ops.pallas import decoder as jax_dec

from mggan_tpu_torch.ablations import decode_ablation as dab
from mggan_tpu_torch.ablations import sorted_select_ablation as sab
from mggan_tpu_torch.ops.kernels import decode_ablation as kab
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decode_sorted as ks
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T = 12
ATOL = 1e-4
BF16_ATOL = 2e-3
FORMATS = ["rel", "abs", "abs_rel"]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_dec.INTERPRET = True
    yield
    jax_dec.INTERPRET = False


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _torch(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x), dtype=torch.float32), tree)


def make_case(inp_format, G=3, N=70, EMB=8, H=16, F=8, seed=0, one_gen=None):
    """JAX-initialised decoders and numpy rows, one per rollout (N of each)."""
    stacked = _np_tree(jax_common.stacked_decoders_init(
        jax.random.PRNGKey(seed), G, EMB, H, inp_format, F))
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    rows = (f32(N, 2) * 3.0, f32(N, 2) * 0.3, f32(N, F), f32(N, H))
    idx = rng.randint(0, G, N).astype(np.int32) if one_gen is None \
        else np.full(N, one_gen, np.int32)
    return stacked, rows, idx


def _max_diff(got, want):
    return max(float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got, want))


# ------------------------------------------------------------------ K4 --
@pytest.mark.parametrize("inp_format,feat,one_gen", [
    ("rel", 8, None), ("abs", 8, None), ("abs_rel", 8, None),
    ("rel", 0, None),  # F = 0: socb = b1
    ("abs_rel", 8, 1),  # every row on one generator: the other groups are empty
])
def test_sorted_route_matches_pallas_sorted(inp_format, feat, one_gen):
    stacked, rows, idx = make_case(inp_format, F=feat, one_gen=one_gen)
    want = jax_dec.pallas_decode_select_sorted(stacked, *map(jnp.asarray, rows),
                                               jnp.asarray(idx), T, inp_format)
    got = ks.decode_select_sorted(_torch(stacked), *map(torch.from_numpy, rows),
                                  torch.from_numpy(idx), T, inp_format)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("inp_format", ["rel", "abs_rel"])
def test_sorted_route_bf16_matches_pallas_sorted(inp_format):
    stacked, rows, idx = make_case(inp_format, H=32, F=32, seed=1)
    args = (jnp.asarray(idx), T, inp_format)
    want = jax_dec.pallas_decode_select_sorted(stacked, *map(jnp.asarray, rows), *args,
                                               compute_dtype=jnp.bfloat16)
    ours = (_torch(stacked), *map(torch.from_numpy, rows), torch.from_numpy(idx), T,
            inp_format)
    got = ks.decode_select_sorted(*ours, compute_dtype=BF16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=BF16_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=BF16_ATOL)
    # the tolerance tells bf16 from f32: the f32 route lies beyond it
    assert _max_diff(ks.decode_select_sorted(*ours), want) > BF16_ATOL


def test_sorted_layout_invariants():
    rng = np.random.RandomState(3)
    g, tile = 4, 8
    idx = torch.from_numpy(rng.randint(0, g - 1, 61).astype(np.int32))  # generator 3 unused
    dest, inv, tile_gen, n_buf = ks.sorted_layout(idx, g, tile)
    n = idx.shape[0]
    assert n_buf == -(-n // tile) * tile + g * tile and inv.shape == (n_buf,)
    assert torch.equal(inv[dest], torch.arange(n))  # inv[dest] is the identity
    assert len(set(dest.tolist())) == n
    # every tile holds rows of its generator only, the rest read the zero row
    for t in range(n_buf // tile):
        rows = inv[t * tile:(t + 1) * tile]
        real = rows[rows < n]
        assert bool((idx[real] == tile_gen[t]).all())
        assert bool((rows[real.numel():] == n).all())  # stable: real rows first
    # stable rank: within a generator, rows keep their order
    for k in range(g):
        mine = dest[idx == k]
        assert bool((mine[1:] > mine[:-1]).all())
    assert tile_gen.dtype == torch.int32 and int(tile_gen.min()) >= 0
    assert int(tile_gen.max()) <= g - 1
    # padding rows read zeros; real rows their own
    h0 = torch.randn(n, 5)
    soc, xy, dxdy = torch.randn(n, 3), torch.randn(n, 2), torch.randn(n, 2)
    buf = ks.sorted_rows(h0, soc, xy, dxdy, inv)
    assert buf.shape == (n_buf, 12)
    assert bool((buf[inv == n] == 0).all())
    assert torch.equal(buf[dest], torch.cat([h0, soc, xy, dxdy], 1))
    # per-agent inputs (M rows, N = K * M) read row n % M
    m = 61
    idx2 = torch.from_numpy(rng.randint(0, g, 2 * m).astype(np.int32))
    dest2, inv2, _, _ = ks.sorted_layout(idx2, g, tile)
    h02 = torch.randn(2 * m, 5)
    buf2 = ks.sorted_rows(h02, soc, xy, dxdy, inv2)
    tiled = torch.cat([soc, xy, dxdy], 1).repeat(2, 1)
    assert torch.equal(buf2[dest2], torch.cat([h02, tiled], 1))


def test_sorted_route_rejects_rows_without_a_generator():
    stacked, rows, idx = make_case("rel", N=10)
    idx[3] = 3  # G = 3
    with pytest.raises(ValueError, match="outside"):
        ks.decode_select_sorted(_torch(stacked), *map(torch.from_numpy, rows),
                                torch.from_numpy(idx), T, "rel")


# ------------------------------------------------------------------ B2 --
def _pallas_sorted_tiles(stacked, rows, tile_gen, tile, inp_format):
    """``_fwd_sorted_kernel`` launched alone on grouped rows, as
    benchmarks/sorted_select_ablation.py::kernel_only launches it, with a
    tile of ``tile`` rows, in interpret mode."""
    h0, soc, xy, dxdy = rows
    h_dim, feat = h0.shape[1], soc.shape[1]
    w_ih = stacked["lstm"]["w_ih"]
    wemb = jnp.einsum("gie,geh->gih", stacked["spatial_embedding"]["w"], w_ih)
    b = (jnp.einsum("ge,geh->gh", stacked["spatial_embedding"]["b"], w_ih)
         + stacked["lstm"]["b_ih"] + stacked["lstm"]["b_hh"])[:, None, :]
    w1 = stacked["hidden2pos"]["lin0"]["w"]
    b1 = stacked["hidden2pos"]["lin0"]["b"][:, None, :]
    w2 = stacked["hidden2pos"]["lin1"]["w"]
    b2 = stacked["hidden2pos"]["lin1"]["b"][:, None, :]
    weights = [jnp.asarray(x) for x in (wemb, stacked["lstm"]["w_hh"], b, w1, b1, w2, b2)]
    n_buf = h0.shape[0]
    kernel = functools.partial(jax_dec._fwd_sorted_kernel, pred_len=T, inp_format=inp_format,
                               h_dim=h_dim, has_soc=True, compute_dtype=None)
    gspec = lambda a: pl.BlockSpec((1,) + a.shape[1:],
                                   lambda i, tg: (tg[i],) + (0,) * (a.ndim - 1))
    rowspec = lambda cols: pl.BlockSpec((tile, cols), lambda i, tg: (i, 0))
    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n_buf // tile,),
            in_specs=[gspec(w) for w in weights] + [rowspec(h_dim), rowspec(feat),
                                                    rowspec(2), rowspec(2)],
            out_specs=rowspec(T * 4)),
        out_shape=jax.ShapeDtypeStruct((n_buf, T * 4), jnp.float32),
        interpret=True,
    )(jnp.asarray(tile_gen), *weights, *map(jnp.asarray, rows))
    return np.asarray(out).reshape(n_buf, T, 2, 2)  # axis 2: [abs, rel]


@pytest.mark.parametrize("inp_format", ["rel", "abs_rel"])
def test_sorted_tiles_reference_matches_pallas_kernel_alone(inp_format):
    g, tile, tiles, h_dim, feat = 3, 8, 5, 16, 8
    stacked, _, _ = make_case(inp_format, G=g, H=h_dim, F=feat, seed=4)
    rng = np.random.RandomState(4)
    n_buf = tile * tiles
    rows = (rng.randn(n_buf, h_dim).astype(np.float32), rng.randn(n_buf, feat).astype(np.float32),
            rng.randn(n_buf, 2).astype(np.float32) * 3.0,
            rng.randn(n_buf, 2).astype(np.float32) * 0.3)
    tile_gen = (np.arange(tiles) * g // tiles).astype(np.int32)  # kernel_only's rule
    want = _pallas_sorted_tiles(stacked, rows, tile_gen, tile, inp_format)
    packed = kdec.pack_decoder_params(_torch(stacked), inp_format)
    got = ks.sorted_tiles_reference(torch.from_numpy(tile_gen), tile, packed,
                                    torch.from_numpy(np.concatenate(rows, 1)), h_dim, feat, T,
                                    inp_format)
    assert got.shape == (n_buf, 2, T, 2)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, :, 0], atol=ATOL)
    np.testing.assert_allclose(got[:, 1].numpy(), want[:, :, 1], atol=ATOL)


# ------------------------------------------------------------------ B1 --
@functools.cache
def _jax_decode_ablation():
    """benchmarks/decode_ablation.py as a module (its timings run only
    under ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "_decode_ablation_bench", ROOT / "benchmarks" / "decode_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _b1_case():
    g, n, h_dim, feat = 4, 64, 32, 32
    stacked, rows, idx = make_case("rel", G=g, N=n, EMB=16, H=h_dim, F=feat, seed=5)
    xy, dxdy, soc, h0 = map(jnp.asarray, rows)
    w_emb, w_hh, b, w1, w2, b2, socb = jax_dec._pack_all(stacked, soc, "rel")
    oh2 = jnp.repeat(jax.nn.one_hot(idx, g, dtype=jnp.float32), 2, axis=-1)
    inputs = (w_emb, w_hh, b, w1, w2, b2, h0, socb, xy, dxdy, oh2)
    dims = {"num_gens": g, "pred_len": T, "h_dim": h_dim}
    port = lambda act: kab.decode_select_act(_torch(stacked), *map(torch.from_numpy, rows),
                                             torch.from_numpy(idx), T, act)
    return inputs, dims, port


def _split(out, n):
    out = np.asarray(out).reshape(n, T, 2, 2)  # axis 2: [abs, rel]
    return out[:, :, 0], out[:, :, 1]


# Inside a jitted computation (the interpreter's too) XLA on the CPU keeps
# the intermediates of bf16 elementwise chains in f32 (excess precision), so
# variant_kernel("bf16") there rounds little more than the activations'
# inputs: read 1.3e-3 to 2.2e-3 from the port's bf16 arithmetic over four
# seeds, about as far as the f32 variant lies (1.4e-3 to 2.1e-3). The
# rounding of every op is pinned by the eager test below.
B1_BF16_XLA_ATOL = 3e-3


@pytest.mark.parametrize("act", ["f32", "bf16", "lin"])
def test_activation_variants_match_variant_kernel(act):
    inputs, dims, port = _b1_case()
    n = inputs[6].shape[0]
    kernel = functools.partial(_jax_decode_ablation().variant_kernel(act), **dims)
    out = pl.pallas_call(kernel, grid=(1,), interpret=True,
                         out_shape=jax.ShapeDtypeStruct((n, T * 4), jnp.float32))(*inputs)
    atol = B1_BF16_XLA_ATOL if act == "bf16" else ATOL
    for g, w in zip(port(act), _split(out, n)):
        np.testing.assert_allclose(g.numpy(), w, atol=atol)


class _OutRef:
    def __setitem__(self, key, value):
        self.value = value


def test_bf16_activations_round_every_op_as_variant_kernel():
    """variant_kernel("bf16")'s body run op by op (no fusion, so every bf16
    op rounds to bf16, as on the TPU): the port's bf16 arithmetic agrees
    within the f32 tolerance (read 9.5e-7 to 1.4e-6), and the f32 variant
    lies beyond it (1.8e-3 to 2.1e-3)."""
    inputs, dims, port = _b1_case()
    out = _OutRef()
    _jax_decode_ablation().variant_kernel("bf16")(*inputs, out, **dims)
    want = _split(out.value, inputs[6].shape[0])
    for g, w in zip(port("bf16"), want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)
    assert max(np.abs(g.numpy() - w).max() for g, w in zip(port("f32"), want)) > 10 * ATOL


# ------------------------------------------------------------------ K5 --
@pytest.mark.parametrize("inp_format", ["rel", "abs_rel"])
def test_ilp_select_matches_pallas_ilp(inp_format):
    stacked, rows, idx = make_case(inp_format, G=4, N=70, seed=6)
    onehot = jax.nn.one_hot(idx, 4, dtype=jnp.float32)
    want = jax_dec.pallas_decode_select(stacked, *map(jnp.asarray, rows), onehot, T,
                                        inp_format, ilp=True, interpret=True)
    args = (_torch(stacked), *map(torch.from_numpy, rows), torch.from_numpy(idx), T,
            inp_format)
    got = kdec.decode_select(*args, ilp=True)  # CPU tensors: K1's plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    for g, w in zip(got, kdec.decode_select(*args)):
        assert torch.equal(g, w)


# ------------------------------------------------------------ K3 on bf16 --
# The bf16 forward's grads: K3 sweeps in f32 on both sides from the bf16
# forward's residuals; they read 2.4e-4 at most against grads of up to
# ~3.3e3 (the f32 pair reads 6e-5 to 4.9e-4 at these sizes), so the f32
# tolerance of tests/test_torch_port_decode_all.py holds. The f32 forward's
# grads read 0.39 to 9.7 from JAX's bf16 ones (three formats, two seeds).
BF16_GRAD_ATOL = BF16_GRAD_RTOL = 2e-4


def _weighted(a, r, xp):
    wa = xp.linspace(0.5, 1.5, a.size if xp is jnp else a.numel()).reshape(a.shape)
    wr = xp.linspace(-1.0, 1.0, r.size if xp is jnp else r.numel()).reshape(r.shape)
    return (a * wa).sum() + (r * wr).sum()


def test_bf16_decode_all_grads_match_pallas_vjp():
    inp_format = "rel"  # K3's other formats: tests/test_torch_port_decode_all.py
    stacked, rows, _ = make_case(inp_format, G=2, N=32, H=32, F=8, seed=7)

    def loss(p, *r):
        out = jax_dec.pallas_decode_all(p, *r, T, inp_format, jnp.bfloat16)
        return _weighted(*out, jnp)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(stacked, *map(jnp.asarray, rows))
    want = tree_leaves(_torch(jg[0])) + [torch.from_numpy(np.array(g)) for g in jg[1:]]

    def port_grads(compute_dtype):
        st = _torch(stacked)
        ins = [torch.from_numpy(x) for x in rows]
        leaves = [x.requires_grad_() for x in tree_leaves(st) + ins]
        a, r = kda.decode_all(st, *ins, T, inp_format, compute_dtype=compute_dtype)
        pg = torch.autograd.grad(_weighted(a, r, torch), leaves, allow_unused=True)
        return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, pg)]

    got = port_grads(BF16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BF16_GRAD_RTOL,
                                   atol=BF16_GRAD_ATOL)
    # the f32 forward's grads lie beyond that tolerance
    f32 = port_grads(None)
    beyond = [bool((g - w).abs().gt(BF16_GRAD_ATOL + BF16_GRAD_RTOL * w.abs()).any())
              for g, w in zip(f32, want)]
    assert any(beyond)


def test_entry_points_raise_without_a_card(monkeypatch):
    """The ablation entry points time on the card only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (dab.main, sab.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(["--rows", "8"])
