"""The port's bf16 compute mode against the JAX package's TPU kernels (CPU).

The JAX package has two bf16 numerics: its Pallas kernels round the matmul
operands to bf16 and keep c, the biases, W2 and every sum in f32, while its
portable XLA scan (the route JAX takes off the TPU) also stores c and the
gate products in bf16. The port follows the kernels, which is what users of
the TPU got. So nothing here compares with JAX's ``Predictor`` in bf16:
the reference is the JAX composition of the fused branch (``encode`` with
``compute_dtype``, ``_broadcast_decoder_inputs``, then
``pallas_decode_select`` / ``pallas_decode_all`` with ``jnp.bfloat16`` in
interpret mode), at atol 2e-3. bf16 against f32 moves a rollout by about
6e-3 at these sizes, so 2e-3 tells the right rounding apart from none.
Interpret-mode runs stay at <= 256 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import common as jax_common
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator
from mggan_tpu.ops.pallas import decoder as jax_dec
from mggan_tpu.training.steps import batch_views as jax_batch_views

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import common, factory
from mggan_tpu_torch.models import generator as G_mod
from mggan_tpu_torch.models.weights import generator_from_jax
from mggan_tpu_torch.ops import cnn
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

T = 12
BF16_ATOL = 2e-3
FORMATS = ["rel", "abs", "abs_rel"]
BF16 = torch.bfloat16


@pytest.fixture
def interpret():
    jax_dec.INTERPRET = True
    yield
    jax_dec.INTERPRET = False


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _torch(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x), dtype=torch.float32), tree)


def make_case(inp_format, G=4, M=64, K=4, H=32, F=32, seed=0):
    """JAX-initialised flagship-width decoders and numpy inputs: M agents,
    N = K*M rollout rows (row n reads agent n % M)."""
    stacked = _np_tree(jax_common.stacked_decoders_init(
        jax.random.PRNGKey(seed), G, H // 2, H, inp_format, F))
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    rows = (f32(M, 2) * 3.0, f32(M, 2) * 0.3, f32(M, F), f32(K * M, H))
    return stacked, rows, rng.randint(0, G, K * M).astype(np.int32)


def _tiled(rows):
    xy, dxdy, soc, h0 = rows
    k = h0.shape[0] // xy.shape[0]
    tile = lambda x: jnp.asarray(np.tile(x, (k, 1)))
    return tile(xy), tile(dxdy), tile(soc), jnp.asarray(h0)


@pytest.mark.parametrize("inp_format", FORMATS)
def test_bf16_select_reference_matches_pallas_select(inp_format):
    stacked, rows, idx = make_case(inp_format)
    onehot = jax.nn.one_hot(idx, 4, dtype=jnp.float32)
    want = jax_dec.pallas_decode_select(stacked, *_tiled(rows), onehot, T, inp_format,
                                        jnp.bfloat16, interpret=True)
    args = (_torch(stacked), *map(torch.from_numpy, rows), torch.from_numpy(idx), T,
            inp_format)
    got = kdec.decode_select(*args, compute_dtype=BF16)  # CPU tensors: the plain version
    f32 = kdec.decode_select_reference(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BF16_ATOL)
    # the tolerance tells bf16 from f32: the f32 positions lie beyond it
    assert np.abs(f32[0].numpy() - np.asarray(want[0])).max() > BF16_ATOL


@pytest.mark.parametrize("inp_format", FORMATS)
def test_bf16_decode_all_reference_matches_pallas_decode_all(inp_format, interpret):
    stacked, rows, _ = make_case(inp_format, M=32, K=2, seed=1)
    want = jax_dec.pallas_decode_all(stacked, *_tiled(rows), T, inp_format, jnp.bfloat16)
    got = kda.decode_all(_torch(stacked), *map(torch.from_numpy, rows), T, inp_format,
                         compute_dtype=BF16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BF16_ATOL)


@pytest.mark.parametrize("inp_format", FORMATS)
def test_bf16_weight_image_layout(inp_format):
    """The kernels' bf16 image (``csrc/decoder_rollout.cuh``): Whh, Wemb' and
    W1h rounded to bf16, two to a word, in the f32 image's orders and padded
    to 8 values, then b, W2 and b2 in f32, each generator's block a
    multiple of 4 words."""
    g, h, hid = 3, 8, 4
    stacked = common.stacked_decoders_init(torch.Generator().manual_seed(3), g, 4, h,
                                           inp_format, 5)
    packed = kdec.pack_decoder_params(stacked, inp_format)
    in_dim = packed["w_emb"].shape[1]
    f32_img, f32_per = kdec.kernel_weights(packed)
    img, per_gen = kdec.kernel_weights(packed, BF16)
    assert img.dtype == torch.float32 and per_gen % 4 == 0 and per_gen < f32_per
    words = img.numpy().reshape(g, per_gen)
    n_bf16 = h * h * 4 + in_dim * h * 4 + h * hid
    n_words = -(-n_bf16 // 8) * 4
    halves = words[:, :n_words].copy().view(np.uint16).astype(np.uint32)
    as_f32 = (halves << 16).view(np.float32)  # bf16 bits -> f32
    f32_words = f32_img.numpy().reshape(g, f32_per)
    off_b = (h * h + in_dim * h) * 4  # b in the f32 image
    f32_mats = np.concatenate([f32_words[:, :off_b], f32_words[:, off_b + 4 * h:][:, :h * hid]], 1)
    want = torch.from_numpy(f32_mats).to(BF16).float().numpy()
    np.testing.assert_array_equal(as_f32[:, :n_bf16], want)
    assert not as_f32[:, n_bf16:].any()
    tail = np.concatenate([f32_words[:, off_b:off_b + 4 * h],
                           f32_words[:, off_b + 4 * h + h * hid:off_b + 4 * h + h * hid + hid * 2 + 2]], 1)
    np.testing.assert_array_equal(words[:, n_words:n_words + tail.shape[1]], tail)


def test_bf16_scene_cnn_within_the_jax_envelope():
    """tests/test_ops.py::test_scene_cnn_folded_bf16_eval_path's checks on
    the port: the folded path in f32 equals the unfolded one; in bf16 it
    stays within 5% of the f32 output's scale."""
    gen = torch.Generator().manual_seed(0)
    params, _ = cnn.scene_cnn_init(gen, channels_cnn=16)
    rng = np.random.RandomState(7)
    state = {bn: {"mean": torch.from_numpy(rng.randn(16).astype(np.float32) * 0.3),
                  "var": torch.from_numpy(rng.uniform(0.5, 2.0, 16).astype(np.float32))}
             for bn in ("bn1", "bn2")}
    x = torch.from_numpy(rng.uniform(-1, 1, (10, 33, 33, 4)).astype(np.float32))
    ref = cnn.scene_cnn_apply(params, state, x)
    folded = cnn.scene_cnn_apply(params, state, x, torch.float32)
    np.testing.assert_allclose(folded.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    low = cnn.scene_cnn_apply(params, state, x, BF16)
    assert low.dtype == torch.float32
    err = (low - ref).abs().max().item()
    assert err <= 0.05 * max(ref.abs().max().item(), 1e-3)


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship generator (mgan, G=4, h=32, sways social, scene CNN)
    with non-trivial BatchNorm statistics, and the port's copy."""
    cfg = JaxConfig(dataset="synthetic_memory", num_gens=4, gan_type="mgan",
                    weighting_target="ml", h_dim=32, decoder_h_dim=32)
    g_spec, _ = jax_factory.build_specs(cfg)
    g_params, _ = jax.jit(jax_generator.init, static_argnums=1)(jax.random.PRNGKey(0), g_spec)
    rng = np.random.RandomState(8)
    g_state = {"scene": {bn: {"mean": rng.randn(16).astype(np.float32) * 0.3,
                              "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
                         for bn in ("bn1", "bn2")}}
    port_cfg = Config.from_dict(cfg.to_dict())
    spec = factory.build_specs(port_cfg)
    params, state = generator_from_jax(_np_tree(g_params), g_state, spec, device="cpu")
    rng = np.random.RandomState(0)
    s, p = 2, 4
    batch = {"xy": rng.randn(s, p, 20, 2).astype(np.float32).cumsum(2) * 0.1,
             "ped_mask": np.ones((s, p), bool),
             "patches": rng.uniform(-1, 1, (s, p, 33, 33, 4)).astype(np.float32)}
    return {"jax": (g_params, g_state, g_spec), "cfg": port_cfg, "spec": spec,
            "params": params, "state": state, "batch": batch}


def _jax_fused(flagship, noise, gen_idxs=None):
    """The JAX composition of the TPU route in bf16: encode, the decoder
    prologue, then pallas_decode_select (with ``gen_idxs``) or
    pallas_decode_all. Returns (abs, enc_h, social_feats)."""
    g_params, g_state, g_spec = flagship["jax"]
    bv = jax_batch_views({k: jnp.asarray(v) for k, v in flagship["batch"].items()})
    enc_h, social, _ = jax_generator.encode(
        g_params, g_state, g_spec, bv.in_xy, bv.in_dxdy, bv.ped_mask, bv.patches,
        False, compute_dtype=jnp.bfloat16)
    rows = jax_generator._broadcast_decoder_inputs(
        g_params, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1], enc_h, social,
        jnp.asarray(noise))
    k, s, p, _ = noise.shape
    if gen_idxs is None:
        a, _ = jax_dec.pallas_decode_all(g_params["decoders"], *rows, T, "rel", jnp.bfloat16)
        return np.asarray(a).reshape(4, k, s, p, T, 2).swapaxes(0, 1), enc_h, social
    onehot = jax.nn.one_hot(jnp.moveaxis(jnp.asarray(gen_idxs), -1, 0).reshape(-1), 4)
    a, _ = jax_dec.pallas_decode_select(g_params["decoders"], *rows, onehot, T, "rel",
                                        jnp.bfloat16)
    return np.asarray(a).reshape(k, s, p, T, 2), enc_h, social


def test_bf16_predictor_matches_the_jax_kernels(flagship, interpret):
    """``Predictor(compute_dtype=bfloat16)``: the decodes of ``sampling``
    (K1's bf16 plain version) and of the decode-all strategies (K2's), given
    JAX's encodings, within 2e-3 of the Pallas kernels in bf16; the bf16
    encodings within the scene CNN's bf16 envelope of JAX's; the whole
    strategies run and stay within bf16 reach of the f32 ones."""
    k = 8  # 2 scenes x 4 peds x 8 samples = 64 rows (x 4 generators)
    batch = flagship["batch"]
    s, p = batch["ped_mask"].shape
    rng = np.random.RandomState(3)
    z = rng.randn(k, s, 1, 8).astype(np.float32)
    uniforms = rng.uniform(1e-6, 1.0, (k, s, p, 4)).astype(np.float32)
    port = Predictor(flagship["cfg"], flagship["spec"], flagship["params"],
                     flagship["state"], device="cpu", compute_dtype=BF16)
    out = port.predict(batch, num=k, draws={"z": z, "uniforms": uniforms})
    noise = np.broadcast_to(z, (k, s, p, 8))
    want_sel, enc_h, social = _jax_fused(flagship, noise, np.asarray(out[3]))
    want_all, _, _ = _jax_fused(flagship, noise)

    bv, _ = port._inputs(batch, None)
    got_enc, got_soc, _ = port._encode(bv)
    scale = np.abs(np.asarray(enc_h)).max()
    assert np.abs(got_enc.numpy() - np.asarray(enc_h)).max() <= 0.05 * scale
    np.testing.assert_allclose(got_soc.numpy(), np.asarray(social), atol=2e-5)

    last = (bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1])
    args = (port.g_params, port.g_spec, *last, torch.from_numpy(np.array(enc_h)),
            torch.from_numpy(np.array(social)), torch.from_numpy(noise.copy()))
    sel = G_mod.decode_select(*args, out[3], BF16)
    np.testing.assert_allclose(sel.abs.numpy(), want_sel, atol=BF16_ATOL)
    every = G_mod.decode_all(*args, BF16)
    np.testing.assert_allclose(every.abs.numpy(), want_all, atol=BF16_ATOL)

    f32 = Predictor(flagship["cfg"], flagship["spec"], flagship["params"],
                    flagship["state"], device="cpu")
    draws = f32.make_draws(torch.Generator().manual_seed(1), ("expected", "sampling"),
                           s, p, k)
    lo = port.predict_multi(batch, None, ("expected", "sampling"), k, draws)
    hi = f32.predict_multi(batch, None, ("expected", "sampling"), k, draws)
    for strat in ("expected", "sampling"):
        assert torch.isfinite(lo[strat][0]).all()
        assert (lo[strat][0] - hi[strat][0]).abs().max() < 0.1


def test_bf16_has_no_backward():
    """K1's bf16 variant has no backward (a gradient path decodes all
    generators, whose bf16 backward is K3 in f32:
    tests/test_torch_port_ablation.py)."""
    st = common.stacked_decoders_init(torch.Generator().manual_seed(0), 2, 4, 8, "rel", 4)
    st = tree_unflatten(st, [x.requires_grad_() for x in tree_leaves(st)])
    rows = (torch.randn(4, 2), torch.randn(4, 2), torch.randn(4, 4), torch.randn(8, 8))
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        kdec.decode_select(st, *rows, idx, T, "rel", compute_dtype=BF16)
    with pytest.raises(ValueError, match="compute_dtype"):
        kdec.kernel_weights(kdec.pack_decoder_params(st, "rel"), torch.float16)
