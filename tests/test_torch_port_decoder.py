"""Port of the fused-selection decoder (K1): the plain PyTorch version held
against the JAX Pallas kernel (interpret mode) and the JAX scan + gather.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``); here its wrapper's packing is checked by
a numpy walk over the kernel's shared-memory layout.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.models import common as jax_common
from mggan_tpu.ops import sampling as jax_sampling
from mggan_tpu.ops.pallas import decoder as jax_dec

from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import decoder as kdec

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T = 12
ATOL = 1e-4  # 12-step rollout (PARITY.md loss-value section)


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x, dtype=np.float32))


def make_case(inp_format, G=3, N=60, M=20, EMB=8, H=16, F=8, seed=0):
    """Random decoder params (JAX init) and numpy row inputs; rollout row n
    reads per-agent row n % M."""
    stacked = _tree(jax_common.stacked_decoders_init(
        jax.random.PRNGKey(seed), G, EMB, H, inp_format, F))
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    return {
        "stacked": stacked,
        "xy": f32(M, 2), "dxdy": f32(M, 2) * 0.3, "soc": f32(M, F),
        "h0": f32(N, H), "idx": rng.randint(0, G, N).astype(np.int32),
    }


def _port(case, inp_format):
    tile = case["h0"].shape[0] // case["xy"].shape[0]
    return kdec.decode_select_reference(
        _torch(case["stacked"]), _torch(case["xy"]), _torch(case["dxdy"]),
        _torch(case["soc"]), _torch(case["h0"]), torch.from_numpy(case["idx"]),
        T, inp_format,
    ), tile


@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
def test_reference_matches_pallas_select(inp_format):
    case = make_case(inp_format)
    (abs_p, rel_p), tile = _port(case, inp_format)
    rep = lambda a: jnp.asarray(np.tile(a, (tile, 1)))
    onehot = jax.nn.one_hot(case["idx"], 3, dtype=jnp.float32)
    abs_j, rel_j = jax_dec.pallas_decode_select(
        case["stacked"], rep(case["xy"]), rep(case["dxdy"]), rep(case["soc"]),
        jnp.asarray(case["h0"]), onehot, T, inp_format, interpret=True,
    )
    np.testing.assert_allclose(abs_p.numpy(), np.asarray(abs_j), atol=ATOL)
    np.testing.assert_allclose(rel_p.numpy(), np.asarray(rel_j), atol=ATOL)


@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
def test_reference_matches_scan_and_gather(inp_format):
    case = make_case(inp_format, seed=1)
    (abs_p, rel_p), tile = _port(case, inp_format)
    rep = lambda a: jnp.asarray(np.tile(a, (tile, 1)))
    abs_g, rel_g = jax_common.stacked_decoders_apply(
        case["stacked"], rep(case["xy"]), rep(case["dxdy"]), rep(case["soc"]),
        jnp.asarray(case["h0"]), T, inp_format,
    )
    n = case["h0"].shape[0]
    idx = jnp.asarray(case["idx"]).reshape(1, n, 1)
    pick = lambda x: np.asarray(
        jax_sampling.gather_samples(x[None, :, None], idx)).reshape(n, T, 2)
    np.testing.assert_allclose(abs_p.numpy(), pick(abs_g), atol=ATOL)
    np.testing.assert_allclose(rel_p.numpy(), pick(rel_g), atol=ATOL)


def _walk_kernel_layout(flat, per_gen, g_count, h, hid, in_dim, fmt, case):
    """numpy replay of csrc/decode_select.cu's arithmetic, reading weights
    only through the flat shared-memory image at the kernel's offsets."""
    W = flat.reshape(g_count, per_gen)
    off_wemb = h * h * 4
    off_b = off_wemb + in_dim * h * 4
    off_w1 = off_b + h * 4
    off_w2 = off_w1 + h * hid
    off_b2 = off_w2 + hid * 2
    n, m = case["h0"].shape[0], case["xy"].shape[0]
    rows = np.arange(n) % m
    Wg = W[case["idx"]]  # (N, per_gen): each row's generator block
    whh = Wg[:, :off_wemb].reshape(n, h, h, 4)
    wemb = Wg[:, off_wemb:off_b].reshape(n, in_dim, h, 4)
    bias = Wg[:, off_b:off_w1].reshape(n, h, 4)
    w1 = Wg[:, off_w1:off_w2].reshape(n, h, hid)
    w2 = Wg[:, off_w2:off_b2].reshape(n, hid, 2)
    b2 = Wg[:, off_b2:off_b2 + 2]
    socb = case["socb"][rows, case["idx"]]
    xy, dxdy = case["xy"][rows].copy(), case["dxdy"][rows].copy()
    hh, c = case["h0"].copy(), np.zeros_like(case["h0"])
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    abs_o, rel_o = [], []
    for _ in range(T):
        te = {0: dxdy, 1: xy, 2: np.concatenate([xy, dxdy], -1)}[fmt]
        acc = (np.einsum("nk,nkjq->njq", hh, whh)
               + np.einsum("ni,nijq->njq", te, wemb) + bias)
        c = sig(acc[..., 1]) * c + sig(acc[..., 0]) * np.tanh(acc[..., 2])
        hh = sig(acc[..., 3]) * np.tanh(c)
        a = np.einsum("nk,nkm->nm", hh, w1) + socb
        a = np.where(a > 0, a, 0.01 * a)
        dxdy = np.einsum("nm,nmd->nd", a, w2) + b2
        xy = xy + dxdy
        abs_o.append(xy)
        rel_o.append(dxdy)
    return np.stack(abs_o, 1), np.stack(rel_o, 1)


@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
def test_kernel_weight_image_matches_reference(inp_format):
    """The wrapper's packed weights, read at the kernel's offsets and
    layout ([k][j][gate], ...), reproduce the plain rollout."""
    case = make_case(inp_format, seed=2)
    stacked = _torch(case["stacked"])
    packed = kdec.pack_decoder_params(stacked, inp_format)
    flat, per_gen = kdec.kernel_weights(packed)
    assert per_gen % 4 == 0
    case["socb"] = kdec.social_bias(packed, _torch(case["soc"])).numpy()
    g, in_dim, four_h = packed["w_emb"].shape
    abs_k, rel_k = _walk_kernel_layout(
        flat.numpy().astype(np.float64), per_gen, g, four_h // 4,
        packed["w1h"].shape[2], in_dim, kdec.FORMATS[inp_format], case)
    (abs_p, rel_p), _ = _port(case, inp_format)
    np.testing.assert_allclose(abs_k, abs_p.numpy(), atol=ATOL)
    np.testing.assert_allclose(rel_k, rel_p.numpy(), atol=ATOL)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version; it never builds
    or launches the kernel."""
    case = make_case("rel", seed=3)

    def no_kernel(*a, **k):
        raise AssertionError("kernel route taken on CPU tensors")

    monkeypatch.setattr(kdec, "decode_select_cuda", no_kernel)
    monkeypatch.setattr(kdec.build, "load", no_kernel)
    before = dict(kernels.launches)
    args = (_torch(case["stacked"]), _torch(case["xy"]), _torch(case["dxdy"]),
            _torch(case["soc"]), _torch(case["h0"]),
            torch.from_numpy(case["idx"]), T, "rel")
    got = kdec.decode_select(*args)
    want = kdec.decode_select_reference(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dict(kernels.launches) == before


def test_kernel_wrapper_rejects_cpu_tensors():
    case = make_case("rel", seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        kdec.decode_select_cuda(
            _torch(case["stacked"]), _torch(case["xy"]), _torch(case["dxdy"]),
            _torch(case["soc"]), _torch(case["h0"]),
            torch.from_numpy(case["idx"]), T, "rel")


def test_module_imports_without_triton_or_nvcc():
    code = (
        "import sys, shutil; sys.modules['triton'] = None; "
        "shutil.which = lambda *a, **k: None; "
        "import mggan_tpu_torch.ops.kernels.decoder as d; "
        "import mggan_tpu_torch.ops.kernels.build as b; "
        "assert not b._loaded; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_source_exists_and_targets_the_port():
    src = ROOT / "mggan_tpu_torch" / "csrc" / "decode_select.cu"
    text = src.read_text()
    assert "__global__" in text and "extern \"C\"" in text
    assert "mggan_decode_select" in text
    assert "_fwd_select_kernel" in text  # the note names the TPU kernel
    assert "sm_90a" in " ".join(importlib.import_module(
        "mggan_tpu_torch.ops.kernels.build").NVCC_FLAGS)

