"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (a CUDA kernel has no CPU mode). Imports neither
JAX nor ``mggan_tpu``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.utils.pytree import tree_leaves

T = 12
ATOL = 1e-4  # f32; summation order and expf/tanhf differ from the CPU


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_decode_select_kernel_matches_reference(cuda, inp_format, h_dim):
    g_count, m, k = 4, 37, 20
    gen = torch.Generator().manual_seed(h_dim)
    stacked = common.stacked_decoders_init(gen, g_count, h_dim // 2, h_dim,
                                           inp_format, 32)
    rng = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc = f32(m, 2), f32(m, 2) * 0.3, f32(m, 32)
    h0 = f32(m * k, h_dim)
    idx = torch.from_numpy(rng.randint(0, g_count, m * k).astype(np.int32))
    args = (stacked, xy, dxdy, soc, h0, idx)
    before = kernels.launches[kdec.KERNEL]
    got = kdec.decode_select(*[_on(a, cuda) for a in args], T, inp_format)
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL] == before + 1
    want = kdec.decode_select_reference(*args, T, inp_format)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=ATOL)


def _decode_all_case(inp_format, h_dim, g_count=4, m=37, k=20, seed=0):
    gen = torch.Generator().manual_seed(h_dim + seed)
    stacked = common.stacked_decoders_init(gen, g_count, h_dim // 2, h_dim,
                                           inp_format, 32)
    rng = np.random.RandomState(seed)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return stacked, (f32(m, 2), f32(m, 2) * 0.3, f32(m, 32), f32(m * k, h_dim))


def _decode_all_grads(stacked, rows, inp_format, dev):
    """Rollout and grads of a weighted sum of abs/rel (the loss of
    tests/test_pallas_decoder.py) w.r.t. the stacked params and every input."""
    stacked = _on(stacked, dev)
    rows = [x.to(dev) for x in rows]
    leaves = [x.requires_grad_() for x in tree_leaves(stacked) + rows]
    a, r = kda.decode_all(stacked, *rows, T, inp_format)
    wa = torch.linspace(0.5, 1.5, a.numel(), device=dev).reshape(a.shape)
    wr = torch.linspace(-1.0, 1.0, r.numel(), device=dev).reshape(r.shape)
    grads = torch.autograd.grad((a * wa).sum() + (r * wr).sum(), leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]
    return [a.detach(), r.detach()], grads


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_decode_all_kernels_match_reference(cuda, inp_format, h_dim):
    """K2 (forward, hc saved) and K3 (through DecodeAll's backward) against
    the plain versions on the CPU. Forward atol 1e-4 (12-step rollout);
    grads rtol/atol 2e-4, as tests/test_pallas_decoder.py holds the TPU
    kernel's backward."""
    stacked, rows = _decode_all_case(inp_format, h_dim)
    before = dict(kernels.launches)
    got_out, got_grads = _decode_all_grads(stacked, rows, inp_format, cuda)
    torch.cuda.synchronize()
    assert kernels.launches[kda.KERNEL_FWD] == before.get(kda.KERNEL_FWD, 0) + 1
    assert kernels.launches[kda.KERNEL_BWD] == before.get(kda.KERNEL_BWD, 0) + 1
    want_out, want_grads = _decode_all_grads(stacked, rows, inp_format, "cpu")
    for a, b in zip(got_out, want_out):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=ATOL)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_decode_all_bwd_weight_grads_are_bit_identical(cuda):
    """K3 sums weight grads without atomics: two launches, same bits."""
    stacked, rows = _decode_all_case("rel", 32, m=64, k=20)
    first = _decode_all_grads(stacked, rows, "rel", cuda)[1]
    second = _decode_all_grads(stacked, rows, "rel", cuda)[1]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


BF16_ATOL = 2e-3  # bf16 operands: a rounding of h can flip between the card and the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_bf16_kernels_match_reference(cuda, inp_format, h_dim):
    """K1's and K2's bf16 variants against their bf16 plain versions, and
    K1-bf16 equal to K2-bf16 on the selected rows bit for bit (one rollout
    template, one arithmetic)."""
    stacked, rows = _decode_all_case(inp_format, h_dim, seed=3)
    idx = torch.from_numpy(np.random.RandomState(3).randint(0, 4, rows[3].shape[0])
                           .astype(np.int32))
    bf16 = torch.bfloat16
    before = dict(kernels.launches)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    sel = kdec.decode_select(*on, T, inp_format, compute_dtype=bf16)
    every = kda.decode_all(*on[:5], T, inp_format, compute_dtype=bf16)
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL_BF16] == before.get(kdec.KERNEL_BF16, 0) + 1
    assert kernels.launches[kda.KERNEL_FWD_BF16] == before.get(kda.KERNEL_FWD_BF16, 0) + 1
    want_sel = kdec.decode_select_reference(stacked, *rows, idx, T, inp_format, bf16)
    want_all = kda.decode_all(stacked, *rows, T, inp_format, compute_dtype=bf16)
    for a, b in zip(sel + every, want_sel + want_all):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=BF16_ATOL)
    rows_n = torch.arange(idx.shape[0], device=cuda)
    for a, b in zip(sel, every):
        assert torch.equal(a, b[idx.to(cuda).long(), rows_n])
