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
from mggan_tpu_torch.ops.kernels import decoder as kdec

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
