"""The host side of K1-bf16's tensor-core kernel (``csrc/decode_select_mma.cu``).

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``).
What the host computes for it is checked here: the fragment image of the
weights (``decoder.mma_weights``) and the rows per tile
(``decoder.mma_tile_rows``). The image is read back through the operand
layouts of ``mma.sync.m16n8k16`` / ``m16n8k8`` (PTX ISA, bf16 operands, f32
accumulators: lane l is row ``l // 4``, quad ``l % 4``) and rolled out on 16
rows the way the kernel's ``rollout_group`` does, accumulator fragments
feeding the next step's A fragments; that rollout must reproduce the bf16
plain version, whose own agreement with the TPU kernel in interpret mode
``tests/test_torch_port_bf16.py`` holds.
"""

import numpy as np
import pytest
import torch

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops.kernels import decoder as kdec

T = 12
ROW, QUAD = torch.arange(32) // 4, torch.arange(32) % 4
_i4, _i2, _e = torch.arange(4)[None, :, None], torch.arange(2)[None, :, None], \
    torch.arange(2)[None, None, :]
# A (16 x 16): lane l, register i, half e -> (row, col)
A16 = (ROW[:, None, None] + 8 * (_i4 % 2), 2 * QUAD[:, None, None] + _e + 8 * (_i4 // 2))
A8 = (ROW[:, None, None] + 8 * _i2, 2 * QUAD[:, None, None] + _e)  # A (16 x 8)
B16 = (2 * QUAD[:, None, None] + _e + 8 * _i2, ROW[:, None, None])  # B (16 x 8): (k, n)
B8 = (2 * QUAD[:, None] + torch.arange(2)[None, :], ROW[:, None])  # B (8 x 8)
C = (ROW[:, None] + 8 * (torch.arange(4)[None, :] // 2), 2 * QUAD[:, None]
     + torch.arange(4)[None, :] % 2)  # C/D (16 x 8): lane l, element i -> (row, col)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _pairs(words):
    """float32 words -> their two bf16 values (low half first), as floats."""
    return words.contiguous().view(torch.bfloat16).float().reshape(*words.shape, 2)


def _mma(acc, a, b, a_map, b_map, k):
    """acc (32, 4) += A . B, A and B given as per-lane fragment registers."""
    a_mat, b_mat = torch.zeros(16, k), torch.zeros(k, 8)
    a_mat[a_map[0].expand(a.shape), a_map[1].expand(a.shape)] = a
    b_mat[b_map[0].expand(b.shape), b_map[1].expand(b.shape)] = b
    return acc + (a_mat @ b_mat)[C]


def _emulate(image, h, hid, fmt, h0, sb, xy, dxdy):
    """The kernel's rollout of 16 rows on one generator's image."""
    whh = _pairs(image[:2048]).reshape(4, 4, 32, 4, 2)
    wemb = _pairs(image[2048:2560]).reshape(4, 32, 4, 2)
    w1 = _pairs(image[2560:3072]).reshape(4, 32, 4, 2)
    bias, w2, b2 = image[3072:3200].reshape(4, 4, 8), image[3200:3264].reshape(16, 4), \
        image[3264:3266]
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[1]))
    h0p, sbp = pad(h0, 32), pad(sb, 32)
    ha = _bf(h0p[A16])  # (32, 4, 2) A fragments of each 16-unit k-tile
    ha = torch.stack([ha, _bf(h0p[A16[0], A16[1] + 16])])
    sbf = torch.stack([sbp[C[0], C[1] + 8 * nt] for nt in range(4)])  # (nt, 32, 4)
    x, y, dx, dy = xy[:, 0], xy[:, 1], dxdy[:, 0], dxdy[:, 1]
    c = torch.zeros(4, 32, 4)
    out_abs, out_rel = [], []
    for _ in range(T):
        te = {"rel": [dx, dy], "abs": [x, y], "abs_rel": [x, y, dx, dy]}[fmt]
        te = _bf(pad(torch.stack(te, 1), 8))
        ta = te[A8]
        hn = torch.zeros(2, 32, 4, 2)
        for u in range((h + 7) // 8):
            acc = []
            for gate in range(4):
                b = bias[u, gate][2 * QUAD[:, None] + torch.arange(2)[None, :]]  # (32, 2)
                a = b.repeat(1, 2)
                a = _mma(a, ta, wemb[u, :, gate], A8, B8, 8)
                for kt in range(2):
                    a = _mma(a, ha[kt], whh[u, gate][:, 2 * kt:2 * kt + 2], A16, B16, 16)
                acc.append(a)
            i, f, g, o = acc
            c[u] = torch.sigmoid(f) * c[u] + torch.sigmoid(i) * torch.tanh(g)
            hv = torch.sigmoid(o) * torch.tanh(c[u])  # (32, 4): rows r, r+8 x 2 units
            hn[u // 2, :, (u % 2) * 2] = hv[:, 0:2]
            hn[u // 2, :, (u % 2) * 2 + 1] = hv[:, 2:4]
        ha = _bf(hn)
        px, py = torch.zeros(32, 2), torch.zeros(32, 2)
        for nt in range((hid + 7) // 8):
            pre = sbf[nt]
            for kt in range(2):
                pre = _mma(pre, ha[kt], w1[nt][:, 2 * kt:2 * kt + 2], A16, B16, 16)
            a = _bf(torch.where(pre > 0, pre, 0.01 * pre))
            w2q = w2[nt * 4 + QUAD]  # (32, 4): rows 8nt+2q, +1 of W2, (x, y) each
            px += a[:, 0::2] * w2q[:, 0:1] + a[:, 1::2] * w2q[:, 2:3]
            py += a[:, 0::2] * w2q[:, 1:2] + a[:, 1::2] * w2q[:, 3:4]
        # the quad's sums: rows r (lanes 4r..4r+3, index 0) and r + 8 (index 1)
        px, py = px.reshape(8, 4, 2).sum(1), py.reshape(8, 4, 2).sum(1)
        dx, dy = px.T.reshape(16) + b2[0], py.T.reshape(16) + b2[1]
        x, y = x + dx, y + dy
        out_abs.append(torch.stack([x, y], 1))
        out_rel.append(torch.stack([dx, dy], 1))
    return torch.stack(out_abs, 1), torch.stack(out_rel, 1)


@pytest.mark.parametrize("inp_format,h_dim", [("rel", 32), ("abs", 32), ("abs_rel", 20)])
def test_fragment_image_rolls_out_like_the_plain_version(inp_format, h_dim):
    gen = torch.Generator().manual_seed(h_dim)
    stacked = common.stacked_decoders_init(gen, 2, h_dim // 2, h_dim, inp_format, 8)
    rng = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc, h0 = f32(16, 2), f32(16, 2) * 0.3, f32(16, 8), f32(16, h_dim)
    packed = kdec.pack_decoder_params(stacked, inp_format)
    image = kdec.mma_weights(packed)
    assert image.shape == (2, 3268) and image.dtype == torch.float32
    socb = kdec.social_bias(packed, soc)
    hid = packed["w1h"].shape[2]
    got = _emulate(image[1], h_dim, hid, inp_format, h0, socb[:, 1], xy, dxdy)
    idx = torch.ones(16, dtype=torch.int32)
    want = kdec.decode_select_reference(stacked, xy, dxdy, soc, h0, idx, T, inp_format,
                                        compute_dtype=torch.bfloat16)
    f32_plain = kdec.decode_select_reference(stacked, xy, dxdy, soc, h0, idx, T, inp_format)
    for a, b, w in zip(got, want, f32_plain):
        # another summation order; a flip of one h's bf16 rounding moves a
        # position by up to ~2e-3 (the bf16 limit of the CPU tests)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
        assert float((a - b).abs().mean()) < 1e-4
        assert float((w - b).abs().max()) > 2e-4  # the f32 rollout is another function


def test_fragment_image_rejects_widths_beyond_the_fragments():
    stacked = common.stacked_decoders_init(torch.Generator().manual_seed(0), 2, 8, 40, "rel", 8)
    with pytest.raises(ValueError, match="H, hid <= 32"):
        kdec.mma_weights(kdec.pack_decoder_params(stacked, "rel"))


@pytest.mark.parametrize("n,sms,tile", [
    (9_728, 132, 64),  # eval's batch: 152 tiles of 64 rows, every SM busy
    (1_310_720, 132, 256),  # bench.py's sampling batch
    (20_480, 132, 128),
    (960, 132, 32),  # fewer rows than SMs x 32: the smallest tile
    (0, 132, 32),
])
def test_tile_rows_fill_the_card(n, sms, tile):
    assert kdec.mma_tile_rows(n, sms) == tile
    if tile != kdec.MMA_TILES[-1]:
        assert -(-n // tile) >= sms  # every SM gets a tile
    if tile != kdec.MMA_TILES[0]:
        assert -(-n // (2 * tile)) < sms  # and the next larger tile would not do that
