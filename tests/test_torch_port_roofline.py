"""The FLOP formulas of ``mggan_tpu_torch/utils/roofline.py`` and K3 as the
operator ``mggan::decode_all_bwd`` (CPU).

* ``rollout_flops`` and ``reverse_sweep_flops`` over the H100's peaks give
  PERF.md's operation-bound kernel bounds at its shapes.
* ``FlopCounterMode`` (``library.count_flops``) counts each ``mggan::``
  operator once, by its formula, never the aten ops of its CPU
  implementation; a tiny train step's total is the aten FLOPs plus the
  operators', and the CPU route on fake tensors (``FakeTensorMode``, as
  ``chip_smoke.py`` counts the flagship step) counts what it counts on
  real ones.
* ``torch.library.opcheck`` on ``mggan::decode_all_bwd``, after the f32
  and the bf16 forward; its grad image splits back into the six weight
  grads bit for bit, and ``DecodeAll``'s gradients are bit for bit those
  of K3's plain version called directly.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import common, factory
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.ops.kernels import library
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import build_train_step, make_draws
from mggan_tpu_torch.utils import roofline
from test_torch_port_train import _batch

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

OPERATORS = ("mggan.decode_select", "mggan.decode_all_fwd", "mggan.decode_all_bwd")


# ---------------------------------------------- PERF.md's kernel bounds --
# PERF.md section 6's operation-bound kernels at the flagship widths (H=32,
# hid=16, rel inputs, 12 steps, 4 generators): (kernel, rows) -> bound ms as
# printed; K2 and K3 roll out every generator on each row
PERF_BOUNDS = {
    ("K1", 960): "0.0017",
    ("K1", 4096): "0.0072",
    ("K1", 9728): "0.0171",
    ("K1", 20480): "0.0359",
    ("K1", 1310720): "2.299",
    ("K1-bf16", 9728): "0.00116",
    ("K1-bf16", 1310720): "0.156",
    ("K2", 4096): "0.0287",
    ("K2", 9728): "0.0682",
    ("K2", 81920): "0.5747",
    ("K2-bf16", 9728): "0.00462",
    ("K3", 4096): "0.0860",
    ("K3", 81920): "1.7203",
}


@pytest.mark.parametrize("case", sorted(PERF_BOUNDS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_formulas_give_perf_md_bounds(case):
    kernel, n = case
    peak = roofline.H100_BF16_FLOPS if kernel.endswith("bf16") else roofline.H100_FP32_FLOPS
    rows = n if kernel.startswith("K1") else 4 * n
    count = roofline.reverse_sweep_flops if kernel == "K3" else roofline.rollout_flops
    want = PERF_BOUNDS[case]
    ms = count(rows, 12, 32, 16, 2) / peak * 1e3
    assert f"{ms:.{len(want.split('.')[1])}f}" == want, ms


# ------------------------------------------------- counting the operators --
def _rollout_case(m=3, k=2, h=8, gens=2, fmt="abs_rel"):
    st = common.stacked_decoders_init(torch.Generator().manual_seed(0), gens, 4, h, fmt, 4)
    packed = kdec.pack_decoder_params(st, fmt)
    g = torch.Generator().manual_seed(1)
    socb = kdec.social_bias(packed, torch.randn(m, 4, generator=g)).contiguous()
    rows = (torch.randn(m * k, h, generator=g), torch.randn(m, 2, generator=g),
            torch.randn(m, 2, generator=g))
    return [packed[key] for key in kdec.PACKED] + [socb, *rows]


def _bwd_args(bf16, t=5, fmt="abs_rel"):
    args = _rollout_case(fmt=fmt)
    out_abs, out_rel, hc = torch.ops.mggan.decode_all_fwd(*args, t, fmt, True, bf16)
    g = torch.Generator().manual_seed(2)
    cot = (torch.randn(out_abs.shape, generator=g), torch.randn(out_rel.shape, generator=g))
    return (*args, out_abs, out_rel, hc, *cot, t, fmt, bf16)


def test_counter_counts_each_operator_by_its_formula_alone():
    """Each operator is one node of the count, by its formula: the CPU
    implementations' own products (aten.bmm in the plain versions) are not
    counted."""
    args = _rollout_case()
    n, h, hid, in_dim = 6, 8, 4, 4
    idx = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)
    bwd = _bwd_args(False)
    calls = {
        "mggan.decode_select": (lambda: torch.ops.mggan.decode_select(*args, idx, 5, "abs_rel",
                                                                      False),
                                roofline.rollout_flops(n, 5, h, hid, in_dim)),
        "mggan.decode_all_fwd": (lambda: torch.ops.mggan.decode_all_fwd(*args, 5, "abs_rel",
                                                                        True, False),
                                 roofline.rollout_flops(2 * n, 5, h, hid, in_dim)),
        "mggan.decode_all_bwd": (lambda: torch.ops.mggan.decode_all_bwd(*bwd),
                                 roofline.reverse_sweep_flops(2 * n, 5, h, hid, in_dim)),
    }
    for name, (call, want) in calls.items():
        total, by_op = library.count_flops(call)
        assert by_op == {name: want} and total == want, (name, by_op)


class _OperatorCalls(TorchDispatchMode):
    """Records the ``mggan::`` operators that run, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func._overloadpacket)
        if name.startswith("mggan."):
            self.calls.append((name, [getattr(a, "shape", a) for a in args]))
        return func(*args, **(kwargs or {}))


def _step_case():
    """A tiny flagship-family step (mgan / ml, 2 generators, h = 16), its
    state, batch and draws on the CPU."""
    cfg = Config(dataset="synthetic_memory", num_gens=2, h_dim=16, decoder_h_dim=16,
                 num_samples=4)
    g_pack, d_pack = factory.construct_gan(cfg, seed=3, device="cpu")
    step = build_train_step(cfg, g_pack[2], d_pack[2])
    draws = make_draws(torch.Generator().manual_seed(5), cfg, 3, 4, g_pack[0], d_pack[0])
    return step, init_train_state(cfg, g_pack, d_pack, seed=1), _batch(3, 4, seed=7), draws


def test_train_step_count_is_aten_plus_operators():
    """The tiny step under the counter: K1 once, K2 twice and K3 once, each
    counted by its formula on its call's shapes; the total is the aten
    FLOPs plus the operators'."""
    spy = _OperatorCalls()
    with spy:
        total, by_op = library.count_flops(*_step_case())
    assert [c[0] for c in spy.calls].count("mggan.decode_select") == 1
    assert [c[0] for c in spy.calls].count("mggan.decode_all_fwd") == 2
    assert [c[0] for c in spy.calls].count("mggan.decode_all_bwd") == 1
    want = dict.fromkeys(OPERATORS, 0)
    for name, shapes in spy.calls:
        w_emb, w1h, h0 = shapes[0], shapes[3], shapes[7]
        g, n, t = w_emb[0], h0[0], shapes[15 if name.endswith("bwd") else
                                         11 if name.endswith("select") else 10]
        rows = n if name.endswith("select") else g * n
        count = roofline.reverse_sweep_flops if name.endswith("bwd") else roofline.rollout_flops
        want[name] += count(rows, t, h0[1], w1h[2], w_emb[1])
    assert {op: n for op, n in by_op.items() if op.startswith("mggan.")} == want
    aten = {op: n for op, n in by_op.items() if op not in OPERATORS}
    assert total == sum(aten.values()) + sum(want.values())
    assert sum(aten.values()) > 0 and all(op.startswith("aten.") for op in aten)


def test_fake_tensor_count_is_the_real_count():
    """The tiny step counted on fake CPU tensors (shapes, no data) gives the
    real CPU run's count, operator by operator."""
    real = library.count_flops(*_step_case())
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = library.count_flops(*_step_case())
    assert fake == real and real[0] > 0


# -------------------------------------------------------- K3, the operator --
@pytest.mark.parametrize("after_bf16", [False, True])
def test_decode_all_bwd_operator_opcheck(after_bf16):
    """K3's operator, on residuals of the f32 and of the bf16 forward:
    schema, fake and dispatch tests of ``torch.library.opcheck`` on its CPU
    implementation."""
    torch.library.opcheck(torch.ops.mggan.decode_all_bwd.default, _bwd_args(after_bf16))


@pytest.mark.parametrize("fmt", ["rel", "abs_rel"])
def test_grad_image_splits_into_the_weight_grads(fmt):
    """The operator's grad image (its first output) holds the six weight
    grads of K3's plain version in K3's layout: ``weight_grads_from_image``
    reads them back bit for bit, and the image's width is
    ``grad_image_floats``."""
    bwd = _bwd_args(False, fmt=fmt)
    image, *rows = torch.ops.mggan.decode_all_bwd(*bwd)
    want = kda.decode_all_bwd_reference(*bwd[:-1])
    w_emb, w_hh, w1h = bwd[0], bwd[1], bwd[3]
    h, hid, in_dim = w_hh.shape[1], w1h.shape[2], w_emb.shape[1]
    assert image.shape == (w_hh.shape[0], kda.grad_image_floats(h, hid, in_dim))
    got = (*kda.weight_grads_from_image(image, h, hid, in_dim), *rows)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("fmt", ["rel", "abs_rel"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_decode_all_grads_are_the_plain_sweeps_bit_for_bit(fmt, compute_dtype):
    """``DecodeAll``'s backward through the operator gives K3's plain
    version called on the saved residuals, bit for bit: the route of the
    backward before it became an operator."""
    args = [x.detach().requires_grad_(True) for x in _rollout_case(fmt=fmt)]
    out_abs, out_rel = kda.DecodeAll.apply(*args, 5, fmt, compute_dtype)
    g = torch.Generator().manual_seed(2)
    g_abs = torch.randn(out_abs.shape, generator=g)
    g_rel = torch.randn(out_rel.shape, generator=g)
    got = torch.autograd.grad((out_abs, out_rel), args, (g_abs, g_rel))
    plain = [x.detach() for x in args]
    res = kda.decode_all_reference(*plain, 5, fmt, True, compute_dtype)
    want = kda.decode_all_bwd_reference(*plain, *res, g_abs, g_rel, 5, fmt)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert np.isfinite(np.concatenate([a.reshape(-1).numpy() for a in got])).all()
