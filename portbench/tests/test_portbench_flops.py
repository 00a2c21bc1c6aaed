"""The benchmark's own FLOP count against the program's ``FlopCounterMode``
count, on fake tensors, with every agent real."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import REPO
from portbench.harness.flops import predict_flops, train_step_flops


def _cfg(gens, k):
    cfg = json.loads((REPO / "portbench/configs/mggan4_zara1.json").read_text())["config"]
    return dict(cfg, num_gens=gens, num_samples=k)


def _program_train_count(cfg, s, p):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.ops.kernels.library import count_flops
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws

    config = Config(**cfg)
    rng = np.random.RandomState(0)
    batch = {"xy": rng.randn(s, p, 20, 2).astype(np.float32), "ped_mask": np.ones((s, p), bool),
             "patches": rng.randn(s, p, 33, 33, 4).astype(np.float32)}
    draws = make_draws(torch.Generator().manual_seed(0), config, s, p)
    g, d = construct_gan(config, seed=0, device="cpu")
    state = init_train_state(config, g, d, seed=0)
    step = build_train_step(config, g[2], d[2])
    with FakeTensorMode(allow_non_fake_inputs=True):
        return count_flops(step, state, batch, draws)[0]


def _program_predict_count(cfg, s, p, num):
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import construct_model
    from mggan_tpu_torch.ops.kernels.library import count_flops

    config = Config(**cfg)
    params, state, spec = construct_model(config, seed=0, device="cpu")
    pred = Predictor(config, spec, params, state, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"xy": rng.randn(s, p, 20, 2).astype(np.float32), "ped_mask": np.ones((s, p), bool),
             "patches": rng.randn(s, p, 33, 33, 4).astype(np.float32)}
    draws = pred.make_draws(torch.Generator().manual_seed(0), ["sampling"], s, p, num)
    with FakeTensorMode(allow_non_fake_inputs=True):
        return count_flops(pred.predict, batch, None, num, draws["sampling"])[0]


@pytest.mark.parametrize("s,p,k,gens", [(2, 3, 2, 4), (3, 5, 4, 8), (256, 16, 20, 4)])
def test_train_step_count_equals_the_programs(s, p, k, gens):
    cfg = _cfg(gens, k)
    assert train_step_flops(cfg, s * p, s * p * p) == _program_train_count(cfg, s, p)


def test_flagship_step_count_is_perf_mds():
    assert train_step_flops(_cfg(4, 20), 256 * 16, 256 * 16 * 16) == 287_733_170_176


@pytest.mark.parametrize("s,p,num,gens", [(2, 3, 2, 4), (3, 5, 4, 8), (4096, 16, 20, 4)])
def test_predict_count_equals_the_programs(s, p, num, gens):
    cfg = _cfg(gens, 20)
    assert predict_flops(cfg, s * p, s * p * p, num) == _program_predict_count(cfg, s, p, num)


def test_padding_is_not_counted():
    cfg = _cfg(4, 20)
    full = train_step_flops(cfg, 4 * 16, 4 * 16 * 16)
    half = train_step_flops(cfg, 4 * 8, 4 * 8 * 8)
    assert half < full / 2
