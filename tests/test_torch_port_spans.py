"""The port's spans (``utils/profiling.py::span``) on the CPU: a null
context without a profiler, the inference path's stages nested under one
``mggan.predict`` and covering every op of a call but the encoder's closing
``cat``, the train step's and the train loop's spans, and serving programs
exported with nothing of the profiler in them.

The model is the smallest that runs the sampling path (2 generators,
h = 16, sways attention, the scene CNN), as in
``tests/test_torch_port_artifact.py``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from mggan_tpu_torch.cli import export as export_cli
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.training.loop import Trainer
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import build_train_step, make_draws
from mggan_tpu_torch.utils import profiling
from mggan_tpu_torch.utils.logging import ExperimentWriter

torch.set_num_threads(1)

SMALL = dict(dataset="synthetic_memory", num_gens=2, h_dim=16, decoder_h_dim=16,
             weighting_target="ml", noise_dim=8)
S, P, K = 3, 4, 5
STAGES = {"mggan.inputs", "mggan.traj_encoder", "mggan.scene_cnn", "mggan.social",
          "mggan.pm", "mggan.decoder_h0", "mggan.rollout"}
STEPS = {"mggan.train.d_step", "mggan.train.g_step", "mggan.train.pm_step"}


@pytest.fixture(scope="module")
def predictor():
    cfg = Config(**SMALL)
    params, state, spec = factory.construct_model(cfg, seed=0, device="cpu")
    return Predictor(cfg, spec, params, state, device="cpu")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"xy": (rng.randn(S, P, 20, 2).cumsum(2) * 0.4).astype(np.float32),
            "ped_mask": np.arange(P)[None] < rng.randint(1, P + 1, (S, 1)),
            "patches": rng.uniform(-1, 1, (S, P, 33, 33, 4)).astype(np.float32)}


def _draws(predictor):
    return predictor.make_draws(predictor.new_generator(1), ["sampling"], S, P, K)["sampling"]


def _names_above(ev):
    names = []
    while ev is not None:
        names.append(ev.name)
        ev = ev.cpu_parent
    return names


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof.events(), out


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("mggan.a"), profiling.span("mggan.b")
    assert a is b
    with a as entered:
        assert entered is None


def test_span_under_a_profiler_is_a_host_range_of_its_own_name():
    events, _ = _profiled(lambda: _in_span("mggan.probe"))
    (probe,) = [e for e in events if e.name == "mggan.probe"]
    assert not probe.is_user_annotation  # no device annotation row for it
    (add,) = [e for e in events if e.name == "aten::add"]
    assert add.cpu_parent is probe


def _in_span(name):
    with profiling.span(name):
        return torch.ones(3) + 1


def test_a_call_without_a_profiler_dispatches_no_profiler_op(predictor):
    batch, draws = _batch(), _draws(predictor)
    with _OpLog() as log:
        predictor.predict(batch, num=K, draws=draws)
    assert log.ops and not [op for op in log.ops if "profiler" in op]


def test_predict_holds_one_root_span_with_every_stage_under_it(predictor):
    batch, draws = _batch(), _draws(predictor)
    want = predictor.predict(batch, num=K, draws=draws)
    events, got = _profiled(lambda: predictor.predict(batch, num=K, draws=draws))
    for a, b in zip(got, want):  # the spans change no output
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    spans = [e for e in events if e.name.startswith("mggan.")]
    roots = [e for e in spans if e.name == "mggan.predict"]
    assert len(roots) == 1 and roots[0].cpu_parent is None
    assert {e.name for e in spans} == STAGES | {"mggan.predict"}
    for e in spans:
        if e is not roots[0]:
            assert e.cpu_parent is roots[0], (e.name, _names_above(e))


def test_every_op_of_a_call_but_the_encoders_cat_lies_in_a_stage(predictor):
    batch, draws = _batch(), _draws(predictor)
    events, _ = _profiled(lambda: predictor.predict(batch, num=K, draws=draws))
    ops = [e for e in events if e.name.startswith("aten::")]
    outside = [e for e in ops if not set(_names_above(e)) & STAGES]
    assert [e.name for e in outside] == ["aten::cat"]
    assert outside[0].cpu_parent.name == "mggan.predict"
    assert len(ops) > 50


def test_the_train_step_holds_its_three_phase_spans():
    cfg = Config(**SMALL, num_samples=3)
    g, d = factory.construct_gan(cfg, seed=3, device="cpu")
    step = build_train_step(cfg, g[2], d[2])
    state = init_train_state(cfg, g, d)
    batch = _batch(2)
    draws = make_draws(torch.Generator().manual_seed(5), cfg, S, P, g[0], d[0])
    events, _ = _profiled(lambda: step(state, batch, draws))
    phases = [e for e in events if e.name in STEPS]
    assert sorted(e.name for e in phases) == sorted(STEPS)
    assert all(e.cpu_parent is None for e in phases)
    # the model's stages inside them: the D step's one-sample rollout (K1's
    # path) and the G step's all-generator rollout
    by_phase = {p.name: {e.name for e in events if p in _ancestors(e)} for p in phases}
    assert {"mggan.scene_cnn", "mggan.rollout"} <= by_phase["mggan.train.d_step"]
    assert {"mggan.traj_encoder", "mggan.decoder_h0", "mggan.rollout"} <= by_phase[
        "mggan.train.g_step"]
    assert "mggan.pm" in by_phase["mggan.train.pm_step"]


def _ancestors(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev)
    return out


def test_the_profiled_iteration_holds_the_feed_and_the_batch_move(tmp_path):
    """``profile_dir`` traces the first epoch's second iteration whole: the
    wait for its batch, the batch's move to the device and the step."""
    prof = tmp_path / "prof"
    cfg = Config(**SMALL, num_samples=2, batch_size=16, epochs=1, top_k_test=2,
                 val_every=2, profile_dir=str(prof), log_dir=str(tmp_path))
    writer = ExperimentWriter(tmp_path, cfg.experiment, cfg.name, version=0, config=cfg,
                              tensorboard=False)
    tr = Trainer(cfg, writer, device="cpu")
    tr.train()
    (trace,) = prof.glob("trace_*.json")
    names = [e.get("name") for e in json.loads(trace.read_text())["traceEvents"]]
    for name in ("mggan.train.feed", "mggan.train.device_batch", *STEPS):
        assert names.count(name) == 1, name
    assert "mggan.rollout" in names


@pytest.mark.parametrize("profiler", ["off", "on"])
def test_an_exported_serving_program_holds_no_profiler_op(predictor, profiler):
    def export():
        return export_cli.export_predictor(predictor, "sampling", 2, P, K)

    program = _profiled(export)[1] if profiler == "on" else export()
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "mggan.decode_select.default" in targets
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
