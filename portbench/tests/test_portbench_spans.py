"""``harness/spans.py`` and ``stages.py`` on synthetic profiler events: the
user-annotation rows left out of the device work, an operation tied to its
span through its correlation and through its launch call, and idle time
split by span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import stages
from portbench.harness import spans


def _ev(name, start, end, id=0, parent=None, linked=0, device=False, annotation=False):
    return SimpleNamespace(name=name, id=id, linked=linked,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation, cpu_parent=parent,
                           time_range=SimpleNamespace(start=start, end=end))


def _links(events):
    """What ``spans.links`` reads from the profiler's raw results."""
    return {e.id: e.linked for e in events if e.device_type == DeviceType.CUDA and e.linked}


def _attribute(events):
    return spans.attribute(events, _links(events))


def _stretch():
    """One call (microseconds): an upload under ``mggan.inputs``, a
    convolution under ``mggan.scene_cnn``, a kernel launched outside any
    op under ``mggan.rollout`` (found by its launch call alone), the
    encoder's ``cat`` under the root alone; then the client's synchronize,
    outside every span. The profiler's annotation row for the root spans
    the call on the device."""
    root = _ev("mggan.predict", 0, 100, id=1)
    inputs = _ev("mggan.inputs", 0, 10, id=2, parent=root)
    to = _ev("aten::to", 1, 9, id=3, parent=inputs)
    scene = _ev("mggan.scene_cnn", 10, 60, id=4, parent=root)
    conv = _ev("aten::conv2d", 12, 20, id=5, parent=scene)
    rollout = _ev("mggan.rollout", 61, 90, id=6, parent=root)
    cat = _ev("aten::cat", 90, 95, id=7, parent=root)
    host = [root, inputs, to, scene, conv, rollout, cat,
            _ev("cudaMemcpyAsync", 2, 3, id=500, parent=to, linked=3),
            _ev("cudaLaunchKernel", 13, 14, id=501, parent=conv, linked=5),
            _ev("cudaLaunchKernel", 65, 66, id=502),  # by ctypes, under no op
            _ev("cudaLaunchKernel", 91, 92, id=503, parent=cat, linked=7),
            _ev("cudaDeviceSynchronize", 100, 120, id=504)]
    device = [_ev("Memcpy HtoD", 5, 15, id=500, linked=3, device=True),
              _ev("sm90_xmma_fprop", 20, 50, id=501, linked=5, device=True),
              _ev("mggan_decode_select_tiled", 70, 90, id=502, device=True),
              _ev("CatArrayBatchedCopy", 95, 98, id=503, linked=7, device=True),
              _ev("mggan.predict", 5, 98, id=1, device=True, annotation=True)]
    return host + device


def test_annotation_rows_are_not_device_work():
    a = _attribute(_stretch())
    assert [name for name, *_ in a["device"]] == [
        "Memcpy HtoD", "sm90_xmma_fprop", "mggan_decode_select_tiled", "CatArrayBatchedCopy"]
    assert a["busy_s"] == pytest.approx((10 + 30 + 20 + 3) * 1e-6)


def test_each_operation_is_tied_to_its_span_by_correlation_or_launch():
    a = _attribute(_stretch())
    assert [names for *_, names in a["device"]] == [
        ("mggan.inputs", "mggan.predict"),  # through aten::to
        ("mggan.scene_cnn", "mggan.predict"),  # through aten::conv2d
        ("mggan.rollout", "mggan.predict"),  # no op: its launch call's span
        ("mggan.predict",)]
    got = {k: (v["device_s"], v["self_device_s"], v["count"]) for k, v in a["spans"].items()}
    assert got == pytest.approx({"mggan.predict": (63e-6, 3e-6, 1),
                                 "mggan.inputs": (10e-6, 10e-6, 1),
                                 "mggan.scene_cnn": (30e-6, 30e-6, 1),
                                 "mggan.rollout": (20e-6, 20e-6, 1)})
    assert a["spans"]["mggan.scene_cnn"]["host_s"] == pytest.approx(50e-6)


def test_a_launch_that_no_link_or_span_reaches_belongs_to_none():
    events = [_ev("mggan.predict", 0, 10, id=1),
              _ev("cudaLaunchKernel", 20, 21, id=9),
              _ev("k", 22, 30, id=9, device=True),
              _ev("orphan", 31, 32, id=10, device=True)]
    a = _attribute(events)
    assert [names for *_, names in a["device"]] == [(), ()]
    assert a["spans"]["mggan.predict"]["device_s"] == 0.0


def test_idle_time_is_split_by_the_span_that_holds_it():
    events = _stretch()
    a = _attribute(events)
    # gaps: 0-5 (inputs), 15-20 (scene CNN), 50-70 (midpoint 60: scene CNN),
    # 90-95 (the root alone: the cat's host time), 98-120 (the synchronize)
    assert a["idle_by_span"] == pytest.approx({
        "mggan.inputs": 5e-6, "mggan.scene_cnn": 25e-6, "mggan.predict": 35e-6,
        spans.NONE: 22e-6})
    assert spans.name_gaps(events, a["gaps"], top=3) == [
        ["(none) / cudaDeviceSynchronize", pytest.approx(22e-6)],
        ["mggan.scene_cnn / mggan.scene_cnn", pytest.approx(20e-6)],
        ["mggan.inputs / cudaMemcpyAsync", pytest.approx(5e-6)]]


def test_the_stage_table_adds_up_to_the_busy_time():
    events = _stretch()
    out = stages.per_call(events, _links(events), 120e-6, 1)
    assert out["inputs_ms"] == pytest.approx(0.010)
    assert out["scene_cnn_ms"] == pytest.approx(0.030)
    assert out["rollout_ms"] == pytest.approx(0.020)
    assert out["unspanned_ms"] == pytest.approx(0.003)
    assert out["stages_sum_ms"] == pytest.approx(out["busy_ms"])
    assert out["call_idle_ms"] == pytest.approx(0.035)
    assert out["between_calls_idle_ms"] == pytest.approx(0.022)
    assert out["stage_ops_ms"]["mggan.scene_cnn"] == [["sm90_xmma_fprop", pytest.approx(0.03)]]


def test_a_tiny_stage_reading_sees_each_stage_once_a_call(tiny_root):
    """On the CPU there is no device row; the spans' host side is whole."""
    import torch

    from portbench.harness import bench

    cell = bench.Cell(tiny_root, "mggan4_sample_b4096")
    out = stages.stage_reading(cell, 2**31 + 5, torch.device("cpu"), 0.3)
    assert out["busy_ms"] == 0.0 and out["summarize"]["device_rows"] == 0
    assert out["instances"] == {"mggan.predict": 1.0, "mggan.inputs": 1.0,
                                "mggan.traj_encoder": 1.0, "mggan.scene_cnn": 1.0,
                                "mggan.social": 1.0, "mggan.pm": 3.0,
                                "mggan.decoder_h0": 2.0, "mggan.rollout": 1.0}
    assert 0 < out["host_ms"]["mggan.scene_cnn"] < out["host_ms"]["mggan.predict"]
