"""The reference stands alone, and the harness imports nothing of JAX."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench.harness import program
from portbench.reference import mggan as ref

FORBIDDEN = {"jax", "jaxlib", "flax", "mggan_tpu", "bench", "benchmarks"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((REPO / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program_or_of_jax():
    code = ("import sys; import portbench.reference.mggan; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {"mggan_tpu_torch"})


def _cfg(name="mggan4_zara1"):
    return json.loads((REPO / f"portbench/configs/{name}.json").read_text())["config"]


@pytest.mark.parametrize("name", ["mggan4_zara1", "mggan8_gofp"])
def test_weights_load_through_the_programs_strict_loaders(name):
    cfg = _cfg(name)
    g_sd, d_sd = ref.make_weights(cfg, torch.Generator().manual_seed(3))
    cfg_obj = program.config(cfg)
    g = program.load_generator(cfg_obj, program.host_state_dict(g_sd), "cpu")
    d = program.load_discriminator(cfg_obj, program.host_state_dict(d_sd), "cpu")
    for sd, (params, _, _) in ((g_sd, g), (d_sd, d)):
        for key, want in ref.trainable(sd).items():
            got = program.program_leaf(params, key)
            assert got.numel() == want.numel(), key
            assert np.isclose(float(got.double().norm()), float(want.double().norm())), key


def test_weights_are_the_seeds():
    cfg = _cfg()
    a = ref.make_weights(cfg, torch.Generator().manual_seed(5))[0]
    b = ref.make_weights(cfg, torch.Generator().manual_seed(5))[0]
    c = ref.make_weights(cfg, torch.Generator().manual_seed(6))[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gs.0.decoder.weight_hh_l0"], c["gs.0.decoder.weight_hh_l0"])


@pytest.mark.parametrize("control", [False, True])
def test_precision_restores_the_switches(control):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with ref.precision(control, "cpu"):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            y = ref.linear({"l.weight": torch.ones(3, 2), "l.bias": torch.zeros(3)}, "l",
                           torch.ones(1, 2))
            assert y.dtype == (torch.bfloat16 if control else torch.float32)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_family_outside_the_reference_is_refused():
    with pytest.raises(ValueError):
        ref.check_family(dict(_cfg(), gan_obj="W"))
