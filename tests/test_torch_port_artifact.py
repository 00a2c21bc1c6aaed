"""The serving artifact as a program (CPU): the kernel operators, the
``torch.export`` bucket programs against live serving and against the JAX
package's ``.jaxexport`` artifact, and an artifact served without the model
code.

The model is the smallest that runs the path (2 generators, h = 16), as in
``tests/test_torch_port_serving.py``. The artifact equals live serving bit
for bit: the program runs the same operators on the same draws, which the
call around it draws from the seed in the live call's order. Against JAX
the tolerance is atol 1e-4 over the 12-step rollout (PARITY.md).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mggan_tpu.cli.export import export_predictor as jax_export_predictor
from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.eval.predict import Predictor as JaxPredictor
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator

from mggan_tpu_torch.cli import export as export_cli
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import common, factory
from mggan_tpu_torch.models.weights import generator_from_jax
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.ops.kernels import library  # noqa: F401  registers mggan::*
from mggan_tpu_torch.serving.runtime import EXPORTABLE, ServingModel

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P, K = 3, 5
BUCKETS = (1, 2)
ATOL = 1e-4
SMALL = dict(dataset="synthetic_memory", num_gens=2, h_dim=16, decoder_h_dim=16,
             weighting_target="ml")
OPERATOR = {s: "mggan.decode_select.default" if s == "sampling"
            else "mggan.decode_all_fwd.default" for s in EXPORTABLE}


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _request(n, seed):
    rng = np.random.RandomState(seed)
    obs = [rng.randn(P - i % 2, 8, 2).astype(np.float32).cumsum(1) * 0.3 for i in range(n)]
    pat = [rng.uniform(-1, 1, (len(o), 33, 33, 4)).astype(np.float32) for o in obs]
    return obs, pat


def _operators(call):
    return {str(n.target) for n in call.program.graph.nodes if str(n.target).startswith("mggan.")}


@pytest.fixture(scope="module")
def predictor():
    cfg = Config(**SMALL, noise_dim=8)
    params, state, spec = factory.construct_model(cfg, seed=0, device="cpu")
    return Predictor(cfg, spec, params, state, device="cpu")


@pytest.fixture(scope="module")
def artifacts(predictor, tmp_path_factory):
    """Each exportable strategy's artifact at BUCKETS, written once."""
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for s in EXPORTABLE:
        paths[s] = out / f"{s}.mgtorch"
        export_cli.save_artifact(predictor, paths[s], s, BUCKETS, P, K)
    return paths


# ---------------------------------------------------------- the operators --
def _rollout_case():
    st = common.stacked_decoders_init(torch.Generator().manual_seed(0), 2, 4, 8, "abs_rel", 4)
    packed = kdec.pack_decoder_params(st, "abs_rel")
    g = torch.Generator().manual_seed(1)
    m, n = 3, 6
    socb = kdec.social_bias(packed, torch.randn(m, 4, generator=g)).contiguous()
    rows = (torch.randn(n, 8, generator=g), torch.randn(m, 2, generator=g),
            torch.randn(m, 2, generator=g))
    return [packed[k] for k in kdec.PACKED] + [socb, *rows]


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_select_operator_opcheck(bf16):
    """K1's operator: schema, fake and dispatch tests of
    ``torch.library.opcheck`` on its CPU implementation."""
    args = _rollout_case()
    idx = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)
    torch.library.opcheck(torch.ops.mggan.decode_select.default,
                          (*args, idx, 5, "abs_rel", bf16))


@pytest.mark.parametrize("save_hc", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_all_fwd_operator_opcheck(save_hc, bf16):
    """K2's operator, with and without (h, c)."""
    torch.library.opcheck(torch.ops.mggan.decode_all_fwd.default,
                          (*_rollout_case(), 5, "abs_rel", save_hc, bf16))


def test_operators_on_meta_tensors_and_the_device_rule():
    """The meta device runs the operators' fakes, which give the output
    shapes; the wrapper takes only CPU and CUDA tensors."""
    args = [x.to("meta") for x in _rollout_case()]
    idx = torch.zeros(6, dtype=torch.int32, device="meta")
    a, r = torch.ops.mggan.decode_select(*args, idx, 5, "abs_rel", False)
    assert a.shape == r.shape == (6, 5, 2) and a.device.type == "meta"
    a, r, hc = torch.ops.mggan.decode_all_fwd(*args, 5, "abs_rel", True, False)
    assert a.shape == (2, 6, 5, 2) and hc.shape == (2, 6, 5, 2, 8)
    st = common.stacked_decoders_init(torch.Generator().manual_seed(0), 2, 4, 8, "rel", 4)
    meta = lambda t: {k: meta(v) for k, v in t.items()} if isinstance(t, dict) else t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kdec.decode_select(meta(st), *(torch.zeros(s, device="meta") for s in
                                       ((3, 2), (3, 2), (3, 4), (6, 8))),
                           idx, 5, "rel")


# ------------------------------------------------- artifact against live --
@pytest.mark.parametrize("strategy", EXPORTABLE)
def test_artifact_equals_live_serving(predictor, artifacts, strategy):
    """Every exportable strategy's bucket programs hold K1 (``sampling``)
    or K2 (the rest) and equal live serving bit for bit at a seed (the
    artifact's draws in the live call's order) and with injected draws."""
    art = ServingModel.from_artifact(artifacts[strategy], device="cpu")
    live = ServingModel.from_predictor(predictor, strategy, BUCKETS[-1], P, K,
                                       scene_buckets=BUCKETS, device="cpu")
    assert (art.buckets, art.peds, art.num, art.strategy) == (BUCKETS, P, K, strategy)
    for b in BUCKETS:
        assert _operators(art._calls[b]) == {OPERATOR[strategy]}
    header, payloads = export_cli.read_artifact(artifacts[strategy])
    assert header["format"] == "mggan_tpu_torch.artifact/2" and len(payloads) == 2
    assert (header["device"], header["torch"]) == ("cpu", torch.__version__)
    names = [d[0] for d in header["draws"]["2"]]
    want_names = {"sampling": ["uniforms", "z"], "smart_sampling": ["z", "uniforms"],
                  "uniform_sampling": ["z", "uniforms"]}.get(strategy, ["z"])
    assert names == want_names
    for n, seed in ((1, 3), (2, 9)):
        obs, pat = _request(n, seed)
        for a, b in zip(art.predict_batch(obs, pat, seed=seed),
                        live.predict_batch(obs, pat, seed=seed)):
            assert a.shape == b.shape and np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)
        rng = np.random.RandomState(seed)
        draws = {"z": rng.randn(K, n, 1, 8).astype(np.float32),
                 "uniforms": rng.uniform(1e-6, 1, (K, n, P, 2)).astype(np.float32)}
        for a, b in zip(art.predict_batch(obs, pat, draws=draws),
                        live.predict_batch(obs, pat, draws=draws)):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- against the JAX one --
def _jax_pair(noise_dim):
    jcfg = JaxConfig(**SMALL, noise_dim=noise_dim)
    g_spec, _ = jax_factory.build_specs(jcfg)
    gp, gs = jax.jit(jax_generator.init, static_argnums=1)(jax.random.PRNGKey(0), g_spec)
    cfg = Config.from_dict(jcfg.to_dict())
    params, state = generator_from_jax(_np_tree(gp), _np_tree(gs), factory.build_specs(cfg),
                                       device="cpu")
    return (JaxPredictor(jcfg, g_spec, gp, gs),
            Predictor(cfg, factory.build_specs(cfg), params, state, device="cpu"))


def _padded(s, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((s, P), bool)
    mask[0, 2:] = False
    return (rng.randn(s, P, 20, 2).astype(np.float32).cumsum(2) * 0.1, mask,
            rng.uniform(-1, 1, (s, P, 33, 33, 4)).astype(np.float32))


def test_expected_program_matches_jax_artifact(tmp_path):
    """A noise-free ``expected`` model (no draws): the port's program and the
    JAX package's ``.jaxexport`` program on the same weights and inputs."""
    jax_pred, port_pred = _jax_pair(noise_dim=0)
    s = 2
    exported = jax_export_predictor(jax_pred, "expected", s, P, K)
    path = tmp_path / "e.mgtorch"
    export_cli.save_artifact(port_pred, path, "expected", (s,), P, K)
    call, header = export_cli.load_artifact(path, device="cpu")
    assert header["draws"][str(s)] == [["z", "normal", [K, s, 1, 0]]]
    xy, mask, pat = _padded(s, 4)
    want = np.asarray(exported.call(jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(pat),
                                    jnp.int32(7)))
    got = call(xy, mask, pat, 7).numpy()
    assert got.shape == want.shape == (K, s, P, 12, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sampling_program_matches_jax_on_its_draws(tmp_path):
    """``sampling`` (noise_dim 8): the port's program fed the draws the JAX
    predictor takes from ``PRNGKey(seed)`` against that predictor."""
    jax_pred, port_pred = _jax_pair(noise_dim=8)
    s, seed = 2, 11
    path = tmp_path / "s.mgtorch"
    export_cli.save_artifact(port_pred, path, "sampling", (s,), P, K)
    call, _ = export_cli.load_artifact(path, device="cpu")
    xy, mask, pat = _padded(s, 5)
    want = jax_pred.predict({"xy": jnp.asarray(xy), "ped_mask": jnp.asarray(mask),
                             "patches": jnp.asarray(pat)}, jax.random.PRNGKey(seed), num=K)[0]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))  # as Predictor._decode_sampled
    draws = {"uniforms": np.array(jax.random.uniform(k2, (K, s, P, 2), minval=1e-20,
                                                     maxval=1.0)),
             "z": np.array(jax.random.normal(k1, (K, s, 1, 8)))}
    got = call(xy, mask, pat, seed, draws=draws).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


# ------------------------------------------------- without the model code --
BLOCKED = ("jax", "mggan_tpu", "mggan_tpu_torch.models", "mggan_tpu_torch.eval",
           "mggan_tpu_torch.training", "mggan_tpu_torch.data")


def test_artifact_serves_without_the_model_code(artifacts, tmp_path):
    """A process in which the JAX package, JAX and the port's models, eval,
    training and data packages cannot be imported loads the ``sampling``
    artifact and serves it: its answers at a seed and on injected draws
    equal this process's bit for bit."""
    xy, mask, pat = _padded(2, 6)
    rng = np.random.RandomState(8)
    z = rng.randn(K, 2, 1, 8).astype(np.float32)
    u = rng.uniform(1e-6, 1, (K, 2, P, 2)).astype(np.float32)
    np.savez(tmp_path / "in.npz", xy=xy, mask=mask, pat=pat, z=z, u=u)
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from mggan_tpu_torch.cli.export import load_artifact_all\n"
        f"calls, header = load_artifact_all({str(artifacts['sampling'])!r}, device='cpu')\n"
        f"d = np.load({str(tmp_path / 'in.npz')!r})\n"
        "a = calls[2](d['xy'], d['mask'], d['pat'], 5)\n"
        "b = calls[2](d['xy'], d['mask'], d['pat'], 0, draws={'z': d['z'], 'uniforms': d['u']})\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, a=a.numpy(), b=b.numpy())\n"
        "loaded = [m for m in sys.modules if m.startswith('mggan_tpu_torch.')]\n"
        "assert not any(m.startswith(b + '.') for m in loaded for b in "
        f"{BLOCKED!r}), loaded\n"
        "print(header['strategy'], sorted(calls))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "sampling [1, 2]"
    calls, _ = export_cli.load_artifact_all(artifacts["sampling"], device="cpu")
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(got["a"], calls[2](xy, mask, pat, 5).numpy())
    np.testing.assert_array_equal(
        got["b"], calls[2](xy, mask, pat, 0, draws={"z": z, "uniforms": u}).numpy())
