"""The port's deployment surface against the JAX package's (CPU): the
server-side scene crop, ``MicroBatcher``, the HTTP server and the offline
serve CLI.

The HTTP comparison serves one noise-free generator (``noise_dim=0``,
``expected``: no random numbers) from both packages on the same weights
(``generator_from_jax``), at the small widths of ``tests/test_serving.py``
(h = 16, 2 generators). Tolerance: atol 1e-4 over the 12-step rollout
(PARITY.md). ``MicroBatcher`` runs beside the JAX package's on the same
stub calls and submits: the batches, folded seeds, answers, errors and
counters must be the same. Every HTTP call has a
30 s client timeout and every server and batcher is shut down in a
``finally``.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

from mggan_tpu.cli.export import build_serving_fn as jax_build_serving_fn
from mggan_tpu.cli.serve import load_obs_windows as jax_load_obs_windows
from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.data.augment import identity_patches as jax_identity_patches
from mggan_tpu.eval.predict import Predictor as JaxPredictor
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import generator as jax_generator
from mggan_tpu.serving.runtime import MicroBatcher as JaxMicroBatcher
from mggan_tpu.serving.runtime import ServingModel as JaxServingModel
from mggan_tpu.serving.runtime import finish_patches_center as jax_finish_patches_center
from mggan_tpu.serving.server import start_background as jax_start_background

from mggan_tpu_torch.cli import serve as serve_cli
from mggan_tpu_torch.cli.export import build_serving_fn, save_artifact
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models import factory
from mggan_tpu_torch.models.weights import generator_from_jax
from mggan_tpu_torch.serving import MicroBatcher, ServingModel
from mggan_tpu_torch.serving.runtime import (
    MissingSceneInputError,
    finish_patches_center,
    fold_seeds,
)
from mggan_tpu_torch.serving.server import start_background

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

S, P, K = 4, 3, 5
ATOL = 1e-4
SMALL = dict(dataset="synthetic_memory", num_gens=2, h_dim=16, decoder_h_dim=16,
             weighting_target="ml")


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def make_obs(peds, seed=0, steps=8):
    rng = np.random.RandomState(seed)
    return rng.randn(peds, steps, 2).astype(np.float32).cumsum(1) * 0.1


def make_patches(peds, seed=0):
    return np.random.RandomState(100 + seed).rand(peds, 33, 33, 4).astype(np.float32)


def make_scene_img(h=64, w=80, seed=0):
    return np.random.RandomState(200 + seed).randint(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pair():
    """A noise-free generator initialised by the JAX package, served
    (``expected``) by both packages."""
    jcfg = JaxConfig(**SMALL, noise_dim=0)
    g_spec, _ = jax_factory.build_specs(jcfg)
    gp, gs = jax.jit(jax_generator.init, static_argnums=1)(jax.random.PRNGKey(0), g_spec)
    cfg = Config.from_dict(jcfg.to_dict())
    params, state = generator_from_jax(_np_tree(gp), _np_tree(gs), factory.build_specs(cfg),
                                       device="cpu")
    jax_pred = JaxPredictor(jcfg, g_spec, gp, gs)
    port_pred = Predictor(cfg, factory.build_specs(cfg), params, state, device="cpu")
    return {
        "jax": JaxServingModel.from_predictor(jax_pred, "expected", S, P, K),
        "port": ServingModel.from_predictor(port_pred, "expected", S, P, K, device="cpu"),
        "jax_predictor": jax_pred,
        "port_predictor": port_pred,
    }


@pytest.fixture(scope="module")
def sampler():
    """The port's sampling predictor (noise_dim 8) for the batcher cases."""
    cfg = Config(**SMALL, noise_dim=8)
    params, state, spec = factory.construct_model(cfg, seed=0, device="cpu")
    return Predictor(cfg, spec, params, state, device="cpu")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _status(fn):
    """The HTTP status code ``fn`` raises, and its error body."""
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, json.loads(e.value.read())


# ------------------------------------------------------------ scene crop --
def test_finish_patches_center_and_crop_patches_match_jax():
    """``finish_patches_center`` equals JAX's and JAX's
    ``identity_patches`` bit for bit; ``crop_patches`` on one registered
    image equals JAX's, crops off the image's edge included."""
    big = np.random.RandomState(3).randint(0, 256, (5, 49, 49, 3), dtype=np.uint8)
    got = finish_patches_center(big)
    np.testing.assert_array_equal(got, jax_finish_patches_center(big))
    np.testing.assert_array_equal(got, np.asarray(jax_identity_patches(big[None]))[0])

    port = ServingModel({S: None}, S, P, K, wants_scene=True)
    ref = JaxServingModel({S: None}, S, P, K, wants_scene=True)
    img = make_scene_img()
    for m in (port, ref):
        m.register_scene("unit", img, 2.0)
    obs = make_obs(3, seed=4) + 8.0
    obs[2, -1] = (-3.0, 45.0)  # a crop that leaves the image
    np.testing.assert_array_equal(port.crop_patches("unit", obs), ref.crop_patches("unit", obs))
    with pytest.raises(KeyError):
        port.crop_patches("nope", obs)
    with pytest.raises(ValueError):
        port.register_scene("bad", img[..., 0], 2.0)


def test_rejection_is_refused_for_serving_in_both_packages(pair):
    """``rejection`` is not one serving function in either package."""
    with pytest.raises(AssertionError, match="not exportable"):
        jax_build_serving_fn(pair["jax_predictor"], "rejection")
    with pytest.raises(AssertionError, match="not exportable"):
        JaxServingModel.from_predictor(pair["jax_predictor"], "rejection", S, P, K)
    with pytest.raises(ValueError, match="not exportable"):
        build_serving_fn(pair["port_predictor"], "rejection", K)
    with pytest.raises(ValueError, match="not exportable"):
        ServingModel.from_predictor(pair["port_predictor"], "rejection", S, P, K,
                                    device="cpu")


# --------------------------------------------------------- MicroBatcher --
def _drive_batcher(batcher_cls, model_cls, buckets, queued, after, wants_scene=False):
    """One package's ``MicroBatcher`` over a stub model whose calls record
    ``(bucket, seed, scenes)`` and return each slot's last observed position
    plus its patch sum and the seed's low bits.

    A submit is ``(peds, seed, with_patches)``. ``queued[0]`` is submitted
    and its call blocks the worker until the rest of ``queued`` is queued
    behind it; then ``after`` is submitted one request at a time. Returns
    the record, every submit's outcome (a refusal, an answer or an error,
    each error by type and text), the counters and the refusal after
    ``close()``."""
    calls, entered, release = [], threading.Event(), threading.Event()

    def call(xy, mask, pat, seed, draws=None):
        calls.append((len(xy), int(seed), int(mask.any(1).sum())))
        entered.set()
        release.wait(timeout=30.0)
        base = xy[:, :, 7] + pat.sum(axis=(2, 3, 4))[..., None] + np.float32(int(seed) % 1024)
        return np.broadcast_to(base[None, :, :, None], (K, len(xy), P, 12, 2)).copy()

    def outcome(f):
        e = f.exception(timeout=30.0)
        return ("ok", f.result()) if e is None else ("error", type(e).__name__, str(e))

    def submit(mb, peds, seed, with_patches):
        try:
            f = mb.submit(make_obs(peds, seed=seed),
                          make_patches(peds, seed=seed) if with_patches else None, seed)
        except ValueError as e:  # the scene check refuses before queueing
            return ("refused", type(e).__name__)
        return f

    model = model_cls(dict.fromkeys(buckets, call), max(buckets), P, K,
                      wants_scene=wants_scene)
    with batcher_cls(model, max_wait_ms=20.0) as mb:
        futures = [submit(mb, *queued[0])]
        assert entered.wait(timeout=30.0)
        futures += [submit(mb, *r) for r in queued[1:]]
        release.set()
        for f in futures:
            if not isinstance(f, tuple):
                f.exception(timeout=30.0)  # the backlog is served first
        for r in after:
            f = submit(mb, *r)
            futures.append(f)
            if not isinstance(f, tuple):
                f.exception(timeout=30.0)  # one request at a time
        results = [f if isinstance(f, tuple) else outcome(f) for f in futures]
        counters = (mb.batches_run, mb.requests_served, mb.early_dispatches)
    with pytest.raises(RuntimeError, match="closed") as closed:
        mb.submit(make_obs(1), make_patches(1))
    assert not mb._worker.is_alive()
    return calls, results, counters, str(closed.value)


# (buckets, queued, after, wants_scene); a submit is (peds, seed, with_patches)
_BATCHER_SCRIPTS = {
    # a backlog grows past bucket 1 at once, stops at the largest bucket,
    # and its tail dispatches early at bucket 1; seeds fold in queue order
    "backlog": ((1, 2, 4),
                [(1, 7, False), (2, 3, True), (3, 3, False), (1, 11, True), (2, 0, False),
                 (3, 2**31 - 2, True)],
                [(2, 5, False), (1, 5, True)], False),
    # one bucket: no early dispatch, every batch waits out max_wait or fills
    "single_bucket": ((4,),
                      [(1, 1, False), (2, 2, False), (3, 3, True), (1, 4, False),
                       (2, 5, False), (3, 6, True), (1, 7, False)],
                      [(2, 8, False)], False),
    # a request with too many peds fails every request of its batch; the
    # batcher serves the next one
    "errors": ((1, 2, 4),
               [(1, 1, False), (2, 2, False), (P + 2, 3, False), (1, 4, True)],
               [(1, 5, False)], False),
    # a scene model refuses a patch-less request before queueing it
    "scene_check": ((1, 2, 4),
                    [(1, 1, True), (2, 2, False), (2, 3, True), (1, 4, True)],
                    [(1, 5, False), (3, 6, True)], True),
}


@pytest.mark.parametrize("script", list(_BATCHER_SCRIPTS))
def test_microbatcher_matches_jax_batcher(script):
    """The port's and the JAX package's ``MicroBatcher`` on the same stub
    calls and the same submits: the same batches, bucket for bucket, with
    the same folded seeds; the same answers and errors to every caller; the
    same counters; the same refusals."""
    buckets, queued, after, wants_scene = _BATCHER_SCRIPTS[script]
    got = _drive_batcher(MicroBatcher, ServingModel, buckets, queued, after, wants_scene)
    want = _drive_batcher(JaxMicroBatcher, JaxServingModel, buckets, queued, after,
                          wants_scene)
    assert got[0] == want[0] and len(got[0]) > 1
    assert got[2:] == want[2:]
    assert len(got[1]) == len(want[1]) == len(queued) + len(after)
    for a, b in zip(got[1], want[1]):
        if a[0] == "ok":
            assert b[0] == "ok"
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a == b


def _grouping(sampler):
    """Concurrent submits share device calls, and each caller gets its slice
    of a direct ``predict_batch`` with the folded seed."""
    model = ServingModel.from_predictor(sampler, "sampling", S, P, K,
                                        allow_missing_scene=True, device="cpu")
    obs = [make_obs(1 + i % P, seed=i) for i in range(S)]
    with pytest.warns(UserWarning, match="without scene patches"):
        with MicroBatcher(model, max_wait_ms=200.0) as mb:
            outs = [f.result(timeout=60) for f in [mb.submit(o, seed=11) for o in obs]]
            assert mb.batches_run < len(obs) and mb.requests_served == len(obs)
    direct = model.predict_batch(obs, seed=fold_seeds([11] * len(obs)))
    for got, want, o in zip(outs, direct, obs):
        assert got.shape == (K, o.shape[0], 12, 2)
        np.testing.assert_array_equal(got, want)


def _seeds(sampler):
    """Replaying a request gives its samples again; another seed other ones."""
    model = ServingModel.from_predictor(sampler, "sampling", S, P, K, device="cpu")
    obs, pat = make_obs(2, seed=5), make_patches(2, seed=5)
    with MicroBatcher(model, max_wait_ms=1.0) as mb:
        a = mb.predict(obs, pat, seed=7)
        b = mb.predict(obs, pat, seed=7)
        c = mb.predict(obs, pat, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def _early_dispatch(sampler):
    """A lone request dispatches as soon as it fills bucket 1, not after
    max_wait, and equals the direct call on its folded seed."""
    model = ServingModel.from_predictor(sampler, "sampling", S, P, K,
                                        scene_buckets=(1, 2, S), device="cpu")
    obs, pat = make_obs(2, seed=6), make_patches(2, seed=6)
    with MicroBatcher(model, max_wait_ms=10_000.0) as mb:
        t0 = time.monotonic()
        out = mb.predict(obs, patches=pat, seed=7, timeout=60.0)
        assert time.monotonic() - t0 < 5.0
        assert mb.early_dispatches == 1
    np.testing.assert_array_equal(out, model.predict(obs, patches=pat, seed=fold_seeds([7])))


def _stress(_):
    """32 threads (more than the cores) of 8 submits each, with a short
    switch interval: every request gets back its own scene's answer and
    each is served once (a stub model that echoes each slot's last
    observed position)."""
    def call(xy, mask, pat, seed, draws=None):
        return np.broadcast_to(xy[None, :, :, None, 7], (K, len(xy), P, 12, 2)).copy()

    fake = ServingModel(call, 4, P, K, buckets=(1, 2, 4), wants_scene=False)
    results, old = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MicroBatcher(fake, max_wait_ms=1.0) as mb:
            def client(c):
                for j in range(8):
                    obs = make_obs(1 + (c + j) % P, seed=100 * c + j)
                    results[c, j] = (obs, mb.submit(obs, seed=c))

            threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for obs, f in results.values():
                got = f.result(timeout=60)
                np.testing.assert_array_equal(
                    got, np.broadcast_to(obs[None, :, None, -1], got.shape))
            assert mb.requests_served == len(results) == 32 * 8
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("case", [_grouping, _seeds, _early_dispatch, _stress],
                         ids=["grouping", "seeds", "early_dispatch", "stress"])
def test_microbatcher_serves_the_port_model(sampler, case):
    """The port's batcher over its own sampling model (the fold is held to
    JAX's by ``test_microbatcher_matches_jax_batcher``)."""
    case(sampler)


# ------------------------------------------------------------------ HTTP --
def test_http_server_matches_jax(pair):
    """Both packages' servers on the same noise-free weights: the same
    metadata keys, predictions within 1e-4 with ``patches`` and with
    ``scene_ids``, 400 without scene input, 404 for an unknown path; the
    port's answer equals its direct call on the folded seed bit for bit."""
    servers = {}
    try:
        for name, start in (("jax", jax_start_background), ("port", start_background)):
            servers[name] = start(pair[name], max_wait_ms=5.0)
        ports = {name: s[2] for name, s in servers.items()}
        meta = {name: _get(p, "/v1/metadata") for name, p in ports.items()}
        assert set(meta["port"]) == set(meta["jax"])
        for k in ("scenes", "peds", "num", "scene_buckets", "obs_len", "pred_len",
                  "strategy", "wants_scene", "allow_missing_scene", "registered_scenes"):
            assert meta["port"][k] == meta["jax"][k], k
        assert _get(ports["port"], "/healthz") == {"status": "ok"}

        obs = [make_obs(2, seed=6), make_obs(3, seed=7)]
        img = make_scene_img(seed=1)
        got = {}
        for name, p in ports.items():
            assert _post(p, "/v1/scenes", {"name": "lobby", "image": img.tolist(),
                                          "px_per_meter": 2.0})["scenes"] == ["lobby"]
            with_patches = _post(p, "/v1/predict", {
                "scenes": [o.tolist() for o in obs],
                "patches": [make_patches(len(o), seed=i).tolist() for i, o in enumerate(obs)],
                "seed": 3})
            with_ids = _post(p, "/v1/predict", {"scenes": [obs[0].tolist()],
                                                "scene_ids": ["lobby"], "seed": 3})
            assert "warning" not in with_patches and "warning" not in with_ids
            got[name] = ([np.asarray(x, np.float32) for x in with_patches["predictions"]],
                         np.asarray(with_ids["predictions"][0], np.float32))
            code, body = _status(lambda: _post(p, "/v1/predict",
                                               {"scenes": [obs[0].tolist()]}))
            assert code == 400 and "MissingSceneInputError" in body["error"]
            assert _status(lambda: _post(p, "/v1/nope", {}))[0] == 404
            assert _status(lambda: _get(p, "/v1/nope"))[0] == 404
            assert _status(lambda: _post(p, "/v1/predict", {"scenes": "nope"}))[0] == 400
        for a, b in zip(got["port"][0], got["jax"][0]):
            assert a.shape == b.shape and np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=ATOL)
        np.testing.assert_allclose(got["port"][1], got["jax"][1], atol=ATOL)

        m = pair["port"]
        want = m.predict_batch([obs[0]], [m.crop_patches("lobby", obs[0])],
                               seed=fold_seeds([3]))[0]
        np.testing.assert_array_equal(got["port"][1], want)
        assert _get(ports["port"], "/v1/metadata")["requests_served"] == 3
    finally:
        for server, batcher, _ in servers.values():
            server.shutdown()
            server.server_close()
            batcher.close()


# --------------------------------------------------------- offline CLI --
def test_offline_cli_matches_jax_windows(sampler, tmp_path):
    """``load_obs_windows`` equals JAX's on one txt (a ped leaving, one
    arriving), and ``cli.serve --input`` over an artifact with
    ``--scene_img`` writes JAX's npz keys, the windows' ped ids and, per
    window, the direct call on the crop and the chunk's seed."""
    rows = [f"{f} {pid} {0.1 * f + pid:.3f} {0.05 * f + 3:.3f}"
            for f in range(12) for pid in (1, 2, 3) if not (pid == 3 and f < 3)
            and not (pid == 1 and f > 9)]
    txt = tmp_path / "obs.txt"
    txt.write_text("\n".join(rows) + "\n")
    scenes, ids = serve_cli.load_obs_windows(txt)
    want_scenes, want_ids = jax_load_obs_windows(txt)
    assert len(scenes) == len(want_scenes) == 5
    for a, b, c, d in zip(scenes, want_scenes, ids, want_ids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)

    art = tmp_path / "m.mgtorch"
    save_artifact(sampler, art, "sampling", (1, 2), P, K)
    img = make_scene_img(seed=2)
    cv2.imwrite(str(tmp_path / "scene.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    argv = ["--artifact", str(art), "--input", str(txt), "--device", "cpu", "--seed", "4"]
    with pytest.raises(MissingSceneInputError):
        serve_cli.main(argv + ["--output", str(tmp_path / "x.npz")])
    out = serve_cli.main(argv + ["--output", str(tmp_path / "p.npz"), "--scene_img",
                                 str(tmp_path / "scene.png"), "--px_per_meter", "2.0"])
    z = np.load(out)
    n = len(scenes)
    assert sorted(z.files) == sorted([f"window_{i:05d}" for i in range(n)]
                                     + [f"ped_ids_{i:05d}" for i in range(n)])
    model = ServingModel.from_artifact(art, device="cpu")
    model.register_scene("s", img, 2.0)
    for i in range(0, n, 2):
        chunk = scenes[i:i + 2]
        direct = model.predict_batch(chunk, [model.crop_patches("s", o) for o in chunk],
                                     seed=4 + i)
        for j, d in enumerate(direct):
            np.testing.assert_array_equal(z[f"window_{i + j:05d}"], d)
            np.testing.assert_array_equal(z[f"ped_ids_{i + j:05d}"], want_ids[i + j])
            assert np.isfinite(d).all()
