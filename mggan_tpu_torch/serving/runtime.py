"""Fixed-shape serving front-end and the micro-batching queue (counterpart
of ``mggan_tpu/serving/runtime.py``).

``ServingModel`` pads variable-sized requests (scenes of p pedestrians, 8
observed steps each) to scene-count buckets of fixed ``(scenes, peds)``
shape: a request of n scenes runs at the smallest bucket that holds it. It
serves a live ``Predictor`` (``from_predictor``), a trained version dir
(``from_version_dir``) or an artifact of ``cli/export.py``
(``from_artifact``), and crops scene patches on the server from registered
scene images (``register_scene`` / ``crop_patches``). ``MicroBatcher``
gathers concurrent single-scene requests into one device call.

Shapes follow the reference's data contract: OBS_LEN=8 observed positions
in, (num, peds, 12, 2) absolute future positions out
(BaseTrajectories.py:30-31).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import torch

from mggan_tpu_torch.config import OBS_LEN, PATCH_C, PATCH_HW, SEQ_LEN
from mggan_tpu_torch.data.augment import identity_patches
from mggan_tpu_torch.data.dataset import extract_big_patches
from mggan_tpu_torch.device import resolve_device

# Strategies whose selection runs as one function of (batch, seed)
# (mggan_tpu/cli/export.py:31-34); rejection is not among them.
EXPORTABLE = (
    "sampling", "expected", "uniform_expected", "smart_expected",
    "smart_sampling", "uniform_sampling",
)


class MissingSceneInputError(ValueError):
    """A scene-conditioned model was asked to predict without scene patches
    (see ``ServingModel.check_scene_input``)."""


def finish_patches_center(big_patches: np.ndarray) -> np.ndarray:
    """uint8 (N,49,49,3) big patches -> (N,33,33,4) float32 model patches:
    the eval feed's ``data/augment.py::identity_patches`` on the host, so
    the server's crops match the eval feed's."""
    return identity_patches(torch.from_numpy(big_patches[None]))[0].numpy()


def build_serving_fn(predictor, strategy: str, num: int):
    """``(xy, ped_mask, patches, seed, draws=None) -> pred_abs`` over
    ``predictor`` for any scene count; raises for a strategy outside
    ``EXPORTABLE``."""
    if strategy not in EXPORTABLE:
        raise ValueError(f"strategy {strategy!r} is not exportable as one serving "
                         f"function (choose from {EXPORTABLE})")
    pred_func = predictor.get_predict_func(strategy)

    def serve(xy, ped_mask, patches, seed, draws=None):
        batch = {"xy": xy, "ped_mask": ped_mask, "patches": patches}
        gen = None if draws is not None else predictor.new_generator(seed)
        return pred_func(batch, gen, num=num, draws=draws)[0]

    return serve


class ServingModel:
    """call(xy (S,P,20,2) f32, ped_mask (S,P) bool, patches (S,P,33,33,4) f32,
    seed, draws=None) -> pred_abs (num, S, P, 12, 2). ``calls`` is one call
    that serves every scene-count bucket in ``buckets`` (default
    ``(scenes,)``), or a dict ``{bucket: call}``; ``scenes`` is the largest
    bucket.

    ``wants_scene`` records whether the model has a scene CNN. When True and
    a request carries no patches, prediction raises
    ``MissingSceneInputError`` unless ``allow_missing_scene`` (then it warns
    once). ``device`` is where the calls run (None for a model of host
    calls); ``source`` names what is served (``/v1/metadata`` reports it).
    """

    def __init__(self, calls, scenes: int, peds: int, num: int, *, buckets=None,
                 strategy: str = "?", source: str = "?", wants_scene: bool | None = None,
                 allow_missing_scene: bool = False, device=None):
        if callable(calls):
            calls = dict.fromkeys(buckets or (scenes,), calls)
        self._calls = dict(sorted(calls.items()))
        self.buckets = tuple(self._calls)
        if scenes != self.buckets[-1]:
            raise ValueError(f"scenes={scenes} must equal the largest bucket {self.buckets}")
        self.scenes = scenes
        self.peds = peds
        self.num = num
        self.strategy = strategy
        self.source = source
        self.wants_scene = wants_scene
        self.allow_missing_scene = allow_missing_scene
        self.device = device
        self._warned_missing = False
        # name -> {"small": (H,W,3) uint8 half-resolution scene image,
        #          "px_per_meter": pixels per meter of that image}
        self.scene_registry: dict = {}
        self._zero_patches = np.zeros(
            (scenes, peds, PATCH_HW, PATCH_HW, PATCH_C), np.float32
        )

    # --------------------------------------------------------- constructors
    @classmethod
    def from_predictor(cls, predictor, strategy: str, scenes: int, peds: int,
                       num: int, allow_missing_scene: bool = False,
                       scene_buckets=None, device="cuda") -> "ServingModel":
        """Live path over a ``Predictor``, which must sit on ``device``.

        ``scene_buckets``: ascending scene-count paddings, the largest equal
        to ``scenes``. Raises for a strategy outside ``EXPORTABLE``.
        """
        dev = resolve_device(device)
        if predictor.device != dev:
            raise ValueError(f"predictor is on {predictor.device}, not {dev}")
        return cls(build_serving_fn(predictor, strategy, num), scenes, peds, num,
                   buckets=scene_buckets, strategy=strategy, source="live",
                   wants_scene=predictor.g_spec.scene_dim > 0,
                   allow_missing_scene=allow_missing_scene, device=dev)

    @classmethod
    def from_version_dir(cls, version_dir, strategy="sampling", scenes=64, peds=16,
                         num=20, checkpoint="best", allow_missing_scene: bool = False,
                         scene_buckets=None, device="cuda") -> "ServingModel":
        """Serve a trained version dir (loaded with
        ``Trainer.load_from_path`` on ``device``)."""
        from mggan_tpu_torch.training.loop import Trainer

        device = resolve_device(device)
        trainer, _ = Trainer.load_from_path(Path(version_dir), checkpoint, device=device)
        m = cls.from_predictor(trainer.predictor(), strategy, scenes, peds, num,
                               allow_missing_scene=allow_missing_scene,
                               scene_buckets=scene_buckets, device=device)
        m.source = str(Path(version_dir))
        return m

    @classmethod
    def from_artifact(cls, path, allow_missing_scene: bool = False,
                      device="cuda") -> "ServingModel":
        """Serve an artifact of ``cli/export.py`` on ``device``: every scene
        bucket it records, its ``peds``, ``num``, ``strategy`` and
        ``wants_scene``."""
        from mggan_tpu_torch.cli.export import load_artifact_predictor

        dev = resolve_device(device)
        predictor, meta = load_artifact_predictor(path, device=dev)
        buckets = meta["scene_buckets"]
        m = cls.from_predictor(predictor, meta["strategy"], max(buckets), meta["peds"],
                               meta["num"], allow_missing_scene=allow_missing_scene,
                               scene_buckets=buckets, device=dev)
        m.source = str(Path(path))
        return m

    # -------------------------------------------------------- scene context
    def register_scene(self, name: str, image, px_per_meter: float):
        """Register a scene image for server-side patch cropping. ``image``:
        (H,W,3) uint8 RGB at the training pipeline's "small" resolution
        (``data/parsing.py::build_image_entry``); ``px_per_meter``: its
        pixels per meter (1 / scaling_small)."""
        img = np.ascontiguousarray(np.asarray(image, dtype=np.uint8))
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"scene image must be (H,W,3) uint8, got {img.shape}")
        self.scene_registry[name] = {"small": img, "px_per_meter": float(px_per_meter)}

    def crop_patches(self, scene_name: str, obs) -> np.ndarray:
        """(p,33,33,4) model patches cut from a registered scene at each
        ped's last observed position: the training-time crop
        (data/parsing.py) and then the eval identity transform."""
        if scene_name not in self.scene_registry:
            raise KeyError(
                f"scene {scene_name!r} not registered (have "
                f"{sorted(self.scene_registry)}); POST /v1/scenes or call "
                f"register_scene() first"
            )
        entry = self.scene_registry[scene_name]
        obs = np.asarray(obs, np.float32)
        centers_px = obs[:, -1] * entry["px_per_meter"]  # last observed position
        return finish_patches_center(extract_big_patches(entry["small"], centers_px))

    def check_scene_input(self, have_patches: bool):
        """Raise ``MissingSceneInputError`` for a scene-conditioned model
        with no scene input (warn once when allowed or unknown)."""
        if have_patches or self.wants_scene is False:
            return
        if self.wants_scene and not self.allow_missing_scene:
            raise MissingSceneInputError(
                "this model conditions on scene patches but the request "
                "carries none — pass per-scene (p,33,33,4) patches, or "
                "register a scene image and reference it, or opt out "
                "explicitly with allow_missing_scene=True "
                "(--allow_missing_scene) to serve degraded zero-patch "
                "predictions"
            )
        if not self._warned_missing:
            self._warned_missing = True
            warnings.warn(
                "serving without scene patches: a scene-conditioned model "
                "will produce degraded zero-patch predictions",
                stacklevel=2,
            )

    # ------------------------------------------------------------- predict
    def pad_request(self, scene_obs, patches=None):
        """Pad a request to its bucket: ``(xy, mask, patches)`` numpy arrays
        of shape ``(s,P,20,2)``, ``(s,P)`` and ``(s,P,33,33,4)``. The
        unobserved future is filled with the last observed position."""
        if len(scene_obs) > self.scenes:
            raise ValueError(f"{len(scene_obs)} scenes > compiled batch {self.scenes}")
        s = next(b for b in self.buckets if b >= len(scene_obs))
        p = self.peds
        for i in range(len(scene_obs)):
            self.check_scene_input(patches is not None and patches[i] is not None)
        xy = np.zeros((s, p, SEQ_LEN, 2), np.float32)
        mask = np.zeros((s, p), bool)
        pat = (self._zero_patches[:s].copy() if patches is not None
               else self._zero_patches[:s])
        for i, obs in enumerate(scene_obs):
            obs = np.asarray(obs, np.float32)
            if obs.ndim != 3 or obs.shape[-1] != 2 or obs.shape[1] < OBS_LEN:
                raise ValueError(
                    f"scene {i}: expected (peds, >={OBS_LEN}, 2), got {obs.shape}"
                )
            n = obs.shape[0]
            if n > p:
                raise ValueError(f"scene {i}: {n} peds > compiled max {p}")
            xy[i, :n, :OBS_LEN] = obs[:, -OBS_LEN:]
            xy[i, :n, OBS_LEN:] = obs[:, -1:, :]
            mask[i, :n] = True
            if patches is not None and patches[i] is not None:
                pat[i, :n] = np.asarray(patches[i], np.float32)
        return xy, mask, pat

    def predict_batch(self, scene_obs, patches=None, seed: int = 0, draws=None):
        """One device call over up to ``self.scenes`` scenes.

        ``scene_obs``: list of ``(p_i, >=8, 2)`` arrays (the last 8 rows are
        observed); ``patches``: optional list of ``(p_i, 33, 33, 4)``;
        ``draws``: optional injected random numbers at the bucket's shape
        (see ``Predictor.predict``). Returns a list of
        ``(num, p_i, 12, 2)`` absolute future positions.
        """
        xy, mask, pat = self.pad_request(scene_obs, patches)
        out = self._calls[xy.shape[0]](xy, mask, pat, seed, draws=draws)
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        return [out[:, i, : np.shape(o)[0]] for i, o in enumerate(scene_obs)]

    def predict(self, obs, patches=None, seed: int = 0):
        """Single scene: (p, >=8, 2) -> (num, p, 12, 2)."""
        return self.predict_batch(
            [obs], None if patches is None else [patches], seed
        )[0]


class _Request:
    __slots__ = ("obs", "patches", "seed", "future")

    def __init__(self, obs, patches, seed):
        self.obs = obs
        self.patches = patches
        self.seed = seed
        self.future: Future = Future()


def fold_seeds(seeds) -> int:
    """The batch's one seed: every request's seed folded in queue order."""
    seed = 0
    for s in seeds:
        seed = (seed * 1_000_003 + s + 1) % 2**31
    return seed


class MicroBatcher:
    """Cross-request dynamic batching.

    Requests (one scene each) queue up; a worker thread drains up to
    ``model.scenes`` of them, waiting at most ``max_wait_ms`` after the
    first, and makes ONE device call. Draining is bucket-aware: when the
    queue is empty and the batch so far exactly fills one of the model's
    scene buckets, the batch dispatches at once instead of waiting toward
    the largest bucket, so a lone request gets the small bucket's latency
    while a backlog still grows batches without extra wait.
    ``early_dispatches`` counts those dispatches.

    The call takes one seed per batch: every request's seed folded in queue
    order (``fold_seeds``). Requests co-batched with distinct seeds or
    slots get distinct samples; two same-seed requests of identical
    composition in separate batches get identical samples. Replaying a
    request stream reproduces its predictions only when the batch
    boundaries replay (exact for sequential ``predict`` calls).

    The worker launches the kernels on the device and stream that were
    current on ``model.device`` when the batcher was made; a result's copy
    to the host is its fence. Shut down with ``close()`` (also a context
    manager).
    """

    def __init__(self, model: ServingModel, max_wait_ms: float = 5.0):
        self.model = model
        self.max_wait = max_wait_ms / 1000.0
        dev = model.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev is not None and dev.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self.batches_run = 0
        self.requests_served = 0
        self.early_dispatches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, obs, patches=None, seed: int = 0) -> Future:
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        # the scene contract is enforced BEFORE queueing, so one patch-less
        # request cannot fail the micro-batch it would land in
        self.model.check_scene_input(patches is not None)
        req = _Request(np.asarray(obs, np.float32), patches, int(seed))
        self._q.put(req)
        return req.future

    def predict(self, obs, patches=None, seed: int = 0, timeout=60.0):
        return self.submit(obs, patches, seed).result(timeout)

    # ------------------------------------------------------------ internals
    def _drain(self):
        """Block for one request, then collect more until the batch is full
        or max_wait elapses. Returns [] only on shutdown."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        buckets = self.model.buckets
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.model.scenes:
            # with nothing queued and the batch exactly filling a bucket,
            # waiting can only add latency: the next request would need the
            # next larger bucket anyway
            if len(batch) in buckets and self._q.empty():
                self.early_dispatches += 1
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-signal shutdown after this batch
                break
            batch.append(nxt)
        return batch

    def _run(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                if self._closed and self._q.empty():
                    return
                batch = self._drain()
                if not batch:
                    if self._closed:
                        return
                    continue
                self._serve(batch)

    def _serve(self, batch):
        try:
            patches = (None if all(r.patches is None for r in batch)
                       else [r.patches for r in batch])
            outs = self.model.predict_batch([r.obs for r in batch], patches,
                                            fold_seeds(r.seed for r in batch))
            self.batches_run += 1
            self.requests_served += len(batch)
            for r, o in zip(batch, outs):
                r.future.set_result(o)
        except Exception as e:  # noqa: BLE001 — every caller of the batch gets it
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
