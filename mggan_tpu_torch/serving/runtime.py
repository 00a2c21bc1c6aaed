"""Fixed-shape serving front-end (counterpart of
``mggan_tpu/serving/runtime.py::ServingModel``).

Requests of variable size (scenes of p pedestrians, 8 observed steps each)
are padded to scene-count buckets of fixed ``(scenes, peds)`` shape: a
request of n scenes runs at the smallest bucket that holds it. Not ported
yet: ``MicroBatcher``, the HTTP server, server-side ``crop_patches`` and
exported artifacts.
"""

from __future__ import annotations

import warnings

import numpy as np

from mggan_tpu_torch.config import OBS_LEN, PATCH_C, PATCH_HW, SEQ_LEN
from mggan_tpu_torch.device import resolve_device


class MissingSceneInputError(ValueError):
    """A scene-conditioned model was asked to predict without scene patches
    (see ``ServingModel.check_scene_input``)."""


def build_serving_fn(predictor, strategy: str):
    """``(xy, ped_mask, patches, seed, *, num, draws=None) -> pred_abs``
    (the closure ``mggan_tpu/cli/export.py::build_serving_fn`` jits)."""
    pred_func = predictor.get_predict_func(strategy)

    def serve(xy, ped_mask, patches, seed, *, num, draws=None):
        batch = {"xy": xy, "ped_mask": ped_mask, "patches": patches}
        gen = None if draws is not None else predictor.new_generator(seed)
        return pred_func(batch, gen, num=num, draws=draws)[0]

    return serve


class ServingModel:
    """call(xy (S,P,20,2) f32, ped_mask (S,P) bool, patches (S,P,33,33,4) f32,
    seed) -> pred_abs (num, S, P, 12, 2), one call per scene-count bucket.

    ``wants_scene`` records whether the model has a scene CNN. When True and
    a request carries no patches, prediction raises
    ``MissingSceneInputError`` unless ``allow_missing_scene`` (then it warns
    once).
    """

    def __init__(self, calls, scenes: int, peds: int, num: int, *,
                 strategy: str = "?", wants_scene: bool | None = None,
                 allow_missing_scene: bool = False):
        self._calls = dict(sorted(calls.items()))
        self.buckets = tuple(self._calls)
        if scenes != self.buckets[-1]:
            raise ValueError(f"scenes={scenes} must equal the largest bucket {self.buckets}")
        self.scenes = scenes
        self.peds = peds
        self.num = num
        self.strategy = strategy
        self.wants_scene = wants_scene
        self.allow_missing_scene = allow_missing_scene
        self._warned_missing = False
        self._zero_patches = np.zeros(
            (scenes, peds, PATCH_HW, PATCH_HW, PATCH_C), np.float32
        )

    @classmethod
    def from_predictor(cls, predictor, strategy: str, scenes: int, peds: int,
                       num: int, allow_missing_scene: bool = False,
                       scene_buckets=None, device="cuda") -> "ServingModel":
        """Live path over a ``Predictor``, which must sit on ``device``.

        ``scene_buckets``: ascending scene-count paddings, the largest equal
        to ``scenes``.
        """
        dev = resolve_device(device)
        if predictor.device != dev:
            raise ValueError(f"predictor is on {predictor.device}, not {dev}")
        serve = build_serving_fn(predictor, strategy)
        call = lambda xy, mask, pat, seed, draws=None: serve(
            xy, mask, pat, seed, num=num, draws=draws)
        buckets = tuple(scene_buckets) if scene_buckets else (scenes,)
        return cls({b: call for b in buckets}, scenes, peds, num,
                   strategy=strategy,
                   wants_scene=predictor.g_spec.scene_dim > 0,
                   allow_missing_scene=allow_missing_scene)

    def check_scene_input(self, have_patches: bool):
        """Raise ``MissingSceneInputError`` for a scene-conditioned model
        with no scene input (warn once when allowed or unknown)."""
        if have_patches or self.wants_scene is False:
            return
        if self.wants_scene and not self.allow_missing_scene:
            raise MissingSceneInputError(
                "this model conditions on scene patches but the request "
                "carries none — pass per-scene (p,33,33,4) patches, or opt "
                "out explicitly with allow_missing_scene=True to serve "
                "degraded zero-patch predictions"
            )
        if not self._warned_missing:
            self._warned_missing = True
            warnings.warn(
                "serving without scene patches: a scene-conditioned model "
                "will produce degraded zero-patch predictions",
                stacklevel=2,
            )

    def pad_request(self, scene_obs, patches=None):
        """Pad a request to its bucket: ``(xy, mask, patches)`` numpy arrays
        of shape ``(s,P,20,2)``, ``(s,P)`` and ``(s,P,33,33,4)``. The
        unobserved future is filled with the last observed position."""
        if len(scene_obs) > self.scenes:
            raise ValueError(f"{len(scene_obs)} scenes > largest bucket {self.scenes}")
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
        out = out.cpu().numpy()
        return [out[:, i, : np.shape(o)[0]] for i, o in enumerate(scene_obs)]

    def predict(self, obs, patches=None, seed: int = 0):
        """Single scene: (p, >=8, 2) -> (num, p, 12, 2)."""
        return self.predict_batch(
            [obs], None if patches is None else [patches], seed
        )[0]
