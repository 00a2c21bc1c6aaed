"""Standard-library HTTP inference server over a ``ServingModel``
(counterpart of ``mggan_tpu/serving/server.py``: the same endpoints, JSON
keys and error codes).

Endpoints:
    GET  /healthz      -> {"status": "ok"}
    GET  /v1/metadata  -> bucket shapes, strategy, source, wants_scene,
                          registered scene names, batch counters
    POST /v1/scenes    -> register a scene image for server-side cropping:
                          {"name": str, "image": (H,W,3) uint8 nested list,
                           "px_per_meter": float}
    POST /v1/predict   -> request {"scenes": [[[x,y] * >=8] * peds, ...],
                                   "seed": int (optional),
                                   "patches": [(p_i,33,33,4) nested lists,
                                               one per scene] (optional),
                                   "scene_ids": [registered scene name per
                                                 scene] (optional)}
                          response {"predictions": [(num, p_i, 12, 2) nested
                                    lists, one per scene]}

A scene-conditioned model (``wants_scene``) needs each predict request to
carry "patches" or "scene_ids" naming a registered scene; the server then
crops at each ped's last observed position as the eval pipeline does.
Without scene input a request gets 400, unless the model allows missing
scenes (then the response carries a "warning"). An unknown path gets 404.

Concurrent requests are micro-batched into one device call
(``runtime.py::MicroBatcher``); a request may carry several scenes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mggan_tpu_torch.config import OBS_LEN, PRED_LEN
from mggan_tpu_torch.serving.runtime import MicroBatcher, ServingModel


class _Handler(BaseHTTPRequestHandler):
    # set by make_server:
    model: ServingModel = None
    batcher: MicroBatcher = None
    quiet = True

    def log_message(self, fmt, *args):  # noqa: D102 — silence default stderr
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/v1/metadata":
            m, b = self.model, self.batcher
            self._send(200, {
                "scenes": m.scenes, "peds": m.peds, "num": m.num,
                "scene_buckets": list(m.buckets),
                "obs_len": OBS_LEN, "pred_len": PRED_LEN,
                "strategy": m.strategy, "source": m.source,
                "wants_scene": m.wants_scene,
                "allow_missing_scene": m.allow_missing_scene,
                "registered_scenes": sorted(m.scene_registry),
                "batches_run": b.batches_run,
                "requests_served": b.requests_served,
            })
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def _read_json(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length))

    def do_POST(self):  # noqa: N802
        if self.path == "/v1/scenes":
            try:
                req = self._read_json()
                self.model.register_scene(req["name"], np.asarray(req["image"], np.uint8),
                                          float(req["px_per_meter"]))
                self._send(200, {"registered": req["name"],
                                 "scenes": sorted(self.model.scene_registry)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        if self.path != "/v1/predict":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            self._send(200, self._predict(self._read_json()))
        except Exception as e:  # noqa: BLE001 — reported to the client
            self._send(400, {"error": f"{type(e).__name__}: {e}"})

    def _predict(self, req):
        scenes = req["scenes"]
        seed = int(req.get("seed", 0))
        if not isinstance(scenes, list) or not scenes:
            raise ValueError("'scenes' must be a non-empty list")
        patches_in = req.get("patches")
        scene_ids = req.get("scene_ids")
        if patches_in is not None and len(patches_in) != len(scenes):
            raise ValueError("'patches' must have one entry per scene")
        if scene_ids is not None and len(scene_ids) != len(scenes):
            raise ValueError("'scene_ids' must have one entry per scene")
        obs_list, patch_list = [], []
        for i, s in enumerate(scenes):
            obs = np.asarray(s, np.float32)
            pat = None
            if patches_in is not None and patches_in[i] is not None:
                pat = np.asarray(patches_in[i], np.float32)
            elif scene_ids is not None and scene_ids[i] is not None:
                pat = self.model.crop_patches(scene_ids[i], obs)
            # fail before queueing (400, not a failed batch)
            self.model.check_scene_input(pat is not None)
            obs_list.append(obs)
            patch_list.append(pat)
        futures = [self.batcher.submit(o, patches=p, seed=seed + i)
                   for i, (o, p) in enumerate(zip(obs_list, patch_list))]
        out = {"predictions": [f.result(timeout=120).tolist() for f in futures]}
        if any(p is None for p in patch_list) and self.model.wants_scene is not False:
            out["warning"] = ("request served without scene patches; a scene-conditioned "
                              "model produces degraded zero-patch predictions (pass "
                              "'patches' or 'scene_ids')")
        return out


class _Server(ThreadingHTTPServer):
    # a burst of concurrent clients waits in the listen queue instead of
    # having its connections dropped and retried a second later (the
    # standard library's default queue is 5)
    request_queue_size = 128


def make_server(model: ServingModel, host="127.0.0.1", port=0, max_wait_ms=5.0,
                quiet=True):
    """Build (but do not start) the server; returns ``(server, batcher)``.
    ``server.server_address[1]`` is the bound port (port=0 picks one)."""
    batcher = MicroBatcher(model, max_wait_ms=max_wait_ms)
    handler = type("Handler", (_Handler,), {"model": model, "batcher": batcher,
                                            "quiet": quiet})
    return _Server((host, port), handler), batcher


def serve_forever(model: ServingModel, host="127.0.0.1", port=8000, max_wait_ms=5.0):
    server, batcher = make_server(model, host, port, max_wait_ms, quiet=False)
    print(f"serving {model.source} [{model.strategy}] on {model.device} "
          f"(S={model.scenes}, P={model.peds}, k={model.num}, "
          f"wants_scene={model.wants_scene}) on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()


def start_background(model: ServingModel, host="127.0.0.1", port=0, max_wait_ms=5.0):
    """Serve from a daemon thread; returns ``(server, batcher, port)``. Stop
    with ``server.shutdown()``, ``server.server_close()`` and
    ``batcher.close()``."""
    server, batcher = make_server(model, host, port, max_wait_ms)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, batcher, server.server_address[1]
