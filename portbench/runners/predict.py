"""The sampling runner: ``Predictor.predict`` (PM-net categorical sampling
of ``num`` futures each agent) from one client, calls back to back, over a
few distinct batches made on the device at set-up.

Each call is timed from its dispatch to a synchronize on its outputs. Two
calls' answers are kept and judged once the window has closed: one drawn
from the seed among the first calls, and the window's last. The
reference recomputes the probabilities of the generators, scores the
program's choice of generator for each (sample, agent) against the best
under the same Gumbel draws, and rolls out each sample's chosen generator
from the same weights and inputs.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import program, scenes
from portbench.harness.flops import batch_sizes, predict_flops
from portbench.reference import mggan as ref

_worst = lambda rows: {k: max(r[k] for r in rows) for k in rows[0]}  # noqa: E731


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.cfg, cell.traffic

    def setup(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.g_sd, _ = ref.make_weights(
            cfg, torch.Generator(device=dev).manual_seed(scenes.sub_seed(self.seed, 1)))
        gen = torch.Generator(device=dev).manual_seed(scenes.sub_seed(self.seed, 2))
        s, p, num, g = tr["scenes"], tr["max_peds"], tr["num"], cfg["num_gens"]
        self.batches, self.draws, self.sizes = [], [], []
        for _ in range(tr["distinct_batches"]):
            sizes = scenes.scene_sizes(tr, s, gen)
            xy, mask, _ = scenes.tracks(tr, sizes, gen)
            self.batches.append({"xy": xy, "ped_mask": mask,
                                 "patches": scenes.model_patches(s, p, gen)})
            u = torch.rand((num, s, p, g), generator=gen, device=dev)
            self.draws.append({"uniforms": ref.GUMBEL_U_MIN + u * (1.0 - ref.GUMBEL_U_MIN),
                               "z": torch.randn((num, s, 1, cfg["noise_dim"]), generator=gen,
                                                device=dev)})
            self.sizes.append(sizes.cpu().numpy())
        self.agents = [int(x.sum()) for x in self.sizes]
        pick = np.random.default_rng(scenes.sub_seed(self.seed, 6))
        self.kept_call = int(pick.integers(0, 2 * len(self.batches)))
        self.cfg_obj = program.config(cfg)
        g = program.load_generator(self.cfg_obj, program.host_state_dict(self.g_sd), dev)
        self.predictor = program.predictor(self.cfg_obj, g, dev)
        for b in range(min(2, len(self.batches))):  # every shape the window uses
            self._call(b)

    def _call(self, b: int):
        out = self.predictor.predict(self.batches[b], num=self.traffic["num"],
                                     draws=self.draws[b])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def window(self, seconds: float, tracer=None):
        call = tracer.wrap(self._call) if tracer is not None else self._call
        lat, agents, self.kept = [], 0, {}
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            b = i % len(self.batches)
            t = time.perf_counter()
            out = call(b)
            lat.append(time.perf_counter() - t)
            agents += self.agents[b]
            if i == self.kept_call:
                self.kept["first"] = (b, out)
            self.kept["last"] = (b, out)
            i += 1
        window_s = time.perf_counter() - t0
        self.calls = i
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        return {"predict_agents_per_s": {"value": agents / window_s, "unit": "agents/s"},
                "predict_p95_ms": {"value": p95, "unit": "ms"}}, i

    def attempted_failed(self):
        return self.calls, 0

    def free(self):
        del self.predictor
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def trace_units(self, tracer) -> list:
        return [batch_sizes(self.sizes[args[0]]) for args in tracer.args]

    def trace_flops(self, units) -> int:
        return sum(predict_flops(self.cfg, a, q, self.traffic["num"]) for a, q in units)

    # ------------------------------------------------------ correctness
    def judged(self) -> list:
        """The kept calls: ``(batch, program outputs)``."""
        return [self.kept[k] for k in ("first", "last") if k in self.kept]

    def correctness(self) -> tuple[dict, int]:
        """The worst of each number over the judged calls, and how many of
        those calls had a number over its limit."""
        rows = [self.gaps(b, out) for b, out in self.judged()]
        limits = self.cell.limits
        failed = sum(any(not v <= limits[k] for k, v in r.items()) for r in rows)
        return _worst(rows), failed

    def readings(self, seconds: float, control: bool) -> dict:
        """For the calibration, after set-up: the program's numbers over a
        short window's judged calls and, with ``control``, the control's on
        the same batches."""
        self.window(seconds)
        kept = self.judged()
        self.free()
        out = {"program": _worst([self.gaps(b, o) for b, o in kept])}
        if control:
            out["control"] = _worst([self.gaps(b, self.control_outputs(b)) for b, _ in kept])
        return out

    def gaps(self, b: int, out) -> dict:
        """The gaps of one call's answers ``out = (abs, rel, probs, choice)``
        against the reference, over the real agents."""
        pred_abs, _, probs, choice = out
        batch, draws, num = self.batches[b], self.draws[b], self.traffic["num"]
        with torch.no_grad(), ref.precision(False, self.device.type):
            v = ref.views(batch["xy"], batch["ped_mask"])
            enc, social = ref.g_encode_eval(self.g_sd, v, batch["patches"])
            logits = ref.pm_logits(self.g_sd, enc)
            scores = ref.gumbel_scores(logits, draws["uniforms"])  # (K, S, P, G)
            chosen = choice.long().permute(2, 0, 1)  # (K, S, P)
            picked = torch.gather(scores, -1, chosen[..., None])[..., 0]
            real = batch["ped_mask"][None]
            choice_gap = float(((scores.max(-1).values - picked) * real).max())
            probs_gap = float(((probs - torch.softmax(logits, -1)).abs()
                               * batch["ped_mask"][..., None]).max())
            h0 = ref.decoder_h0(self.g_sd, enc, draws["z"])
            want, _ = ref.decode_chosen(self.g_sd, v, social, h0, chosen,
                                        self.cfg["num_gens"])
            traj = ((pred_abs - want).abs().amax((-1, -2)) * real).max()
        return {"choice_gap": choice_gap, "probs_gap": probs_gap, "traj_gap": float(traj)}

    def control_outputs(self, b: int):
        """The control: the reference itself, in bfloat16, in the program's
        place: its own choices and rollouts for batch ``b``."""
        batch, draws = self.batches[b], self.draws[b]
        with torch.no_grad(), ref.precision(True, self.device.type):
            v = ref.views(batch["xy"], batch["ped_mask"])
            enc, social = ref.g_encode_eval(self.g_sd, v, batch["patches"])
            logits = ref.pm_logits(self.g_sd, enc)
            chosen = ref.gumbel_choice(logits, draws["uniforms"])
            h0 = ref.decoder_h0(self.g_sd, enc, draws["z"])
            pred_abs, pred_rel = ref.decode_chosen(self.g_sd, v, social, h0, chosen,
                                                   self.cfg["num_gens"])
        return pred_abs, pred_rel, torch.softmax(logits, -1), chosen.permute(1, 2, 0)
