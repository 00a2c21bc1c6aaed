"""The train runner: ``Trainer.train_epoch`` back to back over a shuffled,
augmented loader with the device patch bank, as a trainer runs it.

Set-up makes the weights and the scenes from the seed, builds the trainer
once and runs its first epoch through the same call and feed as the
window, keeping the state after the first step and after the last one the
reference follows; the window then runs whole epochs until ``--seconds``
have passed, and ends on the synchronize that closes an epoch. After the
window the reference follows those first steps from the same weights,
batches and draws, and the numbers it gives are compared with the
program's.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from portbench.harness import program, scenes
from portbench.harness.flops import batch_sizes, train_step_flops
from portbench.reference import mggan as ref

LOSSES = ("train/discr_loss", "train/info_mgan_disc_loss", "train/L2_loss", "train/gen_loss",
          "train/info_mgan_loss", "train/net_chooser_loss")
# A leaf whose reference gradient is below this share of the median leaf's
# is moved by round-off alone (a bias ahead of a batch norm)
ROUNDOFF_SHARE = 1e-3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def scheduled_lr(base: float, epoch: int, epochs: int) -> float:
    """Cosine annealing stepped at each epoch's end; ``epoch`` is 1-based."""
    return base * 0.5 * (1.0 + math.cos(math.pi * (epoch - 1) / epochs))


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.traffic = cell.cfg, cell.traffic

    # ----------------------------------------------------------- set-up
    def setup(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.g_sd, self.d_sd = ref.make_weights(
            cfg, torch.Generator(device=dev).manual_seed(scenes.sub_seed(self.seed, 1)))
        gen = torch.Generator(device=dev).manual_seed(scenes.sub_seed(self.seed, 2))
        n, p = tr["scenes"], tr["max_peds"]
        sizes = scenes.scene_sizes(tr, n, gen)
        xy, _, scene = scenes.tracks(tr, sizes, gen)
        big = scenes.big_patches(n, p, sizes, gen)
        self.sizes = sizes.cpu().numpy()
        self.xy, self.scene = xy.cpu().numpy(), scene.cpu().numpy()
        self.big = big.cpu().numpy()
        del big
        self.agents_per_epoch = int(self.sizes.sum())
        self.cfg_obj = program.config(cfg)
        g = program.load_generator(self.cfg_obj, program.host_state_dict(self.g_sd), dev)
        d = program.load_discriminator(self.cfg_obj, program.host_state_dict(self.d_sd), dev)
        ds = program.scene_dataset(tr, self.xy, self.sizes, self.scene, self.big)
        self.loader_seed = scenes.sub_seed(self.seed, 4) % (2**31 - 1)
        self.loader = program.train_loader(tr, ds, self.loader_seed, dev)
        self.draws = program.Draws(cfg, dev, scenes.sub_seed(self.seed, 3),
                                   keep=tr["compare_steps"])
        self.trainer = program.trainer(self.cfg_obj, g, d, self.draws, dev,
                                       scenes.sub_seed(self.seed, 5))
        self._first_epoch()

    def _first_epoch(self):
        """Epoch 0 through the window's own call, keeping what the
        reference is compared on."""
        tr, last = self.trainer, self.traffic["compare_steps"]
        self.kept = {"g0": _clone(tr.state.g_params), "d0": _clone(tr.state.d_params)}
        step = tr.train_step

        def keeping(state, batch, draws):
            state, metrics = step(state, batch, draws)
            if state.step == 1:
                self.kept["mu_g"] = _clone(state.g_opt.mu)
                self.kept["mu_d"] = _clone(state.d_opt.mu)
            if state.step == last:
                self.kept["g"] = _clone(state.g_params)
                self.kept["d"] = _clone(state.d_params)
            return state, metrics

        tr.train_step = keeping
        values, _ = tr.train_epoch(self.loader, 0)
        tr.train_step = step
        self.first_losses = [{k: float(values[k][i]) for k in LOSSES} for i in range(last)]

    # ----------------------------------------------------------- window
    def window(self, seconds: float, tracer=None):
        tr = self.trainer
        step = tr.train_step
        if tracer is not None:
            tr.train_step = tracer.wrap(step)
        epoch, epochs, fed, steps, finite = 1, 0, 0, 0, True
        t0 = time.perf_counter()
        while True:
            values, perf = tr.train_epoch(self.loader, epoch)
            epoch, epochs = epoch + 1, epochs + 1
            fed, steps = fed + perf["agents"], steps + perf["steps"]
            finite &= all(np.isfinite(values[k]).all() for k in LOSSES)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        tr.train_step = step
        agents = epochs * self.agents_per_epoch
        self.window_counts = {"steps": steps, "agents": agents, "fed": fed, "finite": finite}
        return {"train_agents_per_s": {"value": agents / window_s, "unit": "agents/s"}}, steps

    def attempted_failed(self):
        return self.window_counts["steps"], 0 if self.window_counts["finite"] else 1

    def free(self):
        del self.trainer, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------- the trace
    def trace_units(self, tracer) -> list:
        """``(agents, pairs)`` of each traced step's batch."""
        return [batch_sizes(args[1]["ped_mask"].sum(1).tolist()) for args in tracer.args]

    def trace_flops(self, units) -> int:
        return sum(train_step_flops(self.cfg, a, q) for a, q in units)

    # ------------------------------------------------------ correctness
    def correctness(self) -> tuple[dict, int]:
        """The compared gaps of the first steps, with the agents the
        program counted against the scenes' own; no answer is judged
        apart."""
        numbers = gaps(self.program_side(), self.reference())
        numbers["agents_gap"] = self.agents_gap()
        return numbers, 0

    def readings(self, seconds: float, control: bool) -> dict:
        """For the calibration, after set-up (which has run the compared
        steps): the program's numbers and, with ``control``, the control's
        and those of the planted fault of half of every batch left out."""
        self.free()
        want = self.reference()
        got = self.program_side()
        out = {"program": gaps(got, want), "program_worst": worst_readings(got, want)}
        if control:
            ctl = self.reference(control=True)
            out["control"] = gaps(ctl, want)
            out["control_worst"] = worst_readings(ctl, want)
            out["half_batch"] = gaps(self.reference(half=True), want)
        return out

    def reference(self, control: bool = False, half: bool = False):
        """The reference's losses of the first steps, its optimizers'
        first moments after step 1 and each weight's move by the last.
        ``control`` computes it in bfloat16 (the control); ``half`` leaves
        the second half of every batch's scenes out (a planted fault)."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        b, p, last = tr["batch_scenes"], tr["max_peds"], tr["compare_steps"]
        lr = lambda base: scheduled_lr(base, 1, cfg["epochs"])  # noqa: E731
        order = ref.epoch_order(len(self.sizes), self.loader_seed, 0)
        ppm = tr["px_per_meter"]
        wh = torch.tensor([(w / ppm, h / ppm) for h, w in scenes.scene_extent_px(tr)],
                          dtype=torch.float32, device=dev)
        out = {"losses": []}
        with ref.precision(control, dev.type):
            step = ref.TrainStep(cfg, self.g_sd, self.d_sd, lr(cfg["g_lr"]), lr(cfg["d_lr"]))
            for i in range(last):
                idx = order[i * b:(i + 1) * b]
                xy = torch.from_numpy(self.xy[idx]).to(dev)
                mask = torch.arange(p, device=dev)[None] < torch.from_numpy(
                    self.sizes[idx]).to(dev)[:, None]
                if half:
                    mask[b // 2:] = False
                big = torch.from_numpy(self.big[idx]).to(dev)
                flip, alpha = self.draws.kept_aug[i]
                xy = ref.augment_xy(xy, wh[torch.from_numpy(self.scene[idx]).to(dev)], flip,
                                    alpha.float())
                patches = ref.augment_patches(big, flip, alpha.float())
                out["losses"].append(step(xy, mask, patches, self.draws.kept_steps[i]))
                if i == 0:
                    out["mu_g"] = _clone(step.opt_g.mu)
                    out["mu_d"] = _clone(step.opt_d.mu)
        out["move_g"] = {k: v - self.g_sd[k] for k, v in step.g.items()}
        out["move_d"] = {k: v - self.d_sd[k] for k, v in step.d.items()}
        return out

    def program_side(self) -> dict:
        """The program's first steps in the reference's terms: its losses,
        its optimizers' first moments after step 1 and each weight's move
        by the last compared step, by reference key."""
        kept, out = self.kept, {"losses": self.first_losses}
        for side, sd in (("g", self.g_sd), ("d", self.d_sd)):
            keys = list(ref.trainable(sd))
            out[f"mu_{side}"] = {k: program.program_leaf(kept[f"mu_{side}"], k) for k in keys}
            out[f"move_{side}"] = {k: program.program_leaf(kept[side], k)
                                   - program.program_leaf(kept[f"{side}0"], k) for k in keys}
        return out

    def agents_gap(self) -> float:
        """Real agents the program counted in the window's batches against
        the scenes' own count."""
        return float(abs(self.window_counts["fed"] - self.window_counts["agents"]))


def leaf_detail(got: dict, want: dict) -> dict:
    """For a look at the readings: each tree's worst leaf and the median
    leaf's gap, of the first moment and of the move."""
    out = {}
    for side in ("g", "d"):
        first = {k: _norm(v) for k, v in want[f"mu_{side}"].items()}
        med = statistics.median(first.values())
        keys = [k for k, v in first.items() if v >= ROUNDOFF_SHARE * med]
        for what in ("mu", "move"):
            w = {k: _norm(want[f"{what}_{side}"][k]) for k in keys}
            g = {k: _norm(got[f"{what}_{side}"][k]) for k in keys}
            m = statistics.median(w.values())
            each = {k: abs(g[k] - w[k]) / max(w[k], m) for k in keys}
            worst = max(each, key=each.get)
            out[f"{what}_{side}"] = {"worst": worst, "worst_gap": each[worst],
                                     "median_gap": statistics.median(each.values())}
    return out


def gaps(got: dict, want: dict) -> dict:
    """The compared gaps between two runs of the first steps, in the
    reference's terms. ``loss_gap``: the first step's worst loss, relative.
    ``grad_gap``: the median leaf's gap between the norms of the first
    moment after step 1 (the first gradient as the optimizer holds it).
    ``change_gap``: the worst leaf's gap between the norms of each weight's
    move by the last compared step. Leaf gaps are over the larger of the
    reference's norm of the leaf and of the median leaf; leaves whose
    reference gradient is round-off are left out. The first gradient is
    taken by the median leaf and the loss at the first step because a few
    small leaves of the discriminator's track encoder and attention, and
    the later steps' losses, move with the ~1e-6 rounding of the fake
    futures on some seeds (PERF.md, section 6)."""
    loss_gap = max(abs(got["losses"][0][k] - want["losses"][0][k])
                   / max(abs(want["losses"][0][k]), 1e-30) for k in LOSSES)
    detail = leaf_detail(got, want)
    return {"loss_gap": loss_gap,
            "grad_gap": max(detail[f"mu_{s}"]["median_gap"] for s in ("g", "d")),
            "change_gap": max(detail[f"move_{s}"]["worst_gap"] for s in ("g", "d"))}


def worst_readings(got: dict, want: dict) -> dict:
    """The worst loss over every compared step and the worst leaf's first
    moment: read by the calibration, not compared."""
    detail = leaf_detail(got, want)
    return {"loss_all_steps": max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                                  for g, w in zip(got["losses"], want["losses"])
                                  for k in LOSSES),
            "grad_worst_leaf": max(detail[f"mu_{s}"]["worst_gap"] for s in ("g", "d"))}
