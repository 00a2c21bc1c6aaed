"""The training loop: epochs, validation, checkpoint-best, schedules
(counterpart of ``mggan_tpu/training/loop.py``; reference
``MultiGeneratorGAN.train``, abstract_train.py:87-201).

The per-batch work is ``build_train_step``'s step (the kernels K1, K2 and
K3 on the card); this module is host orchestration, step for step the JAX
loop's: per epoch ``state.epoch = epoch + 1`` (the cosine learning rate
reads it), the loader pinned to the epoch, batches through a
``Prefetcher``, train-time augmentation, the step; epoch means of the
metrics (``gradnorm/*`` into a ``GradNormLogger``), validation every
``val_every`` epochs with ``checkpoint_best`` on ``val/ADE k=<top_k_test>``,
a checkpoint every ``save_every`` epochs and the l2 weight's decay.
``split_step`` trains with ``build_split_train_step`` (the fused step
behind JAX's split-step checks: the port compiles nothing to split), and
``profile_dir`` writes a ``torch.profiler`` trace of
one step into that directory: the second step of the run's first epoch,
the step the JAX loop traces, with the wait for its batch and the batch's
move to the device.

With ``dp`` / ``gp`` / ``slices`` the Trainer is one rank of a pod
(``parallel/``; launched by ``torch.distributed.run``): its device is the
rank's, the step is ``parallel/dp.py``'s, its loaders yield its data
rank's scene rows of each batch (of the node's window shard on several
nodes), the draws are the global batch's, of which it keeps its rows, and
validation sums its rows' metrics over the data ranks (``allreduce_sums``
on ``grid.host_group``), so ``best_val`` and the checkpoint branch are the
same on every rank. With ``gp > 1`` the rank holds its slice of the
generators; validation runs on them all, gathered (as JAX replicates the
parameters for it), and a checkpoint holds the gathered state, which rank
0 writes, as it writes the logs. On one node the Trainer equals the
single-device Trainer step for step. A version dir trained on N ranks
loads on one device (``load_from_path`` outside a pod), and in a pod each
rank takes its slice of it again.

Random numbers come from one source with three methods (``SeededDraws``
by default; a test injects another to replay the JAX Trainer's keys):
``aug(epoch, i, s)`` the augmentation of batch ``i`` of ``epoch``, a pure
function of (seed, epoch, i) as JAX's ``fold_in`` keys are, so a resumed
run replays an uninterrupted one; ``step(state, s, p)`` the step's draws
(``needed_draw_keys``, in ``make_draws``'s fixed order), from the
checkpointed ``state.generator``; and ``val(i,
s, p, num)`` the sampling draws of validation batch ``i``, seeded afresh
in every ``check_accuracy`` as JAX uses ``PRNGKey(0)`` there.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.data.augment import augment_batch, sample_aug_params
from mggan_tpu_torch.data.loaders import get_dataloader
from mggan_tpu_torch.data.prefetch import Prefetcher
from mggan_tpu_torch.device import host_to_device
from mggan_tpu_torch.eval.evaluate import batch_seed
from mggan_tpu_torch.eval.metrics import MetricAccumulator, allreduce_sums, batch_metric_sums
from mggan_tpu_torch.eval.predict import Predictor
from mggan_tpu_torch.models.factory import construct_gan
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.parallel import dp, pod
from mggan_tpu_torch.parallel.mesh import make_mesh
from mggan_tpu_torch.training import checkpoints as ckpt
from mggan_tpu_torch.training.state import init_train_state
from mggan_tpu_torch.training.steps import (
    batch_views, build_split_train_step, build_train_step, make_draws,
)
from mggan_tpu_torch.utils import profiling
from mggan_tpu_torch.utils.logging import ExperimentWriter, load_meta_tags
from mggan_tpu_torch.utils.trajectory_tools import GradNormLogger


def stream_seed(*keys: int) -> int:
    """A 64-bit generator seed that is a fixed function of ``keys``."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])


class SeededDraws:
    """The Trainer's own random numbers (see the module note)."""

    def __init__(self, config: Config, device):
        self.config = config
        self.device = device

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def aug(self, epoch: int, i: int, s: int):
        return sample_aug_params(self._generator(
            stream_seed(self.config.seed + 1, epoch, i)), s)

    def step(self, state, s: int, p: int):
        return make_draws(state.generator, self.config, s, p, state.g_params,
                          state.d_params)

    def val(self, i: int, s: int, p: int, num: int):
        gen = self._generator(batch_seed(0, i))
        u = torch.rand((num, s, p, self.config.num_gens), generator=gen, device=self.device)
        return {"uniforms": sampling.GUMBEL_U_MIN + u * (1.0 - sampling.GUMBEL_U_MIN),
                "z": torch.randn((num, s, 1, self.config.noise_dim), generator=gen,
                                 device=self.device)}


def check_loop_scope(config: Config):
    """Raise for ``split_step`` beside any of dp, gp and slices above 1,
    which the JAX Trainer refuses too (mggan_tpu/training/loop.py:63-66),
    and for a ``decoders`` stack that ``gp`` does not split evenly."""
    if config.split_step and max(config.dp, config.gp, config.slices) > 1:
        raise ValueError("--split_step and --dp/--gp/--slices are mutually exclusive, as in "
                         "the JAX Trainer")
    if config.experiment != "discrete" and config.num_gens % config.gp:
        raise ValueError(f"num_gens={config.num_gens} does not split over gp={config.gp} "
                         "ranks")


class Trainer:
    """The GAN trainer for every family of the train step (gan, mgan,
    infogan and probgan; the four objectives; every PM target but
    disc_scores; D gating and unrolling; the discrete generator:
    ``training/steps.py``), on ``device``. probgan's history heads ride in
    ``state.d_state`` and so in every checkpoint.

    ``draws`` replaces the random-number source (``SeededDraws``'s three
    methods); the weights are random from ``config.seed``. ``grid`` (a
    ``parallel.mesh.Grid``) overrides the one ``make_mesh`` makes from
    ``config.dp`` / ``config.slices`` and the live pod (see the module note).
    """

    def __init__(self, config: Config, writer: ExperimentWriter, device="cuda",
                 draws=None, grid=None):
        check_loop_scope(config)
        self.config = config
        self.writer = writer
        self.grid = make_mesh(config.dp, config.gp, config.slices, device) if grid is None \
            else grid
        self.device = self.grid.device
        g_pack, d_pack = construct_gan(config, seed=config.seed, device=self.device)
        self.g_spec, self.d_spec = g_pack[2], d_pack[2]
        self.state = init_train_state(config, g_pack, d_pack,
                                      seed=stream_seed(config.seed, 1))
        if self.grid.active:
            self.train_step, self.state = dp.make_parallel_train_step(
                config, self.g_spec, self.d_spec, self.grid, self.state)
        else:
            build = build_split_train_step if config.split_step else build_train_step
            self.train_step = build(config, self.g_spec, self.d_spec)
        self.draws = SeededDraws(config, self.device) if draws is None else draws
        self._predictor = None
        self._grad_logger = GradNormLogger()

    # ------------------------------------------------------------------ api
    def predictor(self) -> Predictor:
        if self._predictor is None:
            self._predictor = Predictor(self.config, self.g_spec, self.state.g_params,
                                        self.state.g_state,
                                        device=self.device).shard_to(self.grid)
        self._predictor.g_params = dp.gather_tree(self.state.g_params, self.grid)
        self._predictor.g_state = self.state.g_state
        return self._predictor

    def _device_batch(self, batch, train: bool, aug=None):
        full = augment_batch({k: v for k, v in batch.items()
                              if k not in ("scale", "window_idx")}, train,
                             device=self.device, interp=self.config.patch_interp, aug=aug)
        return {k: full[k] for k in ("xy", "ped_mask", "patches") if k in full}

    def _loader_args(self):
        """The loaders' common arguments; on a pod the rank's rows of the
        node's windows."""
        grid = self.grid
        return dict(data_root=self.config.data_root, patch_bank=bool(self.config.patch_bank),
                    device=self.device, shard_by_process=grid.nodes > 1,
                    grid=grid if grid.active else None)

    def _loaders(self):
        cfg = self.config
        common = dict(batch_size=cfg.batch_size, max_peds=cfg.max_peds or None,
                      **self._loader_args())
        return (get_dataloader(cfg.dataset, "train", augment=bool(cfg.augment),
                               shuffle=True, seed=cfg.seed, **common),
                get_dataloader(cfg.dataset, "val", **common))

    @contextlib.contextmanager
    def _traced(self, on: bool):
        """With ``on``, the block traced into ``config.profile_dir``
        (``utils/profiling.py::trace``), ended by a synchronize."""
        if not on:
            yield
            return
        with profiling.trace(self.config.profile_dir):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def train_epoch(self, loader, epoch: int, profile: bool = False):
        """One epoch of train steps over ``loader`` (pinned to ``epoch``,
        through a ``Prefetcher``, augmented when ``loader.augment``);
        ``profile`` traces the epoch's second iteration into
        ``config.profile_dir``, from the wait for its batch
        (``mggan.train.feed``) through the batch's move to the device
        (``mggan.train.device_batch``) and the step to a synchronize.

        Returns ``(metrics, perf)``: each step metric's per-step values (a
        float64 array per key), and ``steps``, ``agents`` (real,
        mask-counted) and ``seconds`` (host clock, ending in a
        synchronize).
        """
        if self.state.generator is None:
            raise ValueError("this train state was restored on another device type than "
                             "its checkpoint's, so its random stream cannot resume; it "
                             "evaluates, but does not train")
        self.state = self.state.replace(epoch=epoch + 1)
        metrics = defaultdict(list)
        t0 = time.perf_counter()
        n_steps = n_agents = 0
        loader.set_epoch(epoch)
        with Prefetcher(loader) as batches:
            batches = iter(batches)
            for i in itertools.count():
                with self._traced(profile and i == 1):
                    with profiling.span("mggan.train.feed"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    n_agents += int(np.asarray(batch["ped_mask"]).sum())
                    s, p = np.shape(batch["ped_mask"])
                    aug = None
                    if loader.augment:  # the node batch's draws, this rank's rows of them
                        flip, alpha = self.draws.aug(epoch, i, loader.batch_size)
                        rows = dp.shard_batch(self.grid, {"flip": flip, "alpha": alpha})
                        aug = (rows["flip"], rows["alpha"])
                    with profiling.span("mggan.train.device_batch"):
                        model_batch = self._device_batch(batch, train=loader.augment, aug=aug)
                    draws = self.draws.step(self.state, dp.global_rows(self.grid, s), p)
                    self.state, step_metrics = self.train_step(self.state, model_batch, draws)
                for k, v in step_metrics.items():
                    metrics[k].append(v)
                n_steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        if self.grid.active:  # every data rank counted its own rows
            n_agents = int(pod.sum_over_ranks(n_agents, self.grid.host_group))
        values = {k: torch.stack(vs).double().cpu().numpy() for k, vs in metrics.items()}
        return values, {"steps": n_steps, "agents": n_agents, "seconds": seconds}

    def train(self, until_epoch: int | None = None):
        """Run the epoch loop to ``config.epochs``.

        ``until_epoch``: stop (and checkpoint) after this epoch, a
        preemption drill: ``train(until_epoch=k)`` + ``load_from_path`` +
        ``train()`` replays the batch, augmentation and weight stream of
        one uninterrupted ``train()``.
        """
        cfg = self.config
        train_loader, val_loader = self._loaders()
        track_metric = f"val/ADE k={cfg.top_k_test}"
        start_epoch = int(self.state.epoch)
        for epoch in range(start_epoch, cfg.epochs):
            values, perf = self.train_epoch(
                train_loader, epoch, profile=bool(cfg.profile_dir) and epoch == start_epoch
                and pod.is_primary())
            dt = max(perf["seconds"], 1e-9)
            metrics = {k: list(v) for k, v in values.items()}
            metrics["perf/steps_per_sec"] = [perf["steps"] / dt]
            metrics["perf/agents_per_sec"] = [perf["agents"] / dt]
            metrics["perf/padded_agents_per_sec"] = [
                perf["steps"] * dp.global_rows(self.grid, train_loader.rows)
                * train_loader.max_peds / dt]

            if (epoch + 1) % cfg.val_every == 0:
                for k, v in self.check_accuracy(val_loader, num_k=cfg.top_k_test).items():
                    metrics[f"val/{k}"] = [v]
                cur = float(np.mean(metrics[track_metric]))
                if cur < self.state.best_val:
                    if pod.is_primary():
                        print(f"Saving best model... {track_metric}: "
                              f"{self.state.best_val} -> {cur}")
                    self.state = self.state.replace(best_val=cur)
                    self.save("checkpoint_best")

            epoch_metrics = {}
            for k, vs in metrics.items():
                vals = np.asarray(vs, dtype=np.float64)
                if k.startswith("gradnorm/"):
                    # per-module gradient norms -> histograms per epoch
                    # (reference GradNormLogger, utils.py:168-199)
                    self._grad_logger.update_scalars(k[len("gradnorm/"):], vals)
                    continue
                if np.isnan(vals).all():
                    continue  # e.g. a D step skipped all epoch
                epoch_metrics[k] = float(np.nanmean(vals))
            self._grad_logger.write(self.writer, epoch + 1)
            self.writer.log(epoch_metrics, epoch + 1)
            if (epoch + 1) % cfg.save_every == 0:
                self.save()
            # schedules (abstract_train.py:198-200): the cosine learning rate
            # is computed in the step from state.epoch; the l2 weight decays
            # here, in float32 as in JAX
            self.state = self.state.replace(l2_weight=float(
                np.float32(self.state.l2_weight) * np.float32(cfg.l2_decay_rate)))
            if until_epoch is not None and epoch + 1 >= until_epoch:
                self.save()
                break
        return self

    def check_accuracy(self, loader, num_k=20, predict_strategy="sampling"):
        """Validation metrics (train.py:245-257); on a pod each rank
        predicts its rows with its rows of the global draws, and the sums go
        through ``allreduce_sums``."""
        pred_func = self.predictor().get_predict_func(predict_strategy)
        acc = MetricAccumulator()
        for i, batch in enumerate(loader):
            model_batch = self._device_batch(batch, train=False)
            s, p = np.shape(batch["ped_mask"])
            draws = self.draws.val(i, dp.global_rows(self.grid, s), p, num_k)
            pred_abs = pred_func(model_batch, None, num=num_k, draws=draws)[0]
            bv = batch_views(model_batch)
            scale = host_to_device(batch["scale"], self.device)
            acc.update(batch_metric_sums(pred_abs, bv.gt_xy, bv.loss_mask, scale, [num_k]))
        if self.grid.active:
            acc.sums = allreduce_sums(acc.sums, self.grid.host_group)
        return acc.result()

    def test(self, num_k=20, batch_size=8, **kwargs):
        loader = get_dataloader(self.config.dataset, "test", batch_size=batch_size,
                                **self._loader_args())
        return self.check_accuracy(loader, num_k=num_k, **kwargs)

    # ---------------------------------------------------------- checkpoints
    def save(self, name=None):
        """Rank 0 writes ``name``, the gathered state (the single-device
        layout); on a pod the others wait for the file."""
        if name is None:
            name = f"checkpoint_{int(self.state.epoch)}"
        state = dp.gather_generators(self.state, self.grid)
        if pod.is_primary():
            ckpt.save_checkpoint(self.writer.checkpoint_dir, state, name)
        if self.grid.active:
            pod.barrier()

    @classmethod
    def load(cls, log_path, exp_name, version, checkpoint="best", device="cuda"):
        """Reference-signature loader (abstract_train.py:250-285)."""
        version_dir = Path(log_path) / exp_name / f"version_{version}"
        return cls.load_from_path(version_dir, checkpoint, device=device)

    @classmethod
    def load_from_path(cls, version_path, checkpoint="best", device="cuda"):
        """Rebuild a trainer from a version dir (abstract_train.py:250-296);
        returns ``(trainer, config)``. Outside a pod a dir trained on N ranks
        loads on one device; in a pod every rank reads the same file and
        keeps its slice of the generators."""
        version_path = Path(version_path)
        if "version" not in version_path.stem:
            raise ValueError(f"{version_path} is not a model version directory")
        config = Config.from_dict(load_meta_tags(version_path / "meta_tags.csv"))
        writer = ExperimentWriter(
            version_path.parent.parent.parent, version_path.parent.parent.name,
            version_path.parent.name, version=int(version_path.stem.split("_")[1]),
            config=config,
        )
        grid = None if pod.is_initialized() else make_mesh(1, 1, 1, device)
        trainer = cls(config, writer, device=device, grid=grid)
        name = ckpt.resolve_checkpoint_name(writer.checkpoint_dir, checkpoint)
        state = ckpt.restore_checkpoint(writer.checkpoint_dir, trainer.state, name)
        trainer.state = dp.shard_generators(state, trainer.grid)
        return trainer, config
