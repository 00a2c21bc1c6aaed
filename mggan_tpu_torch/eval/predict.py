"""The seven inference strategies (counterpart of
``mggan_tpu/eval/predict.py``; reference train.py:259-576).

Everything but the random draws runs on the predictor's device: the
decode (the rollout kernels K1 and K2, or their plain versions on the CPU),
the deterministic slot allocation of ``expected`` / ``uniform_expected`` /
``smart_expected`` (torch twins of the reference's per-agent loops, held
to the JAX package's numpy oracles by the tests), and the (occurrence,
generator) sample gather.

Strategy map (train.py:553-576):
    sampling          -> PM-categorical sampling (fused-selection decode, K1)
    expected          -> proportional allocation + ranked filler
    uniform_expected  -> round-robin over gens with prob > 0
    smart_expected    -> round-robin over gens with prob > 1/G
    smart_sampling    -> uniform categorical over gens with prob > 1/G^2
    uniform_sampling  -> uniform categorical over all gens
    rejection         -> single-gen Jacobian-norm rejection (arXiv:2006.04596)
All but ``sampling`` decode every generator (K2).

Random numbers come from a ``torch.Generator`` or are injected, one dict
per family of strategies that shares them in the JAX package
(``make_draws`` gives the shapes):
    "expected"  ``z (num,S,1,z)``: expected, uniform_expected, smart_expected
    "sampling"  ``z (num,S,1,z)``, ``uniforms (num,S,P,G)``: sampling,
                smart_sampling, uniform_sampling
    "rejection" ``z (total,S,1,z)``, ``eps (n_estimate,total,S,P,z)``
                (standard normals; the perturbation is ``eps * sigma**2``)

``compute_dtype=torch.bfloat16`` is the JAX package's bf16 mode: the scene
CNN's folded-BN conv stack and the rollout kernels in bf16, with the TPU
kernels' numerics (``ops/kernels/decoder.py``).

``shard_to(grid)`` makes a predictor one data-parallel rank's (JAX's
``shard_to``, where GSPMD splits the batch over the mesh): it takes this
rank's scene rows of the batch (``parallel/dp.py::shard_batch``) and the
global batch's draws, keeps its rows of them (``parallel/dp.py::own_rows``
along ``DRAW_SCENE_AXIS``), and returns its rows' predictions; the metric sums then go through
``eval/metrics.py::allreduce_sums``. Its parameters are whole: under
generator parallelism the caller hands it the gathered generators
(``parallel/dp.py::gather_tree``), as JAX replicates them for prediction.
"""

from __future__ import annotations

import functools
from math import ceil

import numpy as np
import torch

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.models import generator as G_mod
from mggan_tpu_torch.models.factory import tree_to
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.parallel import dp
from mggan_tpu_torch.training.steps import batch_views
from mggan_tpu_torch.utils.profiling import span

STRATEGIES = (
    "uniform_expected",
    "sampling",
    "expected",
    "rejection",
    "smart_expected",
    "smart_sampling",
    "uniform_sampling",
)
EXPECTED_FAMILY = ("expected", "uniform_expected", "smart_expected")
# The scene axis of each draw of a family (``Predictor.make_draws``)
DRAW_SCENE_AXIS = {"z": 1, "uniforms": 1, "eps": 2}
SAMPLING_FAMILY = ("smart_sampling", "uniform_sampling")


def _as_tensor(x, device):
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


def gather_by_occurrence(decoded, gen_idxs):
    """``out[j] = decoded[occurrence_j, gen_j]`` per agent.

    decoded: (K, G, S, P, T, 2) with K above every occurrence count;
    gen_idxs: (S, P, num) -> out (num, S, P, T, 2). The reference's
    ``sample_idxs + offsets * num_gens`` flat gather (train.py:339-349).
    """
    k, g, s, p, t, _ = decoded.shape
    occ = sampling.selection_indices(gen_idxs)
    flat_idx = (occ * g + gen_idxs).long()  # (S,P,num) into sample-major (K*G)
    dec = decoded.reshape(k * g, s, p, t, 2).movedim(0, 2)  # (S,P,KG,T,2)
    out = torch.take_along_dim(dec, flat_idx[..., None, None], dim=2)
    return out.movedim(2, 0)


def rejection_total(num: int, truncation_ratio: float) -> int:
    """Candidates ``predict_rejection`` decodes to keep ``num``."""
    return num + ceil((1 - truncation_ratio) * num)


def rejection_jac(base, pert, sigma):
    """The Jacobian-norm estimate per candidate: ``||pert - base||^2 /
    sigma^2`` averaged over the perturbations. base (total,S,P,T,2), pert
    (N,total,S,P,T,2) -> (S,P,total)."""
    sq = ((pert - base[None]) ** 2).sum((-1, -2)) / sigma**2  # (N,total,S,P)
    return sq.mean(0).movedim(0, -1)


def rejection_pick(abs_all, rel_all, jac, num: int):
    """Keep each agent's ``num`` candidates of smallest ``jac`` (stable
    order, as ``jnp.argsort``): abs/rel (total,1,S,P,T,2) -> (num,S,P,T,2)
    twice and int32 zeros (S,P,num) for the generator ids."""
    order = torch.argsort(jac, dim=-1, stable=True)[..., :num]  # (S,P,num)
    pick = lambda x: torch.take_along_dim(
        x[:, 0].movedim(0, 2), order[..., None, None], dim=2).movedim(2, 0)
    gen_idxs = torch.zeros(order.shape, dtype=torch.int32, device=order.device)
    return pick(abs_all), pick(rel_all), gen_idxs


class Predictor:
    """Inference over a generator's ``(params, state)`` on one device."""

    def __init__(self, config: Config, g_spec, g_params, g_state, device="cuda",
                 compute_dtype=None):
        self.device = resolve_device(device)
        self.config = config
        self.g_spec = g_spec
        self.g_params = tree_to(g_params, self.device)
        self.g_state = tree_to(g_state, self.device)
        self.compute_dtype = compute_dtype
        self.grid = None

    def shard_to(self, grid):
        """Predict one data-parallel rank's scene rows (see the module note)."""
        self.grid = grid if grid is not None and grid.active else None
        return self

    def new_generator(self, seed: int) -> torch.Generator:
        """A generator on this predictor's device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def make_draws(self, generator: torch.Generator, strategies, s: int, p: int,
                   num=20, n_estimate=10, truncation_ratio=0.7):
        """Every random number ``predict_multi(strategies)`` uses, per family
        (see the module note), drawn from ``generator`` in the order
        expected, sampling, rejection."""
        gen, dev = generator, generator.device
        zd, g = self.config.noise_dim, self.config.num_gens
        normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        draws = {}
        if any(x in EXPECTED_FAMILY for x in strategies):
            draws["expected"] = {"z": normal(num, s, 1, zd)}
        if any(x in SAMPLING_FAMILY + ("sampling",) for x in strategies):
            r = torch.rand((num, s, p, g), generator=gen, device=dev)
            draws["sampling"] = {
                "z": normal(num, s, 1, zd),
                "uniforms": sampling.GUMBEL_U_MIN + r * (1.0 - sampling.GUMBEL_U_MIN),
            }
        if "rejection" in strategies:
            total = rejection_total(num, truncation_ratio)
            draws["rejection"] = {"z": normal(total, s, 1, zd),
                                  "eps": normal(n_estimate, total, s, p, zd)}
        return draws

    # ------------------------------------------------------------- helpers
    def _inputs(self, batch, draws):
        with span("mggan.inputs"):
            draws = {} if draws is None else {k: _as_tensor(v, self.device)
                                              for k, v in draws.items()}
            batch = {k: _as_tensor(v, self.device) for k, v in batch.items()
                     if v is not None}
            if self.grid is not None:
                if not draws:
                    raise ValueError("a sharded predictor takes the global batch's draws")
                draws = dp.own_rows(self.grid, draws, batch["ped_mask"].shape[0],
                                    DRAW_SCENE_AXIS)
            return batch_views(batch), draws

    def _encode(self, bv):
        enc_h, social_feats, _ = G_mod.encode(
            self.g_params, self.g_state, self.g_spec, bv.in_xy, bv.in_dxdy,
            bv.ped_mask, bv.patches, compute_dtype=self.compute_dtype,
        )
        return enc_h, social_feats, G_mod.pm_logits(self.g_params, self.g_spec, enc_h)

    def _decode_all(self, bv, enc_h, social_feats, noise):
        return G_mod.decode_all(
            self.g_params, self.g_spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1],
            enc_h, social_feats, noise, self.compute_dtype,
        )

    def _noise(self, bv, num, generator, z):
        s, p = bv.ped_mask.shape
        return sampling.global_noise(num, s, p, self.config.noise_dim,
                                     generator=generator, z=z)

    def _run(self, batch, num, generator, draws):
        """One decode-all pass: ``(abs_all, rel_all (num,G,S,P,T,2), probs
        (S,P,G))``, its noise from ``draws["z"]`` or ``generator``."""
        if generator is None and draws is None:
            raise ValueError("a strategy needs a torch.Generator or injected draws")
        bv, draws = self._inputs(batch, draws)
        enc_h, social_feats, logits = self._encode(bv)
        out = self._decode_all(bv, enc_h, social_feats,
                               self._noise(bv, num, generator, draws.get("z")))
        return out.abs, out.rel, torch.softmax(logits, -1)

    @staticmethod
    def _gather(abs_all, rel_all, gen_idxs):
        return (gather_by_occurrence(abs_all, gen_idxs),
                gather_by_occurrence(rel_all, gen_idxs))

    def _select_expected(self, run, num):
        abs_all, rel_all, probs = run
        s, p, g = probs.shape
        gen_idxs = expected_selection_torch(probs.reshape(-1, g), num).reshape(s, p, num)
        return (*self._gather(abs_all, rel_all, gen_idxs), probs, gen_idxs)

    def _select_uniform(self, run, num, eps):
        abs_all, rel_all, probs = run
        s, p, g = probs.shape
        gen_idxs = uniform_selection_torch(probs.reshape(-1, g), num, eps).reshape(s, p, num)
        return (*self._gather(abs_all, rel_all, gen_idxs), probs, gen_idxs)

    def _select_smart_sampling(self, run, num, eps, generator, uniforms):
        abs_all, rel_all, probs = run
        over = probs > eps
        over = torch.where(~over.any(-1, keepdim=True), True, over)
        logits_u = torch.where(over, 0.0, -1e9)
        uniforms = dp.own_rows(self.grid, {"uniforms": _as_tensor(uniforms, self.device)},
                               probs.shape[0], DRAW_SCENE_AXIS)["uniforms"]
        gen_idxs = sampling.categorical(logits_u, num, generator=generator,
                                        uniforms=uniforms)
        return (*self._gather(abs_all, rel_all, gen_idxs), probs, gen_idxs)

    # ---------------------------------------------------------- strategies
    @torch.inference_mode()
    def predict(self, batch, generator: torch.Generator | None = None, num=20,
                draws=None):
        """PM-net categorical sampling (train.py:259-289).

        ``batch``: dict with ``xy (S,P,20,2)``, ``ped_mask (S,P)`` and
        optional ``patches (S,P,33,33,4)``, as tensors or numpy arrays.
        Random numbers come from ``generator`` or, when ``draws`` is given,
        from ``draws["uniforms"] (num,S,P,G)`` (Gumbel uniforms) and
        ``draws["z"] (num,S,1,noise_dim)`` (per-scene noise).

        Returns ``(pred_abs, pred_rel, probs, gen_idxs)``: ``(num,S,P,12,2)``
        twice, ``(S,P,G)`` and int32 ``(S,P,num)``.
        """
        if generator is None and draws is None:
            raise ValueError("predict needs a torch.Generator or injected draws")
        with span("mggan.predict"):
            bv, draws = self._inputs(batch, draws)
            enc_h, social_feats, logits = self._encode(bv)
            with span("mggan.pm"):
                gen_idxs = sampling.categorical(logits, num, generator=generator,
                                                uniforms=draws.get("uniforms"))
            with span("mggan.decoder_h0"):  # the decoder's start: noise, last step
                noise = self._noise(bv, num, generator, draws.get("z"))
                last_xy, last_dxdy = bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1]
            out = G_mod.decode_select(
                self.g_params, self.g_spec, last_xy, last_dxdy,
                enc_h, social_feats, noise, gen_idxs, self.compute_dtype,
            )
            with span("mggan.pm"):
                probs = torch.softmax(logits, -1)
            return out.abs, out.rel, probs, gen_idxs

    @torch.inference_mode()
    def predict_expected(self, batch, generator=None, num=20, draws=None):
        """Deterministic proportional allocation (train.py:291-351)."""
        return self._select_expected(self._run(batch, num, generator, draws), num)

    @torch.inference_mode()
    def predict_uniform(self, batch, generator=None, num=20, eps=0.0, draws=None):
        """Threshold + descending-prob round robin (train.py:353-412)."""
        return self._select_uniform(self._run(batch, num, generator, draws), num, eps)

    @torch.inference_mode()
    def predict_smart_sampling(self, batch, generator=None, num=20, eps=0.0,
                               draws=None):
        """Uniform categorical over gens above threshold (train.py:414-465);
        the noise is drawn before the categorical uniforms."""
        run = self._run(batch, num, generator, draws)
        uniforms = None if draws is None else draws["uniforms"]
        return self._select_smart_sampling(run, num, eps, generator, uniforms)

    @torch.inference_mode()
    def predict_multi(self, batch, generator, strategies, num=20, draws=None):
        """Run several strategies over one batch, sharing decode passes.

        The decode-all output depends only on (batch, noise, num), so the
        strategies of one draws family share one pass: expected /
        uniform_expected / smart_expected share one, smart_sampling /
        uniform_sampling another, as in the JAX package. ``draws`` (per
        family, see the module note) or ``generator`` supply the random
        numbers; with a generator they are drawn first (``make_draws``).

        Returns ``{strategy: (out_abs, out_rel, probs, gen_idxs)}``.
        """
        unknown = [s for s in strategies if s not in STRATEGIES]
        if unknown:
            raise ValueError(f"unknown strategies {unknown}")
        if draws is None:
            if generator is None:
                raise ValueError("predict_multi needs a torch.Generator or injected draws")
            s, p = np.shape(batch["ped_mask"])
            draws = self.make_draws(generator, strategies, dp.global_rows(self.grid, s), p,
                                    num)
        n = self.config.num_gens
        out = {}
        exp_fam = [s for s in strategies if s in EXPECTED_FAMILY]
        if exp_fam:
            run = self._run(batch, num, None, draws["expected"])
            for s in exp_fam:
                if s == "expected":
                    out[s] = self._select_expected(run, num)
                else:
                    eps = 0.0 if s == "uniform_expected" else 1.0 / n
                    out[s] = self._select_uniform(run, num, eps)
        samp_fam = [s for s in strategies if s in SAMPLING_FAMILY]
        if samp_fam:
            run = self._run(batch, num, None, draws["sampling"])
            for s in samp_fam:
                eps = 0.0 if s == "uniform_sampling" else 1.0 / n**2
                out[s] = self._select_smart_sampling(run, num, eps, None,
                                                     draws["sampling"]["uniforms"])
        if "sampling" in strategies:
            out["sampling"] = self.predict(batch, None, num, draws=draws["sampling"])
        if "rejection" in strategies:
            out["rejection"] = self.predict_rejection(batch, None, num,
                                                      draws=draws["rejection"])
        return out

    @torch.inference_mode()
    def rejection_decodes(self, batch, generator=None, num=20, sigma=1e-3,
                          n_estimate=10, truncation_ratio=0.7, draws=None):
        """The two decodes of ``predict_rejection``: every candidate's
        rollout and, in one more decode-all pass, each candidate under
        ``n_estimate`` noise perturbations of scale ``sigma**2``. Returns
        ``{"abs", "rel" (total,1,S,P,T,2), "probs", "base" (total,S,P,T,2),
        "pert" (n_estimate,total,S,P,T,2)}``."""
        if self.config.num_gens != 1:
            raise ValueError("rejection is only implemented for a single generator")
        if not 0.0 < truncation_ratio <= 1.0:
            raise ValueError(f"truncation_ratio {truncation_ratio} not in (0, 1]")
        if generator is None and draws is None:
            raise ValueError("rejection needs a torch.Generator or injected draws")
        total = rejection_total(num, truncation_ratio)
        bv, draws = self._inputs(batch, draws)
        enc_h, social_feats, logits = self._encode(bv)
        noise = self._noise(bv, total, generator, draws.get("z"))
        out = self._decode_all(bv, enc_h, social_feats, noise)
        eps = draws.get("eps")
        if eps is None:
            eps = torch.randn((n_estimate,) + tuple(noise.shape), generator=generator,
                              device=self.device)
        # all perturbations in one decode pass (the reference loops them)
        pert_noise = (noise[None] + eps * sigma**2).reshape((-1,) + tuple(noise.shape[1:]))
        pert = self._decode_all(bv, enc_h, social_feats, pert_noise).abs[:, 0]
        return {"abs": out.abs, "rel": out.rel, "probs": torch.softmax(logits, -1),
                "base": out.abs[:, 0],
                "pert": pert.reshape((n_estimate, total) + tuple(pert.shape[1:]))}

    @torch.inference_mode()
    def predict_rejection(self, batch, generator=None, num=20, sigma=1e-3,
                          n_estimate=10, truncation_ratio=0.7, draws=None):
        """Jacobian-Frobenius-norm rejection for single-generator models
        ("no GAN's land", train.py:467-551): decode ``rejection_total``
        candidates and keep the ``num`` whose rollouts move least under a
        small perturbation of their noise."""
        d = self.rejection_decodes(batch, generator, num, sigma, n_estimate,
                                   truncation_ratio, draws)
        jac = rejection_jac(d["base"], d["pert"], sigma)
        out_abs, out_rel, gen_idxs = rejection_pick(d["abs"], d["rel"], jac, num)
        return out_abs, out_rel, d["probs"], gen_idxs

    def get_predict_func(self, strategy: str):
        """Dispatch incl. eps defaults (train.py:553-576); every function
        takes ``(batch, generator, num=..., draws=...)``."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        n = self.config.num_gens
        return {
            "expected": self.predict_expected,
            "rejection": self.predict_rejection,
            "uniform_expected": self.predict_uniform,
            "smart_expected": functools.partial(self.predict_uniform, eps=1.0 / n),
            "smart_sampling": functools.partial(self.predict_smart_sampling,
                                                eps=1.0 / n**2),
            "uniform_sampling": functools.partial(self.predict_smart_sampling, eps=0.0),
            "sampling": self.predict,
        }[strategy]


# ------------------------------------------------------------ on the device
def _round_robin_emit_torch(counts, order, num: int):
    """Round-robin emission: walk ``order`` (B, G) repeatedly, emitting each
    generator while it has slots left in ``counts`` (B, G), until ``num``
    slots per row are filled (fixed shapes; rounds = num)."""
    b, g = counts.shape
    c_sorted = torch.gather(counts, 1, order)
    r = torch.arange(num, device=counts.device)[None, :, None]
    valid = (c_sorted[:, None, :] > r).reshape(b, -1)  # (B, num*G)
    flat_gen = order[:, None, :].expand(b, num, g).reshape(b, -1)
    pos = torch.cumsum(valid, dim=1)  # 1-based emission slot per valid entry
    # out[b, j] = flat_gen at the unique position where pos == j+1 (valid)
    slot = torch.arange(1, num + 1, device=counts.device)
    hits = valid[:, None, :] & (pos[:, None, :] == slot[None, :, None])
    return (hits * flat_gen[:, None, :]).sum(-1).to(torch.int32)


def expected_selection_torch(probs, num: int):
    """``predict_expected``'s allocation (train.py:309-337): round(p*num)
    slots per generator, the rounding residue spread over generators in
    descending-allocation order, emitted round-robin in that order;
    probs (B, G) -> int32 (B, num)."""
    b, g = probs.shape
    expected = torch.round(probs * num).to(torch.int64)
    order = torch.argsort(-expected, dim=-1, stable=True)
    missing = num - expected.sum(1)
    m_abs = missing.abs()
    base, rem = m_abs // g, m_abs % g
    per_rank = base[:, None] + (torch.arange(g, device=probs.device)[None, :]
                                < rem[:, None]).to(torch.int64)
    filler = torch.zeros_like(expected).scatter(1, order, per_rank)
    expected = expected + torch.sign(missing)[:, None] * filler
    return _round_robin_emit_torch(expected, order, num)


def uniform_selection_torch(probs, num: int, eps: float):
    """``predict_uniform``'s selection (train.py:382-405): the generators
    with prob > eps (all if none), by descending prob, emitted round-robin;
    probs (B, G) -> int32 (B, num)."""
    over = probs > eps
    over = torch.where(~over.any(1, keepdim=True), True, over)
    counts = torch.where(over, num, 0).to(torch.int64)
    masked = torch.where(over, probs, -torch.inf)
    order = torch.argsort(-masked, dim=1, stable=True)
    return _round_robin_emit_torch(counts, order, num)

