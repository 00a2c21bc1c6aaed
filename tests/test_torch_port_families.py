"""Every train-step family of the port against the JAX package's goldens,
the settings that still raise, and the weight loaders (CPU).

The four golden fixtures of ``tests/test_golden.py`` that the flagship test
(``test_torch_port_train.py``) leaves out: gan / l2, infogan / none,
mgan / ml / W and probgan / ml, at the golden size (h = 16, 2 generators,
batch 4 x 3), with JAX's weights and JAX's draws replayed from the step's
key tree (``test_torch_port_train._jax_draws``: the gradient penalty's
uniforms and probgan's SGHMC normals included). Tolerances: the fixtures'
atol/rtol 1e-4 on every key, and the key sets equal. Then what still
raises (``abs_rel`` in both discriminators; ``disc_scores`` is in
``test_torch_port_families_jax_d.py``), the strict reference-layout loaders for infogan, probgan (with
``discs_hist``), sgan pooling and the discrete generator against
``mggan_tpu/models/torch_export.py``'s export, and the history's update.
"""

import functools
import inspect
import json
import pkgutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mggan_tpu_torch
from mggan_tpu.config import Config as JaxConfig
from mggan_tpu.models import discriminator as jax_D
from mggan_tpu.models import factory as jax_factory
from mggan_tpu.models import torch_export
from mggan_tpu.training.state import init_train_state as jax_init_train_state
from mggan_tpu.training.steps import build_train_step as jax_build_train_step
from mggan_tpu_torch.config import Config
from mggan_tpu_torch.models import discriminator, factory
from mggan_tpu_torch.models.weights import (
    discriminator_from_jax,
    discriminator_from_state_dict,
    generator_from_jax,
    generator_from_state_dict,
)
from mggan_tpu_torch.tools.state_compare import train_state_diffs
from mggan_tpu_torch.training import steps
from mggan_tpu_torch.training.state import AdamState, init_train_state
from mggan_tpu_torch.training.steps import batch_views, build_train_step
from mggan_tpu_torch.utils.pytree import tree_items, tree_map
from test_torch_port_train import (
    _assert_metrics_close,
    _assert_params_close,
    _batch,
    _gsums,
    _jax_draws,
    _np,
    _port_packs,
    _port_step,
)

# small CPU tensors: one intra-op thread runs them faster, and the test
# run's worker processes share the cores
torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "golden"
GOLDEN_SIZE = dict(dataset="synthetic_memory", batch_size=4, num_gens=2, epochs=2,
                   num_samples=3, num_expectation_samples=2, h_dim=16, decoder_h_dim=16,
                   noise_dim=8)


# the running means of the BNs after NOISE_LEAVES' convs (momentum 0.1)
NOISE_STATS = {("scene", "bn1", "mean"), ("scene", "bn2", "mean")}
BN_MOMENTUM = 0.1


def run_case(kw, n_steps=1, s=4, p=3):
    """``n_steps`` steps of the JAX ``build_train_step`` and of the port's
    from the same weights at the golden size, each port step on the JAX
    step's replayed draws (the cases of ``test_torch_port_families_jax_*``).
    Metrics (NaN where both are) after every step and, after the last,
    every parameter (``_assert_params_close``: atol 1e-4, the conv biases
    before train-mode BN within 2 * lr per Adam update) and BN statistic
    or probgan history (1e-5). The running means of those BNs take in
    their conv's bias at momentum 0.1, so after ``u`` updates, the later
    ones reading a bias already off by up to 2 * lr per update, they are
    held to ``0.1 * lr * u * (u - 1)`` more. Returns the port's metrics
    per step."""
    cfg = JaxConfig(**{**GOLDEN_SIZE, **kw})
    (j_g, j_d), pcfg, g_pack, d_pack = _port_packs(cfg)
    batch = _batch(s, p)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state = jax_init_train_state(cfg, j_g, j_d, jax.random.PRNGKey(1))
    j_step = jax_build_train_step(cfg, j_g[2], j_d[2])
    state = init_train_state(pcfg, g_pack, d_pack)
    step = build_train_step(pcfg, g_pack[2], d_pack[2])
    out = []
    for _ in range(n_steps):
        draws = _jax_draws(j_state.rng, cfg, s, p, j_state.d_params, j_state.g_params)
        j_state, j_metrics = j_step(j_state, j_batch)
        state, metrics = step(state, batch, draws)
        got = {k: float(v) for k, v in metrics.items()}
        _assert_metrics_close(got, {k: float(v) for k, v in j_metrics.items()})
        out.append(got)
    assert state.step == int(j_state.step) == n_steps
    _assert_params_close(state.g_params, j_state.g_params, cfg.g_lr, state.g_opt.count)
    _assert_params_close(state.d_params, j_state.d_params, cfg.d_lr, state.d_opt.count)
    for tree, j_tree, lr, u in ((state.g_state, j_state.g_state, cfg.g_lr, state.g_opt.count),
                                (state.d_state, j_state.d_state, cfg.d_lr, state.d_opt.count)):
        want, got = dict(tree_items(_np(j_tree))), dict(tree_items(tree))
        assert set(got) == set(want)
        for path, w in want.items():
            atol = 1e-5 + (BN_MOMENTUM * lr * u * (u - 1) if path in NOISE_STATS else 0.0)
            np.testing.assert_allclose(got[path].numpy(), w, atol=atol, rtol=1e-5,
                                       err_msg=str(path))
    return out


@pytest.mark.parametrize("gan_type,wt,gan_obj", [
    ("gan", "l2", "NS"),
    ("infogan", "none", "NS"),
    ("mgan", "ml", "W"),
    ("probgan", "ml", "NS"),
])
def test_train_step_matches_golden_fixture(gan_type, wt, gan_obj):
    """One port step from the golden's weights and replayed draws gives the
    golden's metrics and parameter sums (tests/test_golden.py:62-97)."""
    cfg = JaxConfig(gan_type=gan_type, weighting_target=wt, gan_obj=gan_obj, **GOLDEN_SIZE)
    (j_g, j_d), pcfg, g_pack, d_pack = _port_packs(cfg)
    draws = _jax_draws(jax.random.PRNGKey(1), cfg, 4, 3, j_d[0], j_g[0])
    assert set(draws) == set(steps.needed_draw_keys(pcfg))
    state, metrics = _port_step(cfg, (pcfg, g_pack, d_pack), _batch(4, 3), draws)
    got = {k: float(v) for k, v in metrics.items()}
    got.update(_gsums(state))
    tag = f"{gan_type}_{wt}" + ("" if gan_obj == "NS" else f"_{gan_obj}")
    _assert_metrics_close(got, json.loads((GOLDEN_DIR / f"train_step_{tag}_v1.json").read_text()))
    assert state.step == 1
    if gan_type == "probgan":  # the history moved at step 0: len 2, the heads' mean
        hist = state.d_state["hist"]
        assert float(hist["len"]) == 2.0
        for (path, h), (_, live) in zip(tree_items(hist["discs"]),
                                        tree_items(state.d_params["discs"])):
            init = d_pack[0]["discs"]
            for key in path:
                init = init[key]
            torch.testing.assert_close(h, 0.5 * init + 0.5 * live, atol=1e-7, rtol=1e-6)


def test_abs_rel_discriminator_raises_in_both():
    """``inp_format="abs_rel"`` is generator-only (PARITY.md deviation 8):
    both discriminators fail to concatenate 8-step positions with 7-step
    offsets."""
    cfg = JaxConfig(inp_format="abs_rel", **GOLDEN_SIZE)
    _, d_pack = jax_factory.construct_model(cfg, jax.random.PRNGKey(0))
    pcfg = Config.from_dict(cfg.to_dict())
    d_spec = factory.build_d_spec(pcfg)
    dp, ds = discriminator_from_jax(_np(d_pack[0]), _np(d_pack[1]), d_spec, device="cpu")
    bv = batch_views({k: torch.from_numpy(v) for k, v in _batch(2, 3).items()})
    args = (bv.in_xy, bv.in_dxdy, bv.gt_xy[None], bv.gt_dxdy[None], bv.ped_mask,
            bv.loss_mask, bv.patches)
    with pytest.raises(TypeError):
        jax_D.apply(d_pack[0], d_pack[1], d_pack[2], *(jnp.asarray(a.numpy()) for a in args))
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        discriminator.apply(dp, ds, d_spec, *args)


def test_no_port_module_names_the_train_step_item():
    """Every family of the train step is ported: no module of the port
    refers a caller to that queue item any more."""
    named = []
    for m in pkgutil.walk_packages(mggan_tpu_torch.__path__, "mggan_tpu_torch."):
        mod = __import__(m.name, fromlist=["_"])
        try:
            src = inspect.getsource(mod)
        except (OSError, TypeError):
            continue
        if "item 10" in src:
            named.append(m.name)
    assert not named
    for kw in ({"gan_type": "infogan"}, {"gan_type": "probgan", "num_unrolling_steps": 1},
               {"experiment": "discrete", "pool_type": "sgan"}, {"gan_obj": "LS"}):
        steps.check_scope(Config(**kw))


@pytest.mark.parametrize("kw", [
    {"gan_type": "infogan"},
    {"gan_type": "probgan"},
    {"pool_type": "sgan"},
    {"experiment": "discrete", "weighting_target": "none"},
], ids=["infogan", "probgan", "sgan", "discrete"])
def test_reference_state_dicts_load_strictly(kw):
    """The JAX export's reference-layout state dicts load through the strict
    ``*_from_state_dict`` into the trees ``*_from_jax`` gives; an extra or a
    missing key raises."""
    cfg = JaxConfig(**{**GOLDEN_SIZE, "num_gens": 3, **kw})
    (g_pack, d_pack), pcfg, (gp, gs, g_spec), (dp, ds, d_spec) = _port_packs(cfg)
    g_sd = torch_export.export_generator(g_pack[0], g_pack[1], g_pack[2])
    d_sd = torch_export.export_discriminator(d_pack[0], d_pack[1], d_pack[2])
    if kw.get("gan_type") == "probgan":
        assert sum(k.startswith("discs_hist.") for k in d_sd) == 5 * 4
    loaded = (generator_from_state_dict(g_sd, g_spec, device="cpu"),
              discriminator_from_state_dict(d_sd, d_spec, device="cpu"))
    for (p2, s2), (p1, s1) in zip(loaded, ((gp, gs), (dp, ds))):
        for a, b in ((p1, p2), (s1, s2)):
            items_a, items_b = list(tree_items(a)), list(tree_items(b))
            assert [k for k, _ in items_a] == [k for k, _ in items_b]
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(items_a, items_b))
    for load, sd, spec in ((generator_from_state_dict, g_sd, g_spec),
                           (discriminator_from_state_dict, d_sd, d_spec)):
        with pytest.raises(KeyError, match="unexpected"):
            load({**sd, "extra.bias": np.zeros(1)}, spec, device="cpu")
        with pytest.raises(KeyError):
            load({k: v for k, v in sd.items() if k != sorted(sd)[-1]}, spec, device="cpu")


def test_update_hist_matches_jax():
    """Two Polyak updates of probgan's history against ``update_hist``."""
    cfg = JaxConfig(gan_type="probgan", **GOLDEN_SIZE)
    (_, (jp, js, _)), _, _, (dp, ds, _) = _port_packs(cfg)
    rng = np.random.RandomState(0)
    for _ in range(2):
        live = jax.tree.map(lambda x: x + rng.randn(*x.shape).astype(np.float32), jp)
        js = jax_D.update_hist(live, js)
        ds = discriminator.update_hist(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), live), ds)
    assert float(ds["hist"]["len"]) == float(js["hist"]["len"]) == 3.0
    for (path, got), (_, want) in zip(tree_items(ds["hist"]["discs"]),
                                      tree_items(_np(js["hist"]["discs"]))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6, err_msg=str(path))


@functools.lru_cache(maxsize=1)
def _stepped_state():
    """The port's state after one flagship-family step at the golden size
    (CPU, the state's own draws), and its config."""
    pcfg = Config(**GOLDEN_SIZE)
    g_pack, d_pack = factory.construct_gan(pcfg, seed=0, device="cpu")
    step = build_train_step(pcfg, g_pack[2], d_pack[2])
    return step(init_train_state(pcfg, g_pack, d_pack), _batch(4, 3))[0], pcfg


def _edit(state, tree, path, fn, what="params"):
    """A copy of ``state`` whose leaf ``path`` of ``{tree}_params`` (or of
    its Adam ``mu`` and ``nu`` with ``what="moments"``) is ``fn`` of it."""
    def edit(t):
        t = tree_map(torch.clone, t)
        sub = t
        for key in path[:-1]:
            sub = sub[key]
        sub[path[-1]] = fn(sub[path[-1]])
        return t
    opt = getattr(state, f"{tree}_opt")
    if what == "params":
        return state.replace(**{f"{tree}_params": edit(getattr(state, f"{tree}_params"))})
    return state.replace(**{f"{tree}_opt": AdamState(opt.count, edit(opt.mu), edit(opt.nu))})


@pytest.mark.parametrize("case", ["same", "parameter_off", "card_gradient_zero",
                                  "noise_leaf_flips"])
def test_state_compare_holds_float_noise_elements_by_their_gradients(case):
    """``tools/state_compare.py`` (phase 16's card-vs-CPU rule): a state
    passes against itself; an element off by 2e-4 fails; an element whose
    gradient is 0 on one device where the other's is its leaf's largest
    counts as float noise and fails on its first moment, though its
    parameter moved by lr only, within the 2 * lr bound; a conv bias before
    train-mode BN (a noise leaf) that moved by lr the other way passes."""
    cpu, cfg = _stepped_state()
    path = ("decoders", "lstm", "w_ih")  # K3's gradient on the card
    mu = dict(tree_items(cpu.g_opt.mu))[path]
    hot = torch.zeros_like(mu, dtype=torch.bool).flatten()
    hot[int(mu.abs().flatten().argmax())] = True
    hot = hot.reshape(mu.shape)
    conv_b = ("scene", "conv1", "b")
    card = {
        "same": cpu,
        "parameter_off": _edit(cpu, "g", path, lambda x: x + 2e-4 * hot),
        "card_gradient_zero": _edit(
            _edit(cpu, "g", path, lambda x: x + cfg.g_lr * hot),
            "g", path, lambda x: torch.where(hot, 0.0, x), what="moments"),
        "noise_leaf_flips": _edit(cpu, "d", conv_b, lambda x: x - cfg.d_lr),
    }[case]
    diffs = train_state_diffs(card, cpu, cfg, 1e-4, {conv_b})
    assert diffs["elements"] > diffs["noise_elements"] >= dict(
        tree_items(cpu.d_params))[conv_b].numel()
    reasons = [(tree, p, why.split(" ")[0]) for tree, p, why in diffs["bad"]]
    want = {"same": [], "noise_leaf_flips": [], "parameter_off": [("g", path, "parameter")],
            "card_gradient_zero": [("g", path, "float-noise")]}[case]
    assert reasons == want, diffs["bad"]
    if case == "card_gradient_zero":
        assert "gradient" in diffs["bad"][0][2] and diffs["noise_max_abs_diff"] <= 2 * cfg.g_lr
