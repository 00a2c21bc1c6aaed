"""Hold the train state one step leaves on the card against the CPU's.

Both devices run the step from the same weights, state and draws. Each
parameter element is held to ``atol``, but where its gradient is float
noise, the remainder of a sum that cancels: a conv bias before train-mode
BatchNorm, a head bias under W's difference of two means over the same
agents, any element whose sums happen to cancel. Adam's first updates move
an element by about ``lr * g / (|g| + eps)``, so such an element moves by
up to ``lr`` of a random sign on either device, and its parameter is held
to ``2 * lr`` per update on top of ``atol``. What the kernels computed for
it is held instead: the two states' bias-corrected first moments (a
weighted mean of the step's gradients) agree within ``GRAD_NOISE_REL``
times the rms gradient of its module (the top-level key, as the gradnorm
metrics group them), that module's rms read from the CPU's state.

A float-noise element is one of a leaf in ``noise_leaves``, or one whose
rms gradient (the bias-corrected second moment) is nonzero on one device
and below ``GRAD_NOISE_REL`` times its module's on one. So a card gradient
of 0 where the CPU's is large is such an element, and fails on its first
moment. An element with no gradient on either device moves by the weight
decay alone and is held to ``atol``.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.training.state import optimizers
from mggan_tpu_torch.utils.pytree import tree_items

GRAD_NOISE_REL = 1e-4


def _module_rms(nu, bc2):
    """Top-level key -> rms of the bias-corrected second moments under it."""
    out = {}
    for key, sub in nu.items():
        leaves = [v for _, v in tree_items(sub)]
        out[key] = float(torch.sqrt(sum(v.double().sum() for v in leaves) / bc2
                                    / sum(v.numel() for v in leaves)))
    return out


def train_state_diffs(a, b, cfg, atol, noise_leaves=frozenset()):
    """Card state ``a`` against CPU state ``b`` (``TrainState``s after the
    same step) -> dict: ``param_max_abs_diff`` over the elements held to
    ``atol``; ``noise_max_abs_diff`` and ``noise_grad_max_rel_diff`` (first
    moments' difference over the module's rms gradient) over the
    float-noise elements; ``grad_max_rel_diff``, the latter over every
    element (reported, not held); ``noise_elements``, ``elements``; and
    ``bad``: ``(tree, path, reason)`` for each leaf beyond a bound."""
    out = {"param_max_abs_diff": 0.0, "noise_max_abs_diff": 0.0,
           "noise_grad_max_rel_diff": 0.0, "grad_max_rel_diff": 0.0,
           "noise_elements": 0, "elements": 0, "bad": []}
    for name, tx, lr in zip(("g", "d"), optimizers(cfg), (cfg.g_lr, cfg.d_lr)):
        opt_a, opt_b = getattr(a, f"{name}_opt"), getattr(b, f"{name}_opt")
        params_b = dict(tree_items(getattr(b, f"{name}_params")))
        if opt_a.count != opt_b.count:
            out["bad"].append((name, (), f"{opt_a.count} updates, {opt_b.count} on the CPU"))
            continue
        count = opt_b.count
        bc1, bc2 = 1.0 - tx.beta1 ** count, 1.0 - tx.beta2 ** count
        module_rms = _module_rms(opt_b.nu, bc2) if count else {}
        mu_a, mu_b, nu_a, nu_b = (dict(tree_items(t)) for t in
                                  (opt_a.mu, opt_b.mu, opt_a.nu, opt_b.nu))
        for path, x in tree_items(getattr(a, f"{name}_params")):
            err = (x.cpu() - params_b[path]).abs()
            out["elements"] += err.numel()
            if not count:
                noisy = torch.zeros_like(err, dtype=torch.bool)
                grad = torch.zeros_like(err)
            else:
                rms = module_rms[path[0]]
                rms_a, rms_b = (torch.sqrt(v[path].cpu() / bc2) for v in (nu_a, nu_b))
                noisy = ((torch.minimum(rms_a, rms_b) < GRAD_NOISE_REL * rms)
                         & (torch.maximum(rms_a, rms_b) > 0))
                if path in noise_leaves:
                    noisy = torch.ones_like(noisy)
                grad = (mu_a[path].cpu() - mu_b[path]).abs() / bc1 / max(rms, 1e-30)
            out["noise_elements"] += int(noisy.sum())
            quiet = float(err[~noisy].max()) if (~noisy).any() else 0.0
            loud = float(err[noisy].max()) if noisy.any() else 0.0
            noise_grad = float(grad[noisy].max()) if noisy.any() else 0.0
            out["param_max_abs_diff"] = max(out["param_max_abs_diff"], quiet)
            out["noise_max_abs_diff"] = max(out["noise_max_abs_diff"], loud)
            out["noise_grad_max_rel_diff"] = max(out["noise_grad_max_rel_diff"], noise_grad)
            out["grad_max_rel_diff"] = max(out["grad_max_rel_diff"], float(grad.max()))
            if quiet > atol:
                out["bad"].append((name, path, f"parameter {quiet:.3e} > {atol:g}"))
            if loud > 2 * lr * count + atol:
                out["bad"].append((name, path, f"float-noise parameter {loud:.3e} > "
                                               f"2 * lr * {count} + {atol:g}"))
            if noise_grad > GRAD_NOISE_REL:
                out["bad"].append((name, path, f"float-noise gradient {noise_grad:.3e} of the "
                                               f"module's rms > {GRAD_NOISE_REL:g}"))
    return out
