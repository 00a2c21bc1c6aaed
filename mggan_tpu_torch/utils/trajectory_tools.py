"""Gradient-norm logging and the SGHMC noise helpers (counterpart of
``GradNormLogger``, ``sghmc_noise_like`` and ``noise_loss`` in
``mggan_tpu/utils/trajectory_tools.py``; reference utils.py:10-31,
168-199). The rest of that module waits for ROADMAP.md queue 1 item 15."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from mggan_tpu_torch.utils.pytree import tree_items, tree_map


class GradNormLogger:
    """Per-module gradient-norm accumulation from the train step's
    ``gradnorm/<prefix>/<module>`` metrics (the top-level keys of the grad
    tree play the modules' part)."""

    def __init__(self):
        self.grad_norms = defaultdict(list)

    def update_scalars(self, module: str, values):
        """Append per-step norms already computed for one module (the train
        step's ``gradnorm/<prefix>/<module>`` metrics); NaN sentinels of
        skipped D steps are dropped, as the reference appends nothing on a
        skipped iteration."""
        vals = [float(v) for v in values]
        self.grad_norms[module].extend(v for v in vals if not np.isnan(v))

    def reset(self):
        self.grad_norms = defaultdict(list)

    def write(self, writer, global_step):
        """Emit per-module gradient histograms to the writer's TensorBoard
        backend, if it has one (utils.py:195-199), and reset."""
        tb = getattr(writer, "_tb", None)
        if tb is not None:
            for module, vals in self.grad_norms.items():
                tb.add_histogram(f"gradient_histograms/{module}", np.array(vals),
                                 global_step)
        self.reset()


def sghmc_noise_like(params):
    """Zero buffers matching the parameter tree (utils.py:28-31)."""
    return tree_map(torch.zeros_like, params)


def noise_loss(params, normals, alpha: float):
    """SGHMC noise loss ``sum_p <p, n_p>``, ``n_p = alpha * normals_p``
    (utils.py:10-15). ``normals`` is a tree shaped like ``params`` of
    standard normals (JAX draws one per leaf from ``split(key, n_leaves)``
    in leaf order); the leaves add in ``tree_items`` order, JAX's order."""
    flat = dict(tree_items(normals))
    total = 0.0
    for path, p in tree_items(params):
        total = total + (p * (flat[path] * alpha)).sum()
    return total
