"""LSTM cell and time loop with fused gate matmuls.

Counterpart of ``mggan_tpu/ops/lstm.py``: gate order (i, f, g, o), weights
``w_ih (in, 4h)`` and ``w_hh (h, 4h)``, both biases added.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.ops.linear import uniform


def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int):
    bound = 1.0 / hidden_size ** 0.5
    return {
        "w_ih": uniform(gen, (input_size, 4 * hidden_size), bound),
        "w_hh": uniform(gen, (hidden_size, 4 * hidden_size), bound),
        "b_ih": uniform(gen, (4 * hidden_size,), bound),
        "b_hh": uniform(gen, (4 * hidden_size,), bound),
    }


def _gate_update(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(params, x, h, c):
    """One LSTM step. x: (..., in), h/c: (..., hidden)."""
    gates = x @ params["w_ih"] + h @ params["w_hh"] + params["b_ih"] + params["b_hh"]
    return _gate_update(gates, c)


def lstm_scan(params, xs, h0=None, c0=None):
    """Run an LSTM over the leading time axis of ``xs (T, N, in)``.

    The input contribution of every step is one matmul hoisted out of the
    loop, as in the JAX scan. Returns ``(hs (T, N, hidden), (h_T, c_T))``.
    """
    n = xs.shape[1]
    hidden = params["w_hh"].shape[0]
    if h0 is None:
        h0 = xs.new_zeros((n, hidden))
    if c0 is None:
        c0 = xs.new_zeros((n, hidden))
    x_gates = xs @ params["w_ih"] + (params["b_ih"] + params["b_hh"])
    h, c = h0, c0
    hs = []
    for xg in x_gates:
        h, c = _gate_update(xg + h @ params["w_hh"], c)
        hs.append(h)
    return torch.stack(hs), (h, c)
