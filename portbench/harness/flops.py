"""The benchmark's own count of the products a train step and a predictor
call need.

Counted as ``torch.utils.flop_counter`` counts them (matrix products,
convolutions and their gradients, at two FLOPs a multiply-add; element-wise
work is not counted), layer by layer from the configuration's widths and
two sizes of the batch: ``agents``, the real agents, and ``pairs``, the sum
over scenes of the square of each scene's real agents (the social modules
score every ordered pair of a scene, self included). Padded rows are not
counted, so the count is the work the batch needs, whatever the program
runs on its padding. With every agent real (``agents = S * P``, ``pairs =
S * P * P``) it equals the count of the program's step under
``FlopCounterMode``.

In a differentiated pass each product also costs its gradients: the
weight's when the weight is trained in that pass, and the input's when the
input depends on a trained weight. A multiplier ``m`` below is 1 for the
forward product alone, 2 with one of its gradients, 3 with both.
"""

from __future__ import annotations

from portbench.harness.roofline import reverse_sweep_flops, rollout_flops

OBS_STEPS = 7  # observed steps the encoders read
PRED_LEN = 12
PATCH = 33
SCENE_CELLS = 64


def mm(m, k, n):
    return 2 * m * k * n


def _conv(rows, c_in, c_out, side):
    return 2 * rows * c_out * side * side * c_in * 9


class Widths:
    def __init__(self, cfg: dict):
        self.h = cfg["h_dim"]
        self.dh = cfg["decoder_h_dim"]
        self.emb = self.dh // 2
        self.z = cfg["noise_dim"]
        self.g = cfg["num_gens"]
        self.k = cfg["num_samples"]
        self.ke = cfg["num_expectation_samples"]
        self.enc = self.h + SCENE_CELLS + self.h  # track, scene, social
        self.dd = 2 * self.h  # the discriminator's width
        self.cd = 2 * self.dd + SCENE_CELLS


def _track(n, inp, emb, h, m_embed, m_in, m_first, m_rest):
    """Embedding + LSTM over the observed steps of ``n`` tracks; the first
    step's recurrent product multiplies a zero state that needs no
    gradient."""
    return (mm(OBS_STEPS * n, inp, emb) * m_embed + mm(OBS_STEPS * n, emb, 4 * h) * m_in
            + mm(n, h, 4 * h) * (m_first + (OBS_STEPS - 1) * m_rest))


def _scene(n, channels, m_first, m_rest):
    """Two 3x3 convolutions (33x33, then 16x16 after the pool) and the
    channel attention over the 8x8 map."""
    return (_conv(n, 4, channels, PATCH) * m_first + _conv(n, channels, channels, 16) * m_rest
            + (mm(SCENE_CELLS * n, channels, 32) + mm(SCENE_CELLS * n, 32, channels)) * m_rest)


def _social(n, pairs, k, h, feat, m_first, m_rest, m_w, m_score, m_pool):
    """Sways attention: the pair features' MLP (3 -> 32 -> 64 -> feat), the
    key projection of ``k`` samples' encodings, the pair scores and the
    pooling."""
    return ((mm(pairs, 3, 32) * m_first + (mm(pairs, 32, 64) + mm(pairs, 64, feat)) * m_rest)
            + mm(k * n, h, feat) * m_w + 2 * k * pairs * feat * m_score
            + 2 * k * pairs * h * m_pool)


def _g_encode(w: Widths, n, pairs, grad: bool):
    two, three = (2, 3) if grad else (1, 1)
    return (_track(n, 2, w.emb, w.h, two, three, two, three)
            + _scene(n, 16, two, three)
            + _social(n, pairs, 1, w.h, w.h, two, three, three, three, three))


def _pm(w: Widths, n, m):
    return (mm(n, w.enc, w.h // 2) + mm(n, w.h // 2, w.h // 2) + mm(n, w.h // 2, w.g)) * m


def _h0(w: Widths, rows, m):
    return mm(rows, w.enc + w.z, w.dh) * m


def _decoder_prep(w: Widths, n, m):
    """Folding the spatial embedding into the gate weights (weights and
    bias) and the hoisted social term of every generator."""
    return (mm(w.g * 2, w.emb, 4 * w.dh) + mm(w.g, w.emb, 4 * w.dh)
            + mm(n, w.h, w.g * (w.dh // 2))) * m


def _d(w: Widths, n, pairs, k, trained: bool, branch: bool):
    """The discriminator on ``k`` candidate futures. ``trained``: its
    weights take gradients (the D step); otherwise the gradient reaches the
    candidates alone (the G step). ``branch``: the generator-id head is in
    the loss."""
    if trained:
        fut_first, fut_rest, w_soc, score, pool, head = 2, 3, 3, 3, 3, 3
        track = _track(n, 2, w.dd, w.dd, 2, 3, 2, 3)
        past = (mm(n, w.dd, w.dd // 2) + mm(n, w.dd // 2, w.dd // 2)) * 3
        pairs_mlp = (mm(pairs, 3, 32) * 2 + (mm(pairs, 32, 64) + mm(pairs, 64, w.dd)) * 3)
        scene = _scene(n, 8, 2, 3)
    else:
        fut_first = fut_rest = w_soc = score = head = 2
        pool = 3
        track = _track(n, 2, w.dd, w.dd, 1, 1, 1, 1)
        past = mm(n, w.dd, w.dd // 2) + mm(n, w.dd // 2, w.dd // 2)
        pairs_mlp = mm(pairs, 3, 32) + mm(pairs, 32, 64) + mm(pairs, 64, w.dd)
        scene = _scene(n, 8, 1, 1)
    future = (mm(k * n, PRED_LEN * 2, w.dd) * fut_first
              + mm(k * n, w.dd, w.dd // 2) * fut_rest)
    social = (mm(k * n, w.dd, w.dd) * w_soc + 2 * k * pairs * w.dd * score
              + 2 * k * pairs * w.dd * pool)
    heads = (mm(k * n, w.cd, w.cd // 2) + mm(k * n, w.cd // 2, 1)) * head
    br = (mm(k * n, w.cd, w.cd // 2) + mm(k * n, w.cd // 2, w.g)) * (head if branch else 1)
    return track + past + pairs_mlp + scene + future + social + heads + br


def _rollouts(w: Widths, rows):
    return rollout_flops(rows, PRED_LEN, w.dh, w.dh // 2, 2)


def _sweep(w: Widths, rows):
    return reverse_sweep_flops(rows, PRED_LEN, w.dh, w.dh // 2, 2)


def train_step_flops(cfg: dict, agents: int, pairs: int) -> int:
    """One train step: the D update (real and one sampled fake candidate
    each agent), the G update (K candidates of every generator, gathered,
    through the frozen D) and the PM update (``num_expectation_samples``
    rollouts of every generator as targets)."""
    w, n = Widths(cfg), agents
    d_step = (_d(w, n, pairs, 1, True, False)
              + _g_encode(w, n, pairs, False) + _pm(w, n, 1) + _h0(w, n, 1)
              + _decoder_prep(w, n, 1) + _rollouts(w, n)
              + _d(w, n, pairs, 1, True, True))
    g_step = (_g_encode(w, n, pairs, True) + _pm(w, n, 1) + _h0(w, w.k * n, 3)
              + _decoder_prep(w, n, 3) + _rollouts(w, w.g * w.k * n) + _sweep(w, w.g * w.k * n)
              + _d(w, n, pairs, w.k, False, True))
    pm_step = (_g_encode(w, n, pairs, True) + _pm(w, n, 3) + _h0(w, w.ke * n, 1)
               + _decoder_prep(w, n, 1) + _rollouts(w, w.g * w.ke * n))
    return int(d_step + g_step + pm_step)


def predict_flops(cfg: dict, agents: int, pairs: int, num: int) -> int:
    """One sampling call: the encoding, the PM net and ``num`` rollouts of
    each agent's chosen generator."""
    w, n = Widths(cfg), agents
    return int(_g_encode(w, n, pairs, False) + _pm(w, n, 1) + _h0(w, num * n, 1)
               + _decoder_prep(w, n, 1) + _rollouts(w, num * n))


def batch_sizes(ped_counts) -> tuple[int, int]:
    """``(agents, pairs)`` of a batch from its scenes' real agent counts."""
    counts = [int(c) for c in ped_counts]
    return sum(counts), sum(c * c for c in counts)
