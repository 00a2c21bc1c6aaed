"""The decoder ablation entry points: the port's counterparts of the JAX
package's ``benchmarks/decode_ablation.py`` and
``benchmarks/sorted_select_ablation.py``, at their shapes, on the card.

    python -m mggan_tpu_torch.ablations.decode_ablation
    python -m mggan_tpu_torch.ablations.sorted_select_ablation

Each prints one line, ``DECODEABL {json}`` or ``SORTEDPARTS {json}``, of
device times in ms (CUDA events), and raises without a CUDA card.
"""

from __future__ import annotations

import torch

N = 1_310_720  # 4096 scenes x 16 peds x k=20
G, H, EMB, F, T = 4, 32, 16, 32, 12


def make_inputs(n: int = N, seed: int = 0, device="cuda"):
    """The benchmarks' inputs from seeded ``torch.Generator``s: decoders
    (G=4, h=32, emb 16, social 32, rel) and one row per rollout of xy,
    dxdy, social features, h0 and the sampled generator."""
    from mggan_tpu_torch.models import common

    stacked = common.stacked_decoders_init(torch.Generator().manual_seed(seed), G, EMB, H,
                                           "rel", F)
    gen = torch.Generator().manual_seed(seed + 1)
    rows = {
        "xy": torch.randn((n, 2), generator=gen),
        "dxdy": torch.randn((n, 2), generator=gen) * 0.1,
        "soc": torch.randn((n, F), generator=gen),
        "h0": torch.randn((n, H), generator=gen),
        "idx": torch.randint(0, G, (n,), generator=gen, dtype=torch.int32),
    }
    to = lambda x: ({k: to(v) for k, v in x.items()} if isinstance(x, dict) else x.to(device))
    return {"stacked": to(stacked), **to(rows)}


def cuda_time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
