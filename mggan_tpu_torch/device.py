"""Device selection shared by the port's entry points.

Entry points default to the card. Without one they raise rather than fall
back: the CPU runs only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def host_to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``.

    A host array bound for the card is staged in pinned memory and copied
    with ``non_blocking=True``: a copy from pageable memory synchronizes
    the current stream, so the calling thread would wait for every step
    already queued on it. The caching host allocator keeps the pinned
    block until the copy has run.
    """
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
