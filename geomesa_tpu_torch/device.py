"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller names the CPU.  With
no card and no explicit ``"cpu"`` they raise: a run that asked for the
card never carries on quietly on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else is taken as named.  Raises when
    the resolved device is CUDA and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
