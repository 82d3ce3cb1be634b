"""Device resolution shared by the port's entry points.

Every entry point (``simulate``, ``run_window``, ``ProfileTable``,
``ArcusRuntime``) takes ``device=`` and runs on the card unless the caller
asks for the CPU.  Without CUDA and without an explicit ``device="cpu"`` it
raises: the port never carries on quietly on the host.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "host")
    return dev
