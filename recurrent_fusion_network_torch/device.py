"""Device resolution for the port's entry points.

Every entry point runs on the CUDA device unless its caller asks for the
CPU explicitly (``device="cpu"``, ``--device cpu``), as the tests do. Without
CUDA and without that request it raises: it never quietly runs on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None or "cuda" -> the CUDA device (raises when CUDA is absent);
    "cpu" -> the CPU; any other torch device spec is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU explicitly"
        )
    return dev
