"""Device resolution for the port's entry points.

The port runs on the card. ``device=None`` means ``cuda``; without a GPU that
raises instead of quietly carrying on on the CPU. The CPU is used only when
the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
