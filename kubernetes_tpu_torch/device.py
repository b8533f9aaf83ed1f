"""Device resolution for the port's entry points.

The port runs on the card. The CPU is used only when a caller names it
(`device="cpu"`), as the tests do; there is no silent fallback, so a
measurement that finds no card fails instead of timing the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` when no device is given; raises if CUDA is absent then.

    An explicit device is returned as given (a CUDA device still needs
    a card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is absent")
    return dev
