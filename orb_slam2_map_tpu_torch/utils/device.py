"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` when given, else the CUDA card; raises when there is no
    card and the caller did not ask for another device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run it on the CPU")
    return torch.device("cuda")
