"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import numpy as np
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


def host_tensor(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Numpy array `a` as a `dtype` tensor on `device`; uint32 arrays
    (packed descriptors) become their int32 bit-views, the port's
    descriptor type."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a, dtype = a.view(np.int32), torch.int32
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Tensor on `device` holding numpy array `a`. To a CUDA device the
    array is staged in page-locked memory and copied without blocking
    the host (the caching host allocator keeps the staging block until
    the copy has completed), so a launch queue running ahead of the host
    is not drained; to the CPU it is a plain conversion."""
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
