"""Launch the hand-written Hopper Hamming-matrix kernel (csrc/hamming.cu).

Counterpart of orb_slam2_map_tpu/ops/pallas_kernels.py:
hamming_matrix_pallas. The library is built on first use
(ops/cuda_build.py); a missing nvcc, a failed build or a failed launch
raises. The plain version lives in ops/matching.py:hamming_matrix_plain.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

LIB = cuda_build.KernelLibrary(
    "hamming", "hamming_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()   # the async pipeline launches from
                                   # several threads


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: desc_a [N, 8] and desc_b [M, 8] int32 (bit views
    of packed uint32 words), contiguous and 16-byte aligned on one CUDA
    device. Returns the [N, M] float32 Hamming distances on the current
    stream, without synchronising. N = 0 or M = 0 launches nothing."""
    global LAUNCHES
    cuda_build.require_cuda("hamming_cuda", desc_a)
    device = desc_a.device
    n, m = desc_a.shape[0], desc_b.shape[0]
    cuda_build.check("desc_a", desc_a, torch.int32, (n, 8), device)
    cuda_build.check("desc_b", desc_b, torch.int32, (m, 8), device)
    cuda_build.check_aligned("desc_a", desc_a)
    cuda_build.check_aligned("desc_b", desc_b)
    if (n + 63) // 64 > 65535:
        raise ValueError(f"{n} query rows exceed the kernel's grid")
    launch = LIB.fn()
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(device):
        rc = launch(desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), n, m,
                    cuda_build.stream_of(device))
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out
