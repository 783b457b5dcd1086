"""Launch the hand-written Hopper gated-NN kernel (csrc/gated_nn.cu).

Counterpart of orb_slam2_map_tpu/ops/pallas_kernels.py:gated_nn_pallas.
The library is built on first use (ops/cuda_build.py); a missing nvcc, a
failed build or a failed launch raises. The plain version lives in
ops/matching.py:gated_nn_plain.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

LIB = cuda_build.KernelLibrary(
    "gated_nn", "gated_nn_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# columns are packed into the low 22 bits of the kernel's candidate keys
MAX_KEYS = (1 << 22) - 64

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()   # the async pipeline launches from
                                   # several threads


def gated_nn(desc_a: torch.Tensor, desc_b: torch.Tensor, gate: torch.Tensor):
    """Launch the kernel: desc_a [N, 8] int32, desc_b [M, 8] int32 (bit
    views of packed uint32 words, 16-byte aligned), gate [N, M] bool, all
    contiguous on one CUDA device, M <= 2^22 - 64. Returns (idx int32 [N],
    best f32 [N], second f32 [N]) on the current stream, without
    synchronising."""
    global LAUNCHES
    cuda_build.require_cuda("gated_nn_cuda", desc_a)
    device = desc_a.device
    n, m = desc_a.shape[0], desc_b.shape[0]
    cuda_build.check("desc_a", desc_a, torch.int32, (n, 8), device)
    cuda_build.check("desc_b", desc_b, torch.int32, (m, 8), device)
    cuda_build.check("gate", gate, torch.bool, (n, m), device)
    cuda_build.check_aligned("desc_a", desc_a)
    cuda_build.check_aligned("desc_b", desc_b)
    if m > MAX_KEYS:
        raise ValueError(f"{m} keys exceed the kernel's {MAX_KEYS}")
    launch = LIB.fn()
    idx = torch.empty(n, dtype=torch.int32, device=device)
    best = torch.empty(n, dtype=torch.float32, device=device)
    second = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return idx, best, second
    with torch.cuda.device(device):
        rc = launch(desc_a.data_ptr(), desc_b.data_ptr(), gate.data_ptr(),
                    idx.data_ptr(), best.data_ptr(), second.data_ptr(), n, m,
                    cuda_build.stream_of(device))
    if rc != 0:
        raise RuntimeError(f"gated_nn kernel launch failed: CUDA error {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return idx, best, second
