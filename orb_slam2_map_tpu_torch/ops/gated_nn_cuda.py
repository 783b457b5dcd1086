"""Build, bind and launch the hand-written Hopper gated-NN kernel.

Counterpart of orb_slam2_map_tpu/ops/pallas_kernels.py. The CUDA source
is csrc/gated_nn.cu; it is compiled with nvcc for sm_90a into a shared
library with a plain C entry (no PyTorch headers, so the build takes
seconds) and bound with ctypes. The library is built on first use into
build/torch_kernels/ at the repository root, under a name keyed on a
hash of the source, so an edited .cu rebuilds.

There is no fallback: a missing nvcc, a failed build or a failed launch
raises. The plain version lives in ops/matching.py:gated_nn_plain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gated_nn.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# incremented once per kernel launch, and nowhere else
LAUNCHES = 0

_LIB = None
_LOCK = threading.Lock()
BUILD_LOG = ""        # nvcc's output of the build this process made
BUILD_SECONDS = 0.0   # its wall time (0 when the library was already built)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the gated-NN kernel cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"gated_nn_{digest}.so"


def build() -> Path:
    """Compile csrc/gated_nn.cu unless the library for this source exists."""
    global BUILD_LOG, BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.gated_nn_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gated_nn(desc_a: torch.Tensor, desc_b: torch.Tensor, gate: torch.Tensor):
    """Launch the kernel: desc_a [N, 8] int32, desc_b [M, 8] int32 (bit
    views of packed uint32 words), gate [N, M] bool, all contiguous on
    one CUDA device. Returns (idx int32 [N], best f32 [N], second f32 [N])
    on the current stream, without synchronising."""
    global LAUNCHES
    device = desc_a.device
    if device.type != "cuda":
        raise ValueError(f"gated_nn_cuda needs CUDA tensors, got {device}")
    n, m = desc_a.shape[0], desc_b.shape[0]
    _check("desc_a", desc_a, torch.int32, (n, 8), device)
    _check("desc_b", desc_b, torch.int32, (m, 8), device)
    _check("gate", gate, torch.bool, (n, m), device)
    lib = _load()
    idx = torch.empty(n, dtype=torch.int32, device=device)
    best = torch.empty(n, dtype=torch.float32, device=device)
    second = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return idx, best, second
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gated_nn_launch(desc_a.data_ptr(), desc_b.data_ptr(),
                                 gate.data_ptr(), idx.data_ptr(),
                                 best.data_ptr(), second.data_ptr(),
                                 n, m, stream)
    if rc != 0:
        raise RuntimeError(f"gated_nn kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return idx, best, second
