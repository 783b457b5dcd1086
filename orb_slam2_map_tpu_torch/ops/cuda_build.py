"""Build, load and check the hand-written CUDA kernels of the port.

Each kernel source under csrc/ is compiled with nvcc for sm_90a into a
shared library with a plain C entry (no PyTorch headers, so a build
takes seconds) and bound with ctypes. A library is built on first use
into build/torch_kernels/ at the repository root, under a name keyed on
a hash of its source, every header under csrc/ and the flags, so an
edited .cu or .cuh rebuilds.
`build_all` starts one nvcc per source at once and waits for all.

There is no fallback: a missing nvcc, a failed build or a failed launch
raises.
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
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


class KernelLibrary:
    """One csrc/<name>.cu compiled to a shared library exporting `entry`
    with the given ctypes argument types (returning int: the CUDA error
    of the launch, 0 = ok). `source` overrides the .cu file (another
    version of a kernel, for a side-by-side timing)."""

    def __init__(self, name: str, entry: str, argtypes: Sequence,
                 source: Optional[Path] = None):
        self.name = name
        self.source = Path(source) if source else CSRC / f"{name}.cu"
        self.entry = entry
        self.argtypes = list(argtypes)
        self.build_log = ""       # nvcc's output of the build this process made
        self.build_seconds = 0.0  # its wall time (0 when already built)
        self._fn = None
        self._proc: Optional[subprocess.Popen] = None
        self._t0 = 0.0
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"

    def _tmp_path(self) -> Path:
        return self.library_path().with_suffix(f".{os.getpid()}.tmp.so")

    def start_build(self):
        """Start nvcc unless the library for this source exists."""
        if self._proc is not None or self.library_path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(self._tmp_path()),
               str(self.source)]
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)

    def finish_build(self) -> Path:
        """Wait for the build started by start_build (starting it if
        needed) and return the library's path."""
        self.start_build()
        out = self.library_path()
        if self._proc is None:
            return out
        proc, self._proc = self._proc, None
        log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - self._t0
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{log}")
        os.replace(self._tmp_path(), out)
        out.with_suffix(".log").write_text(log)
        return out

    def ptxas_summary(self) -> str:
        """The registers / shared-memory / spill lines ptxas printed
        (-Xptxas -v), from this process's build or the log kept beside
        the library."""
        log = self.build_log
        if not log and self.library_path().with_suffix(".log").exists():
            log = self.library_path().with_suffix(".log").read_text()
        return " | ".join(ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "smem" in ln
                          or "spill" in ln)

    def fn(self):
        """The bound C entry, building and loading the library once."""
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(self.finish_build()))
                f = getattr(lib, self.entry)
                f.argtypes = self.argtypes
                f.restype = ctypes.c_int
                self._fn = f
        return self._fn


def build_all(libs: Sequence[KernelLibrary]):
    """Build every library in parallel: one nvcc per source, all started
    together, then load each."""
    for lib in libs:
        lib.start_build()
    for lib in libs:
        lib.fn()


def check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name, t, alignment=16):
    if t.numel() and t.data_ptr() % alignment:
        raise ValueError(f"{name} must be {alignment}-byte aligned")


def require_cuda(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def stream_of(device) -> int:
    """The current CUDA stream of `device`, as the int ctypes passes."""
    return torch.cuda.current_stream(device).cuda_stream
