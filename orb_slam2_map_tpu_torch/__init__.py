"""orb_slam2_map_tpu_torch — the SLAM engine in PyTorch, for NVIDIA Hopper.

A port of `orb_slam2_map_tpu` (JAX/XLA/Pallas) that keeps its layout and
names module for module (`geom/`, `ops/`, `optim/`, `slam/`, `io/`), so
each function's counterpart is easy to find. Plain tensor code is
PyTorch; both Pallas kernels of the JAX package are hand-written CUDA
C++ for sm_90a under `csrc/`, built on first use (ops/cuda_build.py).

This package imports torch and numpy only: never jax, never the JAX
package. Ported: the RGB-D tracking slice (`slam.tracking.Tracker`) and
the stereo system with local mapping (`slam.system.SLAMSystem`, without
loop closing). Relocalization, loop closing, monocular, dense mapping
and the async pipeline are later slices (ROADMAP.md). Entry points run
on the CUDA card unless given `device="cpu"`.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry/optimization matmuls need full f32: reduced matmul precision
# (TF32 keeps ~10 mantissa bits) cost ~1.5 cm ATE on the synthetic
# benchmark in the JAX package. Descriptor matching is unaffected — the
# plain Hamming matmul multiplies +-1 vectors, exact in any of these.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
