"""Image pyramid + Gaussian blur.

Port of orb_slam2_map_tpu/ops/pyramid.py: ORBextractor::ComputePyramid
(reference: src/ORBextractor.cc:1107-1132 — 8 levels, scale 1.2,
bilinear resize) and the pre-descriptor 7x7 sigma=2 Gaussian blur
(reference: src/ORBextractor.cc:1084-1090). Images are [H, W] float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_sizes(height: int, width: int, n_levels: int,
                scale_factor: float) -> List[Tuple[int, int]]:
    sizes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        sizes.append((int(round(height * s)), int(round(width * s))))
    return sizes


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect padding, [H, W] float32, as
    shifted-slice weighted sums (the same summation order as the JAX
    package, so results agree to rounding)."""
    k = gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="reflect")[0, 0]
    x = sum(float(k[i]) * x[i:i + H, :] for i in range(ksize))
    x = F.pad(x[None, None], (pad, pad, 0, 0), mode="reflect")[0, 0]
    x = sum(float(k[i]) * x[:, i:i + W] for i in range(ksize))
    return x


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]):
    """cv::resize(INTER_LINEAR)-compatible bilinear resample."""
    H, W = img.shape
    oh, ow = out_hw
    dev = img.device
    # OpenCV convention: src = (dst + 0.5) * scale - 0.5
    sy = H / oh
    sx = W / ow
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * sy - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * sx - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=H - 1)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    top = img[y0i, :]
    bot = img[y1i, :]
    row = top * (1 - wy)[:, None] + bot * wy[:, None]
    left = row[:, x0i]
    right = row[:, x1i]
    return left * (1 - wx)[None, :] + right * wx[None, :]


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """Returns list of [H_l, W_l] float32 images, level 0 = input, each
    level resized from the previous one (reference: src/ORBextractor.cc:
    1113-1124)."""
    sizes = level_sizes(img.shape[0], img.shape[1], n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], sizes[lvl]))
    return levels
