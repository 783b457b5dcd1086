"""Vectorized FAST-9-16 corner detection.

Port of orb_slam2_map_tpu/ops/fast.py (reference: src/ORBextractor.cc:
769-829). The 16-pixel Bresenham ring is materialized as 16 shifted
views; the contiguous-arc-of-9 test is a log-depth reduction; the score
is the exact OpenCV cornerScore (max over arcs of the min ring
difference). Differences, mins and maxes of float32 are exact, so the
score map equals the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# FAST-16 Bresenham circle offsets (dr, dc), circularly ordered.
RING_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LENGTH = 9  # FAST-9: contiguous arc of >= 9 ring pixels


def ring_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W] ring pixel values via shifted slices of a padded image."""
    H, W = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    views = [p[3 + dr:3 + dr + H, 3 + dc:3 + dc + W] for dr, dc in RING_OFFSETS]
    return torch.stack(views, dim=0)


def _windowed_reduce(x: torch.Tensor, op, length: int) -> torch.Tensor:
    """Reduce op over all circular windows of `length` along dim 0 (16).
    Returns [16, H, W]: entry s = op over x[s:s+length] (circular)."""
    if length != 9:
        raise ValueError("only arc length 9 supported")
    ext = torch.cat([x, x[: length - 1]], dim=0)           # [24, H, W]
    r3 = op(op(ext[:-2], ext[1:-1]), ext[2:])             # [22, H, W]
    return op(op(r3[:16], r3[3:19]), r3[6:22])


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Threshold-independent FAST-9-16 corner score map [H, W]: the
    largest threshold t at which the pixel is still a corner."""
    ring = ring_stack(img)
    center = img[None]
    min_b = _windowed_reduce(ring - center, torch.minimum, ARC_LENGTH).amax(dim=0)
    min_d = _windowed_reduce(center - ring, torch.minimum, ARC_LENGTH).amax(dim=0)
    return torch.maximum(min_b, min_d)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep pixels equal to the local max.
    Ties broken toward the top-left pixel (strictly greater than earlier
    neighbors in raster order) so plateaus yield a single keypoint."""
    H, W = score.shape
    p = F.pad(score[None, None], (1, 1, 1, 1), mode="constant", value=-1.0)[0, 0]
    keep = torch.ones_like(score, dtype=torch.bool)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            nb = p[1 + dr:1 + dr + H, 1 + dc:1 + dc + W]
            if (dr < 0) or (dr == 0 and dc < 0):
                keep &= score > nb       # earlier neighbor: must beat it
            else:
                keep &= score >= nb      # later neighbor: ties OK
    return torch.where(keep, score, 0.0)
