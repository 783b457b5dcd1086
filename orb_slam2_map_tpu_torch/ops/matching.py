"""Descriptor matching: Hamming distance + gated nearest neighbour.

Port of orb_slam2_map_tpu/ops/matching.py (reference: src/ORBmatcher.cc).
Every Search* variant decomposes into the same primitives: all-pairs
Hamming distance, a candidate gate (search window, scale band, stereo
column, epipolar distance), and gated nearest-neighbour selection with
the ratio test, duplicate resolution and the rotation-histogram filter.

`hamming_matrix` and `gated_nn` are the kernel entries: on CUDA tensors
they launch the hand-written Hopper kernels (ops/hamming_cuda.py,
csrc/hamming.cu; ops/gated_nn_cuda.py, csrc/gated_nn.cu); on CPU tensors
they run the plain versions beside them, `hamming_matrix_plain` and
`gated_nn_plain`.

Descriptors are [N, 8] int32 bit-views of the packed uint32 words.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .orb import top_k, unpack_bits

INF = 1e9
HISTO_LENGTH = 30  # rotation histogram bins (reference: src/ORBmatcher.cc:39)


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] packed -> [N, 256] float32 {-1, +1}."""
    return unpack_bits(desc).to(torch.float32) * 2.0 - 1.0


def hamming_matrix_plain(desc_a: torch.Tensor,
                         desc_b: torch.Tensor) -> torch.Tensor:
    """Plain version of the Hamming-matrix kernel: all-pairs distance
    [N, M] float32 = (256 - a.b) / 2 with a, b in {-1,+1}^256. Exact in
    float32 (integers <= 256)."""
    dot = unpack_pm1(desc_a) @ unpack_pm1(desc_b).T
    return (256.0 - dot) * 0.5


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance [N, M] float32 from packed [*, 8]
    descriptors. CUDA tensors go through the hand kernel, CPU tensors
    the plain version."""
    if desc_a.is_cuda:
        from . import hamming_cuda

        return hamming_cuda.hamming_matrix(desc_a.contiguous(),
                                           desc_b.contiguous())
    return hamming_matrix_plain(desc_a, desc_b)


def popcount_np(x: np.ndarray) -> np.ndarray:
    """Set bits of each word of a uint32 numpy array (host SWAR popcount;
    uint32 shifts are logical, unlike the int32 bit-views on the device)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_distance(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Rowwise Hamming distance [N] int between paired packed descriptors
    (bit unpacking: the SWAR popcount is wrong on int32 words with the
    top bit set, because int32 `>>` is arithmetic)."""
    return unpack_bits(torch.bitwise_xor(desc_a, desc_b)).sum(dim=-1)


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N] int64 best column per row (meaningful where ok)
    dist: torch.Tensor   # [N] float32 best distance
    ok: torch.Tensor     # [N] bool


def gated_nn_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   gate: torch.Tensor):
    """Plain version of the gated-NN kernel: per query row, the gated
    Hamming distance's (idx, best, second). Gated pairs count 1e9; idx is
    the lowest column reaching best (0 when best >= 1e9); second is the
    min over every other column, capped at 1e9."""
    d = torch.where(gate, hamming_matrix_plain(desc_a, desc_b), INF)
    if d.shape[1] == 0:
        full = torch.full((d.shape[0],), INF, device=d.device)
        return torch.zeros(d.shape[0], dtype=torch.int32, device=d.device), \
            full, full.clone()
    best = d.amin(dim=1)
    col = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(d == best[:, None], col, d.shape[1]).amin(dim=1)
    idx = torch.where(best >= INF, 0, idx)
    second = d.scatter(1, idx[:, None], INF).amin(dim=1)
    return idx.to(torch.int32), best, second


def gated_nn(desc_a: torch.Tensor, desc_b: torch.Tensor,
             gate: torch.Tensor, max_dist: float = 256.0,
             ratio: Optional[float] = None) -> MatchResult:
    """Fused distance + gated nearest neighbor: the common core of every
    Search* variant, with Lowe's ratio test best < ratio * second. CUDA
    tensors go through the hand kernel, CPU tensors the plain version."""
    if desc_a.is_cuda:
        from . import gated_nn_cuda

        idx, best, second = gated_nn_cuda.gated_nn(desc_a, desc_b, gate)
    else:
        idx, best, second = gated_nn_plain(desc_a, desc_b, gate)
    ok = best <= max_dist
    if ratio is not None:
        ok &= best < ratio * second
    return MatchResult(idx=idx.long(), dist=best, ok=ok)


def masked_nn(dist: torch.Tensor, gate: Optional[torch.Tensor] = None,
              max_dist: float = 256.0, ratio: Optional[float] = None,
              cross_check: bool = False) -> MatchResult:
    """Nearest neighbor per row of a gated distance matrix (first index
    on ties). ratio: Lowe's test best < ratio * second_best. cross_check:
    also require the row to be its column's best."""
    d = dist if gate is None else torch.where(gate, dist, INF)
    best, idx = torch.min(d, dim=1)
    ok = best <= max_dist
    if ratio is not None:
        second = d.scatter(1, idx[:, None], INF).amin(dim=1)
        ok &= best < ratio * second
    if cross_check:
        col_best = torch.argmin(d, dim=0)
        ok &= col_best[idx] == torch.arange(d.shape[0], device=d.device)
    return MatchResult(idx=idx, dist=best, ok=ok)


def resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor,
                       ok: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Keep only the lowest-distance row per matched column, lowest row
    on ties (the reference evicts worse duplicate matches, e.g.
    src/ORBmatcher.cc:110-121). Returns the updated ok mask."""
    n = idx.shape[0]
    dev = idx.device
    col = torch.where(ok, idx.long(), n_cols)
    d = torch.where(ok, dist, INF)
    best_dist = torch.full((n_cols + 1,), INF, device=dev).scatter_reduce(
        0, col, d, "amin", include_self=True)
    cand = ok & (d == best_dist[col])
    rowid = torch.arange(n, device=dev)
    big = 2 ** 30
    best_row = torch.full((n_cols + 1,), big, dtype=torch.int64,
                          device=dev).scatter_reduce(
        0, col, torch.where(cand, rowid, big), "amin", include_self=True)
    return cand & (best_row[col] == rowid)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor,
                         idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Rotation-histogram filter: keep matches whose angle difference
    falls in one of the 3 most populated of 30 bins (reference:
    src/ORBmatcher.cc:1601-1642 ComputeThreeMaxima)."""
    diff = angle_a - angle_b[idx]
    two_pi = 2.0 * math.pi
    # floored modulo with jnp.mod's rounding: fmod, then shift negatives
    diff = torch.fmod(diff, two_pi)
    diff = torch.where(diff < 0, diff + two_pi, diff)
    bins = torch.clamp((diff * HISTO_LENGTH / two_pi).to(torch.int64),
                       0, HISTO_LENGTH - 1)
    # scatter-add rather than bincount: bincount syncs with the host on CUDA
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=ok.device)
    hist = hist.scatter_add(0, bins, ok.to(torch.int32))
    top3_vals, top3_idx = top_k(hist, 3)
    # reference keeps bin2/bin3 only if >= 0.1 * max count
    keep2 = top3_vals[1] >= 0.1 * top3_vals[0]
    keep3 = top3_vals[2] >= 0.1 * top3_vals[0]
    in1 = bins == top3_idx[0]
    in2 = (bins == top3_idx[1]) & keep2
    in3 = (bins == top3_idx[2]) & keep3
    return ok & (in1 | in2 | in3)


# ---------------------------------------------------------------------------
# Candidate gates
# ---------------------------------------------------------------------------

def window_gate(query_uv: torch.Tensor, kp_xy: torch.Tensor,
                radius: torch.Tensor) -> torch.Tensor:
    """[N_query, N_kp] True where kp within +-radius box of query point
    (the reference's GetFeaturesInArea grid query, src/Frame.cc:327-393).
    radius: [N_query] or a scalar."""
    dx = torch.abs(query_uv[:, None, 0] - kp_xy[None, :, 0])
    dy = torch.abs(query_uv[:, None, 1] - kp_xy[None, :, 1])
    r = torch.as_tensor(radius, dtype=query_uv.dtype, device=query_uv.device)
    r = r[:, None] if r.ndim == 1 else r
    return (dx <= r) & (dy <= r)


def level_gate(query_level: torch.Tensor, kp_level: torch.Tensor,
               min_delta: int = 0, max_delta: int = 1) -> torch.Tensor:
    """[N_query, N_kp] scale-band gate: kp_level in
    [query_level + min_delta, query_level + max_delta]."""
    d = kp_level[None, :] - query_level[:, None]
    return (d >= min_delta) & (d <= max_delta)


def stereo_gate(query_ur: torch.Tensor, kp_ur: torch.Tensor,
                radius: torch.Tensor) -> torch.Tensor:
    """Right-image column agreement for stereo/RGB-D points (reference:
    src/ORBmatcher.cc:1413-1417). kp_ur < 0 = monocular kp (passes)."""
    d = torch.abs(query_ur[:, None] - kp_ur[None, :])
    return (kp_ur[None, :] < 0) | (d <= radius[:, None])


def epipolar_gate(kp1_xy: torch.Tensor, kp2_xy: torch.Tensor,
                  F12: torch.Tensor, sigma2_level2: torch.Tensor) -> torch.Tensor:
    """[N1, N2] epipolar distance gate for triangulation matching
    (reference: src/ORBmatcher.cc:140-157 CheckDistEpipolarLine, gate
    dsqr < 3.84 * sigma2 of kp2's level)."""
    ones1 = torch.ones((kp1_xy.shape[0], 1), dtype=kp1_xy.dtype,
                       device=kp1_xy.device)
    lines = torch.cat([kp1_xy, ones1], dim=1) @ F12.T        # epilines in img2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    den = a * a + b * b
    dist_num = a * kp2_xy[None, :, 0] + b * kp2_xy[None, :, 1] + c
    dsqr = dist_num * dist_num / torch.where(den < 1e-12, 1e-12, den)
    return dsqr < 3.84 * sigma2_level2[None, :]
