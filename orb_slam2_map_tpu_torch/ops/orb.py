"""Batched ORB feature extraction: keypoints + oriented BRIEF descriptors.

Port of orb_slam2_map_tpu/ops/orb.py (reference: src/ORBextractor.cc:
1043-1105 operator(), :765-853 ComputeKeyPointsOctTree, :77-147 IC_Angle
+ rBRIEF): per-level FAST + NMS, per-cell top-4 with rank-major
priority in place of the reference's quadtree, IC angle, steered BRIEF.

Descriptors are [N, 8] torch.int32 bit-views of the packed uint32 words
(torch has no usable uint32 arithmetic): bit j of word w is test
32*w + j. `np_u32.view(np.int32)` converts to and from the JAX layout.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ORBConfig
from . import fast, pyramid

HALF_PATCH = 15           # IC-angle circular patch radius (ref: :73)
BRIEF_N_TESTS = 256
BRIEF_PATCH = 48          # gather patch side for descriptor sampling
BRIEF_HALF = BRIEF_PATCH // 2


class Keypoints(NamedTuple):
    """Fixed-capacity SoA keypoint set for one image (device tensors)."""

    xy: torch.Tensor        # [N, 2] float32, level-0 (full-res) pixel coords
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int32 pyramid level
    desc: torch.Tensor      # [N, 8] int32 bit-view of packed rBRIEF
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self):
        return self.xy.shape[0]


# ---------------------------------------------------------------------------
# rBRIEF pattern (generated, deterministic) — verbatim from the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) test-pair offsets.

    Gaussian BRIEF pairs (Calonder et al. recipe: p, q ~ N(0, (S/5)^2)),
    seeded for determinism, deduplicated, clipped to +-13 so rotated
    samples stay within the gather patch.
    """
    rng = np.random.default_rng(20240917)
    sigma = 31 / 5.0
    pts = []
    seen = set()
    while len(pts) < BRIEF_N_TESTS:
        p = np.clip(np.round(rng.normal(0, sigma, 4)), -13, 13).astype(np.int32)
        key = tuple(p)
        if key in seen or (p[0] == p[2] and p[1] == p[3]):
            continue
        seen.add(key)
        pts.append(p)
    return np.asarray(pts, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def _ic_angle_masks() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular-patch mask and x/y coordinate grids for IC-angle moments
    (reference: src/ORBextractor.cc:77-104 uses per-row u_max bounds; the
    dense mask form is identical)."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs * xs + ys * ys) <= r * r
    return (mask.astype(np.float32), xs.astype(np.float32) * mask,
            ys.astype(np.float32) * mask)


@functools.lru_cache(maxsize=None)
def _brief_points(device: torch.device) -> torch.Tensor:
    """[512, 2] float32 (x, y) sample offsets: first points, then second
    points of the 256 tests. Cached per device: a host->device copy in
    the middle of a frame would wait for every queued launch."""
    pat = torch.as_tensor(brief_pattern())
    return torch.cat([pat[:, :2], pat[:, 2:]], dim=0).to(
        device=device, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ic_moment_grids(device: torch.device):
    _, mx, my = _ic_angle_masks()
    return torch.as_tensor(mx, device=device), torch.as_tensor(my, device=device)


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` semantics along the last dim: the k largest values,
    equal values in ascending index order. torch.topk promises no tie
    order, so this is a stable descending sort, sliced."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] {0,1} -> [N, 8] int32 bit-views. Packs in int64 (bit 31
    overflows int32) and wraps to the two's-complement int32 pattern."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.to(torch.int64).reshape(-1, 8, 32) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 bit-views -> [N, 256] int32 {0, 1}. `>>` on int32 is
    arithmetic, but bit s of (w >> s) & 1 is still bit s of w."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)


# ---------------------------------------------------------------------------
# Per-level keypoint detection with spatial balancing
# ---------------------------------------------------------------------------

def detect_level(img: torch.Tensor, n_keep: int, cfg: ORBConfig):
    """Detect up to n_keep FAST keypoints on one pyramid level.

    Returns (xy [n_keep, 2] float32 level coords, response [n_keep],
    valid [n_keep] bool). Cells that found nothing at iniThFAST retry at
    minThFAST (reference: src/ORBextractor.cc:791-801).
    """
    H, W = img.shape
    dev = img.device
    border = cfg.edge_threshold - 3  # FAST evaluated inside this margin (:770)
    cs = cfg.cell_size

    smap = fast.fast_score_map(img)
    nms = fast.nms3(smap)
    score_hi = torch.where(nms > float(cfg.ini_th_fast), nms, 0.0)
    score_lo = torch.where(nms > float(cfg.min_th_fast), nms, 0.0)

    rr = torch.arange(H, device=dev)[:, None]
    cc = torch.arange(W, device=dev)[None, :]
    inb = (rr >= border) & (rr < H - border) & (cc >= border) & (cc < W - border)
    score_hi = torch.where(inb, score_hi, 0.0)
    score_lo = torch.where(inb, score_lo, 0.0)

    # pad to cell multiples, reshape into cells
    Hp = (H + cs - 1) // cs * cs
    Wp = (W + cs - 1) // cs * cs
    pad_h, pad_w = Hp - H, Wp - W
    ncy, ncx = Hp // cs, Wp // cs

    def cells(s):
        s = F.pad(s, (0, pad_w, 0, pad_h))
        return s.reshape(ncy, cs, ncx, cs).permute(0, 2, 1, 3).reshape(
            ncy * ncx, cs * cs)

    sh_c, sl_c = cells(score_hi), cells(score_lo)
    has_hi = sh_c.amax(dim=1) > 0.0
    cell_scores = torch.where(has_hi[:, None], sh_c, sl_c)   # [C, cs*cs]

    # per-cell top-R candidates (quadtree stand-in)
    R = 4
    top_vals, top_idx = top_k(cell_scores, R)                # [C, R]
    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    py = (cell_ids // ncx) * cs + top_idx // cs
    px = (cell_ids % ncx) * cs + top_idx % cs

    vals = top_vals.reshape(-1)
    pys_i = py.reshape(-1)
    pxs_i = px.reshape(-1)
    ranks = torch.arange(R, device=dev)[None, :].expand(top_vals.shape).reshape(-1)

    # sub-pixel refinement: 1D quadratic fits on the pre-NMS score map
    # around each peak (an improvement over the reference's integer
    # FAST positions, src/ORBextractor.cc:819-827)
    score_full = F.pad(torch.where(smap > float(cfg.min_th_fast), smap, 0.0),
                       (1, 1 + pad_w, 1, 1 + pad_h))
    yc = pys_i + 1
    xc = pxs_i + 1
    s_c = score_full[yc, xc]
    s_l = score_full[yc, xc - 1]
    s_r = score_full[yc, xc + 1]
    s_u = score_full[yc - 1, xc]
    s_d = score_full[yc + 1, xc]
    denx = 2.0 * s_c - s_l - s_r
    deny = 2.0 * s_c - s_u - s_d
    okx = torch.abs(denx) > 1e-6
    oky = torch.abs(deny) > 1e-6
    dx = torch.where(okx, 0.5 * (s_r - s_l) / torch.where(okx, denx, 1.0), 0.0)
    dy = torch.where(oky, 0.5 * (s_d - s_u) / torch.where(oky, deny, 1.0), 0.0)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    pxs = pxs_i.to(torch.float32) + dx
    pys = pys_i.to(torch.float32) + dy

    valid = vals > 0.0
    # rank-major priority: all best-in-cell first, then second-best, ...
    priority = torch.where(valid, -ranks.to(torch.float32) * 1e6 + vals,
                           -torch.inf)
    k = min(n_keep, vals.shape[0])
    sel_p, sel_i = top_k(priority, k)
    xy = torch.stack([pxs[sel_i], pys[sel_i]], dim=-1)
    resp = vals[sel_i]
    ok = torch.isfinite(sel_p)
    if k < n_keep:  # capacity exceeds candidates; pad
        pad = n_keep - k
        xy = torch.cat([xy, torch.full((pad, 2), float(border), device=dev)])
        resp = torch.cat([resp, torch.zeros(pad, device=dev)])
        ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool, device=dev)])
    xy = torch.where(ok[:, None], xy, float(border + 1))
    return xy, resp, ok


# ---------------------------------------------------------------------------
# Orientation + descriptors (per level, fixed capacity)
# ---------------------------------------------------------------------------

def _gather_at_offsets(img: torch.Tensor, xy: torch.Tensor,
                       dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Sample img at (trunc(xy) + (dy, dx)) with edge clamping.
    xy [N, 2] float level coords; dx/dy [N, K] integer offsets -> [N, K]."""
    H, W = img.shape
    cx = xy[:, 0].to(torch.int64)[:, None]                 # trunc
    cy = xy[:, 1].to(torch.int64)[:, None]
    ax = torch.clamp(cx + dx, 0, W - 1)
    ay = torch.clamp(cy + dy, 0, H - 1)
    return img.reshape(-1)[(ay * W + ax).reshape(-1)].reshape(ax.shape)


def _gather_patches(img: torch.Tensor, xy: torch.Tensor, half: int):
    """[N, 2*half+1, 2*half+1] patches centered at trunc(xy) (level
    coords) of the edge-padded image. Start indices are clamped into the
    padded image, as lax.dynamic_slice clamps them."""
    size = 2 * half + 1
    padded = F.pad(img[None, None], (half, half, half, half),
                   mode="replicate")[0, 0]
    Hp, Wp = padded.shape
    c = xy.to(torch.int64)
    r0 = torch.clamp(c[:, 1], 0, Hp - size)
    c0 = torch.clamp(c[:, 0], 0, Wp - size)
    off = torch.arange(size, device=img.device)
    rows = (r0[:, None] + off)[:, :, None]
    cols = (c0[:, None] + off)[:, None, :]
    return padded[rows, cols]


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint [N] (radians)."""
    mx, my = _ic_moment_grids(img.device)
    patches = _gather_patches(img, xy, HALF_PATCH)          # [N, 31, 31]
    m10 = torch.einsum("nij,ij->n", patches, mx)
    m01 = torch.einsum("nij,ij->n", patches, my)
    return torch.arctan2(m01, m10)


def brief_descriptors(img_blurred: torch.Tensor, xy: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 -> [N, 8] int32 packed descriptors (steered
    BRIEF, reference computeOrbDescriptor src/ORBextractor.cc:108-147:
    rotate the 512 pattern points by the keypoint angle, sample nearest
    neighbor, compare, pack bits)."""
    pts = _brief_points(xy.device)                          # [512, 2]

    ca, sa = torch.cos(angle), torch.sin(angle)
    rx = pts[None, :, 0] * ca[:, None] - pts[None, :, 1] * sa[:, None]
    ry = pts[None, :, 0] * sa[:, None] + pts[None, :, 1] * ca[:, None]
    dx = torch.round(rx).to(torch.int64)                    # [N, 512]
    dy = torch.round(ry).to(torch.int64)

    samples = _gather_at_offsets(img_blurred, xy, dx, dy)   # [N, 512]
    bits = samples[:, :BRIEF_N_TESTS] < samples[:, BRIEF_N_TESTS:]
    return pack_bits(bits)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

def _level_capacities(cfg: ORBConfig) -> List[int]:
    caps = cfg.features_per_level()
    # each level's capacity rounded up to a multiple of 8
    return [max(8, (c + 7) // 8 * 8) for c in caps]


def extract(img: torch.Tensor, cfg: ORBConfig) -> Keypoints:
    """Full ORB extraction for one grayscale image [H, W] float32
    (reference: src/ORBextractor.cc:1043-1105): pyramid -> per-level
    FAST+balance -> IC angle on the raw level -> Gaussian blur -> rBRIEF;
    keypoint coords scaled back to level 0."""
    levels = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    caps = _level_capacities(cfg)
    scale = cfg.scale_factor

    xs, rs, angs, lvls, descs, oks = [], [], [], [], [], []
    for lvl, (im, cap) in enumerate(zip(levels, caps)):
        xy, resp, ok = detect_level(im, cap, cfg)
        ang = ic_angles(im, xy)
        blurred = pyramid.gaussian_blur(im)
        desc = brief_descriptors(blurred, xy, ang)
        xs.append(xy * scale ** lvl)
        rs.append(resp)
        angs.append(ang)
        lvls.append(torch.full((cap,), lvl, dtype=torch.int32, device=img.device))
        descs.append(desc)
        oks.append(ok)

    return Keypoints(
        xy=torch.cat(xs), response=torch.cat(rs), angle=torch.cat(angs),
        level=torch.cat(lvls), desc=torch.cat(descs), valid=torch.cat(oks),
    )


def total_capacity(cfg: ORBConfig) -> int:
    return sum(_level_capacities(cfg))
