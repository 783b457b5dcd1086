"""Stereo keypoint matching: epipolar-row descriptor match + SAD refine.

Port of orb_slam2_map_tpu/ops/stereo.py, replacing
Frame::ComputeStereoMatches (reference: src/Frame.cc:466-638): for each
left keypoint, search right keypoints on the same (scale-tolerant) row
within the disparity range, take the best Hamming match, then refine the
disparity to sub-pixel with an 11x11 SAD window slid +-5 px and a
parabola fit.

The candidate search is one gated [N, N] Hamming matrix (the hand kernel
csrc/hamming.cu on the card, ops/matching.py:hamming_matrix); the SAD
refine gathers one 11x21 strip per keypoint and evaluates all 11 shifts
as one tensor op.

Two behaviours of the JAX package are kept as they are:
* its gathers are `lax.dynamic_slice`s, which clamp the start index into
  the padded image: a strip near the border (or centred on the
  meaningless match of an unmatched row) is shifted, not cut;
* its median-cost outlier gate (reference :604-637 rejects costs above
  1.5 * 1.4 * median) takes `jnp.median` over all N slots with NaN at the
  unmatched ones. NaN propagates, so as soon as one slot is unmatched
  (padding always is) the median is replaced by 1e9 and nothing is
  rejected; with every slot matched, an even count averages the two
  middle values. `_jax_median_gate` reproduces exactly that.
"""

from __future__ import annotations

import torch

from ..config import SystemConfig
from ..geom import camera as cam_mod
from ..utils import profiling
from . import matching, orb

SAD_W = 5          # half window (11x11), reference :547
SAD_SHIFT = 5      # +- disparity slide L, reference :549
BIG = 1e9


def _gather(img_p: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            height: int, width: int) -> torch.Tensor:
    """[N, height, width] windows of img_p with top-left corners (x, y):
    float -> int32 truncates, and the start is clamped into the image,
    as lax.dynamic_slice does."""
    H, W = img_p.shape
    y0 = torch.clamp(y.to(torch.int32).long(), 0, H - height)
    x0 = torch.clamp(x.to(torch.int32).long(), 0, W - width)
    rows = y0[:, None] + torch.arange(height, device=img_p.device)
    cols = x0[:, None] + torch.arange(width, device=img_p.device)
    return img_p[rows[:, :, None], cols[:, None, :]]


def _jax_median_gate(ok: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The JAX package's median reference: jnp.median over all slots of
    where(ok, cost, nan), with NaN mapped to 1e9. Any unmatched slot
    gives 1e9; otherwise the median, averaging the two middle values of
    an even count."""
    n = cost.shape[0]
    if n == 0:
        return torch.full((), BIG, device=cost.device)
    s = torch.sort(cost).values
    med = s[n // 2] if n % 2 else 0.5 * s[n // 2 - 1] + 0.5 * s[n // 2]
    return torch.where(ok.all(), med, BIG)


def _stereo_match(cfg: SystemConfig, kp_l: orb.Keypoints, kp_r: orb.Keypoints,
                  img_l: torch.Tensor, img_r: torch.Tensor):
    """Returns (ur [N], depth [N]) for left keypoints; -1 where unmatched."""
    cam = cfg.camera
    dev = img_l.device
    sf = torch.as_tensor(cfg.orb.scale_factors, dtype=torch.float32,
                         device=dev)
    min_z = cam.baseline
    min_d = 0.0
    max_d = cam.bf / min_z

    # row band: |v_l - v_r| <= 2 * scale of left kp level (reference :489)
    row_tol = 2.0 * sf[kp_l.level.long()]
    dv = torch.abs(kp_l.xy[:, 1:2] - kp_r.xy[None, :, 1])
    disparity = kp_l.xy[:, 0:1] - kp_r.xy[None, :, 0]
    gate = ((dv <= row_tol[:, None])
            & (disparity >= min_d) & (disparity <= max_d)
            & matching.level_gate(kp_l.level, kp_r.level, -1, 1)
            & kp_l.valid[:, None] & kp_r.valid[None, :])
    dmat = matching.hamming_matrix(kp_l.desc, kp_r.desc)
    res = matching.masked_nn(dmat, gate, max_dist=100.0)

    # SAD sub-pixel refinement on level-0 images (the reference works per
    # pyramid level; level 0 with fixed windows, as in the JAX package)
    uL = kp_l.xy[:, 0]
    vL = kp_l.xy[:, 1]
    uR0 = kp_r.xy[res.idx, 0]

    half = SAD_W
    width = 2 * half + 1
    strip_w = width + 2 * SAD_SHIFT
    pad = half + SAD_SHIFT + 1
    img_l_p = torch.nn.functional.pad(img_l[None, None], (pad,) * 4,
                                      mode="replicate")[0, 0]
    img_r_p = torch.nn.functional.pad(img_r[None, None], (pad,) * 4,
                                      mode="replicate")[0, 0]

    # left template [N, 11, 11] at (uL, vL); right strip [N, 11, 21] at
    # (uR0, vL)
    tl = _gather(img_l_p, uL - half + pad, vL - half + pad, width, width)
    sr = _gather(img_r_p, uR0 - half - SAD_SHIFT + pad, vL - half + pad,
                 width, strip_w)
    # normalize by the centre pixel (reference divides by it, :551)
    tl_n = tl / torch.clamp(tl[:, half, half], min=1.0)[:, None, None]
    sr_n = sr / torch.clamp(sr[:, half, SAD_SHIFT + half], min=1.0)[:, None, None]

    # SAD over 11 shifts: windows [N, 11 shifts, 11, 11]
    windows = sr_n.unfold(2, width, 1).permute(0, 2, 1, 3)
    sad = torch.abs(windows - tl_n[:, None]).sum(dim=(2, 3))      # [N, S]
    best_cost, best_s = torch.min(sad, dim=1)

    # parabola fit around the minimum (reference :583-594)
    last = 2 * SAD_SHIFT
    sm1 = sad.gather(1, torch.clamp(best_s - 1, 0, last)[:, None])[:, 0]
    sp1 = sad.gather(1, torch.clamp(best_s + 1, 0, last)[:, None])[:, 0]
    denom = sm1 + sp1 - 2 * best_cost
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (sm1 - sp1) / torch.clamp(denom, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    interior = (best_s > 0) & (best_s < last)
    delta = torch.where(interior, delta, 0.0)

    u_r = uR0 + (best_s.to(torch.float32) - SAD_SHIFT) + delta
    disp = uL - u_r
    ok = res.ok & (disp > min_d) & (disp < max_d)

    # median-cost outlier gate, dead as in the JAX package (module doc)
    costs = torch.where(ok, best_cost, BIG)
    ok = ok & (costs <= 1.5 * 1.4 * _jax_median_gate(ok, best_cost))

    depth = torch.where(ok, cam.bf / torch.clamp(disp, min=1e-6), -1.0)
    ur = torch.where(ok, u_r, -1.0)
    return ur, depth


def build_stereo_frame(cfg: SystemConfig, gray_left: torch.Tensor,
                       gray_right: torch.Tensor):
    """Stereo frame from [H, W] float32 left/right tensors: two
    extractions (the reference's two extraction threads, src/Frame.cc:
    78-81) + row SAD matching."""
    from ..slam.frame import Frame, _identity_pose, _inv_sigma2_on

    with profiling.stage("stereo/extract"):
        kp_l = orb.extract(gray_left, cfg.orb)
        kp_r = orb.extract(gray_right, cfg.orb)
    with profiling.stage("stereo/match"):
        ur, depth = _stereo_match(cfg, kp_l, kp_r, gray_left, gray_right)

    cam = cfg.camera
    xy_und = (cam_mod.undistort_points(cam, kp_l.xy)
              if cam.has_distortion else kp_l.xy)
    inv_s2 = _inv_sigma2_on(cfg, gray_left.device)[kp_l.level]
    R, t = _identity_pose()
    return Frame(xy=xy_und, response=kp_l.response, angle=kp_l.angle,
                 level=kp_l.level, desc=kp_l.desc, valid=kp_l.valid,
                 ur=ur, depth=depth, inv_sigma2=inv_s2, R=R, t=t)
