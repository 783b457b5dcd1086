"""Tensor programs of the local-mapping stage.

Port of orb_slam2_map_tpu/slam/mapping_kernels.py. The reference's
CreateNewMapPoints / SearchInNeighbors inner loops (reference:
src/LocalMapping.cc:207-452, :454-534 with the epipolar and Fuse
matchers of src/ORBmatcher.cc) run here as one masked program per
keyframe pair over the full keypoint capacity; the host slices the
results with numpy masks afterwards.

The JAX package vmaps the pair program over the neighbours; here the
`_batch` forms loop over them, one gated-NN kernel launch
(csrc/gated_nn.cu) per pair, and stack the results. The JAX package
also pads candidate point sets to power-of-two buckets so that XLA
compiles one program per bucket; PyTorch compiles nothing, and padded
rows are gated out and change no result, so the port takes the sets as
they come.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SystemConfig
from ..geom import se3
from ..ops import matching
from ..optim import triangulate


class TriangulatePairResult(NamedTuple):
    kp2_idx: torch.Tensor   # [N] matched keypoint in KF2 per KF1 keypoint
    ok: torch.Tensor        # [N] match accepted + all gates passed
    X: torch.Tensor         # [N, 3] triangulated world points


def _table(values, device) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def triangulate_pair(cfg: SystemConfig, R1, t1, R2, t2,
                     xy1, level1, desc1, free1, ur1,
                     xy2, level2, desc2, free2, ur2) -> TriangulatePairResult:
    """Epipolar-gated matching + DLT triangulation + acceptance gates for
    one keyframe/neighbour pair at full keypoint capacity (reference:
    src/LocalMapping.cc:207-452 with SearchForTriangulation,
    src/ORBmatcher.cc:657-823)."""
    cam = cfg.camera
    lcfg = cfg.local_mapping
    dev = xy1.device
    sigma2 = _table(cfg.orb.level_sigma2, dev)
    level1, level2 = level1.long(), level2.long()

    # fundamental matrix F12 (reference: src/LocalMapping.cc:536-553)
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    t12x = se3.hat(t12)
    Kinv = torch.linalg.inv(cam.K).to(dev)
    F12 = Kinv.T @ t12x @ R12 @ Kinv

    gate = (matching.epipolar_gate(xy1, xy2, F12.T, sigma2[level2])
            & free1[:, None] & free2[None, :])
    res = matching.gated_nn(desc1, desc2, gate, max_dist=50.0)
    ok = matching.resolve_duplicates(res.idx, res.dist, res.ok,
                                     xy2.shape[0])

    P1 = triangulate.projection_matrix(cam, R1, t1)
    P2 = triangulate.projection_matrix(cam, R2, t2)
    xy2_m = xy2[res.idx]
    X = triangulate.triangulate_dlt(P1, P2, xy1, xy2_m)
    good = triangulate.acceptance_gates(
        cam, R1, t1, R2, t2, X, xy1, xy2_m, ur1, ur2[res.idx],
        sigma2[level1], sigma2[level2[res.idx]],
        chi2_mono=lcfg.chi2_mono, chi2_stereo=lcfg.chi2_stereo)
    return TriangulatePairResult(kp2_idx=res.idx, ok=ok & good, X=X)


class FuseMatchResult(NamedTuple):
    kp_idx: torch.Tensor    # [C] matched keypoint per candidate point
    ok: torch.Tensor        # [C]


def fuse_match(cfg: SystemConfig, R, t, mp_pos, mp_desc,
               mp_min_dist, mp_max_dist, mp_valid,
               kf_xy, kf_level, kf_valid, kf_desc,
               th: float = 3.0) -> FuseMatchResult:
    """Project candidate map points into a keyframe and match against its
    keypoints (reference Fuse, src/ORBmatcher.cc:825-975): frustum +
    distance band + predicted-scale window + level band + Hamming NN."""
    cam = cfg.camera
    n_levels = cfg.orb.n_levels
    sf = _table(cfg.orb.scale_factors, mp_pos.device)
    log_sf = torch.log(torch.tensor(cfg.orb.scale_factor,
                                    dtype=torch.float32))

    Xc = se3.act(R, t, mp_pos)
    z = Xc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    _, twc = se3.inverse(R, t)
    dist = torch.linalg.norm(mp_pos - twc[None, :], dim=-1)
    visible = (mp_valid & (z > 0.05)
               & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
               & (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist))

    ratio = torch.clamp(mp_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred = torch.clamp(torch.ceil(torch.log(ratio) / log_sf.to(ratio.device))
                       .to(torch.int32), 0, n_levels - 1)
    radius = th * sf[pred.long()]

    uvq = torch.stack([u, v], dim=1)
    gate = (matching.window_gate(uvq, kf_xy, radius)
            & matching.level_gate(pred, kf_level, min_delta=-1, max_delta=0)
            & visible[:, None] & kf_valid[None, :])
    res = matching.gated_nn(mp_desc, kf_desc, gate, max_dist=50.0)
    keep = matching.resolve_duplicates(res.idx, res.dist, res.ok,
                                       kf_xy.shape[0])
    return FuseMatchResult(kp_idx=res.idx, ok=keep)


def triangulate_pairs_batch(cfg: SystemConfig, R1, t1,
                            xy1, level1, desc1, free1, ur1,
                            R2s, t2s, xy2s, level2s, desc2s, free2s,
                            ur2s) -> TriangulatePairResult:
    """Every neighbour pair of one keyframe: a [B] leading axis of
    results. The host consumes them in neighbour order and drops
    keypoints already consumed by an earlier pair (the sequential free1
    update of reference src/LocalMapping.cc:207-452, applied post hoc)."""
    outs = [triangulate_pair(cfg, R1, t1, R2s[j], t2s[j], xy1, level1, desc1,
                             free1, ur1, xy2s[j], level2s[j], desc2s[j],
                             free2s[j], ur2s[j])
            for j in range(R2s.shape[0])]
    return TriangulatePairResult(*(torch.stack(x) for x in zip(*outs)))


def fuse_match_batch(cfg: SystemConfig, Rs, ts, mp_pos, mp_desc,
                     mp_min_dist, mp_max_dist, mp_valid,
                     kf_xys, kf_levels, kf_valids, kf_descs
                     ) -> FuseMatchResult:
    """The same candidate point set fused into many keyframes (the
    forward direction of SearchInNeighbors, reference:
    src/LocalMapping.cc:454-534): a [T] leading axis of results."""
    outs = [fuse_match(cfg, Rs[j], ts[j], mp_pos, mp_desc, mp_min_dist,
                       mp_max_dist, mp_valid, kf_xys[j], kf_levels[j],
                       kf_valids[j], kf_descs[j])
            for j in range(Rs.shape[0])]
    return FuseMatchResult(*(torch.stack(x) for x in zip(*outs)))
