"""Parity of the PyTorch port's local-mapping programs against the JAX
package, on the CPU, with the same seeded numpy inputs fed to both.

The scenes are synthetic: world points seen by two cameras of the small
test camera (320x240), keypoints at their noisy projections (plus
distractors), descriptors shared between the two views up to a few
flipped bits, half the keypoints with a stereo coordinate. Bounds:

* triangulate_dlt: points within 1e-3 relative to their range. Both
  solve the 3x3 normal equations in float32 by the adjugate; the
  products are summed in another order, and the normal equations square
  the conditioning of the DLT system.
* acceptance_gates on identical points, the matched keypoint indices
  and the `ok` masks of triangulate_pair / fuse_match and their batch
  forms: exact (selection outputs).
* local_ba: poses and points within 1e-3 (the LM's einsum reductions
  add in another order over 15 iterations), inlier masks exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_config
from orb_slam2_map_tpu.geom import se3 as jse3
from orb_slam2_map_tpu.optim import local_ba as jba
from orb_slam2_map_tpu.optim import triangulate as jtri
from orb_slam2_map_tpu.slam import mapping_kernels as jmk
from orb_slam2_map_tpu_torch.optim import local_ba as tba
from orb_slam2_map_tpu_torch.optim import triangulate as ttri
from orb_slam2_map_tpu_torch.slam import mapping_kernels as tmk

from test_torch_kernels import _t
from test_torch_orb import port_config

torch.set_num_threads(1)

X_RTOL = 1e-3
BA_ATOL = 1e-3


def _rot(rng, scale):
    R, _ = jse3.se3_exp(jnp.asarray(np.concatenate(
        [np.zeros(3), rng.normal(0, scale, 3)]).astype(np.float32)))
    return np.asarray(R)


def _project(cam, R, t, X):
    Xc = X @ R.T + t
    return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                     cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], 1), Xc[:, 2]


def _view(rng, cam, R, t, X, desc, n_cap):
    """Keypoint columns of one view at capacity n_cap: the visible
    points' noisy projections in random slots, distractors elsewhere."""
    uv, z = _project(cam, R, t, X)
    vis = ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
    pts = np.nonzero(vis)[0]
    slots = rng.permutation(n_cap)[:len(pts)]
    xy = rng.uniform([0, 0], [cam.width, cam.height], (n_cap, 2))
    xy[slots] = uv[pts] + rng.normal(0, 0.3, (len(pts), 2))
    d = rng.integers(0, 2 ** 32, (n_cap, 8), dtype=np.uint32)
    flip = (rng.uniform(size=(len(pts), 8)) < 0.3).astype(np.uint32) \
        << rng.integers(0, 32, (len(pts), 8)).astype(np.uint32)
    d[slots] = desc[pts] ^ flip
    level = rng.integers(0, 4, n_cap).astype(np.int32)
    ur = np.full(n_cap, -1.0)
    stereo = rng.uniform(size=len(pts)) < 0.5
    ur[slots[stereo]] = xy[slots[stereo], 0] - cam.bf / z[pts[stereo]]
    valid = np.ones(n_cap, bool)
    valid[rng.integers(0, n_cap, 20)] = False
    return dict(xy=xy.astype(np.float32), level=level, desc=d,
                ur=ur.astype(np.float32), valid=valid, slot_of=dict(
                    zip(pts.tolist(), slots.tolist())))


@pytest.fixture(scope="module")
def scene():
    cfg = small_config()
    cam = cfg.camera
    rng = np.random.default_rng(5)
    n_pts, n_cap = 300, 424
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(2.0, 6.0, n_pts)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    desc[::4, 0] |= np.uint32(0x80000000)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    for k in range(3):
        R = _rot(rng, 0.05).astype(np.float32)
        t = (rng.normal(0, 0.15, 3) + [0.25 * (k + 1), 0, 0]).astype(np.float32)
        poses.append((R, t))
    views = [_view(rng, cam, R, t, X, desc, n_cap) for R, t in poses]
    return cfg, X, desc, poses, views


def _pair_args(poses, views, i, j, rng):
    a, b = views[i], views[j]
    free1 = a["valid"] & (rng.uniform(size=len(a["valid"])) < 0.8)
    free2 = b["valid"] & (rng.uniform(size=len(b["valid"])) < 0.8)
    return (poses[i][0], poses[i][1], poses[j][0], poses[j][1],
            a["xy"], a["level"], a["desc"], free1, a["ur"],
            b["xy"], b["level"], b["desc"], free2, b["ur"])


def _port(args):
    return [_t(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args]


def test_triangulate_dlt_and_gates(scene):
    cfg, X, _, poses, views = scene
    cam = cfg.camera
    (R1, t1), (R2, t2) = poses[0], poses[2]
    x1, _ = _project(cam, R1, t1, X)
    x2, _ = _project(cam, R2, t2, X)
    rng = np.random.default_rng(11)
    x1 = (x1 + rng.normal(0, 0.5, x1.shape)).astype(np.float32)
    x2 = (x2 + rng.normal(0, 0.5, x2.shape)).astype(np.float32)
    P1j = jtri.projection_matrix(cam, jnp.asarray(R1), jnp.asarray(t1))
    P2j = jtri.projection_matrix(cam, jnp.asarray(R2), jnp.asarray(t2))
    tcam = port_config(cfg).camera
    P1t = ttri.projection_matrix(tcam, _t(R1), _t(t1))
    P2t = ttri.projection_matrix(tcam, _t(R2), _t(t2))
    np.testing.assert_allclose(P1t.numpy(), np.asarray(P1j), rtol=1e-6)
    Xj = np.asarray(jtri.triangulate_dlt(P1j, P2j, jnp.asarray(x1),
                                         jnp.asarray(x2)))
    Xt = ttri.triangulate_dlt(P1t, P2t, _t(x1), _t(x2)).numpy()
    rng_ = np.linalg.norm(Xj, axis=1)
    assert (np.linalg.norm(Xt - Xj, axis=1) <= X_RTOL * rng_).all()
    # both near the truth: the noise, not the solver, sets the error
    assert np.median(np.linalg.norm(Xj - X, axis=1) / rng_) < 0.05

    sig = np.asarray(cfg.orb.level_sigma2, np.float32)
    lv1 = views[0]["level"][:len(X)]
    lv2 = views[2]["level"][:len(X)]
    ur1 = np.where(np.arange(len(X)) % 2, -1.0, x1[:, 0] - 30.0).astype(np.float32)
    ur2 = np.full(len(X), -1.0, np.float32)
    gj = jtri.acceptance_gates(cam, jnp.asarray(R1), jnp.asarray(t1),
                               jnp.asarray(R2), jnp.asarray(t2),
                               jnp.asarray(Xj), jnp.asarray(x1),
                               jnp.asarray(x2), jnp.asarray(ur1),
                               jnp.asarray(ur2), jnp.asarray(sig[lv1]),
                               jnp.asarray(sig[lv2]))
    gt_ = ttri.acceptance_gates(tcam, _t(R1), _t(t1), _t(R2), _t(t2),
                                _t(Xj), _t(x1), _t(x2), _t(ur1), _t(ur2),
                                _t(sig[lv1]), _t(sig[lv2]))
    gj = np.asarray(gj)
    np.testing.assert_array_equal(gt_.numpy(), gj)
    assert 0 < gj.sum() < len(gj)


@pytest.mark.parametrize("pair_ids", [(0, 1), (1, 3)])
def test_triangulate_pair(scene, pair_ids):
    cfg, _, _, poses, views = scene
    args = _pair_args(poses, views, *pair_ids,
                      np.random.default_rng(sum(pair_ids)))
    rj = jmk.triangulate_pair(cfg, *map(jnp.asarray, args))
    rt = tmk.triangulate_pair(port_config(cfg), *_port(args))
    np.testing.assert_array_equal(rt.kp2_idx.numpy(), np.asarray(rj.kp2_idx))
    ok = np.asarray(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    assert ok.sum() >= 50
    Xj, Xt = np.asarray(rj.X)[ok], rt.X.numpy()[ok]
    assert (np.linalg.norm(Xt - Xj, axis=1)
            <= X_RTOL * np.linalg.norm(Xj, axis=1)).all()


def _fuse_args(cfg, X, desc, poses, views, target, rng):
    """Candidate points (world points, some perturbed) into a keyframe."""
    sf = np.asarray(cfg.orb.scale_factors, np.float32)
    R0, t0 = poses[0]
    c0 = -R0.T @ t0
    dist = np.linalg.norm(X - c0, axis=1)
    lvl = rng.integers(0, 4, len(X))
    maxd = (dist * sf[lvl]).astype(np.float32)
    mind = (maxd / sf[-1]).astype(np.float32)
    pos = X + rng.normal(0, 0.005, X.shape).astype(np.float32)
    valid = rng.uniform(size=len(X)) < 0.9
    v = views[target]
    R, t = poses[target]
    return (R, t, pos.astype(np.float32), desc, mind, maxd, valid,
            v["xy"], v["level"], v["valid"], v["desc"])


@pytest.mark.parametrize("target", [1, 2])
def test_fuse_match(scene, target):
    cfg, X, desc, poses, views = scene
    args = _fuse_args(cfg, X, desc, poses, views, target,
                      np.random.default_rng(target))
    rj = jmk.fuse_match(cfg, *map(jnp.asarray, args))
    rt = tmk.fuse_match(port_config(cfg), *_port(args))
    ok = np.asarray(rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), ok)
    np.testing.assert_array_equal(rt.kp_idx.numpy(), np.asarray(rj.kp_idx))
    assert ok.sum() >= 50
    # accepted matches land on the points' own keypoints
    slot_of = views[target]["slot_of"]
    hits = [slot_of.get(p) == k for p, k in
            zip(np.nonzero(ok)[0], rt.kp_idx.numpy()[ok])]
    assert np.mean(hits) >= 0.9


def test_batch_forms(scene):
    cfg, X, desc, poses, views = scene
    tcfg = port_config(cfg)
    rng = np.random.default_rng(3)
    a = _pair_args(poses, views, 0, 1, rng)
    b = _pair_args(poses, views, 0, 2, rng)
    first = a[:2] + a[4:9]
    rest = [np.stack([x, y]) for x, y in zip(a[2:4] + a[9:], b[2:4] + b[9:])]
    batch = first[:2] + first[2:] + tuple(rest)
    rj = jmk.triangulate_pairs_batch(cfg, *map(jnp.asarray, batch))
    rt = tmk.triangulate_pairs_batch(tcfg, *_port(batch))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    np.testing.assert_array_equal(rt.kp2_idx.numpy(), np.asarray(rj.kp2_idx))
    assert rt.ok.shape == (2, 424)

    f1 = _fuse_args(cfg, X, desc, poses, views, 1, np.random.default_rng(0))
    f3 = _fuse_args(cfg, X, desc, poses, views, 3, np.random.default_rng(0))
    shared = f1[2:7]
    per_kf = [np.stack([x, y]) for x, y in zip(f1[:2] + f1[7:],
                                                f3[:2] + f3[7:])]
    fargs = tuple(per_kf[:2]) + shared + tuple(per_kf[2:])
    fj = jmk.fuse_match_batch(cfg, *map(jnp.asarray, fargs))
    ft = tmk.fuse_match_batch(tcfg, *_port(fargs))
    np.testing.assert_array_equal(ft.ok.numpy(), np.asarray(fj.ok))
    np.testing.assert_array_equal(ft.kp_idx.numpy(), np.asarray(fj.kp_idx))


def _ba_problem(cfg, seed=7, P=256, K=4, F=2):
    """A padded local-BA problem: K free cameras (3 valid), F fixed, P
    point slots (240 valid), perturbed poses/points, noisy observations
    with 5 % gross outliers, stereo coordinates on half of them."""
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    n_pts = 240
    X = np.zeros((P, 3), np.float32)
    X[:n_pts] = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                          rng.uniform(2.0, 6.0, n_pts)], 1)
    R = np.tile(np.eye(3, dtype=np.float32), (K + F, 1, 1))
    t = np.zeros((K + F, 3), np.float32)
    for c in range(K + F):
        R[c] = _rot(rng, 0.04)
        t[c] = rng.normal(0, 0.1, 3) + [0.2 * c - 0.5, 0, 0]
    sig = np.asarray(cfg.orb.level_sigma2, np.float32)

    def grid(cams):
        C = len(cams)
        uv = np.zeros((P, C, 2), np.float32)
        ur = np.full((P, C), -1.0, np.float32)
        iv = np.ones((P, C), np.float32)
        mask = rng.uniform(size=(P, C)) < 0.8
        mask[n_pts:] = False
        for j, c in enumerate(cams):
            p, z = _project(cam, R[c], t[c], X[:n_pts])
            uv[:n_pts, j] = p + rng.normal(0, 0.5, p.shape)
            bad = rng.uniform(size=n_pts) < 0.05
            uv[:n_pts][bad, j] += rng.normal(0, 20, (bad.sum(), 2))
            st = np.nonzero(rng.uniform(size=n_pts) < 0.5)[0]
            ur[st, j] = uv[st, j, 0] - cam.bf / np.maximum(z[st], 1e-3)
            iv[:, j] = 1.0 / sig[rng.integers(0, 4, P)]
            mask[:n_pts, j] &= z > 0.1
        return uv, ur, iv, mask

    uv_f, ur_f, iv_f, m_f = grid(range(K))
    uv_x, ur_x, iv_x, m_x = grid(range(K, K + F))
    R_free = R[:K].copy()
    t_free = t[:K] + rng.normal(0, 0.02, (K, 3)).astype(np.float32)
    Xp = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    cam_valid = np.arange(K) < 3
    point_valid = np.arange(P) < n_pts
    return jba.BAProblem(
        R_free=R_free, t_free=t_free, R_fix=R[K:], t_fix=t[K:], X=Xp,
        cam_valid=cam_valid, point_valid=point_valid,
        uv_free=uv_f, ur_free=ur_f, inv_sigma2_free=iv_f, mask_free=m_f,
        uv_fix=uv_x, ur_fix=ur_x, inv_sigma2_fix=iv_x, mask_fix=m_x)


def test_local_ba(scene):
    cfg = scene[0]
    prob = _ba_problem(cfg)
    rj = jba.local_ba_jit(cfg.camera, jba.BAProblem(*map(jnp.asarray, prob)))
    rt = tba.local_ba(port_config(cfg).camera,
                      tba.BAProblem(*(_t(np.asarray(a)) for a in prob)))
    for name in ("R_free", "t_free", "X"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=0, atol=BA_ATOL)
    for name in ("inlier_free", "inlier_fix"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)))
    inl = np.asarray(rj.inlier_free)
    assert 0 < inl.sum() < prob.mask_free.sum()   # outliers were dropped
    assert float(rt.chi2_total) == pytest.approx(float(rj.chi2_total),
                                                 rel=1e-3)
