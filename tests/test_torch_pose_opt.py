"""Parity of the PyTorch port's pose-only optimizer (residuals, Jacobians,
the 4x10 LM schedule, multi-start and the batched refinement entry)
against the JAX package, on synthetic 3D-2D sets with mono and stereo
observations and gross outliers.

Tolerances: R and t within 1e-4 — the 6x6 solves, the einsum
reductions and se3_exp run on different kernels, so the iterates differ
in the last bits and the converged poses agree to ~1e-6 on these sets;
inlier masks exactly (the chi2 gates sit far from the residuals of
these sets).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu.geom import se3 as jse3
from orb_slam2_map_tpu.geom.camera import PinholeCamera as JCam
from orb_slam2_map_tpu.optim import pose_opt as jpo
from orb_slam2_map_tpu.optim import residuals as jres
from orb_slam2_map_tpu_torch.geom.camera import PinholeCamera as TCam
from orb_slam2_map_tpu_torch.optim import pose_opt as tpo
from orb_slam2_map_tpu_torch.optim import residuals as tres

from test_torch_kernels import _t

torch.set_num_threads(1)

CAM = dict(fx=258.0, fy=258.0, cx=159.5, cy=119.5, width=320, height=240,
           bf=20.0)
POSE_TOL = dict(rtol=0, atol=1e-4)


def _problem(seed, n=300, outlier_frac=0.15):
    """(R_true, t_true, X, uv, ur, inv_sigma2, valid): world points seen
    by a camera at (R_true, t_true); 40 % stereo observations."""
    rng = np.random.default_rng(seed)
    phi = rng.normal(0, 0.1, 3).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(phi)))
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    Xc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.0, 6.0, n)], 1)
    X = ((Xc - t) @ R).astype(np.float32)              # R^T (Xc - t)
    level = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** level).astype(np.float32)
    u = CAM["fx"] * Xc[:, 0] / Xc[:, 2] + CAM["cx"]
    v = CAM["fy"] * Xc[:, 1] / Xc[:, 2] + CAM["cy"]
    noise = rng.normal(0, 0.5, (n, 2)) * 1.2 ** level[:, None]
    uv = np.stack([u, v], 1) + noise
    ur = np.where(rng.uniform(size=n) < 0.4,
                  uv[:, 0] - CAM["bf"] / Xc[:, 2] + rng.normal(0, 0.5, n), -1.0)
    bad = rng.uniform(size=n) < outlier_frac
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    valid = rng.uniform(size=n) < 0.95
    return (R, t, X, uv.astype(np.float32), ur.astype(np.float32), inv_s2,
            valid)


def _start(R, t, seed, scale=1.0):
    rng = np.random.default_rng(seed + 100)
    dR = np.asarray(jse3.so3_exp(jnp.asarray(
        rng.normal(0, 0.03 * scale, 3).astype(np.float32))))
    return (dR @ R).astype(np.float32), \
        (t + rng.normal(0, 0.05 * scale, 3)).astype(np.float32)


def test_residuals_and_jacobians():
    R, t, X, uv, ur, _, _ = _problem(0, n=64)
    jc, tc = JCam(**CAM), TCam(**CAM)
    e_j, Xc_j = jres.project_residual(jc, R, t, X, uv, ur)
    e_t, Xc_t = tres.project_residual(tc, _t(R), _t(t), _t(X), _t(uv), _t(ur))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Xc_t.numpy(), np.asarray(Xc_j), rtol=1e-5, atol=1e-6)
    Jp_j = jres.proj_jacobian_point(jc, Xc_j, ur >= 0)
    Jp_t = tres.proj_jacobian_point(tc, Xc_t, _t(ur >= 0))
    np.testing.assert_allclose(Jp_t.numpy(), np.asarray(Jp_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tres.pose_jacobian_from_point_jac(Jp_t, Xc_t).numpy(),
        np.asarray(jres.pose_jacobian_from_point_jac(Jp_j, Xc_j)),
        rtol=1e-5, atol=1e-3)
    chi2 = np.linspace(0, 20, 50).astype(np.float32)
    np.testing.assert_allclose(
        tres.huber_weight(_t(chi2), torch.tensor(5.991)).numpy(),
        np.asarray(jres.huber_weight(chi2, 5.991)), rtol=1e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pose_optimize(seed):
    R, t, X, uv, ur, inv_s2, valid = _problem(seed)
    R0, t0 = _start(R, t, seed)
    want = jpo.pose_optimize(JCam(**CAM), R0, t0, X, uv, ur, inv_s2, valid)
    got = tpo.pose_optimize(TCam(**CAM), _t(R0), _t(t0), _t(X), _t(uv),
                            _t(ur), _t(inv_s2), _t(valid))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), t, atol=0.02)   # converged


@pytest.mark.parametrize("seed", [4, 5])
def test_pose_optimize_multi(seed):
    R, t, X, uv, ur, inv_s2, valid = _problem(seed, outlier_frac=0.3)
    starts = [_start(R, t, seed), _start(R, t, seed + 7, scale=4.0)]
    R0s = np.stack([s[0] for s in starts])
    t0s = np.stack([s[1] for s in starts])
    want = jpo.pose_optimize_multi(JCam(**CAM), R0s, t0s, X, uv, ur, inv_s2,
                                   valid)
    got = tpo.pose_optimize_multi(TCam(**CAM), _t(R0s), _t(t0s), _t(X),
                                  _t(uv), _t(ur), _t(inv_s2), _t(valid))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **POSE_TOL)
    np.testing.assert_allclose(got.chi2.numpy(), np.asarray(want.chi2),
                               rtol=1e-3, atol=1e-3)


def test_batched_refinement_entry():
    """The trajectory refinement's batch (one LM per frame, each with its
    own observations) against the JAX package's vmapped optimizer."""
    probs = [_problem(10 + i, n=128) for i in range(3)]
    stack = lambda k: np.stack([p[k] for p in probs])  # noqa: E731
    X, uv, ur, inv_s2, valid = (stack(k) for k in range(2, 7))
    inits = [_start(p[0], p[1], 20 + i) for i, p in enumerate(probs)]
    R0 = np.stack([s[0] for s in inits])
    t0 = np.stack([s[1] for s in inits])
    want = jax.jit(jax.vmap(functools.partial(jpo.pose_optimize, JCam(**CAM))))(
        R0, t0, X, uv, ur, inv_s2, valid)
    got = tpo.pose_optimize_batch(TCam(**CAM), _t(R0), _t(t0), _t(X), _t(uv),
                                  _t(ur), _t(inv_s2), _t(valid))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_array_equal(got.n_inliers.numpy(),
                                  np.asarray(want.n_inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), **POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), **POSE_TOL)
