"""Parity of the PyTorch port's absolute orientation (optim/horn.py) and
EPnP-RANSAC (optim/epnp.py) against the JAX package, on seeded numpy
scenes fed to both.

Tolerances:
* Horn: R and t within 1e-5 (batched, with and without scale, and a
  reflection case where the determinant sign rule decides).
* epnp_solve on projections with 0.5 px noise: R within 1e-4, t within
  1e-4 relative to |t| (the 12x12 eigen-system and the 3x3 SVDs run on
  other LAPACK calls; the noise keeps the null space well separated).
* pnp_ransac given the minimal sets JAX itself draws (the same
  jax.random calls as the JAX package's sampler): equal inlier masks and
  counts, R and t within 1e-4; some of those sets repeat an index
  (sampling with replacement: a rank-deficient beta system, solved
  minimum-norm on both sides), and degenerate sets are finite on both.
* the port's own sampler: the JAX package's outlier test (128 points,
  50 outliers) passes with the port's draws; no valid row gives
  ok=False and no exception.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu.geom import se3 as jse3
from orb_slam2_map_tpu.geom.camera import PinholeCamera as JCam
from orb_slam2_map_tpu.optim import epnp as jepnp
from orb_slam2_map_tpu.optim import horn as jhorn
from orb_slam2_map_tpu_torch.geom.camera import PinholeCamera as TCam
from orb_slam2_map_tpu_torch.optim import epnp as tepnp
from orb_slam2_map_tpu_torch.optim import horn as thorn

torch.set_num_threads(1)

CAM = dict(fx=258.0, fy=258.0, cx=159.5, cy=119.5, width=320, height=240,
           bf=20.0)
JC, TC = JCam(**CAM), TCam(**CAM)


def _pose(rng, rot=0.2, trans=0.3):
    R = np.asarray(jse3.so3_exp(jnp.asarray(
        rng.normal(0, rot, 3).astype(np.float32))))
    return R.astype(np.float32), rng.normal(0, trans, 3).astype(np.float32)


def _scene(seed, n, noise_px=0.5):
    """World points seen at depth 1.5-6 m by a camera at (R, t), their
    projections with Gaussian pixel noise, and per-level inv_sigma2."""
    rng = np.random.default_rng(seed)
    R, t = _pose(rng)
    Xc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.5, 6.0, n)], 1)
    X = ((Xc - t) @ R).astype(np.float32)
    uv = np.stack([CAM["fx"] * Xc[:, 0] / Xc[:, 2] + CAM["cx"],
                   CAM["fy"] * Xc[:, 1] / Xc[:, 2] + CAM["cy"]], 1)
    uv = (uv + rng.normal(0, noise_px, uv.shape)).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return R, t, X, uv, inv_s2


def _assert_pose(Rt, tt, Rj, tj, atol):
    np.testing.assert_allclose(np.asarray(Rt), np.asarray(Rj), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(np.asarray(tt), np.asarray(tj), rtol=0,
                               atol=atol * max(1.0, float(np.linalg.norm(tj))))


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_batched_parity(with_scale):
    rng = np.random.default_rng(3)
    B, n = 6, 40
    A = rng.normal(0, 1.0, (B, n, 3)).astype(np.float32)
    Bp = np.empty_like(A)
    for b in range(B):
        R, t = _pose(rng, rot=1.0, trans=1.0)
        s = 1.7 if with_scale else 1.0
        Bp[b] = s * A[b] @ R.T + t + rng.normal(0, 1e-3, (n, 3))
    # a reflection: the best orthogonal fit has det -1, the rule keeps R
    # a rotation
    Bp[-1] = A[-1] * np.asarray([1.0, 1.0, -1.0], np.float32)
    w = rng.uniform(0.5, 1.5, (B, n)).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.as_tensor(weights)
        Rj, tj, sj = jhorn.absolute_orientation(
            jnp.asarray(A), jnp.asarray(Bp), jw, with_scale=with_scale)
        Rt, tt, st = thorn.absolute_orientation(
            torch.as_tensor(A), torch.as_tensor(Bp), tw, with_scale=with_scale)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
        np.testing.assert_allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epnp_solve_parity(seed):
    R_gt, t_gt, X, uv, _ = _scene(seed, 60)
    Rj, tj, ej = jepnp.epnp_solve(JC, jnp.asarray(X), jnp.asarray(uv))
    Rt, tt, et = tepnp.epnp_solve(TC, torch.as_tensor(X), torch.as_tensor(uv))
    _assert_pose(Rt.numpy(), tt.numpy(), Rj, tj, 1e-4)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-2, atol=1e-3)
    # and both near the truth
    _assert_pose(Rt.numpy(), tt.numpy(), R_gt, t_gt, 2e-2)
    # batched over sets equals one solve per set
    Xb = torch.as_tensor(np.stack([X[:20], X[20:40], X[40:]]))
    uvb = torch.as_tensor(np.stack([uv[:20], uv[20:40], uv[40:]]))
    Rb, tb, _ = tepnp.epnp_solve(TC, Xb, uvb)
    for i in range(3):
        R1, t1, _ = tepnp.epnp_solve(TC, Xb[i], uvb[i])
        np.testing.assert_allclose(Rb[i].numpy(), R1.numpy(), atol=1e-5)
        np.testing.assert_allclose(tb[i].numpy(), t1.numpy(), atol=1e-5)


def _jax_minimal_sets(valid, key, n_hypotheses=256):
    """The minimal sets the JAX package's pnp_ransac draws for `key`
    (orb_slam2_map_tpu/optim/epnp.py:182-185)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(4,))
    )(jax.random.split(key, n_hypotheses)))


@pytest.mark.parametrize("seed", [4, 5])
def test_pnp_ransac_given_jax_minimal_sets(seed):
    n, n_bad = 150, 40
    _, _, X, uv, inv_s2 = _scene(seed, n)
    rng = np.random.default_rng(seed + 100)
    uv[:n_bad] += rng.uniform(25.0, 120.0, (n_bad, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-10:] = False
    key = jax.random.PRNGKey(seed)
    idx = np.array(_jax_minimal_sets(valid, key))
    assert valid[idx].all()
    # sampling with replacement: some sets repeat an index (a
    # rank-deficient beta system)
    assert (np.sort(idx, 1)[:, 1:] == np.sort(idx, 1)[:, :-1]).any()
    jr = jepnp.pnp_ransac(JC, jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(inv_s2), jnp.asarray(valid), key)
    tr = tepnp.pnp_ransac(TC, torch.as_tensor(X), torch.as_tensor(uv),
                          torch.as_tensor(inv_s2), torch.as_tensor(valid),
                          idx=torch.as_tensor(idx))
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    assert bool(tr.ok) and bool(jr.ok)
    assert tr.inliers.numpy()[:n_bad].sum() <= 3
    _assert_pose(tr.R.numpy(), tr.t.numpy(), jr.R, jr.t, 1e-4)


def test_epnp_degenerate_sets_are_finite():
    """One point four times, and a set with a repeated index: both
    packages return a finite pose (minimum-norm beta solve)."""
    _, _, X, uv, _ = _scene(6, 20)
    sets = np.asarray([[3, 3, 3, 3], [1, 1, 5, 9], [2, 4, 4, 4]])
    jsolve = jax.vmap(lambda ids: jepnp.epnp_solve(
        JC, jnp.asarray(X)[ids], jnp.asarray(uv)[ids]))
    Rj, tj, _ = jsolve(jnp.asarray(sets))
    Rt, tt, _ = tepnp.epnp_solve(TC, torch.as_tensor(X[sets]),
                                 torch.as_tensor(uv[sets]))
    assert np.isfinite(np.asarray(Rj)).all() and np.isfinite(np.asarray(tj)).all()
    assert torch.isfinite(Rt).all() and torch.isfinite(tt).all()


def test_pnp_ransac_own_sampling_with_outliers():
    """The JAX package's test_ransac_with_outliers, on the port's draws."""
    n, n_bad = 128, 50
    R_gt, t_gt, X, uv, _ = _scene(8, n, noise_px=0.0)
    rng = np.random.default_rng(9)
    uv[:n_bad] += rng.uniform(25.0, 120.0, (n_bad, 2)).astype(np.float32)
    g = torch.Generator().manual_seed(10)
    res = tepnp.pnp_ransac(TC, torch.as_tensor(X), torch.as_tensor(uv),
                           torch.ones(n), torch.ones(n, dtype=torch.bool),
                           generator=g)
    assert bool(res.ok)
    assert int(res.n_inliers) >= n - n_bad - 5
    assert res.inliers.numpy()[:n_bad].sum() <= 3
    np.testing.assert_allclose(res.t.numpy(), t_gt, atol=0.05)
    # draws fall on valid rows only, and are reproducible from the seed
    valid = np.zeros(n, bool)
    valid[60:90] = True
    a = tepnp.sample_minimal_sets(torch.as_tensor(valid), 256,
                                  torch.Generator().manual_seed(3))
    b = tepnp.sample_minimal_sets(torch.as_tensor(valid), 256,
                                  torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and valid[a.numpy()].all()
    assert len(np.unique(a.numpy())) == 30


def test_pnp_ransac_no_valid_row():
    _, _, X, uv, inv_s2 = _scene(11, 40)
    res = tepnp.pnp_ransac(TC, torch.as_tensor(X), torch.as_tensor(uv),
                           torch.as_tensor(inv_s2), torch.zeros(40, dtype=torch.bool),
                           generator=torch.Generator().manual_seed(0))
    assert not bool(res.ok) and int(res.n_inliers) == 0
    assert not res.inliers.any()


def test_slice_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.slam.async_pipeline, "
            "orb_slam2_map_tpu_torch.optim.epnp, "
            "orb_slam2_map_tpu_torch.optim.horn; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
