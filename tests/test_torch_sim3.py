"""Parity of the port's Sim(3) geometry (geom/sim3.py), Sim3 solver
(optim/sim3_solver.py) and SearchBySim3 (slam/mapping_kernels.py)
against the JAX package, on seeded numpy inputs fed to both.

Tolerances:
* exp / log / compose / inverse / act: 1e-5 absolute (float32; the small
  angle, small scale and near-pi branches are all exercised).
* sim3_ransac given the minimal sets JAX itself draws (the JAX package's
  jax.random.categorical over PRNGKey(kid)): equal inlier masks and
  counts; R, t, s within 1e-4 (batched Horn SVDs on other LAPACK calls).
* optimize_sim3 from the same start: equal inlier masks, R, t, s within
  1e-4 (30 LM iterations of a 7x7 solve, Jacobians by forward-mode AD on
  both sides).
* search_by_sim3: exact (integer matches behind gated-NN).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu.geom import sim3 as jsim3
from orb_slam2_map_tpu.optim import sim3_solver as jsolver
from orb_slam2_map_tpu.slam import mapping_kernels as jmk
from orb_slam2_map_tpu_torch.geom import sim3 as tsim3
from orb_slam2_map_tpu_torch.optim import sim3_solver as tsolver
from orb_slam2_map_tpu_torch.slam import mapping_kernels as tmk

from conftest import small_config
from test_torch_orb import port_config

torch.set_num_threads(1)

ATOL = 1e-5


def _t(a, dtype=None):
    a = np.array(a)
    if a.dtype == np.uint32:
        return torch.as_tensor(a.view(np.int32))
    return torch.as_tensor(a, dtype=dtype)


def _tangents():
    """[n, 7] tangents: generic, small angle, zero angle, small and zero
    scale, and rotations near pi."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (24, 7))
    xi[4:8, 3:6] *= 1e-7                        # small angle
    xi[8:10, 3:6] = 0.0                         # zero angle
    xi[10:14, 6] *= 1e-7                        # small scale
    xi[14:16, 6] = 0.0                          # unit scale
    axis = rng.normal(size=(4, 3))
    xi[16:20, 3:6] = axis / np.linalg.norm(axis, axis=1,
                                           keepdims=True) * 3.1
    xi[20:22, 3:6] *= 1e-7
    xi[20:22, 6] = 0.0                          # both limits at once
    return xi.astype(np.float32)


def test_exp_log_parity():
    xi = _tangents()
    Rj, tj, sj = jsim3.exp(jnp.asarray(xi))
    Rt, tt, st = tsim3.exp(_t(xi))
    for a, b in ((Rt, Rj), (tt, tj), (st, sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    lj = jsim3.log(Rj, tj, sj)
    lt = tsim3.log(_t(np.asarray(Rj)), _t(np.asarray(tj)),
                   _t(np.asarray(sj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    # away from the near-pi rows log inverts exp
    np.testing.assert_allclose(lt.numpy()[:16], xi[:16], rtol=0, atol=1e-4)


def test_group_operations_parity():
    xi = _tangents()
    a = jsim3.exp(jnp.asarray(xi))
    b = jsim3.exp(jnp.asarray(xi[::-1].copy()))
    ta = tuple(_t(np.asarray(x)) for x in a)
    tb = tuple(_t(np.asarray(x)) for x in b)
    X = np.random.default_rng(1).normal(size=(len(xi), 3)).astype(np.float32)
    pairs = [(tsim3.compose(*ta, *tb), jsim3.compose(*a, *b)),
             (tsim3.inverse(*ta), jsim3.inverse(*a)),
             ((tsim3.act(*ta, _t(X)),), (jsim3.act(*a, jnp.asarray(X)),)),
             (tsim3.to_se3(*ta), jsim3.to_se3(*a)),
             (tsim3.from_se3(*ta[:2]), jsim3.from_se3(*a[:2])),
             (tsim3.identity((3,)), jsim3.identity((3,)))]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL * 10)


def _sim3_scene(seed, n=120, n_out=30, scale=1.3):
    """Camera-frame points X1 (camera 1) and X2 (camera 2) related by a
    known S12, with outliers in the last n_out rows and pixel noise."""
    rng = np.random.default_rng(seed)
    Rg = np.asarray(jsim3.exp(jnp.asarray(
        rng.normal(0, 0.2, 7).astype(np.float32)))[0])
    tg = rng.normal(0, 0.2, 3).astype(np.float32)
    X2 = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                   rng.uniform(2.0, 5.0, n)], 1).astype(np.float32)
    X1 = (scale * X2 @ Rg.T + tg).astype(np.float32)
    X1 = X1 + rng.normal(0, 0.003, X1.shape).astype(np.float32)
    X1[-n_out:] += rng.normal(0, 0.5, (n_out, 3)).astype(np.float32)
    X1[:, 2] = np.maximum(X1[:, 2], 0.5)
    s2 = (1.2 ** (2 * rng.integers(0, 4, (2, n)))).astype(np.float32)
    return X1, X2, s2


def _jax_draws(valid, kid, n_hyp=256):
    """The minimal sets the JAX package draws (sim3_solver.py:46-49)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(3,)))(
        jax.random.split(jax.random.PRNGKey(kid), n_hyp)))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_on_jax_draws(fix_scale):
    cam = small_config().camera
    tcam = port_config(small_config()).camera
    X1, X2, s2 = _sim3_scene(3, scale=1.0 if fix_scale else 1.3)
    valid = np.ones(len(X1), bool)
    valid[5] = False
    kid = 17
    idx = _jax_draws(valid, kid)
    rj = jsolver.sim3_ransac(cam, jnp.asarray(X1), jnp.asarray(X2),
                             jnp.asarray(s2[0]), jnp.asarray(s2[1]),
                             jnp.asarray(valid), jax.random.PRNGKey(kid),
                             256, fix_scale, 20)
    rt = tsolver.sim3_ransac(tcam, _t(X1), _t(X2), _t(s2[0]), _t(s2[1]),
                             _t(valid), fix_scale=fix_scale, min_inliers=20,
                             idx=_t(idx))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok) == bool(rj.ok)
    for a, b in ((rt.R, rj.R), (rt.t, rj.t), (rt.s, rj.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    # the port's own draws find the same consensus on this scene
    gen = torch.Generator().manual_seed(kid)
    own = tsolver.sim3_ransac(tcam, _t(X1), _t(X2), _t(s2[0]), _t(s2[1]),
                              _t(valid), generator=gen, fix_scale=fix_scale)
    assert bool(own.ok) and abs(int(own.n_inliers) - int(rj.n_inliers)) <= 3


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_parity(fix_scale):
    cam = small_config().camera
    tcam = port_config(small_config()).camera
    X1, X2, s2 = _sim3_scene(5, scale=1.0 if fix_scale else 1.3)
    uv1 = np.stack([cam.fx * X1[:, 0] / X1[:, 2] + cam.cx,
                    cam.fy * X1[:, 1] / X1[:, 2] + cam.cy], 1)
    uv2 = np.stack([cam.fx * X2[:, 0] / X2[:, 2] + cam.cx,
                    cam.fy * X2[:, 1] / X2[:, 2] + cam.cy], 1)
    uv1 = uv1.astype(np.float32)
    uv2 = uv2.astype(np.float32)
    valid = np.ones(len(X1), bool)
    valid[-3:] = False
    # start from a perturbed ground truth
    R0 = np.asarray(jsim3.exp(jnp.asarray(
        np.asarray([0, 0, 0, 0.01, -0.02, 0.015, 0], np.float32)))[0])
    t0 = np.asarray([0.02, -0.01, 0.03], np.float32)
    s0 = np.float32(1.0 if fix_scale else 1.25)
    args = (X1, X2, uv1, uv2, 1.0 / s2[0], 1.0 / s2[1], valid)
    oj = jsolver.optimize_sim3(cam, jnp.asarray(R0), jnp.asarray(t0),
                               jnp.asarray(s0), *map(jnp.asarray, args),
                               fix_scale)
    ot = tsolver.optimize_sim3(tcam, _t(R0), _t(t0), _t(s0),
                               *map(_t, args), fix_scale)
    np.testing.assert_array_equal(ot.inliers.numpy(), np.asarray(oj.inliers))
    assert int(ot.n_inliers) == int(oj.n_inliers) > 60
    for a, b in ((ot.R, oj.R), (ot.t, oj.t), (ot.s, oj.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def _kf_arrays(rng, N, level_n=4):
    """Per-keypoint arrays of one keyframe at capacity N: camera-frame
    points, descriptors (top-bit words included), levels, distance bands,
    pixels."""
    Xc = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1, 1, N),
                   rng.uniform(1.5, 5.0, N)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    desc[::3, 5] |= np.uint32(0x80000000)
    level = rng.integers(0, level_n, N).astype(np.int32)
    dist = np.linalg.norm(Xc, axis=1)
    maxd = (dist * 1.2 ** level * 1.1).astype(np.float32)
    mind = (maxd / 1.2 ** (level_n - 1) * 0.8).astype(np.float32)
    return Xc, desc, level, mind, maxd


def test_search_by_sim3_exact():
    """Two keyframes seeing the same points through a known S12: the
    mutual Sim3-guided matches agree exactly."""
    jcfg = small_config()
    tcfg = port_config(jcfg)
    cam = jcfg.camera
    rng = np.random.default_rng(11)
    N = 424                             # the small config's keypoint slots
    Xc2, desc2, level2, mind2, maxd2 = _kf_arrays(rng, N)
    R12 = np.asarray(jsim3.exp(jnp.asarray(
        np.asarray([0, 0, 0, 0.02, 0.05, -0.01, 0], np.float32)))[0])
    t12 = np.asarray([0.1, -0.05, 0.05], np.float32)
    s12 = np.float32(1.0)
    # keyframe 1 sees the same points in shuffled order, with most
    # descriptors kept and some bits flipped
    perm = rng.permutation(N)
    Xc1 = (Xc2[perm] @ R12.T * s12 + t12).astype(np.float32)
    desc1 = desc2[perm].copy()
    desc1[:, 0] ^= rng.integers(0, 2 ** 6, N, dtype=np.uint32)
    desc1[::5] = rng.integers(0, 2 ** 32, (len(desc1[::5]), 8),
                              dtype=np.uint32)
    level1 = level2[perm].copy()
    mind1, maxd1 = mind2[perm].copy(), maxd2[perm].copy()

    def px(X):
        return np.stack([cam.fx * X[:, 0] / X[:, 2] + cam.cx,
                         cam.fy * X[:, 1] / X[:, 2] + cam.cy],
                        1).astype(np.float32)

    xy1 = px(Xc1) + rng.normal(0, 0.7, (N, 2)).astype(np.float32)
    xy2 = px(Xc2) + rng.normal(0, 0.7, (N, 2)).astype(np.float32)
    has1 = rng.uniform(size=N) < 0.9
    has2 = rng.uniform(size=N) < 0.9
    already1 = rng.uniform(size=N) < 0.1
    already2 = rng.uniform(size=N) < 0.1
    args = (Xc1, has1, desc1, level1, mind1, maxd1, xy1, already1,
            Xc2, has2, desc2, level2, mind2, maxd2, xy2, already2)
    rj = jmk.search_by_sim3(jcfg, jnp.asarray(R12), jnp.asarray(t12),
                            jnp.asarray(s12), *map(jnp.asarray, args))
    rt = tmk.search_by_sim3(tcfg, _t(R12), _t(t12), _t(s12), *map(_t, args))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    np.testing.assert_array_equal(rt.match12.numpy(),
                                  np.asarray(rj.match12).astype(np.int64))
    n = int(rt.ok.sum())
    print(f"search_by_sim3: {n} mutual matches of {N}")
    assert n > 100
    # agreed matches are the true correspondences
    ok = rt.ok.numpy()
    assert (perm[np.nonzero(ok)[0]] == rt.match12.numpy()[ok]).mean() > 0.95


def test_sim3_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.geom.sim3, "
            "orb_slam2_map_tpu_torch.optim.sim3_solver, "
            "orb_slam2_map_tpu_torch.slam.mapping_kernels; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
