"""Parity of the PyTorch port's config, geometry, pyramid and evaluation
modules against the JAX package, on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both
packages. Float tolerances: 1e-5 (relative/absolute) for closed-form
float32 geometry — the two frameworks evaluate sin/cos/arccos and
matmuls with different kernels, which moves the last bits only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu import config as jcfg_mod
from orb_slam2_map_tpu.geom import camera as jcam
from orb_slam2_map_tpu.geom import se3 as jse3
from orb_slam2_map_tpu.io import evaluate as jeval
from orb_slam2_map_tpu.ops import pyramid as jpyr
from orb_slam2_map_tpu_torch import config as tcfg_mod
from orb_slam2_map_tpu_torch.geom import camera as tcam
from orb_slam2_map_tpu_torch.geom import se3 as tse3
from orb_slam2_map_tpu_torch.io import evaluate as teval
from orb_slam2_map_tpu_torch.ops import pyramid as tpyr

from test_torch_kernels import _t

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rotations(rng, n, max_angle=np.pi):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, max_angle, (n, 1))
    return (axis * ang).astype(np.float32)


class TestConfig:
    def test_same_dataclasses_fields_and_defaults(self):
        names = [n for n, v in vars(jcfg_mod).items()
                 if dataclasses.is_dataclass(v) and isinstance(v, type)]
        assert sorted(names) == sorted(
            n for n, v in vars(tcfg_mod).items()
            if dataclasses.is_dataclass(v) and isinstance(v, type))
        for name in names:
            jc, tc = getattr(jcfg_mod, name), getattr(tcfg_mod, name)
            jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
            tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
            assert jf == tf, name
            if name != "SystemConfig":
                assert dataclasses.asdict(jc()) == dataclasses.asdict(tc()), name
        js, ts = jcfg_mod.SystemConfig(), tcfg_mod.SystemConfig()
        assert tuple(js.camera) == tuple(ts.camera)
        assert js.camera._fields == ts.camera._fields
        for f in dataclasses.fields(js):
            if f.name != "camera":
                a, b = getattr(js, f.name), getattr(ts, f.name)
                if dataclasses.is_dataclass(a):
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, f.name
        assert js.orb.features_per_level() == ts.orb.features_per_level()

    def test_load_settings_same(self, tmp_path):
        p = tmp_path / "TUM1.yaml"
        p.write_text("%YAML:1.0\nCamera.fx: 517.306408\nCamera.k1: 0.262383\n"
                     "ORBextractor.nFeatures: 800\nDepthMapFactor: 5000.0\n")
        a, b = jcfg_mod.load_settings(str(p)), tcfg_mod.load_settings(str(p))
        assert tuple(a.camera) == tuple(b.camera)
        assert dataclasses.asdict(a.orb) == dataclasses.asdict(b.orb)
        assert a.tracking.min_init_stereo_points == b.tracking.min_init_stereo_points


class TestSE3:
    @pytest.mark.parametrize("max_angle", [1e-6, 1e-3, 1.0, 3.1, np.pi])
    def test_exp_log(self, max_angle):
        rng = np.random.default_rng(0)
        phi = _rotations(rng, 64, max_angle)
        np.testing.assert_allclose(tse3.so3_exp(_t(phi)).numpy(),
                                   np.asarray(jse3.so3_exp(jnp.asarray(phi))), **TOL)
        R = np.asarray(jse3.so3_exp(jnp.asarray(phi)))
        np.testing.assert_allclose(tse3.so3_log(_t(R)).numpy(),
                                   np.asarray(jse3.so3_log(jnp.asarray(R))),
                                   rtol=1e-4, atol=1e-4)
        xi = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32), phi], 1)
        # V's (theta - sin theta) / theta^3 cancels in float32 for small
        # theta; the two sin implementations differ there in the 5th digit
        for a, b in zip(tse3.se3_exp(_t(xi)), jse3.se3_exp(jnp.asarray(xi))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)

    def test_group_ops(self):
        rng = np.random.default_rng(1)
        Ra = np.asarray(jse3.so3_exp(jnp.asarray(_rotations(rng, 32))))
        Rb = np.asarray(jse3.so3_exp(jnp.asarray(_rotations(rng, 32))))
        ta, tb = rng.normal(size=(2, 32, 3)).astype(np.float32)
        X = rng.normal(size=(32, 3)).astype(np.float32)
        pairs = [
            (tse3.compose(_t(Ra), _t(ta), _t(Rb), _t(tb)),
             jse3.compose(Ra, ta, Rb, tb)),
            (tse3.inverse(_t(Ra), _t(ta)), jse3.inverse(Ra, ta)),
            ((tse3.act(_t(Ra), _t(ta), _t(X)),), (jse3.act(Ra, ta, X),)),
            ((tse3.hat(_t(X)),), (jse3.hat(X),)),
            (tse3.identity((4,)), jse3.identity((4,))),
        ]
        for got, want in pairs:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


class TestCamera:
    def test_project_unproject_distortion(self):
        cam_j = jcfg_mod.tum1_camera()
        cam_t = tcfg_mod.tum1_camera()
        rng = np.random.default_rng(2)
        uv = rng.uniform([0, 0], [640, 480], (500, 2)).astype(np.float32)
        np.testing.assert_allclose(
            tcam.undistort_points(cam_t, _t(uv)).numpy(),
            np.asarray(jcam.undistort_points(cam_j, jnp.asarray(uv))),
            rtol=0, atol=1e-3)  # 8 fixed-point iterations, pixels
        xn = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
        np.testing.assert_allclose(tcam.distort(cam_t, _t(xn)).numpy(),
                                   np.asarray(jcam.distort(cam_j, jnp.asarray(xn))),
                                   **TOL)
        X = np.concatenate([rng.normal(size=(500, 2)),
                            rng.uniform(0.3, 5, (500, 1))], 1).astype(np.float32)
        uvp = tcam.project(cam_t, _t(X)).numpy()
        np.testing.assert_allclose(uvp, np.asarray(jcam.project(cam_j, X)),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(
            tcam.in_image(cam_t, _t(uvp), 1.0).numpy(),
            np.asarray(jcam.in_image(cam_j, jnp.asarray(uvp), 1.0)))
        d = X[:, 2]
        np.testing.assert_allclose(tcam.unproject(cam_t, _t(uv), _t(d)).numpy(),
                                   np.asarray(jcam.unproject(cam_j, uv, d)), **TOL)
        np.testing.assert_allclose(cam_t.K.numpy(), np.asarray(cam_j.K))


class TestPyramid:
    def test_levels_blur_resize(self):
        rng = np.random.default_rng(3)
        img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
        assert tpyr.level_sizes(480, 640, 8, 1.2) == jpyr.level_sizes(480, 640, 8, 1.2)
        # same separable-sum order on both sides: agreement to rounding
        tol = dict(rtol=0, atol=1e-3)
        np.testing.assert_allclose(tpyr.gaussian_blur(_t(img)).numpy(),
                                   np.asarray(jpyr.gaussian_blur(jnp.asarray(img))),
                                   **tol)
        for hw in [(100, 133), (37, 51)]:
            np.testing.assert_allclose(
                tpyr.resize_bilinear(_t(img), hw).numpy(),
                np.asarray(jpyr.resize_bilinear(jnp.asarray(img), hw)), **tol)
        for a, b in zip(tpyr.build_pyramid(_t(img), 4, 1.2),
                        jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_ate_and_rpe_same():
    rng = np.random.default_rng(4)
    ts = np.arange(40) / 30.0
    gt = np.tile(np.eye(4), (40, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.01, (40, 3)), 0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.002, (40, 3))
    assert teval.ate_rmse(ts, est[:, :3, 3], ts, gt[:, :3, 3]) == \
        jeval.ate_rmse(ts, est[:, :3, 3], ts, gt[:, :3, 3])
    assert teval.rpe(ts, est, ts, gt) == jeval.rpe(ts, est, ts, gt)
