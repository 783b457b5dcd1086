"""Parity of the PyTorch port's ORB front end (FAST, NMS, detection,
orientation, BRIEF, extraction, RGB-D frame) against the JAX package,
on the CPU at the small test configuration.

Each stage gets identical inputs on both sides (the same pyramid level
images, keypoints and angles), so integer and selection outputs must
match exactly: FAST scores are differences/mins/maxes of float32 (exact
in any order), and the tie order of the JAX top-k is reproduced with a
stable sort.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_config
from orb_slam2_map_tpu.io.synthetic import SyntheticWorld, sweep_trajectory
from orb_slam2_map_tpu.ops import fast as jfast
from orb_slam2_map_tpu.ops import orb as jorb
from orb_slam2_map_tpu.ops import pyramid as jpyr
from orb_slam2_map_tpu.slam import frame as jframe
from orb_slam2_map_tpu_torch import config as tconfig
from orb_slam2_map_tpu_torch.geom.camera import PinholeCamera as TCam
from orb_slam2_map_tpu_torch.ops import fast as tfast
from orb_slam2_map_tpu_torch.ops import orb as torb
from orb_slam2_map_tpu_torch.slam import frame as tframe

from test_torch_kernels import _t

torch.set_num_threads(1)


def port_config(cfg):
    """The port's SystemConfig with the same values as a JAX one."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "camera":
            v = TCam(*v)
        elif dataclasses.is_dataclass(v):
            v = getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconfig.SystemConfig(**kw)


@pytest.fixture(scope="module")
def scene():
    cfg = small_config()
    world = SyntheticWorld(cam=cfg.camera)
    Twc, _ = sweep_trajectory(30)
    gray, depth, _ = world.render(Twc[3])
    levels = [np.asarray(x) for x in
              jpyr.build_pyramid(jnp.asarray(gray), cfg.orb.n_levels,
                                 cfg.orb.scale_factor)]
    return cfg, gray, depth, levels


def test_pattern_and_masks_copied():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    for a, b in zip(torb._ic_angle_masks(), jorb._ic_angle_masks()):
        np.testing.assert_array_equal(a, b)
    assert torb._level_capacities(small_config().orb) == \
        jorb._level_capacities(small_config().orb)
    assert torb.total_capacity(tconfig.ORBConfig()) == \
        jorb.total_capacity(tconfig.ORBConfig()) == 1032


def test_bit_packing_top_bit():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    words[:, 0] |= np.uint32(0x80000000)
    words[0] = 0xFFFFFFFF
    bits = torb.unpack_bits(_t(words.view(np.int32)))
    ref = np.asarray(jorb.unpack_descriptors(jnp.asarray(words))) > 0
    np.testing.assert_array_equal(bits.numpy().astype(bool), ref)
    np.testing.assert_array_equal(torb.pack_bits(bits).numpy(),
                                  words.view(np.int32))


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_fast_nms_detect_exact(scene, level):
    cfg, _, _, levels = scene
    im = levels[level]
    rng = np.random.default_rng(level)
    noise = rng.integers(0, 256, im.shape).astype(np.float32)
    for img in (im, noise):
        s_j = np.asarray(jfast.fast_score_map(jnp.asarray(img)))
        s_t = tfast.fast_score_map(_t(img)).numpy()
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(tfast.nms3(_t(s_j)).numpy(),
                                      np.asarray(jfast.nms3(jnp.asarray(s_j))))
    cap = jorb._level_capacities(cfg.orb)[level]
    for img, n_keep in ((im, cap), (noise, cap), (im, 4 * cap)):
        want = [np.asarray(x) for x in
                jorb.detect_level(jnp.asarray(img), n_keep, cfg.orb)]
        got = [x.numpy() for x in torb.detect_level(_t(img), n_keep, cfg.orb)]
        for g, w in zip(got, want):   # keypoint set AND order
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level", [0, 2])
def test_angles_and_descriptors(scene, level):
    cfg, _, _, levels = scene
    im = levels[level]
    cap = jorb._level_capacities(cfg.orb)[level]
    xy = np.asarray(jorb.detect_level(jnp.asarray(im), cap, cfg.orb)[0])
    ang_j = np.asarray(jorb.ic_angles(jnp.asarray(im), jnp.asarray(xy)))
    ang_t = torb.ic_angles(_t(im), _t(xy)).numpy()
    # 961-term moment sums in another order: last-bit differences
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=1e-4)
    blurred = np.asarray(jpyr.gaussian_blur(jnp.asarray(im)))
    rng = np.random.default_rng(7)
    for angle in (ang_j, rng.uniform(-np.pi, np.pi, ang_j.shape).astype(np.float32)):
        d_j = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred),
                                                jnp.asarray(xy),
                                                jnp.asarray(angle)))
        d_t = torb.brief_descriptors(_t(blurred), _t(xy), _t(angle)).numpy()
        assert (d_j >= 2 ** 31).any()      # words with the top bit set
        np.testing.assert_array_equal(d_t, d_j.view(np.int32))


def test_extract_and_rgbd_frame(scene):
    cfg, gray, depth, _ = scene
    tcfg = port_config(cfg)
    k_j = jorb.extract(jnp.asarray(gray), cfg.orb)
    k_t = torb.extract(_t(gray), tcfg.orb)
    for name in ("xy", "response", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)))
    # descriptors steer by the IC angle, which differs in the last bits:
    # a rotated sample can round to the neighbouring pixel
    same = (k_t.desc.numpy() == np.asarray(k_j.desc).view(np.int32)).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(k_t.angle.numpy(), np.asarray(k_j.angle),
                               rtol=0, atol=1e-4)

    f_j = jframe.build_rgbd_frame(cfg, gray, depth)
    f_t = tframe.build_rgbd_frame(tcfg, gray, depth, device="cpu")
    for name in ("level", "valid", "depth", "inv_sigma2"):
        np.testing.assert_array_equal(getattr(f_t, name).numpy(),
                                      np.asarray(getattr(f_j, name)))
    # the jitted JAX frame program fuses the level scaling of the
    # keypoint coordinates: last-bit differences only
    for name in ("xy", "ur"):
        np.testing.assert_allclose(getattr(f_t, name).numpy(),
                                   np.asarray(getattr(f_j, name)),
                                   rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(f_t.R, np.asarray(f_j.R))
    Xw_j, ok_j = jframe.unproject_valid(cfg, f_j)
    Xw_t, ok_t = tframe.unproject_valid(tcfg, f_t)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(Xw_t.numpy(), np.asarray(Xw_j), rtol=1e-6,
                               atol=1e-6)
