"""Parity of the PyTorch port's stereo matching against the JAX package,
on the CPU at the small test configuration (320x240, 400 features, 4
levels: 424 keypoint slots), stereo pairs rendered by the JAX world with
the right eye at Twc . [b, 0, 0], b = bf / fx (tests/fixtures.py).

* Hamming matrix: exact, against the JAX plain path and the Pallas
  kernel in interpret mode, with ragged sizes, top-bit words and empty
  sides.
* `_stereo_match` on identical keypoints: the `ok` mask exactly; ur and
  depth within 1e-3 px / 1e-3 relative. The SAD sums 121 normalized
  pixel differences in another order than XLA; a one-ulp change of a
  cost moves the parabola's sub-pixel offset by far less than 1e-3 px
  (a flip of the best shift would move ur by ~1 px and fail the test).
* The JAX package's median gate, both branches: with an unmatched slot it
  rejects nothing; with every slot matched and an even count it takes
  the mean of the two middle costs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import small_config
from fixtures import small_camera
from orb_slam2_map_tpu.io.synthetic import SyntheticWorld, sweep_trajectory
from orb_slam2_map_tpu.ops import matching as jm
from orb_slam2_map_tpu.ops import orb as jorb
from orb_slam2_map_tpu.ops import pallas_kernels
from orb_slam2_map_tpu.ops import stereo as jstereo
from orb_slam2_map_tpu.slam import frame as jframe
from orb_slam2_map_tpu_torch.ops import matching as tm
from orb_slam2_map_tpu_torch.ops import orb as torb
from orb_slam2_map_tpu_torch.ops import stereo as tstereo
from orb_slam2_map_tpu_torch.slam import frame as tframe

from test_torch_kernels import _descs, _t
from test_torch_orb import port_config

torch.set_num_threads(1)

UR_ATOL = 1e-3       # px
DEPTH_RTOL = 1e-3


def stereo_pair(world, Twc, baseline):
    """Left and right gray images of a rectified pair at Twc."""
    gl, depth, _ = world.render(Twc)
    Tr = Twc.copy()
    Tr[:3, 3] += Twc[:3, :3] @ np.asarray([baseline, 0.0, 0.0])
    gr, _, _ = world.render(Tr)
    return gl, gr, depth


@pytest.fixture(scope="module")
def pair():
    cfg = small_config()
    assert cfg.camera == small_camera()
    Twc, _ = sweep_trajectory(12)
    gl, gr, depth = stereo_pair(SyntheticWorld(cam=cfg.camera), Twc[3],
                                cfg.camera.baseline)
    kp_l = [np.asarray(x) for x in jorb.extract(jnp.asarray(gl), cfg.orb)]
    kp_r = [np.asarray(x) for x in jorb.extract(jnp.asarray(gr), cfg.orb)]
    return cfg, gl, gr, depth, kp_l, kp_r


def _both_match(cfg, kp_l, kp_r, gl, gr):
    """(ur, depth) of both packages' _stereo_match on the same inputs."""
    j = jstereo._stereo_match(cfg, jorb.Keypoints(*map(jnp.asarray, kp_l)),
                              jorb.Keypoints(*map(jnp.asarray, kp_r)),
                              jnp.asarray(gl), jnp.asarray(gr))
    t = tstereo._stereo_match(port_config(cfg),
                              torb.Keypoints(*map(_t, kp_l)),
                              torb.Keypoints(*map(_t, kp_r)), _t(gl), _t(gr))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_match_parity(j, t):
    (ur_j, d_j), (ur_t, d_t) = j, t
    np.testing.assert_array_equal(ur_t >= 0, ur_j >= 0)
    np.testing.assert_array_equal(d_t > 0, d_j > 0)
    np.testing.assert_allclose(ur_t, ur_j, rtol=0, atol=UR_ATOL)
    np.testing.assert_allclose(d_t, d_j, rtol=DEPTH_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(200, 150), (37, 300), (5, 1), (0, 8),
                                   (8, 0)])
def test_hamming_plain_exact(shape):
    n, m = shape
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _descs(rng, max(n, 2), max(m, 2))
    a, b = a[:n], b[:m]
    got = tm.hamming_matrix_plain(_t(a), _t(b)).numpy()
    assert got.shape == (n, m) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    # the CPU entry point takes the plain version
    np.testing.assert_array_equal(tm.hamming_matrix(_t(a), _t(b)).numpy(), got)
    if n and m:
        with pltpu.force_tpu_interpret_mode():
            p = pallas_kernels.hamming_matrix_pallas(jnp.asarray(a),
                                                     jnp.asarray(b))
        np.testing.assert_array_equal(got, np.asarray(p))
        d = np.unpackbits((a[:, None, :] ^ b[None, :, :]).view(np.uint8),
                          axis=-1).sum(-1)
        np.testing.assert_array_equal(got, d.astype(np.float32))


def test_stereo_match_parity(pair):
    cfg, gl, gr, depth, kp_l, kp_r = pair
    j, t = _both_match(cfg, kp_l, kp_r, gl, gr)
    _assert_match_parity(j, t)
    ok = t[0] >= 0
    assert 300 <= ok.sum() < kp_l[0].shape[0]    # padding slots: unmatched
    # stereo depth against the rendered depth at the keypoints: most
    # matches are right (the dead median gate lets the rest through)
    xy = kp_l[0][ok]
    ratio = t[1][ok] / depth[xy[:, 1].astype(int), xy[:, 0].astype(int)]
    assert np.median(ratio) == pytest.approx(1.0, abs=0.03)
    print(f"stereo depths more than 30 % off the rendered depth: "
          f"{np.mean(np.abs(ratio - 1) > 0.3):.3f} of {ok.sum()} matches")


def test_stereo_match_border_clamped_strips(pair):
    """Keypoints moved to the image border and corners: their templates
    and strips start outside the padded image and are shifted inward, as
    lax.dynamic_slice shifts them; unmatched rows gather at keypoint 0."""
    cfg, gl, gr, _, kp_l, kp_r = pair
    kp_l = [x.copy() for x in kp_l]
    W, H = cfg.camera.width, cfg.camera.height
    corners = np.asarray([[0.0, 0.0], [W - 1.0, 0.0], [0.4, H - 1.0],
                          [W - 0.6, H - 1.0], [2.5, 120.0], [316.7, 3.2]],
                         np.float32)
    kp_l[0][:len(corners)] = corners
    kp_r2 = [x.copy() for x in kp_r]
    kp_r2[0][0] = [1.0, 1.0]                    # right keypoint 0 at a corner
    for right in (kp_r, kp_r2):
        _assert_match_parity(*_both_match(cfg, kp_l, right, gl, gr))


def test_stereo_match_all_matched_even_count(pair):
    """Every slot matched: the median gate is live. An even count takes
    the mean of the two middle costs (jnp.median), which rejects some
    matches; both packages reject the same ones."""
    cfg, gl, gr, _, kp_l, kp_r = pair
    j, _ = _both_match(cfg, kp_l, kp_r, gl, gr)
    rows = np.nonzero(j[0] >= 0)[0]
    rows = rows[: len(rows) // 2 * 2]
    sub = [x[rows] for x in kp_l]
    j2, t2 = _both_match(cfg, sub, kp_r, gl, gr)
    _assert_match_parity(j2, t2)
    kept = (t2[0] >= 0).sum()
    assert 0 < kept < len(rows)                 # the gate rejected some


@pytest.mark.parametrize("costs, ok", [
    ([4.0, 1.0, 3.0, 2.0], [1, 1, 1, 1]),       # even: (2 + 3) / 2
    ([4.0, 1.0, 3.0], [1, 1, 1]),               # odd: middle
    ([4.0, 1.0, 3.0, 2.0], [1, 0, 1, 1]),       # unmatched slot: 1e9
    ([0.5, 7.25], [1, 1]),
])
def test_median_gate_semantics(costs, ok):
    c = np.asarray(costs, np.float32)
    ok = np.asarray(ok, bool)
    want = np.nan_to_num(np.asarray(jnp.median(jnp.where(jnp.asarray(ok),
                                                         jnp.asarray(c),
                                                         jnp.nan))),
                         nan=1e9)
    got = tstereo._jax_median_gate(_t(ok), _t(c))
    assert float(got) == float(want)


def test_build_stereo_frame(pair):
    """The whole frame: two extractions + match. The port's descriptors
    differ from the JAX package's in ~1 % of keypoints (last-bit IC
    angles, test_torch_orb.py), so matches agree on >= 97 % of slots
    and the depths of the slots both matched agree as above."""
    cfg, gl, gr, _, _, _ = pair
    f_j = jframe.build_stereo_frame(cfg, gl, gr)
    f_t = tframe.build_stereo_frame(port_config(cfg), gl, gr, device="cpu")
    for name in ("level", "valid", "inv_sigma2"):
        np.testing.assert_array_equal(getattr(f_t, name).numpy(),
                                      np.asarray(getattr(f_j, name)))
    ok_j, ok_t = np.asarray(f_j.ur) >= 0, f_t.ur.numpy() >= 0
    assert (ok_j == ok_t).mean() >= 0.97
    both = ok_j & ok_t
    same = np.abs(f_t.ur.numpy()[both] - np.asarray(f_j.ur)[both]) <= UR_ATOL
    assert same.mean() >= 0.97
    assert f_t.depth.dtype == torch.float32 and f_t.R.dtype == np.float32
