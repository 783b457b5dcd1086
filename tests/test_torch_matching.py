"""Parity of the PyTorch port's matching layer against the JAX package:
Hamming distance, the gated nearest-neighbour matcher (against both the
JAX plain path and the Pallas kernel in interpret mode), duplicate
resolution, the rotation histogram, the gates and the projection
searches. Descriptor inputs always include words with the top bit set.
All outputs compared here are integers, masks or integer-valued floats:
exact equality throughout.

The hand-written CUDA kernel itself is tested in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from conftest import small_config
from orb_slam2_map_tpu.io.synthetic import SyntheticWorld, sweep_trajectory
from orb_slam2_map_tpu.ops import matching as jm
from orb_slam2_map_tpu.ops import pallas_kernels
from orb_slam2_map_tpu.slam import frame as jframe
from orb_slam2_map_tpu.slam import search as jsearch
from orb_slam2_map_tpu_torch.ops import matching as tm
from orb_slam2_map_tpu_torch.slam import frame as tframe
from orb_slam2_map_tpu_torch.slam import search as tsearch

from test_torch_kernels import GATE_KINDS, _descs, _gate, _t
from test_torch_orb import port_config

torch.set_num_threads(1)


def test_hamming_exact():
    rng = np.random.default_rng(0)
    a, b = _descs(rng, 150, 97)
    np.testing.assert_array_equal(
        tm.hamming_matrix(_t(a), _t(b)).numpy(),
        np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    b2 = b.repeat(2, 0)[:150]
    np.testing.assert_array_equal(
        tm.hamming_distance(_t(a), _t(b2)).numpy(),
        np.asarray(jm.hamming_distance(jnp.asarray(a), jnp.asarray(b2))))


@pytest.mark.parametrize("kind", GATE_KINDS)
@pytest.mark.parametrize("shape", [(300, 257), (64, 1)])
def test_gated_nn_plain_matches_reference_and_pallas(kind, shape):
    n, m = shape
    rng = np.random.default_rng(GATE_KINDS.index(kind) * 1000 + n)
    a, b = _descs(rng, n, m)
    gate = _gate(kind, rng, n, m)
    idx, best, second = (x.numpy() for x in
                         tm.gated_nn_plain(_t(a), _t(b), _t(gate)))
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_best, p_second = (np.asarray(x) for x in
                                   pallas_kernels.gated_nn_pallas(
                                       jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(gate)))
    np.testing.assert_array_equal(idx, p_idx)
    np.testing.assert_array_equal(best, p_best)
    np.testing.assert_array_equal(second, p_second)
    # the matcher built on it == the JAX plain path (masked_nn)
    for max_dist, ratio in ((256.0, None), (100.0, 0.8), (50.0, 0.7)):
        ref = jm.gated_nn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gate),
                          max_dist=max_dist, ratio=ratio)
        got = tm.gated_nn(_t(a), _t(b), _t(gate), max_dist=max_dist,
                          ratio=ratio)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
        np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_duplicates_and_rotation(seed):
    rng = np.random.default_rng(seed)
    n, m = 400, 120
    idx = rng.integers(0, m, n).astype(np.int32)
    dist = rng.integers(0, 30, n).astype(np.float32)     # many equal dists
    ok = rng.uniform(size=n) < 0.8
    np.testing.assert_array_equal(
        tm.resolve_duplicates(_t(idx), _t(dist), _t(ok), m).numpy(),
        np.asarray(jm.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist),
                                         jnp.asarray(ok), m)))
    ang_a = rng.uniform(-3 * np.pi, 3 * np.pi, n).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    if seed == 2:   # histogram ties across the top-3 bins
        ang_a = np.round(ang_a / (2 * np.pi / 30)).astype(np.float32) \
            * np.float32(2 * np.pi / 30) + np.float32(0.01)
        ang_b[:] = 0.0
    np.testing.assert_array_equal(
        tm.rotation_consistency(_t(ang_a), _t(ang_b), _t(idx), _t(ok)).numpy(),
        np.asarray(jm.rotation_consistency(jnp.asarray(ang_a),
                                           jnp.asarray(ang_b),
                                           jnp.asarray(idx), jnp.asarray(ok))))


def test_masked_nn_and_gates():
    rng = np.random.default_rng(3)
    d = rng.integers(0, 60, (80, 70)).astype(np.float32)
    g = rng.uniform(size=(80, 70)) < 0.6
    for kw in (dict(ratio=0.9), dict(cross_check=True), dict(max_dist=20.0)):
        a = tm.masked_nn(_t(d), _t(g), **kw)
        b = jm.masked_nn(jnp.asarray(d), jnp.asarray(g), **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    q = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    k = rng.uniform(0, 100, (60, 2)).astype(np.float32)
    r = rng.uniform(1, 20, 50).astype(np.float32)
    lq, lk = rng.integers(0, 8, 50), rng.integers(0, 8, 60)
    urq = rng.uniform(0, 100, 50).astype(np.float32)
    urk = np.where(rng.uniform(size=60) < 0.3, -1.0,
                   rng.uniform(0, 100, 60)).astype(np.float32)
    F = rng.normal(size=(3, 3)).astype(np.float32)
    s2 = rng.uniform(1, 3, 60).astype(np.float32)
    pairs = [
        (tm.window_gate(_t(q), _t(k), _t(r)), jm.window_gate(q, k, r)),
        (tm.level_gate(_t(lq), _t(lk), -1, 0), jm.level_gate(lq, lk, -1, 0)),
        (tm.stereo_gate(_t(urq), _t(urk), _t(r)), jm.stereo_gate(urq, urk, r)),
        (tm.epipolar_gate(_t(q), _t(k), _t(F), _t(s2)),
         jm.epipolar_gate(q, k, F, s2)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def frames():
    cfg = small_config()
    world = SyntheticWorld(cam=cfg.camera)
    Twc, _ = sweep_trajectory(30)
    out = []
    for i in (0, 2):
        g, d, _ = world.render(Twc[i])
        out.append((jframe.build_rgbd_frame(cfg, g, d), g, d))
    return cfg, out, Twc


def _torch_frame(f_j):
    """The port's Frame holding exactly the JAX frame's columns."""
    kw = {name: _t(np.asarray(getattr(f_j, name)))
          for name in tframe.Frame._fields if name not in ("R", "t")}
    return tframe.Frame(**kw, R=np.asarray(f_j.R), t=np.asarray(f_j.t))


def test_projection_searches(frames):
    cfg, [(f0, _, _), (f1, _, _)], Twc = frames
    tcfg = port_config(cfg)
    tf0, tf1 = _torch_frame(f0), _torch_frame(f1)
    # world = camera 0; last-frame points from its depth
    Xw, has = jframe.unproject_valid(cfg, f0)
    Xw, has = np.asarray(Xw), np.asarray(has)
    T01 = np.linalg.inv(Twc[2]) @ Twc[0]
    R = T01[:3, :3].astype(np.float32)
    t = T01[:3, 3].astype(np.float32)
    for th in (15.0, 30.0):
        want = jsearch.search_by_projection_last_frame(
            cfg, R, t, Xw, has, th, f0.level, f0.ur, f0.desc, f1, f0.angle)
        got = tsearch.search_by_projection_last_frame(
            tcfg, _t(R), _t(t), _t(Xw), _t(has), th, tf0.level, tf0.ur,
            tf0.desc, tf1, tf0.angle)
        assert int(np.asarray(want.ok).sum()) > 50
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # local map: the same points with normals and depth bands
    c0 = np.zeros(3, np.float32)
    rays = Xw - c0
    dist = np.linalg.norm(rays, axis=1) + 1e-12
    normal = (rays / dist[:, None]).astype(np.float32)
    sf = np.asarray(cfg.orb.scale_factors, np.float32)
    dmax = (dist * sf[np.asarray(f0.level)]).astype(np.float32)
    dmin = (dmax / sf[-1]).astype(np.float32)
    taken = np.zeros(f1.capacity, bool)
    taken[::7] = True
    want = jsearch.search_by_projection_local(
        cfg, R, t, Xw, f0.desc, normal, dmin, dmax, 3.0, has, f1, taken)
    got = tsearch.search_by_projection_local(
        tcfg, _t(R), _t(t), _t(Xw), tf0.desc, _t(normal), _t(dmin),
        _t(dmax), 3.0, _t(has), tf1, _t(taken))
    assert int(np.asarray(want.ok).sum()) > 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # reference-keyframe match (all pairs) and the windowed matcher
    has_mp = np.asarray(f0.valid) & has
    for ratio in (0.7, 0.75):
        w_idx, w_keep = jsearch.match_frame_to_kf(cfg, f0.desc, f0.valid,
                                                  has_mp, f1, ratio)
        g_idx, g_keep = tsearch.match_frame_to_kf(tcfg, tf0.desc, tf0.valid,
                                                  _t(has_mp), tf1, ratio)
        np.testing.assert_array_equal(g_keep.numpy(), np.asarray(w_keep))
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    radius = np.full(f0.capacity, 20.0, np.float32)
    want = jsearch.match_descriptors_windowed(
        cfg, f0.desc, f0.xy, f0.valid, f1.desc, f1.xy, f1.valid,
        jnp.asarray(radius), f0.angle, f1.angle)
    got = tsearch.match_descriptors_windowed(
        tcfg, tf0.desc, tf0.xy, tf0.valid, tf1.desc, tf1.xy, tf1.valid,
        _t(radius), tf0.angle, tf1.angle)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
