"""Parity of the PyTorch port's tracking slice against the JAX package.

* The slice: a 30-frame sweep at the small test configuration, frames
  rendered once by the JAX world and fed to both `Tracker`s. Bounds:
  both lose no frame and make the same keyframes; per-frame camera
  centres differ by a median <= 2 mm and a max <= 1 cm; the port's raw
  ATE is <= 1 cm. The two front ends agree bit for bit (see
  test_torch_orb.py); the differences come from the pose solver's last
  bits, fed back through the motion model frame after frame.
* The per-frame steps on one shared carry and map: the map-point
  bindings exactly, the pose within 1e-3 (one LM run; see
  test_torch_pose_opt.py for its own 1e-4 bound).
* The map store's state exchange and device columns, the renderer, and
  that the package imports without JAX.
"""

import copy
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_config
from orb_slam2_map_tpu.io.evaluate import ate_rmse
from orb_slam2_map_tpu.io.synthetic import SyntheticWorld, sweep_trajectory
from orb_slam2_map_tpu.ops import orb as jorb
from orb_slam2_map_tpu.slam import frame as jframe
from orb_slam2_map_tpu.slam import pipeline_step as jps
from orb_slam2_map_tpu.slam.mapstore import MapStore as JMapStore
from orb_slam2_map_tpu.slam.tracking import Tracker as JTracker
from orb_slam2_map_tpu_torch.geom.camera import PinholeCamera as TCam
from orb_slam2_map_tpu_torch.io import synthetic as tsyn
from orb_slam2_map_tpu_torch.slam import pipeline_step as tps
from orb_slam2_map_tpu_torch.slam.mapstore import MapStore as TMapStore
from orb_slam2_map_tpu_torch.slam.tracking import FrameLog
from orb_slam2_map_tpu_torch.slam.tracking import Tracker as TTracker

from test_torch_kernels import _t
from test_torch_orb import port_config

torch.set_num_threads(1)

N_FRAMES = 30


def _centres(T):
    return T[:, :3, 3]


@pytest.fixture(scope="module")
def sweep():
    cfg = small_config()
    world = SyntheticWorld(cam=cfg.camera)
    Twc, ts = sweep_trajectory(N_FRAMES)
    frames = [world.render(T) for T in Twc]
    return cfg, world, Twc, ts, frames


def _run(tracker, ts, frames):
    lost = 0
    for i, (gray, depth, _) in enumerate(frames):
        lost += tracker.track_rgbd(ts[i], gray, depth) is None
    return lost


@pytest.fixture(scope="module")
def trackers(sweep):
    cfg, _, _, ts, frames = sweep
    n = jorb.total_capacity(cfg.orb)
    jt = JTracker(cfg, JMapStore(max_keyframes=64, max_points=1 << 14,
                                 kp_capacity=n), local_mapper=None)
    tt = TTracker(port_config(cfg), TMapStore(max_keyframes=64,
                                              max_points=1 << 14,
                                              kp_capacity=n),
                  local_mapper=None, device="cpu")
    return jt, _run(jt, ts, frames), tt, _run(tt, ts, frames)


def test_slice_parity(sweep, trackers):
    _, _, Twc, ts, _ = sweep
    jt, j_lost, tt, t_lost = trackers
    assert j_lost == 0 and t_lost == 0
    assert tt.map.n_keyframes() == jt.map.n_keyframes()
    ts_j, T_j = jt.trajectory(refine=False)
    ts_t, T_t = tt.trajectory(refine=False)
    np.testing.assert_array_equal(ts_t, ts_j)
    d = np.linalg.norm(_centres(T_t) - _centres(T_j), axis=1)
    assert np.median(d) <= 0.002, d
    assert d.max() <= 0.01, d
    ate = ate_rmse(ts_t, _centres(T_t), ts, _centres(Twc))
    assert ate <= 0.01, ate
    ts_r, T_r = tt.trajectory(refine=True)
    assert ate_rmse(ts_r, _centres(T_r), ts, _centres(Twc)) <= 0.01


def _shared_state(cfg, jt, frames):
    """Carry, map and local candidates from the JAX tracker's last frame,
    as numpy, plus the next frame of the periodic sweep."""
    lf = jt.last_frame
    Rv, tv = jt.velocity
    carry = dict(R=np.asarray(lf.R), t=np.asarray(lf.t), Rv=Rv, tv=tv,
                 cur_obs=jt.last_obs.astype(np.int32),
                 last_xy=np.asarray(lf.xy), last_ur=np.asarray(lf.ur),
                 last_depth=np.asarray(lf.depth), last_desc=np.asarray(lf.desc),
                 last_level=np.asarray(lf.level), last_angle=np.asarray(lf.angle),
                 last_valid=np.asarray(lf.valid), ok=np.asarray(True))
    carry = {k: (v.astype(np.float32) if np.asarray(v).dtype == np.float64
                 else np.asarray(v)) for k, v in carry.items()}
    _, mids_p, mp_valid = jt._local_candidates(jt.last_obs)
    gray, depth, _ = frames[1]        # the sweep is periodic: frame 1 follows
    return carry, mids_p.astype(np.int32), mp_valid, gray, depth


def test_fused_frame_step_parity(sweep, trackers):
    cfg, _, _, _, frames = sweep
    jt, _, _, _ = trackers
    carry, mids, mp_valid, gray, depth = _shared_state(cfg, jt, frames)
    jm = jt.map
    tm = TMapStore.from_arrays({k: getattr(jm, k) for k in TMapStore._STATE_FIELDS}
                               | dict(_next_kf=jm._next_kf, _next_mp=jm._next_mp))
    ctrl = np.asarray([3.0, 30.0, 1.0, 1.0], np.float32)
    jcols = jm.device_point_arrays()
    tcols = tm.device_point_arrays("cpu")
    for name in jcols:
        np.testing.assert_array_equal(tcols[name].numpy(),
                                      np.asarray(jcols[name]).view(
                                          tcols[name].numpy().dtype))
    j_carry, j_packed, _ = jps.fused_frame_step(
        cfg, jps.TrackCarry(**{k: jnp.asarray(v) for k, v in carry.items()}),
        jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(ctrl),
        jcols["mp_pos"], jcols["mp_desc"], jcols["mp_normal"],
        jcols["mp_min_dist"], jcols["mp_max_dist"], jnp.asarray(jm.mp_exists),
        jnp.asarray(mids), jnp.asarray(mp_valid), jcols["mp_redirect"])
    t_carry, t_packed, _ = tps.fused_frame_step(
        port_config(cfg), tps.TrackCarry.from_numpy(**carry), _t(gray),
        _t(depth), _t(ctrl), tcols["mp_pos"], tcols["mp_desc"],
        tcols["mp_normal"], tcols["mp_min_dist"], tcols["mp_max_dist"],
        _t(tm.mp_exists), _t(mids), _t(mp_valid), tcols["mp_redirect"])
    jp, tp = np.asarray(j_packed), t_packed.numpy()
    assert jp[5] == 1.0 and tp[5] == 1.0                      # ok
    np.testing.assert_array_equal(tp[:8], jp[:8])            # match counts
    np.testing.assert_array_equal(t_carry.cur_obs.numpy(),
                                  np.asarray(j_carry.cur_obs))
    np.testing.assert_allclose(t_carry.R.numpy(), np.asarray(j_carry.R),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_carry.t.numpy(), np.asarray(j_carry.t),
                               rtol=0, atol=1e-3)


def test_chain_steps_parity(sweep, trackers):
    """motion_match_step -> local_map_step -> pack_frame_result, and the
    single-step tracking_step, on one shared state."""
    cfg, _, _, _, frames = sweep
    jt, _, _, _ = trackers
    carry, mids, mp_valid, gray, depth = _shared_state(cfg, jt, frames)
    tcfg = port_config(cfg)
    jf = jframe.build_rgbd_frame(cfg, gray, depth)
    tf = tps.frame_mod.Frame(
        **{k: _t(np.asarray(getattr(jf, k))) for k in jf._fields
           if k not in ("R", "t")}, R=np.asarray(jf.R), t=np.asarray(jf.t))
    lo = carry["cur_obs"]
    alive = lo >= 0
    X = np.asarray(jt.map.mp_pos)[np.clip(lo, 0, None)]
    R0s = np.stack([carry["Rv"] @ carry["R"], carry["R"]]).astype(np.float32)
    t0s = np.stack([carry["Rv"] @ carry["t"] + carry["tv"],
                    carry["t"]]).astype(np.float32)
    last = [carry[k] for k in ("last_level", "last_ur", "last_desc",
                               "last_angle")]
    j_mm = jps.motion_match_step(cfg, jf, X, alive, *last, lo, 20,
                                 (jnp.asarray(R0s), jnp.asarray(t0s)))
    t_mm = tps.motion_match_step(tcfg, tf, _t(X), _t(alive),
                                 *(_t(a) for a in last), _t(lo), 20,
                                 (_t(R0s), _t(t0s)))
    np.testing.assert_array_equal(t_mm.cur_obs.numpy(), np.asarray(j_mm.cur_obs))
    assert int(t_mm.n_inliers) == int(j_mm.n_inliers) > 50
    np.testing.assert_allclose(t_mm.t.numpy(), np.asarray(j_mm.t), atol=1e-3)

    jcols = jt.map.device_point_arrays()
    tm = TMapStore.from_arrays({k: getattr(jt.map, k)
                                for k in TMapStore._STATE_FIELDS})
    tcols = tm.device_point_arrays("cpu")
    inits = (np.stack([np.asarray(j_mm.R), carry["R"]]),
             np.stack([np.asarray(j_mm.t), carry["t"]]))
    names = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist")
    j_lm = jps.local_map_step(cfg, jf, *(jcols[k] for k in names), mids,
                              mp_valid, j_mm.cur_obs,
                              tuple(jnp.asarray(a) for a in inits), 3.0)
    t_lm = tps.local_map_step(tcfg, tf, *(tcols[k] for k in names), _t(mids),
                              _t(mp_valid), _t(np.asarray(j_mm.cur_obs)),
                              tuple(_t(a) for a in inits), 3.0)
    np.testing.assert_array_equal(t_lm.cur_obs.numpy(), np.asarray(j_lm.cur_obs))
    np.testing.assert_array_equal(t_lm.visible.numpy(), np.asarray(j_lm.visible))
    for k in ("n_inliers", "n_close_tracked", "n_close_untracked"):
        assert int(getattr(t_lm, k)) == int(getattr(j_lm, k)), k
    np.testing.assert_allclose(t_lm.R.numpy(), np.asarray(j_lm.R), atol=1e-3)
    jp = np.asarray(jps.pack_frame_result(j_mm, j_lm))
    tp = tps.pack_frame_result(t_mm, t_lm).numpy()
    np.testing.assert_array_equal(tp[:5], jp[:5])
    np.testing.assert_array_equal(tp[17:], jp[17:])
    np.testing.assert_allclose(tp[5:17], jp[5:17], atol=1e-3)

    j_ts = jps.tracking_step(cfg, jnp.asarray(gray), jnp.asarray(depth), X,
                             alive, *last[:3], R0s[0], t0s[0])
    t_ts = tps.tracking_step(tcfg, _t(gray), _t(depth), _t(X), _t(alive),
                             *(_t(a) for a in last[:3]), _t(R0s[0]),
                             _t(t0s[0]))
    assert int(t_ts.n_matches) == int(j_ts.n_matches)
    assert int(t_ts.n_inliers) == int(j_ts.n_inliers)
    np.testing.assert_allclose(t_ts.t.numpy(), np.asarray(j_ts.t), atol=1e-3)


def test_mapstore_state_and_device_columns(trackers):
    jt, _, tt, _ = trackers
    tm = TMapStore.from_arrays({k: getattr(jt.map, k)
                                for k in TMapStore._STATE_FIELDS})
    np.testing.assert_array_equal(tm.mp_desc, jt.map.mp_desc)
    assert tm.n_keyframes() == jt.map.n_keyframes()
    assert tm.n_points() == jt.map.n_points()
    k = int(tm.keyframe_ids()[-1])
    np.testing.assert_array_equal(tm.covisible_keyframes(k),
                                  jt.map.covisible_keyframes(k))
    state = {k: getattr(tt.map, k) for k in TMapStore._STATE_FIELDS}
    again = TMapStore.from_arrays(state)
    for name in TMapStore._STATE_FIELDS:
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(tt.map, name))
    # dirty rows are copied in place into the cached columns
    cols = again.device_point_arrays("cpu")
    ids = again.point_ids()[:5]
    again.mp_pos[ids] += 1.0
    again.mp_desc[ids[0]] = 0xFFFFFFFF
    again.mark_points_dirty(ids)
    again.version += 1
    cols2 = again.device_point_arrays("cpu")
    assert cols2["mp_pos"] is cols["mp_pos"]
    fresh = TMapStore.from_arrays(
        {k: getattr(again, k) for k in TMapStore._STATE_FIELDS}
    ).device_point_arrays("cpu")
    for name in cols2:
        np.testing.assert_array_equal(cols2[name].numpy(), fresh[name].numpy())
    assert cols2["mp_desc"][ids[0]].tolist() == [-1] * 8


def _map_copy(jm):
    """The port's MapStore holding the JAX map's state."""
    return TMapStore.from_arrays(
        {k: getattr(jm, k) for k in TMapStore._STATE_FIELDS}
        | dict(_next_kf=jm._next_kf, _next_mp=jm._next_mp,
               kf_origin=jm.kf_origin, version=jm.version))


def _lost_pair(cfg, jt):
    """A JAX and a port tracker, LOST, over copies of the same map."""
    jl = JTracker(cfg, copy.deepcopy(jt.map), local_mapper=None)
    tl = TTracker(port_config(cfg), _map_copy(jt.map), local_mapper=None,
                  device="cpu")
    for tr in (jl, tl):
        tr.state = tr.state.__class__.LOST
        tr.velocity = None
        tr.frame_id = jt.frame_id
    return jl, tl


def test_relocalization_parity(sweep, trackers):
    """Relocalization of a LOST tracker against the JAX tracker's map,
    both packages on the same frames: the same candidate keyframe,
    camera centres within 1 mm and rotations within 1e-3 rad of each
    other, inlier counts within 3, and centres within 2 cm of ground
    truth (the map frame is the first camera's)."""
    cfg, _, Twc, ts, frames = sweep
    jt, _, _, _ = trackers
    jl, tl = _lost_pair(cfg, jt)
    to_map = np.linalg.inv(Twc[0])
    for i in (5, 12, 21):
        gray, depth, _ = frames[i]
        jl.frame_id = tl.frame_id = 100 + i
        ok_j, f_j, obs_j = jl._relocalize(jframe.build_rgbd_frame(cfg, gray, depth))
        ok_t, f_t, obs_t = tl._relocalize(
            tps.frame_mod.build_rgbd_frame(port_config(cfg), gray, depth,
                                           device="cpu"))
        assert ok_j and ok_t, (i, ok_j, ok_t)
        assert jl.ref_kf == tl.ref_kf, (i, jl.ref_kf, tl.ref_kf)
        Rj, tj = np.asarray(f_j.R), np.asarray(f_j.t)
        c_j, c_t = -Rj.T @ tj, -f_t.R.T @ f_t.t
        assert np.linalg.norm(c_t - c_j) <= 1e-3, (i, c_t, c_j)
        cos = np.clip(0.5 * (np.trace(f_t.R @ Rj.T) - 1.0), -1.0, 1.0)
        assert np.arccos(cos) <= 1e-3, (i, np.arccos(cos))
        assert abs(int((obs_t >= 0).sum()) - int((obs_j >= 0).sum())) <= 3
        c_gt = (to_map @ Twc[i])[:3, 3]
        assert np.linalg.norm(c_t - c_gt) <= 0.02, (i, c_t, c_gt)
    # through the state machine: LOST -> relocalized -> OK, with the
    # after-reloc window opened at this frame
    gray, depth, _ = frames[8]
    tl.frame_id = 200
    tl.state, tl.velocity = tl.state.__class__.LOST, None
    assert tl.track_rgbd(ts[8], gray, depth) is not None
    assert tl.state.name == "OK" and tl.last_reloc_frame_id == 201


def test_reloc_motion_gate_parity(sweep, trackers):
    """_reloc_aliased on a constructed failure time, supervised pose and
    log history: the same accept/reject decisions in both packages."""
    from orb_slam2_map_tpu.slam.tracking import FrameLog as JLog
    from orb_slam2_map_tpu_torch.slam.tracking import FrameLog as TLog

    cfg, _, _, _, _ = sweep
    jt, _, _, _ = trackers
    jl, tl = _lost_pair(cfg, jt)
    kfs = jt.map.keyframe_ids()
    rng = np.random.default_rng(0)
    for tr, Log in ((jl, JLog), (tl, TLog)):
        assert not tr._reloc_aliased(np.eye(3, dtype=np.float32),
                                     np.zeros(3, np.float32))  # no failure
        tr.failure_ts = [1.0]
        tr.async_pose = (np.eye(3, dtype=np.float32),
                         np.asarray([0.0, 0.0, -0.1], np.float32))
        tr._cur_ts = 1.5
        tr.logs = []
    for k in range(6):
        Tcr = np.eye(4, dtype=np.float32)
        Tcr[:3, 3] = [-0.05 * k, 0.0, 0.01 * k]
        for tr, Log in ((jl, JLog), (tl, TLog)):
            tr.logs.append(Log(timestamp=0.9 + 0.1 * k,
                               ref_kf=int(kfs[k % len(kfs)]), Tcr=Tcr,
                               lost=(k == 2)))
    decisions = []
    for jump in (0.0, 0.2, 0.6, 0.9, 1.5, 3.0):
        d = rng.normal(size=3)
        t = (-jump * d / np.linalg.norm(d)).astype(np.float32)
        R = np.eye(3, dtype=np.float32)
        a, b = jl._reloc_aliased(R, t), tl._reloc_aliased(R, t)
        assert a == b, (jump, a, b)
        decisions.append(a)
    assert any(decisions) and not all(decisions), decisions
    for tr in (jl, tl):
        tr._cur_ts = 5.0                       # outside the 3 s window
    assert not jl._reloc_aliased(R, t) and not tl._reloc_aliased(R, t)


def test_erase_keyframe_keeps_culled_chains():
    """Culling a keyframe whose child was culled before it leaves the
    child's parent as it was (the child's kf_Tcp is relative to that
    parent), and the trajectory composes a chain of culled keyframes as
    Trw * Tcp: a frame logged against the child keeps its pose. (The JAX
    package re-parents the culled child and composes it against its
    grandparent.)"""
    rng = np.random.default_rng(2)
    m = TMapStore(8, 64, 16)
    for k in range(4):
        kid = m.alloc_keyframe()
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m.kf_R[kid] = (R * np.sign(np.linalg.det(R))).astype(np.float32)
        m.kf_t[kid] = rng.normal(size=3).astype(np.float32)
        m.parent[kid] = kid - 1
    Tcw2 = m.kf_Tcw(2)
    m.erase_keyframe(2)
    m.erase_keyframe(1)
    assert m.parent[2] == 1 and m.parent[3] == 0
    tr = TTracker(port_config(small_config()), m, device="cpu")
    Tcr = np.eye(4, dtype=np.float32)
    Tcr[:3, 3] = [0.1, -0.2, 0.3]
    tr.logs.append(FrameLog(timestamp=0.0, ref_kf=2, Tcr=Tcr, lost=False))
    _, Twc = tr.trajectory(refine=False)
    np.testing.assert_allclose(Twc[0], np.linalg.inv(Tcr @ Tcw2), atol=1e-5)


def test_renderer_parity(sweep):
    cfg, world, Twc, _, frames = sweep
    textures = (np.asarray(world.coarse_tex), np.asarray(world.fine_tex),
                np.asarray(world.blob_tex))
    tw = tsyn.SyntheticWorld(cam=TCam(*cfg.camera), textures=textures,
                             device="cpu")
    for i in (0, 17):
        g_j, d_j, rgb_j = frames[i]
        g_t, d_t, rgb_t = tw.render(Twc[i])
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
        # texel lookups at floor() boundaries can flip on last-bit
        # differences of the ray math: a few pixels, elsewhere exact-ish
        close = np.abs(g_t - g_j) <= 1e-2
        assert close.mean() >= 0.995, close.mean()
        assert rgb_t.dtype == rgb_j.dtype and rgb_t.shape == rgb_j.shape
    # the seeded default textures follow the JAX distributions
    c, f, b = tsyn.make_textures(0)
    assert c.shape == textures[0].shape and b.shape == textures[2].shape
    assert 0.0 <= float(c.min()) and float(c.max()) < 1.0
    assert abs(float(b.mean()) - 0.015) < 0.002


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.slam.tracking, "
            "orb_slam2_map_tpu_torch.io.synthetic; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
