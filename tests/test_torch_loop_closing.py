"""The port's loop closing (slam/loop_closing.py) against the JAX
package's, on the CPU, at the small test configuration.

One module fixture drives the JAX package's default RGB-D system (loop
closing on, synchronous global BA) over the 110-frame revisiting orbit
of tests/test_background_gba.py (`orbit_trajectory(110, angle_range=
2.4 pi)`) and records, at its loop closure, the map before the Sim3
computation, the snapshot and result of that computation, and the map
before and after the correction. Each record is carried into the port
with MapStore.load_arrays.

Held to:
* the Sim3 computation on the carried map: the same snapshot (exact), the
  same BoW matches (exact: gated-NN), the same RANSAC inliers given JAX's
  own minimal sets, the same optimized inlier matches (exact), S12 within
  1e-4;
* the correction (Sim3 propagation, point re-mapping, fusion, essential
  graph; global BA off) from the same map and hypothesis: the same
  observation table and live sets (exact), poses within 1e-4, points
  within 1e-4 relative;
* end to end, the port's default system over the same frames: >= 1 loop
  closed, <= 2 frames lost, ATE < 4 cm (trajectory(), as the JAX test
  gates it) before and after final_optimize, and the JAX package's loop
  count; the centre-to-centre gap between the two trajectories is
  printed and held to a median of 2 cm.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_map_tpu.io import evaluate
from orb_slam2_map_tpu.io.synthetic import (SyntheticRGBDSequence,
                                            orbit_trajectory)
from orb_slam2_map_tpu.ops import matching as jmatching
from orb_slam2_map_tpu.slam import SLAMSystem as JSLAMSystem
from orb_slam2_map_tpu.slam import Sensor as JSensor
from orb_slam2_map_tpu.slam.loop_closing import LoopCloser as JLoopCloser
from orb_slam2_map_tpu_torch.place.database import KeyFrameDatabase
from orb_slam2_map_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_map_tpu_torch.slam.mapstore import MapStore as TMapStore
from orb_slam2_map_tpu_torch.slam.system import SLAMSystem, Sensor

from test_torch_orb import port_config
from test_torch_sim3 import _jax_draws

torch.set_num_threads(2)

N_FRAMES = 110
KW = dict(max_keyframes=128, max_points=1 << 15)
CARRY = (*TMapStore._STATE_FIELDS, "_next_kf", "_next_mp", "kf_origin",
         "version", "loop_edges")


def _state(m) -> dict:
    return {k: (np.array(getattr(m, k)) if isinstance(getattr(m, k),
                                                      np.ndarray)
                else list(getattr(m, k)) if k == "loop_edges"
                else getattr(m, k)) for k in CARRY}


@pytest.fixture(scope="module")
def orbit(small_world):
    world, cfg = small_world
    Twc, ts = orbit_trajectory(N_FRAMES, angle_range=2.4 * np.pi)
    seq = SyntheticRGBDSequence(world, Twc, ts)
    frames = [seq[i] for i in range(N_FRAMES)]
    return cfg, Twc, ts, frames


@pytest.fixture(scope="module")
def jax_run(orbit):
    """The JAX package's default system over the orbit, with its loop
    closer's inputs and outputs recorded around the first closure."""
    cfg, Twc, ts, frames = orbit
    rec = {"sim3": [], "correct": None}
    compute, correct = JLoopCloser._compute_sim3, JLoopCloser._correct_loop
    essential = JLoopCloser._optimize_essential_graph

    def rec_compute(self, s):
        before = _state(self.map)
        out = compute(self, s)
        rec["sim3"].append((before, s, out))
        return out

    def rec_correct(self, kid, loop_kf, S12, loop_points=None, mkp=None,
                    mmp=None):
        first = rec["correct"] is None
        if first:
            rec["correct"] = {"before": _state(self.map), "args": (
                kid, loop_kf, S12, np.array(loop_points), np.array(mkp),
                np.array(mmp))}
        return correct(self, kid, loop_kf, S12, loop_points, mkp, mmp)

    def rec_essential(self, *args, **kwargs):
        out = essential(self, *args, **kwargs)
        if rec["correct"] is not None and "after" not in rec["correct"]:
            rec["correct"]["after"] = _state(self.map)
        return out

    JLoopCloser._compute_sim3 = rec_compute
    JLoopCloser._correct_loop = rec_correct
    JLoopCloser._optimize_essential_graph = rec_essential
    try:
        slam = JSLAMSystem(cfg, JSensor.RGBD, **KW)
        lost = sum(slam.track_rgbd(t, g, d) is None for t, g, d, _ in frames)
    finally:
        JLoopCloser._compute_sim3 = compute
        JLoopCloser._correct_loop = correct
        JLoopCloser._optimize_essential_graph = essential
    return slam, lost, rec


def _port_closer(cfg, arrays, run_global_ba=True):
    tcfg = port_config(cfg)
    m = TMapStore(KW["max_keyframes"], KW["max_points"], arrays["kf_obs"].shape[1])
    m.load_arrays(arrays)
    db = KeyFrameDatabase(tcfg, m, device="cpu")
    return LoopCloser(tcfg, m, db, fix_scale=True,
                      run_global_ba=run_global_ba, device="cpu")


def test_jax_run_closed_a_loop(jax_run):
    slam, lost, rec = jax_run
    lc = slam.loop_closer
    print(f"JAX sync run: {lc.n_loops_closed} loops, lost {lost}, "
          f"{len(rec['sim3'])} Sim3 computations, "
          f"{slam.map.n_keyframes()} keyframes")
    assert lc.n_loops_closed >= 1 and rec["correct"] is not None
    assert "after" in rec["correct"]


def test_compute_sim3_parity(orbit, jax_run):
    """Every Sim3 computation of the JAX run, replayed on the port from
    the carried map with JAX's own RANSAC draws."""
    cfg = orbit[0]
    _, _, rec = jax_run
    n_ok = 0
    for before, js, jout in rec["sim3"]:
        closer = _port_closer(cfg, before)
        ts = closer._snapshot_pair(js.kid, js.cand)
        for f in ("obs2", "has1", "has2", "desc1", "desc2", "level1",
                  "level2", "xy1", "xy2", "Xc1_all", "Xc2_all", "min_dist1",
                  "max_dist1", "min_dist2", "max_dist2"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)
        # the standalone BoW match (the loop path's gated-NN launch)
        gate = js.has1[:, None] & js.has2[None, :]
        res = jmatching.gated_nn(jnp.asarray(js.desc1), jnp.asarray(js.desc2),
                                 jnp.asarray(gate), max_dist=50.0,
                                 ratio=0.75, standalone=True)
        keep = np.asarray(jmatching.resolve_duplicates(res.idx, res.dist,
                                                       res.ok, closer.map.N))
        rows_j = np.nonzero(keep)[0]
        rows_t, cols_t = closer._bow_match(ts)
        np.testing.assert_array_equal(rows_t, rows_j)
        np.testing.assert_array_equal(cols_t, np.asarray(res.idx)[rows_j])
        npts = min(len(rows_j), closer.SIM3_RANSAC_PAD)
        valid = np.arange(closer.SIM3_RANSAC_PAD) < npts
        tout = closer._compute_sim3(ts, idx=_jax_draws(valid, js.kid))
        assert (tout is None) == (jout is None)
        if jout is None:
            continue
        n_ok += 1
        (Rj, tj, sj), mkp_j, mmp_j = jout
        (Rt, tt, st), mkp_t, mmp_t = tout
        np.testing.assert_array_equal(mkp_t, mkp_j)
        np.testing.assert_array_equal(mmp_t, mmp_j)
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-4)
        assert abs(st - sj) <= 1e-4
    print(f"{len(rec['sim3'])} Sim3 computations replayed, {n_ok} accepted")
    assert n_ok >= 1


def test_correct_loop_parity(orbit, jax_run):
    """The JAX run's first correction, replayed on the carried map with
    the JAX hypothesis: the same map after the essential graph."""
    cfg = orbit[0]
    _, _, rec = jax_run
    corr = rec["correct"]
    closer = _port_closer(cfg, corr["before"], run_global_ba=False)
    kid, loop_kf, S12, loop_points, mkp, mmp = corr["args"]
    closer._correct_loop(kid, loop_kf, S12, loop_points, mkp, mmp)
    m, want = closer.map, corr["after"]
    for f in ("kf_exists", "mp_exists", "kf_obs", "parent", "covis",
              "mp_obs_count"):
        np.testing.assert_array_equal(getattr(m, f), want[f], err_msg=f)
    assert [tuple(e) for e in m.loop_edges] == \
        [tuple(e) for e in want["loop_edges"]]
    kfs = np.nonzero(want["kf_exists"])[0]
    mids = np.nonzero(want["mp_exists"])[0]
    moved = np.abs(want["kf_t"][kfs] - corr["before"]["kf_t"][kfs]).max()
    gap_R = np.abs(m.kf_R[kfs] - want["kf_R"][kfs]).max()
    gap_t = np.abs(m.kf_t[kfs] - want["kf_t"][kfs]).max()
    dX = np.linalg.norm(m.mp_pos[mids] - want["mp_pos"][mids], axis=1)
    rel = dX / np.maximum(1.0, np.linalg.norm(want["mp_pos"][mids], axis=1))
    print(f"correction of KF {kid} to loop KF {loop_kf}: moved keyframes up "
          f"to {moved:.4f} m; port - jax |dR| {gap_R:.2e}, |dt| {gap_t:.2e}, "
          f"points max relative {rel.max():.2e}")
    assert moved > 1e-3
    assert gap_R <= 1e-4 and gap_t <= 1e-4
    assert rel.max() <= 1e-4


def test_end_to_end_sync_orbit(orbit, jax_run):
    cfg, Twc, ts, frames = orbit
    jslam, jlost, _ = jax_run
    s = SLAMSystem(port_config(cfg), Sensor.RGBD, device="cpu", **KW)
    assert s.loop_closer is not None and s.place_db is not None
    assert s.tracker.relocalizer is s.place_db
    lost = sum(s.track_rgbd(t, g, d) is None for t, g, d, _ in frames)
    lc = s.loop_closer
    ts_p, T_p = s.trajectory()
    ate = evaluate.ate_rmse(ts_p, T_p[:, :3, 3], ts, Twc[:, :3, 3])
    ts_j, T_j = jslam.trajectory()
    ate_j = evaluate.ate_rmse(ts_j, T_j[:, :3, 3], ts, Twc[:, :3, 3])
    gba = s.final_optimize()
    ts_f, T_f = s.trajectory()
    ate_f = evaluate.ate_rmse(ts_f, T_f[:, :3, 3], ts, Twc[:, :3, 3])
    np.testing.assert_array_equal(ts_p, ts_j)
    gap = np.linalg.norm(T_p[:, :3, 3] - T_j[:, :3, 3], axis=1)
    print(f"port sync: {lc.n_loops_closed} loops {lc.closures}, "
          f"{lc.n_sim3_attempts} Sim3 attempts, lost {lost}, "
          f"{s.map.n_keyframes()} keyframes, ATE {ate * 100:.3f} cm, after "
          f"final_optimize {ate_f * 100:.3f} cm ({gba.n_iters} LM "
          f"iterations); JAX sync: {jslam.loop_closer.n_loops_closed} loops, "
          f"lost {jlost}, ATE {ate_j * 100:.3f} cm; centre gap port vs jax "
          f"median {np.median(gap) * 1e3:.3f} mm, max {gap.max() * 1e3:.3f} mm")
    assert lc.n_loops_closed >= 1
    assert lc.n_loops_closed == jslam.loop_closer.n_loops_closed
    assert lost <= 2 and len(ts_p) >= N_FRAMES - 2
    assert ate < 0.04 and ate_f < 0.04
    assert np.median(gap) <= 0.02

    # a kidnapped tracker relocalizes through the BoW-ranked candidates
    ranked = []
    rank = s.place_db.reloc_candidates
    s.place_db.reloc_candidates = lambda f: ranked.append(rank(f)) or ranked[-1]
    s.tracker.state = type(s.tracker.state).LOST
    s.tracker.velocity = None
    t, g, d, _ = frames[55]
    pose = s.track_rgbd(t, g, d)
    assert pose is not None and s.tracking_state.name == "OK"
    assert len(ranked) == 1 and len(ranked[0]) >= 1
    _, A_R, A_t = evaluate.umeyama_alignment(T_f[:, :3, 3], Twc[:, :3, 3])
    c = A_R @ (-pose[:3, :3].T @ pose[:3, 3]) + A_t
    assert np.linalg.norm(c - Twc[55, :3, 3]) < 0.04
    # the replayed frame is logged after frame 109 with frame 55's
    # timestamp; trajectory() reads the logs in timestamp order, so the
    # refinement's kinematic pass does not take it for frame 109's
    # neighbour (it did: 1.55 -> 33.19 cm ATE on this orbit)
    ts_k, T_k = s.trajectory()
    ate_k = evaluate.ate_rmse(ts_k, T_k[:, :3, 3], ts, Twc[:, :3, 3])
    assert len(ts_k) == len(ts_f) + 1 and (np.diff(ts_k) >= 0).all()
    assert abs(ate_k - ate_f) < 0.005

    # a map transform re-bases the tracker's last pose: Tcw' = Tcw A^-1
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    A[:3, 3] = [0.1, -0.2, 0.3]
    before = s.tracker._pose_of(s.tracker.last_frame)
    s.tracker.apply_map_transform(A)
    np.testing.assert_allclose(s.tracker._pose_of(s.tracker.last_frame),
                               before @ np.linalg.inv(A), atol=1e-6)
    s.reset()
    assert s.map.n_keyframes() == 0 and not s.place_db._has_bow.any()


def test_pipeline_with_loop_closer_is_not_ported(small_world):
    _, cfg = small_world
    s = SLAMSystem(port_config(cfg), Sensor.RGBD, device="cpu",
                   max_keyframes=8, max_points=256)
    with pytest.raises(NotImplementedError, match="dense"):
        s.pipeline
    with pytest.raises(NotImplementedError, match="dense"):
        s.track_rgbd_async(0.0, np.zeros((240, 320), np.float32),
                           np.zeros((240, 320), np.float32))


def test_loop_closing_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.slam.loop_closing, "
            "orb_slam2_map_tpu_torch.slam.system; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
