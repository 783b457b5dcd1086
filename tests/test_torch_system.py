"""The port's `SLAMSystem` (stereo tracking with local mapping, no loop
closing) against the JAX package's, on the CPU, over the same 10-frame
stereo sequence; plus the facade's device default, its unported parts
and the KITTI / trajectory I/O copies.

The sequence: the full 10-frame `sweep_trajectory` at the small test
camera (320x240, 400 features, 4 levels) with the stereo baseline of
KITTI 00-02 (0.537 m, so bf = 258 * 0.537 = 138.6), both eyes rendered
by the JAX world. At the fixtures' own 7.75 cm baseline the JAX package
itself tracks such sequences above the 2 cm ATE gate: its stereo median
gate is dead (ops/stereo.py), and at disparities of 5-10 px the outlier
depths it lets through (test_torch_stereo.py prints their share) pull
the poses. Bounds: neither system loses a frame;
keyframe counts within 1; per-frame camera centres differ by a median
<= 2 mm and a max <= 1 cm; both raw ATEs <= 2 cm.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import small_config
from orb_slam2_map_tpu.io import kitti as jkitti
from orb_slam2_map_tpu.io import trajectory as jtraj
from orb_slam2_map_tpu.io.evaluate import ate_rmse
from orb_slam2_map_tpu.io.synthetic import SyntheticWorld, sweep_trajectory
from orb_slam2_map_tpu.slam import SLAMSystem as JSLAMSystem
from orb_slam2_map_tpu.slam import Sensor as JSensor
from orb_slam2_map_tpu_torch.io import kitti as tkitti
from orb_slam2_map_tpu_torch.io import synthetic as tsynthetic
from orb_slam2_map_tpu_torch.io import trajectory as ttraj
from orb_slam2_map_tpu_torch.slam import frame as tframe
from orb_slam2_map_tpu_torch.slam import mapstore as tmapstore
from orb_slam2_map_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_map_tpu_torch.slam.system import SLAMSystem, Sensor
from orb_slam2_map_tpu_torch.slam.tracking import Tracker

from test_torch_orb import port_config
from test_torch_stereo import stereo_pair

torch.set_num_threads(1)

N_FRAMES = 10
KITTI_BASELINE_M = 386.1448 / 718.856


def stereo_config():
    cfg = small_config()
    return cfg.replace(camera=cfg.camera._replace(
        bf=cfg.camera.fx * KITTI_BASELINE_M))


@pytest.fixture(scope="module")
def runs():
    cfg = stereo_config()
    world = SyntheticWorld(cam=cfg.camera)
    Twc, ts = sweep_trajectory(N_FRAMES)
    frames = [stereo_pair(world, T, cfg.camera.baseline)[:2] for T in Twc]
    kw = dict(enable_loop_closing=False, max_keyframes=64,
              max_points=1 << 14)
    js = JSLAMSystem(cfg, JSensor.STEREO, **kw)
    ts_ = SLAMSystem(port_config(cfg), Sensor.STEREO, device="cpu", **kw)
    lost = {}
    for name, s in (("jax", js), ("port", ts_)):
        lost[name] = sum(s.track_stereo(ts[i], gl, gr) is None
                         for i, (gl, gr) in enumerate(frames))
    return Twc, ts, js, ts_, lost


def test_stereo_system_parity(runs):
    Twc, ts, js, tsys, lost = runs
    assert lost == {"jax": 0, "port": 0}
    n_j, n_t = js.map.n_keyframes(), tsys.map.n_keyframes()
    assert abs(n_j - n_t) <= 1 and n_t >= 3    # local BA ran (> 2 KFs)
    ts_j, T_j = js.tracker.trajectory(refine=False)
    ts_t, T_t = tsys.tracker.trajectory(refine=False)
    np.testing.assert_array_equal(ts_t, ts_j)
    d = np.linalg.norm(T_t[:, :3, 3] - T_j[:, :3, 3], axis=1)
    ate = [ate_rmse(t, T[:, :3, 3], ts, Twc[:, :3, 3])
           for T, t in ((T_j, ts_j), (T_t, ts_t))]
    print(f"keyframes {n_j}/{n_t}, centre difference median "
          f"{np.median(d) * 1e3:.3f} mm max {d.max() * 1e3:.3f} mm, raw ATE "
          f"jax {ate[0] * 100:.3f} cm port {ate[1] * 100:.3f} cm")
    assert np.median(d) <= 0.002, d
    assert d.max() <= 0.01, d
    assert max(ate) <= 0.02, ate


def test_system_outputs_and_modes(runs, tmp_path):
    _, _, js, tsys, _ = runs
    ts_t, T_t = tsys.trajectory()
    assert T_t.shape == (N_FRAMES, 4, 4) and np.isfinite(T_t).all()
    for fn, jfn in (("save_trajectory_tum", "save_trajectory_tum"),
                    ("save_keyframe_trajectory_tum",
                     "save_keyframe_trajectory_tum")):
        getattr(tsys, fn)(str(tmp_path / f"{fn}.txt"))
        ts_r, T_r = jtraj.read_tum(str(tmp_path / f"{fn}.txt"))
        assert len(ts_r) == (N_FRAMES if fn == "save_trajectory_tum"
                             else tsys.map.n_keyframes())
    tsys.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    rows = np.loadtxt(tmp_path / "kitti.txt")
    np.testing.assert_allclose(rows.reshape(-1, 3, 4), T_t[:, :3, :4],
                               rtol=0, atol=1e-6)
    assert "local_mapping/local_ba" in tsys.profile_report()
    tsys.activate_localization_mode()
    assert tsys.tracker.only_tracking and not tsys.local_mapper.enabled
    tsys.deactivate_localization_mode()
    assert tsys.tracking_state.name == "OK"


def test_unported_parts_raise():
    """Dense mapping, monocular tracking, map save/load and the async
    pipeline with a loop closer raise, naming their ROADMAP slice; loop
    closing, background GBA and final_optimize are ported."""
    cfg = port_config(stereo_config())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SLAMSystem(cfg, Sensor.STEREO, device="cpu", enable_loop_closing=False,
                   enable_dense_mapping=True)
    s = SLAMSystem(cfg, Sensor.RGBD, background_gba=True, max_keyframes=8,
                   max_points=256, device="cpu")
    assert s.loop_closer is not None and s.loop_closer.background_gba
    assert s.final_optimize() is None           # an empty map: nothing to do
    for call in (lambda: s.track_monocular(0.0, None),
                 lambda: s.save_map("x"), lambda: s.load_map("x"),
                 lambda: s.pipeline):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    s.shutdown()


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points run on the card, and
    raise on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    cfg = port_config(stereo_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLAMSystem(cfg, Sensor.STEREO, enable_loop_closing=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tracker(cfg, tmapstore.MapStore(8, 256, 424))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmapstore.MapStore(8, 256, 424).device_point_arrays()
    from orb_slam2_map_tpu_torch.parallel.background import BackgroundGBA
    from orb_slam2_map_tpu_torch.place.database import KeyFrameDatabase
    from orb_slam2_map_tpu_torch.place.vocabulary import train_vocabulary
    from orb_slam2_map_tpu_torch.slam.loop_closing import LoopCloser

    desc = np.random.default_rng(0).integers(0, 2 ** 32, (64, 8),
                                             dtype=np.uint32)
    voc = train_vocabulary(desc, k=2, L=2)
    for build in (lambda: KeyFrameDatabase(cfg, tmapstore.MapStore(8, 256, 424)),
                  lambda: voc.transform(desc),
                  lambda: voc.bow_sparse(desc),
                  lambda: LoopCloser(cfg, tmapstore.MapStore(8, 256, 424), None),
                  lambda: BackgroundGBA(cfg, tmapstore.MapStore(8, 256, 424))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    img = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    for build in (lambda: tframe.build_rgbd_frame(cfg, img, img),
                  lambda: tframe.build_mono_frame(cfg, img),
                  lambda: tframe.build_stereo_frame(cfg, img, img),
                  lambda: tsynthetic.SyntheticWorld(cam=cfg.camera),
                  lambda: LocalMapper(cfg, tmapstore.MapStore(8, 256, 424))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_async_mapping_drains(runs):
    """async_mapping=True: keyframes go through the worker's queue; flush
    waits for it, shutdown stops it."""
    Twc, ts, _, _, _ = runs
    cfg = stereo_config()
    world = SyntheticWorld(cam=cfg.camera)
    s = SLAMSystem(port_config(cfg), Sensor.STEREO, enable_loop_closing=False,
                   async_mapping=True, max_keyframes=16, max_points=4096,
                   device="cpu")
    for i in range(4):
        gl, gr, _ = stereo_pair(world, Twc[i], cfg.camera.baseline)
        assert s.track_stereo(ts[i], gl, gr) is not None
    s.flush()
    assert s._queue.unfinished_tasks == 0 and s.map.n_keyframes() >= 1
    s.shutdown()
    assert s._worker is None


def test_kitti_io_copies(tmp_path):
    for seq in (0, 3, 7):
        assert tuple(tkitti.kitti_camera(seq)) == tuple(jkitti.kitti_camera(seq))
    rng = np.random.default_rng(0)
    Twc = np.tile(np.eye(4), (40, 1, 1))
    Twc[:, :3, 3] = np.cumsum(rng.normal(0, 5.0, (40, 3)), axis=0)
    path = str(tmp_path / "poses.txt")
    jtraj.write_kitti(path, Twc)
    np.testing.assert_array_equal(tkitti.load_poses(path),
                                  jkitti.load_poses(path))
    est = Twc.copy()
    est[:, :3, 3] *= 1.01
    lengths = (20, 50)
    assert tkitti.translational_drift(est, Twc, lengths) == \
        jkitti.translational_drift(est, Twc, lengths)
    ts = np.arange(40) / 10.0
    ttraj.write_tum(str(tmp_path / "a.txt"), ts, Twc)
    jtraj.write_tum(str(tmp_path / "b.txt"), ts, Twc)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_kitti_sequence_reader(tmp_path):
    from fixtures import make_kitti_fixture

    root, _ = make_kitti_fixture(str(tmp_path / "seq"), n_frames=3)
    tseq, jseq = tkitti.KittiSequence(root), jkitti.KittiSequence(root)
    assert len(tseq) == len(jseq) == 3
    assert tuple(tseq.camera) == tuple(jseq.camera)
    for a, b in zip(tseq[1], jseq[1]):
        np.testing.assert_array_equal(a, b)


def test_system_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import orb_slam2_map_tpu_torch.slam.system, "
            "orb_slam2_map_tpu_torch.io.kitti, "
            "orb_slam2_map_tpu_torch.ops.hamming_cuda; "
            "assert 'orb_slam2_map_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_rgbd_system_and_reset():
    """Sensor.RGBD: track_rgbd runs the tracker's launch chain with local
    mapping behind it; a stereo call is refused; reset empties the map.
    (A 15 cm view-change trigger makes keyframes on this short sweep.)"""
    cfg = small_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                   kf_translation_m=0.15))
    world = SyntheticWorld(cam=cfg.camera)
    Twc, ts = sweep_trajectory(N_FRAMES)
    s = SLAMSystem(port_config(cfg), Sensor.RGBD, enable_loop_closing=False,
                   max_keyframes=16, max_points=4096, device="cpu")
    for i in range(N_FRAMES):
        gray, depth, _ = world.render(Twc[i])
        assert s.track_rgbd(ts[i], gray, depth) is not None
    print(f"RGB-D system: {s.map.n_keyframes()} keyframes, "
          f"{s.map.n_points()} points")
    assert s.map.n_keyframes() >= 2 and s.map.n_points() > 0
    with pytest.raises(ValueError, match="RGBD"):
        s.track_stereo(ts[0], gray, gray)
    s.reset()
    assert s.tracking_state.name == "NO_IMAGES_YET"
    assert s.map.n_keyframes() == 0 and s.map.n_points() == 0
