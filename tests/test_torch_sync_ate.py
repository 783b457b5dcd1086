"""The synchronous RGB-D system of both packages on the same frames.

The test: the JAX package's `SLAMSystem(cfg, Sensor.RGBD,
enable_loop_closing=False).track_rgbd` and the port's (`device="cpu"`)
over the same 30 frames of the small test sweep (320x240, rendered by
the JAX world): neither loses a frame, both raw ATEs <= 2 cm, camera
centres within a median 2 mm of each other (the sync parity bound of
test_torch_system.py). Its 1 cm max does not hold here, and the test
pins down why: at every frame where the centres differ by more than
1 cm, the port is within 1 cm of the ground truth, and it is the JAX
package's trajectory that departs (local BA amplifies last-bit
differences; measured: 37.7 mm apart at the last frame, the JAX package
35.6 mm and the port 4.7 mm from the truth).

The same comparison at full width, as a script (CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_sync_ate.py [n_frames]
        [width] [jax|port]

renders the first `n_frames` (default 60) of bench.py's noisy sweep
(`sweep_trajectory(240)`, `SensorNoiseModel(seed=0)`, bench.py:116-161)
at `SystemConfig(camera=SyntheticWorld().cam)` (640x480 unless a width
is given) with the JAX package's world (default) or the port's (its
textures come from a torch.Generator, so its frames differ; the world of
chip_smoke.py and chip_profile.py), drives both sync systems over the
identical numpy frames, and prints both raw ATEs, the per-frame camera
centre gap, and each trajectory's error against the ground truth at the
frames where the two differ most.
"""

import os
import sys
import time

import numpy as np
import torch

# run as a script: the repository root and this directory on the path
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from orb_slam2_map_tpu.config import SystemConfig  # noqa: E402
from orb_slam2_map_tpu.io.evaluate import (ate_rmse,  # noqa: E402
                                           umeyama_alignment)
from orb_slam2_map_tpu.io.synthetic import (SensorNoiseModel,  # noqa: E402
                                            SyntheticRGBDSequence,
                                            SyntheticWorld,
                                            synthetic_camera,
                                            sweep_trajectory)
from orb_slam2_map_tpu.slam import SLAMSystem as JSLAMSystem  # noqa: E402
from orb_slam2_map_tpu.slam import Sensor as JSensor  # noqa: E402
from orb_slam2_map_tpu_torch.io import synthetic as tsynthetic  # noqa: E402
from orb_slam2_map_tpu_torch.slam.system import (SLAMSystem,  # noqa: E402
                                                 Sensor)

from test_torch_orb import port_config  # noqa: E402


def compare(cfg, frames, Twc, ts, label=""):
    """Both packages' sync RGB-D systems over `frames`; prints and returns
    (lost per package, raw ATE per package, per-frame centre gap)."""
    lost, ate, traj = {}, {}, {}
    n = len(frames)
    for name, make in (
            ("jax", lambda: JSLAMSystem(cfg, JSensor.RGBD,
                                        enable_loop_closing=False)),
            ("port", lambda: SLAMSystem(port_config(cfg), Sensor.RGBD,
                                        enable_loop_closing=False,
                                        device="cpu"))):
        s = make()
        t0 = time.perf_counter()
        lost[name] = sum(s.track_rgbd(t, g, d) is None
                         for t, g, d, _ in frames)
        wall = time.perf_counter() - t0
        t_raw, T_raw = s.tracker.trajectory(refine=False)
        ate[name] = ate_rmse(t_raw, T_raw[:, :3, 3], ts[:n], Twc[:n, :3, 3])
        traj[name] = (t_raw, T_raw)
        print(f"{label}{name}: {n} frames {cfg.camera.width}x"
              f"{cfg.camera.height}, lost {lost[name]}, keyframes "
              f"{s.map.n_keyframes()}, points {s.map.n_points()}, raw ATE "
              f"{ate[name] * 100:.3f} cm ({wall:.1f} s on the CPU)",
              flush=True)
    (tj, Tj), (tt, Tt) = traj["jax"], traj["port"]
    assert np.array_equal(tj, tt)
    gap = np.linalg.norm(Tj[:, :3, 3] - Tt[:, :3, 3], axis=1)
    print(f"{label}camera-centre gap port vs jax: median "
          f"{np.median(gap) * 1e3:.3f} mm, max {gap.max() * 1e3:.3f} mm "
          f"(frame {int(gap.argmax())})")
    # each trajectory's own error against the ground truth (rigidly
    # aligned), at the frames where the two differ most
    gt = Twc[:n, :3, 3]
    err = {}
    for name, (_, T) in traj.items():
        _, R, t = umeyama_alignment(T[:, :3, 3], gt)
        err[name] = np.linalg.norm(T[:, :3, 3] @ R.T + t - gt, axis=1)
    for i in np.argsort(-gap)[:5]:
        print(f"{label}frame {i}: gap {gap[i] * 1e3:.3f} mm, error against "
              f"the ground truth jax {err['jax'][i] * 1e3:.3f} mm, port "
              f"{err['port'][i] * 1e3:.3f} mm")
    return lost, ate, gap, err


def test_rgbd_sync_system_parity(small_world):
    world, cfg = small_world
    Twc, ts = sweep_trajectory(30)
    seq = SyntheticRGBDSequence(world, Twc, ts)
    frames = [seq[i] for i in range(len(seq))]
    lost, ate, gap, err = compare(cfg, frames, Twc, ts)
    assert lost == {"jax": 0, "port": 0}
    assert max(ate.values()) <= 0.02, ate
    assert np.median(gap) <= 0.002, gap
    apart = gap > 0.01
    assert (err["port"][apart] <= 0.01).all(), (gap, err)


def main(n_frames=60, width=640, world="jax"):
    torch.set_num_threads(4)
    cam = synthetic_camera(width, width * 3 // 4)
    cfg = SystemConfig(camera=cam)
    Twc, ts = sweep_trajectory(240)
    if world == "port":
        seq = tsynthetic.SyntheticRGBDSequence(
            tsynthetic.SyntheticWorld(cam=port_config(cfg).camera, seed=0,
                                      device="cpu"),
            Twc, ts, noise=tsynthetic.SensorNoiseModel(seed=0))
    else:
        seq = SyntheticRGBDSequence(SyntheticWorld(cam=cam), Twc, ts,
                                    noise=SensorNoiseModel(seed=0))
    compare(cfg, [seq[i] for i in range(n_frames)], Twc, ts,
            label=f"[{world} world] ")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main(*(int(a) for a in sys.argv[1:3]), *sys.argv[3:4])
