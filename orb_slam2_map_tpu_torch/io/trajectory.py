"""Trajectory writers/readers in TUM and KITTI formats.

A numpy copy of orb_slam2_map_tpu/io/trajectory.py. Replaces System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM /
SaveTrajectoryKITTI (reference: src/System.cc:349-489), including the
relative-pose recovery through the keyframe spanning tree for frames whose
reference keyframe was culled (reference: src/System.cc:384-390).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), numerically robust."""
    q = np.empty(4)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q[:] = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    if q[3] < 0:
        q = -q
    return q


def write_tum(path: str, timestamps: Sequence[float],
              Twc_list: Sequence[np.ndarray]) -> None:
    """Write camera-to-world poses as TUM lines 't tx ty tz qx qy qz qw'
    (reference: src/System.cc:391-398)."""
    with open(path, "w") as f:
        for t, Twc in zip(timestamps, Twc_list):
            R, tw = Twc[:3, :3], Twc[:3, 3]
            q = _rot_to_quat(R)
            f.write(f"{t:.6f} {tw[0]:.7f} {tw[1]:.7f} {tw[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def write_kitti(path: str, Twc_list: Sequence[np.ndarray]) -> None:
    """Write 3x4 row-major camera-to-world matrices
    (reference: src/System.cc:441-489)."""
    with open(path, "w") as f:
        for Twc in Twc_list:
            vals = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read TUM trajectory -> (timestamps [N], Twc [N, 4, 4])."""
    ts, mats = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = [float(x) for x in line.split()]
            if len(p) < 8:
                continue
            ts.append(p[0])
            x, y, z, qx, qy, qz, qw = p[1:8]
            n = qx * qx + qy * qy + qz * qz + qw * qw
            s = 0.0 if n == 0 else 2.0 / n
            R = np.array([
                [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw), s * (qx * qz + qy * qw)],
                [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz), s * (qy * qz - qx * qw)],
                [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw), 1 - s * (qx * qx + qy * qy)],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [x, y, z]
            mats.append(T)
    return np.asarray(ts), np.asarray(mats)
