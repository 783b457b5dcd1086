"""KITTI odometry dataset loading.

A numpy copy of orb_slam2_map_tpu/io/kitti.py (with the image reader of
its io/tum.py). Replaces the reference's KITTI drivers' image/timestamp loaders
(reference: Examples/Stereo/stereo_kitti.cc LoadImages,
Examples/Monocular/mono_kitti.cc LoadImages) plus the per-sequence
camera settings shipped as KITTI00-02.yaml / KITTI03.yaml /
KITTI04-12.yaml. Calibration is read directly from the dataset's
calib.txt instead of hand-copied YAMLs when available.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..geom.camera import PinholeCamera


def _read_image(path: str) -> np.ndarray:
    """Read a PNG/PGM image to a numpy array without OpenCV."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path))
    except ImportError:  # pragma: no cover - fallback
        import imageio.v2 as imageio

        return imageio.imread(path)


def kitti_camera(sequence: int) -> PinholeCamera:
    """Per-sequence intrinsics matching the reference's settings files
    (Examples/Stereo/KITTI00-02.yaml, KITTI03.yaml, KITTI04-12.yaml).
    KITTI images are pre-rectified: zero distortion."""
    if 0 <= sequence <= 2:
        fx, fy, cx, cy = 718.856, 718.856, 607.1928, 185.2157
        bf, w, h = 386.1448, 1241, 376
    elif sequence == 3:
        fx, fy, cx, cy = 721.5377, 721.5377, 609.5593, 172.854
        bf, w, h = 387.5744, 1242, 375
    else:  # 04-12
        fx, fy, cx, cy = 707.0912, 707.0912, 601.8873, 183.1104
        bf, w, h = 379.8145, 1226, 370
    return PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
                         bf=bf, fps=10.0, th_depth=35.0)


def load_calib(path: str) -> Tuple[PinholeCamera, np.ndarray]:
    """Parse calib.txt (P0..P3 3x4 projection rows). Returns the left-gray
    camera with bf from the P1 baseline, plus the raw P matrices."""
    Ps = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.fromstring(vals, sep=" ")
            if arr.size == 12:
                Ps[key.strip()] = arr.reshape(3, 4)
    P0, P1 = Ps["P0"], Ps["P1"]
    fx, fy = P0[0, 0], P0[1, 1]
    cx, cy = P0[0, 2], P0[1, 2]
    bf = -P1[0, 3]  # P1[0,3] = -fx * baseline
    cam = PinholeCamera(fx=float(fx), fy=float(fy), cx=float(cx),
                        cy=float(cy), width=1241, height=376,
                        bf=float(bf), fps=10.0, th_depth=35.0)
    return cam, np.stack([Ps[k] for k in sorted(Ps)])


def load_times(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def load_poses(path: str) -> np.ndarray:
    """Ground-truth poses file (poses/NN.txt): N rows of flattened 3x4
    Twc in KITTI convention. Returns [N, 4, 4]."""
    flat = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(flat), 1, 1))
    out[:, :3, :] = flat
    return out


class KittiSequence:
    """Folder-of-images sequence (sequences/NN/): image_0 left gray,
    image_1 right gray, times.txt, calib.txt."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        self.stereo = stereo
        self.timestamps = load_times(os.path.join(root, "times.txt"))
        left_dir = os.path.join(root, "image_0")
        self.left = [os.path.join(left_dir, f)
                     for f in sorted(os.listdir(left_dir))
                     if f.endswith(".png")]
        self.right: List[str] = []
        if stereo:
            right_dir = os.path.join(root, "image_1")
            self.right = [os.path.join(right_dir, f)
                          for f in sorted(os.listdir(right_dir))
                          if f.endswith(".png")]
        calib = os.path.join(root, "calib.txt")
        if os.path.exists(calib):
            self.camera, _ = load_calib(calib)
        else:
            self.camera = kitti_camera(self._guess_sequence())
        self.camera_config = self.camera

    def _guess_sequence(self) -> int:
        base = os.path.basename(os.path.normpath(self.root))
        try:
            return int(base)
        except ValueError:
            return 0

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i: int):
        """-> (timestamp, gray_left [, gray_right])."""
        gl = np.asarray(_read_image(self.left[i]), dtype=np.float32)
        if gl.ndim == 3:
            gl = gl.mean(-1)
        if not self.stereo:
            return self.timestamps[i], gl
        gr = np.asarray(_read_image(self.right[i]), dtype=np.float32)
        if gr.ndim == 3:
            gr = gr.mean(-1)
        return self.timestamps[i], gl, gr


def translational_drift(Twc_est: np.ndarray, Twc_gt: np.ndarray,
                        lengths=(100, 200, 300, 400, 500, 600, 700, 800)
                        ) -> float:
    """KITTI-style average translational drift (%): for every start frame
    and segment length, compare relative motion est vs gt."""
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(Twc_gt[:, :3, 3], axis=0), axis=1))])
    errs = []
    for L in lengths:
        for i in range(0, len(Twc_gt) - 1, 10):
            j = np.searchsorted(dist, dist[i] + L)
            if j >= len(Twc_gt):
                break
            d_gt = np.linalg.inv(Twc_gt[i]) @ Twc_gt[j]
            d_est = np.linalg.inv(Twc_est[i]) @ Twc_est[j]
            e = np.linalg.inv(d_est) @ d_gt
            errs.append(np.linalg.norm(e[:3, 3]) / L)
    return float(np.mean(errs) * 100.0) if errs else float("nan")
