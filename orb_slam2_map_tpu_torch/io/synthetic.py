"""Synthetic RGB-D world: a ray-cast textured box room with ground truth.

Port of orb_slam2_map_tpu/io/synthetic.py. A camera moves inside a
textured box, rendered analytically (plane intersection per pixel),
which yields geometrically exact RGB + depth + ground-truth
trajectories. Rendering runs as tensor code on the world's device; the
trajectories, the sensor noise model and the sequence wrapper are numpy
and copied verbatim.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..geom.camera import PinholeCamera
from ..utils.device import default_device


def synthetic_camera(width: int = 640, height: int = 480) -> PinholeCamera:
    """Distortion-free TUM-like intrinsics for synthetic sequences."""
    return PinholeCamera(
        fx=517.3, fy=516.5, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0,
        width=width, height=height, bf=40.0, fps=30.0, th_depth=50.0,
    )


def make_textures(seed: int, n_faces: int = 6, coarse: int = 256,
                  fine: int = 512):
    """(coarse [F,c,c,3], fine [F,f,f,3], blob [F,f,f,1]) float32 textures
    drawn from a torch.Generator with the JAX package's distributions:
    uniform [0, 1) texels, and bright blobs where uniform > 0.985 (the
    bits differ from jax.random's)."""
    g = torch.Generator().manual_seed(seed)
    coarse_tex = torch.rand((n_faces, coarse, coarse, 3), generator=g)
    fine_tex = torch.rand((n_faces, fine, fine, 3), generator=g)
    blob_tex = (torch.rand((n_faces, fine, fine, 1), generator=g)
                > 0.985).to(torch.float32)
    return coarse_tex, fine_tex, blob_tex


class SyntheticWorld:
    """Textured axis-aligned box room [0,Lx]x[0,Ly]x[0,Lz], y-up.

    render(Twc) -> (gray f32 [H,W] in [0,255], depth f32 [H,W] meters,
    rgb u8 [H,W,3]) as numpy arrays; render_tensors keeps them on the
    device. `textures` = (coarse, fine, blob) arrays replaces the seeded
    draw (e.g. to render with another world's textures). The world lives
    on `device`, by default the card."""

    def __init__(self, cam: Optional[PinholeCamera] = None,
                 size=(6.0, 3.0, 6.0), seed: int = 0,
                 coarse_texels_per_m: float = 8.0,
                 fine_texels_per_m: float = 40.0,
                 textures=None, device=None):
        self.cam = cam or synthetic_camera()
        self.size = np.asarray(size, dtype=np.float32)
        self.device = default_device(device)
        if textures is None:
            textures = make_textures(seed)
        self.coarse_tex, self.fine_tex, self.blob_tex = (
            torch.as_tensor(np.asarray(t), dtype=torch.float32,
                            device=self.device) for t in textures)
        self.coarse_scale = coarse_texels_per_m
        self.fine_scale = fine_texels_per_m

    def render_tensors(self, Twc):
        Twc = torch.as_tensor(np.asarray(Twc), dtype=torch.float32,
                              device=self.device)
        return _render_box(Twc, self.coarse_tex, self.fine_tex,
                           self.blob_tex, self.coarse_scale,
                           self.fine_scale, cam=self.cam,
                           size=tuple(float(s) for s in self.size))

    def render(self, Twc: np.ndarray):
        gray, depth, rgb = self.render_tensors(Twc)
        return gray.cpu().numpy(), depth.cpu().numpy(), rgb.cpu().numpy()


def _render_box(Twc, coarse_tex, fine_tex, blob_tex, coarse_scale, fine_scale,
                *, cam: PinholeCamera, size):
    H, W = cam.height, cam.width
    dev = Twc.device
    R = Twc[:3, :3]
    o = Twc[:3, 3]

    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    dx = ((u - cam.cx) / cam.fx).expand(H, W)
    dy = ((v - cam.cy) / cam.fy).expand(H, W)
    d_cam = torch.stack([dx, dy, torch.ones((H, W), device=dev)], dim=-1)
    d_world = torch.einsum("ij,hwj->hwi", R, d_cam)       # [H,W,3]

    L = tuple(float(s) for s in size)
    eps = 1e-6
    best_t = torch.full((H, W), 1e9, dtype=torch.float32, device=dev)
    best_face = torch.zeros((H, W), dtype=torch.int64, device=dev)

    for axis in range(3):
        d_a = d_world[..., axis]
        safe_d = torch.where(torch.abs(d_a) < eps, eps, d_a)
        for side, plane in ((0, 0.0), (1, L[axis])):
            t = (plane - o[axis]) / safe_d
            hit = o[None, None, :] + t[..., None] * d_world
            oth = [a for a in range(3) if a != axis]
            inside = (
                (t > 1e-3)
                & (hit[..., oth[0]] >= -1e-3) & (hit[..., oth[0]] <= L[oth[0]] + 1e-3)
                & (hit[..., oth[1]] >= -1e-3) & (hit[..., oth[1]] <= L[oth[1]] + 1e-3)
            )
            t_valid = torch.where(inside, t, 1e9)
            update = t_valid < best_t
            best_t = torch.where(update, t_valid, best_t)
            best_face = torch.where(update, axis * 2 + side, best_face)

    # depth along the optical axis = t (ray z-component in camera frame is 1)
    depth = torch.where(best_t < 1e8, best_t, 0.0)
    hit = o[None, None, :] + best_t[..., None] * d_world

    # face-local 2D coords: the two non-normal axes
    axis_of_face = best_face // 2
    coords = []
    for a in range(3):
        oth = [b for b in range(3) if b != a]
        coords.append(torch.stack([hit[..., oth[0]], hit[..., oth[1]]], dim=-1))
    uv_face = torch.where(
        (axis_of_face == 0)[..., None], coords[0],
        torch.where((axis_of_face == 1)[..., None], coords[1], coords[2]))

    def sample(tex, scale, rot_per_face):
        """Bilinear texture sample with a per-face lattice rotation
        (sub-pixel smooth corners; de-correlated lattices across faces)."""
        n = tex.shape[1]
        ca = torch.cos(rot_per_face)[best_face]
        sa = torch.sin(rot_per_face)[best_face]
        u0 = uv_face[..., 0] * scale
        v0 = uv_face[..., 1] * scale
        ur_ = ca * u0 - sa * v0
        vr_ = sa * u0 + ca * v0
        u_f = torch.floor(ur_)
        v_f = torch.floor(vr_)
        wu = (ur_ - u_f)[..., None]
        wv = (vr_ - v_f)[..., None]
        iu0 = torch.remainder(u_f.to(torch.int64), n)
        iv0 = torch.remainder(v_f.to(torch.int64), n)
        iu1 = torch.remainder(iu0 + 1, n)
        iv1 = torch.remainder(iv0 + 1, n)
        t00 = tex[best_face, iu0, iv0]
        t01 = tex[best_face, iu0, iv1]
        t10 = tex[best_face, iu1, iv0]
        t11 = tex[best_face, iu1, iv1]
        return ((1 - wu) * (1 - wv) * t00 + (1 - wu) * wv * t01
                + wu * (1 - wv) * t10 + wu * wv * t11)     # [H,W,C]

    rot_c = torch.tensor([0.17, 0.43, 0.71, 0.93, 1.19, 1.41], device=dev)
    rot_f = torch.tensor([0.29, 0.61, 0.87, 1.07, 1.33, 1.57], device=dev)
    col = (0.45 * sample(coarse_tex, coarse_scale, rot_c)
           + 0.35 * sample(fine_tex, fine_scale, rot_f)
           + 0.5 * sample(blob_tex, fine_scale, rot_f))
    col = torch.clamp(col, 0.0, 1.0)
    # mild distance shading for realism (keeps texture contrast dominant)
    shade = 1.0 / (1.0 + 0.02 * best_t * best_t)
    col = col * (0.25 + 0.75 * torch.clamp(shade, 0.0, 1.0)[..., None])
    rgb = (col * 255.0).to(torch.uint8)
    gray = (0.299 * col[..., 0] + 0.587 * col[..., 1] + 0.114 * col[..., 2]) * 255.0
    return gray, depth, rgb


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world pose with +z toward target (OpenCV convention:
    x right, y down, z forward) — hence default up = -Y for a y-up world."""
    eye = np.asarray(eye, dtype=np.float64)
    z = np.asarray(target, dtype=np.float64) - eye
    z = z / (np.linalg.norm(z) + 1e-12)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(up, z)
    # guard: if view direction ~ parallel to up, pick another up
    if np.linalg.norm(x) < 1e-6:
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    Twc = np.eye(4)
    Twc[:3, 0], Twc[:3, 1], Twc[:3, 2], Twc[:3, 3] = x, y, z, eye
    return Twc


def orbit_trajectory(n_frames: int, size=(6.0, 3.0, 6.0),
                     radius_frac: float = 0.25, height_frac: float = 0.5,
                     angle_range: float = 2.0 * np.pi,
                     wobble: float = 0.05, fps: float = 30.0):
    """Smooth orbit inside the room looking outward past the center.
    angle_range=2*pi revisits the start (loop-closure sequences);
    small angle_range gives a gentle fr1/xyz-style sweep.
    Returns (Twc [N,4,4], timestamps [N])."""
    Lx, Ly, Lz = size
    c = np.array([Lx / 2, Ly * height_frac, Lz / 2])
    r = radius_frac * min(Lx, Lz)
    Twc = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        a = angle_range * i / max(n_frames - 1, 1)
        eye = c + np.array([
            r * np.sin(a),
            wobble * Ly * np.sin(3.1 * a),
            r * np.cos(a),
        ])
        # look outward: target on the far wall beyond the orbit
        tgt = c + np.array([2.5 * r * np.sin(a + 0.35), 0.0, 2.5 * r * np.cos(a + 0.35)])
        Twc[i] = look_at(eye, tgt)
    ts = np.arange(n_frames, dtype=np.float64) / fps
    return Twc, ts


def sweep_trajectory(n_frames: int, size=(6.0, 3.0, 6.0),
                     amplitude: float = 0.4, fps: float = 30.0):
    """fr1/xyz-style translation-dominant sweep facing one wall."""
    Lx, Ly, Lz = size
    base = np.array([Lx / 2, Ly / 2, Lz * 0.35])
    Twc = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        ph = 2 * np.pi * i / max(n_frames - 1, 1)
        eye = base + amplitude * np.array(
            [np.sin(ph), 0.35 * np.sin(2 * ph), 0.25 * np.cos(ph)]
        )
        tgt = np.array([Lx / 2 + 0.6 * amplitude * np.sin(0.5 * ph), Ly / 2, Lz])
        Twc[i] = look_at(eye, tgt)
    ts = np.arange(n_frames, dtype=np.float64) / fps
    return Twc, ts


class SensorNoiseModel:
    """Realistic RGB-D sensor degradation for accuracy evaluation.

    The clean synthetic world is geometrically exact; real TUM-class
    sensors are not. This model layers the dominant effects of a
    structured-light RGB-D camera (Kinect-class, the reference's TUM
    data, reference: Examples/RGB-D/TUM1.yaml DepthMapFactor=5000):

      * depth: zero-mean Gaussian with the Khoshelham-Elberink
        quadratic law sigma(z) = a + b*z^2, random dropout (invalid
        pixels), and u16 quantization at 1/factor metres;
      * intensity: Gaussian read noise, slow sinusoidal exposure drift
        (auto-exposure hunting), and directional motion blur whose
        length follows the inter-frame pixel motion.
    """

    def __init__(self, depth_sigma_base: float = 0.0012,
                 depth_sigma_quad: float = 0.0019,
                 depth_dropout: float = 0.02,
                 depth_factor: float = 5000.0,
                 read_noise: float = 2.0,
                 exposure_drift: float = 0.15,
                 exposure_period_s: float = 4.0,
                 shutter_fraction: float = 0.35,
                 motion_blur_px: float = 5.0,
                 seed: int = 1):
        self.depth_sigma_base = depth_sigma_base
        self.depth_sigma_quad = depth_sigma_quad
        self.depth_dropout = depth_dropout
        self.depth_factor = depth_factor
        self.read_noise = read_noise
        self.exposure_drift = exposure_drift
        self.exposure_period_s = exposure_period_s
        self.shutter_fraction = shutter_fraction   # shutter-open fraction
        self.motion_blur_px = motion_blur_px       # cap on blur length
        self.rng = np.random.default_rng(seed)

    def apply(self, t: float, gray: np.ndarray, depth: np.ndarray,
              flow_px: Tuple[float, float] = (0.0, 0.0)):
        rng = self.rng
        # --- depth ---
        valid = depth > 0
        sigma = self.depth_sigma_base + self.depth_sigma_quad * depth ** 2
        depth = depth + sigma * rng.standard_normal(depth.shape).astype(
            np.float32)
        if self.depth_dropout > 0:
            drop = rng.random(depth.shape) < self.depth_dropout
            valid = valid & ~drop
        if self.depth_factor > 0:   # u16 quantization like the datasets
            q = np.round(depth * self.depth_factor)
            depth = (np.clip(q, 0, 65535) / self.depth_factor).astype(
                np.float32)
        depth = np.where(valid, depth, 0.0).astype(np.float32)

        # --- intensity ---
        if self.motion_blur_px > 0:
            # blur streak length = image motion during the open shutter
            # (flow px/frame * shutter fraction), capped; odd tap count
            # keeps the kernel symmetric so corners aren't biased
            length = min(float(np.hypot(*flow_px)) * self.shutter_fraction,
                         self.motion_blur_px)
            n = max(1, int(round(length)) | 1)
            if n > 1:
                du, dv = flow_px
                norm = max(float(np.hypot(du, dv)), 1e-6)
                du, dv = du / norm, dv / norm
                acc = np.zeros_like(gray)
                for k in range(n):   # odd tap count along the motion
                    s = (k - (n - 1) / 2.0)
                    acc += np.roll(np.roll(gray, int(round(s * dv)), 0),
                                   int(round(s * du)), 1)
                gray = acc / n
        gain = 1.0 + self.exposure_drift * np.sin(
            2.0 * np.pi * t / self.exposure_period_s)
        gray = gray * gain
        if self.read_noise > 0:
            gray = gray + self.read_noise * rng.standard_normal(
                gray.shape)
        gray = np.clip(gray, 0, 255).astype(np.float32)
        return gray, depth


class SyntheticRGBDSequence:
    """Dataset-like wrapper: iterates (timestamp, gray, depth, rgb) and keeps
    ground-truth camera-to-world poses in `.gt_Twc`. Pass `noise=` a
    SensorNoiseModel (or noise=True for TUM-like defaults) to evaluate
    under realistic sensor degradation instead of exact renders."""

    def __init__(self, world: SyntheticWorld, Twc: np.ndarray,
                 timestamps: np.ndarray,
                 depth_noise: float = 0.0, intensity_noise: float = 0.0,
                 noise=None, seed: int = 1):
        self.world = world
        self.gt_Twc = Twc
        self.timestamps = timestamps
        self.depth_noise = depth_noise
        self.intensity_noise = intensity_noise
        if noise is True:
            noise = SensorNoiseModel(seed=seed)
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.timestamps)

    def _flow_px(self, i: int) -> Tuple[float, float]:
        """Mean image-plane motion (px) between frame i-1 and i: drives
        the directional motion-blur length."""
        if i == 0:
            return (0.0, 0.0)
        cam = self.world.cam
        # translation of the view center projected with mean depth ~2 m
        d = self.gt_Twc[i, :3, 3] - self.gt_Twc[i - 1, :3, 3]
        dc = self.gt_Twc[i, :3, :3].T @ d
        z = 2.0
        return (float(cam.fx * dc[0] / z), float(cam.fy * dc[1] / z))

    def __getitem__(self, i: int):
        gray, depth, rgb = self.world.render(self.gt_Twc[i])
        if self.noise is not None:
            gray, depth = self.noise.apply(float(self.timestamps[i]),
                                           gray, depth, self._flow_px(i))
        if self.depth_noise > 0:
            depth = depth * (
                1.0 + self.depth_noise * self.rng.standard_normal(depth.shape)
            ).astype(np.float32)
        if self.intensity_noise > 0:
            gray = np.clip(
                gray + self.intensity_noise * self.rng.standard_normal(gray.shape),
                0, 255,
            ).astype(np.float32)
        return self.timestamps[i], gray, depth, rgb
