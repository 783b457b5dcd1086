"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises, so the
script exits non-zero without the final line:

1. device: card name, power limit, torch / CUDA / nvcc versions;
2. build: compiles orb_slam2_map_tpu_torch/csrc/gated_nn.cu with nvcc;
3. kernel: the gated-NN kernel against its plain PyTorch version on the
   card, at the tracking path's shapes, exact equality required, with
   CUDA-event timings of both;
4. slice: the port's Tracker over a 120-frame 640x480 sweep with sensor
   noise (TUM1 ORB settings), 0 lost frames and raw ATE <= 2 cm
   required, and the kernel's launch count on that run;
5. fused: `fused_frame_step` over the next 10 frames of the (periodic)
   sweep from the tracker's last state;
6. the kernels' JSON line, then the result line.

It needs CUDA and the checkout it sits in; it imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_FRAMES = 120          # 4 s of 30 fps sensor data
N_FUSED = 10
ATE_GATE_M = 0.02       # the project's ATE gate (BASELINE.md)
FUSED_GATE_M = 0.02
KERNEL_SHAPES = [(1032, 1032), (4096, 1032)]   # motion-model / local-map


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA card", file=sys.stderr)
        sys.exit(2)
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

    card = _card_line()
    nvcc = subprocess.run([gated_nn_cuda._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return torch.device("cuda", 0), card


def phase_build():
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

    t0 = time.perf_counter()
    gated_nn_cuda._load()
    dt = time.perf_counter() - t0
    ptxas = [ln for ln in gated_nn_cuda.BUILD_LOG.splitlines()
             if "registers" in ln or "smem" in ln]
    print(f"[build] {gated_nn_cuda.library_path().name} in {dt:.2f} s "
          f"(nvcc {gated_nn_cuda.BUILD_SECONDS:.2f} s) "
          f"{' | '.join(s.strip() for s in ptxas)}")


def _kernel_inputs(n, m, seed, device):
    """Descriptors with top-bit words, duplicated keys and exact-copy
    queries (ties), and four gate styles stacked by rows: a search
    window, a random 30 % gate, rows with every pair gated, and all-open
    rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    a[::7, 0] = 0xFFFFFFFF
    b[5::11] = b[3:3 + len(b[5::11])]            # duplicated key rows
    a[::5] = b[rng.integers(0, m, len(a[::5]))]  # queries equal to keys
    q = rng.uniform(0, 640, (n, 2))
    k = rng.uniform(0, 640, (m, 2))
    window = (np.abs(q[:, None] - k[None]) <= 60.0).all(-1)
    gate = rng.uniform(size=(n, m)) < 0.3
    quarter = n // 4
    gate[:quarter] = window[:quarter]
    gate[quarter:quarter + 17] = False
    gate[quarter + 17:quarter + 40] = True
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return t(a.view(np.int32)), t(b.view(np.int32)), t(gate)


def _time_ms(fn, reps=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def phase_kernel(device, card):
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, matching

    rows = []
    for i, (n, m) in enumerate(KERNEL_SHAPES):
        a, b, gate = _kernel_inputs(n, m, seed=100 + i, device=device)
        idx, best, second = gated_nn_cuda.gated_nn(a, b, gate)
        torch.cuda.synchronize()
        ridx, rbest, rsecond = matching.gated_nn_plain(a, b, gate)
        err = max(float((idx.long() - ridx.long()).abs().max()),
                  float((best - rbest).abs().max()),
                  float((second - rsecond).abs().max()))
        if not (torch.equal(idx, ridx) and torch.equal(best, rbest)
                and torch.equal(second, rsecond)):
            bad = int(((idx != ridx) | (best != rbest)
                       | (second != rsecond)).sum())
            raise AssertionError(f"gated_nn kernel != plain at [{n}x{m}]: "
                                 f"{bad} rows differ, max abs err {err}")
        # parent/change/change/parent order: plain, kernel, kernel, plain
        p1 = _time_ms(lambda: matching.gated_nn_plain(a, b, gate))
        k1 = _time_ms(lambda: gated_nn_cuda.gated_nn(a, b, gate))
        k2 = _time_ms(lambda: gated_nn_cuda.gated_nn(a, b, gate))
        p2 = _time_ms(lambda: matching.gated_nn_plain(a, b, gate))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        print(f"[kernel] gated_nn [{n}x{m}] exact (max abs err {err}); "
              f"kernel {ms:.4f} ms ({k1:.4f}/{k2:.4f}), plain {plain_ms:.4f} ms "
              f"({p1:.4f}/{p2:.4f}) | {card}")
        rows.append(dict(shape=(n, m), err=err, ms=ms, plain_ms=plain_ms))
    return rows


def _sequence(device, n_frames):
    from orb_slam2_map_tpu_torch.io.synthetic import (
        SyntheticRGBDSequence, SyntheticWorld, synthetic_camera,
        sweep_trajectory)

    cam = synthetic_camera()
    world = SyntheticWorld(cam=cam, seed=0, device=device)
    Twc, ts = sweep_trajectory(n_frames)
    return cam, SyntheticRGBDSequence(world, Twc, ts, noise=True)


def phase_slice(device, card, n_frames=N_FRAMES):
    from orb_slam2_map_tpu_torch.config import SystemConfig
    from orb_slam2_map_tpu_torch.io.evaluate import ate_rmse
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, orb
    from orb_slam2_map_tpu_torch.slam.mapstore import MapStore
    from orb_slam2_map_tpu_torch.slam.tracking import Tracker

    cam, seq = _sequence(device, n_frames)
    cfg = SystemConfig(camera=cam)
    assert orb.total_capacity(cfg.orb) == 1032, orb.total_capacity(cfg.orb)
    tracker = Tracker(cfg, MapStore(max_keyframes=512, max_points=1 << 16,
                                    kp_capacity=1032),
                      local_mapper=None, device=device)
    frames = [seq[i] for i in range(n_frames)]
    torch.cuda.synchronize()

    gated_nn_cuda.LAUNCHES = 0
    per_frame, wall, lost = [], [], 0
    for ts, gray, depth, _ in frames:
        before = gated_nn_cuda.LAUNCHES
        t0 = time.perf_counter()
        pose = tracker.track_rgbd(ts, gray, depth)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        per_frame.append(gated_nn_cuda.LAUNCHES - before)
        lost += pose is None
    launches = gated_nn_cuda.LAUNCHES

    ts_raw, T_raw = tracker.trajectory(refine=False)
    ts_ref, T_ref = tracker.trajectory(refine=True)
    gt = seq.gt_Twc
    ate_raw = ate_rmse(ts_raw, T_raw[:, :3, 3], seq.timestamps, gt[:, :3, 3])
    ate_ref = ate_rmse(ts_ref, T_ref[:, :3, 3], seq.timestamps, gt[:, :3, 3])
    med_ms = float(np.median(wall[1:])) * 1e3
    print(f"[slice] {n_frames} frames 640x480, lost {lost}, keyframes "
          f"{tracker.map.n_keyframes()}, points {tracker.map.n_points()}, "
          f"ATE raw {ate_raw * 100:.3f} cm, refined {ate_ref * 100:.3f} cm, "
          f"median frame {med_ms:.2f} ms (mean {np.mean(wall[1:]) * 1e3:.2f}, "
          f"first {wall[0] * 1e3:.1f}), gated_nn launches {launches} "
          f"(min per steady-state frame {min(per_frame[2:])}) | {card}")
    torch.cuda.synchronize()
    if lost:
        raise AssertionError(f"{lost} lost frames")
    if not ate_raw <= ATE_GATE_M:
        raise AssertionError(f"raw ATE {ate_raw} m above {ATE_GATE_M} m")
    # frame 0 initializes the map and frame 1 (no velocity yet) tracks
    # the reference keyframe; from frame 2 on every frame is the chain
    if min(per_frame[2:]) < 3:
        raise AssertionError(f"gated_nn ran fewer than 3 times on a "
                             f"steady-state frame: {per_frame}")
    return tracker, seq, launches, (ts_raw, T_raw)


def phase_fused(device, card, tracker, seq, raw_traj):
    from orb_slam2_map_tpu_torch.io.evaluate import umeyama_alignment
    from orb_slam2_map_tpu_torch.slam import pipeline_step
    from orb_slam2_map_tpu_torch.slam.tracking import LOCAL_POINT_CAP

    # world alignment estimated from the tracked trajectory
    ts_raw, T_raw = raw_traj
    gt_at = {float(t): g for t, g in zip(seq.timestamps, seq.gt_Twc)}
    gt_pos = np.stack([gt_at[float(t)][:3, 3] for t in ts_raw])
    _, A_R, A_t = umeyama_alignment(T_raw[:, :3, 3], gt_pos)

    lf = tracker.last_frame
    Rv, tv = tracker.velocity
    dt = lambda x, d=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(x), dtype=d, device=device)
    carry = pipeline_step.TrackCarry(
        R=dt(lf.R), t=dt(lf.t), Rv=dt(Rv), tv=dt(tv),
        cur_obs=dt(tracker.last_obs, torch.int32), last_xy=lf.xy,
        last_ur=lf.ur, last_depth=lf.depth, last_desc=lf.desc,
        last_level=lf.level, last_angle=lf.angle, last_valid=lf.valid,
        ok=torch.ones((), dtype=torch.bool, device=device))
    ms = tracker.map
    cols = ms.device_point_arrays(device)
    alive = dt(ms.mp_exists, torch.bool)
    ctrl = dt([3.0, tracker.cfg.tracking.local_map_min_inliers, 1.0, 1.0])
    cur_obs = tracker.last_obs
    N = lf.capacity
    errs = []
    # sweep_trajectory is periodic (frame n-1 == frame 0): the frames that
    # follow the last one are frames 1, 2, ... of the same sweep
    for k in range(N_FUSED):
        _, gray, depth, _ = seq[1 + k]
        mids, mids_p, mp_valid = tracker._local_candidates(cur_obs)
        carry, packed, _ = pipeline_step.fused_frame_step(
            tracker.cfg, carry, dt(gray), dt(depth), ctrl,
            cols["mp_pos"], cols["mp_desc"], cols["mp_normal"],
            cols["mp_min_dist"], cols["mp_max_dist"], alive,
            dt(mids_p, torch.int64), dt(mp_valid, torch.bool),
            cols["mp_redirect"])
        out = packed.cpu().numpy()
        if out[5] < 0.5:
            raise AssertionError(f"fused_frame_step not ok on frame {k}: "
                                 f"head {out[:8]}")
        cur_obs = out[pipeline_step.PACK_SCALARS + 12:
                      pipeline_step.PACK_SCALARS + 12 + N].astype(np.int64)
        R = carry.R.cpu().numpy()
        t = carry.t.cpu().numpy()
        c = A_R @ (-R.T @ t) + A_t
        errs.append(float(np.linalg.norm(c - seq.gt_Twc[1 + k][:3, 3])))
    torch.cuda.synchronize()
    print(f"[fused] {N_FUSED} fused_frame_step frames ok, camera-centre error "
          f"max {max(errs) * 100:.3f} cm, mean {np.mean(errs) * 100:.3f} cm, "
          f"per frame (cm) {np.round(np.asarray(errs) * 100, 3).tolist()} "
          f"(local points cap {LOCAL_POINT_CAP}) | {card}")
    if max(errs) > FUSED_GATE_M:
        raise AssertionError(f"fused_frame_step centre error {max(errs)} m")


def main():
    device, card = phase_device()
    phase_build()
    kernel_rows = phase_kernel(device, card)
    tracker, seq, launches, raw_traj = phase_slice(device, card)
    phase_fused(device, card, tracker, seq, raw_traj)
    big = kernel_rows[-1]
    print(json.dumps({"kernels": [{
        "name": "gated_nn", "route": "cuda",
        "source": "orb_slam2_map_tpu_torch/csrc/gated_nn.cu",
        "replaces": "orb_slam2_map_tpu/ops/pallas_kernels.py:125",
        "launches": launches, "max_abs_err": max(r["err"] for r in kernel_rows),
        "ms": big["ms"], "plain_ms": big["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
