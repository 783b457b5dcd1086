"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises, so the
script exits non-zero without the final line:

1. device: card name, power limit, torch / CUDA / nvcc versions;
2. build: compiles every kernel under orb_slam2_map_tpu_torch/csrc/ with
   nvcc, one process per source, all started together (ptxas -v lines),
   and requires tensor-core instructions (IMMA) in each library's SASS;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its paths give it and at ragged shapes, exact equality
   required; CUDA-event timings of the kernel, the plain version and
   (where one exists) the single PyTorch call computing the same
   function (and, for the Hamming matrix, torch._int_mm on +-1 int8
   operands as a second yardstick), beside the bound;
4. slice: the port's Tracker over a 120-frame 640x480 RGB-D sweep with
   sensor noise (TUM1 ORB settings), 0 lost frames and raw ATE <= 2 cm,
   and the share of open gate pairs over its gated_nn launches;
5. fused: `fused_frame_step` over the next 10 frames of the sweep, then
   one more under torch.profiler (its kernel launches) and one with
   torch.cuda.set_sync_debug_mode("error") (the dispatch never waits for
   the device);
6. reloc: the slice's tracker kidnapped at three frames of its sweep
   (LOST, no velocity): each must relocalize (EPnP-RANSAC) within 2 cm
   of the aligned ground truth; ms per relocalization, candidates tried,
   gated_nn launches per relocalization;
7. stereo: SLAMSystem(Sensor.STEREO, local mapping, no loop closing) at
   KITTI 00-02 width (1241x376, 2000 features, 2040 keypoint slots) over
   a 60-frame stereo sweep, 0 lost frames and raw ATE <= 2 cm, with the
   per-stage times of its profile and the open-gate share in tracking
   and in local mapping;
8. async: bench.py's pass 1 at full width, SLAMSystem(Sensor.RGBD, local
   mapping, no loop closing) over the 240-frame noisy 640x480 sweep
   through track_rgbd_async + flush: fps, 0 lost frames, raw ATE <= 2 cm,
   >= 3 gated_nn launches on the dispatch thread per async frame, the
   pipeline's stage means, no worker error;
9. recovery: an async run with a 4-frame blackout must end OK (which
   branch ran, relocalization or reset, is printed);
10. the kernels' JSON line, the card line, then the result line.

Each kernel counts its launches; the counts are set to 0 right before a
path runs and read right after, and every kernel of a path must have
run in it. It needs CUDA and the checkout it sits in; it imports no JAX.
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

N_FRAMES = 120          # RGB-D: 4 s of 30 fps sensor data
N_FUSED = 10
N_STEREO = 60           # stereo: 6 s of 10 fps KITTI-rate data
# the sweep's default 0.4 m amplitude is too little motion for the
# KITTI camera's 81-degree field of view: no keyframe after the first in
# 40 frames; at 1 m the keyframe policy inserts keyframes and local
# mapping runs
STEREO_SWEEP_AMPLITUDE = 1.0
N_ASYNC = 240           # bench.py pass 1: the 240-frame noisy sweep
# recovery run: the first 70 frames of a 90-frame sweep (the sweep's
# speed is set by its length), frames 50-53 replaced by featureless noise
N_RECOVERY = (70, 90)
BLACKOUT = (50, 54)
RELOC_FRAMES = (30, 60, 90)   # kidnap points of the [slice] sweep
ASYNC_TIMEOUT_S = 300.0
ATE_GATE_M = 0.02       # the project's ATE gate (BASELINE.md)
FUSED_GATE_M = 0.02
# gated-NN shapes: RGB-D motion-model / local-map search (1032 slots),
# stereo tracking searches and local mapping (2040 slots)
GATED_SHAPES = [(1032, 1032), (4096, 1032), (2040, 2040), (4096, 2040)]
HAMMING_SHAPES = [(2040, 2040), (1032, 1032), (37, 1500)]
# exactness only: shapes off every tile multiple (16, 8, 32, 64), key
# ranges split across the blocks of a cluster ([17 x 2041], [33 x 2041]),
# no keys at all
RAGGED_GATED_SHAPES = [(1, 1), (15, 7), (17, 9), (1031, 1033), (17, 2041),
                       (33, 2041), (5, 0)]
RAGGED_HAMMING_SHAPES = [(1, 1), (15, 7), (17, 9), (1031, 1033), (17, 2041)]
# the card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s and
# dense int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _bound(n_bytes: float, n_ops: float):
    """(least time in ms, what sets it) for moving n_bytes through HBM and
    doing n_ops int8 tensor-core operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_libs():
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, hamming_cuda

    return {"gated_nn": gated_nn_cuda, "hamming": hamming_cuda}


def _reset_launches():
    for mod in _kernel_libs().values():
        mod.LAUNCHES = 0


def _read_launches():
    return {name: mod.LAUNCHES for name, mod in _kernel_libs().items()}


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA card", file=sys.stderr)
        sys.exit(2)
    from orb_slam2_map_tpu_torch.ops import cuda_build

    card = _card_line()
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return torch.device("cuda", 0), card


def _sass_count(path, opcode: str) -> int:
    """Instructions of `opcode` in the SASS of a built library
    (cuobjdump -sass)."""
    from orb_slam2_map_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path}: {out.stderr.strip()}")
    return sum(1 for ln in out.stdout.splitlines()
               if f" {opcode}" in ln or f"{{{opcode}" in ln)


def phase_build():
    from orb_slam2_map_tpu_torch.ops import cuda_build

    libs = [mod.LIB for mod in _kernel_libs().values()]
    t0 = time.perf_counter()
    cuda_build.build_all(libs)
    dt = time.perf_counter() - t0
    for lib in libs:
        # the Hamming product runs on the tensor cores: IMMA in the SASS
        imma = _sass_count(lib.library_path(), "IMMA")
        print(f"[build] {lib.library_path().name}: nvcc "
              f"{lib.build_seconds:.2f} s | {lib.ptxas_summary()} | "
              f"SASS: {imma} IMMA, {_sass_count(lib.library_path(), 'POPC')} "
              f"POPC")
        if imma == 0:
            raise AssertionError(f"{lib.name}: no IMMA instruction in its SASS")
    print(f"[build] {len(libs)} kernels in {dt:.2f} s (parallel nvcc)")


def _descriptors(rng, n, m):
    """Descriptors with top-bit words, duplicated key rows and queries
    equal to keys (ties and zero distances)."""
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    a[::7, 0] = 0xFFFFFFFF
    b[::3, 7] |= np.uint32(0x80000000)
    if m > 10:
        b[5::11] = b[3:3 + len(b[5::11])]            # duplicated key rows
    if m:
        a[::5] = b[rng.integers(0, m, len(a[::5]))]  # queries equal to keys
    if n > 4:
        a[1::4] = a[0]                               # duplicated query rows
    return a, b


def _gated_inputs(n, m, seed, device):
    """Descriptors plus four gate styles stacked by rows: a search window,
    a random 30 % gate, rows with every pair gated, and all-open rows."""
    rng = np.random.default_rng(seed)
    a, b = _descriptors(rng, n, m)
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


def _time_ms(fn, reps=20, rounds=5):
    """Device time of one call, in ms: `reps` calls queued behind a device
    sleep, so that the card runs them back to back whatever the host's
    launch overhead, timed between two CUDA events; median of `rounds`.
    (One call between two events on an idle card also times the host's
    launch of it.)"""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)      # ~25 ms of device spin
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def _gated_exact(n, m, seed, device):
    """Inputs for [n x m], the kernel against the plain version (exact
    equality), and the max abs error; raises on any difference."""
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, matching

    a, b, gate = _gated_inputs(n, m, seed, device)
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
    return a, b, gate, err


def phase_gated_nn(device, card):
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, matching

    errs = [_gated_exact(n, m, 300 + i, device)[3]
            for i, (n, m) in enumerate(RAGGED_GATED_SHAPES)]
    print(f"[kernel] gated_nn exact at the ragged shapes "
          f"{RAGGED_GATED_SHAPES} (max abs err {max(errs)})")
    rows = []
    for i, (n, m) in enumerate(GATED_SHAPES):
        a, b, gate, err = _gated_exact(n, m, 100 + i, device)
        # plain, kernel, kernel, plain
        p1 = _time_ms(lambda: matching.gated_nn_plain(a, b, gate))
        k1 = _time_ms(lambda: gated_nn_cuda.gated_nn(a, b, gate))
        k2 = _time_ms(lambda: gated_nn_cuda.gated_nn(a, b, gate))
        p2 = _time_ms(lambda: matching.gated_nn_plain(a, b, gate))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        # reads both descriptor sets and the byte gate, writes 12 B a row;
        # the popcounts it needs are those of the open pairs (2 x 256
        # operations each as a +-1 int8 product)
        bound_ms, bound_by = _bound((n + m) * 32 + n * m + n * 12,
                                    2 * 256 * int(gate.sum()))
        print(f"[kernel] gated_nn [{n}x{m}] exact (max abs err {err}); "
              f"kernel {ms:.4f} ms ({k1:.4f}/{k2:.4f}), plain {plain_ms:.4f} ms "
              f"({p1:.4f}/{p2:.4f}), bound {bound_ms:.5f} ms ({bound_by}), "
              f"{float(gate.float().mean()):.3f} of pairs open, no single "
              f"PyTorch call | {card}")
        rows.append(dict(shape=(n, m), err=max(err, *errs), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
    return rows


def _hamming_exact(n, m, seed, device):
    from orb_slam2_map_tpu_torch.ops import hamming_cuda, matching

    rng = np.random.default_rng(seed)
    a_np, b_np = _descriptors(rng, n, m)
    a = torch.as_tensor(a_np.view(np.int32), device=device)
    b = torch.as_tensor(b_np.view(np.int32), device=device)
    d = hamming_cuda.hamming_matrix(a, b)
    torch.cuda.synchronize()
    ref = matching.hamming_matrix_plain(a, b)
    err = float((d - ref).abs().max())
    if not torch.equal(d, ref):
        raise AssertionError(f"hamming kernel != plain at [{n}x{m}]: "
                             f"{int((d != ref).sum())} entries differ, "
                             f"max abs err {err}")
    return a, b, ref, err


def _int_mm_yardstick(a, b, ref):
    """torch._int_mm (cuBLAS int8 tensor cores) on operands unpacked to
    +-1 int8 beforehand: the same dot product as the kernel's, without
    the unpack and the conversion to distances. Returns a zero-argument
    call, or None where cuBLAS refuses the shape."""
    from orb_slam2_map_tpu_torch.ops import matching

    A8 = matching.unpack_pm1(a).to(torch.int8)
    B8t = matching.unpack_pm1(b).to(torch.int8).t()
    try:
        dot = torch._int_mm(A8, B8t)
    except RuntimeError:
        return None
    if not torch.equal((256.0 - dot.float()) * 0.5, ref):
        raise AssertionError(f"_int_mm yardstick != plain at {tuple(ref.shape)}")
    return lambda: torch._int_mm(A8, B8t)


def phase_hamming(device, card):
    from orb_slam2_map_tpu_torch.ops import hamming_cuda, matching

    errs = [_hamming_exact(n, m, 400 + i, device)[3]
            for i, (n, m) in enumerate(RAGGED_HAMMING_SHAPES)]
    print(f"[kernel] hamming exact at the ragged shapes "
          f"{RAGGED_HAMMING_SHAPES} (max abs err {max(errs)})")
    rows = []
    for i, (n, m) in enumerate(HAMMING_SHAPES):
        a, b, ref, err = _hamming_exact(n, m, 200 + i, device)
        # the stereo matcher's masked_nn takes the lowest column on ties
        # (jnp.argmin): hold torch.min to that on the card
        res = matching.masked_nn(ref, ref < 120.0, max_dist=100.0)
        dg = torch.where(ref < 120.0, ref, matching.INF)
        col = torch.arange(m, device=device)
        first = torch.where(dg == dg.amin(1, keepdim=True), col, m).amin(1)
        if not torch.equal(res.idx, first):
            raise AssertionError(f"masked_nn is not first-index on ties at "
                                 f"[{n}x{m}]")
        # the single PyTorch call computing the same matrix, on operands
        # unpacked to +-1 float32 beforehand (unpack not timed)
        A, B = matching.unpack_pm1(a), matching.unpack_pm1(b)
        half = torch.full((), 128.0, device=device)
        lib = torch.addmm(half, A, B.T, alpha=-0.5)
        if not torch.equal(lib, ref):
            raise AssertionError(f"addmm yardstick != plain at [{n}x{m}]")
        int_mm = _int_mm_yardstick(a, b, ref)
        p1 = _time_ms(lambda: matching.hamming_matrix_plain(a, b))
        k1 = _time_ms(lambda: hamming_cuda.hamming_matrix(a, b))
        k2 = _time_ms(lambda: hamming_cuda.hamming_matrix(a, b))
        p2 = _time_ms(lambda: matching.hamming_matrix_plain(a, b))
        lib_ms = _time_ms(lambda: torch.addmm(half, A, B.T, alpha=-0.5))
        int_mm_ms = _time_ms(int_mm) if int_mm is not None else None
        ms, plain_ms = min(k1, k2), min(p1, p2)
        bound_ms, bound_by = _bound((n + m) * 32 + n * m * 4, 2 * 256 * n * m)
        int_mm_txt = (f"{int_mm_ms:.4f} ms" if int_mm_ms is not None
                      else "refused by cuBLAS at this shape")
        print(f"[kernel] hamming [{n}x{m}] exact (max abs err {err}), "
              f"masked_nn first-index on ties; kernel {ms:.4f} ms "
              f"({k1:.4f}/{k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}/"
              f"{p2:.4f}), addmm {lib_ms:.4f} ms, _int_mm on +-1 int8 "
              f"{int_mm_txt}, bound {bound_ms:.5f} ms ({bound_by}) | {card}")
        rows.append(dict(shape=(n, m), err=max(err, *errs), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
    return rows


class GateDensity:
    """Open pairs of the gate of every gated_nn launch on a path, summed
    on the device (a reduction per launch, no host synchronisation) under
    the current bucket, and read once after the path."""

    def __init__(self, device):
        self.device = device
        self.bucket = "tracking"
        self.sums = {}       # bucket -> [open pairs, pairs, sum of fractions]
        self.launches = {}   # bucket -> launches with a non-empty gate

    def __enter__(self):
        from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

        launch = self._launch = gated_nn_cuda.gated_nn

        def counted(desc_a, desc_b, gate):
            if gate.numel():
                acc = self.sums.get(self.bucket)
                if acc is None:
                    acc = self.sums[self.bucket] = torch.zeros(
                        3, dtype=torch.float64, device=self.device)
                    self.launches[self.bucket] = 0
                opened = gate.sum(dtype=torch.float64)
                acc[0] += opened
                acc[1] += float(gate.numel())
                acc[2] += opened / gate.numel()
                self.launches[self.bucket] += 1
            return launch(desc_a, desc_b, gate)

        gated_nn_cuda.gated_nn = counted
        return self

    def __exit__(self, *exc):
        from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

        gated_nn_cuda.gated_nn = self._launch

    def report(self) -> str:
        parts = []
        for bucket, acc in self.sums.items():
            opened, pairs, frac = acc.tolist()
            n = self.launches[bucket]
            parts.append(f"{bucket}: mean {frac / n:.4f} of pairs open over "
                         f"{n} gated_nn launches ({opened / pairs:.4f} of all "
                         f"{pairs:.0f} pairs)")
        return "; ".join(parts)


def phase_slice(device, card, n_frames=N_FRAMES):
    from orb_slam2_map_tpu_torch.config import SystemConfig
    from orb_slam2_map_tpu_torch.io.evaluate import ate_rmse
    from orb_slam2_map_tpu_torch.io.synthetic import (
        SyntheticRGBDSequence, SyntheticWorld, synthetic_camera,
        sweep_trajectory)
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, orb
    from orb_slam2_map_tpu_torch.slam.mapstore import MapStore
    from orb_slam2_map_tpu_torch.slam.tracking import Tracker

    cam = synthetic_camera()
    world = SyntheticWorld(cam=cam, seed=0, device=device)
    Twc, ts = sweep_trajectory(n_frames)
    seq = SyntheticRGBDSequence(world, Twc, ts, noise=True)
    cfg = SystemConfig(camera=cam)
    assert orb.total_capacity(cfg.orb) == 1032, orb.total_capacity(cfg.orb)
    tracker = Tracker(cfg, MapStore(max_keyframes=512, max_points=1 << 16,
                                    kp_capacity=1032),
                      local_mapper=None, device=device)
    frames = [seq[i] for i in range(n_frames)]
    torch.cuda.synchronize()

    _reset_launches()
    per_frame, wall, lost = [], [], 0
    with GateDensity(device) as density:
        for ts_i, gray, depth, _ in frames:
            before = gated_nn_cuda.LAUNCHES
            t0 = time.perf_counter()
            pose = tracker.track_rgbd(ts_i, gray, depth)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            per_frame.append(gated_nn_cuda.LAUNCHES - before)
            lost += pose is None
    launches = _read_launches()

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
          f"first {wall[0] * 1e3:.1f}), launches {launches} (gated_nn min "
          f"per steady-state frame {min(per_frame[2:])}) | {card}")
    print(f"[slice] gate density, RGB-D {density.report()} | {card}")
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

    # two more frames, every input uploaded beforehand: one under the
    # profiler (kernel launches of one step), one with any host
    # synchronisation raising (the async pipeline's dispatch never waits)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = []
    for k in (N_FUSED, N_FUSED + 1):
        _, gray, depth, _ = seq[1 + k]
        mids, mids_p, mp_valid = tracker._local_candidates(cur_obs)
        steps.append((dt(gray), dt(depth), dt(mids_p, torch.int64),
                      dt(mp_valid, torch.bool)))
    torch.cuda.synchronize()

    def step(args, carry):
        g, d, m, v = args
        return pipeline_step.fused_frame_step(
            tracker.cfg, carry, g, d, ctrl, cols["mp_pos"], cols["mp_desc"],
            cols["mp_normal"], cols["mp_min_dist"], cols["mp_max_dist"],
            alive, m, v, cols["mp_redirect"])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry, packed, _ = step(steps[0], carry)
        torch.cuda.synchronize()
    events = prof.events()
    launch_calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                       and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                      "cudaLaunchKernelExC"))
    gpu_kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        carry, packed, _ = step(steps[1], carry)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = packed.cpu().numpy()
    if out[5] < 0.5:
        raise AssertionError(f"fused_frame_step not ok under sync-debug mode: "
                             f"head {out[:8]}")
    print(f"[fused] one fused_frame_step: {launch_calls} kernel-launch calls, "
          f"{gpu_kernels} GPU kernels (torch.profiler); the next ran clean "
          f"under torch.cuda.set_sync_debug_mode('error') in {host_ms:.2f} ms "
          f"of host time | {card}")
    return (A_R, A_t), launch_calls


class ThreadLaunches:
    """gated_nn launches counted per host thread (the async pipeline
    launches from its dispatch, mapper and continuous-BA threads)."""

    def __init__(self):
        self.by_thread = {}

    def __enter__(self):
        import threading

        from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

        launch = self._launch = gated_nn_cuda.gated_nn
        lock = threading.Lock()

        def counted(*args):
            out = launch(*args)
            with lock:
                me = threading.get_ident()
                self.by_thread[me] = self.by_thread.get(me, 0) + 1
            return out

        gated_nn_cuda.gated_nn = counted
        return self

    def __exit__(self, *exc):
        from orb_slam2_map_tpu_torch.ops import gated_nn_cuda

        gated_nn_cuda.gated_nn = self._launch

    def mine(self) -> int:
        import threading

        return self.by_thread.get(threading.get_ident(), 0)


def phase_reloc(device, card, tracker, seq, align):
    """Kidnap the [slice] tracker at three points of its sweep (LOST, no
    velocity, then that frame): it must relocalize, within 2 cm of the
    aligned ground truth."""
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda
    from orb_slam2_map_tpu_torch.slam import search, tracking

    A_R, A_t = align
    match = search.match_frame_to_kf
    relocalize = tracker._relocalize
    stats = {"candidates": 0, "ms": [], "launches": []}

    def counted_match(*args, **kwargs):
        stats["candidates"] += 1
        return match(*args, **kwargs)

    def timed(f):
        torch.cuda.synchronize()
        before = gated_nn_cuda.LAUNCHES
        t0 = time.perf_counter()
        out = relocalize(f)
        torch.cuda.synchronize()
        stats["ms"].append((time.perf_counter() - t0) * 1e3)
        stats["launches"].append(gated_nn_cuda.LAUNCHES - before)
        return out

    errs = []
    search.match_frame_to_kf = counted_match
    tracker._relocalize = timed
    _reset_launches()
    try:
        for i in RELOC_FRAMES:
            ts_i, gray, depth, _ = seq[i]
            tracker.state = tracking.TrackingState.LOST
            tracker.velocity = None
            pose = tracker.track_rgbd(ts_i, gray, depth)
            if pose is None or tracker.state != tracking.TrackingState.OK:
                raise AssertionError(f"kidnap at frame {i}: not relocalized")
            c = A_R @ (-pose[:3, :3].T @ pose[:3, 3]) + A_t
            errs.append(float(np.linalg.norm(c - seq.gt_Twc[i][:3, 3])))
    finally:
        search.match_frame_to_kf = match
        del tracker._relocalize
    launches = _read_launches()
    print(f"[reloc] {len(RELOC_FRAMES)} kidnaps (frames {RELOC_FRAMES}) "
          f"relocalized against {tracker.map.n_keyframes()} keyframes: "
          f"centre error (cm) {np.round(np.asarray(errs) * 100, 3).tolist()}, "
          f"ms per relocalization {np.round(stats['ms'], 2).tolist()}, "
          f"{stats['candidates']} candidates tried, gated_nn launches per "
          f"relocalization {stats['launches']}, launches {launches} | {card}")
    if max(errs) > ATE_GATE_M:
        raise AssertionError(f"relocalized centre error {max(errs)} m")
    if min(stats["launches"]) < 1 or sum(stats["launches"]) < stats["candidates"]:
        raise AssertionError(f"fewer gated_nn launches than candidates: {stats}")
    return launches


def _async_system(device, n_frames, noise_seed=0):
    """bench.py's pass 1 at full width: SLAMSystem(RGBD, local mapping, no
    loop closing; MapStore(512, 65536), local-map cap 4096, pipeline
    depth 24) and the noisy 640x480 sweep (SensorNoiseModel(seed=0)),
    frames rendered beforehand."""
    from orb_slam2_map_tpu_torch.config import SystemConfig
    from orb_slam2_map_tpu_torch.io.synthetic import (
        SensorNoiseModel, SyntheticRGBDSequence, SyntheticWorld,
        synthetic_camera, sweep_trajectory)
    from orb_slam2_map_tpu_torch.slam.system import SLAMSystem, Sensor

    cam = synthetic_camera()
    world = SyntheticWorld(cam=cam, seed=0, device=device)
    Twc, ts = sweep_trajectory(n_frames)
    seq = SyntheticRGBDSequence(world, Twc, ts,
                                noise=SensorNoiseModel(seed=noise_seed))
    frames = [seq[i] for i in range(n_frames)]
    slam = SLAMSystem(SystemConfig(camera=cam), Sensor.RGBD,
                      enable_loop_closing=False, device=device)
    return slam, seq, frames


def _stop(slam):
    pipe = slam.pipeline
    slam.shutdown()
    alive = [t.name for t in pipe.threads() if t.is_alive()]
    if alive:
        raise AssertionError(f"pipeline threads alive after shutdown: {alive}")
    if pipe.errors:
        raise AssertionError(f"pipeline worker errors: {pipe.errors!r}")


def phase_async(device, card, n_frames=N_ASYNC):
    from orb_slam2_map_tpu_torch.io.evaluate import ate_rmse
    from orb_slam2_map_tpu_torch.slam import pipeline_step
    from orb_slam2_map_tpu_torch.utils import profiling

    slam, seq, frames = _async_system(device, n_frames)
    per_step = []
    fused = pipeline_step.fused_frame_step
    torch.cuda.synchronize()
    profiling.PROFILER.reset()
    _reset_launches()
    with ThreadLaunches() as counts:
        def counted(*args, **kwargs):
            before = counts.mine()
            out = fused(*args, **kwargs)
            per_step.append(counts.mine() - before)
            return out

        pipeline_step.fused_frame_step = counted
        try:
            t0 = time.perf_counter()
            for ts_i, gray, depth, _ in frames:
                slam.track_rgbd_async(ts_i, gray, depth)
            slam.pipeline.flush(timeout=ASYNC_TIMEOUT_S)
            wall = time.perf_counter() - t0
        finally:
            pipeline_step.fused_frame_step = fused
    launches = _read_launches()
    summary = profiling.PROFILER.summary()
    logs = slam.tracker.logs
    lost = sum(lg.lost for lg in logs) + (n_frames - len(logs))
    ts_raw, T_raw = slam.tracker.trajectory(refine=False)
    ate = ate_rmse(ts_raw, T_raw[:, :3, 3], seq.timestamps, seq.gt_Twc[:, :3, 3])
    # [mean ms, count] per stage; fetch_batchsz is a count (frames per
    # fetch), not a time
    stages = {k.split("/", 1)[1]: [round(v["mean_ms"], 3), v["count"]]
              for k, v in summary.items() if k.startswith("pipeline/")
              and k != "pipeline/fetch_batchsz"}
    batch = summary.get("pipeline/fetch_batchsz", {}).get("mean_ms", 0.0) / 1e3
    dispatch_ms = summary.get("pipeline/dispatch", {}).get("mean_ms", float("nan"))
    print(f"[async] {n_frames} frames 640x480 through track_rgbd_async + flush "
          f"(pipeline depth {slam._pipeline_depth}): {n_frames / wall:.3f} fps "
          f"({wall:.2f} s wall), lost {lost}, keyframes "
          f"{slam.map.n_keyframes()}, points {slam.map.n_points()}, ATE raw "
          f"{ate * 100:.3f} cm, {len(per_step)} frames dispatched async, "
          f"dispatch thread host {dispatch_ms:.2f} ms per frame, gated_nn "
          f"launches per async frame min {min(per_step, default=0)} max "
          f"{max(per_step, default=0)}, "
          f"launches {launches} | {card}")
    print(f"[async] pipeline stages [mean ms, count]: {json.dumps(stages)}; "
          f"mean frames per fetch {batch:.2f} | {card}")
    _stop(slam)
    if lost:
        raise AssertionError(f"{lost} lost frames in the async run")
    if not ate <= ATE_GATE_M:
        raise AssertionError(f"async raw ATE {ate} m above {ATE_GATE_M} m")
    if len(per_step) < n_frames // 2 or min(per_step) < 3:
        raise AssertionError(f"async dispatch: {len(per_step)} frames, "
                             f"gated_nn launches per frame {per_step}")
    return launches, {"fps": n_frames / wall, "dispatch_ms": dispatch_ms}


def phase_recovery(device, card, n_frames=N_RECOVERY):
    """An async run with a 4-frame blackout (featureless noise, no depth):
    the pipeline declares the failure, drains, replays the buffered frames
    through the synchronous tracker and must end OK. n_frames: (frames
    run, frames of the sweep)."""
    slam, _, frames = _async_system(device, n_frames[1])
    n_frames = n_frames[0]
    frames = frames[:n_frames]
    rng = np.random.default_rng(0)
    H, W = frames[0][1].shape
    _reset_launches()
    t0 = time.perf_counter()
    for i, (ts_i, gray, depth, _) in enumerate(frames):
        if BLACKOUT[0] <= i < BLACKOUT[1]:
            gray = rng.uniform(0, 2, (H, W)).astype(np.float32)
            depth = np.zeros((H, W), dtype=np.float32)
        slam.track_rgbd_async(ts_i, gray, depth)
    slam.pipeline.flush(timeout=ASYNC_TIMEOUT_S)
    wall = time.perf_counter() - t0
    t = slam.tracker
    branch = ("relocalized at frame " + str(t.last_reloc_frame_id)
              if t.last_reloc_frame_id >= 0 else "reset and re-initialized")
    print(f"[recovery] {n_frames} async frames, blackout at frames "
          f"{BLACKOUT[0]}-{BLACKOUT[1] - 1}: failure declared at t = "
          f"{t.failure_ts}, {branch}, final state {t.state.name}, "
          f"{len(t.logs)} frames logged, {wall:.2f} s, launches "
          f"{_read_launches()} | {card}")
    ok = t.state.name == "OK" and bool(t.failure_ts)
    _stop(slam)
    if not ok:
        raise AssertionError(f"recovery did not end OK: state {t.state.name}, "
                             f"failures {t.failure_ts}")


def _stereo_frames(device, cam, n_frames):
    """A rectified stereo sweep rendered on the card: the left eye on
    sweep_trajectory, the right eye at Twc . [b, 0, 0], b = bf / fx."""
    from orb_slam2_map_tpu_torch.io.synthetic import (SyntheticWorld,
                                                      sweep_trajectory)

    world = SyntheticWorld(cam=cam, seed=0, device=device)
    Twc, ts = sweep_trajectory(n_frames, amplitude=STEREO_SWEEP_AMPLITUDE,
                               fps=cam.fps)
    b = cam.bf / cam.fx
    frames = []
    for T in Twc:
        Tr = T.copy()
        Tr[:3, 3] += T[:3, :3] @ np.asarray([b, 0.0, 0.0])
        for eye in (T[:3, 3], Tr[:3, 3]):
            if not ((eye > 0.05).all() and (eye < world.size - 0.05).all()):
                raise AssertionError(f"stereo eye {eye} outside the room")
        frames.append((world.render_tensors(T)[0],
                       world.render_tensors(Tr)[0]))
    return Twc, ts, frames


def phase_stereo(device, card, n_frames=N_STEREO):
    from orb_slam2_map_tpu_torch.config import ORBConfig, SystemConfig
    from orb_slam2_map_tpu_torch.io.evaluate import ate_rmse
    from orb_slam2_map_tpu_torch.io.kitti import kitti_camera
    from orb_slam2_map_tpu_torch.ops import gated_nn_cuda, hamming_cuda, orb
    from orb_slam2_map_tpu_torch.slam.system import SLAMSystem, Sensor
    from orb_slam2_map_tpu_torch.utils import profiling

    cam = kitti_camera(0)
    # KITTI settings: 2000 features (Examples/Stereo/KITTI00-02.yaml)
    cfg = SystemConfig(camera=cam,
                       orb=ORBConfig(n_features=2000, max_keypoints=2048))
    assert orb.total_capacity(cfg.orb) == 2040, orb.total_capacity(cfg.orb)
    slam = SLAMSystem(cfg, Sensor.STEREO, enable_loop_closing=False,
                      max_keyframes=512, max_points=1 << 16, device=device)
    Twc, ts, frames = _stereo_frames(device, cam, n_frames)
    torch.cuda.synchronize()

    # gated-NN launches made by local mapping
    mapper = slam.local_mapper
    process = mapper.process_keyframe
    mapping_launches = [0]
    density = GateDensity(device)

    def counted(kid, *args, **kwargs):
        before = gated_nn_cuda.LAUNCHES
        density.bucket = "local mapping"
        try:
            process(kid, *args, **kwargs)
        finally:
            density.bucket = "stereo tracking"
        mapping_launches[0] += gated_nn_cuda.LAUNCHES - before

    mapper.process_keyframe = counted
    profiling.PROFILER.reset()
    profiling.PROFILER.sync = torch.cuda.synchronize
    _reset_launches()
    wall, per_frame_hamming, lost = [], [], 0
    density.bucket = "stereo tracking"
    try:
        with density:
            for ts_i, (gl, gr) in zip(ts, frames):
                before = hamming_cuda.LAUNCHES
                t0 = time.perf_counter()
                pose = slam.track_stereo(float(ts_i), gl, gr)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
                per_frame_hamming.append(hamming_cuda.LAUNCHES - before)
                lost += pose is None
    finally:
        profiling.PROFILER.sync = None
    launches = _read_launches()

    ts_raw, T_raw = slam.tracker.trajectory(refine=False)
    ate_raw = ate_rmse(ts_raw, T_raw[:, :3, 3], ts, Twc[:, :3, 3])
    finite = np.isfinite(T_raw).all() and T_raw.shape == (n_frames, 4, 4)
    print(f"[stereo] {n_frames} frames {cam.width}x{cam.height} (KITTI 00-02 "
          f"camera, 2040 slots), lost {lost}, keyframes "
          f"{slam.map.n_keyframes()}, points {slam.map.n_points()}, ATE raw "
          f"{ate_raw * 100:.3f} cm, median frame "
          f"{np.median(wall[1:]) * 1e3:.2f} ms (mean "
          f"{np.mean(wall[1:]) * 1e3:.2f}, first {wall[0] * 1e3:.1f}; stage "
          f"boundaries synchronised), launches {launches} (hamming min per "
          f"frame {min(per_frame_hamming)}, gated_nn in local mapping "
          f"{mapping_launches[0]}) | {card}")
    print(f"[stereo] gate density, {density.report()} | {card}")
    print("[stereo] profile_report():\n" + slam.profile_report())
    if lost:
        raise AssertionError(f"{lost} lost stereo frames")
    if not (finite and ate_raw <= ATE_GATE_M):
        raise AssertionError(f"stereo raw ATE {ate_raw} m above "
                             f"{ATE_GATE_M} m (finite: {finite})")
    if min(per_frame_hamming) < 1:
        raise AssertionError(f"a stereo frame ran no hamming kernel: "
                             f"{per_frame_hamming}")
    if mapping_launches[0] < 1:
        raise AssertionError("local mapping launched no gated_nn kernel")
    return launches


def main():
    device, card = phase_device()
    phase_build()
    gated_rows = phase_gated_nn(device, card)
    hamming_rows = phase_hamming(device, card)
    tracker, seq, rgbd_launches, raw_traj = phase_slice(device, card)
    if rgbd_launches["gated_nn"] < 1:
        raise AssertionError("the RGB-D path launched no gated_nn kernel")
    align, _ = phase_fused(device, card, tracker, seq, raw_traj)
    reloc_launches = phase_reloc(device, card, tracker, seq, align)
    stereo_launches = phase_stereo(device, card)
    for name, n in stereo_launches.items():
        if n < 1:
            raise AssertionError(f"the stereo path launched no {name} kernel")
    async_launches, _ = phase_async(device, card)
    phase_recovery(device, card)
    for path, counts in (("reloc", reloc_launches), ("async", async_launches)):
        if counts["gated_nn"] < 1:
            raise AssertionError(f"the {path} path launched no gated_nn kernel")

    g = next(r for r in gated_rows if r["shape"] == (4096, 2040))
    h = next(r for r in hamming_rows if r["shape"] == (2040, 2040))
    print(json.dumps({"kernels": [
        {"name": "gated_nn", "route": "cuda",
         "source": "orb_slam2_map_tpu_torch/csrc/gated_nn.cu",
         "replaces": "orb_slam2_map_tpu/ops/pallas_kernels.py:125",
         "launches": stereo_launches["gated_nn"],
         "launches_by_path": {"rgbd": rgbd_launches["gated_nn"],
                              "stereo": stereo_launches["gated_nn"],
                              "reloc": reloc_launches["gated_nn"],
                              "async": async_launches["gated_nn"]},
         "shape": list(g["shape"]),
         "max_abs_err": max(r["err"] for r in gated_rows),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": None},
        {"name": "hamming", "route": "cuda",
         "source": "orb_slam2_map_tpu_torch/csrc/hamming.cu",
         "replaces": "orb_slam2_map_tpu/ops/pallas_kernels.py:51",
         "launches": stereo_launches["hamming"],
         "launches_by_path": {"rgbd": rgbd_launches["hamming"],
                              "stereo": stereo_launches["hamming"],
                              "reloc": reloc_launches["hamming"],
                              "async": async_launches["hamming"]},
         "shape": list(h["shape"]),
         "max_abs_err": max(r["err"] for r in hamming_rows),
         "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
         "bound_by": h["bound_by"], "library_ms": h["library_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
