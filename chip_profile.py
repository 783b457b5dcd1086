"""Where the device time goes: torch.profiler over steady-state frames of
the smoke's two cells, on one NVIDIA GPU; the card's POPC issue rate
(csrc/popc_rate.cu), which bounded the CUDA-core Hamming kernels, and
its mma.sync m16n8k32 s8 rate (csrc/mma_rate.cu), which bounds the
tensor-core ones.

    python3 chip_profile.py          # the two cells + the rate probes
    python3 chip_profile.py async    # the async cell: sync / async / async
                                     # with the continuous-BA thread idle

For the 640x480 RGB-D sweep (tracking only, frames 50-59 after 50 warm
frames) and the KITTI-width stereo SLAMSystem sweep (frames 40-59 after
40 warm frames, local mapping included), prints per frame: wall time
under the profiler, GPU kernels, device busy time and share, host
kernel-launch calls, the kernels and device time under each named
stage (torch.profiler.record_function ranges put around the port's
functions; the hand kernels, launched through ctypes, are not seen
inside those ranges and are listed by name), and the kernels that take
the most device time. The cells
are built as chip_smoke.py builds them. The profiler slows the host, so
wall times here are not frame times; chip_smoke.py measures those.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time
from collections import defaultdict

import torch

import chip_smoke

# (module path, attribute) of the functions timed as named stages
RGBD_STAGES = [
    ("orb_slam2_map_tpu_torch.slam.frame", "_build_rgbd"),
    ("orb_slam2_map_tpu_torch.slam.pipeline_step", "motion_match_step"),
    ("orb_slam2_map_tpu_torch.slam.pipeline_step", "local_map_step"),
    ("orb_slam2_map_tpu_torch.optim.pose_opt", "pose_optimize_multi"),
    ("orb_slam2_map_tpu_torch.ops.matching", "gated_nn"),
]
STEREO_STAGES = [
    ("orb_slam2_map_tpu_torch.ops.orb", "extract"),
    ("orb_slam2_map_tpu_torch.ops.stereo", "_stereo_match"),
    ("orb_slam2_map_tpu_torch.ops.matching", "hamming_matrix"),
    ("orb_slam2_map_tpu_torch.ops.matching", "gated_nn"),
    ("orb_slam2_map_tpu_torch.optim.pose_opt", "pose_optimize_multi"),
    ("orb_slam2_map_tpu_torch.slam.tracking", "Tracker._track_with_motion_model"),
    ("orb_slam2_map_tpu_torch.slam.tracking", "Tracker._track_local_map"),
    ("orb_slam2_map_tpu_torch.slam.local_mapping", "LocalMapper.process_keyframe"),
    ("orb_slam2_map_tpu_torch.slam.local_mapping", "LocalMapper._create_new_map_points"),
    ("orb_slam2_map_tpu_torch.slam.local_mapping", "LocalMapper._fuse_neighbors"),
    ("orb_slam2_map_tpu_torch.optim.local_ba", "local_ba"),
]


def _annotate(stages):
    """Wrap each named function in a record_function range of its name.
    The wrappers stay for the rest of the process."""
    import importlib

    for mod_name, attr in stages:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        fn = getattr(owner, name)

        def wrapped(*args, __fn=fn, __name=attr, **kwargs):
            with torch.profiler.record_function(__name):
                return __fn(*args, **kwargs)

        setattr(owner, name, functools.wraps(fn)(wrapped))


def _kernels_under(evt):
    """(count, device us) of the GPU kernels launched under a CPU event."""
    n = len(evt.kernels)
    us = sum(k.duration for k in evt.kernels)
    for child in evt.cpu_children:
        cn, cus = _kernels_under(child)
        n += cn
        us += cus
    return n, us


def _report(name, prof, n_frames, wall_s, card):
    from torch.autograd import DeviceType

    events = prof.events()
    names = {attr for _, attr in (RGBD_STAGES + STEREO_STAGES)}
    # device events, less the device-side copies of the named ranges
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in names
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                  "cudaLaunchKernelExC"))
    per = 1.0 / n_frames
    print(f"[profile] {name}: {n_frames} frames, wall {wall_s * 1e3 * per:.2f} "
          f"ms/frame under the profiler, {len(kernels) * per:.1f} GPU "
          f"kernels/frame, device busy {busy_us * 1e-3 * per:.3f} ms/frame "
          f"({100.0 * busy_us * 1e-6 / wall_s:.2f} % of wall), "
          f"{launches * per:.1f} kernel-launch calls/frame | {card}")
    ranges = defaultdict(lambda: [0, 0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            n, us = _kernels_under(e)
            r = ranges[e.name]
            r[0] += 1
            r[1] += n
            r[2] += us
    for stage, (calls, n, us) in sorted(ranges.items(),
                                        key=lambda kv: -kv[1][2]):
        print(f"[profile] {name}   {stage:<40} calls/frame {calls * per:6.2f}  "
              f"kernels/frame {n * per:8.1f}  device ms/frame "
              f"{us * 1e-3 * per:8.3f}")
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        k = by_kernel[e.name[:70]]
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    # the hand kernels launch through ctypes, outside the ranges' view:
    # found by name
    ours = [(k, v) for k, v in by_kernel.items()
            if "gated_nn" in k or "hamming_kernel" in k]
    for kname, (n, us) in top + ours:
        print(f"[profile] {name}   kernel {kname:<70} n/frame "
              f"{n * per:7.1f} ms/frame {us * 1e-3 * per:.3f}")


def _profiled(run_frame, frames, card, name):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames:
            run_frame(fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(name, prof, len(frames), wall, card)


def profile_rgbd(device, card, n_warm=50, n_prof=10):
    from orb_slam2_map_tpu_torch.config import SystemConfig
    from orb_slam2_map_tpu_torch.io.synthetic import (
        SyntheticRGBDSequence, SyntheticWorld, synthetic_camera,
        sweep_trajectory)
    from orb_slam2_map_tpu_torch.slam.mapstore import MapStore
    from orb_slam2_map_tpu_torch.slam.tracking import Tracker

    cam = synthetic_camera()
    world = SyntheticWorld(cam=cam, seed=0, device=device)
    Twc, ts = sweep_trajectory(chip_smoke.N_FRAMES)
    seq = SyntheticRGBDSequence(world, Twc, ts, noise=True)
    tracker = Tracker(SystemConfig(camera=cam),
                      MapStore(max_keyframes=512, max_points=1 << 16,
                               kp_capacity=1032), device=device)
    frames = [seq[i] for i in range(n_warm + n_prof)]

    def run(fr):
        if tracker.track_rgbd(fr[0], fr[1], fr[2]) is None:
            raise AssertionError("RGB-D frame lost")

    for fr in frames[:n_warm]:
        run(fr)
    _profiled(run, frames[n_warm:], card, "rgbd")


def profile_stereo(device, card, n_warm=40, n_prof=20):
    from orb_slam2_map_tpu_torch.config import ORBConfig, SystemConfig
    from orb_slam2_map_tpu_torch.io.kitti import kitti_camera
    from orb_slam2_map_tpu_torch.slam.system import SLAMSystem, Sensor

    cam = kitti_camera(0)
    cfg = SystemConfig(camera=cam,
                       orb=ORBConfig(n_features=2000, max_keypoints=2048))
    slam = SLAMSystem(cfg, Sensor.STEREO, enable_loop_closing=False,
                      max_keyframes=512, max_points=1 << 16, device=device)
    _, ts, frames = chip_smoke._stereo_frames(device, cam, n_warm + n_prof)
    items = list(zip(ts, frames))
    kfs = []

    def run(item):
        t, (gl, gr) = item
        if slam.track_stereo(float(t), gl, gr) is None:
            raise AssertionError("stereo frame lost")
        kfs.append(slam.map.n_keyframes())

    for item in items[:n_warm]:
        run(item)
    before = slam.map.n_keyframes()
    _profiled(run, items[n_warm:], card, "stereo")
    print(f"[profile] stereo: keyframes {before} -> {kfs[-1]} over the "
          f"profiled window (insertions minus culls) | {card}")


def _smi(field: str) -> float:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _rate_probe(device, name, iters, blocks_per_sm=8):
    """Build csrc/<name>.cu and time its <name>_launch over
    blocks_per_sm x SMs blocks of 256 threads between CUDA events.
    Returns (seconds per launch, blocks, SMs, the library)."""
    import ctypes

    from orb_slam2_map_tpu_torch.ops import cuda_build

    lib = cuda_build.KernelLibrary(
        name, f"{name}_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])
    launch = lib.fn()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = blocks_per_sm * sms
    words = torch.randint(0, 2 ** 31, (1024,), dtype=torch.int32,
                          device=device)
    out = torch.empty(blocks * 256, dtype=torch.int32, device=device)
    stream = cuda_build.stream_of(device)

    def run():
        if launch(words.data_ptr(), out.data_ptr(), blocks, iters, stream):
            raise RuntimeError(f"{name} launch failed")

    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        run()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e-3 / 10, blocks, sms, lib


def popc_rate(device, card, iters=4096):
    """POPC results per clock per SM: 8 independent chains per thread,
    8 resident blocks per SM (csrc/popc_rate.cu)."""
    seconds, blocks, sms, lib = _rate_probe(device, "popc_rate", iters)
    clock_now = _smi("clocks.sm")
    clock_max = _smi("clocks.max.sm")
    n = blocks * 256 * iters * 8
    per_clk = n / seconds / sms / (clock_max * 1e6)
    print(f"[popc] {n:.3e} POPC in {seconds * 1e3:.4f} ms on {sms} SMs: "
          f"{per_clk:.2f} per clock per SM at the {clock_max:.0f} MHz maximum "
          f"SM clock ({n / seconds / sms / (clock_now * 1e6):.2f} at the "
          f"{clock_now:.0f} MHz read right after) | {lib.ptxas_summary()} | "
          f"{card}")


def mma_count(n, m):
    """mma.sync m16n8k32 instructions for all [n, m] descriptor pairs:
    8 k-steps per m16 x n8 tile."""
    return -(-n // 16) * -(-m // 8) * 8


def mma_rate(device, card, iters=4096):
    """mma.sync m16n8k32 s8 instructions per clock per SM and int8 TOP/s:
    8 independent accumulator chains per warp, 8 warps per block, 8
    resident blocks per SM (csrc/mma_rate.cu); and the tensor-core floor
    this rate puts under the two Hamming kernels at their path shapes."""
    seconds, blocks, sms, lib = _rate_probe(device, "mma_rate", iters)
    clock_now = _smi("clocks.sm")
    clock_max = _smi("clocks.max.sm")
    n = blocks * 8 * iters * 8
    rate = n / seconds
    floors = ", ".join(
        f"{kind} [{a}x{b}] {mma_count(a, b) / rate * 1e6:.3f} us"
        for kind, shapes in (("gated_nn", chip_smoke.GATED_SHAPES),
                             ("hamming", chip_smoke.HAMMING_SHAPES[:1]))
        for a, b in shapes)
    print(f"[mma] {n:.3e} mma.sync m16n8k32 s8 in {seconds * 1e3:.4f} ms on "
          f"{sms} SMs: {rate / sms / (clock_max * 1e6):.3f} per clock per SM "
          f"at the {clock_max:.0f} MHz maximum SM clock "
          f"({rate / sms / (clock_now * 1e6):.3f} at the {clock_now:.0f} MHz "
          f"read right after), {rate * 8192 / 1e12:.1f} int8 TOP/s; floors at "
          f"this rate (every tile computed): {floors} | {lib.ptxas_summary()} "
          f"| {card}")


def profile_async(device, card, n_frames=120):
    """The [async] cell's first `n_frames` frames three ways in one
    process: the sync tracker (track_rgbd), the async pipeline as it
    runs, and the async pipeline with its continuous-BA thread idle (a
    diagnostic: every thread launches from Python under one GIL). Prints
    fps, the dispatch thread's host ms per frame and the raw ATE."""
    from orb_slam2_map_tpu_torch.io.evaluate import ate_rmse
    from orb_slam2_map_tpu_torch.slam.async_pipeline import AsyncRGBDPipeline
    from orb_slam2_map_tpu_torch.utils import profiling

    ba_loop = AsyncRGBDPipeline._ba_loop

    def idle(self):
        while self._running:
            time.sleep(0.05)

    for mode in ("sync", "async", "async, continuous BA idle"):
        slam, seq, frames = chip_smoke._async_system(device, chip_smoke.N_ASYNC)
        frames = frames[:n_frames]
        if mode.endswith("idle"):
            AsyncRGBDPipeline._ba_loop = idle
        profiling.PROFILER.reset()
        torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            for ts_i, gray, depth, _ in frames:
                if mode == "sync":
                    slam.track_rgbd(ts_i, gray, depth)
                else:
                    slam.track_rgbd_async(ts_i, gray, depth)
            if mode != "sync":
                slam.pipeline.flush(timeout=chip_smoke.ASYNC_TIMEOUT_S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            AsyncRGBDPipeline._ba_loop = ba_loop
        summ = profiling.PROFILER.summary()
        ts_raw, T_raw = slam.tracker.trajectory(refine=False)
        ate = ate_rmse(ts_raw, T_raw[:, :3, 3], seq.timestamps[:n_frames],
                       seq.gt_Twc[:n_frames, :3, 3])
        stage = "track_rgbd" if mode == "sync" else "pipeline/dispatch"
        ba = summ.get("pipeline/continuous_ba", {})
        print(f"[profile] async cell, first {n_frames} frames, {mode}: "
              f"{n_frames / wall:.3f} fps ({wall:.2f} s), {stage} host "
              f"{summ.get(stage, {}).get('mean_ms', float('nan')):.2f} ms per "
              f"frame (median {summ.get(stage, {}).get('median_ms', float('nan')):.2f}), "
              f"continuous BA {ba.get('count', 0)} solves of "
              f"{ba.get('mean_ms', 0.0):.1f} ms, keyframes "
              f"{slam.map.n_keyframes()}, raw ATE {ate * 100:.3f} cm | {card}")
        slam.shutdown()


def main():
    device, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    if sys.argv[1:] == ["async"]:
        profile_async(device, card)
        print(card)
        return
    popc_rate(device, card)
    mma_rate(device, card)
    _annotate(RGBD_STAGES + [s for s in STEREO_STAGES
                             if s not in RGBD_STAGES])
    profile_rgbd(device, card)
    profile_stereo(device, card)
    print(card)


if __name__ == "__main__":
    sys.exit(main())
