"""System facade: the public entry point of the SLAM engine.

Port of orb_slam2_map_tpu/slam/system.py, replacing the reference's
System class (reference: src/System.cc): constructs the map, tracking and
local mapping, routes frames per sensor type, exposes localization mode,
reset and shutdown, and the trajectory savers.

Local mapping runs as a host-orchestrated phase inside keyframe creation
by default, or on a worker thread fed by a queue (async_mapping=True).
`track_rgbd_async` + `flush` drive the asynchronous RGB-D pipeline
(slam/async_pipeline.py), which brings its own mapping threads.

Parts of the JAX package's facade that belong to later slices of the
port (ROADMAP.md) raise NotImplementedError naming that slice: loop
closing and its background global BA, dense mapping, final_optimize,
monocular tracking and map save/load.
"""

from __future__ import annotations

import enum
import queue
import threading
from typing import Tuple

import numpy as np

from ..config import SystemConfig
from ..io import trajectory as traj_io
from ..ops import orb
from ..utils import profiling
from ..utils.device import default_device
from . import frame as frame_mod
from .local_mapping import LocalMapper
from .mapstore import MapStore
from .tracking import Tracker, TrackingState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _not_ported(what: str, queue_item: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {queue_item} slice "
        f"of ROADMAP.md")


class SLAMSystem:
    def __init__(self, cfg: SystemConfig, sensor: Sensor = Sensor.RGBD,
                 enable_loop_closing: bool = True,
                 enable_dense_mapping: bool = False,
                 async_mapping: bool = False,
                 background_gba: bool = False,
                 pipeline_depth: int = 24,
                 max_keyframes: int = 512, max_points: int = 1 << 16,
                 device=None):
        if enable_loop_closing:
            raise _not_ported("loop closing (pass enable_loop_closing=False)",
                              "loop-closing and global-BA")
        if background_gba:
            raise _not_ported("background global BA",
                              "loop-closing and global-BA")
        if enable_dense_mapping:
            raise _not_ported("dense mapping", "dense")
        self.device = default_device(device)
        self.cfg = cfg
        self.sensor = sensor
        self.map = MapStore(max_keyframes=max_keyframes,
                            max_points=max_points,
                            kp_capacity=orb.total_capacity(cfg.orb))
        self.local_mapper = LocalMapper(cfg, self.map, device=self.device)
        self.tracker = Tracker(cfg, self.map,
                               local_mapper=self._mapper_hook(async_mapping),
                               relocalizer=None, device=self.device)
        self._worker = None
        self._queue: "queue.Queue[int]" = queue.Queue()
        if async_mapping:
            self._running = True
            self._worker = threading.Thread(target=self._mapping_loop,
                                            daemon=True)
            self._worker.start()
        self._pipeline = None
        self._pipeline_depth = pipeline_depth

    # ------------------------------------------------------------------
    # pipelined (asynchronous) tracking
    # ------------------------------------------------------------------

    @property
    def pipeline(self):
        """The AsyncRGBDPipeline, made on first use: a device-resident
        tracking recurrence with background supervision. track_rgbd_async
        + flush is the throughput path; track_rgbd stays the synchronous
        one."""
        if self._pipeline is None:
            from .async_pipeline import AsyncRGBDPipeline

            self._pipeline = AsyncRGBDPipeline(
                self.cfg, self.tracker, local_mapper=self.local_mapper,
                max_in_flight=self._pipeline_depth)
        return self._pipeline

    def track_rgbd_async(self, timestamp: float, gray, depth, rgb=None):
        """Non-blocking frame submission ([H, W] numpy gray and depth in
        metres); poses are recovered from trajectory(), results lag by
        up to the pipeline depth."""
        self._require(Sensor.RGBD)
        self.pipeline.submit(timestamp, gray, depth, rgb=rgb)

    # ------------------------------------------------------------------

    def _mapper_hook(self, async_mapping):
        if not async_mapping:
            return self.local_mapper

        system = self

        class _QueueHook:
            def process_keyframe(self, kid):
                system._queue.put(kid)

        return _QueueHook()

    def _mapping_loop(self):
        while self._running:
            try:
                kid = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            self.local_mapper.process_keyframe(kid)
            self._queue.task_done()

    # ------------------------------------------------------------------
    # frame entry points (reference: src/System.cc:148-330 Track*)
    # ------------------------------------------------------------------

    def _require(self, sensor: Sensor):
        if self.sensor != sensor:
            raise ValueError(f"this system was built for {self.sensor}, "
                             f"not {sensor}")

    def track_rgbd(self, timestamp: float, gray, depth, rgb=None):
        self._require(Sensor.RGBD)
        with profiling.stage("track_rgbd"):
            return self.tracker.track_rgbd(timestamp, gray, depth, rgb=rgb)

    def track_stereo(self, timestamp: float, gray_left, gray_right):
        """Track one rectified stereo pair ([H, W] gray, numpy or tensors);
        returns Tcw [4, 4] or None if lost."""
        self._require(Sensor.STEREO)
        with profiling.stage("track_stereo"):
            with profiling.stage("track_stereo/frame"):
                f = frame_mod.build_stereo_frame(self.cfg, gray_left,
                                                 gray_right,
                                                 device=self.device)
            with profiling.stage("track_stereo/track"):
                return self.tracker.track_frame(timestamp, f)

    def track_monocular(self, timestamp: float, gray):
        raise _not_ported("monocular tracking", "stereo-and-monocular")

    def flush(self):
        """Block until the async pipeline has supervised every submitted
        frame, then until the mapping worker has processed every queued
        keyframe (each a no-op when not in use)."""
        if self._pipeline is not None:
            self._pipeline.flush()
        if self._worker is not None:
            self._queue.join()

    # ------------------------------------------------------------------
    # modes / control (reference: src/System.cc:160-192, 296-347)
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        self.tracker.only_tracking = True
        self.local_mapper.enabled = False

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False
        self.local_mapper.enabled = True

    def reset(self):
        self.tracker.reset()

    def final_optimize(self, iters: int = 40, rounds: int = 2):
        raise _not_ported("final_optimize (global BA)",
                          "loop-closing and global-BA")

    def shutdown(self):
        if self._pipeline is not None:
            self._pipeline.shutdown()
        if self._worker is not None:
            self._running = False
            self._worker.join(timeout=5.0)
            self._worker = None

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def profile_report(self) -> str:
        """Per-stage timing table (tracking / local mapping)."""
        return profiling.PROFILER.report()

    # ------------------------------------------------------------------
    # output (reference: src/System.cc:349-515)
    # ------------------------------------------------------------------

    def trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.tracker.trajectory()

    def save_trajectory_tum(self, path: str):
        ts, Twc = self.trajectory()
        traj_io.write_tum(path, ts, Twc)

    def save_keyframe_trajectory_tum(self, path: str):
        kfs = self.map.keyframe_ids()
        traj_io.write_tum(path, self.map.kf_timestamp[kfs],
                          [self.map.kf_Twc(int(k)) for k in kfs])

    def save_trajectory_kitti(self, path: str):
        _, Twc = self.trajectory()
        traj_io.write_kitti(path, Twc)

    def save_map(self, path: str):
        raise _not_ported("map save", "dense (io/mapio.py)")

    def load_map(self, path: str):
        raise _not_ported("map load", "dense (io/mapio.py)")
