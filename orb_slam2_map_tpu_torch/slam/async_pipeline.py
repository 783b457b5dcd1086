"""Asynchronous RGB-D tracking pipeline: device-resident recurrence +
background supervision.

Port of orb_slam2_map_tpu/slam/async_pipeline.py. The reference overlaps
Tracking / LocalMapping / LoopClosing as CPU threads over a mutexed map
(reference: src/System.cc:107-133); here the boundary is drawn around the
device:

  * The per-frame tracking recurrence (pose, velocity, last-frame
    features, keypoint->point bindings) lives on the device as a carry
    (pipeline_step.TrackCarry). The dispatch thread (the caller of
    `submit`) queues `fused_frame_step` frame after frame and never
    waits for the device.
  * A fetcher thread waits for each frame's packed result to reach the
    host.
  * A supervisor thread owns the host map (single writer; the map lock
    is the analogue of the reference's map mutex): it consumes results
    with a lag, keeps the visibility counters and the trajectory log,
    runs the keyframe policy, and publishes immutable device snapshots
    (map-point columns + local candidate set) that the dispatch thread
    picks up at its next frame. Publication is one reference assignment.
  * A mapper thread runs local mapping per keyframe (with a backlog
    ladder), and a continuous-BA thread runs local BA at whatever rate
    the device allows.
  * A failure (tracking lost) is detected with a lag of up to the
    pipeline depth; the pipeline then drains, replays the buffered
    frames through the synchronous tracker (relocalization included)
    and resumes.

Transport and streams. The pipeline's device is the tracker's device.
On a CUDA device:
  * the uploader thread stages each frame (u8 gray, u16 depth, f32
    control vector) in one slot of a ring of page-locked buffers and
    copies it to the device on a copy stream of its own, then records an
    event; a slot is reused only after that event has completed. The
    dispatch thread makes its stream wait on the event and records the
    frame's tensors onto its stream before the caching allocator could
    hand their memory back to the copy stream;
  * the dispatch, supervisor, mapper and continuous-BA threads all
    launch on the device's default stream (PyTorch's current stream of
    a thread that never set one), so launch order is the only order
    tensors crossing those threads need: a published snapshot or the
    carry is written before it is read, and freed memory is reused in
    stream order. Each in-flight frame also holds its snapshot until it
    has been supervised;
  * each frame's packed result (8 + 12 + N + C + 4N floats) is copied
    without blocking into a page-locked host buffer, followed by an
    event; the fetcher waits on that event (which releases the GIL).
    Keyframe creation downloads the frame's fields once, packed into
    one float32 tensor.
On the CPU (what the tests run, when the caller asks for it) copies
are plain synchronous copies; there are no streams or events.

The JAX package's map-transform deltas (loop corrections and global-BA
merges re-basing the carry) are here as `_on_map_transform` /
`_apply_pending_carry_deltas`; only the loop closer registers them, so
their listener wiring and the loop-closing thread come with the
loop-closing slice (ROADMAP.md). Dense mapping's keyframe insert comes
with the dense slice.

Worker threads print the traceback of an exception and carry on, as
the JAX package's do; each exception is also appended to `errors`.
"""

from __future__ import annotations

import collections
import queue
import threading
import time as _time
import traceback
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..utils import profiling
from ..utils.device import to_device
from . import frame as frame_mod
from . import pipeline_step
from .pipeline_step import PACK_SCALARS, TrackCarry
from .tracking import (LOCAL_POINT_CAP, FrameLog, Tracker, TrackingState,
                       obs_snapshot)

# page-locked upload slots: the upload queues hold at most 2 + 2 frames
UPLOAD_SLOTS = 6
# bound of each thread join at shutdown (a continuous-BA solve in flight
# finishes first)
JOIN_TIMEOUT_S = 30.0
# frame fields downloaded at keyframe creation: (name, float32 columns)
_KF_FIELDS = (("xy", 2), ("ur", 1), ("depth", 1), ("desc", 8), ("level", 1),
              ("angle", 1), ("valid", 1), ("inv_sigma2", 1), ("response", 1))


@dataclass
class Published:
    """Immutable device snapshot published by the supervisor; swapped
    atomically (reference analogue: the map state guarded by
    mMutexMapUpdate, src/Tracking.cc:463)."""

    cols: Dict[str, torch.Tensor]
    mp_alive: torch.Tensor      # [M] bool
    mids_np: np.ndarray         # [<=C] selected local candidate ids
    mids_dev: torch.Tensor      # [C] int64 padded
    mp_valid_dev: torch.Tensor  # [C] bool
    version: int
    # reference KF id + its pose at publish time: frame poses computed
    # against this snapshot log their Tcr against this pose, so the
    # relative transform stays within one map epoch
    ref_kf: int = -1
    ref_Tcw: Optional[np.ndarray] = None


@dataclass
class _InFlight:
    fid: int
    ts: float
    packed: torch.Tensor        # host copy of the packed result
    ready: Optional[torch.cuda.Event]   # set when `packed` has landed
    frame: frame_mod.Frame
    published: Published
    rgb: Optional[np.ndarray]
    deltas_applied: int = 0     # map-transform deltas folded into the
                                # carry when this frame dispatched


class _UploadSlot:
    """Page-locked staging buffers of one frame and the event of their
    last copy to the device."""

    def __init__(self, height: int, width: int):
        self.gray = torch.empty((height, width), dtype=torch.uint8,
                                pin_memory=True)
        self.depth = torch.empty((height, width), dtype=torch.uint16,
                                 pin_memory=True)
        self.ctrl = torch.empty(4, dtype=torch.float32, pin_memory=True)
        self.copied: Optional[torch.cuda.Event] = None


class AsyncRGBDPipeline:
    """Pipelined steady-state tracking around a synchronous Tracker.

    The sync Tracker handles initialization, relocalization and any
    fallback; once tracking is OK with a velocity estimate, frames flow
    through the device recurrence. Results are supervised with up to
    `max_in_flight` frames of lag."""

    def __init__(self, cfg: SystemConfig, tracker: Tracker,
                 local_mapper=None, max_in_flight: int = 16, ring: int = 64):
        self.cfg = cfg
        self.tracker = tracker
        self.map = tracker.map
        self.device = tracker.device
        self._cuda = self.device.type == "cuda"
        self.local_mapper = local_mapper
        self.max_in_flight = max_in_flight
        self.errors: List[BaseException] = []

        self._carry: Optional[TrackCarry] = None
        self._published: Optional[Published] = None
        self._mode = "sync"
        self._failed_at: Optional[int] = None
        self._ring: Deque[Tuple[int, float, np.ndarray, np.ndarray,
                                Optional[np.ndarray]]] = \
            collections.deque(maxlen=ring)
        self._inflight_sem = threading.Semaphore(max_in_flight)

        self._fetch_q: "queue.Queue[Optional[_InFlight]]" = queue.Queue()
        self._result_q: "queue.Queue" = queue.Queue()
        # uploader thread: quantization and the host->device copy run off
        # the dispatch thread, one frame ahead of it
        self._upload_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._uploaded_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._pending_uploads = 0   # dispatch-thread-only counter
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._slots: List[_UploadSlot] = []
        self._next_slot = 0
        self._uploader = threading.Thread(target=self._upload_loop,
                                          daemon=True)
        # host-map ownership; reentrant: recovery holds it across the
        # sync replay and re-enters through _enter_async/_publish
        self._map_lock = threading.RLock()
        self._results_since_refresh = 0
        self._recovered_to = -1
        self._pending_results = 0
        self._pending_cv = threading.Condition()
        self._running = True
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True)
        self._supervisor = threading.Thread(target=self._supervise_loop,
                                            daemon=True)
        # local mapping on its own thread (the reference's LocalMapping
        # thread, src/System.cc:109-110), sharing the map through the lock
        self._kf_q: "queue.Queue" = queue.Queue()
        self._mapper = threading.Thread(target=self._mapper_loop,
                                        daemon=True)
        if self.local_mapper is not None:
            self.local_mapper.lock = self._map_lock
        self._force_republish = False
        # map-transform deltas: (map version after, A^-1 4x4); the carry
        # and in-flight poses are re-based Tcw' = Tcw A^-1
        self._map_deltas: List[Tuple[int, np.ndarray]] = []
        self._carry_deltas_applied = 0
        self._notok_streak = 0
        # continuous refinement: local BA decoupled from the keyframe
        # queue, so that the mapper's backlog ladder never sheds it
        self._ba_thread = None
        if self.local_mapper is not None:
            self.local_mapper.external_ba = True
            self._ba_thread = threading.Thread(target=self._ba_loop,
                                               daemon=True)
        self._fetcher.start()
        self._supervisor.start()
        self._uploader.start()
        self._mapper.start()
        if self._ba_thread is not None:
            self._ba_thread.start()

    def threads(self) -> List[threading.Thread]:
        return [t for t in (self._uploader, self._fetcher, self._supervisor,
                            self._mapper, self._ba_thread) if t is not None]

    def _record_error(self, exc: BaseException):
        """Worker threads survive an exception: print it, keep it."""
        traceback.print_exc()
        self.errors.append(exc)

    # ------------------------------------------------------------------
    # main-thread API
    # ------------------------------------------------------------------

    def submit(self, ts: float, gray: np.ndarray, depth: np.ndarray,
               rgb: Optional[np.ndarray] = None) -> None:
        """Feed one frame ([H, W] numpy gray and depth in metres).
        Non-blocking in the steady state; the frame's pose is recovered
        later from the trajectory log."""
        fid = self.tracker.frame_id + 1
        self._ring.append((fid, ts, gray, depth, rgb))

        if self._failed_at is not None:
            self._drain_pending_uploads()
            self._recover()
            if self._recovered_to >= fid:
                # the recovery replay already tracked this frame
                return

        if self._mode == "sync":
            with self._map_lock:
                self.tracker.track_rgbd(ts, gray, depth, rgb=rgb)
            if (self.tracker.state == TrackingState.OK
                    and self.tracker.velocity is not None):
                self._enter_async()
            return

        # async steady state: hand the frame to the uploader, then
        # dispatch the oldest uploaded frame (a one-frame lookahead lets
        # the upload overlap the dispatch; both queues are FIFO and only
        # this thread pushes and pops)
        self.tracker.frame_id = fid
        after_reloc = (fid - self.tracker.last_reloc_frame_id
                       < int(self.cfg.camera.fps))
        th = 5.0 if after_reloc else 3.0
        tcfg = self.cfg.tracking
        min_inl = (tcfg.local_map_min_inliers_after_reloc if after_reloc
                   else tcfg.local_map_min_inliers)
        self._upload_q.put((fid, ts, gray, depth, rgb, th, min_inl))
        self._pending_uploads += 1
        if self._pending_uploads > 1:
            self._dispatch_one()

    def _upload_loop(self):
        """Uploader thread: u8 gray + u16 depth (the dataset's native
        format, 0.2 mm steps at the TUM factor of 5000). Depths beyond
        the u16 range become 0 = no depth, not saturated: a clipped far
        point would get a wrong pseudo-stereo constraint."""
        qf = float(self.cfg.depth_map_factor) or 5000.0
        while self._running:
            item = self._upload_q.get()
            if item is None:
                return
            fid, ts, gray, depth, rgb, th, min_inl = item
            try:
                with profiling.stage("pipeline/upload"):
                    d = np.asarray(depth) * qf
                    depth_u16 = np.where(d > 65535.0, 0.0, d).astype(np.uint16)
                    gray_u8 = np.asarray(gray, dtype=np.uint8)
                    ctrl = np.asarray([th, float(min_inl), 1.0, 1.0 / qf],
                                      dtype=np.float32)
                    dev = self._upload(gray_u8, depth_u16, ctrl)
            except Exception as e:  # surfaced at dispatch time
                self._uploaded_q.put((fid, ts, e, rgb))
                continue
            self._uploaded_q.put((fid, ts, dev, rgb))

    def _upload(self, gray_u8, depth_u16, ctrl):
        """(gray, depth, ctrl) on the device, plus the event of the copy
        (None on the CPU)."""
        if not self._cuda:
            return (torch.from_numpy(gray_u8.copy()),
                    torch.from_numpy(depth_u16.copy()),
                    torch.from_numpy(ctrl), None)
        if len(self._slots) < UPLOAD_SLOTS:
            self._slots.append(_UploadSlot(*gray_u8.shape))
        slot = self._slots[self._next_slot % len(self._slots)]
        self._next_slot += 1
        if slot.copied is not None:
            slot.copied.synchronize()    # its last copy has left the slot
        slot.gray.numpy()[...] = gray_u8
        slot.depth.numpy()[...] = depth_u16
        slot.ctrl.numpy()[...] = ctrl
        with torch.cuda.stream(self._copy_stream):
            out = tuple(b.to(self.device, non_blocking=True)
                        for b in (slot.gray, slot.depth, slot.ctrl))
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._copy_stream)
        return out + (slot.copied,)

    def _drain_pending_uploads(self):
        """Discard queued-but-undispatched frames (main thread): they stay
        in the ring, and the recovery replay tracks them synchronously."""
        while self._pending_uploads > 0:
            self._uploaded_q.get()
            self._pending_uploads -= 1

    def _dispatch_one(self) -> None:
        """Dispatch the oldest uploaded frame into the device recurrence
        (main thread)."""
        fid, ts, dev, rgb = self._uploaded_q.get()
        self._pending_uploads -= 1
        if isinstance(dev, Exception):
            raise dev
        gray_u8, depth_u16, ctrl, copied = dev
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in (gray_u8, depth_u16, ctrl):
                t.record_stream(stream)
        with profiling.stage("pipeline/backpressure"):
            self._inflight_sem.acquire()
        pub = self._published
        self._apply_pending_carry_deltas(pub)
        with profiling.stage("pipeline/dispatch"):
            self._carry, packed, f = pipeline_step.fused_frame_step(
                self.cfg, self._carry, gray_u8, depth_u16, ctrl,
                pub.cols["mp_pos"], pub.cols["mp_desc"], pub.cols["mp_normal"],
                pub.cols["mp_min_dist"], pub.cols["mp_max_dist"],
                pub.mp_alive, pub.mids_dev, pub.mp_valid_dev,
                pub.cols["mp_redirect"])
            # ONE device->host copy per frame, started now so that it
            # overlaps later frames; the fetcher waits on its event
            host, ready = self._download_async(packed)
        with self._pending_cv:
            self._pending_results += 1
        self._fetch_q.put(_InFlight(
            fid=fid, ts=ts, packed=host, ready=ready, frame=f, published=pub,
            rgb=rgb, deltas_applied=self._carry_deltas_applied))

    def _download_async(self, x: torch.Tensor):
        """(host tensor, event): a non-blocking copy of `x` into
        page-locked memory and the event that marks its arrival (on the
        CPU: `x` itself and None)."""
        if not self._cuda:
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready

    def flush(self, timeout: Optional[float] = None) -> None:
        """Drain all in-flight frames, their supervision and any queued
        local-mapping work; then recover from a failure if one was
        declared. `timeout` (seconds) bounds each wait; a wait that runs
        out raises TimeoutError."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        while self._pending_uploads > 0:
            self._dispatch_one()
        self._wait_results(deadline)
        self._wait_queue(self._kf_q, deadline)
        if self._failed_at is not None:
            self._recover()

    def _wait_results(self, deadline=None):
        with self._pending_cv:
            while self._pending_results > 0:
                if deadline is not None and _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self._pending_results} frames still in flight")
                self._pending_cv.wait(timeout=0.1)

    @staticmethod
    def _wait_queue(q: "queue.Queue", deadline=None):
        if deadline is None:
            q.join()
            return
        with q.all_tasks_done:
            while q.unfinished_tasks:
                left = deadline - _time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{q.unfinished_tasks} keyframes "
                                       f"still queued for mapping")
                q.all_tasks_done.wait(min(left, 0.1))

    def shutdown(self) -> None:
        """Flush, then stop every thread (each join bounded by
        JOIN_TIMEOUT_S). A second call does nothing."""
        if not self._running:
            return
        try:
            self.flush()
        finally:
            self._running = False
            self._fetch_q.put(None)
            self._result_q.put(None)
            self._kf_q.put(None)
            try:
                self._upload_q.put(None, timeout=JOIN_TIMEOUT_S)
            except queue.Full:   # the uploader is stuck behind a failure
                pass
            for t in self.threads():
                t.join(timeout=JOIN_TIMEOUT_S)

    # ------------------------------------------------------------------
    # map-transform re-basing (loop corrections / global-BA merges)
    # ------------------------------------------------------------------

    def _on_map_transform(self, A: np.ndarray):
        """Called under the map lock when the tracker's neighbourhood
        moves by world transform A (X_new = A X_old): registers the delta
        for the device carry (applied at the next dispatch once the
        published snapshot includes the move) and for in-flight results
        (applied at supervision)."""
        Ainv = np.linalg.inv(A).astype(np.float32)
        self._map_deltas.append((self.map.version, Ainv))

    def _apply_pending_carry_deltas(self, pub: Published):
        """Dispatch thread: fold every delta already visible in the
        published snapshot into the device carry (small device composes
        after non-blocking uploads; never waits for the device)."""
        while (self._carry_deltas_applied < len(self._map_deltas)
               and self._map_deltas[self._carry_deltas_applied][0]
               <= pub.version):
            _, Ainv = self._map_deltas[self._carry_deltas_applied]
            c = self._carry
            Ra = to_device(np.ascontiguousarray(Ainv[:3, :3]), self.device)
            ta = to_device(np.ascontiguousarray(Ainv[:3, 3]), self.device)
            self._carry = c._replace(R=c.R @ Ra, t=c.R @ ta + c.t)
            self._carry_deltas_applied += 1

    # ------------------------------------------------------------------
    # mode transitions
    # ------------------------------------------------------------------

    def _enter_async(self):
        t = self.tracker
        lf = t.last_frame
        cur_obs = np.where(
            (t.last_obs >= 0) & self.map.mp_exists[np.clip(t.last_obs, 0,
                                                           None)],
            t.last_obs, -1).astype(np.int32)
        Rv, tv = t.velocity
        dev = lambda a: to_device(np.ascontiguousarray(a, dtype=np.float32),  # noqa: E731
                                  self.device)
        self._carry = TrackCarry(
            R=dev(lf.R), t=dev(lf.t), Rv=dev(Rv), tv=dev(tv),
            cur_obs=to_device(cur_obs, self.device),
            last_xy=lf.xy, last_ur=lf.ur, last_depth=lf.depth,
            last_desc=lf.desc, last_level=lf.level, last_angle=lf.angle,
            last_valid=lf.valid,
            ok=torch.ones((), dtype=torch.bool, device=self.device))
        # the fresh carry comes from the sync tracker's state: every
        # registered delta is already folded in
        self._carry_deltas_applied = len(self._map_deltas)
        with self._map_lock:
            self._publish(t.last_obs)
        self._mode = "async"

    def _publish(self, bindings: Optional[np.ndarray]):
        """Build and swap the published device snapshot (supervisor or
        main thread, under the map lock)."""
        with profiling.stage("pipeline/publish"):
            self._publish_inner(bindings)

    def _publish_inner(self, bindings: Optional[np.ndarray]):
        with profiling.stage("pipeline/publish_cols"):
            cols = self.map.device_point_arrays(self.device, snapshot=True)
            mp_alive = to_device(self.map.mp_exists, self.device)
        if bindings is None:
            bindings = np.full(self.map.N, -1, dtype=np.int64)
        with profiling.stage("pipeline/publish_cand"):
            cand = self._publish_cand(bindings)
        self._publish_finish(cols, mp_alive, cand)

    def _publish_cand(self, bindings):
        return self.tracker._local_candidates(
            np.where(self.map.mp_exists[np.clip(bindings, 0, None)]
                     & (bindings >= 0), bindings, -1))

    def _publish_finish(self, cols, mp_alive, cand):
        if cand is None:
            # no covisibility votes: the current reference keyframe's
            # neighbourhood (points the tracker can see), not the
            # arbitrary lowest-id live points
            ref = self.tracker.ref_kf
            if ref >= 0 and self.map.kf_exists[ref]:
                hood = [ref] + self.map.covisible_keyframes(
                    ref, top_n=10).tolist()
                mids = np.nonzero(self.map.observed_mask(
                    np.asarray(hood)))[0][:LOCAL_POINT_CAP]
            else:
                mids = np.nonzero(self.map.mp_exists)[0][:LOCAL_POINT_CAP]
            pad = LOCAL_POINT_CAP - len(mids)
            mids_p = np.concatenate([mids, np.zeros(pad, dtype=np.int64)])
        else:
            mids, mids_p, _ = cand
        # in the pipelined path already-bound points stay matchable:
        # bindings lag the current frame
        valid = np.concatenate([np.ones(len(mids), bool),
                                np.zeros(LOCAL_POINT_CAP - len(mids), bool)])
        with profiling.stage("pipeline/publish_put"):
            mids_dev = to_device(mids_p.astype(np.int64), self.device)
            valid_dev = to_device(valid, self.device)
        ref = self.tracker.ref_kf
        self._published = Published(
            cols=cols, mp_alive=mp_alive, mids_np=mids,
            mids_dev=mids_dev, mp_valid_dev=valid_dev,
            version=self.map.version, ref_kf=ref,
            ref_Tcw=(self.map.kf_Tcw(ref) if ref >= 0
                     and self.map.kf_exists[ref] else None))

    def _recover(self):
        """Roll back to synchronous tracking after an async failure:
        frames from the failure on are logged lost; the buffered frames
        are re-tracked by the synchronous state machine, whose LOST
        branch relocalizes (reference: src/Tracking.cc:1645-1806)."""
        # everything in flight after the failure is untrusted and is
        # logged lost by _process_result
        self._wait_results()
        failed = self._failed_at
        self._failed_at = None
        self._mode = "sync"
        t = self.tracker
        with self._map_lock:
            t.state = TrackingState.LOST
            t.velocity = None
            start = max(failed if failed is not None else 0,
                        self._recovered_to + 1)
            buffered = [fr for fr in self._ring if fr[0] >= start]
            replay = buffered[-8:]
            if len(buffered) > len(replay):
                # frames beyond the replay window stay logged lost
                profiling.PROFILER.add_sample(
                    "pipeline/replay_cap_dropped",
                    float(len(buffered) - len(replay)))
        # per-frame locking: a replay spans several frames of sync
        # tracking; holding the lock across it would starve the mapper
        for fid, ts, gray, depth, rgb in replay:
            with self._map_lock:
                self._recovered_to = fid
                t.frame_id = fid - 1
                t.track_rgbd(ts, gray, depth, rgb=rgb)
        with self._map_lock:
            if (t.state == TrackingState.OK
                    and t.velocity is not None):
                self._enter_async()

    # ------------------------------------------------------------------
    # fetcher thread: waits for each frame's packed result
    # ------------------------------------------------------------------

    def _fetch_loop(self):
        while self._running:
            item = self._fetch_q.get()
            if item is None:
                return
            batch = [item]
            while True:
                try:
                    nxt = self._fetch_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)
            with profiling.stage("pipeline/fetch"):
                for b in batch:
                    if b.ready is not None:
                        b.ready.synchronize()
            profiling.PROFILER.add_sample("pipeline/fetch_batchsz",
                                          float(len(batch)))
            for b in batch:
                self._result_q.put((b, b.packed.numpy()))

    # ------------------------------------------------------------------
    # mapper thread: the reference's LocalMapping loop
    # ------------------------------------------------------------------

    def _mapper_loop(self):
        while self._running:
            kid = self._kf_q.get()
            if kid is None:
                self._kf_q.task_done()
                return
            try:
                if self.local_mapper is not None:
                    # backlog shedding (the reference's InterruptBA
                    # analogue): with keyframes queuing faster than full
                    # mapping drains, drop to bookkeeping only
                    q = self._kf_q.unfinished_tasks   # incl. this one
                    effort = ("full" if q <= 1 else
                              "medium" if q <= 3 else "light")
                    self.local_mapper.process_keyframe(kid, effort=effort)
            except Exception as e:
                self._record_error(e)
            finally:
                self._kf_q.task_done()

    # ------------------------------------------------------------------
    # continuous-refinement thread: local BA at device rate
    # ------------------------------------------------------------------

    def _ba_loop(self):
        while self._running:
            try:
                m = self.map
                if m.n_keyframes() < 3:
                    _time.sleep(0.1)
                    continue
                live = m.keyframe_ids()
                kid = int(live[np.argmax(m.kf_frame_id[live])])
                n0 = len(self._map_deltas)
                with profiling.stage("pipeline/continuous_ba"):
                    self.local_mapper._local_bundle_adjustment(
                        kid, discard_if=lambda:
                        len(self._map_deltas) > n0)
            except Exception as e:
                self._record_error(e)
                _time.sleep(0.5)
            _time.sleep(0.02)

    # ------------------------------------------------------------------
    # supervisor thread: result consumption + keyframe policy
    # ------------------------------------------------------------------

    def _supervise_loop(self):
        while self._running:
            item = self._result_q.get()
            if item is None:
                return
            inflight, packed = item
            try:
                with profiling.stage("pipeline/supervise"):
                    with self._map_lock:
                        self._process_result(inflight, packed)
            except Exception as e:
                self._record_error(e)
            finally:
                # the slot is released only after supervision, so the
                # slot count bounds how stale a snapshot can be
                self._inflight_sem.release()
                with self._pending_cv:
                    self._pending_results -= 1
                    self._pending_cv.notify_all()

    def _process_result(self, inflight: _InFlight, packed: np.ndarray):
        t = self.tracker
        close_tracked, close_untracked = int(packed[3]), int(packed[4])
        n_inl_final = packed[2]
        ok = packed[5] > 0.5
        N = self.map.N
        S = PACK_SCALARS
        R = packed[S:S + 9].reshape(3, 3).astype(np.float32)
        tt = packed[S + 9:S + 12].astype(np.float32)
        # the raw device pose lives in the dispatched snapshot's map
        # epoch: kept for snapshot-relative logging
        R_snap, tt_snap = R, tt
        # re-based to the current map frame by the deltas registered
        # after this frame dispatched
        for _, Ainv in self._map_deltas[inflight.deltas_applied:]:
            R, tt = R @ Ainv[:3, :3], R @ Ainv[:3, 3] + tt
        cur_obs = packed[S + 12:S + 12 + N].astype(np.int64)
        visible = packed[S + 12 + N:S + 12 + N + LOCAL_POINT_CAP] > 0.5
        base = S + 12 + N + LOCAL_POINT_CAP
        f_xy = packed[base:base + 2 * N].reshape(N, 2)
        f_ur = packed[base + 2 * N:base + 3 * N]
        f_is2 = packed[base + 3 * N:base + 4 * N]

        if self._failed_at is not None and inflight.fid > self._failed_at:
            ok = False   # everything after a failure is untrusted
        if not ok:
            # grace window: a brief dropout (motion blur, a texture-poor
            # wall) often recovers on its own through the in-step 2x
            # window retry; failure is declared after 4 in a row
            if self._failed_at is None:
                self._notok_streak += 1
                if self._notok_streak > 3:
                    self._failed_at = inflight.fid
                    t.failure_ts.append(float(inflight.ts))
            t.logs.append(FrameLog(timestamp=inflight.ts, ref_kf=t.ref_kf,
                                   Tcr=np.eye(4, dtype=np.float32),
                                   lost=True))
            return
        self._notok_streak = 0

        # visibility / found counters (reference: Tracking.cc:1470-1505)
        mids_pub = inflight.published.mids_np
        vis = visible[:len(mids_pub)]
        self.map.mp_visible[mids_pub[vis]] += 1
        alive_obs = cur_obs[(cur_obs >= 0)]
        alive_obs = alive_obs[self.map.mp_exists[alive_obs]]
        self.map.mp_found[alive_obs] += 1
        t.matches_inliers = int(n_inl_final)

        # latest supervised pose: anchors the candidate frustum truncation
        t.async_pose = (R, tt)
        # trajectory log: Tcr against the ref-KF pose of the snapshot this
        # frame was computed against (one map epoch); the live ref KF
        # when the snapshot predates the first keyframe
        Tcw = np.eye(4, dtype=np.float32)
        pub = inflight.published
        if pub.ref_Tcw is not None:
            Tcw[:3, :3] = R_snap
            Tcw[:3, 3] = tt_snap
            ref, Trw = pub.ref_kf, pub.ref_Tcw
        else:
            Tcw[:3, :3] = R
            Tcw[:3, 3] = tt
            ref, Trw = t.ref_kf, self.map.kf_Tcw(t.ref_kf)
        fake_cur = np.where(self.map.mp_exists[np.clip(cur_obs, 0, None)]
                            & (cur_obs >= 0), cur_obs, -1)
        t.logs.append(FrameLog(
            timestamp=inflight.ts, ref_kf=ref,
            Tcr=Tcw @ np.linalg.inv(Trw), lost=False,
            obs=obs_snapshot(fake_cur, f_xy, f_ur, f_is2)))

        # keyframe policy (reference: src/Tracking.cc:1261-1358); keyframe
        # creation outpaces the mapper (it keeps the published candidates
        # fresh) and is deferred only under a pathological backlog
        mapper_busy = self._kf_q.unfinished_tasks > 30
        c1a_force = (inflight.fid - t.last_frame_id_of_kf
                     >= t.max_frames_between_kf)
        if (not t.only_tracking
                and (not mapper_busy or c1a_force)
                and t._need_new_keyframe(
                    inflight.frame, fake_cur,
                    (close_tracked, close_untracked),
                    fid=inflight.fid)):
            with profiling.stage("pipeline/create_kf"):
                self._create_keyframe(inflight, R, tt, fake_cur)
            self._publish(fake_cur)
            self._results_since_refresh = 0
        else:
            self._results_since_refresh += 1
            # periodic candidate refresh, deferred while the mapper works
            # a keyframe (both contend for the map lock) but never more
            # than 15 frames stale
            if (self._force_republish
                    or (self._results_since_refresh >= 5
                        and (self._kf_q.unfinished_tasks == 0
                             or self._results_since_refresh >= 15))):
                self._force_republish = False
                self._publish(fake_cur)
                self._results_since_refresh = 0

    def _create_keyframe(self, inflight: _InFlight, R, tt,
                         cur_obs: np.ndarray):
        """Download the frame once, insert the keyframe and its depth
        points, queue local mapping (reference: src/Tracking.cc:
        1360-1445 + LocalMapping)."""
        t = self.tracker
        f = inflight.frame
        with profiling.stage("pipeline/create_kf_fetch"):
            hf = self._frame_to_host(f, R, tt)
        # points for every valid-depth free keypoint, not only the close
        # band: the mapper's triangulation lags by its queue here
        obs = t._create_points_from_depth(hf, cur_obs, max_new=self.map.N)
        kid = self.map.add_keyframe(hf, inflight.ts, inflight.fid, obs)
        t._finish_new_points(kid, obs)
        t.ref_kf = kid
        t.last_kf_id = kid
        t.last_frame_id_of_kf = inflight.fid
        if self.local_mapper is not None:
            self._kf_q.put(kid)

    @staticmethod
    def _frame_to_host(f: frame_mod.Frame, R, tt) -> frame_mod.Frame:
        """The frame's fields as numpy, from ONE download of them packed
        into a float32 tensor (int32 fields travel as bit views)."""
        cols = []
        for name, width in _KF_FIELDS:
            x = getattr(f, name)
            if x.dtype == torch.bool:
                x = x.to(torch.float32)
            elif x.dtype == torch.int32:
                x = x.view(torch.float32)
            cols.append(x.reshape(-1, width))
        packed = torch.cat(cols, dim=1).cpu().numpy()
        out, o = {}, 0
        for name, width in _KF_FIELDS:
            out[name] = packed[:, o:o + width]
            o += width
        return frame_mod.Frame(
            xy=np.ascontiguousarray(out["xy"]), ur=out["ur"][:, 0].copy(),
            depth=out["depth"][:, 0].copy(),
            desc=np.ascontiguousarray(out["desc"]).view(np.int32),
            level=out["level"][:, 0].copy().view(np.int32),
            angle=out["angle"][:, 0].copy(), valid=out["valid"][:, 0] > 0.5,
            inv_sigma2=out["inv_sigma2"][:, 0].copy(),
            response=out["response"][:, 0].copy(), R=R, t=tt)
