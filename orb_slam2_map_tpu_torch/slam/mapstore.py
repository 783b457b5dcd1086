"""SoA map store: keyframes, map points, observations, covisibility.

Port of orb_slam2_map_tpu/slam/mapstore.py (a copy of its numpy host
state), replacing the reference's pointer-graph of KeyFrame / MapPoint /
Map objects (reference: src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc).
All map state lives in fixed-capacity structure-of-arrays with existence
masks; stages run as host-orchestrated phases with single-writer
ownership.

Covisibility (reference: src/KeyFrame.cc:327-417 UpdateConnections) is an
integer weight matrix maintained by O(K*N) scans of the kf_obs
observation table (the single source of truth); the spanning tree
(:409-414, :491-583 re-parenting) is a parent array.

Descriptors are kept as uint32 words, as in the JAX package; the device
columns carry them as int32 bit-views (`.view(np.int32)`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.matching import popcount_np
from ..utils.device import default_device, to_device

COVIS_EDGE_MIN = 15  # keep covisibility edge if weight >= 15 (ref :368-390)


def host(x) -> np.ndarray:
    """numpy view of a tensor (copied to the host if it lives on a
    device) or of an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MapStore:
    def __init__(self, max_keyframes: int = 512, max_points: int = 1 << 16,
                 kp_capacity: int = 1024):
        K, M, N = max_keyframes, max_points, kp_capacity
        self.K, self.M, self.N = K, M, N

        # --- keyframes ---
        self.kf_exists = np.zeros(K, dtype=bool)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), dtype=np.float32)
        self.kf_timestamp = np.zeros(K, dtype=np.float64)
        self.kf_frame_id = np.full(K, -1, dtype=np.int64)
        self.kf_xy = np.zeros((K, N, 2), dtype=np.float32)
        self.kf_ur = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_depth = np.full((K, N), -1.0, dtype=np.float32)
        self.kf_level = np.zeros((K, N), dtype=np.int32)
        self.kf_angle = np.zeros((K, N), dtype=np.float32)
        self.kf_desc = np.zeros((K, N, 8), dtype=np.uint32)
        self.kf_kp_valid = np.zeros((K, N), dtype=bool)
        self.kf_obs = np.full((K, N), -1, dtype=np.int64)   # kp -> mp id
        # relative pose to parent at cull time (trajectory recovery,
        # reference: src/KeyFrame.cc:576 mTcp)
        self.kf_Tcp = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))

        # --- map points ---
        self.mp_exists = np.zeros(M, dtype=bool)
        self.mp_pos = np.zeros((M, 3), dtype=np.float32)
        self.mp_desc = np.zeros((M, 8), dtype=np.uint32)
        self.mp_normal = np.zeros((M, 3), dtype=np.float32)
        self.mp_min_dist = np.zeros(M, dtype=np.float32)
        self.mp_max_dist = np.zeros(M, dtype=np.float32)
        self.mp_visible = np.ones(M, dtype=np.int32)
        self.mp_found = np.ones(M, dtype=np.int32)
        self.mp_first_kf = np.full(M, -1, dtype=np.int32)
        self.mp_obs_count = np.zeros(M, dtype=np.int32)
        self.mp_level = np.zeros(M, dtype=np.int32)  # level at creation
        # merge-redirect table (the reference's MapPoint::GetReplaced +
        # Tracking::CheckReplacedInLastFrame): identity for live points;
        # after a fuse merge the dropped id points at its survivor —
        # transitively resolved — so stale bindings (device tracking
        # carry, last-frame observations) follow the merge instead of
        # silently dying with mp_exists
        self.mp_redirect = np.arange(M, dtype=np.int32)

        # --- graph ---
        # kf_obs [K, N] is the single source of truth for observations.
        # The former dense KF x MapPoint incidence/weight matrices were
        # O(K*M) bytes — 1 GB at KITTI-00 scale (K=2048, M=2^18) — and
        # every derived quantity (covisibility weights, observer lists,
        # local-point unions) is an O(K*N) scan of kf_obs instead, which
        # is ~256x smaller. Observation weights follow the reference:
        # stereo/RGB-D observations count 2, mono 1 (MapPoint::
        # AddObservation nObs += 2 when mvuRight >= 0 — this drives the
        # keyframe policy and culling thresholds); the weight of (k, kp)
        # is derived from kf_ur[k, kp] >= 0. _counted_obs mirrors the
        # kf_obs rows as last folded into mp_obs_count so incremental
        # refreshes can subtract the stale contribution.
        self._counted_obs = np.full((K, N), -1, dtype=np.int64)
        self.covis = np.zeros((K, K), dtype=np.int32)
        self.parent = np.full(K, -1, dtype=np.int32)
        self.loop_edges: List[Tuple[int, int]] = []
        self.kf_origin: int = -1  # first KF (GBA root)

        self._next_kf = 0
        self._next_mp = 0
        self.version = 0  # bumped on any structural change
        self._dev = None            # device-resident point-column cache
        self._dev_device = None
        self._dev_version = -1
        # rows whose column data (pos/desc/normal/dist band) changed since
        # the last device sync — device_point_arrays() ships only these
        self._dirty_mp = np.zeros(M, dtype=bool)

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    def n_keyframes(self) -> int:
        return int(self.kf_exists.sum())

    def n_points(self) -> int:
        return int(self.mp_exists.sum())

    def keyframe_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_exists)[0]

    def point_ids(self) -> np.ndarray:
        return np.nonzero(self.mp_exists)[0]

    def alloc_keyframe(self) -> int:
        if self._next_kf < self.K:
            kid = self._next_kf
            self._next_kf += 1
        else:  # reuse a culled slot
            free = np.nonzero(~self.kf_exists)[0]
            if len(free) == 0:
                raise RuntimeError("keyframe capacity exhausted")
            kid = int(free[0])
        self.kf_exists[kid] = True
        return kid

    def alloc_points(self, count: int) -> np.ndarray:
        ids = []
        reused = False
        if self._next_mp + count <= self.M:
            ids = np.arange(self._next_mp, self._next_mp + count)
            self._next_mp += count
        else:
            free = np.nonzero(~self.mp_exists)[0]
            if len(free) < count:
                raise RuntimeError("map point capacity exhausted")
            ids = free[:count]
            reused = True
        self.mp_exists[ids] = True
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.mp_obs_count[ids] = 0
        # a reused slot must shed any stale merge redirect, in BOTH
        # directions: redirect[id] must be identity again, and entries
        # of other (dead) ids still pointing AT this slot must not
        # re-bind old observations to the unrelated new point
        self.mp_redirect[ids] = ids
        if reused:
            stale = np.isin(self.mp_redirect, ids)
            stale[ids] = False
            if stale.any():
                rows = np.nonzero(stale)[0]
                self.mp_redirect[rows] = rows
        self._dirty_mp[ids] = True
        return np.asarray(ids, dtype=np.int64)

    def mark_points_dirty(self, mids):
        """Record direct writes to mp_pos/mp_desc/mp_normal/dist bands so
        the next device_point_arrays() ships the changed rows."""
        self._dirty_mp[mids] = True

    def mark_all_points_dirty(self):
        self._dev = None   # force a full column re-upload

    # ------------------------------------------------------------------
    # keyframe insertion + observations
    # ------------------------------------------------------------------

    def add_keyframe(self, frame, timestamp: float, frame_id: int,
                     obs: np.ndarray) -> int:
        """Insert a tracked frame as a keyframe. `obs` [N] int64: map-point
        id observed by each keypoint (-1 = none)."""
        kid = self.alloc_keyframe()
        self.kf_R[kid] = host(frame.R)
        self.kf_t[kid] = host(frame.t)
        self.kf_timestamp[kid] = timestamp
        self.kf_frame_id[kid] = frame_id
        self.kf_xy[kid] = host(frame.xy)
        self.kf_ur[kid] = host(frame.ur)
        self.kf_depth[kid] = host(frame.depth)
        self.kf_level[kid] = host(frame.level)
        self.kf_angle[kid] = host(frame.angle)
        self.kf_desc[kid] = host(frame.desc).view(np.uint32)
        self.kf_kp_valid[kid] = host(frame.valid)
        self.kf_obs[kid] = obs
        if self.kf_origin < 0:
            self.kf_origin = kid
        self._refresh_obs_row(kid)
        self.update_connections(kid)
        self.version += 1
        return kid

    def _refresh_obs_row(self, kid: int):
        """Fold kf_obs[kid] changes into mp_obs_count: subtract the row's
        previously-counted contribution, add the current one. Call after
        any in-place mutation of kf_obs[kid]."""
        w = np.where(self.kf_ur[kid] >= 0, 2, 1).astype(np.int32)
        old = self._counted_obs[kid]
        ov = old >= 0
        if ov.any():
            np.subtract.at(self.mp_obs_count, old[ov], w[ov])
        new = self.kf_obs[kid]
        nv = new >= 0
        if nv.any():
            np.add.at(self.mp_obs_count, new[nv], w[nv])
        self._counted_obs[kid] = new

    def set_observation(self, kid: int, kp_idx: int, mid: int):
        old = self.kf_obs[kid, kp_idx]
        if old == mid:
            return
        self.kf_obs[kid, kp_idx] = mid
        self._refresh_obs_row(kid)

    def set_observations_bulk(self, kid: int, kp_idx: np.ndarray,
                              mids: np.ndarray):
        self.kf_obs[kid, kp_idx] = mids
        self._refresh_obs_row(kid)

    def refresh_obs_rows(self, kids: np.ndarray):
        """Bulk `_refresh_obs_row` over several keyframes: one flattened
        scatter-add instead of per-row passes."""
        kids = np.asarray(kids)
        if len(kids) == 0:
            return
        w = np.where(self.kf_ur[kids] >= 0, 2, 1).astype(np.int32)
        old = self._counted_obs[kids]
        ov = old >= 0
        if ov.any():
            np.subtract.at(self.mp_obs_count, old[ov], w[ov])
        new = self.kf_obs[kids]
        nv = new >= 0
        if nv.any():
            np.add.at(self.mp_obs_count, new[nv], w[nv])
        self._counted_obs[kids] = new

    def replace_points_bulk(self, pairs) -> None:
        """MapPoint::Replace for a whole round of merges (reference:
        src/MapPoint.cc:177-215) in ONE pass over the observation table.

        `pairs` is a sequence of (old, new): every observation of `old`
        re-binds to `new` unless the keyframe already observes `new`
        (then the old binding drops, keeping the reference's
        no-duplicate-binding invariant); found/visible counters
        accumulate into the survivor; `old` is erased. Chained merges
        (a->b, b->c) resolve transitively. The per-pair variant was a
        full K x N scan per merge — O(matches*K*N) per fuse round at
        capacity (ADVICE r3) — this is O(K*N) total."""
        if len(pairs) == 0:
            return
        # resolve chains at the mapping level (host ints, O(len(pairs)))
        repl: dict = {}

        def resolve(x: int) -> int:
            seen = []
            while x in repl:
                seen.append(x)
                x = repl[x]
            for s in seen:       # path compression
                repl[s] = x
            return x

        for old, new in pairs:
            old, new = int(old), int(new)
            ro, rn = resolve(old), resolve(new)
            if ro == rn or not self.mp_exists[ro]:
                continue
            repl[ro] = rn
        if not repl:
            return
        finals = {o: resolve(o) for o in list(repl)}
        finals = {o: n for o, n in finals.items()
                  if self.mp_exists[o] and self.mp_exists[n]}
        if not finals:
            return
        olds = np.fromiter(finals.keys(), np.int64, len(finals))
        news = np.fromiter(finals.values(), np.int64, len(finals))

        lut = np.arange(self.M, dtype=np.int64)
        lut[olds] = news
        sel = np.zeros(self.M, dtype=bool)
        sel[olds] = True
        hit = (self.kf_obs >= 0) & sel[np.clip(self.kf_obs, 0, None)]
        rows_aff = np.nonzero(hit.any(axis=1) & self.kf_exists)[0]
        if len(rows_aff):
            obs_r = self.kf_obs[rows_aff]                       # [R, N]
            translated = (obs_r >= 0) & sel[np.clip(obs_r, 0, None)]
            obs_r = np.where(translated, lut[np.clip(obs_r, 0, None)],
                             obs_r)
            # within-row dedup: a row may now bind the survivor twice
            # (it observed both old and new). Keep the untranslated
            # binding, else the first translated one — mirrors the
            # reference's "already observes pMP -> EraseObservation"
            # branch. Stable sort groups (value, translated) per row.
            R, N = obs_r.shape
            key = obs_r * 2 + translated                        # -2 for -1s
            order = np.argsort(key, axis=1, kind="stable")
            sv = np.take_along_axis(obs_r, order, 1)
            dup = np.concatenate(
                [np.zeros((R, 1), bool),
                 (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)], axis=1)
            drop = np.zeros_like(dup)
            np.put_along_axis(drop, order, dup, 1)
            obs_r[drop & translated] = -1
            self.kf_obs[rows_aff] = obs_r
        # counters accumulate into the survivor (duplicates add up)
        np.add.at(self.mp_found, news, self.mp_found[olds])
        np.add.at(self.mp_visible, news, self.mp_visible[olds])
        self.mp_exists[olds] = False
        self.mp_obs_count[olds] = 0
        # redirect stale bindings to the survivors (transitive: entries
        # already pointing AT an old now point at its survivor)
        before = self.mp_redirect
        self.mp_redirect = lut.astype(np.int32)[self.mp_redirect]
        changed = np.nonzero(self.mp_redirect != before)[0]
        self._dirty_mp[changed] = True
        if len(rows_aff):
            self.refresh_obs_rows(rows_aff)
        self.version += 1

    # ------------------------------------------------------------------
    # covisibility + spanning tree
    # ------------------------------------------------------------------

    def update_connections(self, kid: int):
        """Recompute covisibility weights for one KF and set its spanning
        -tree parent on first connection (reference: src/KeyFrame.cc:
        327-417)."""
        # shared-point counts against every other KF: one O(K*N) pass
        # over kf_obs (a KF binds each point at most once, so counting
        # matching entries counts shared points)
        obs = self.kf_obs[kid]
        weights = self.shared_counts(obs[obs >= 0])
        weights[kid] = 0
        self.covis[kid, :] = weights
        self.covis[:, kid] = weights
        if self.parent[kid] < 0 and kid != self.kf_origin:
            best = int(np.argmax(weights))
            if weights[best] > 0:
                self.parent[kid] = best

    def covisible_keyframes(self, kid: int, min_weight: int = 1,
                            top_n: Optional[int] = None) -> np.ndarray:
        """Ordered best-covisible KFs (reference: src/KeyFrame.cc:176-195
        GetBestCovisibilityKeyFrames)."""
        w = self.covis[kid].copy()
        w[~self.kf_exists] = 0
        ids = np.nonzero(w >= max(min_weight, 1))[0]
        order = np.argsort(-w[ids], kind="stable")
        ids = ids[order]
        return ids[:top_n] if top_n is not None else ids

    def point_observers(self, mid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(kf_ids, kp_indices) observing map point `mid`."""
        eq = (self.kf_obs == mid) & self.kf_exists[:, None]
        kfs, kps = np.nonzero(eq)
        if len(kfs) == 0:
            return kfs, kps
        # a KF binds a point at most once; keep the first kp if not
        first = np.concatenate([[True], kfs[1:] != kfs[:-1]])
        return kfs[first], kps[first]

    def observed_mask(self, kids: np.ndarray) -> np.ndarray:
        """bool[M]: points observed by any of the given (existing) KFs."""
        mask = np.zeros(self.M, dtype=bool)
        if len(kids):
            obs = self.kf_obs[kids]
            mask[obs[obs >= 0]] = True
        return mask

    def shared_counts(self, mids: np.ndarray) -> np.ndarray:
        """int32[K]: per-KF count of observations landing in `mids`
        (covisibility votes). One O(K*N) scan of kf_obs."""
        weights = np.zeros(self.K, dtype=np.int32)
        if len(mids) == 0:
            return weights
        sel = np.zeros(self.M, dtype=bool)
        sel[mids] = True
        hit = sel[np.clip(self.kf_obs, 0, None)] & (self.kf_obs >= 0)
        weights[:] = hit.sum(axis=1, dtype=np.int32)
        weights *= self.kf_exists
        return weights

    # ------------------------------------------------------------------
    # erasure (culling)
    # ------------------------------------------------------------------

    def erase_point(self, mid: int):
        """SetBadFlag (reference: src/MapPoint.cc:151-168)."""
        self.kf_obs[self.kf_obs == mid] = -1
        self._counted_obs[self._counted_obs == mid] = -1
        self.mp_exists[mid] = False
        self.mp_obs_count[mid] = 0
        self.version += 1

    def erase_points_bulk(self, mids: np.ndarray):
        if len(mids) == 0:
            return
        sel = np.zeros(self.M, dtype=bool)
        sel[mids] = True
        hit = sel[np.clip(self.kf_obs, 0, None)] & (self.kf_obs >= 0)
        self.kf_obs[hit] = -1
        hitc = sel[np.clip(self._counted_obs, 0, None)] \
            & (self._counted_obs >= 0)
        self._counted_obs[hitc] = -1
        self.mp_exists[sel] = False
        self.mp_obs_count[sel] = 0
        self.version += 1

    def erase_keyframe(self, kid: int):
        """SetBadFlag with spanning-tree re-parenting of orphans
        (reference: src/KeyFrame.cc:491-583). Children adopt the culled
        KF's parent; mTcp-equivalent stored for trajectory recovery."""
        parent = self.parent[kid]
        # store relative pose to parent: Tcp = Tcw(kid) * Twc(parent)
        if parent >= 0:
            Tc = np.eye(4, dtype=np.float32)
            Tc[:3, :3] = self.kf_R[kid]
            Tc[:3, 3] = self.kf_t[kid]
            Tp = np.eye(4, dtype=np.float32)
            Tp[:3, :3] = self.kf_R[parent]
            Tp[:3, 3] = self.kf_t[parent]
            self.kf_Tcp[kid] = Tc @ np.linalg.inv(Tp)
        # live children only: a child culled earlier keeps its parent, as
        # its kf_Tcp is relative to that parent (the reference's culled
        # KF leaves its parent's child set, src/KeyFrame.cc:540). The JAX
        # package re-parents culled children too, which breaks their
        # trajectory chain (ROADMAP.md, faults found in the port).
        children = np.nonzero((self.parent == kid) & self.kf_exists)[0]
        # reference runs a best-covisibility adoption loop; adopting the
        # grandparent preserves tree connectivity with the same asymptotics
        self.parent[children] = parent
        self.kf_obs[kid] = -1
        self._refresh_obs_row(kid)
        self.kf_exists[kid] = False
        self.covis[kid, :] = 0
        self.covis[:, kid] = 0
        self.version += 1

    # ------------------------------------------------------------------
    # pose access
    # ------------------------------------------------------------------

    def kf_Tcw(self, kid: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.kf_R[kid]
        T[:3, 3] = self.kf_t[kid]
        return T

    def kf_Twc(self, kid: int) -> np.ndarray:
        T = self.kf_Tcw(kid)
        Ti = np.eye(4, dtype=np.float32)
        Ti[:3, :3] = T[:3, :3].T
        Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
        return Ti

    def set_kf_pose(self, kid: int, R: np.ndarray, t: np.ndarray):
        self.kf_R[kid] = R
        self.kf_t[kid] = t

    # ------------------------------------------------------------------
    # map point attribute maintenance
    # ------------------------------------------------------------------

    def update_point_stats(self, mids: np.ndarray, scale_factors: np.ndarray):
        """Recompute normal, depth band, and distinctive descriptor for the
        given points (reference: src/MapPoint.cc:242-307 ComputeDistinctive
        Descriptors + :330-383 UpdateNormalAndDepth).

        Vectorized over all points at once: CSR observation lists and
        normals in numpy; min-median-Hamming descriptor selection loops
        per point. (The JAX package's native C++ batch kernels come with
        local mapping, which calls this; the tracking slice does not.)"""
        mids = np.atleast_1d(np.asarray(mids))
        mids = mids[self.mp_exists[mids]]
        if len(mids) == 0:
            return
        P = len(mids)
        slot_of_mp = np.full(self.M, -1, dtype=np.int64)
        slot_of_mp[mids] = np.arange(P)
        counts, obs_kf, obs_kp = self._build_observers_np(slot_of_mp, P)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        if offsets[-1] == 0:
            return
        slot_ids = np.repeat(np.arange(P), counts)

        # camera centers of the observers (c = -R^T t)
        centers = np.einsum("kji,kj->ki", self.kf_R[obs_kf],
                            -self.kf_t[obs_kf])
        pos_o = self.mp_pos[mids][slot_ids]
        rays = pos_o - centers
        norms = np.linalg.norm(rays, axis=1) + 1e-12
        unit = rays / norms[:, None]
        nsum = np.zeros((P, 3), dtype=np.float64)
        np.add.at(nsum, slot_ids, unit)
        has = counts > 0
        self.mp_normal[mids[has]] = (
            nsum[has] / counts[has, None]).astype(np.float32)

        # depth band from the first (reference) observer
        first = offsets[:-1][has]
        ref_kf, ref_kp = obs_kf[first], obs_kp[first]
        level = self.kf_level[ref_kf, ref_kp]
        dist = norms[first]
        n_levels = len(scale_factors)
        maxd = (dist * scale_factors[level]).astype(np.float32)
        self.mp_max_dist[mids[has]] = maxd
        self.mp_min_dist[mids[has]] = maxd / scale_factors[n_levels - 1]

        # distinctive descriptor: min median Hamming over observations
        descs = self.kf_desc[obs_kf, obs_kp]                 # [O, 8]
        chosen = np.zeros((P, 8), dtype=np.uint32)
        for p in np.nonzero(has)[0]:
            d = descs[offsets[p]:offsets[p + 1]]
            x = d[:, None, :] ^ d[None, :, :]
            dd = popcount_np(x).sum(axis=-1)
            chosen[p] = d[int(np.argmin(np.median(dd, axis=1)))]
        self.mp_desc[mids[has]] = chosen[has]
        self._dirty_mp[mids] = True
        self.version += 1

    def _build_observers_np(self, slot_of_mp: np.ndarray, P: int):
        """Pure-numpy CSR observer lists, slot-ordered."""
        kfs = np.nonzero(self.kf_exists)[0]
        obs = self.kf_obs[kfs]                                # [K', N]
        kp_grid = np.broadcast_to(np.arange(obs.shape[1]), obs.shape)
        kf_grid = np.broadcast_to(kfs[:, None], obs.shape)
        sel = obs >= 0
        slots = slot_of_mp[obs[sel]]
        keep = slots >= 0
        slots = slots[keep]
        o_kf = kf_grid[sel][keep].astype(np.int32)
        o_kp = kp_grid[sel][keep].astype(np.int32)
        order = np.argsort(slots, kind="stable")
        slots, o_kf, o_kp = slots[order], o_kf[order], o_kp[order]
        counts = np.bincount(slots, minlength=P).astype(np.int32)
        return counts, o_kf, o_kp

    # ------------------------------------------------------------------
    # device-resident point columns (refreshed per map version)
    # ------------------------------------------------------------------

    def device_point_arrays(self, device=None, snapshot: bool = False):
        """Device-resident map-point columns the per-frame tracking steps
        gather from. When the map version changes, only the DIRTY rows
        are shipped and copied into the columns with index_copy_.

        The update is in place: safe on the synchronous tracking path,
        which holds no snapshot of the columns across frames (every
        frame's launches are complete once its packed result has been
        copied to the host, before the next call here). snapshot=True
        returns device copies of the updated columns instead, which
        nothing writes afterwards: the async pipeline publishes those to
        frames that are still in flight when the map changes again (a
        device-to-device copy of ~70 B per point, queued on the caller's
        stream after the update). `device` defaults to the card."""
        cols = self._updated_columns(default_device(device))
        if snapshot:
            return {name: col.clone() for name, col in cols.items()}
        return cols

    def _updated_columns(self, device: torch.device):
        if (self._dev is not None and self._dev_device == device
                and self._dev_version == self.version):
            return self._dev
        n_dirty = int(self._dirty_mp.sum())
        if (self._dev is None or self._dev_device != device
                or n_dirty > self.M // 4):
            self._dev = {name: to_device(col, device)
                         for name, col in self._point_columns(slice(None))}
            self._dev_device = device
        elif n_dirty > 0:
            rows = np.nonzero(self._dirty_mp)[0]
            idx = to_device(rows, device)
            for name, col in self._point_columns(rows):
                self._dev[name].index_copy_(0, idx, to_device(col, device))
        self._dirty_mp[:] = False
        self._dev_version = self.version
        return self._dev

    def _point_columns(self, rows):
        """(name, numpy rows) of every device column; descriptors as
        int32 bit-views."""
        return [("mp_pos", self.mp_pos[rows]),
                ("mp_desc", np.ascontiguousarray(self.mp_desc[rows]).view(np.int32)),
                ("mp_normal", self.mp_normal[rows]),
                ("mp_min_dist", self.mp_min_dist[rows]),
                ("mp_max_dist", self.mp_max_dist[rows]),
                ("mp_redirect", self.mp_redirect[rows])]

    # ------------------------------------------------------------------
    # state exchange
    # ------------------------------------------------------------------

    _STATE_FIELDS = (
        "kf_exists", "kf_R", "kf_t", "kf_timestamp", "kf_frame_id", "kf_xy",
        "kf_ur", "kf_depth", "kf_level", "kf_angle", "kf_desc", "kf_kp_valid",
        "kf_obs", "kf_Tcp", "mp_exists", "mp_pos", "mp_desc", "mp_normal",
        "mp_min_dist", "mp_max_dist", "mp_visible", "mp_found", "mp_first_kf",
        "mp_obs_count", "mp_level", "mp_redirect", "_counted_obs", "covis",
        "parent")

    @classmethod
    def from_arrays(cls, arrays: dict) -> "MapStore":
        """A new MapStore, sized from the arrays, holding their state
        (see load_arrays)."""
        K, N = arrays["kf_obs"].shape
        ms = cls(K, arrays["mp_exists"].shape[0], N)
        ms.load_arrays(arrays)
        return ms

    def load_arrays(self, arrays: dict) -> None:
        """Take over the given state: numpy arrays named as the MapStore
        attributes in _STATE_FIELDS (e.g. the fields of the JAX package's
        MapStore, which has the same names), plus optional cursors
        (_next_kf, _next_mp, kf_origin, version, loop_edges). Every array
        is copied; its shape must be this store's. Descriptors may be
        uint32 or int32 bit-views. The device column cache is dropped."""
        for k in self._STATE_FIELDS:
            if k not in arrays:
                continue
            a = np.asarray(arrays[k])
            dst = getattr(self, k)
            if a.shape != dst.shape:
                raise ValueError(f"{k}: shape {a.shape}, this store holds "
                                 f"{dst.shape}")
            if a.dtype != dst.dtype and a.dtype.itemsize == dst.dtype.itemsize \
                    and a.dtype.kind in "iu" and dst.dtype.kind in "iu":
                a = a.view(dst.dtype)
            setattr(self, k, a.astype(dst.dtype, copy=True))
        self._next_kf = int(arrays.get("_next_kf", int(self.kf_exists.sum())))
        self._next_mp = int(arrays.get("_next_mp", int(self.mp_exists.sum())))
        self.kf_origin = int(arrays.get("kf_origin", -1))
        self.version = int(arrays.get("version", 0))
        self.loop_edges = [tuple(e) for e in arrays.get("loop_edges", [])]
        self.mark_all_points_dirty()
