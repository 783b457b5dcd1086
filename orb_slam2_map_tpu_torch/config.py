"""Configuration system.

Replaces the reference's cv::FileStorage YAML parsing (reference:
src/Tracking.cc:133-237, src/System.cc:60-67) with typed dataclasses, and
can load the reference's own OpenCV-YAML settings files (TUM1.yaml etc.)
so users can switch with their existing configs.

Every hard-coded behavioral constant catalogued in SURVEY.md §2 lives here
with its reference citation, so the behavioral spec is auditable in one
place and every threshold is tunable.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional

from .geom.camera import PinholeCamera


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor parameters (reference: Examples/RGB-D/TUM1.yaml:41-53,
    src/ORBextractor.cc:72-74, 410-470)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    edge_threshold: int = 19     # border margin (src/ORBextractor.cc:72)
    patch_size: int = 31         # IC-angle / BRIEF patch (src/ORBextractor.cc:73)
    cell_size: int = 32          # grid cell for spatial balancing; the
                                 # reference uses 30px cells + a quadtree
                                 # (src/ORBextractor.cc:769-829); we use a
                                 # power-of-2 cell with per-cell top-k which
                                 # maps to static TPU shapes.
    max_keypoints: int = 1024    # fixed device capacity (padded)

    @property
    def scale_factors(self):
        return [self.scale_factor ** i for i in range(self.n_levels)]

    @property
    def level_sigma2(self):
        return [s * s for s in self.scale_factors]

    def features_per_level(self):
        """Geometric per-level quota, reference ctor logic
        (src/ORBextractor.cc:410-440)."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - factor) / (1 - factor ** self.n_levels)
        counts = []
        total = 0
        for _ in range(self.n_levels - 1):
            c = int(round(n_desired))
            counts.append(c)
            total += c
            n_desired *= factor
        counts.append(max(self.n_features - total, 0))
        return counts


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference: src/ORBmatcher.cc:37-39)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9    # SearchByProjection last-frame
    nn_ratio_bow: float = 0.7         # TrackReferenceKeyFrame (src/Tracking.cc:1049)
    nn_ratio_reloc: float = 0.75      # Relocalization (src/Tracking.cc:1668)


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference: src/Tracking.cc)."""

    min_init_stereo_points: int = 500     # StereoInitialization (:789)
    min_init_mono_keypoints: int = 100    # MonocularInitialization (:848)
    min_init_mono_matches: int = 100      # (:880)
    motion_model_min_matches: int = 20    # TrackWithMotionModel (:1189)
    ref_kf_min_matches: int = 15          # TrackReferenceKeyFrame (:1058)
    ref_kf_min_inliers: int = 10          # (:1082)
    local_map_min_inliers: int = 30       # TrackLocalMap (:1249)
    local_map_min_inliers_after_reloc: int = 50  # (:1244)
    search_window_stereo: float = 7.0     # SearchByProjection th (:1169)
    search_window_mono: float = 15.0
    max_local_keyframes: int = 80         # UpdateLocalKeyFrames cap (:1589)
    min_frames_between_kf: int = 0        # mMinFrames (:268)
    vo_depth_points: int = 100            # UpdateLastFrame / CreateNewKeyFrame
                                          # closest-depth point budget (:1129, :1418)
    reloc_min_inliers: int = 50           # Relocalization accept (:1784)
    lost_reset_max_kfs: int = 5           # auto-reset if lost early (:731)
    # view-change keyframe trigger (no reference equivalent; the
    # reference's c2 gate — inliers < 0.75 * ref-KF matches — blocks
    # insertion on slow trajectories where the candidate union keeps
    # inlier counts high, leaving 600-frame orbits with ~15 keyframes,
    # starving loop detection and letting drift accumulate between
    # distant anchors). A keyframe is also inserted once the camera has
    # rotated/translated this far from its reference keyframe; 0
    # disables. Deliberately COARSE (insurance against pathological
    # starvation, not a cadence driver): r5 measured that halving KF
    # spacing saturates a small host's mapping thread, which then sheds
    # triangulation/BA and the extra unrefined keyframes make drift
    # WORSE.
    kf_rotation_deg: float = 25.0
    kf_translation_m: float = 0.5


@dataclass(frozen=True)
class LocalMappingConfig:
    """(reference: src/LocalMapping.cc)."""

    culling_found_ratio: float = 0.25     # MapPointCulling (:181)
    culling_min_obs: int = 3              # (:186)
    triangulation_neighbors_stereo: int = 10  # CreateNewMapPoints (:210-212)
    triangulation_neighbors_mono: int = 20
    chi2_mono: float = 5.991              # (:374)
    chi2_stereo: float = 7.8              # (:385)
    kf_culling_redundancy: float = 0.9    # KeyFrameCulling (:632-698)
    kf_culling_min_obs: int = 3


@dataclass(frozen=True)
class LoopClosingConfig:
    """(reference: src/LoopClosing.cc)."""

    covisibility_consistency_th: int = 3  # (:43)
    min_kfs_since_last_loop: int = 10     # DetectLoop (:115)
    sim3_min_bow_matches: int = 20        # ComputeSim3 (:268)
    sim3_ransac_prob: float = 0.99        # (:276)
    sim3_ransac_min_inliers: int = 20
    sim3_ransac_max_iters: int = 300
    sim3_min_opt_inliers: int = 20        # (:327-330)
    sim3_min_total_matches: int = 40      # (:376-386)
    essential_graph_min_weight: int = 100 # src/Optimizer.cc:806,952
    # TPU-native extension (no reference equivalent): launch the
    # background global BA every N keyframes even WITHOUT a loop
    # closure. The reference only runs GBA after CorrectLoop
    # (src/LoopClosing.cc:575) because whole-map BA is unaffordable on
    # its CPU budget; on a TPU the implicit-Schur solve rides spare
    # MXU cycles on the background worker, keeping drift continuously
    # small instead of letting it accumulate until a closure. 0 = off.
    # OFF by default: periodic GBA polishes map chi2 but CANNOT remove
    # drift (without loop constraints the observations are drift-
    # consistent), and the r5 per-correction accounting showed mid-run
    # merges moving KF ATE both ways (5.2 -> 11.5 cm once). Global
    # accuracy comes from loop closures + the post-closure GBA + the
    # final trajectory refinement; enable this only for localization-
    # quality maps where continuous polish matters more than variance.
    periodic_gba_kfs: int = 0
    # minimum temporal separation (in frames) between a keyframe and a
    # loop candidate. The reference relies on covisibility exclusion
    # alone (src/LoopClosing.cc:121-124); when the covisibility edge to
    # a ~1 s-old keyframe decays below the 15-point threshold (sparse
    # mono maps, post-recovery fragmentation), such candidates pass
    # that gate and burn loop-thread Sim3 attempts on what is simply
    # the previous segment. One second keeps every genuine revisit
    # (medium-range orbit overlaps included) while filtering the
    # constant near-neighbor churn.
    min_candidate_gap_frames: int = 30


@dataclass(frozen=True)
class DenseMappingConfig:
    """Dense cloud + occupancy fusion (reference: src/PointCloudMap.cc,
    src/MapDrawer.cc:527-769)."""

    resolution: float = 0.04              # PointCloudMapping.Resolution
    depth_min: float = 0.01               # cloud depth gates (:115)
    depth_max: float = 10.0
    decimation: int = 3                   # 3x3 pixel decimation (:110-112)
    sor_mean_k: int = 50                  # statistical outlier removal (:46-47)
    sor_std: float = 1.0
    octo_resolution: float = 0.05         # MapDrawer m_res
    octo_depth_min: float = 0.5           # (:540)
    octo_depth_max: float = 4.8           # 0.8 * 6m (:541)
    occ_log_odds_hit: float = 0.85        # log-odds increments (octomap defaults)
    occ_log_odds_miss: float = -0.4
    occ_threshold: float = 0.8            # DrawOctoMap occupancy thresh (:312)
    ground_axis: int = 1                  # RANSAC ground plane: Y axis (:566-663)
    ground_dist_th: float = 0.04


@dataclass(frozen=True)
class SystemConfig:
    """Top-level settings bundle = the reference's YAML + hard constants."""

    camera: PinholeCamera = field(default_factory=lambda: tum1_camera())
    orb: ORBConfig = field(default_factory=ORBConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    local_mapping: LocalMappingConfig = field(default_factory=LocalMappingConfig)
    loop_closing: LoopClosingConfig = field(default_factory=LoopClosingConfig)
    dense: DenseMappingConfig = field(default_factory=DenseMappingConfig)
    depth_map_factor: float = 5000.0      # TUM1.yaml:35
    rgb_order: int = 1                    # Camera.RGB

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tum1_camera() -> PinholeCamera:
    """TUM freiburg1 intrinsics (Examples/RGB-D/TUM1.yaml:8-35)."""
    return PinholeCamera(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480, bf=40.0, fps=30.0, th_depth=50.0,
    )


def parse_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML (the reference's settings format).

    Handles the '%YAML:1.0' directive and flat 'Group.key: value' entries;
    ignores nested structures it doesn't recognize.
    """
    values: dict = {}
    pat = re.compile(r"^([A-Za-z0-9_.]+)\s*:\s*(.+?)\s*(#.*)?$")
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line or line.startswith("%") or line.lstrip().startswith("#"):
                continue
            m = pat.match(line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2)
            raw = raw.strip().strip('"')
            try:
                values[key] = int(raw)
            except ValueError:
                try:
                    values[key] = float(raw)
                except ValueError:
                    values[key] = raw
    return values


def load_settings(path: str) -> SystemConfig:
    """Build a SystemConfig from a reference-format YAML settings file
    (drop-in for the files in Examples/{RGB-D,Monocular,Stereo}/*.yaml)."""
    v = parse_opencv_yaml(path)

    def g(key, default):
        return v.get(key, default)

    cam = PinholeCamera(
        fx=float(g("Camera.fx", 517.3)), fy=float(g("Camera.fy", 516.5)),
        cx=float(g("Camera.cx", 318.6)), cy=float(g("Camera.cy", 255.3)),
        k1=float(g("Camera.k1", 0.0)), k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)), p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        width=int(g("Camera.width", 640)), height=int(g("Camera.height", 480)),
        bf=float(g("Camera.bf", 40.0)), fps=float(g("Camera.fps", 30.0)),
        th_depth=float(g("ThDepth", 50.0)),
    )
    orb = ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    dense = DenseMappingConfig(
        resolution=float(g("PointCloudMapping.Resolution", 0.04)),
    )
    # the reference's hard-coded 500-point stereo-init gate assumes the
    # 1000-feature budget (src/Tracking.cc:789); scale it with nFeatures
    tracking = TrackingConfig(
        min_init_stereo_points=max(100, orb.n_features // 2))
    return SystemConfig(
        camera=cam, orb=orb, dense=dense, tracking=tracking,
        depth_map_factor=float(g("DepthMapFactor", 5000.0)),
        rgb_order=int(g("Camera.RGB", 1)),
    )
