"""Host-side map / state store (rebuild of SURVEY.md §2.8).

A copy of `amcslam_tpu/pipeline/map_store.py`, with two host shortcuts that
give the same numbers (`cam_of_global` bisects, `n_obs` counts in one
array, `update_normal_and_depth` can share camera centers across points).
Mirrors the reference's MultiFrame / MultiKeyFrame / MapPoint / Map / Atlas
(Frame.cc, KeyFrame.cc, MapPoint.cc, Map.cc, Atlas.cc) as plain Python +
NumPy SoA: the map lives on the host; the solvers get padded, statically
shaped problem instances on the device (pipeline/extraction.py) and their
results are written back. The threaded schedule serializes map mutations
through `Map.mutex`.

Key reference behaviors kept:
  * per-camera keypoints with a global index and (camera, local-id) mapping
    (Frame.h:283-285)
  * 12-dim continuous-time state (Twb + world twist) and GP-interpolated
    per-camera poses at each camera's own timestamp (Frame.cc:391-417,
    KeyFrame.cc:116-145 re-interpolates on SetPose)
  * MapPoint observations: one slot per camera per keyframe (index -1 if
    unseen) plus non-keyframe GPObs records (MapPoint.h:46-62)
  * covisibility graph + spanning tree + temporal prev/next chain
  * found/visible ratio bookkeeping for culling (MapPoint.cc)
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_ids = itertools.count()


def _next_id():
    return next(_ids)


@dataclass
class GPObs:
    """Non-keyframe GP observation (MapPoint.h:46-62)."""

    time: float
    cam: int
    uv: np.ndarray       # (2,) undistorted pixel
    ur: float            # right-image u (stereo) or -1
    octave: int = 0
    sigma2_scale: float = 1.0  # KB8 lift variance inflation (1 for pinhole)


@dataclass
class MapPoint:
    position: np.ndarray                      # (3,)
    descriptor: Optional[np.ndarray] = None   # (32,) uint8
    id: int = field(default_factory=_next_id)
    # observations[kf_id] = per-camera keypoint global indices (-1 unseen)
    observations: dict = field(default_factory=dict)
    gp_observations: list = field(default_factory=list)  # [(kf_id, GPObs)]
    normal: np.ndarray = field(default_factory=lambda: np.zeros(3))
    min_dist: float = 0.0
    max_dist: float = 0.0
    n_visible: int = 1
    n_found: int = 1
    bad: bool = False
    first_kf_id: int = -1

    def add_observation(self, kf: "KeyFrame", cam: int, kp_global_idx: int):
        slots = self.observations.setdefault(
            kf.id, -np.ones(kf.n_cameras, dtype=np.int64)
        )
        slots[cam] = kp_global_idx

    def erase_observation(self, kf: "KeyFrame", cam: int):
        if kf.id in self.observations:
            self.observations[kf.id][cam] = -1
            if (self.observations[kf.id] < 0).all():
                del self.observations[kf.id]

    def add_gp_observation(self, kf_id: int, obs: GPObs):
        self.gp_observations.append((kf_id, obs))

    def erase_gp_observation(self, kf_id: int, obs: GPObs):
        self.gp_observations = [
            (k, o) for (k, o) in self.gp_observations if not (k == kf_id and o is obs)
        ]

    def n_obs(self) -> int:
        if not self.observations:
            return 0
        return int(np.count_nonzero(np.concatenate(list(self.observations.values())) >= 0))

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)

    def update_normal_and_depth(self, kf_table: dict, Tbc: np.ndarray,
                                scale_factor: float = 1.2, n_levels: int = 8,
                                centers: dict | None = None):
        """MapPoint::UpdateNormalAndDepth (MapPoint.cc:611-702): mean viewing
        direction over all (KF, camera) observations + scale-invariance
        distance range from the reference (first) keyframe's octaves.
        Camera centers use the KF body pose (the cm-level GP-interpolation
        offset is irrelevant for these gates). `centers` ((kf id, camera) ->
        center) lets a caller that updates many points between two pose
        changes compute each camera center once."""
        if not self.observations:
            return
        if centers is None:
            centers = {}

        def center(kf, c):
            Ow = centers.get((kf.id, c))
            if Ow is None:
                Ow = centers[kf.id, c] = (kf.Twb @ Tbc[c])[:3, 3]
            return Ow

        normal = np.zeros(3)
        n = 0
        for kf_id, slots in self.observations.items():
            kf = kf_table.get(kf_id)
            if kf is None:
                continue
            for c, gi in enumerate(slots):
                if gi < 0:
                    continue
                d = self.position - center(kf, c)
                nd = np.sqrt(d.dot(d))  # np.linalg.norm of a real vector
                if nd > 1e-9:
                    normal += d / nd
                    n += 1
        if n == 0:
            return
        self.normal = normal / n
        ref = kf_table.get(self.first_kf_id)
        if ref is None or ref.id not in self.observations:
            # fall back to any observing keyframe as reference
            ref = next(
                (kf_table[k] for k in self.observations if k in kf_table), None
            )
        if ref is None:
            return
        max_d, min_d = 0.0, np.inf
        for c, gi in enumerate(self.observations[ref.id]):
            if gi < 0:
                continue
            d = self.position - center(ref, c)
            dist = np.sqrt(d.dot(d))
            cam_, local = ref.cam_of_global(int(gi))
            lvl = int(ref.kp_octaves[cam_][local])
            max_d = max(max_d, dist * scale_factor ** lvl)
            min_d = min(
                min_d, dist * scale_factor ** lvl / scale_factor ** (n_levels - 1)
            )
        if np.isfinite(min_d):
            self.max_dist = max_d
            self.min_dist = min_d

    def compute_distinctive_descriptor(self, descriptors: list[np.ndarray]):
        """Median-Hamming-distance descriptor selection (MapPoint.cc:498)."""
        if not descriptors:
            return
        D = np.stack(descriptors)
        bits = np.unpackbits(D, axis=1)
        dist = (bits[:, None, :] != bits[None, :, :]).sum(-1)
        medians = np.median(dist, axis=1)
        self.descriptor = D[int(np.argmin(medians))]


@dataclass
class KeyFrame:
    """MultiKeyFrame: persistent multi-camera keyframe."""

    timestamp: float
    cam_times: np.ndarray        # (C,) per-camera timestamps
    Twb: np.ndarray              # (4,4) body-to-world
    velocity: np.ndarray         # (6,) world twist [rho, omega]
    keypoints: list              # per camera: (Nc,2) float
    kp_octaves: list             # per camera: (Nc,) int
    descriptors: list            # per camera: (Nc,32) uint8
    kp_ur: Optional[np.ndarray] = None   # stereo right-u for last camera
    kp_depth: Optional[np.ndarray] = None
    kp_angles: Optional[list] = None     # per camera: (Nc,) rad
    id: int = field(default_factory=_next_id)
    kf_seq: int = -1  # keyframe-only sequence number, set by Map.add_keyframe
    # global keypoint index = offset[cam] + local idx
    matches: Optional[np.ndarray] = None  # (Ntot,) MapPoint id or -1
    prev_kf: Optional["KeyFrame"] = None
    next_kf: Optional["KeyFrame"] = None
    covisibility: dict = field(default_factory=dict)  # kf_id -> weight
    parent: Optional["KeyFrame"] = None
    loop_edges: list = field(default_factory=list)
    bad: bool = False
    bow: Optional[dict] = None
    # per camera: (Nc,) measurement-variance inflation of the KB8 lift
    # (cameras.rectify_kb8_points aux), or None for pinhole cameras
    kp_sigma2_scale: Optional[list] = None

    def __post_init__(self):
        self.kp_offsets = np.cumsum([0] + [len(k) for k in self.keypoints])
        if self.matches is None:
            self.matches = -np.ones(self.kp_offsets[-1], dtype=np.int64)

    def kp_inv_sigma2(self, rig, cam: int, local: int) -> float:
        """Per-keypoint information weight: the octave inv_sigma2, divided by
        the KB8 lift's variance inflation when this keypoint was rectified
        from a fisheye detection (edge-of-FOV features carry magnified pixel
        noise and must not be trusted at raw-pixel sigma)."""
        w = rig.inv_sigma2(self.kp_octaves[cam][local])
        s = getattr(self, "kp_sigma2_scale", None)
        if s is not None and s[cam] is not None:
            w = w / float(s[cam][local])
        return w

    @property
    def n_cameras(self) -> int:
        return len(self.keypoints)

    @property
    def n_keypoints(self) -> int:
        return int(self.kp_offsets[-1])

    def cam_of_global(self, gidx: int) -> tuple[int, int]:
        # bisect_right is searchsorted(side="right") without numpy's per-call cost
        cam = bisect.bisect_right(self.kp_offsets, gidx) - 1
        return cam, int(gidx - self.kp_offsets[cam])

    def global_index(self, cam: int, local: int) -> int:
        return int(self.kp_offsets[cam] + local)

    def set_pose(self, Twb: np.ndarray):
        """SetPose re-interpolates async-camera poses lazily — camera poses
        are always derived on demand from (Twb, velocity, cam_times), so only
        the body state is stored (KeyFrame.cc:116-145 parity by construction)."""
        self.Twb = Twb

    def update_connections(self, map_points: dict, min_weight: int = 15):
        """Covisibility graph update (KeyFrame::UpdateConnections)."""
        counter: dict[int, int] = {}
        for mp_id in self.matches:
            if mp_id < 0:
                continue
            mp = map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.observations:
                if kf_id != self.id:
                    counter[kf_id] = counter.get(kf_id, 0) + 1
        if not counter:
            return
        self.covisibility = {k: w for k, w in counter.items() if w >= min_weight}
        if not self.covisibility:
            best = max(counter, key=counter.get)
            self.covisibility = {best: counter[best]}

    def best_covisible(self, n: int) -> list[int]:
        return sorted(self.covisibility, key=self.covisibility.get, reverse=True)[:n]

    def compute_scene_median_depth(self, map_points: dict, q: int = 2) -> float:
        """Median depth of this KF's landmarks in its body frame
        (MultiKeyFrame::ComputeSceneMedianDepth)."""
        Tbw = np.linalg.inv(self.Twb)
        depths = []
        for mp_id in self.matches:
            if mp_id < 0:
                continue
            mp = map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            depths.append((Tbw[:3, :3] @ mp.position + Tbw[:3, 3])[2])
        if not depths:
            return -1.0
        return float(np.sort(np.asarray(depths))[(len(depths) - 1) // q])

    def set_bad_flag(self, map_: "Map"):
        """KeyFrame::SetBadFlag: detach observations and covisibility.
        NOTE: keyframe culling stays disabled in the pipeline (it would break
        the temporal GP chain, LocalMapping.cc:160-162) — provided for API
        parity and explicit map surgery."""
        for mp_id in self.matches:
            mp = map_.map_points.get(int(mp_id)) if mp_id >= 0 else None
            if mp is not None:
                mp.observations.pop(self.id, None)
        for kf_id in list(self.covisibility):
            other = map_.keyframes.get(kf_id)
            if other is not None:
                other.covisibility.pop(self.id, None)
        self.bad = True
        map_.keyframes.pop(self.id, None)


@dataclass
class Frame:
    """MultiFrame: per-tick container (not persisted)."""

    timestamp: float
    cam_times: np.ndarray
    Twb: np.ndarray
    velocity: np.ndarray
    keypoints: list
    kp_octaves: list
    descriptors: list
    kp_ur: Optional[np.ndarray] = None
    kp_depth: Optional[np.ndarray] = None
    kp_angles: Optional[list] = None
    id: int = field(default_factory=_next_id)
    matches: Optional[np.ndarray] = None
    outlier: Optional[np.ndarray] = None
    ref_kf: Optional[KeyFrame] = None
    kp_sigma2_scale: Optional[list] = None  # see KeyFrame.kp_sigma2_scale

    def __post_init__(self):
        self.kp_offsets = np.cumsum([0] + [len(k) for k in self.keypoints])
        n = int(self.kp_offsets[-1])
        if self.matches is None:
            self.matches = -np.ones(n, dtype=np.int64)
        if self.outlier is None:
            self.outlier = np.zeros(n, dtype=bool)

    n_cameras = KeyFrame.n_cameras
    n_keypoints = KeyFrame.n_keypoints
    cam_of_global = KeyFrame.cam_of_global
    global_index = KeyFrame.global_index
    kp_inv_sigma2 = KeyFrame.kp_inv_sigma2


class Map:
    """KF/MP registry with change index (Map.cc) and the big map lock
    (`mMutexMapUpdate`): in `System(threaded=True)` the background
    mapper/loop-closer serializes its mutations against tracking's reads
    through this reentrant lock (see pipeline/system.py). The sequential
    default never contends on it."""

    def __init__(self, map_id: int = 0):
        import threading

        self.id = map_id
        self.keyframes: dict[int, KeyFrame] = {}
        self.map_points: dict[int, MapPoint] = {}
        self.change_index = 0
        self.origin_kf: Optional[KeyFrame] = None
        self._kf_seq = 0
        self.mutex = threading.RLock()

    def __getstate__(self):
        # locks are not picklable (atlas checkpointing); recreate on load
        state = self.__dict__.copy()
        state.pop("mutex", None)
        return state

    def __setstate__(self, state):
        import threading

        self.__dict__.update(state)
        self.mutex = threading.RLock()

    def add_keyframe(self, kf: KeyFrame):
        # keyframe-only sequence number: ids come from a counter shared with
        # Frames/MapPoints, so id differences are useless as "how many
        # keyframes ago" — culling probation (MapPoint.cc) needs this
        kf.kf_seq = self._kf_seq
        self._kf_seq += 1
        self.keyframes[kf.id] = kf
        if self.origin_kf is None:
            self.origin_kf = kf

    def add_map_point(self, mp: MapPoint):
        self.map_points[mp.id] = mp

    def erase_map_point(self, mp: MapPoint):
        mp.bad = True
        self.map_points.pop(mp.id, None)

    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def n_map_points(self) -> int:
        return len(self.map_points)

    def max_kf_id(self) -> int:
        return max(self.keyframes) if self.keyframes else -1

    def increase_change_index(self):
        self.change_index += 1


class Atlas:
    """Multi-map container (Atlas.cc). A new map is created on timestamp
    regression (CreateMapInAtlas semantics live in Tracking)."""

    def __init__(self):
        self.maps: list[Map] = [Map(0)]
        self.active: Map = self.maps[0]
        self.cameras: list = []

    def create_new_map(self):
        m = Map(len(self.maps))
        self.maps.append(m)
        self.active = m
        return m

    def add_camera(self, cam):
        for c in self.cameras:
            if c is cam:
                return c
        self.cameras.append(cam)
        return cam
