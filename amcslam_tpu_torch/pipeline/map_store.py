"""Host-side map / state store (rebuild of SURVEY.md §2.8).

A copy of `amcslam_tpu/pipeline/map_store.py`, with two host shortcuts that
give the same numbers (`cam_of_global` bisects, `n_obs` counts in one
array) and one that gives them to rounding (`update_normals_and_depths`
refreshes many points' viewing geometry in one array computation).
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

from ..utils.timing import GLOBAL_TIMER

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
        """MapPoint::UpdateNormalAndDepth (MapPoint.cc:611-702) for this
        point alone: a one-point call of `update_normals_and_depths` (which
        leaves a bad point as it is)."""
        update_normals_and_depths((self,), kf_table, Tbc, scale_factor, n_levels, centers)

    def compute_distinctive_descriptor(self, descriptors: list[np.ndarray]):
        """Median-Hamming-distance descriptor selection (MapPoint.cc:498)."""
        if not descriptors:
            return
        D = np.stack(descriptors)
        bits = np.unpackbits(D, axis=1)
        dist = (bits[:, None, :] != bits[None, :, :]).sum(-1)
        medians = np.median(dist, axis=1)
        self.descriptor = D[int(np.argmin(medians))]


def update_normals_and_depths(points, kf_table: dict, Tbc: np.ndarray,
                              scale_factor: float = 1.2, n_levels: int = 8,
                              centers: dict | None = None):
    """MapPoint::UpdateNormalAndDepth (MapPoint.cc:611-702) for many points in
    one array computation: each point's mean viewing direction over all its
    (KF, camera) observations, and its scale-invariance distance range from
    the reference (first) keyframe's octaves. Camera centers use the KF body
    pose (the cm-level GP-interpolation offset is irrelevant for these
    gates); each (KF, camera) center is computed once, and `centers` ((kf
    id, camera) -> center) carries them between calls with no pose change
    in between.

    The rules of the reference's per-point method: a bad point or one with
    no observations is skipped, and so are keyframes missing from
    `kf_table`; directions of norm <= 1e-9 are dropped and a point left with
    none is unchanged; the reference keyframe is `first_kf_id` if it
    observes the point, else the first observing keyframe in the table; a
    range that is not finite is left unchanged. Each point's directions are
    summed in the per-point order (keyframes as its dict holds them, then
    cameras), so the normal is the per-point one's to rounding."""
    with GLOBAL_TIMER.span("map.refresh_geometry"):
        pts = [mp for mp in points if not mp.bad and mp.observations]
        if not pts:
            return
        if centers is None:
            centers = {}
        # slot rows: point -> its keyframe rows (dict order) -> cameras
        kf_ids, rows, n_rows = [], [], []
        for mp in pts:
            kf_ids.extend(mp.observations)
            rows.extend(mp.observations.values())
            n_rows.append(len(mp.observations))
        row_kf = np.asarray(kf_ids, dtype=np.int64)
        row_pt = np.repeat(np.arange(len(pts)), n_rows)
        slots = np.array(rows)  # (rows, cameras): a map's keyframes share the rig
        uniq, row_k = np.unique(row_kf, return_inverse=True)
        kfs = [kf_table.get(int(k)) for k in uniq]
        row_found = np.array([kf is not None for kf in kfs])[row_k]
        # each observation (in row-major order): its row, camera, keypoint,
        # keyframe and point
        v_row, v_cam = np.nonzero((slots >= 0) & row_found[:, None])
        if not len(v_row):
            return
        v_gi, v_k, v_pt = slots[v_row, v_cam], row_k[v_row], row_pt[v_row]
        n_cam = slots.shape[1]
        v_pair = v_k * n_cam + v_cam
        used = np.zeros(len(kfs) * n_cam, dtype=bool)
        used[v_pair] = True
        cen = np.zeros((3, len(used)))
        for q in np.flatnonzero(used).tolist():
            kf, c = kfs[q // n_cam], q % n_cam
            Ow = centers.get((kf.id, c))
            if Ow is None:
                Ow = centers[kf.id, c] = (kf.Twb @ Tbc[c])[:3, 3]
            cen[:, q] = Ow
        # coordinates as rows: a gather of one coordinate is a 1-D take
        X = np.stack([mp.position for mp in pts], 1)
        d = np.stack([X[j][v_pt] - cen[j][v_pair] for j in range(3)])
        nd = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        keep = np.flatnonzero(nd > 1e-9)
        u_pt = v_pt[keep]
        n = np.bincount(u_pt, minlength=len(pts))
        normal = np.stack([np.bincount(u_pt, d[j][keep] / nd[keep], len(pts))
                           for j in range(3)], 1)
        # reference keyframe row: first_kf_id's, else the first one found
        no_row = len(rows)
        row_idx = np.arange(len(rows))
        first = np.array([mp.first_kf_id for mp in pts], dtype=np.int64)
        pt_start = np.cumsum(n_rows) - n_rows
        is_first = row_found & (row_kf == first[row_pt])
        ref1 = np.minimum.reduceat(np.where(is_first, row_idx, no_row), pt_start)
        ref2 = np.minimum.reduceat(np.where(row_found, row_idx, no_row), pt_start)
        ref_row = np.where(ref1 < no_row, ref1, ref2)
        on_ref = np.flatnonzero(v_row == ref_row[v_pt])
        # octave of each reference observation, one keyframe at a time
        ref_k, ref_gi = v_k[on_ref], v_gi[on_ref]
        lvl = np.empty(len(on_ref), dtype=np.int64)
        by_k = np.argsort(ref_k, kind="stable")
        # one group per keyframe (none when there is no reference observation)
        for grp in np.split(by_k, np.flatnonzero(np.diff(ref_k[by_k])) + 1)[:len(by_k)]:
            kf = kfs[ref_k[grp[0]]]
            gi = ref_gi[grp]
            cam = np.searchsorted(kf.kp_offsets, gi, side="right") - 1
            octs = [np.asarray(o).reshape(-1) for o in kf.kp_octaves]
            oct_off = np.cumsum([0] + [len(o) for o in octs])
            lvl[grp] = np.concatenate(octs)[oct_off[cam] + gi - kf.kp_offsets[cam]]
        scaled = nd[on_ref] * scale_factor ** lvl
        max_d = np.zeros(len(pts))
        min_d = np.full(len(pts), np.inf)
        np.maximum.at(max_d, v_pt[on_ref], scaled)
        np.minimum.at(min_d, v_pt[on_ref], scaled / scale_factor ** (n_levels - 1))
        seen = np.flatnonzero(n)
        normal = normal[seen] / n[seen, None]
        ranged = np.isfinite(min_d[seen]).tolist()
        for j, i in enumerate(seen.tolist()):
            mp = pts[i]
            mp.normal = normal[j]
            if ranged[j]:
                mp.max_dist = float(max_d[i])
                mp.min_dist = float(min_d[i])


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
