"""Tracking: the per-frame front-to-back loop (rebuild of src/Tracking.cc).

State machine {NO_IMAGES_YET, NOT_INITIALIZED, OK, RECENTLY_LOST, LOST}
(Tracking.h:128-136) with the MULTICAMERA flow of Tracking::Track
(Tracking.cc:1066-1427):

  stereo initialization -> TrackWithMotionModel (const-twist prediction, GP
  per-camera pose interpolation, projection search, per-frame GP pose solve)
  -> TrackLocalMap (local-map projection search + MC-RANSAC + pose solve)
  -> motion-model update -> NeedNewKeyFrame / CreateNewKeyFrame with the
  temporal prev/next chain and stereo-depth landmark seeding.

Port of `amcslam_tpu/pipeline/tracking.py`. Host code orchestrates on
numpy; the numeric stages run on the tracker's device in its dtype:
MC-RANSAC (ransac.vel_ransac), the 4-round pose solve (solver.pose_solver,
whose GP chain is the CUDA kernel on the card) and the relocalization PnP
(ransac.mlpnp). The reference's `jax.jit(pose_gp_optimize)` is a plain
call. Each solve's write-back is one device-to-host read, as the reference
batches its `device_get`s. RANSAC and PnP samples come from the same
`np.random.RandomState(0)` in the same order as the reference's, so both
packages draw the same hypotheses.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import convert
from ..ops import host_geom
from ..ransac.mlpnp import PnPRansacData, pnp_ransac
from ..ransac.vel_ransac import mc_ransac
from ..solver.pose_solver import pose_gp_optimize
from ..utils.timing import GLOBAL_TIMER
from . import matcher
from .extraction import _hw_bucket, extract_pose_problem
from .map_store import Atlas, Frame, GPObs, KeyFrame, Map, MapPoint
from .rig import Rig


def resolve_device(device) -> torch.device:
    """The explicit device of a pipeline object. A CUDA device that is not
    present raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is present")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) present")
    elif dev.type != "cpu":
        raise ValueError(f"the pipeline runs on cpu or cuda, not {dev}")
    return dev


def _fetch(*tensors) -> list[np.ndarray]:
    """Host float64 copies (bool masks as 0/1) in one device-to-host read."""
    return convert.fetch(*tensors, dtype=torch.float64)


class TrackState(Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclass
class TrajectoryEntry:
    """Relative-frame-pose trajectory record (Tracking.cc:1408-1427):
    each frame stores its pose RELATIVE to its reference keyframe, so loop
    closures / GBA that move keyframes retroactively correct the whole frame
    trajectory when SaveTrajectoryTUM recomposes (System.cc:393-460)."""

    timestamp: float
    ref_kf: "KeyFrame"
    Trb: np.ndarray   # ref-KF-body -> frame-body at track time
    lost: bool

    @property
    def Twb(self) -> np.ndarray:
        """Recompose against the ref KF's CURRENT (possibly corrected) pose."""
        return self.ref_kf.Twb @ self.Trb


# Host glue runs single 4x4 ops hundreds of times per frame; the pure-NumPy
# closed forms in ops/host_geom avoid a device launch per op.
_np_exp_se3 = host_geom.exp_se3
_np_log_se3 = host_geom.log_se3


def interp_camera_pose(T_prev, v_prev, t_prev, T_cur, v_cur, t_cur, t_cam):
    """GP-interpolated body pose at an async camera's timestamp
    (MultiFrame::UpdatePoseMatrices, Frame.cc:391-417)."""
    return host_geom.gp_interp_pose(
        T_prev, v_prev, float(t_prev), T_cur, v_cur, float(t_cur), float(t_cam)
    )


@dataclass
class TrackingConfig:
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10
    kf_translation_th: float = 2.0   # c3: |t| > 2 m (Tracking.cc:2085-2198)
    kf_rotation_th: float = 0.08     # or |omega| > 0.08
    min_track_matches: int = 10
    min_local_matches: int = 30
    ransac_max_it: int = 23
    ransac_min_match: int = 30
    ransac_threshold: float = 3.0
    max_stereo_seed: int = 100       # stereo-depth landmark seeding cap
    search_radius: float = 7.0
    th_depth: float = 35.0           # "close" stereo point threshold (mThDepth)
    # localization-only mode (System::ActivateLocalizationMode): track but
    # never create keyframes or modify the map
    localization_only: bool = False
    # Record non-keyframe GP observations on tracked map points for use by
    # BundleAdjustment/LocalGPBA (the reference keeps this plumbing inert —
    # producer commented out at Tracking.cc:1376-1384; off by default).
    produce_gp_obs: bool = False


class Tracking:
    def __init__(self, rig: Rig, atlas: Atlas, config: TrackingConfig | None = None,
                 local_mapper=None, kfdb=None, *, device, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.rig = rig
        self.atlas = atlas
        self.kfdb = kfdb
        self.cfg = config or TrackingConfig()
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame: Frame | None = None
        self.last_kf: KeyFrame | None = None
        self.velocity_model = np.zeros(6)  # relative twist between frames
        self.frames_since_kf = 0
        self.frames_since_reloc = 10**9
        self.n_inliers = 0
        self.local_mapper = local_mapper
        self.trajectory: list[TrajectoryEntry] = []
        self._rng = np.random.RandomState(0)

    # ------------------------------------------------------------------
    def grab_frame(self, frame: Frame) -> TrackState:
        """Tracking::GrabImageMultiCam + Track (Tracking.cc:1018-1427)."""
        m = self.atlas.active

        # timestamp regression -> new map in the atlas (Tracking.cc:1081-1088)
        if (
            self.last_frame is not None
            and frame.timestamp < self.last_frame.timestamp
            and self.state not in (TrackState.NO_IMAGES_YET,)
        ):
            self.atlas.create_new_map()
            self.state = TrackState.NOT_INITIALIZED
            self.last_kf = None
            if self.local_mapper is not None:
                self.local_mapper.map = self.atlas.active
                self.local_mapper.queue.clear()
                self.local_mapper.recent_points.clear()

        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            ok = self._stereo_initialization(frame)
            self.state = TrackState.OK if ok else TrackState.NOT_INITIALIZED
            self.last_frame = frame
            self._record(frame)
            return self.state

        # --- relocalization when recently lost (reference: MLPnP RANSAC,
        # stubbed upstream Tracking.cc:1431-1450/2577-2628 — functional here)
        self.frames_since_reloc += 1
        relocalized = False
        if self.state == TrackState.RECENTLY_LOST:
            if self._relocalize(frame):
                self.state = TrackState.OK
                self.frames_since_reloc = 0
                relocalized = True
            else:
                self.last_frame = frame
                self._record(frame)
                return self.state

        # --- TrackWithMotionModel (Tracking.cc:1822-1890), falling back to
        # TrackReferenceKeyFrame (Tracking.cc:1893) when it yields too few
        # matches — e.g. after an abrupt motion the constant-twist
        # prediction misses, but descriptor matching against the reference
        # keyframe still anchors the frame.
        # After a relocalization the PnP pose + its inlier associations ARE
        # the frame state (Tracking.cc:1989-2001: bOK comes straight from
        # Relocalization and flow continues at TrackLocalMap) — running the
        # constant-twist prediction here would overwrite the recovered pose
        # with one extrapolated from the stale LOST frame.
        if not relocalized:
            self._predict(frame)
            with GLOBAL_TIMER.span("track.motion_model"):
                n = self._track_motion_model(frame)
            if n < self.cfg.min_track_matches:
                with GLOBAL_TIMER.span("track.ref_kf"):
                    n = self._track_reference_keyframe(frame)
            if n < self.cfg.min_track_matches:
                self.state = (
                    TrackState.RECENTLY_LOST if m.n_keyframes() > 10
                    else TrackState.LOST
                )
                self.last_frame = frame
                self._record(frame)
                return self.state

        # --- TrackLocalMap (Tracking.cc:2004-2082)
        with GLOBAL_TIMER.span("track.local_map"):
            n_local = self._track_local_map(frame)
        self.n_inliers = n_local
        self.state = TrackState.OK if n_local >= self.cfg.min_local_matches else (
            TrackState.RECENTLY_LOST if m.n_keyframes() > 10 else TrackState.LOST
        )

        # motion model update: relative twist between consecutive frames —
        # except against a pre-relocalization frame, whose pose is the stale
        # lost-track extrapolation. There the 12-dof pose solve's own solved
        # velocity seeds the model instead: the GP state is (T, v) with
        # T(t+d) ~ T exp(d v), the same body-twist convention _predict uses.
        # (The reference leaves mVelocity unset and falls back to
        # TrackReferenceKeyFrame on the next frame, Tracking.cc:1787-1792;
        # a zero model here made the next frame's projection search miss by
        # the full inter-frame motion and tracking oscillated
        # OK -> RECENTLY_LOST -> reloc forever.)
        if relocalized:
            self.velocity_model = np.asarray(frame.velocity, float).copy()
        else:
            dt = frame.timestamp - self.last_frame.timestamp
            rel = _np_log_se3(np.linalg.inv(self.last_frame.Twb) @ frame.Twb)
            self.velocity_model = rel / max(dt, 1e-6)

        if (
            self.state == TrackState.OK
            and not self.cfg.localization_only
            and self._need_new_keyframe(frame)
        ):
            with GLOBAL_TIMER.span("track.create_kf"):
                self._create_keyframe(frame)
        else:
            self.frames_since_kf += 1
            if self.cfg.produce_gp_obs and self.state == TrackState.OK:
                self._add_gp_observations(frame)

        self.last_frame = frame
        self._record(frame)
        return self.state

    # ------------------------------------------------------------------
    def _record(self, frame: Frame):
        """Trajectory bookkeeping (Tracking.cc:1408-1427): store the pose
        relative to the reference keyframe; on tracking failure duplicate
        the previous record with the lost flag (System.cc:400 skips them)."""
        ref = frame.ref_kf if frame.ref_kf is not None else self.last_kf
        lost = self.state in (TrackState.RECENTLY_LOST, TrackState.LOST)
        if ref is None or (lost and not np.isfinite(frame.Twb).all()):
            if self.trajectory:
                prev = self.trajectory[-1]
                self.trajectory.append(
                    TrajectoryEntry(frame.timestamp, prev.ref_kf, prev.Trb, True)
                )
            return
        Trb = np.linalg.inv(ref.Twb) @ frame.Twb
        self.trajectory.append(TrajectoryEntry(frame.timestamp, ref, Trb, lost))

    def trajectory_poses(self, include_lost: bool = False):
        """Recomposed (timestamp, Twb) pairs against the corrected keyframe
        poses — the SaveTrajectoryTUM composition (System.cc:393-460)."""
        return [
            (e.timestamp, e.Twb)
            for e in self.trajectory
            if include_lost or not e.lost
        ]

    def _predict(self, frame: Frame):
        """Constant-twist prediction (Tracking.cc:1833-1837)."""
        dt = frame.timestamp - self.last_frame.timestamp
        frame.Twb = self.last_frame.Twb @ _np_exp_se3(self.velocity_model * dt)
        frame.velocity = self.velocity_model.copy()

    def _camera_Tcw(self, frame: Frame, cam: int) -> np.ndarray:
        """World-to-camera at this camera's timestamp."""
        if cam == self.rig.n_cams - 1 or self.last_frame is None:
            Twc = frame.Twb @ self.rig.Tbc[cam]
        else:
            Twb_t = interp_camera_pose(
                self.last_frame.Twb, self.last_frame.velocity,
                self.last_frame.timestamp, frame.Twb, frame.velocity,
                frame.timestamp, frame.cam_times[cam],
            )
            Twc = Twb_t @ self.rig.Tbc[cam]
        R = Twc[:3, :3].T
        Tcw = np.eye(4)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = -R @ Twc[:3, 3]
        return Tcw

    def _match_map_points(self, frame: Frame, mp_ids, radius):
        """Project a set of map points into every camera and associate."""
        m = self.atlas.active
        mps = [m.map_points[i] for i in mp_ids if i in m.map_points and not m.map_points[i].bad]
        if not mps:
            return 0
        pos = np.stack([mp.position for mp in mps])
        desc = np.stack([
            mp.descriptor if mp.descriptor is not None else np.zeros(32, np.uint8)
            for mp in mps
        ])
        n_matched = 0
        for cam in range(self.rig.n_cams):
            if len(frame.keypoints[cam]) == 0:
                continue
            Tcw = self._camera_Tcw(frame, cam)
            idx = matcher.search_by_projection(
                pos, desc, frame.keypoints[cam], frame.descriptors[cam],
                frame.kp_octaves[cam], Tcw, self.rig.K[cam],
                radius=radius, scale_factors=self.rig.scale_factor ** np.arange(self.rig.n_levels),
                device=self.device,
            )
            for mi, ki in enumerate(idx):
                if ki < 0:
                    continue
                g = frame.global_index(cam, int(ki))
                if frame.matches[g] < 0:
                    frame.matches[g] = mps[mi].id
                    n_matched += 1
        return n_matched

    def _track_motion_model(self, frame: Frame) -> int:
        m = self.atlas.active
        last_ids = set(int(i) for i in self.last_frame.matches if i >= 0)
        n_m = self._match_map_points(frame, last_ids, self.cfg.search_radius)
        if n_m < 20:
            # wider-window retry (Tracking.cc:1848-1855): clear the partial
            # associations and search again at 2x the radius
            frame.matches[:] = -1
            frame.outlier[:] = False
            n_m = self._match_map_points(
                frame, last_ids, 2 * self.cfg.search_radius
            )
        if n_m < 20:
            return 0
        n = self._pose_solve(frame)
        # Acceptance needs direct support on the CURRENT vertex: async-camera
        # GP edges sample only C-1 distinct interpolation times, so with the
        # previous vertex free (fix=false) they can be satisfied by bending
        # v1/velocities while the current pose stays wrong — only the
        # synchronized stereo camera's unary edges pin v2. The reference's
        # nmatchesMap>=10 check (Tracking.cc:1889) implicitly relies on its
        # synchronized camera; we make that requirement explicit per camera.
        if self._stereo_inlier_count(frame) < 10:
            return 0
        return n

    def _stereo_inlier_count(self, frame: Frame) -> int:
        cam = self.rig.n_cams - 1
        lo = int(frame.kp_offsets[cam])
        hi = lo + len(frame.keypoints[cam])
        sl = slice(lo, hi)
        return int(((frame.matches[sl] >= 0) & ~frame.outlier[sl]).sum())

    def _track_reference_keyframe(self, frame: Frame) -> int:
        """TrackReferenceKeyFrame (Tracking.cc:1893-1937): pure descriptor
        matching against the reference keyframe's map points (SearchByBoW
        equivalent, ratio 0.7 + rotation consistency), pose seeded from the
        last frame, then the standard GP pose solve. Motion-model fallback —
        no relocalization machinery involved."""
        if self.last_kf is None:
            return 0
        m = self.atlas.active
        # reset any partial associations from the failed motion-model pass
        frame.matches[:] = -1
        frame.outlier[:] = False
        frame.Twb = self.last_frame.Twb.copy()
        frame.velocity = self.last_frame.velocity.copy()
        kf = self.last_kf
        n = 0
        for cam in range(self.rig.n_cams):
            if len(frame.keypoints[cam]) == 0 or len(kf.keypoints[cam]) == 0:
                continue
            mps, descs, angs_ref = [], [], []
            for local in range(len(kf.keypoints[cam])):
                g = kf.global_index(cam, local)
                mp_id = kf.matches[g]
                if mp_id < 0:
                    continue
                mp = m.map_points.get(int(mp_id))
                if mp is None or mp.bad or mp.descriptor is None:
                    continue
                mps.append(mp)
                descs.append(mp.descriptor)
                angs_ref.append(
                    float(kf.kp_angles[cam][local])
                    if kf.kp_angles is not None else np.nan
                )
            if not mps:
                continue
            ang1 = np.asarray(angs_ref)
            ang2 = (
                np.asarray(frame.kp_angles[cam])
                if frame.kp_angles is not None else None
            )
            have_ang = ang2 is not None and np.isfinite(ang1).all()
            idx = matcher.match_descriptors(
                np.stack(descs), frame.descriptors[cam],
                max_dist=matcher.TH_LOW, ratio=0.7,
                ang1=ang1 if have_ang else None,
                ang2=ang2 if have_ang else None,
                device=self.device,
            )
            for mi, ki in enumerate(idx):
                if ki < 0:
                    continue
                g = frame.global_index(cam, int(ki))
                if frame.matches[g] < 0:
                    frame.matches[g] = mps[mi].id
                    n += 1
        if n < 15:
            return 0
        return self._pose_solve(frame)

    def _update_local_keyframes(self, frame: Frame) -> list[int]:
        """Tracking::UpdateLocalKeyFrames (Tracking.cc:2395-2553): K1 = every
        keyframe observing a current match; expand with 10-best covisible
        neighbors + spanning-tree parents (capped at 80 KFs) and the last 20
        temporal keyframes; the max-vote KF becomes the reference keyframe."""
        m = self.atlas.active
        kf_votes: dict[int, int] = {}
        for mp_id in frame.matches:
            if mp_id < 0:
                continue
            mp = m.map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.observations:
                kf_votes[kf_id] = kf_votes.get(kf_id, 0) + 1
        local: list[int] = []
        seen: set[int] = set()
        kf_max, vote_max = None, 0
        for kf_id, votes in kf_votes.items():
            kf = m.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            local.append(kf_id)
            seen.add(kf_id)
            if votes > vote_max:
                vote_max, kf_max = votes, kf
        # K2 expansion: covisible neighbors + parent of each K1 keyframe
        # (first unseen one each, as the reference's `break`s do)
        for kf_id in list(local):
            if len(local) > 80:
                break
            kf = m.keyframes.get(kf_id)
            if kf is None:
                continue
            for nb_id in kf.best_covisible(10):
                if nb_id not in seen and nb_id in m.keyframes:
                    local.append(nb_id)
                    seen.add(nb_id)
                    break
            if kf.parent is not None and kf.parent.id not in seen:
                local.append(kf.parent.id)
                seen.add(kf.parent.id)
        # last 20 temporal keyframes (Tracking.cc:2532-2547)
        tkf = self.last_kf
        for _ in range(20):
            if tkf is None or len(local) >= 80:
                break
            if tkf.id not in seen:
                local.append(tkf.id)
                seen.add(tkf.id)
            tkf = tkf.prev_kf
        if kf_max is not None:
            frame.ref_kf = kf_max  # mpReferenceKF = pKFmax
        return local

    def _search_local_points(
        self, frame: Frame, local_points: set[int],
        seen_cam: dict[int, set[int]] | None = None,
    ) -> int:
        """Tracking::SearchLocalPoints (Tracking.cc:2294-2352): project every
        local map point into every camera with the full frustum gates
        (viewing cone, distance range, predicted octave) and match with the
        viewing-angle-dependent radius (th=1).

        ``seen_cam`` maps mp_id -> cameras where the point is already matched
        this frame (the reference's ``mvnLastFrameSeen[c] == mnId`` skip,
        Tracking.cc:2298-2330): those (point, camera) pairs are excluded from
        both the frustum/IncreaseVisible pass and matching, but the point can
        still be counted visible and matched in the *other* cameras."""
        m = self.atlas.active
        seen_cam = seen_cam or {}
        mps = [
            m.map_points[i]
            for i in local_points
            if i in m.map_points and not m.map_points[i].bad
        ]
        if not mps:
            return 0
        pos = np.stack([mp.position for mp in mps])
        desc = np.stack([
            mp.descriptor if mp.descriptor is not None else np.zeros(32, np.uint8)
            for mp in mps
        ])
        normals = np.stack([mp.normal for mp in mps])
        min_d = np.array([mp.min_dist for mp in mps])
        max_d = np.array([mp.max_dist for mp in mps])
        n_matched = 0
        stereo_cam = self.rig.n_cams - 1
        for cam in range(self.rig.n_cams):
            if len(frame.keypoints[cam]) == 0:
                continue
            sub = [
                mi for mi, mp in enumerate(mps)
                if cam not in seen_cam.get(mp.id, ())
            ]
            if not sub:
                continue
            s = np.asarray(sub)
            Tcw = self._camera_Tcw(frame, cam)
            idx, in_frustum = matcher.search_by_projection_frustum(
                pos[s], desc[s], normals[s], min_d[s], max_d[s],
                frame.keypoints[cam], frame.descriptors[cam],
                frame.kp_octaves[cam], Tcw, self.rig.K[cam],
                scale_factor=self.rig.scale_factor,
                n_levels=self.rig.n_levels,
                kp_ur=frame.kp_ur if cam == stereo_cam else None,
                bf=self.rig.bf if cam == stereo_cam else 0.0,
                device=self.device,
            )
            for si, vis in enumerate(in_frustum):
                if vis:
                    mps[sub[si]].n_visible += 1  # IncreaseVisible
            for si, ki in enumerate(idx):
                if ki < 0:
                    continue
                g = frame.global_index(cam, int(ki))
                if frame.matches[g] < 0:
                    frame.matches[g] = mps[sub[si]].id
                    n_matched += 1
        return n_matched

    def _track_local_map(self, frame: Frame) -> int:
        """Tracking::TrackLocalMap (Tracking.cc:2004-2082)."""
        from ..utils.timing import GLOBAL_TIMER as T

        m = self.atlas.active
        with T.span("tlm.update_kfs"):
            local_kfs = self._update_local_keyframes(frame)
            local_points: set[int] = set()
            for kf_id in local_kfs:
                kf = m.keyframes.get(kf_id)
                if kf is None:
                    continue
                local_points.update(int(i) for i in kf.matches if i >= 0)
            # mvnLastFrameSeen[cam] (Tracking.cc:2298-2315): record which
            # camera each already-matched point was seen in — it is skipped
            # there but stays eligible for visibility/matching elsewhere
            seen_cam: dict[int, set[int]] = {}
            for g, mp_id in enumerate(frame.matches):
                if mp_id >= 0:
                    cam, _ = frame.cam_of_global(g)
                    seen_cam.setdefault(int(mp_id), set()).add(cam)
        with T.span("tlm.search_points"):
            self._search_local_points(frame, local_points, seen_cam)

        # MC-RANSAC over async-camera matches (Tracking.cc:2029, 1939-2002)
        with T.span("tlm.mc_ransac"):
            self._mc_ransac(frame)
        with T.span("tlm.pose_solve"):
            n = self._pose_solve(frame)
        # bookkeeping: found counters (IncreaseFound, Tracking.cc:2047-2066)
        for g, mp_id in enumerate(frame.matches):
            if mp_id >= 0 and not frame.outlier[g]:
                mp = m.map_points.get(int(mp_id))
                if mp is not None:
                    mp.n_found += 1
        return n

    def _mc_ransac(self, frame: Frame):
        m = self.atlas.active
        idxs, rows = [], []
        for g, mp_id in enumerate(frame.matches):
            if mp_id < 0:
                continue
            mp = m.map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            cam, local = frame.cam_of_global(g)
            uv = frame.keypoints[cam][local]
            w = frame.kp_inv_sigma2(self.rig, cam, local)
            dtc = frame.cam_times[cam] - self.last_frame.timestamp
            rows.append((*mp.position, dtc, cam, uv[0], uv[1], w))
            idxs.append(g)
        if len(rows) < self.cfg.ransac_min_match:
            return
        A = np.array(rows)
        n = len(rows)
        # pow2-bucket the row count, as the reference does (fixed shapes)
        nb = 16
        while nb < n:
            nb *= 2
        if nb > n:
            # pad with safe geometry (point 5 m ahead of the body, observed
            # at the stereo principal point, dt=0) so padded residuals stay
            # finite before the valid mask — a zero row would put the point
            # at camera z<=0 and produce inf/NaN (same convention as
            # loop_closing._solve_sim3)
            cam_s = self.rig.n_cams - 1
            Ks = self.rig.K[cam_s]
            Twc = self.last_frame.Twb @ self.rig.Tbc[cam_s]
            ahead = Twc[:3, :3] @ np.array([0.0, 0.0, 5.0]) + Twc[:3, 3]
            pad_row = np.array(
                [*ahead, 0.0, cam_s, Ks[2], Ks[3], 1.0]
            )
            A = np.concatenate([A, np.tile(pad_row, (nb - n, 1))])
        # the reference hard-codes float32 here; the port takes its dtype
        data = convert.vel_ransac_from_numpy(
            dict(T_last=self.last_frame.Twb, v0=frame.velocity, dt=A[:, 3],
                 Xw=A[:, :3], obs=A[:, 5:7], cam=A[:, 4].astype(np.int64),
                 w=A[:, 7], valid=np.arange(nb) < n, Tbc=self.rig.Tbc,
                 K=self.rig.K),
            device=self.device, dtype=self.dtype)
        samples = np.stack([
            self._rng.choice(n, 3, replace=False)
            for _ in range(self.cfg.ransac_max_it)
        ])
        ok, v_best, inl, n_in = mc_ransac(
            data, torch.as_tensor(samples, device=self.device),
            threshold=self.cfg.ransac_threshold,
            min_match=self.cfg.ransac_min_match,
        )
        ok, inl = _fetch(ok, inl)  # one device-to-host read
        if bool(ok):
            for j, g in enumerate(idxs):
                if not inl[j]:
                    frame.outlier[g] = True

    def _pose_solve(self, frame: Frame) -> int:
        """Per-frame GP pose optimization + outlier write-back."""
        m = self.atlas.active
        # the reference frees the previous frame's vertex in every per-frame
        # pose solve (fix=false at Tracking.cc:1863/1912/2036) and discards
        # its refinement — only the current frame is written back
        data, state, handles = extract_pose_problem(
            frame, self.last_frame, m.map_points, self.rig, fix_prev=False,
            device=self.device, dtype=self.dtype,
        )
        out_m = np.zeros(handles["Nm"], bool)
        out_s = np.zeros(handles["Ns"], bool)
        out_m[: handles["n_mg"]] = frame.outlier[handles["mg_idx"]] if handles["n_mg"] else False
        out_s[: handles["n_st"]] = frame.outlier[handles["st_idx"]] if handles["n_st"] else False
        state, lvl_m, lvl_s, (stats, n_inl) = pose_gp_optimize(
            data, state, torch.as_tensor(out_m, device=self.device),
            torch.as_tensor(out_s, device=self.device),
        )
        # the write-back is one device-to-host read
        T1, v1, lvl_m, lvl_s = _fetch(state.T[1], state.v[1], lvl_m, lvl_s)
        lvl_m, lvl_s = lvl_m.astype(bool), lvl_s.astype(bool)
        frame.Twb = T1
        frame.velocity = v1
        if handles["n_mg"]:
            frame.outlier[handles["mg_idx"]] = ~lvl_m[: handles["n_mg"]]
        if handles["n_st"]:
            frame.outlier[handles["st_idx"]] = ~lvl_s[: handles["n_st"]]
        n = int(lvl_m[: handles["n_mg"]].sum() + lvl_s[: handles["n_st"]].sum())
        return n

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Full Tracking::NeedNewKeyFrame conditions (Tracking.cc:2085-2198):
        c1a (max frames), c1b (min frames + idle mapper), c1c (weak tracking
        or many untracked close points), gated by c2 (few tracked points vs
        the reference KF), plus c3 (motion), c4 (marginal inlier count), and
        the c5 low-speed veto."""
        m = self.atlas.active
        if self.cfg.localization_only:
            return False
        n_kfs = m.n_keyframes()
        # not right after a relocalization (Tracking.cc:2103-2106)
        if (self.frames_since_reloc < self.cfg.max_frames_between_kf
                and n_kfs > self.cfg.max_frames_between_kf):
            return False
        if self.last_kf is None:
            return True

        # tracked map points in the reference KF with enough observations
        min_obs = 3 if n_kfs > 2 else 2
        n_ref = 0
        for mp_id in self.last_kf.matches:
            if mp_id < 0:
                continue
            mp = m.map_points.get(int(mp_id))
            if mp is not None and not mp.bad and mp.n_obs() >= min_obs:
                n_ref += 1
        idle = self.local_mapper is None or not self.local_mapper.queue

        # close-point bookkeeping on the stereo camera (Tracking.cc:2117-2136)
        n_tracked_close = n_nontracked_close = 0
        if frame.kp_depth is not None:
            cam = self.rig.n_cams - 1
            for local, d in enumerate(frame.kp_depth):
                if 0 < d < self.cfg.th_depth:
                    g = frame.global_index(cam, local)
                    if frame.matches[g] >= 0 and not frame.outlier[g]:
                        n_tracked_close += 1
                    else:
                        n_nontracked_close += 1
        need_close = n_tracked_close < 100 and n_nontracked_close > 70

        ni = self.n_inliers
        c1a = self.frames_since_kf >= self.cfg.max_frames_between_kf
        c1b = (self.frames_since_kf >= self.cfg.min_frames_between_kf) and idle
        c1c = ni < n_ref * 0.25 or need_close
        c2 = (ni < n_ref * 0.75 or need_close) and ni > 15
        rel = _np_log_se3(np.linalg.inv(self.last_kf.Twb) @ frame.Twb)
        c3 = (
            np.linalg.norm(rel[:3]) > self.cfg.kf_translation_th
            or np.linalg.norm(rel[3:]) > self.cfg.kf_rotation_th
        )
        c4 = 15 < ni < 75
        v = np.linalg.norm(frame.velocity[:3])
        w = np.linalg.norm(frame.velocity[3:])
        c5 = v < 0.3 and w < 0.1
        if ((c1a or c1b or c1c) and c2) or c3 or c4:
            if not c3 and c5:
                return False  # low-speed veto
            if idle:
                return True
            return len(self.local_mapper.queue) < 3
        return False

    def _create_keyframe(self, frame: Frame):
        """Tracking::CreateNewKeyFrame (Tracking.cc:2200-2292)."""
        m = self.atlas.active
        kf = KeyFrame(
            timestamp=frame.timestamp,
            cam_times=frame.cam_times.copy(),
            Twb=frame.Twb.copy(),
            velocity=frame.velocity.copy(),
            keypoints=frame.keypoints,
            kp_octaves=frame.kp_octaves,
            descriptors=frame.descriptors,
            kp_ur=frame.kp_ur,
            kp_angles=frame.kp_angles,
            kp_depth=frame.kp_depth,
            kp_sigma2_scale=frame.kp_sigma2_scale,
        )
        kf.matches = frame.matches.copy()
        kf.matches[frame.outlier] = -1
        kf.prev_kf = self.last_kf
        if self.last_kf is not None:
            self.last_kf.next_kf = kf
        m.add_keyframe(kf)
        # register observations
        for g, mp_id in enumerate(kf.matches):
            if mp_id < 0:
                continue
            mp = m.map_points.get(int(mp_id))
            if mp is None:
                continue
            cam, local = kf.cam_of_global(g)
            mp.add_observation(kf, cam, g)
        self._seed_stereo_landmarks(kf, m)
        kf.update_connections(m.map_points)
        self.last_kf = kf
        self.frames_since_kf = 0
        frame.ref_kf = kf
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)

    def _seed_stereo_landmarks(self, kf: KeyFrame, m: Map, max_seed=None):
        """Stereo-depth landmark seeding (<=100, Tracking.cc:2247-2288)."""
        max_seed = max_seed or self.cfg.max_stereo_seed
        cam = self.rig.n_cams - 1
        if kf.kp_depth is None:
            return
        order = np.argsort(kf.kp_depth)
        created = 0
        Twc = kf.Twb @ self.rig.Tbc[cam]
        K = self.rig.K[cam]
        for local in order:
            d = kf.kp_depth[local]
            if d <= 0:
                continue
            g = kf.global_index(cam, int(local))
            if kf.matches[g] >= 0:
                continue
            uv = kf.keypoints[cam][local]
            Xc = np.array([(uv[0] - K[2]) / K[0] * d, (uv[1] - K[3]) / K[1] * d, d])
            Xw = Twc[:3, :3] @ Xc + Twc[:3, 3]
            mp = MapPoint(position=Xw, descriptor=kf.descriptors[cam][local],
                          first_kf_id=kf.id)
            mp.add_observation(kf, cam, g)
            kf.matches[g] = mp.id
            m.add_map_point(mp)
            mp.update_normal_and_depth(
                m.keyframes, self.rig.Tbc, self.rig.scale_factor,
                self.rig.n_levels,
            )
            created += 1
            if created >= max_seed:
                break

    # ------------------------------------------------------------------
    def _stereo_initialization(self, frame: Frame) -> bool:
        """Tracking::StereoInitialization (Tracking.cc:1452-1503)."""
        cam = self.rig.n_cams - 1
        if frame.kp_depth is None or (frame.kp_depth > 0).sum() < 50:
            return False
        frame.Twb = np.eye(4)
        frame.velocity = self.rig.ini_vel.copy()
        m = self.atlas.active
        kf = KeyFrame(
            timestamp=frame.timestamp,
            cam_times=frame.cam_times.copy(),
            Twb=frame.Twb.copy(),
            velocity=frame.velocity.copy(),
            keypoints=frame.keypoints,
            kp_octaves=frame.kp_octaves,
            descriptors=frame.descriptors,
            kp_ur=frame.kp_ur,
            kp_angles=frame.kp_angles,
            kp_depth=frame.kp_depth,
            kp_sigma2_scale=frame.kp_sigma2_scale,
        )
        m.add_keyframe(kf)
        self._seed_stereo_landmarks(kf, m, max_seed=10**9)
        frame.matches = kf.matches.copy()
        self.last_kf = kf
        self.frames_since_kf = 0
        frame.ref_kf = kf
        self.velocity_model = self.rig.ini_vel.copy()
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        return True


    # ------------------------------------------------------------------
    def _relocalize(self, frame: Frame) -> bool:
        """Relocalization: KF-database candidates -> descriptor matching ->
        batched MLPnP RANSAC, tried on EVERY camera of the rig (the
        reference declares this path but ships it stubbed; see SURVEY.md
        §2.5/§5). Async cameras matter when only they see known structure —
        a viewpoint the stereo pair has turned away from. The recovered
        camera pose maps back to the body through that camera's extrinsic
        (async-camera timestamp offset within the frame is accepted as
        relocalization seed error; the next pose solve absorbs it)."""
        if self.kfdb is None:
            return False

        import os as _os
        _dbg = _os.environ.get("AMCSLAM_RELOC_DEBUG", "") == "1"
        m = self.atlas.active
        cands = self.kfdb.detect_relocalization_candidates(
            _FrameAsKF(frame), 3
        ) if any(d is not None for d in frame.descriptors) else []
        if _dbg:
            print(f"[reloc] t={frame.timestamp:.2f} cands="
                  f"{[c.id for c in cands]}", flush=True)
        for cand in cands:
            mp_ids = [int(i) for i in cand.matches if i >= 0]
            mps = [m.map_points[i] for i in set(mp_ids) if i in m.map_points]
            mps = [mp for mp in mps if not mp.bad and mp.descriptor is not None]
            if len(mps) < 12:
                if _dbg:
                    print(f"[reloc]  cand={cand.id} mps={len(mps)} <12",
                          flush=True)
                continue
            desc_mp = np.stack([mp.descriptor for mp in mps])
            best = None  # (n_in, cam, Tcw, mp_rows, kp_locals, inliers)
            for cam in range(self.rig.n_cams):
                if len(frame.keypoints[cam]) < 12:
                    continue
                idx = matcher.match_descriptors(desc_mp, frame.descriptors[cam],
                                                device=self.device)
                sel = idx >= 0
                if sel.sum() < 12:
                    continue
                mp_rows = np.nonzero(sel)[0]
                kp_locals = idx[sel]
                pts = np.stack([mps[mi].position for mi in mp_rows])
                obs = frame.keypoints[cam][kp_locals]
                res = self._pnp_camera(pts, obs, self.rig.K[cam])
                if res is None:
                    if _dbg:
                        print(f"[reloc]  cand={cand.id} cam={cam} "
                              f"n_match={len(pts)} pnp=None", flush=True)
                    continue
                Tcw, n_in, inl = res
                if _dbg:
                    print(f"[reloc]  cand={cand.id} cam={cam} "
                          f"n_match={len(pts)} n_in={n_in} "
                          f"need={max(15, len(pts) // 3)}", flush=True)
                if n_in >= max(15, len(pts) // 3) and (
                    best is None or n_in > best[0]
                ):
                    best = (n_in, cam, Tcw, mp_rows, kp_locals, inl)
            if best is not None:
                _, cam, Tcw, mp_rows, kp_locals, inl = best
                Twc = np.linalg.inv(Tcw)
                frame.Twb = Twc @ np.linalg.inv(self.rig.Tbc[cam])
                frame.velocity = np.zeros(6)
                self.velocity_model = np.zeros(6)
                # the PnP inlier associations become the frame's matches
                # (the reference's Relocalization fills mvpMapPoints before
                # handing the frame to TrackLocalMap, Tracking.cc:2577-2628;
                # UpdateLocalKeyFrames votes through them)
                for mi, loc, ok in zip(mp_rows, kp_locals, inl):
                    if ok:
                        frame.matches[frame.global_index(cam, int(loc))] = (
                            mps[int(mi)].id
                        )
                return True
        return False

    def _pnp_camera(self, pts: np.ndarray, obs: np.ndarray, K: np.ndarray):
        """MLPnP RANSAC for one camera's 2D-3D set, in the tracker's dtype
        (the reference uses its global float dtype here). Counts are
        pow2-bucketed with valid-masked padding, as in the reference."""
        n = len(pts)
        N = _hw_bucket("reloc.N", n)
        bear = np.concatenate(
            [(obs[:, :1] - K[2]) / K[0], (obs[:, 1:] - K[3]) / K[1],
             np.ones((len(obs), 1))], axis=1)
        bear /= np.linalg.norm(bear, axis=1, keepdims=True)
        # pad with a well-posed dummy ray (principal axis, point 5 m ahead)
        pts_p = np.concatenate([pts, np.tile([0.0, 0.0, 5.0], (N - n, 1))])
        obs_p = np.concatenate([obs, np.tile([K[2], K[3]], (N - n, 1))])
        bear_p = np.concatenate([bear, np.tile([0.0, 0.0, 1.0], (N - n, 1))])
        f = dict(device=self.device, dtype=self.dtype)
        data = PnPRansacData(
            points=torch.as_tensor(pts_p, **f),
            bearings=torch.as_tensor(bear_p, **f),
            obs=torch.as_tensor(obs_p, **f),
            K=torch.as_tensor(K, **f),
            w=torch.ones(N, **f),
            valid=torch.as_tensor(np.arange(N) < n, device=self.device),
            th2=torch.full((N,), 9.21, **f),
        )
        H = 32
        samples = np.stack([
            self._rng.choice(n, 6, replace=False) for _ in range(H)
        ])
        (R, t), inl, n_in = pnp_ransac(data, torch.as_tensor(samples, device=self.device))
        R, t, inl, n_in = _fetch(R, t, inl, n_in)  # one device-to-host read
        if not np.isfinite(t).all():
            return None
        Tcw = np.eye(4)
        Tcw[:3, :3] = R
        Tcw[:3, 3] = t
        return Tcw, int(n_in), np.asarray(inl[:n], bool)

    def _add_gp_observations(self, frame: Frame):
        """Attach this (non-keyframe) frame's inlier matches as GPObs records
        on their map points, anchored at the reference keyframe — consumed by
        BundleAdjustment/LocalGPBA (Optimizer.cc:252-304, 1027-1098)."""
        if self.last_kf is None:
            return
        m = self.atlas.active
        for g, mp_id in enumerate(frame.matches):
            if mp_id < 0 or frame.outlier[g]:
                continue
            mp = m.map_points.get(int(mp_id))
            if mp is None or mp.bad:
                continue
            cam, local = frame.cam_of_global(g)
            uv = frame.keypoints[cam][local]
            ur = -1.0
            if cam == self.rig.n_cams - 1 and frame.kp_ur is not None:
                ur = float(frame.kp_ur[local])
            mp.add_gp_observation(
                self.last_kf.id,
                GPObs(
                    time=float(frame.cam_times[cam]),
                    cam=cam,
                    uv=np.asarray(uv, float),
                    ur=ur,
                    octave=int(frame.kp_octaves[cam][local]),
                    sigma2_scale=(
                        float(frame.kp_sigma2_scale[cam][local])
                        if frame.kp_sigma2_scale is not None
                        and frame.kp_sigma2_scale[cam] is not None else 1.0
                    ),
                ),
            )


class _FrameAsKF:
    """Adapter: lets the keyframe database score a plain Frame query."""

    def __init__(self, frame: Frame):
        self.id = -1
        self.descriptors = frame.descriptors
        self.covisibility = {}

    def best_covisible(self, n):
        return []
