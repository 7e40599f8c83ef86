"""Local mapping (rebuild of src/LocalMapping.cc Run loop).

Sequential (or caller-threaded) consumer of new keyframes:
  ProcessNewKeyFrame -> MapPointCulling -> CreateNewMapPoints (epipolar
  search + batched DLT triangulation on device) -> SearchInNeighbors (fuse)
  -> LocalGPBA (the Schur solver via extraction) -> pass to loop
  closing. KeyFrameCulling stays disabled, as in the reference — culling
  would break the temporal GP chain (LocalMapping.cc:160-162).

Port of `amcslam_tpu/pipeline/local_mapping.py`. The numeric stages run on
the mapper's device: the batched DLT triangulation (one SVD call, no pow2
pad rows; in float64, the reference's dtype in its float64 runs) and the
local BA in the mapper's dtype (a plain call of `solver.ba.local_gp_ba`, or
`local_gp_ba_interruptible` in threaded mode; the reference's jitted
closure, `block_until_ready` and debug rerun are gone). Each solve's
write-back is one device-to-host read.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..frontend.cameras import triangulate_dlt
from ..solver.ba import BAState, local_gp_ba, local_gp_ba_interruptible
from ..utils.timing import GLOBAL_TIMER
from . import matcher
from .extraction import apply_local_ba, extract_local_ba
from .map_store import KeyFrame, Map, MapPoint
from .rig import Rig
from .tracking import resolve_device


def camera_Twc(kf: KeyFrame, cam: int, rig: Rig) -> np.ndarray:
    """Per-camera pose at that camera's own timestamp: the stereo camera
    is at the KF time; async cameras GP-interpolate between the previous
    keyframe and this one (GetCameraPose semantics, KeyFrame.cc:116-145 /
    LocalMapping.cc:360-393)."""
    if cam == rig.n_cams - 1:
        return kf.Twb @ rig.Tbc[cam]
    t = float(kf.cam_times[cam])
    prev = kf.prev_kf
    if prev is not None and prev.timestamp < t < kf.timestamp:
        from .tracking import interp_camera_pose

        Twb_t = interp_camera_pose(
            prev.Twb, prev.velocity, prev.timestamp,
            kf.Twb, kf.velocity, kf.timestamp, t,
        )
    else:
        # constant-twist extrapolation from the KF's own state
        from .tracking import _np_exp_se3

        Twb_t = kf.Twb @ _np_exp_se3(kf.velocity * (t - kf.timestamp))
    return Twb_t @ rig.Tbc[cam]


class LocalMapping:
    def __init__(self, rig: Rig, map_: Map, b_extrinsic: bool = False,
                 loop_closer=None, interruptible: bool = False, *, device,
                 dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.rig = rig
        self.map = map_
        self.b_extrinsic = b_extrinsic
        self.loop_closer = loop_closer
        self.recent_points: list[MapPoint] = []
        self.queue: list[KeyFrame] = []
        # mbAbortBA (LocalMapping.cc:35): set by InsertKeyFrame (:215) so a
        # keyframe arriving from tracking force-stops a running LocalGPBA at
        # the next LM-segment boundary. Only consulted when `interruptible`
        # (threaded mode) — the sequential schedule drains the queue between
        # frames, so there is never a concurrent producer to abort for.
        import threading

        self.abort_ba = threading.Event()
        self.interruptible = interruptible
        self.n_ba_aborted = 0  # nLBA_abort diagnostic (LocalMapping.cc:150)

    def insert_keyframe(self, kf: KeyFrame):
        self.queue.append(kf)
        self.abort_ba.set()  # InterruptBA (LocalMapping.cc:215)

    def run_once(self, lock=None) -> bool:
        """One LocalMapping::Run iteration; returns False when idle.

        `lock` (threaded mode: the map mutex) is taken per map-mutating
        stage, NOT across the whole iteration — in particular the local-BA
        SOLVE runs outside it on an extracted snapshot, so tracking is never
        blocked for the solve's duration (the reference's LocalMapping
        equally holds mMutexMapUpdate only around state updates while g2o
        optimizes its own copies; Optimizer.cc:1246 'Optimize' vs :1386
        'Recover optimized data')."""
        if not self.queue:
            return False
        import contextlib

        ctx = lock if lock is not None else contextlib.nullcontext()
        kf = self.queue.pop(0)
        T = GLOBAL_TIMER
        with ctx, T.span("lm.process_new_kf"):
            self.process_new_keyframe(kf)
        with ctx, T.span("lm.cull_map_points"):
            self.cull_map_points(kf)
        with ctx, T.span("lm.create_new_points"):
            self.create_new_map_points(kf)
        # mbAbortBA = false after triangulation (LocalMapping.cc:104); fuse
        # and BA only run when the mapper has caught up with tracking
        # (!CheckNewKeyFrames() gates, LocalMapping.cc:106/125)
        self.abort_ba.clear()
        if not self.queue:
            with ctx, T.span("lm.fuse_neighbors"):
                self.fuse_neighbors(kf)
        if not self.queue and self.map.n_keyframes() > 2:
            with T.span("lm.local_ba"):
                self.local_ba(kf, lock=lock)
        if self.loop_closer is not None:
            with T.span("lm.loop_closing"):
                self.loop_closer.insert_keyframe(kf)
        return True

    # ------------------------------------------------------------------
    def process_new_keyframe(self, kf: KeyFrame):
        """LocalMapping::ProcessNewKeyFrame (:225): observation registration
        happens at creation; refresh covisibility and track recent points."""
        kf.update_connections(self.map.map_points)
        # spanning tree: first connection sets the parent to the strongest
        # covisible keyframe (KeyFrame::UpdateConnections mbFirstConnection)
        if kf.parent is None and kf.covisibility and self.map.origin_kf is not kf:
            best = max(kf.covisibility, key=kf.covisibility.get)
            kf.parent = self.map.keyframes.get(best)
        for mp_id in kf.matches:
            if mp_id < 0:
                continue
            mp = self.map.map_points.get(int(mp_id))
            if mp is not None and mp.first_kf_id == kf.id:
                self.recent_points.append(mp)

    def cull_map_points(self, kf: KeyFrame):
        """LocalMapping::MapPointCulling (:273): found-ratio < 0.25 or too few
        observations within 2 KFs of creation. Probation ages count
        *keyframes* (kf_seq), not raw ids — ids come from a counter shared
        with Frames/MapPoints so consecutive KFs differ by 100+ ids."""
        keep = []
        for mp in self.recent_points:
            if mp.bad:
                continue
            first = self.map.keyframes.get(mp.first_kf_id)
            age = kf.kf_seq - first.kf_seq if first is not None else 3
            if mp.found_ratio() < 0.25:
                self.map.erase_map_point(mp)
            elif age >= 2 and mp.n_obs() <= 2:
                self.map.erase_map_point(mp)
            elif age >= 3:
                pass  # survived probation
            else:
                keep.append(mp)
        self.recent_points = keep

    # ------------------------------------------------------------------
    def _camera_Twc(self, kf: KeyFrame, cam: int) -> np.ndarray:
        return camera_Twc(kf, cam, self.rig)

    @staticmethod
    def _kp_s2(kf, c: int, local: int) -> float:
        """KB8 lift variance inflation for one keypoint (1.0 for pinhole) —
        chi2 gates must widen by it or edge-of-FOV fisheye features are
        systematically rejected (they carry magnified pixel noise)."""
        sc = getattr(kf, "kp_sigma2_scale", None)
        if sc is None or sc[c] is None:
            return 1.0
        return float(sc[c][local])

    @staticmethod
    def _global_s2(kf, C: int) -> "np.ndarray":
        sc = getattr(kf, "kp_sigma2_scale", None)
        if sc is None:
            return np.ones(int(kf.kp_offsets[-1]))
        return np.concatenate([
            np.ones(len(kf.keypoints[c])) if sc[c] is None
            else np.asarray(sc[c], float)
            for c in range(C)
        ]) if int(kf.kp_offsets[-1]) else np.ones(0)

    def _global_arrays(self, kf: KeyFrame):
        """Concatenate per-camera keypoint data into the global index order
        (the reference's flat `mvKeysUn`/`mmpKeyToCam` layout)."""
        C = self.rig.n_cams
        kp = np.concatenate([np.asarray(kf.keypoints[c]).reshape(-1, 2)
                             for c in range(C)])
        desc = np.concatenate([np.asarray(kf.descriptors[c]).reshape(-1, 32)
                               for c in range(C)]).astype(np.uint8)
        octv = np.concatenate([np.asarray(kf.kp_octaves[c]).reshape(-1)
                               for c in range(C)]).astype(int)
        cams = np.concatenate([np.full(len(kf.keypoints[c]), c, int)
                               for c in range(C)])
        ang = (
            np.concatenate([np.asarray(kf.kp_angles[c]).reshape(-1)
                            for c in range(C)])
            if kf.kp_angles is not None else None
        )
        return kp, desc, octv, cams, ang

    def create_new_map_points(self, kf: KeyFrame, n_neighbors: int = 10):
        """LocalMapping::CreateNewMapPoints (:311-569): descriptor matching
        across the GLOBAL keypoint sets of both keyframes (cross-camera pairs
        possible, ORBmatcher::SearchForTriangulation ORBmatcher.cc:947ff) with
        per-pair epipolar gating, then batched DLT triangulation and the full
        acceptance gates — parallax, cheirality in both views, reprojection
        chi2 in both views, octave scale consistency (LocalMapping.cc:434-569).
        Each camera observes at its own GP-interpolated pose."""
        neighbors = [
            self.map.keyframes[i]
            for i in kf.best_covisible(n_neighbors)
            if i in self.map.keyframes
        ]
        if kf.prev_kf is not None and kf.prev_kf not in neighbors:
            neighbors.append(kf.prev_kf)

        C = self.rig.n_cams
        sf = self.rig.scale_factor
        ratio_factor = 1.5 * sf
        Kmats, Kinvs = [], []
        for c in range(C):
            K4 = self.rig.K[c]
            Km = np.array([[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1.0]])
            Kmats.append(Km)
            Kinvs.append(np.linalg.inv(Km))
        Twc1 = [self._camera_Twc(kf, c) for c in range(C)]
        Tcw1 = [np.linalg.inv(T) for T in Twc1]
        kp1, d1, oct1, cam1, ang1 = self._global_arrays(kf)
        if len(kp1) == 0:
            return 0
        free1 = kf.matches < 0

        tri_r1, tri_r2, tri_T1, tri_T2, tri_meta = [], [], [], [], []
        for nb in neighbors:
            # a keyframe waiting in the queue aborts the neighbor sweep
            # (LocalMapping.cc:622/651 mbAbortBA checks in CreateNewMapPoints)
            if self.interruptible and self.abort_ba.is_set() and self.queue:
                break
            kp2, d2, oct2, cam2, ang2 = self._global_arrays(nb)
            if len(kp2) == 0:
                continue
            s2_2 = self._global_s2(nb, C)
            Twc2 = [self._camera_Twc(nb, c) for c in range(C)]
            Tcw2 = [np.linalg.inv(T) for T in Twc2]
            # per-(c1,c2) fundamental matrices from the relative camera poses
            F12 = np.zeros((C, C, 3, 3))
            base_ok = np.zeros((C, C), bool)
            for a in range(C):
                for b in range(C):
                    T12 = Tcw1[a] @ Twc2[b]
                    t12 = T12[:3, 3]
                    base_ok[a, b] = np.linalg.norm(t12) >= 0.05
                    tx = np.array(
                        [[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]],
                         [-t12[1], t12[0], 0]]
                    )
                    F12[a, b] = Kinvs[a].T @ tx @ T12[:3, :3] @ Kinvs[b]
            if not base_ok.any():
                continue
            idx2 = matcher.match_descriptors(
                d1, d2, max_dist=matcher.TH_LOW, ratio=0.9,
                ang1=ang1, ang2=ang2, device=self.device,
            )
            # batched candidate gates (the reference's per-pair loop,
            # LocalMapping.cc:434-569, vectorized over every match at once)
            g1s = np.nonzero((idx2 >= 0) & free1)[0]
            if len(g1s) == 0:
                continue
            g2s = idx2[g1s]
            keep = nb.matches[g2s] < 0
            g1s, g2s = g1s[keep], g2s[keep]
            if len(g1s) == 0:
                continue
            c1v, c2v = cam1[g1s], cam2[g2s]
            ok = base_ok[c1v, c2v]
            g1s, g2s, c1v, c2v = g1s[ok], g2s[ok], c1v[ok], c2v[ok]
            if len(g1s) == 0:
                continue
            ones = np.ones((len(g1s), 1))
            kp1h = np.concatenate([kp1[g1s], ones], axis=1)
            kp2h = np.concatenate([kp2[g2s], ones], axis=1)
            # epipolar gate: distance of kp2 from kp1's epipolar line
            # (CheckDistEpipolarLine, 3.84 * sigma2 of kp2's octave)
            l2 = np.einsum("nji,nj->ni", F12[c1v, c2v], kp1h)
            num = np.einsum("ni,ni->n", l2, kp2h)
            den = l2[:, 0] ** 2 + l2[:, 1] ** 2
            ep_ok = (den >= 1e-12) & (
                num * num <= 3.84 * self.rig.level_sigma2[oct2[g2s]]
                * s2_2[g2s] * np.maximum(den, 1e-12)
            )
            # parallax gate: nearly parallel rays triangulate badly
            # (cosParallaxRays < 0.9998, LocalMapping.cc:480)
            Kinv_a = np.stack(Kinvs)
            Rwc1_a = np.stack([T[:3, :3] for T in Twc1])
            Rwc2_a = np.stack([T[:3, :3] for T in Twc2])
            r1 = np.einsum("nij,nj->ni", Kinv_a[c1v], kp1h)
            r2 = np.einsum("nij,nj->ni", Kinv_a[c2v], kp2h)
            ray1 = np.einsum("nij,nj->ni", Rwc1_a[c1v], r1)
            ray2 = np.einsum("nij,nj->ni", Rwc2_a[c2v], r2)
            cos_par = np.einsum("ni,ni->n", ray1, ray2) / (
                np.linalg.norm(ray1, axis=1) * np.linalg.norm(ray2, axis=1)
            )
            sel = ep_ok & (cos_par < 0.9998)
            if not sel.any():
                continue
            g1s, g2s, c1v, c2v = g1s[sel], g2s[sel], c1v[sel], c2v[sel]
            r1, r2 = r1[sel], r2[sel]
            Tcw1_a = np.stack(Tcw1)
            Tcw2_a = np.stack(Tcw2)
            tri_r1.append(r1 / r1[:, 2:3])
            tri_r2.append(r2 / r2[:, 2:3])
            tri_T1.append(Tcw1_a[c1v])
            tri_T2.append(Tcw2_a[c2v])
            tri_meta.extend(
                (int(c1), int(g1), nb, int(c2), int(g2))
                for c1, g1, c2, g2 in zip(c1v, g1s, c2v, g2s)
            )

        if not tri_r1:
            return 0
        r1_a = np.concatenate(tri_r1)
        r2_a = np.concatenate(tri_r2)
        T1_a = np.concatenate(tri_T1)
        T2_a = np.concatenate(tri_T2)
        n_tri = len(r1_a)
        f64 = dict(device=self.device, dtype=torch.float64)
        X, w = convert.fetch(*triangulate_dlt(
            torch.as_tensor(r1_a, **f64), torch.as_tensor(r2_a, **f64),
            torch.as_tensor(T1_a, **f64), torch.as_tensor(T2_a, **f64),
        ), dtype=torch.float64)  # one device-to-host read for both outputs

        # --- batched acceptance gates (cheirality, reprojection chi2 in
        # both views, octave scale consistency — LocalMapping.cc:480-569)
        meta_c1 = np.array([m[0] for m in tri_meta])
        meta_g1 = np.array([m[1] for m in tri_meta])
        meta_c2 = np.array([m[3] for m in tri_meta])
        meta_g2 = np.array([m[4] for m in tri_meta])
        o1 = np.array([
            int(kf.kp_octaves[c][g - kf.kp_offsets[c]])
            for c, g in zip(meta_c1, meta_g1)
        ])
        o2 = np.array([
            int(m[2].kp_octaves[m[3]][m[4] - m[2].kp_offsets[m[3]]])
            for m in tri_meta
        ])
        uv2 = np.stack([
            np.asarray(m[2].keypoints[m[3]])[m[4] - m[2].kp_offsets[m[3]]]
            for m in tri_meta
        ])
        s2g1 = np.array([
            self._kp_s2(kf, c, g - kf.kp_offsets[c])
            for c, g in zip(meta_c1, meta_g1)
        ])
        s2g2 = np.array([
            self._kp_s2(m[2], m[3], m[4] - m[2].kp_offsets[m[3]])
            for m in tri_meta
        ])
        T1r = T1_a[:n_tri]
        T2r = T2_a[:n_tri]
        Xc1 = np.einsum("nij,nj->ni", T1r[:, :3, :3], X) + T1r[:, :3, 3]
        Xc2 = np.einsum("nij,nj->ni", T2r[:, :3, :3], X) + T2r[:, :3, 3]
        Ka = np.asarray(self.rig.K)
        K1v, K2v = Ka[meta_c1], Ka[meta_c2]
        with np.errstate(divide="ignore", invalid="ignore"):
            p1 = K1v[:, :2] * Xc1[:, :2] / Xc1[:, 2:3] + K1v[:, 2:]
            p2 = K2v[:, :2] * Xc2[:, :2] / Xc2[:, 2:3] + K2v[:, 2:]
        e1 = np.einsum("ni,ni->n", p1 - kp1[meta_g1], p1 - kp1[meta_g1])
        e2 = np.einsum("ni,ni->n", p2 - uv2, p2 - uv2)
        cen1 = -np.einsum("nji,nj->ni", T1r[:, :3, :3], T1r[:, :3, 3])
        cen2 = -np.einsum("nji,nj->ni", T2r[:, :3, :3], T2r[:, :3, 3])
        dist1 = np.linalg.norm(X - cen1, axis=1)
        dist2 = np.linalg.norm(X - cen2, axis=1)
        sig2 = np.asarray(self.rig.level_sigma2)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio_dist = dist2 / np.maximum(dist1, 1e-12)
        ratio_oct = sf ** o1.astype(float) / sf ** o2.astype(float)
        accept = (
            np.isfinite(X).all(axis=1)
            & (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0) & (np.abs(w) >= 1e-9)
            & (e1 <= 5.991 * sig2[o1] * s2g1) & (e2 <= 5.991 * sig2[o2] * s2g2)
            & (dist1 > 0) & (dist2 > 0)
            & (ratio_dist * ratio_factor > ratio_oct)
            & (ratio_dist < ratio_oct * ratio_factor)
        )

        created = 0
        centers = {}  # no pose changes while points are created
        for n in np.nonzero(accept)[0]:
            c1, g1, nb, c2, g2 = tri_meta[n]
            if kf.matches[g1] >= 0 or nb.matches[g2] >= 0:
                continue
            cam_l1 = g1 - kf.kp_offsets[c1]
            mp = MapPoint(position=X[n], descriptor=kf.descriptors[c1][cam_l1],
                          first_kf_id=kf.id)
            mp.add_observation(kf, c1, g1)
            mp.add_observation(nb, c2, g2)
            kf.matches[g1] = mp.id
            nb.matches[g2] = mp.id
            self.map.add_map_point(mp)
            mp.update_normal_and_depth(
                self.map.keyframes, self.rig.Tbc, sf, self.rig.n_levels, centers
            )
            self.recent_points.append(mp)
            created += 1
        return created

    # ------------------------------------------------------------------
    def fuse_neighbors(self, kf: KeyFrame):
        """LocalMapping::SearchInNeighbors (:593): project this KF's points
        into neighbors and merge duplicates (keep the more-observed point)."""
        neighbors = [
            self.map.keyframes[i]
            for i in kf.best_covisible(10)
            if i in self.map.keyframes
        ]
        mps = [
            self.map.map_points[int(i)]
            for i in kf.matches
            if i >= 0 and int(i) in self.map.map_points
        ]
        if not mps:
            return
        pos = np.stack([mp.position for mp in mps])
        desc = np.stack([
            mp.descriptor if mp.descriptor is not None else np.zeros(32, np.uint8)
            for mp in mps
        ])
        centers = {}  # no pose changes while points fuse
        for nb in neighbors:
            # project through EVERY camera at its own (GP-interpolated) pose
            # (ORBmatcher::Fuse loops cameras, ORBmatcher.cc:1133ff)
            for cam in range(self.rig.n_cams):
                if len(nb.keypoints[cam]) == 0:
                    continue
                Tcw = np.linalg.inv(self._camera_Twc(nb, cam))
                idx = matcher.search_by_projection(
                    pos, desc, nb.keypoints[cam], nb.descriptors[cam],
                    nb.kp_octaves[cam], Tcw, self.rig.K[cam], radius=3.0,
                    max_dist=matcher.TH_LOW, device=self.device,
                )
                for mi, ki in enumerate(idx):
                    if ki < 0:
                        continue
                    g = nb.global_index(cam, int(ki))
                    other_id = nb.matches[g]
                    mp = mps[mi]
                    if mp.bad:
                        continue
                    if other_id < 0:
                        nb.matches[g] = mp.id
                        mp.add_observation(nb, cam, g)
                        mp.update_normal_and_depth(
                            self.map.keyframes, self.rig.Tbc,
                            self.rig.scale_factor, self.rig.n_levels, centers,
                        )
                    elif other_id != mp.id and int(other_id) in self.map.map_points:
                        other = self.map.map_points[int(other_id)]
                        # keep the better-observed one (ORBmatcher::Fuse)
                        winner, loser = (mp, other) if mp.n_obs() >= other.n_obs() else (other, mp)
                        for kf_id, slots in list(loser.observations.items()):
                            okf = self.map.keyframes.get(kf_id)
                            if okf is None:
                                continue
                            for c, gi in enumerate(slots):
                                if gi >= 0:
                                    okf.matches[gi] = winner.id
                                    winner.add_observation(okf, c, int(gi))
                        self.map.erase_map_point(loser)
                        winner.update_normal_and_depth(
                            self.map.keyframes, self.rig.Tbc,
                            self.rig.scale_factor, self.rig.n_levels, centers,
                        )

    # ------------------------------------------------------------------
    def local_ba(self, kf: KeyFrame, lock=None):
        """Optimizer::LocalGPBA via extraction + the Schur solver on the
        mapper's device.

        With `lock` (threaded mode): snapshot-extract and write-back run
        under the map mutex; the device solve between them does not."""
        import contextlib

        ctx = lock if lock is not None else contextlib.nullcontext()
        with ctx, GLOBAL_TIMER.span("lm.ba_extract"):
            data, state, handles = extract_local_ba(
                kf, self.map.map_points, self.rig, kf_table=self.map.keyframes,
                device=self.device, dtype=self.dtype,
            )
        with GLOBAL_TIMER.span("lm.ba_solve"):
            if self.interruptible:
                res, aborted = local_gp_ba_interruptible(
                    data, state, b_large=False, b_extrinsic=self.b_extrinsic,
                    ext_min_obs=self.rig.ext_min_obs,
                    should_abort=lambda: (
                        self.abort_ba.is_set() and bool(self.queue)
                    ),
                )
                if aborted:
                    self.n_ba_aborted += 1
            else:
                res = local_gp_ba(data, state, b_large=False,
                                  b_extrinsic=self.b_extrinsic,
                                  ext_min_obs=self.rig.ext_min_obs)
            # the whole result in one device-to-host read, in the solve's
            # dtype (the write-back keeps it, as the reference's host copies)
            s = res.state
            parts = convert.fetch(res.ok, res.erase_m, res.erase_sg, res.erase_st,
                                  s.T, s.v, s.Text, s.X, dtype=s.T.dtype)
        with ctx, GLOBAL_TIMER.span("lm.ba_apply"):
            self._apply_local_ba(parts, handles)

    def _apply_local_ba(self, parts, handles):
        ok, erase_m, erase_sg, erase_st, T, v, Text, X = parts
        if bool(ok):
            apply_local_ba(BAState(T=T, v=v, Text=Text, X=X), handles,
                           self.map.map_points)
            # refined extrinsics write back into the STATIC rig so subsequent
            # tracking/extraction uses them (Optimizer.cc:1419-1428 mutates
            # MultiKeyFrame::mTbc / MultiFrame::mTbc)
            if self.b_extrinsic:
                Cx = self.rig.n_cams - 1
                self.rig.Tbc[:Cx] = np.asarray(Text, np.float64)
            # erase outlier observations (Optimizer.cc:1257-1382):
            # stereo-cam KF obs -> EraseMapPointMatch + EraseObservation
            erase_st = erase_st.astype(bool)
            erase_m = erase_m.astype(bool)
            erase_sg = erase_sg.astype(bool)
            cam_s = self.rig.n_cams - 1
            st_meta, mg_meta = handles["st_meta"], handles["mg_meta"]
            for n in np.nonzero(erase_st[:len(st_meta)])[0]:
                kf_i, mp, g = st_meta[n]
                mp.erase_observation(kf_i, cam_s)
                kf_i.matches[g] = -1
            # mono-GP edges: KF async-cam obs erase as above; non-KF GPObs
            # records scrub via EraseGPObservation
            for n in np.nonzero(erase_m[:len(mg_meta)])[0]:
                meta = mg_meta[n]
                if meta[0] == "kf":
                    _, kf_i, cam, mp, g = meta
                    mp.erase_observation(kf_i, cam)
                    kf_i.matches[g] = -1
                else:
                    _, kf_id, obs, mp = meta
                    mp.erase_gp_observation(kf_id, obs)
            for n, meta in enumerate(handles["sg_meta"]):
                if erase_sg[n]:
                    _, kf_id, obs, mp = meta
                    mp.erase_gp_observation(kf_id, obs)
            # refresh viewing geometry of moved landmarks
            # (pMP->UpdateNormalAndDepth after SetWorldPos, Optimizer.cc:1415)
            centers = {}  # the poses were written back above
            for mp in handles["lms"]:
                if not mp.bad:
                    mp.update_normal_and_depth(
                        self.map.keyframes, self.rig.Tbc,
                        self.rig.scale_factor, self.rig.n_levels, centers,
                    )
            self.map.increase_change_index()
