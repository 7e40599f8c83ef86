"""Loop closing (rebuild of src/LoopClosing.cc Run loop).

Port of `amcslam_tpu/pipeline/loop_closing.py`. NewDetectCommonRegions ->
(KeyFrameDatabase candidates -> descriptor matching -> batched Sim3 RANSAC
(Horn) -> SearchBySim3 densification -> OptimizeSim3 refinement ->
temporal consistency count) -> CorrectLoop (pose/landmark propagation
through the corrected Sim3, essential-graph optimization, SearchAndFuse,
full global BA). The device work (RANSAC, OptimizeSim3, the essential
graph, the global BA) runs on the closer's explicit `device` in its
`dtype`; each result comes back to the host in one read (`convert.fetch`).

The global BA either runs in place (`detached_gba=False`, the sequential
schedule) or on a thread of its own that snapshots the map under its mutex,
solves without it, polls an abort flag between LM segments and applies its
result only if no newer loop superseded it (LoopClosing.cc:1036-1044,
:1206-1339). Lock order: the map mutex, then `_gba_lock`. An exception in
that thread is kept in `gba_error` and raised by `join_gba`.

The reference's `jax.jit` wrappers are not ported; its known faults are
kept (ROADMAP §3), e.g. the essential graph measures every edge from
already-corrected poses, so it does nothing on a first closure.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import convert
from ..ops.sim3 import Sim3
from ..ransac.sim3_solver import Sim3RansacData, sim3_ransac
from ..solver import ba
from ..solver.sim3_opt import (EssentialGraphData, Sim3Field, Sim3PairData,
                               optimize_essential_graph, optimize_sim3)
from ..utils.shapes import bucket_pow2
from ..utils.timing import GLOBAL_TIMER
from . import extraction, matcher
from .keyframe_database import KeyFrameDatabase
from .map_store import KeyFrame, Map
from .rig import Rig
from .tracking import resolve_device


class LoopClosing:
    def __init__(self, rig: Rig, map_: Map, kfdb: KeyFrameDatabase | None = None,
                 fix_scale: bool = True, min_matches: int = 20,
                 consistency_needed: int = 3, run_global_ba: bool = True,
                 detached_gba: bool = False, *, device, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.rig = rig
        self.map = map_
        self.kfdb = kfdb or KeyFrameDatabase()
        self.fix_scale = fix_scale
        self.min_matches = min_matches
        self.consistency_needed = consistency_needed
        self.run_global_ba = run_global_ba
        self.n_coincidences = 0
        self.n_not_found = 0
        self.candidate: KeyFrame | None = None
        self.queue: list[KeyFrame] = []
        self.loops_closed = 0
        self._rng = np.random.RandomState(3)
        # Detached abortable global BA (LoopClosing.cc:1036-1044 launches
        # RunGlobalBundleAdjustment on its own thread; :811-835 aborts a
        # running one when a newer loop arrives). `detached_gba=False`
        # (sequential schedule) keeps the synchronous deterministic path.
        self.detached_gba = detached_gba
        self.full_ba_idx = 0                   # mnFullBAIdx
        self.gba_abort = threading.Event()     # mbStopGBA
        self.running_gba = False               # mbRunningGBA
        self.gba_thread: threading.Thread | None = None
        self._gba_lock = threading.Lock()      # mMutexGBA
        self.gba_error: Exception | None = None
        self.n_gba_aborted = 0                 # nFGBA_abort diagnostic
        self.n_gba_applied = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _index(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.int64), device=self.device)

    def _flag(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, bool), device=self.device)

    def insert_keyframe(self, kf: KeyFrame):
        self.queue.append(kf)

    def run_once(self) -> bool:
        if not self.queue:
            return False
        with GLOBAL_TIMER.span("lc.run_once"):
            kf = self.queue.pop(0)
            if self.map.n_keyframes() >= 12:  # guard (LoopClosing.cc:212-217)
                with GLOBAL_TIMER.span("lc.detect"):
                    hit = self.detect_common_regions(kf)
                if hit is not None:
                    loop_kf, S12 = hit
                    with GLOBAL_TIMER.span("lc.correct"):
                        self.correct_loop(kf, loop_kf, S12)
            with GLOBAL_TIMER.span("lc.kfdb_add"):
                self.kfdb.add(kf)
        return True

    # ------------------------------------------------------------------
    def _match_keyframes(self, kf1: KeyFrame, kf2: KeyFrame):
        """Descriptor matching between two KFs' map points (SearchByBoW-ish).
        Returns two parallel observation records (mps, cams, uvs, ws): the
        MEASURED keypoint of each match, not a reprojected estimate
        (Sim3Solver.cc:181-342 checks against measured keypoints)."""
        rec1 = self._kf_points(kf1)
        rec2 = self._kf_points(kf2)
        if len(rec1[0]) < 3 or len(rec2[0]) < 3:
            return ([], [], [], []), ([], [], [], [])
        ang1 = np.asarray(rec1[5])
        ang2 = np.asarray(rec2[5])
        have_ang = np.isfinite(ang1).all() and np.isfinite(ang2).all()
        idx = matcher.match_descriptors(
            np.stack(rec1[4]), np.stack(rec2[4]), max_dist=50,
            ang1=ang1 if have_ang else None,
            ang2=ang2 if have_ang else None, device=self.device,
        )
        out1 = [[], [], [], []]
        out2 = [[], [], [], []]
        for i, j in enumerate(idx):
            if j >= 0:
                for a in range(4):
                    out1[a].append(rec1[a][i])
                    out2[a].append(rec2[a][int(j)])
        return tuple(out1), tuple(out2)

    def _kf_points(self, kf: KeyFrame):
        """(mps, cams, uvs, ws, descs, angs): map points observed by `kf`
        with the measured keypoint (camera, pixel, invSigma2, angle) of each
        observation (angle NaN when the keyframe has no angles)."""
        mps, cams, uvs, ws, descs, angs = [], [], [], [], [], []
        seen = set()
        for g, mp_id in enumerate(kf.matches):
            if mp_id < 0 or int(mp_id) in seen:
                continue
            mp = self.map.map_points.get(int(mp_id))
            if mp is None or mp.bad or mp.descriptor is None:
                continue
            seen.add(int(mp_id))
            cam, local = kf.cam_of_global(g)
            mps.append(mp)
            cams.append(cam)
            uvs.append(np.asarray(kf.keypoints[cam][local], float))
            ws.append(float(kf.kp_inv_sigma2(self.rig, cam, local)))
            descs.append(mp.descriptor)
            angs.append(
                float(kf.kp_angles[cam][local])
                if kf.kp_angles is not None else np.nan
            )
        return mps, cams, uvs, ws, descs, angs

    def detect_common_regions(self, kf: KeyFrame):
        """NewDetectCommonRegions (LoopClosing.cc:194-733), batched RANSAC.

        Temporal consistency accumulates ACROSS successive keyframes: once a
        candidate passes geometric verification it is stored as a pending
        hypothesis and re-verified against each subsequent keyframe
        (DetectAndReffineSim3FromLastKF, LoopClosing.cc:239-285) until
        `consistency_needed` successive verifications confirm the loop. Up
        to two consecutive verification misses are tolerated before the
        hypothesis is dropped (mnLoopNumNotFound semantics).
        """
        # re-verify a pending hypothesis against this keyframe first
        if self.candidate is not None:
            S12 = self._try_pair(kf, self.candidate)
            if S12 is not None:
                self.n_coincidences += 1
                self.n_not_found = 0
                if self.n_coincidences >= self.consistency_needed:
                    cand = self.candidate
                    self._reset_hypothesis()
                    return cand, S12
                return None
            self.n_not_found += 1
            if self.n_not_found >= 2:
                self._reset_hypothesis()
            return None

        # no pending hypothesis: query the database for a fresh one
        exclude = {kf.id} | set(kf.covisibility)
        cands = self.kfdb.detect_n_best_candidates(kf, 3, exclude)
        for cand in cands:
            S12 = self._try_pair(kf, cand)
            if S12 is None:
                continue
            self.candidate = cand
            self.n_coincidences = 1
            self.n_not_found = 0
            if self.n_coincidences >= self.consistency_needed:
                self._reset_hypothesis()
                return cand, S12
            return None
        return None

    def _reset_hypothesis(self):
        self.candidate = None
        self.n_coincidences = 0
        self.n_not_found = 0

    def _try_pair(self, kf: KeyFrame, cand: KeyFrame):
        """Match + Sim3-verify one (current, candidate) pair; the Sim3 maps
        candidate body coords into current body coords, or None."""
        rec1, rec2 = self._match_keyframes(kf, cand)
        if len(rec1[0]) < self.min_matches:
            return None
        S12, n_inl, _ = self._solve_sim3(kf, cand, rec1, rec2)
        if S12 is None or int(n_inl) < self.min_matches:
            return None
        return S12

    def _solve_sim3(self, kf1: KeyFrame, kf2: KeyFrame, rec1, rec2):
        """Sim3Solver RANSAC + OptimizeSim3 (LoopClosing.cc:527, :597).

        Verification reprojects the aligned points against the MEASURED
        keypoints through each observation's own camera, with per-octave
        chi2 gates (Sim3Solver.cc:181-342 mvnMaxError semantics). Returns
        (S12 as host arrays in the closer's dtype, inlier count, mask)."""
        mps1, cams1, uvs1, ws1 = rec1
        mps2, cams2, uvs2, ws2 = rec2
        n = len(mps1)
        Tbw1 = np.linalg.inv(kf1.Twb)
        Tbw2 = np.linalg.inv(kf2.Twb)
        Xb1 = np.stack([Tbw1[:3, :3] @ mp.position + Tbw1[:3, 3] for mp in mps1])
        Xb2 = np.stack([Tbw2[:3, :3] @ mp.position + Tbw2[:3, 3] for mp in mps2])
        obs1 = np.stack(uvs1)
        obs2 = np.stack(uvs2)
        cams1 = np.asarray(cams1, np.int32)
        cams2 = np.asarray(cams2, np.int32)
        w1 = np.asarray(ws1)
        w2 = np.asarray(ws2)
        Tcb_all = np.stack([np.linalg.inv(T) for T in self.rig.Tbc])
        # pow2-bucket the correspondence count as the reference does (its
        # shapes, so the two packages compare array for array). Padding rows
        # carry safe geometry (a point 5 m ahead) and valid=False.
        nb = 16
        while nb < n:
            nb *= 2

        def _padrows(a, fill_row):
            fill = np.tile(np.asarray(fill_row, a.dtype), (nb - n, 1) if a.ndim > 1 else (nb - n,))
            return np.concatenate([a, fill.reshape((nb - n,) + a.shape[1:])]) if nb > n else a

        principal = [self.rig.K[0][2], self.rig.K[0][3]]
        w1p = _padrows(w1, 1.0)
        w2p = _padrows(w2, 1.0)
        data = Sim3RansacData(
            Xb1=self._tensor(_padrows(Xb1, [0.0, 0.0, 5.0])),
            Xb2=self._tensor(_padrows(Xb2, [0.0, 0.0, 5.0])),
            obs1=self._tensor(_padrows(obs1, principal)),
            obs2=self._tensor(_padrows(obs2, principal)),
            cam1=self._index(_padrows(cams1, 0)),
            cam2=self._index(_padrows(cams2, 0)),
            max_err1=self._tensor(9.21 / w1p),
            max_err2=self._tensor(9.21 / w2p),
            valid=self._flag(np.arange(nb) < n),
            K1=self._tensor(self.rig.K),
            K2=self._tensor(self.rig.K),
            Tc1b=self._tensor(Tcb_all),
            Tc2b=self._tensor(Tcb_all),
            fix_scale=self._flag(self.fix_scale),
        )
        H = 32
        samples = np.stack([self._rng.choice(n, 3, replace=False) for _ in range(H)])
        (s, R, t), inl, n_best, _ = sim3_ransac(data, self._index(samples))
        # one device-to-host read for the whole RANSAC result
        s, R, t, inl, n_best = convert.fetch(s, R, t, inl, n_best, dtype=self.dtype)
        if int(n_best) < max(6, self.min_matches // 2):
            return None, 0, None

        # SearchBySim3 densification (ORBmatcher::SearchBySim3 via
        # LoopClosing.cc:581-597): project each side's full point set through
        # the RANSAC Sim3 and admit mutually consistent extra pairs before
        # the final refinement.
        valid = inl[:n].astype(bool)
        seen_pairs = {(m1.id, m2.id) for m1, m2 in zip(mps1, mps2)}
        full1 = self._kf_points(kf1)
        full2 = self._kf_points(kf2)
        if len(full1[0]) >= 3 and len(full2[0]) >= 3:
            fXb1 = np.stack([Tbw1[:3, :3] @ mp.position + Tbw1[:3, 3] for mp in full1[0]])
            fXb2 = np.stack([Tbw2[:3, :3] @ mp.position + Tbw2[:3, 3] for mp in full2[0]])
            didx = matcher.search_by_sim3(
                fXb1, np.asarray(full1[1], np.int32), np.stack(full1[2]), np.stack(full1[4]),
                fXb2, np.asarray(full2[1], np.int32), np.stack(full2[2]), np.stack(full2[4]),
                float(s), R, t, Tcb_all, np.asarray(self.rig.K), device=self.device,
            )
            ex1, ex2, exc1, exc2, exu1, exu2, exw1, exw2 = ([] for _ in range(8))
            for i, j in enumerate(didx):
                if j < 0:
                    continue
                key = (full1[0][i].id, full2[0][int(j)].id)
                if key in seen_pairs:
                    continue
                seen_pairs.add(key)
                ex1.append(fXb1[i]); ex2.append(fXb2[int(j)])  # noqa: E702
                exc1.append(full1[1][i]); exc2.append(full2[1][int(j)])  # noqa: E702
                exu1.append(full1[2][i]); exu2.append(full2[2][int(j)])  # noqa: E702
                exw1.append(full1[3][i]); exw2.append(full2[3][int(j)])  # noqa: E702
            if ex1:
                Xb1 = np.concatenate([Xb1, np.stack(ex1)])
                Xb2 = np.concatenate([Xb2, np.stack(ex2)])
                obs1 = np.concatenate([obs1, np.stack(exu1)])
                obs2 = np.concatenate([obs2, np.stack(exu2)])
                cams1 = np.concatenate([cams1, np.asarray(exc1, np.int32)])
                cams2 = np.concatenate([cams2, np.asarray(exc2, np.int32)])
                w1 = np.concatenate([w1, np.asarray(exw1)])
                w2 = np.concatenate([w2, np.asarray(exw2)])
                valid = np.concatenate([valid, np.ones(len(ex1), bool)])

        # refinement with paired reprojection edges in the observing cameras
        X1c = np.einsum("nij,nj->ni", Tcb_all[cams1, :3, :3], Xb1) + Tcb_all[cams1, :3, 3]
        X2c = np.einsum("nij,nj->ni", Tcb_all[cams2, :3, :3], Xb2) + Tcb_all[cams2, :3, 3]
        # pow2-bucket the (densified) pair count, as for the RANSAC data
        m = len(X1c)
        mb = 16
        while mb < m:
            mb *= 2

        def _padp(a, fill_row):
            if mb == m:
                return a
            fill = np.tile(np.asarray(fill_row, a.dtype), (mb - m, 1) if a.ndim > 1 else (mb - m,))
            return np.concatenate([a, fill.reshape((mb - m,) + a.shape[1:])])

        pair = Sim3PairData(
            X1=self._tensor(_padp(X1c, [0.0, 0.0, 5.0])),
            X2=self._tensor(_padp(X2c, [0.0, 0.0, 5.0])),
            obs1=self._tensor(_padp(obs1, principal)),
            obs2=self._tensor(_padp(obs2, principal)),
            cam1=self._index(_padp(cams1, 0)),
            cam2=self._index(_padp(cams2, 0)),
            w1=self._tensor(_padp(w1, 1.0)),
            w2=self._tensor(_padp(w2, 1.0)),
            valid=self._flag(np.concatenate([valid, np.zeros(mb - m, bool)])),
            K1=self._tensor(self.rig.K),
            K2=self._tensor(self.rig.K),
            Tc1b=self._tensor(Tcb_all),
            Tc2b=self._tensor(Tcb_all),
            fix_scale=self._flag(self.fix_scale),
        )
        S0 = Sim3(s=self._tensor(s), R=self._tensor(R), t=self._tensor(t))
        S12, n_inl, inlier = optimize_sim3(pair, S0, 10.0)
        # one read; correct_loop reads the S12 fields on the host
        s, R, t, n_inl, inlier = convert.fetch(*S12, n_inl, inlier, dtype=self.dtype)
        return Sim3(s=s, R=R, t=t), int(n_inl), inlier.astype(bool)

    # ------------------------------------------------------------------
    def correct_loop(self, kf: KeyFrame, loop_kf: KeyFrame, S12: Sim3):
        """CorrectLoop (LoopClosing.cc:805-1206): propagate the corrected
        Sim3 to covisible KFs + landmarks, then essential-graph optimize."""
        # a newer loop kills any global BA still running for the previous
        # one (LoopClosing.cc:814-829: mbStopGBA=true, mnFullBAIdx++, thread
        # detached: its result is discarded on the idx check)
        if self.running_gba:
            with self._gba_lock:
                self.gba_abort.set()
                self.full_ba_idx += 1
        # S12 aligns loop-KF body coords into CURRENT-KF body coords
        # (Xb_cur = S12 . Xb_loop, from the Horn/OptimizeSim3 data layout).
        # A physical point X_w = T_loop . Xb_loop must also equal
        # T_cur_corrected . Xb_cur, so T_cur_corrected = T_loop . S12^-1
        # with the scale folded into the translation.
        s = float(S12.s)
        R12 = np.asarray(S12.R)
        t12 = np.asarray(S12.t)
        T12_inv = np.eye(4)
        T12_inv[:3, :3] = R12.T
        T12_inv[:3, 3] = -R12.T @ t12 / max(s, 1e-9)
        T_cur_corrected = loop_kf.Twb @ T12_inv
        delta = T_cur_corrected @ np.linalg.inv(kf.Twb)

        # propagate to current KF + covisible neighborhood; correct landmarks
        corrected = {kf.id} | set(kf.covisibility)
        moved_points = set()
        for kf_id in corrected:
            k = self.map.keyframes.get(kf_id)
            if k is None:
                continue
            k.set_pose(delta @ k.Twb)
            for mp_id in k.matches:
                if mp_id < 0 or int(mp_id) in moved_points:
                    continue
                mp = self.map.map_points.get(int(mp_id))
                if mp is None:
                    continue
                mp.position = delta[:3, :3] @ mp.position + delta[:3, 3]
                moved_points.add(int(mp_id))

        # record the loop edge with its measured relative (post-propagation):
        # meas C for add_edge(a=other, b=this) is S_this @ S_other^-1; prior
        # loop edges are re-added in every later essential graph
        # (Optimizer.cc:1540-1560 spLoopEdges handling)
        C = np.linalg.inv(kf.Twb) @ loop_kf.Twb
        kf.loop_edges.append((loop_kf.id, C))
        loop_kf.loop_edges.append((kf.id, np.linalg.inv(C)))
        self._essential_graph(kf, loop_kf)
        self._search_and_fuse(kf, loop_kf)
        if self.run_global_ba:
            if self.detached_gba:
                self._launch_global_ba()
            else:
                self._run_global_ba()
        self.map.increase_change_index()
        self.loops_closed += 1

    def _search_and_fuse(self, kf: KeyFrame, loop_kf: KeyFrame) -> int:
        """SearchAndFuse (LoopClosing.cc:1053-1100): project loop-side map
        points into the corrected current-side keyframes; merge duplicates,
        keeping the loop-side (established) point."""
        loop_kfs = [loop_kf] + [
            self.map.keyframes[i]
            for i in loop_kf.best_covisible(10)
            if i in self.map.keyframes
        ]
        loop_mps, seen = [], set()
        for lk in loop_kfs:
            for mp_id in lk.matches:
                if mp_id < 0 or int(mp_id) in seen:
                    continue
                mp = self.map.map_points.get(int(mp_id))
                if mp is None or mp.bad or mp.descriptor is None:
                    continue
                seen.add(int(mp_id))
                loop_mps.append(mp)
        if not loop_mps:
            return 0
        pos = np.stack([mp.position for mp in loop_mps])
        desc = np.stack([mp.descriptor for mp in loop_mps])
        cur_kfs = [kf] + [
            self.map.keyframes[i]
            for i in kf.best_covisible(10)
            if i in self.map.keyframes
        ]
        from .local_mapping import camera_Twc

        fused = 0
        for ck in cur_kfs:
            for cam in range(self.rig.n_cams):
                if len(ck.keypoints[cam]) == 0:
                    continue
                Tcw = np.linalg.inv(camera_Twc(ck, cam, self.rig))
                idx = matcher.search_by_projection(
                    pos, desc, ck.keypoints[cam], ck.descriptors[cam],
                    ck.kp_octaves[cam], Tcw, self.rig.K[cam], radius=4.0,
                    max_dist=matcher.TH_LOW, device=self.device,
                )
                for mi, ki in enumerate(idx):
                    if ki < 0:
                        continue
                    g = ck.global_index(cam, int(ki))
                    cur_id = int(ck.matches[g])
                    mp = loop_mps[mi]
                    if mp.bad:
                        continue
                    if cur_id < 0:
                        ck.matches[g] = mp.id
                        mp.add_observation(ck, cam, g)
                        fused += 1
                    elif cur_id != mp.id and cur_id in self.map.map_points:
                        other = self.map.map_points[cur_id]
                        for kf_id, slots in list(other.observations.items()):
                            okf = self.map.keyframes.get(kf_id)
                            if okf is None:
                                continue
                            for c, gi in enumerate(slots):
                                if gi >= 0:
                                    okf.matches[gi] = mp.id
                                    mp.add_observation(okf, c, int(gi))
                        self.map.erase_map_point(other)
                        fused += 1
        return fused

    def _run_global_ba(self, num_iterations: int = 10):
        """RunGlobalBundleAdjustment (LoopClosing.cc:1206-1339): full-map BA
        after the essential graph; write-back is staged (apply_global_ba
        propagates to keyframes created while the BA ran)."""
        if self.map.n_keyframes() < 3:
            return
        data, state, handles = extraction.extract_global_ba(
            self.map, self.rig, device=self.device, dtype=self.dtype)
        new_state, stats = ba.global_ba(data, state, num_iterations)
        if not np.isfinite(float(stats.chi2)):
            return
        extraction.apply_global_ba(new_state, handles, self.map)
        self.n_gba_applied += 1

    # ------------------------------------------------------------------
    def _launch_global_ba(self, num_iterations: int = 10):
        """Start RunGlobalBundleAdjustment on its own thread
        (LoopClosing.cc:1036-1044: mbRunningGBA=true, mbStopGBA=false,
        mpThreadGBA = new thread). Tracking and local mapping keep running;
        the write-back is staged under the map mutex on completion."""
        if self.map.n_keyframes() < 3:
            return
        with self._gba_lock:
            self.gba_abort.clear()
            self.running_gba = True
            idx = self.full_ba_idx
        self.gba_thread = threading.Thread(
            target=self._gba_worker, args=(idx, num_iterations), daemon=True
        )
        self.gba_thread.start()

    def _gba_worker(self, idx: int, num_iterations: int):
        """RunGlobalBundleAdjustment (LoopClosing.cc:1206-1339): snapshot
        the map under its mutex, solve WITHOUT the lock (tracking/mapping
        stay live, possibly inserting keyframes), poll the stop flag between
        LM segments, and, only if neither aborted nor superseded
        (idx == mnFullBAIdx, :1245-1249), re-acquire the map mutex and
        apply the staged write-back, which propagates the correction to
        keyframes created while the BA ran (apply_global_ba's prev-chain
        walk = the reference's mTbwGBA spanning-tree pass, :1266-1330). An
        exception is kept in `gba_error` for the caller."""
        try:
            with self.map.mutex:
                if self.map.n_keyframes() < 3:
                    return
                data, state, handles = extraction.extract_global_ba(
                    self.map, self.rig, device=self.device, dtype=self.dtype)
            new_state, stats, aborted = ba.global_ba_interruptible(
                data, state, num_iterations,
                should_abort=lambda: (
                    self.gba_abort.is_set() or idx != self.full_ba_idx
                ),
            )
            if aborted or self.gba_abort.is_set() or idx != self.full_ba_idx:
                self.n_gba_aborted += 1
                return
            if not np.isfinite(float(stats.chi2)):
                return
            with self.map.mutex:
                with self._gba_lock:
                    if idx != self.full_ba_idx:
                        self.n_gba_aborted += 1
                        return
                extraction.apply_global_ba(new_state, handles, self.map)
                self.map.increase_change_index()
                self.n_gba_applied += 1
        except Exception as e:  # reported to the caller's thread
            self.gba_error = e
        finally:
            with self._gba_lock:
                if idx == self.full_ba_idx:
                    self.running_gba = False

    def raise_gba_error(self):
        if self.gba_error is not None:
            raise RuntimeError("the detached global BA failed") from self.gba_error

    def join_gba(self, timeout: float | None = None):
        """Block until the detached GBA (if any) finishes (shutdown and the
        deterministic test sync point; the reference only ever detaches),
        then raise what it raised, if anything."""
        t = self.gba_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self.raise_gba_error()

    def _essential_graph(self, kf: KeyFrame, loop_kf: KeyFrame):
        """OptimizeEssentialGraph over S_cw vertices: spanning/temporal chain
        + covisibility + loop edges (Optimizer.cc:1434-1717)."""
        kfs = sorted(self.map.keyframes.values(), key=lambda k: k.timestamp)
        slot = {k.id: i for i, k in enumerate(kfs)}
        N = len(kfs)
        s = np.ones(N)
        R = np.stack([np.linalg.inv(k.Twb)[:3, :3] for k in kfs])
        t = np.stack([np.linalg.inv(k.Twb)[:3, 3] for k in kfs])

        pairs, meas = [], []

        def add_edge(a: KeyFrame, b: KeyFrame):
            Sa = np.linalg.inv(a.Twb)
            Sb = np.linalg.inv(b.Twb)
            # meas C with residual log(C S_a S_b^-1): C = S_b S_a^-1
            C = Sb @ np.linalg.inv(Sa)
            pairs.append((slot[a.id], slot[b.id]))
            meas.append(C)

        # temporal chain
        for a, b in zip(kfs[:-1], kfs[1:]):
            add_edge(a, b)
        # covisibility edges (weight >= 100, minFeat)
        for k in kfs:
            for nb_id, w in k.covisibility.items():
                if w >= 100 and nb_id in slot and nb_id > k.id:
                    add_edge(k, self.map.keyframes[nb_id])
        # loop edges: the current one AND every prior closure's, each with
        # the relative measured at its own correction time
        # (Optimizer.cc:1540-1560)
        done = set()
        for k in kfs:
            for other_id, C in k.loop_edges:
                pair_key = frozenset((k.id, other_id))
                if other_id not in slot or pair_key in done:
                    continue
                done.add(pair_key)
                pairs.append((slot[other_id], slot[k.id]))
                meas.append(C)

        # pow2-bucket both the pose and the edge counts as the reference does
        E, N_real = len(pairs), N
        Nb, Eb = bucket_pow2(N_real), bucket_pow2(E)
        s = np.concatenate([s, np.ones(Nb - N_real)])
        R = np.concatenate([R, np.tile(np.eye(3), (Nb - N_real, 1, 1))])
        t = np.concatenate([t, np.zeros((Nb - N_real, 3))])
        fixed = np.array([k.id == loop_kf.id for k in kfs])
        fixed = np.concatenate([fixed, np.ones(Nb - N_real, bool)])
        pairs_a = np.concatenate(
            [np.array(pairs, np.int64).reshape(-1, 2), np.zeros((Eb - E, 2), np.int64)]
        )
        meas_R = np.concatenate(
            [np.stack([m[:3, :3] for m in meas]), np.tile(np.eye(3), (Eb - E, 1, 1))]
        )
        meas_t = np.concatenate([np.stack([m[:3, 3] for m in meas]), np.zeros((Eb - E, 3))])
        data = EssentialGraphData(
            pairs=self._index(pairs_a),
            meas_s=self._tensor(np.ones(Eb)),
            meas_R=self._tensor(meas_R),
            meas_t=self._tensor(meas_t),
            valid=self._flag(np.arange(Eb) < E),
            fixed=self._flag(fixed),
            fix_scale=self._flag(self.fix_scale),
        )
        state = Sim3Field(s=self._tensor(s), R=self._tensor(R), t=self._tensor(t))
        out, _ = optimize_essential_graph(data, state)
        # recover SE3: T_wb = inv(S_cw) with translation /s (Optimizer.cc:1669-1683)
        s_o, R_o, t_o = convert.fetch(out.s, out.R, out.t, dtype=self.dtype)
        for i, k in enumerate(kfs):
            Scw = np.eye(4)
            Scw[:3, :3] = R_o[i]
            Scw[:3, 3] = t_o[i] / max(s_o[i], 1e-9)
            old_Twb = k.Twb
            k.set_pose(np.linalg.inv(Scw))
            # re-map this KF's landmarks through the correction
            delta = k.Twb @ np.linalg.inv(old_Twb)
            for mp_id in k.matches:
                mp = self.map.map_points.get(int(mp_id)) if mp_id >= 0 else None
                if mp is not None and mp.first_kf_id == k.id:
                    mp.position = delta[:3, :3] @ mp.position + delta[:3, 3]
