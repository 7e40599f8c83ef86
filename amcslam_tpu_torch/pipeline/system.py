"""System facade (rebuild of src/System.cc): wiring, per-tick entry point,
trajectory savers, atlas checkpoint/resume.

Port of `amcslam_tpu/pipeline/system.py`: the sequential schedule (track
-> drain the local mapper -> drain the loop closer) and the threaded one
(mapper and closer on a background thread, serialized against tracking by
the active map's mutex: per stage for the mapper, around each `run_once`
for the closer, whose global BA then runs detached on a thread of its own).
Tracking, local mapping and loop closing run their solves on the System's
explicit `device` in its `dtype`; every thread uses the device's default
stream. An exception in the background thread or in the detached global BA
is raised to the caller by the next `track_multicamera` and by `shutdown`.
The reference's XLA cache clearing is not ported (nothing here compiles per
shape).
"""

from __future__ import annotations

import hashlib
import os as _os
import pickle
import threading

import numpy as np
import torch

from ..utils.timing import GLOBAL_TIMER
from .extraction import preset_shape_buckets
from .keyframe_database import KeyFrameDatabase
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .map_store import Atlas, Frame
from .rig import Rig
from .tracking import Tracking, TrackingConfig, TrackState, resolve_device


class System:
    def __init__(
        self,
        rig: Rig,
        tracking_config: TrackingConfig | None = None,
        enable_loop_closing: bool = True,
        b_extrinsic: bool = False,
        threaded: bool = False,
        *,
        device,
        dtype=torch.float32,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.rig = rig
        self.atlas = Atlas()
        self.kfdb = KeyFrameDatabase()
        # threaded mode gets the reference's interruption semantics: a
        # detached abortable global BA (LoopClosing.cc:1036-1044) and the
        # mbAbortBA force-stop on the local BA (LocalMapping.cc:215); the
        # sequential schedule stays synchronous and deterministic.
        self.loop_closer = (
            LoopClosing(rig, self.atlas.active, self.kfdb, detached_gba=threaded,
                        device=self.device, dtype=dtype)
            if enable_loop_closing
            else None
        )
        self.local_mapper = LocalMapping(
            rig, self.atlas.active, b_extrinsic=b_extrinsic,
            loop_closer=self.loop_closer, interruptible=threaded,
            device=self.device, dtype=dtype,
        )
        self.tracker = Tracking(
            rig, self.atlas, tracking_config, local_mapper=self.local_mapper,
            kfdb=self.kfdb, device=self.device, dtype=dtype,
        )
        self.threaded = threaded
        self._stop = False
        self._worker_error: Exception | None = None
        # the reference's serving-size shape buckets (fixed solver shapes);
        # AMCSLAM_NO_BUCKET_PRESET opts out, as in the reference
        if not _os.environ.get("AMCSLAM_NO_BUCKET_PRESET"):
            preset_shape_buckets()
        if threaded:
            self._worker = threading.Thread(target=self._background, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def track_multicamera(self, frame: Frame) -> TrackState:
        """System::TrackMultiCamera -> Tracking::GrabImageMultiCam.

        Threaded mode serializes tracking against the background mapper
        through the active map's `mutex` (the reference's mMutexMapUpdate,
        Map.h / Tracking.cc:1096)."""
        with GLOBAL_TIMER.span("sys.frame"):
            self._raise_worker_error()
            with self.atlas.active.mutex:
                state = self.tracker.grab_frame(frame)
            if not self.threaded:
                while self.local_mapper.run_once():
                    pass
                if self.loop_closer is not None:
                    while self.loop_closer.run_once():
                        pass
            return state

    def _background(self):
        import time

        try:
            while not self._stop:
                m = self.atlas.active
                # per-stage locking: the mapper takes the map mutex around each
                # map-mutating stage but releases it for the local-BA solve, so
                # tracking is never blocked for a device solve
                busy = self.local_mapper.run_once(lock=m.mutex)
                if self.loop_closer is not None:
                    with m.mutex:
                        busy = self.loop_closer.run_once() or busy
                if not busy:
                    time.sleep(0.002)
        except Exception as e:  # reported to the caller's thread
            self._worker_error = e

    def _raise_worker_error(self):
        if self._worker_error is not None:
            raise RuntimeError("the background mapper/loop closer failed") from self._worker_error
        if self.loop_closer is not None:
            self.loop_closer.raise_gba_error()

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode: tracking only, map frozen."""
        self.tracker.cfg.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.cfg.localization_only = False

    def shutdown(self):
        self._stop = True
        if self.threaded:
            self._worker.join(timeout=60)
            if self._worker.is_alive():
                raise RuntimeError("the background mapper did not stop within 60 s")
        if self.loop_closer is not None:
            self.loop_closer.join_gba(timeout=600)
        self._raise_worker_error()

    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        """SaveTrajectoryTUM (System.cc:393-460): recompose each frame's
        RELATIVE pose against its reference keyframe's current (loop-/GBA-
        corrected) pose; frames flagged lost are skipped (System.cc:400)."""
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for t, Twb in self.tracker.trajectory_poses():
                q = Rotation.from_matrix(Twb[:3, :3]).as_quat()  # x y z w
                p = Twb[:3, 3]
                f.write(
                    f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_keyframe_trajectory_tum(self, path: str):
        from scipy.spatial.transform import Rotation

        kfs = sorted(self.atlas.active.keyframes.values(), key=lambda k: k.timestamp)
        with open(path, "w") as f:
            for k in kfs:
                q = Rotation.from_matrix(k.Twb[:3, :3]).as_quat()
                p = k.Twb[:3, 3]
                f.write(
                    f"{k.timestamp:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_trajectory_euroc(self, path: str):
        """SaveTrajectoryEuRoC (System.cc:481-680): same loop-consistent
        recomposition as TUM, EuRoC convention — timestamps in nanoseconds,
        poses from the map with the most keyframes."""
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for t, Twb in self.tracker.trajectory_poses():
                q = Rotation.from_matrix(Twb[:3, :3]).as_quat()
                p = Twb[:3, 3]
                f.write(
                    f"{t * 1e9:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )

    def save_keyframe_trajectory_euroc(self, path: str):
        """SaveKeyFrameTrajectoryEuRoC (System.cc:850-897): keyframe poses
        of the biggest map, nanosecond timestamps."""
        from scipy.spatial.transform import Rotation

        maps = getattr(self.atlas, "maps", None) or [self.atlas.active]
        biggest = max(maps, key=lambda m: len(m.keyframes))
        kfs = sorted(biggest.keyframes.values(), key=lambda k: k.timestamp)
        with open(path, "w") as f:
            for k in kfs:
                if k.bad:
                    continue
                q = Rotation.from_matrix(k.Twb[:3, :3]).as_quat()
                p = k.Twb[:3, 3]
                f.write(
                    f"{k.timestamp * 1e9:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """SaveTrajectoryKITTI (System.cc:969-1020): per-frame 3x4 row-major
        pose matrices, re-expressed so the FIRST keyframe sits at the origin
        (after a loop closure it may not), frames recomposed against the
        corrected keyframe poses exactly as the TUM saver."""
        kfs = sorted(self.atlas.active.keyframes.values(), key=lambda k: k.id)
        T0 = kfs[0].Twb if kfs else np.eye(4)
        T0_inv = np.linalg.inv(T0)
        with open(path, "w") as f:
            for _, Twb in self.tracker.trajectory_poses():
                M = T0_inv @ Twb
                f.write(
                    " ".join(f"{M[r, c]:.9f}" for r in range(3) for c in range(4))
                    + "\n"
                )

    # ------------------------------------------------------------------
    def save_atlas(self, path: str):
        """SaveAtlas with md5 checksum (System.h:194-197, CalculateCheckSum).
        The file pickles the port's own classes."""
        payload = pickle.dumps(
            {"atlas": self.atlas, "trajectory": self.tracker.trajectory}
        )
        digest = hashlib.md5(payload).hexdigest()
        with open(path, "wb") as f:
            pickle.dump({"md5": digest, "payload": payload}, f)

    def load_atlas(self, path: str):
        """Load a file written by `save_atlas` (only files this program
        wrote: unpickling runs code). A checksum mismatch raises IOError."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if hashlib.md5(blob["payload"]).hexdigest() != blob["md5"]:
            raise IOError("atlas checksum mismatch")
        state = pickle.loads(blob["payload"])
        self.atlas = state["atlas"]
        self.tracker.atlas = self.atlas
        self.tracker.trajectory = state["trajectory"]
        self.local_mapper.map = self.atlas.active
        if self.loop_closer is not None:
            self.loop_closer.map = self.atlas.active
        # rebuild the retrieval database (PostLoad id remapping analog). As
        # in the reference, the tracker keeps the database it was built with
        # (ROADMAP §3 lists this).
        self.kfdb = KeyFrameDatabase()
        for kf in self.atlas.active.keyframes.values():
            self.kfdb.add(kf)
        if self.loop_closer is not None:
            self.loop_closer.kfdb = self.kfdb

    def reset_active_map(self):
        """ResetActiveMap chain (System.h:129-131)."""
        self.atlas.create_new_map()
        self.tracker.state = TrackState.NOT_INITIALIZED
        self.tracker.last_kf = None
        self.local_mapper.map = self.atlas.active
        self.local_mapper.queue.clear()
        self.local_mapper.recent_points.clear()
        if self.loop_closer is not None:
            self.loop_closer.map = self.atlas.active
            self.loop_closer.queue.clear()
