"""Traffic kind `keypoint_drive`: a closed-loop drive of synthetic keypoint
frames through the program's System.

Set-up draws the drive from the seed (`synthetic.keypoint_drive`), builds
the System as the configuration states it and the program's Frame of every
tick, and tracks the first `warm_frames` frames; the window continues the
System they built. A unit is one `System.track_multicamera(frame)` call,
from the Frame handed over to the state returned (the card synchronized):
tracking, and in the sequential schedule the local mapping and loop
closing it triggers. A frame fails when its state is not OK. The next
frame is submitted when the last returns; when the drive runs out the
window ends there.

The check compares, with the plain references under `benchmark/reference/`:

- `pose_opt_gap` (`pose.py`): for a sample of the window's frames drawn from
  the seed, the share of its last round's cost that one float64
  Gauss-Newton step from the pose the solve returned would still remove:
  the tracking solve's answer against the optimum of its own problem;
- `pose_inlier_flips` (`pose.py`): for the same frames, the edges whose
  inlier flag in the answer contradicts their chi2 at the returned pose
  (by more than a tenth of the threshold);
- `lba_opt_gap` (`ba_opt.py`): for a sample of the window's local BAs drawn
  from the seed (`check_local_bas` of them), the share
  of the cost at the state it wrote back that one float64 Gauss-Newton step
  would still remove: the local BA's answer against the optimum of its own
  problem;
- `lba_cost_gap` (`ba_cost.py`): for every local BA of the window, the
  largest relative gap between the chi2 it reports (at its start and at the
  state it wrote back) and the reference's cost of that state;
- `local_bas_not_ok`: local BAs whose divergence guard threw their answer
  away (none does on this traffic);
- `frames_not_ok`, `wrong_matches`, `false_loops` (`drive.py`): exact
  comparisons with the ground truth the generator drew;
- `kf_step_err_mm` (`drive.py`): the RMS error of the motion between the
  window's consecutive keyframes against the drawn trajectory: the map's
  keyframes against the truth, whatever the program's own problems were.

The problems of the pose solves and local BAs are the program's own (which
map points a frame matched, which keyframes a window holds): the references
follow the program from its state there, and recompute every number of the
cost from the raw observations and the rig. `drive.py` also reports the
accuracy against the ground truth (frame steps, map points, ATE).
"""

from __future__ import annotations

import gc

import numpy as np

from benchmark.reference import ba_cost, ba_opt, drive, pose
from benchmark.traffic import synthetic

LOOP_CLOSER_SPAN = "bench.loop_closer"


class Session:
    unit = "frame"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        import torch

        from amcslam_tpu_torch.pipeline import extraction
        from amcslam_tpu_torch.pipeline.map_store import Frame
        from amcslam_tpu_torch.pipeline.rig import Rig
        from amcslam_tpu_torch.pipeline.system import System
        from amcslam_tpu_torch.pipeline.tracking import TrackingConfig
        from amcslam_tpu_torch.solver import graphs

        self.torch, self.device = torch, torch.device(device)
        self.mix = mix
        rig = config["rig"]
        self.drive = synthetic.keypoint_drive(rig, mix, seed)
        Tbc, K, bf, offsets = synthetic.rig_arrays(rig)
        self.rig = Rig(Tbc=Tbc, K=K, bf=bf, cam_time_offsets=offsets,
                       qc_diag=np.asarray(rig["qc_diag"], np.float64),
                       ext_prior_info=np.tile(np.eye(3) * rig["ext_prior_info"], (len(K) - 1, 1, 1)))
        sysc = config["system"]
        self.dtype_name = sysc["dtype"]
        # a run starts as a fresh process does: no captured graphs (a graph
        # replays the arithmetic of its capture) and no shape high-water marks
        graphs.clear()
        extraction.reset_bucket_high_water()
        self.system = System(self.rig, TrackingConfig(),
                             enable_loop_closing=sysc["enable_loop_closing"],
                             threaded=sysc["threaded"], device=self.device,
                             dtype=getattr(torch, sysc["dtype"]))
        closer = self.system.loop_closer
        if closer is not None:
            # the loop closer's work on each keyframe (its queue drained by the
            # System after local mapping) has no span of its own in the
            # program: the benchmark times its calls into the closer
            from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER

            run_once = closer.run_once

            def timed_run_once():
                with GLOBAL_TIMER.span(LOOP_CLOSER_SPAN):
                    return run_once()

            closer.run_once = timed_run_once
        from amcslam_tpu_torch.pipeline import local_mapping, tracking

        self.graphs = graphs
        # the window's pose solves and local BAs, kept (by reference: each
        # call's problem and answer are fresh tensors) for the check
        self.capturing = False
        self.poses, self.lbas = [], []
        self._entries = [(tracking, "pose_gp_optimize"), (local_mapping, "local_gp_ba")]
        real_pose, real_lba = (getattr(m, n) for m, n in self._entries)

        def pose_solve(data, state, *args, **kw):
            out = real_pose(data, state, *args, **kw)
            if self.capturing:
                self.poses.append((data, out[0], out[1], out[2]))
            return out

        def local_ba(data, state, *args, **kw):
            res = real_lba(data, state, *args, **kw)
            if self.capturing:
                self.lbas.append((data, state, res))
            return res

        self._real = (real_pose, real_lba)
        tracking.pose_gp_optimize, local_mapping.local_gp_ba = pose_solve, local_ba
        self.seed = seed
        self.rig_ref = {"Tbc": Tbc, "K": K, "bf": bf, "qc": np.asarray(rig["qc_diag"], np.float64),
                        "ext_info": float(rig["ext_prior_info"])}
        self.frames = [
            Frame(timestamp=f["timestamp"], cam_times=f["cam_times"], Twb=np.eye(4),
                  velocity=np.zeros(6), keypoints=f["keypoints"],
                  kp_octaves=[np.zeros(len(k), np.int64) for k in f["keypoints"]],
                  descriptors=f["descriptors"], kp_ur=f["ur"], kp_depth=f["depth"])
            for f in self.drive["frames"]]
        self.next = 0
        self.warm_frames = int(mix["warm_frames"])
        self.tracked = []  # (frame index, state, Twb returned, keyframe created)

    def _track(self):
        k = self.next
        self.next += 1
        m = self.system.atlas.active
        n_kf = m.n_keyframes()
        state = self.system.track_multicamera(self.frames[k]).name
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        kf = self.system.atlas.active.n_keyframes() > n_kf
        self.tracked.append((k, state, np.array(self.frames[k].Twb, np.float64), kf))
        return state, kf

    def warm(self) -> None:
        for _ in range(self.warm_frames):
            self._track()

    def step(self) -> dict | None:
        if self.next >= len(self.frames):
            return None
        self.capturing = True
        captures = self.graphs.counts()["captures"]
        state, kf = self._track()
        return {"failed": state != "OK", "kf": kf,
                "captures": self.graphs.counts()["captures"] - captures}

    def summary(self, rec: dict) -> dict:
        units = rec["units"]
        window = self.drive["frames"][self.warm_frames:self.warm_frames + len(units)]
        kp = [len(k) for f in window for k in f["keypoints"]]
        ms = {flag: [u["ms"] for u in units if u["kf"] == flag] for flag in (True, False)}
        med = lambda x: float(np.median(x)) if x else None  # noqa: E731
        return {"frames_in_drive": len(self.frames), "warm_frames": self.warm_frames,
                "window_frames": len(units),
                "keypoints_per_camera": float(np.mean(kp)) if kp else None,
                "keyframe_share": len(ms[True]) / max(len(units), 1),
                "frame_ms_median": {"keyframe": med(ms[True]), "other": med(ms[False])},
                "frame_ms_p95": float(np.percentile([u["ms"] for u in units], 95))
                if units else None,
                "captures_at_frame": {i: u["captures"] for i, u in enumerate(units)
                                      if u["captures"]},
                "keyframes_in_map": self.system.atlas.active.n_keyframes(),
                "map_points": self.system.atlas.active.n_map_points()}

    def outputs(self) -> dict:
        """What the window produced, as plain arrays; then the System is shut
        down and freed."""
        fps = float(self.mix["fps"])
        index = lambda t: int(round(t * fps))  # noqa: E731
        w = self.warm_frames
        frames = [(k, s, T) for k, s, T, _ in self.tracked[max(w - 1, 0):]]
        m = self.system.atlas.active
        kfs = sorted((kf for kf in m.keyframes.values() if not kf.bad), key=lambda kf: kf.timestamp)
        first = [i for i, kf in enumerate(kfs) if index(kf.timestamp) >= w]
        keyframes = []
        for kf in kfs[max(first[0] - 1, 0):] if first else []:
            descs, points = [], []
            for mp_id in kf.matches:
                mp = m.map_points.get(int(mp_id)) if mp_id >= 0 else None
                ok = mp is not None and not mp.bad and mp.descriptor is not None
                descs.append(np.asarray(mp.descriptor) if ok else None)
                points.append(np.array(mp.position, np.float64) if ok else None)
            keyframes.append((index(kf.timestamp), np.array(kf.Twb, np.float64), descs, points))
        by_id = {kf.id: kf for kf in kfs}
        loops = [(index(kf.timestamp), index(by_id[o].timestamp))
                 for kf in kfs for o, _ in kf.loop_edges if o in by_id]
        traj = self.system.tracker.trajectory_poses()
        out = {"frames": frames, "keyframes": keyframes, "loops": loops,
               "trajectory": (np.array([t for t, _ in traj]), np.stack([T for _, T in traj]))}
        rng = np.random.default_rng(self.seed)
        n = int(self.mix["check_frames"])
        pick = sorted(rng.choice(len(self.poses), min(n, len(self.poses)), replace=False))
        out["poses"] = [pose_problem(*self.poses[i]) for i in pick]
        out["lbas"] = [lba_problem(*x) for x in self.lbas]
        m = int(self.mix["check_local_bas"])
        out["lba_sample"] = set(rng.choice(len(self.lbas), min(m, len(self.lbas)), replace=False)
                                .tolist())
        self.poses, self.lbas = [], []
        for (module, name), real in zip(self._entries, self._real):
            setattr(module, name, real)
        self.system.shutdown()
        self.system = None
        self.frames = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        out = self.outputs()
        numbers = drive.compare(self.drive, out, float(self.mix["loop_radius_m"]))
        rig = self.rig_ref
        gaps = [pose.optimality_gap(p, rig, T, v) for p, T, v in out["poses"]]
        numbers["pose_opt_gap"] = max(gaps, default=float("inf"))
        numbers["pose_opt_gap_median"] = float(np.median(gaps)) if gaps else float("inf")
        numbers["pose_inlier_flips"] = float(sum(pose.inlier_flips(p, rig, T, v)
                                                 for p, T, v in out["poses"]))
        lba, opt, not_ok = [], [], 0
        for i, (p, gp_huber, s_in, s_out, ok, err_initial, err_final) in enumerate(out["lbas"]):
            c0 = ba_cost.cost(p, rig, s_in, gp_huber)
            lba.append(abs(err_initial - c0) / c0)
            if not ok:
                not_ok += 1
                continue
            c1 = ba_cost.cost(p, rig, s_out, gp_huber)
            lba.append(abs(err_final - c1) / c1)
            if i in out["lba_sample"]:
                opt.append(ba_opt.optimality_gap(p, rig, s_out, gp_huber))
        numbers["lba_cost_gap"] = max(lba, default=float("inf"))
        numbers["lba_opt_gap"] = max(opt, default=float("inf"))
        numbers["lba_opt_gap_median"] = float(np.median(opt)) if opt else float("inf")
        numbers["local_bas_not_ok"] = float(not_ok)
        numbers.update(poses_checked=float(len(gaps)), local_bas_checked=float(len(out["lbas"])),
                       local_bas_opt_checked=float(len(opt)))
        return numbers


def _np(t):
    t = t.detach().cpu()
    return t.double().numpy() if t.is_floating_point() else t.numpy()


def pose_problem(data, state, lvl_m, lvl_s):
    """A pose solve's problem, with the inlier edges of the answer, and its
    answer, as numpy."""
    p = {k: _np(getattr(data, k)) for k in ("t_prev", "t_cur", "mg_obs", "mg_Xw", "mg_t",
                                            "mg_cam", "st_obs", "st_Xw", "st_is_stereo")}
    p["mg_valid"], p["st_valid"] = _np(data.mg_valid), _np(data.st_valid)
    p["mg_inlier"], p["st_inlier"] = _np(lvl_m), _np(lvl_s)
    p["mg_active"] = p["mg_valid"] & p["mg_inlier"]
    p["st_active"] = p["st_valid"] & p["st_inlier"]
    p["fix_prev"] = bool(data.fix_prev)
    return p, _np(state.T), _np(state.v)


LBA_FIELDS = ("times", "pose_fixed", "vel_valid", "gp_pairs", "gp_valid", "mg_pair", "mg_lm", "mg_cam",
              "mg_t", "mg_obs", "mg_valid", "sg_pair", "sg_lm", "sg_t", "sg_obs", "sg_valid",
              "st_pose", "st_lm", "st_obs", "st_valid", "st_is_stereo")


def lba_problem(data, state, res):
    """A local BA's problem (its window and observations), its input state
    and its result, as numpy."""
    p = {k: _np(getattr(data, k)) for k in LBA_FIELDS}
    as_dict = lambda s: dict(zip(("T", "v", "Text", "X"), (_np(t) for t in s)))  # noqa: E731
    return (p, bool(data.gp_huber), as_dict(state), as_dict(res.state), bool(res.ok),
            float(res.err_initial), float(res.err_final))
