"""The plain reference of the keypoint drive: the ground truth that the
generator drew, and the comparisons that judge the System's outputs by it,
in numpy float64.

The System starts its map at the first frame's pose (the identity, as the
ground truth does) with metric depth from the stereo camera, so its poses
are in the ground truth's frame; they drift slowly. The numbers are local,
each free of the drift that accumulates before it. Compared exactly:

- `frames_not_ok`: window frames whose tracking state is not OK;
- `wrong_matches`: keyframe keypoints matched to a map point of another
  landmark (the descriptors are unique, so matching is exact);
- `false_loops`: loop edges between keyframes whose true positions are
  farther apart than `loop_radius_m`: the loop closer's decisions.

Compared against a limit: `kf_step_err_mm`, the RMS error of the motion
between consecutive keyframes of the window, which the local BA refines.
Reported beside them: the RMS error of each window frame's motion from the
frame before (`step_err_mm`, `step_err_mrad`), the median error of the
window's map points in the body frame of a keyframe that observes them
(`point_err_pct`), and the ATE. The pixel noise sets these more than the
arithmetic's precision does: a TF32 run moves them by 1.6-2.2x, too little
to set a limit between; it moves the keyframe steps by 3x and more.
"""

from __future__ import annotations

import numpy as np

from . import lie


def rel(Ta, Tb):
    return lie.rigid_inv(Ta) @ Tb


def step_errors(T_est, T_gt):
    """Per consecutive pair: (translation error (m), rotation error (rad)) of
    the estimated relative motion against the true one."""
    E, G = rel(T_est[:-1], T_est[1:]), rel(T_gt[:-1], T_gt[1:])
    dt = np.linalg.norm(E[:, :3, 3] - G[:, :3, 3], axis=1)
    dr = lie.rot_angle(E[:, :3, :3], G[:, :3, :3])
    return dt, dr


def rms(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt(np.mean(x * x))) if x.size else float("nan")


def ate(est_t, est_T, gt_t, gt_T) -> tuple[float, float]:
    """(RMSE of positions after a rigid alignment (m), path length (m)) for
    poses associated to the ground truth by timestamp."""
    idx = np.clip(np.searchsorted(gt_t, np.asarray(est_t) - 1e-6), 0, len(gt_t) - 1)
    P, G = np.asarray(est_T)[:, :3, 3], gt_T[idx, :3, 3]
    mu_p, mu_g = P.mean(0), G.mean(0)
    U, _, Vt = np.linalg.svd((P - mu_p).T @ (G - mu_g))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T
    err = np.linalg.norm((P - mu_p) @ R.T + mu_g - G, axis=1)
    path = float(np.linalg.norm(np.diff(gt_T[:, :3, 3], axis=0), axis=1).sum())
    return float(np.sqrt(np.mean(err ** 2))), path


def compare(gt: dict, out: dict, loop_radius_m: float) -> dict:
    """`gt`: the generator's drive. `out`: what the System produced —
    "frames": [(frame index, state, Twb)] of the window, with the frame
    before it first; "keyframes": [(frame index, Twb, matched landmark
    descriptors per keypoint (or None), map point positions per keypoint)]
    of the window, with the keyframe before it first; "loops": [(frame
    index, frame index)] of the loop edges; "trajectory": (times, poses)."""
    poses = gt["poses"]
    idx = np.array([k for k, _, _ in out["frames"]])
    T = np.stack([T for _, _, T in out["frames"]])
    dt, dr = step_errors(T, poses[idx])
    states = [s for _, s, _ in out["frames"][1:]]

    kfs = out["keyframes"]
    kidx = np.array([k for k, *_ in kfs])
    kT = np.stack([T for _, T, *_ in kfs]) if kfs else np.zeros((0, 4, 4))
    kdt = step_errors(kT, poses[kidx])[0] if len(kfs) > 1 else np.zeros(0)

    # map points in the observing keyframe's body frame, against the truth
    lut = {d.tobytes(): i for i, d in enumerate(gt["descriptors"])}
    errs, wrong = [], 0
    for k, Twb, descs, points in kfs[1:]:
        frame = gt["frames"][k]
        lm_of_kp = np.concatenate(frame["landmark_ids"])
        Tbw_est, Tbw_gt = lie.rigid_inv(Twb), lie.rigid_inv(poses[k])
        for g, (d, X) in enumerate(zip(descs, points)):
            if d is None:
                continue
            lm = lut.get(d.tobytes(), -1)
            if lm != lm_of_kp[g]:
                wrong += 1
                continue
            Xb_est = Tbw_est[:3, :3] @ X + Tbw_est[:3, 3]
            Xb_gt = Tbw_gt[:3, :3] @ gt["landmarks"][lm] + Tbw_gt[:3, 3]
            errs.append(np.linalg.norm(Xb_est - Xb_gt) / np.linalg.norm(Xb_gt))

    far = [1 for a, b in out["loops"]
           if np.linalg.norm(poses[a, :3, 3] - poses[b, :3, 3]) > loop_radius_m]
    t, Ts = out["trajectory"]
    ate_m, path = ate(t, Ts, gt["times"], poses)
    return {
        "frames_not_ok": float(sum(s != "OK" for s in states)),
        "step_err_mm": 1e3 * rms(dt),
        "step_err_mrad": 1e3 * rms(dr),
        "kf_step_err_mm": 1e3 * rms(kdt),
        "point_err_pct": 100 * float(np.median(errs)) if errs else float("nan"),
        "wrong_matches": float(wrong),
        "false_loops": float(len(far)),
        "step_err_max_mm": 1e3 * float(dt.max()) if dt.size else float("nan"),
        "points_checked": float(len(errs)), "keyframes_checked": float(len(kfs) - 1),
        "loops": float(len(out["loops"])),
        "ate_m": ate_m, "ate_pct_of_path": 100 * ate_m / path if path > 0 else float("nan"),
    }
