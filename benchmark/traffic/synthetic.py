"""The benchmark's data generators, in numpy alone.

Copies of the port's `utils/synthetic.make_sequence` (the multi-camera
keypoint drive) and `make_local_ba_problem_numpy` (the windowed / global BA
problem), with their per-landmark and per-keyframe loops vectorised, every
draw taken from one `numpy.random.Generator` seeded by the run's `--seed`,
and the rig read from the configuration instead of drawn. What depends on
the seed is the scene (landmark positions, descriptors, noise, the drifted
start); the sizes and the trajectory are the same for every seed, so every
seed asks for the same work.

Nothing here imports the program: the program receives the arrays, and the
references under `benchmark/reference/` read the same arrays.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.lie import exp_se3, rigid_inv


def rig_arrays(rig: dict):
    """(Tbc (C,4,4), K (C,4), bf, time offsets (C,)) from a configuration's
    `rig` group."""
    return (np.asarray(rig["Tbc"], np.float64), np.asarray(rig["K"], np.float64),
            float(rig["bf"]), np.asarray(rig["cam_time_offsets"], np.float64))


def drive_poses(n_frames: int, fps: float, twist, wiggle, wiggle_rate: float):
    """Body poses of the drive: the twist `twist` (body frame, per second)
    plus `sin(wiggle_rate * k) * wiggle` at frame k, integrated frame by
    frame. Returns (poses (N,4,4), per-frame twists (N,6))."""
    dt = 1.0 / fps
    k = np.arange(n_frames)
    vk = np.asarray(twist, np.float64) + np.sin(wiggle_rate * k)[:, None] * np.asarray(wiggle)
    vk[0] = twist
    steps = exp_se3(vk * dt)
    Ts = np.empty((n_frames, 4, 4))
    Ts[0] = np.eye(4)
    for i in range(1, n_frames):
        Ts[i] = Ts[i - 1] @ steps[i]
    return Ts, vk


def keypoint_drive(rig: dict, mix: dict, seed: int) -> dict:
    """The multi-camera keypoint drive of `make_sequence`, vectorised.

    `lm_per_frame` landmarks are anchored at every frame of the drive, each
    uniform in a box ahead of the stereo camera at that frame; every camera
    of every frame sees the landmarks that project inside its image at
    depth >= `min_depth`, with Gaussian pixel noise; the stereo camera has a
    depth (and right-image u) on a `stereo_depth_frac` share of its points.
    Each landmark has a unique random 256-bit descriptor, so descriptor
    matching is exact. Keypoints of a camera are in increasing landmark
    order, as in the original.

    Returns {"poses" (N,4,4) ground-truth body poses, "times" (N,),
    "landmarks" (L,3), "descriptors" (L,32) uint8, "frames": per frame
    {"timestamp", "cam_times" (C,), "keypoints" [C x (n,2)], "landmark_ids"
    [C x (n,)], "descriptors" [C x (n,32)], "ur" (n_s,), "depth" (n_s,)}}.
    """
    rng = np.random.default_rng(seed)
    Tbc, K, bf, offsets = rig_arrays(rig)
    C = len(K)
    W, H = rig["image_size"]
    n = int(mix["n_frames"])
    fps = float(mix["fps"])
    Ts, vk = drive_poses(n, fps, mix["twist"], mix["wiggle"], mix["wiggle_rate"])

    lo, hi = np.asarray(mix["landmark_box_min"]), np.asarray(mix["landmark_box_max"])
    anchor = np.repeat(np.arange(n), int(mix["lm_per_frame"]))
    L = anchor.size
    Xc0 = lo + (hi - lo) * rng.random((L, 3))
    Twc = Ts[anchor] @ Tbc[-1]
    X = np.einsum("lij,lj->li", Twc[:, :3, :3], Xc0) + Twc[:, :3, 3]
    descs = rng.integers(0, 256, (L, 32), dtype=np.uint8)
    if len(np.unique(descs.view(np.dtype((np.void, 32))))) != L:
        raise ValueError("two landmarks drew one descriptor; use another seed")

    noise = float(mix["noise_px"])
    frac = float(mix["stereo_depth_frac"])
    zmin = float(mix["min_depth"])
    # per camera: the body pose at the camera's time within the frame, at the
    # frame's own twist (constant within a frame)
    Twb_c = Ts[:, None] @ exp_se3(vk[:, None, :] * offsets[None, :, None])  # (N,C,4,4)
    Tcw = rigid_inv(Twb_c @ Tbc[None])
    frames = []
    for k in range(n):
        kps, ids, ds = [], [], []
        ur = depth = None
        for c in range(C):
            Xc = X @ Tcw[k, c, :3, :3].T + Tcw[k, c, :3, 3]
            z = Xc[:, 2]
            zs = np.where(z > 0, z, 1.0)
            u = K[c, 0] * Xc[:, 0] / zs + K[c, 2]
            v = K[c, 1] * Xc[:, 1] / zs + K[c, 3]
            sel = np.nonzero((z >= zmin) & (u >= 0) & (u < W) & (v >= 0) & (v < H))[0]
            uv = np.stack([u[sel], v[sel]], 1) + noise * rng.standard_normal((sel.size, 2))
            kps.append(uv)
            ids.append(sel)
            ds.append(descs[sel])
            if c == C - 1:
                has_d = rng.random(sel.size) < frac
                ur = np.where(has_d, uv[:, 0] - bf / z[sel], -1.0)
                depth = np.where(has_d, z[sel], -1.0)
        frames.append({"timestamp": k / fps, "cam_times": k / fps + offsets,
                       "keypoints": kps, "landmark_ids": ids, "descriptors": ds,
                       "ur": ur, "depth": depth})
    return {"poses": Ts, "times": np.arange(n) / fps, "landmarks": X,
            "descriptors": descs, "frames": frames}


def map_problem(rig: dict, mp: dict, seed: int) -> dict:
    """The windowed-BA problem of `make_local_ba_problem_numpy` (keyframes on
    a smooth trajectory, landmarks seen by the stereo camera at keyframe
    times and by the async cameras between keyframes, at per-camera phases
    within `frames_per_interval` slots), as raw observations.

    Returns float64 / int64 arrays: "times" (K,), "gt_T" (K,4,4), "gt_v"
    (K,6), "gt_X" (L,3), the drifted start "T0", "v0", "X0", stereo-camera
    observations "st_pose", "st_lm", "st_obs" (Es,3: u, v, right u or -1),
    "st_is_stereo", async-camera observations "mg_pair" (Em,2), "mg_lm",
    "mg_cam", "mg_t", "mg_obs" (Em,2), and "n_fixed", "kf_dt".
    """
    rng = np.random.default_rng(seed)
    Tbc, K, bf, _ = rig_arrays(rig)
    C = len(K)
    Cx = C - 1
    n_kf, n_lm = int(mp["n_kf"]), int(mp["n_lm"])
    kf_dt = float(mp["kf_dt"])
    noise = float(mp["noise_px"])
    times = np.arange(n_kf) * kf_dt

    # smooth trajectory: a slowly varying twist
    k = np.arange(n_kf)
    vs = np.asarray(mp["twist"]) + np.sin(mp["wiggle_rate"] * k)[:, None] * np.asarray(mp["wiggle"])
    steps = exp_se3(vs * kf_dt)
    Ts = np.empty((n_kf, 4, 4))
    Ts[0] = exp_se3(0.1 * rng.standard_normal(6))
    for i in range(1, n_kf):
        Ts[i] = Ts[i - 1] @ steps[i - 1]

    # landmarks: spread evenly over the keyframes, ahead of the stereo camera
    anchor = np.arange(n_lm) % n_kf
    lo, hi = np.asarray(mp["landmark_box_min"]), np.asarray(mp["landmark_box_max"])
    Xc0 = lo + (hi - lo) * rng.random((n_lm, 3))
    Twc_a = Ts[anchor] @ Tbc[-1]
    X = np.einsum("lij,lj->li", Twc_a[:, :3, :3], Xc0) + Twc_a[:, :3, 3]

    # stereo-camera observations on a window of keyframes around the anchor
    w2 = int(mp["obs_per_lm"]) // 2
    offs = np.arange(-w2, w2 + 1)
    k_mat = anchor[:, None] + offs[None, :]
    in_range = (k_mat >= 0) & (k_mat < n_kf)
    k_clip = np.clip(k_mat, 0, n_kf - 1)
    Tcw = rigid_inv(Ts[k_clip] @ Tbc[-1])
    Xc = np.einsum("lwij,lj->lwi", Tcw[..., :3, :3], X) + Tcw[..., :3, 3]
    vis = in_range & (Xc[..., 2] > mp["min_depth"])
    zs = np.where(Xc[..., 2] > 0, Xc[..., 2], 1.0)
    u_true = K[-1, 0] * Xc[..., 0] / zs + K[-1, 2]
    u = u_true + noise * rng.standard_normal(k_mat.shape)
    v = K[-1, 1] * Xc[..., 1] / zs + K[-1, 3] + noise * rng.standard_normal(k_mat.shape)
    is_st = rng.random(k_mat.shape) < mp["stereo_frac"]
    ur = np.where(is_st, u_true - bf / zs + noise * rng.standard_normal(k_mat.shape), -1.0)
    sel = vis.ravel()
    lm_mat = np.broadcast_to(np.arange(n_lm)[:, None], k_mat.shape)
    st_pose = k_clip.ravel()[sel]
    st_lm = lm_mat.ravel()[sel]
    st_obs = np.stack([u.ravel()[sel], v.ravel()[sel], ur.ravel()[sel]], 1)
    st_is_stereo = is_st.ravel()[sel]

    # async-camera observations between keyframes (anchor - 1, anchor)
    rep = np.repeat(np.arange(n_lm), int(mp["gpobs_per_lm"]))
    kk = anchor[rep]
    ok = kk > 0
    rep, kk = rep[ok], kk[ok]
    M = rep.size
    cc = rng.integers(0, Cx, M)
    F = int(mp["frames_per_interval"])
    slot = rng.integers(0, F, M)
    tt = times[kk - 1] + ((slot + (cc + 1.0) / C) / F) * kf_dt
    Twb_t = Ts[kk - 1] @ exp_se3(vs[kk - 1] * (tt - times[kk - 1])[:, None])
    Tcw_m = rigid_inv(Twb_t @ Tbc[cc])
    Xcm = np.einsum("mij,mj->mi", Tcw_m[:, :3, :3], X[rep]) + Tcw_m[:, :3, 3]
    vism = Xcm[:, 2] > mp["min_depth"]
    zm = np.where(Xcm[:, 2] > 0, Xcm[:, 2], 1.0)
    um = K[cc, 0] * Xcm[:, 0] / zm + K[cc, 2] + noise * rng.standard_normal(M)
    vm = K[cc, 1] * Xcm[:, 1] / zm + K[cc, 3] + noise * rng.standard_normal(M)

    # the drifted start: every free keyframe and every landmark perturbed
    n_fixed = int(mp["n_fixed"])
    dT = np.asarray(mp["drift_pose"]) * rng.standard_normal((n_kf, 6))
    dT[:n_fixed] = 0.0
    T0 = Ts @ exp_se3(dT)
    v0 = vs + mp["drift_vel"] * rng.standard_normal((n_kf, 6))
    v0[:n_fixed] = vs[:n_fixed]
    X0 = X + mp["drift_landmark"] * rng.standard_normal((n_lm, 3))
    return {
        "times": times, "kf_dt": kf_dt, "n_fixed": n_fixed,
        "gt_T": Ts, "gt_v": vs, "gt_X": X, "T0": T0, "v0": v0, "X0": X0,
        "st_pose": st_pose, "st_lm": st_lm, "st_obs": st_obs, "st_is_stereo": st_is_stereo,
        "mg_pair": np.stack([kk - 1, kk], 1)[vism], "mg_lm": rep[vism], "mg_cam": cc[vism],
        "mg_t": tt[vism], "mg_obs": np.stack([um, vm], 1)[vism],
    }
