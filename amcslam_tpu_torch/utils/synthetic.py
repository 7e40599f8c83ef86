"""Synthetic pose-solve, local-BA, sequence and loop problems (port of
`amcslam_tpu/utils/synthetic.py`: `_np_exp_se3`, `make_rig`,
`make_pose_problem`, `make_local_ba_problem`, `make_sequence`,
`make_vi_ba_synthetic`, `make_essential_graph`), and `build_loop_map`, a
copy of the reference's drifted-loop test map
(`tests/test_loop_closing.py:13-121`) on the port's map store.

The generator is the reference's numpy code, draw for draw from
`np.random.RandomState(seed)`, so for the same arguments it emits the same
arrays; only the final conversion differs (torch tensors on `device`, index
fields int64). No global RNG is touched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import ba_from_numpy, pose_from_numpy, pose_state_from_numpy, state_from_numpy
from ..solver.ba import build_interp_tables, make_landmark_tables, make_structure_ids


def _np_exp_se3(xi):
    from scipy.linalg import expm

    W = np.zeros((4, 4))
    W[:3, :3] = np.array(
        [[0, -xi[5], xi[4]], [xi[5], 0, -xi[3]], [-xi[4], xi[3], 0]]
    )
    W[:3, 3] = xi[:3]
    return expm(W)


def make_rig(n_cams=3, seed=0, dtype=np.float64):
    """Camera rig: n_cams-1 async monos + 1 stereo reference camera."""
    rng = np.random.RandomState(seed)
    Tbc = []
    for c in range(n_cams):
        xi = np.concatenate([rng.randn(3) * 0.3, rng.randn(3) * 0.2])
        if c == n_cams - 1:
            xi *= 0.1  # stereo camera near the body frame
        Tbc.append(_np_exp_se3(xi))
    K = np.tile(np.array([420.0, 420.0, 480.0, 300.0], dtype), (n_cams, 1))
    bf = 40.0
    return np.stack(Tbc).astype(dtype), K, bf


def make_pose_problem_numpy(
    n_mono=64,
    n_stereo=48,
    n_cams=3,
    noise_px=0.5,
    outlier_frac=0.0,
    seed=0,
):
    """One per-frame pose-solve instance (PoseGPOptimizationFromeLastFrame)
    as numpy arrays: (data fields, state0 fields, gt fields), keyed by the
    PoseGPData/PoseState field names, float64. Observations come from the
    ground-truth constant-twist trajectory; async-camera timestamps fall
    strictly inside (t_prev, t_cur)."""
    rng = np.random.RandomState(seed)
    Tbc, K, bf = make_rig(n_cams, seed + 1)

    t_prev, t_cur = 0.0, 0.1
    v_true = np.array([2.0, 0.2, -0.1, 0.02, -0.03, 0.2])
    T_prev = _np_exp_se3(rng.randn(6) * 0.2)
    T_cur = T_prev @ _np_exp_se3(v_true * (t_cur - t_prev))

    # --- async mono GP observations
    cams = rng.randint(0, n_cams - 1, n_mono)
    ts = rng.uniform(t_prev + 0.01, t_cur - 0.01, n_mono)
    mg_obs = np.zeros((n_mono, 2))
    mg_Xw = np.zeros((n_mono, 3))
    for i in range(n_mono):
        s = (ts[i] - t_prev) / (t_cur - t_prev)
        Twb = T_prev @ _np_exp_se3(v_true * s * (t_cur - t_prev))
        Twc = Twb @ Tbc[cams[i]]
        Xc = np.array([rng.uniform(-3, 3), rng.uniform(-2, 2), rng.uniform(4, 20)])
        Xw = Twc[:3, :3] @ Xc + Twc[:3, 3]
        u = K[cams[i], 0] * Xc[0] / Xc[2] + K[cams[i], 2]
        v = K[cams[i], 1] * Xc[1] / Xc[2] + K[cams[i], 3]
        mg_obs[i] = [u + rng.randn() * noise_px, v + rng.randn() * noise_px]
        mg_Xw[i] = Xw

    # --- stereo-camera observations at t_cur
    st_obs = np.zeros((n_stereo, 3))
    st_Xw = np.zeros((n_stereo, 3))
    is_stereo = rng.rand(n_stereo) < 0.7
    Twc = T_cur @ Tbc[-1]
    for i in range(n_stereo):
        Xc = np.array([rng.uniform(-3, 3), rng.uniform(-2, 2), rng.uniform(4, 20)])
        Xw = Twc[:3, :3] @ Xc + Twc[:3, 3]
        u = K[-1, 0] * Xc[0] / Xc[2] + K[-1, 2]
        v = K[-1, 1] * Xc[1] / Xc[2] + K[-1, 3]
        ur = u - bf / Xc[2]
        st_obs[i] = [
            u + rng.randn() * noise_px,
            v + rng.randn() * noise_px,
            (ur + rng.randn() * noise_px) if is_stereo[i] else -1.0,
        ]
        st_Xw[i] = Xw

    # --- outliers: corrupt a fraction of observations grossly
    n_out_m = int(outlier_frac * n_mono)
    if n_out_m:
        idx = rng.choice(n_mono, n_out_m, replace=False)
        mg_obs[idx] += rng.randn(n_out_m, 2) * 40 + 20
    n_out_s = int(outlier_frac * n_stereo)
    if n_out_s:
        idx = rng.choice(n_stereo, n_out_s, replace=False)
        st_obs[idx, :2] += rng.randn(n_out_s, 2) * 40 + 20

    qc_diag = np.ones(6)
    qi_inv = np.zeros((12, 12))
    dt = t_cur - t_prev
    qi_inv[:6, :6] = np.diag(12.0 / dt**3 / qc_diag)
    qi_inv[:6, 6:] = np.diag(-6.0 / dt**2 / qc_diag)
    qi_inv[6:, :6] = np.diag(-6.0 / dt**2 / qc_diag)
    qi_inv[6:, 6:] = np.diag(4.0 / dt / qc_diag)

    data = dict(
        t_prev=np.asarray(t_prev),
        t_cur=np.asarray(t_cur),
        qi_inv=qi_inv,
        qcinv22=np.asarray(1.0),
        fix_prev=np.asarray(True),
        Tbc=Tbc,
        K=K,
        bf=np.asarray(bf),
        mg_obs=mg_obs,
        mg_Xw=mg_Xw,
        mg_t=ts,
        mg_cam=cams.astype(np.int64),
        mg_w=np.ones(n_mono),
        mg_valid=np.ones(n_mono, bool),
        mg_close=np.zeros(n_mono, bool),
        st_obs=st_obs,
        st_Xw=st_Xw,
        st_w=np.ones(n_stereo),
        st_valid=np.ones(n_stereo, bool),
        st_is_stereo=is_stereo,
        st_close=np.zeros(n_stereo, bool),
    )
    gt = dict(T=np.stack([T_prev, T_cur]), v=np.stack([v_true, v_true]))
    # initial guess: previous state exact (fixed), current perturbed
    xi0 = rng.randn(6) * np.array([0.05, 0.05, 0.05, 0.01, 0.01, 0.01])
    state0 = dict(T=np.stack([T_prev, T_cur @ _np_exp_se3(xi0)]),
                  v=np.stack([v_true, v_true + rng.randn(6) * 0.1]))
    return data, state0, gt


def make_pose_problem(n_mono=64, n_stereo=48, n_cams=3, noise_px=0.5,
                      outlier_frac=0.0, seed=0, dtype=torch.float64, device="cpu"):
    """One per-frame pose-solve instance on `device` in `dtype`:
    (data: PoseGPData, state0: PoseState perturbed, gt: PoseState)."""
    data_np, state0_np, gt_np = make_pose_problem_numpy(
        n_mono=n_mono, n_stereo=n_stereo, n_cams=n_cams, noise_px=noise_px,
        outlier_frac=outlier_frac, seed=seed)
    data, state0 = pose_from_numpy(data_np, state0_np, device=device, dtype=dtype)
    return data, state0, pose_state_from_numpy(gt_np, device=device, dtype=dtype)


def _rigid_inv(T):
    """Batched rigid inverse of (...,4,4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Ti = np.zeros_like(T)
    Ti[..., :3, :3] = np.swapaxes(R, -1, -2)
    Ti[..., :3, 3] = -np.einsum("...ji,...j->...i", R, t)
    Ti[..., 3, 3] = 1.0
    return Ti


def make_local_ba_problem_numpy(
    n_kf=12,
    n_fixed=2,
    n_lm=256,
    n_cams=3,
    obs_per_lm=4,
    gpobs_per_lm=1,
    noise_px=0.5,
    seed=0,
    shared_times=True,
    frames_per_interval=4,
):
    """The generator as numpy arrays: (data fields, state0 fields, gt fields),
    each a dict keyed by the LocalBAData/BAState field names, float64."""
    rng = np.random.RandomState(seed)
    Tbc, K, bf = make_rig(n_cams, seed + 1)
    kf_dt = 0.4
    times = np.arange(n_kf) * kf_dt

    # smooth trajectory: slowly varying twist
    v_base = np.array([2.0, 0.15, -0.05, 0.01, -0.02, 0.15])
    Ts, vs = [], []
    T = _np_exp_se3(rng.randn(6) * 0.1)
    for k in range(n_kf):
        vk = v_base + 0.15 * np.sin(0.4 * k) * np.array([1, 0.5, 0.2, 0.1, 0.1, 0.3])
        Ts.append(T)
        vs.append(vk)
        T = T @ _np_exp_se3(vk * kf_dt)
    Ts = np.stack(Ts)
    vs = np.stack(vs)

    # landmarks: sprinkled ahead of trajectory keyframes
    anchor = rng.randint(0, n_kf, n_lm)
    Xc0 = np.stack(
        [
            rng.uniform(-4, 4, n_lm),
            rng.uniform(-2.5, 2.5, n_lm),
            rng.uniform(5, 25, n_lm),
        ],
        axis=1,
    )
    Twc_anchor = Ts[anchor] @ Tbc[-1]
    X = np.einsum("lij,lj->li", Twc_anchor[:, :3, :3], Xc0) + Twc_anchor[:, :3, 3]

    # ---- stereo-cam KF observations: window of KFs around each anchor
    w2 = obs_per_lm // 2
    offs = np.arange(-w2, w2 + 1)
    k_mat = anchor[:, None] + offs[None, :]            # (L,W)
    in_range = (k_mat >= 0) & (k_mat < n_kf)
    k_clip = np.clip(k_mat, 0, n_kf - 1)
    Tcw = _rigid_inv(Ts[k_clip] @ Tbc[-1])             # (L,W,4,4)
    Xc = np.einsum("lwij,lj->lwi", Tcw[..., :3, :3], X) + Tcw[..., :3, 3]
    vis = in_range & (Xc[..., 2] > 0.2)
    u = K[-1, 0] * Xc[..., 0] / Xc[..., 2] + K[-1, 2]
    v = K[-1, 1] * Xc[..., 1] / Xc[..., 2] + K[-1, 3]
    is_st_mat = rng.rand(n_lm, offs.size) < 0.7
    ur = np.where(
        is_st_mat, u - bf / Xc[..., 2] + rng.randn(n_lm, offs.size) * noise_px, -1.0
    )
    lm_mat = np.broadcast_to(np.arange(n_lm)[:, None], k_mat.shape)
    sel = vis.ravel()
    st = np.stack(
        [
            k_clip.ravel()[sel],
            lm_mat.ravel()[sel],
            (u + rng.randn(n_lm, offs.size) * noise_px).ravel()[sel],
            (v + rng.randn(n_lm, offs.size) * noise_px).ravel()[sel],
            ur.ravel()[sel],
            is_st_mat.ravel()[sel].astype(float),
        ],
        axis=1,
    )

    # ---- async-camera GP observations on pairs (anchor-1, anchor)
    rep = np.repeat(np.arange(n_lm), gpobs_per_lm)
    kk = anchor[rep]
    okm = kk > 0
    rep, kk = rep[okm], kk[okm]
    M = rep.size
    cc = rng.randint(0, n_cams - 1, M)
    if shared_times:
        # fixed per-camera phase within one of F frame slots per interval
        F = frames_per_interval
        slot = rng.randint(0, F, M)
        phase = (cc + 1.0) / n_cams
        tt = times[kk - 1] + ((slot + phase) / F) * (times[kk] - times[kk - 1])
    else:
        tt = times[kk - 1] + 0.05 + rng.rand(M) * (times[kk] - times[kk - 1] - 0.1)
    # batched exp_se3 via Rodrigues for the intra-interval pose
    xi = vs[kk - 1] * (tt - times[kk - 1])[:, None]
    rho, om = xi[:, :3], xi[:, 3:]
    th2 = np.sum(om * om, axis=1)
    th = np.sqrt(np.maximum(th2, 1e-32))
    A_ = np.where(th2 > 1e-16, np.sin(th) / th, 1.0)
    B_ = np.where(th2 > 1e-16, (1 - np.cos(th)) / np.maximum(th2, 1e-32), 0.5)
    C_ = np.where(th2 > 1e-16, (th - np.sin(th)) / np.maximum(th2 * th, 1e-32), 1 / 6)
    zeros = np.zeros(M)
    Wx = np.stack(
        [
            np.stack([zeros, -om[:, 2], om[:, 1]], 1),
            np.stack([om[:, 2], zeros, -om[:, 0]], 1),
            np.stack([-om[:, 1], om[:, 0], zeros], 1),
        ],
        axis=1,
    )
    Wx2 = np.einsum("mij,mjk->mik", Wx, Wx)
    I3 = np.eye(3)[None]
    Rm = I3 + A_[:, None, None] * Wx + B_[:, None, None] * Wx2
    Jl = I3 + B_[:, None, None] * Wx + C_[:, None, None] * Wx2
    tm = np.einsum("mij,mj->mi", Jl, rho)
    Texp = np.zeros((M, 4, 4))
    Texp[:, :3, :3] = Rm
    Texp[:, :3, 3] = tm
    Texp[:, 3, 3] = 1.0
    Twb_t = np.einsum("mij,mjk->mik", Ts[kk - 1], Texp)
    Tcw_m = _rigid_inv(np.einsum("mij,mjk->mik", Twb_t, Tbc[cc]))
    Xcm = np.einsum("mij,mj->mi", Tcw_m[:, :3, :3], X[rep]) + Tcw_m[:, :3, 3]
    vism = Xcm[:, 2] > 0.2
    um = K[cc, 0] * Xcm[:, 0] / Xcm[:, 2] + K[cc, 2] + rng.randn(M) * noise_px
    vm = K[cc, 1] * Xcm[:, 1] / Xcm[:, 2] + K[cc, 3] + rng.randn(M) * noise_px
    mg = np.stack([kk - 1, kk, rep, cc, tt, um, vm], axis=1)[vism]

    if mg.size == 0:
        mg = np.zeros((0, 7))
    if st.size == 0:
        st = np.zeros((0, 6))
    Em, Es = len(mg), len(st)

    qi_inv_one = np.zeros((12, 12))
    qi_inv_one[:6, :6] = 12.0 / kf_dt**3 * np.eye(6)
    qi_inv_one[:6, 6:] = -6.0 / kf_dt**2 * np.eye(6)
    qi_inv_one[6:, :6] = -6.0 / kf_dt**2 * np.eye(6)
    qi_inv_one[6:, 6:] = 4.0 / kf_dt * np.eye(6)
    gp_pairs = np.stack([np.arange(n_kf - 1), np.arange(1, n_kf)], 1)

    Cx = n_cams - 1
    pose_fixed = np.arange(n_kf) < n_fixed

    mg_pair = mg[:, :2].astype(np.int64)
    mg_lm = mg[:, 2].astype(np.int64)
    mg_cam = mg[:, 3].astype(np.int64)
    mg_valid = np.ones(Em, bool)
    mg_sid, mg_sid_cols = make_structure_ids(mg_pair, mg_cam, mg_valid, n_kf, Cx)
    sg_sid, sg_sid_cols = make_structure_ids(
        np.zeros((0, 2), np.int64), None, np.zeros(0, bool), n_kf, Cx)
    mg_it, mg_it_sid, mg_it_t = build_interp_tables(mg_sid, mg[:, 4], mg_valid)
    sg_it, sg_it_sid, sg_it_t = build_interp_tables(
        np.zeros(0, np.int32), np.zeros(0), np.zeros(0, bool))
    st_pose = st[:, 0].astype(np.int64)
    st_lm = st[:, 1].astype(np.int64)
    st_valid = np.ones(Es, bool)
    sg_pair = np.zeros((0, 2), np.int64)
    sg_lm = np.zeros(0, np.int64)
    sg_valid = np.ones(0, bool)
    lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid = make_landmark_tables(
        mg_lm, mg_pair, mg_cam, mg_valid, sg_lm, sg_pair, sg_valid,
        st_lm, st_pose, st_valid, n_lm, n_kf, Cx)

    data = dict(
        times=times,
        pose_fixed=pose_fixed,
        vel_valid=~pose_fixed,
        qcinv22=np.asarray(1.0),
        gp_pairs=gp_pairs,
        gp_qi_inv=np.tile(qi_inv_one, (n_kf - 1, 1, 1)),
        gp_valid=np.ones(n_kf - 1, bool),
        gp_huber=np.asarray(False),
        Tbc_stereo=Tbc[-1],
        K_stereo=K[-1],
        bf=np.asarray(bf),
        K_async=K[:Cx],
        ext_fixed=np.ones(Cx, bool),
        R_prior=Tbc[:Cx, :3, :3],
        ext_info=np.tile(np.eye(3) * 1e4, (Cx, 1, 1)),
        mg_pair=mg_pair,
        mg_lm=mg_lm,
        mg_cam=mg_cam,
        mg_t=mg[:, 4],
        mg_obs=mg[:, 5:7],
        mg_w=np.ones(Em),
        mg_valid=mg_valid,
        mg_close=np.zeros(Em, bool),
        mg_sid=mg_sid,
        mg_sid_cols=mg_sid_cols,
        sg_pair=sg_pair,
        sg_lm=sg_lm,
        sg_t=np.zeros(0),
        sg_obs=np.zeros((0, 3)),
        sg_w=np.ones(0),
        sg_valid=sg_valid,
        sg_sid=sg_sid,
        sg_sid_cols=sg_sid_cols,
        st_pose=st_pose,
        st_lm=st_lm,
        st_obs=st[:, 2:5],
        st_w=np.ones(Es),
        st_valid=st_valid,
        st_is_stereo=st[:, 5] > 0.5,
        st_close=np.zeros(Es, bool),
        lm_blk=lm_blk,
        lm_blk_g=lm_blk_g,
        lm_blk_valid=lm_blk_valid,
        lm_edge=lm_edge,
        lm_edge_valid=lm_edge_valid,
        mg_it=mg_it,
        mg_it_sid=mg_it_sid,
        mg_it_t=mg_it_t,
        sg_it=sg_it,
        sg_it_sid=sg_it_sid,
        sg_it_t=sg_it_t,
    )
    gt = dict(T=Ts, v=vs, Text=Tbc[:Cx], X=X)
    # perturb non-fixed states
    Tp = Ts.copy()
    vp = vs.copy()
    Xp = X + rng.randn(n_lm, 3) * 0.03
    for k in range(n_fixed, n_kf):
        Tp[k] = Ts[k] @ _np_exp_se3(
            rng.randn(6) * np.array([0.03, 0.03, 0.03, 0.005, 0.005, 0.005])
        )
        vp[k] = vs[k] + rng.randn(6) * 0.05
    state0 = dict(T=Tp, v=vp, Text=Tbc[:Cx].copy(), X=Xp)
    return data, state0, gt


def make_local_ba_problem(
    n_kf=12,
    n_fixed=2,
    n_lm=256,
    n_cams=3,
    obs_per_lm=4,
    gpobs_per_lm=1,
    noise_px=0.5,
    seed=0,
    dtype=torch.float64,
    device="cpu",
    shared_times=True,
    frames_per_interval=4,
):
    """A LocalGPBA-shaped problem instance on `device` in `dtype`.

    n_kf keyframes on a smooth trajectory (the first n_fixed fixed),
    landmarks observed by several consecutive KFs through the stereo camera
    (at KF times) and the async cameras (GP-interpolated, between KFs).
    shared_times=True lets async cameras fire at fixed per-camera phases,
    so edges share interpolation timestamps (the interp-combo path);
    shared_times=False draws one random time per observation.
    Returns (data: LocalBAData, state0: BAState perturbed, gt: BAState)."""
    data_np, state0_np, gt_np = make_local_ba_problem_numpy(
        n_kf=n_kf, n_fixed=n_fixed, n_lm=n_lm, n_cams=n_cams,
        obs_per_lm=obs_per_lm, gpobs_per_lm=gpobs_per_lm, noise_px=noise_px,
        seed=seed, shared_times=shared_times,
        frames_per_interval=frames_per_interval,
    )
    data, state0 = ba_from_numpy(data_np, state0_np, device=device, dtype=dtype)
    return data, state0, state_from_numpy(gt_np, device=device, dtype=dtype)


def make_sequence(
    n_frames=30,
    n_cams=3,
    n_lm=400,
    fps=10.0,
    noise_px=0.3,
    stereo_depth_frac=0.8,
    seed=0,
):
    """Synthetic multi-camera sequence for end-to-end pipeline tests (a copy
    of `amcslam_tpu/utils/synthetic.py::make_sequence`, draw for draw).

    Produces per-frame Frames (pipeline.map_store.Frame) with keypoints =
    projections of persistent landmarks (so descriptor matching is exact by
    construction: each landmark has a unique random 256-bit descriptor),
    stereo depths on the reference camera, and async camera timestamps.
    Returns (frames, rig, gt_poses (N,4,4), landmarks).

    The reference projects every landmark in every camera of every frame
    one at a time. Here a vectorized pass first drops the landmarks that
    are far outside a camera's view (margins of 0.1 m in depth and 1 px in
    the image, far above the rounding difference between the two forms),
    and the reference's per-landmark projection decides for the rest, so
    the outputs and the random draws are the reference's exactly."""
    from ..pipeline.map_store import Frame
    from ..pipeline.rig import Rig

    rng = np.random.RandomState(seed)
    Tbc, K, bf = make_rig(n_cams, seed + 1)
    rig = Rig(Tbc=Tbc, K=K, bf=bf)

    dt = 1.0 / fps
    v_true = np.array([1.5, 0.1, 0.0, 0.0, 0.0, 0.12])
    Ts = [np.eye(4)]
    for k in range(1, n_frames):
        vk = v_true + 0.2 * np.sin(0.3 * k) * np.array([1, 0.3, 0, 0, 0, 0.5])
        Ts.append(Ts[-1] @ _np_exp_se3(vk * dt))
    Ts = np.stack(Ts)

    # landmarks sprinkled along the trajectory in front of the stereo camera
    anchor = rng.randint(0, n_frames, n_lm)
    X = np.zeros((n_lm, 3))
    for l in range(n_lm):  # noqa: E741
        Twc = Ts[anchor[l]] @ Tbc[-1]
        Xc = np.array([rng.uniform(-5, 5), rng.uniform(-3, 3), rng.uniform(4, 25)])
        X[l] = Twc[:3, :3] @ Xc + Twc[:3, 3]
    descs = rng.randint(0, 256, (n_lm, 32)).astype(np.uint8)

    def project_cam(Twb, c, Xw):
        Twc = Twb @ Tbc[c]
        Rcw = Twc[:3, :3].T
        Xc = Rcw @ (Xw - Twc[:3, 3])
        if Xc[2] < 0.5:
            return None, Xc
        u = K[c, 0] * Xc[0] / Xc[2] + K[c, 2]
        v = K[c, 1] * Xc[1] / Xc[2] + K[c, 3]
        if not (0 <= u < 960 and 0 <= v < 600):
            return None, Xc
        return np.array([u, v]), Xc

    def candidates(Twb, c):
        """Landmarks not certainly outside camera c's view (superset of the
        ones project_cam keeps), in increasing index order."""
        Twc = Twb @ Tbc[c]
        Xc = (X - Twc[:3, 3]) @ Twc[:3, :3]
        z = Xc[:, 2]
        zs = np.maximum(z, 1e-9)
        u = K[c, 0] * Xc[:, 0] / zs + K[c, 2]
        v = K[c, 1] * Xc[:, 1] / zs + K[c, 3]
        keep = (z >= 0.4) & (u >= -1.0) & (u < 961.0) & (v >= -1.0) & (v < 601.0)
        return np.nonzero(keep)[0]

    frames = []
    for k in range(n_frames):
        t_frame = k * dt
        cam_times = rig.cam_times(t_frame)
        kps, octs, ds = [], [], []
        ur, depth = None, None
        for c in range(n_cams):
            # pose at this camera's timestamp (constant twist within frame)
            toff = cam_times[c] - t_frame
            if k > 0:
                vk = v_true + 0.2 * np.sin(0.3 * k) * np.array([1, 0.3, 0, 0, 0, 0.5])
            else:
                vk = v_true
            Twb_c = Ts[k] @ _np_exp_se3(vk * toff)
            kp_c, oc_c, d_c, ur_c, z_c = [], [], [], [], []
            for l in candidates(Twb_c, c):  # noqa: E741
                uv, Xc = project_cam(Twb_c, c, X[l])
                if uv is None:
                    continue
                uv = uv + rng.randn(2) * noise_px
                kp_c.append(uv)
                oc_c.append(0)
                d_c.append(descs[l])
                if c == n_cams - 1:
                    has_d = rng.rand() < stereo_depth_frac
                    ur_c.append(uv[0] - bf / Xc[2] if has_d else -1.0)
                    z_c.append(Xc[2] if has_d else -1.0)
            kps.append(np.array(kp_c).reshape(-1, 2))
            octs.append(np.array(oc_c, np.int64))
            ds.append(np.array(d_c, np.uint8).reshape(-1, 32))
            if c == n_cams - 1:
                ur = np.array(ur_c)
                depth = np.array(z_c)
        frames.append(
            Frame(
                timestamp=t_frame,
                cam_times=cam_times,
                Twb=np.eye(4),
                velocity=np.zeros(6),
                keypoints=kps,
                kp_octaves=octs,
                descriptors=ds,
                kp_ur=ur,
                kp_depth=depth,
            )
        )
    return frames, rig, Ts, (X, descs)


def make_vi_ba_synthetic_numpy(n_kf=20, n_lm=500, steps_per_kf=40, imu_dt=0.005,
                               noise_px=0.3, seed=0):
    """A visual-inertial BA instance (config 4 of BASELINE.md) as numpy
    arrays, draw for draw the reference's `make_vi_ba_synthetic`
    (synthetic.py:519-650): n_kf inertial keyframes on a smooth accelerating
    trajectory, IMU preintegration factors between consecutive keyframes
    and mono reprojection edges to n_lm landmarks. The windows preintegrate
    with the port's `ops/imu.preintegrate` on the CPU in float64 (all
    windows in one batch).

    Returns (data, state0, gt): field name -> array mappings of VIBAData
    (`pre` a mapping of PreintState fields), the perturbed VIBAState and the
    true one."""
    from ..ops import imu

    rng = np.random.RandomState(seed)
    G = np.array([0.0, 0.0, -9.81])
    w_body = np.array([0.25, -0.15, 0.4])

    def a_world(t):
        return np.array([0.4 * np.sin(2 * t), 0.2 * np.cos(1.3 * t), 0.1 * np.cos(t)])

    n_steps = steps_per_kf * (n_kf - 1)
    R = np.eye(3)
    p = np.zeros(3)
    v = np.array([1.0, 0.0, 0.2])
    Rs, ps, vs, gyro, acc = [R.copy()], [p.copy()], [v.copy()], [], []
    for k in range(n_steps):
        a_w = a_world(k * imu_dt)
        gyro.append(w_body.copy())
        acc.append(R.T @ (a_w - G))
        p = p + v * imu_dt + 0.5 * a_w * imu_dt * imu_dt
        v = v + a_w * imu_dt
        R = R @ _np_exp_se3(np.r_[np.zeros(3), w_body * imu_dt])[:3, :3]
        Rs.append(R.copy())
        ps.append(p.copy())
        vs.append(v.copy())
    acc, gyro = np.array(acc), np.array(gyro)
    Rs, ps, vs = np.array(Rs), np.array(ps), np.array(vs)
    kf_idx = np.arange(n_kf) * steps_per_kf

    f64 = torch.float64
    n_win = n_kf - 1
    pre = imu.preintegrate(
        torch.tensor(acc.reshape(n_win, steps_per_kf, 3), dtype=f64),
        torch.tensor(gyro.reshape(n_win, steps_per_kf, 3), dtype=f64),
        torch.full((n_win, steps_per_kf), imu_dt, dtype=f64),
        torch.zeros(3, dtype=f64), torch.zeros(3, dtype=f64),
        torch.eye(6, dtype=f64) * 1e-6, torch.eye(6, dtype=f64) * 1e-8,
    )

    Tbc, Kin, _ = make_rig(2, seed + 1)
    cam = 0
    # landmarks sprinkled in front of the trajectory
    anchor = rng.randint(0, n_kf, n_lm)
    X = np.zeros((n_lm, 3))
    for l in range(n_lm):
        Twb = np.eye(4)
        Twb[:3, :3] = Rs[kf_idx[anchor[l]]]
        Twb[:3, 3] = ps[kf_idx[anchor[l]]]
        Twc = Twb @ Tbc[cam]
        Xc = np.array([rng.uniform(-4, 4), rng.uniform(-2.5, 2.5), rng.uniform(5, 20)])
        X[l] = Twc[:3, :3] @ Xc + Twc[:3, 3]

    obs, okf, olm, ocam = [], [], [], []
    for k in range(n_kf):
        Twb = np.eye(4)
        Twb[:3, :3] = Rs[kf_idx[k]]
        Twb[:3, 3] = ps[kf_idx[k]]
        Tcw = np.linalg.inv(Twb @ Tbc[cam])
        Xc = X @ Tcw[:3, :3].T + Tcw[:3, 3]
        for l in np.nonzero(Xc[:, 2] > 1.0)[0]:
            u = Kin[cam, 0] * Xc[l, 0] / Xc[l, 2] + Kin[cam, 2]
            v_ = Kin[cam, 1] * Xc[l, 1] / Xc[l, 2] + Kin[cam, 3]
            obs.append([u + rng.randn() * noise_px, v_ + rng.randn() * noise_px])
            okf.append(k)
            olm.append(int(l))
            ocam.append(cam)
    E = len(obs)

    data = dict(
        pre={k: val.numpy() for k, val in pre._asdict().items()},
        imu_pairs=np.stack([np.arange(n_win), np.arange(1, n_kf)], 1).astype(np.int32),
        imu_valid=np.ones(n_win, bool),
        bg_lin=np.zeros((n_win, 3)),
        ba_lin=np.zeros((n_win, 3)),
        walk_info=np.eye(6) * 1e4,
        gravity=G,
        obs=np.array(obs),
        obs_kf=np.asarray(okf, np.int32),
        obs_lm=np.asarray(olm, np.int32),
        obs_cam=np.asarray(ocam, np.int32),
        w=np.ones(E),
        obs_valid=np.ones(E, bool),
        Tbc=Tbc,
        K_intr=Kin,
        pose_fixed=np.arange(n_kf) == 0,
    )
    gt = dict(R=Rs[kf_idx], p=ps[kf_idx], v=vs[kf_idx], bg=np.zeros((n_kf, 3)),
              ba=np.zeros((n_kf, 3)), X=X)
    Rp = gt["R"].copy()
    for k in range(1, n_kf):
        Rp[k] = Rp[k] @ _np_exp_se3(np.r_[np.zeros(3), rng.randn(3) * 0.01])[:3, :3]
    free = (np.arange(n_kf) > 0)[:, None]
    state0 = dict(
        R=Rp,
        p=gt["p"] + rng.randn(n_kf, 3) * 0.05 * free,
        v=gt["v"] + rng.randn(n_kf, 3) * 0.05 * free,
        bg=gt["bg"],
        ba=gt["ba"],
        X=gt["X"] + rng.randn(n_lm, 3) * 0.02,
    )
    return data, state0, gt


def make_vi_ba_synthetic(n_kf=20, n_lm=500, steps_per_kf=40, imu_dt=0.005, noise_px=0.3,
                         seed=0, dtype=torch.float64, device="cpu"):
    """`make_vi_ba_synthetic_numpy` as (VIBAData, VIBAState perturbed,
    VIBAState true) with tensors on `device` in `dtype`."""
    from ..convert import vi_ba_from_numpy, vi_ba_state_from_numpy

    data, state0, gt = make_vi_ba_synthetic_numpy(n_kf, n_lm, steps_per_kf, imu_dt,
                                                  noise_px, seed)
    return (vi_ba_from_numpy(data, device=device, dtype=dtype),
            vi_ba_state_from_numpy(state0, device=device, dtype=dtype),
            vi_ba_state_from_numpy(gt, device=device, dtype=dtype))


def make_essential_graph_numpy(n_kf=500, n_loop=40, drift=0.002, seed=0,
                               step_m=0.1, laps=None):
    """A Sim3 pose-graph instance (config 5) as numpy arrays: n_kf
    keyframes on a loopy trajectory, consecutive-chain Sim3 edges measured
    from drifted odometry, plus n_loop drift-free loop-closure edges to
    early keyframes (Optimizer::OptimizeEssentialGraph topology,
    Optimizer.cc:1390-1680).

    `step_m` is the spacing of keyframes in meters (path length ~= n_kf *
    step_m). With `laps=L`, the ground truth is L closed circuits of one
    circle and the loop edges are revisit closures: every
    (n_kf - n_kf//L)/n_loop-th keyframe on laps >= 2 gets a drift-free edge
    to the keyframe one lap earlier at the same spot.

    Returns (EssentialGraphData fields, drifted Sim3Field fields, gt poses
    (n_kf,4,4)), as the reference's `make_essential_graph` draws them."""
    rng = np.random.RandomState(seed)
    Ts = [np.eye(4)]
    if laps is None:
        # the open arc (one tenth of a turn over the run)
        xi_step = np.array([step_m * 10.0, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / n_kf]) * 0.1
    else:
        # a closed circle per lap
        per_lap = n_kf // laps
        xi_step = np.array([step_m, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / per_lap])
    for _ in range(1, n_kf):
        Ts.append(Ts[-1] @ _np_exp_se3(xi_step))
    Ts = np.stack(Ts)

    # drifted estimates: accumulate noisy relative motions
    Td = [Ts[0]]
    for k in range(1, n_kf):
        rel = np.linalg.inv(Ts[k - 1]) @ Ts[k]
        rel = rel @ _np_exp_se3(rng.randn(6) * drift)
        Td.append(Td[-1] @ rel)
    Td = np.stack(Td)

    pairs, ms, mR, mt = [], [], [], []
    # chain edges measured from the drifted odometry (consistent with state0)
    for k in range(1, n_kf):
        rel = np.linalg.inv(Td[k]) @ Td[k - 1]
        pairs.append([k - 1, k]); ms.append(1.0)  # noqa: E702
        mR.append(rel[:3, :3]); mt.append(rel[:3, 3])  # noqa: E702
    if laps is None:
        # drift-free ground-truth constraints to early keyframes
        for _ in range(n_loop):
            a = int(rng.randint(0, n_kf // 4))
            b = int(rng.randint(3 * n_kf // 4, n_kf))
            rel = np.linalg.inv(Ts[b]) @ Ts[a]
            pairs.append([a, b]); ms.append(1.0)  # noqa: E702
            mR.append(rel[:3, :3]); mt.append(rel[:3, 3])  # noqa: E702
    else:
        # revisit closures: keyframe b on lap >= 2 against the keyframe one
        # lap earlier
        per_lap = n_kf // laps
        stride = max(1, (n_kf - per_lap) // max(n_loop, 1))
        for b in range(per_lap, n_kf, stride):
            a = b - per_lap
            rel = np.linalg.inv(Ts[b]) @ Ts[a]
            pairs.append([a, b]); ms.append(1.0)  # noqa: E702
            mR.append(rel[:3, :3]); mt.append(rel[:3, 3])  # noqa: E702

    E = len(pairs)
    data = dict(pairs=np.array(pairs, np.int64), meas_s=np.array(ms),
                meas_R=np.stack(mR), meas_t=np.stack(mt), valid=np.ones(E, bool),
                fixed=np.arange(n_kf) == 0, fix_scale=np.asarray(True))
    Tdw = np.linalg.inv(Td)  # vertices store world->body (Scw convention)
    state0 = dict(s=np.ones(n_kf), R=Tdw[:, :3, :3], t=Tdw[:, :3, 3])
    return data, state0, Ts


def make_essential_graph(n_kf=500, n_loop=40, drift=0.002, seed=0, dtype=torch.float64,
                         step_m=0.1, laps=None, device="cpu"):
    """`make_essential_graph_numpy` as (EssentialGraphData, Sim3Field, gt
    poses) with tensors on `device` in `dtype`."""
    from ..convert import essential_graph_from, sim3_field_from

    data, state0, Ts = make_essential_graph_numpy(n_kf, n_loop, drift, seed, step_m, laps)
    return (essential_graph_from(data, device=device, dtype=dtype),
            sim3_field_from(state0, device=device, dtype=dtype), Ts)


def build_loop_map(n_kf=14, n_lm=120, drift=0.04, seed=0, n_local=25, noise_px=0.3):
    """Closed circular trajectory with accumulating odometry drift, on the
    port's map store (a copy of the reference's test-data builder,
    `tests/test_loop_closing.py:13-121`, draw for draw). Every consecutive
    keyframe pair co-observes a local stereo landmark cluster; the last
    keyframe revisits the first one's area and re-observes its landmarks as
    drifted duplicate points (what tracking would triangulate), which loop
    closing must detect, align, fuse and optimize away. Observations are
    consistent with the ground truth, so it is the chi2 optimum (keyframe 0
    fixes the gauge). Returns (map, rig, keyframes, gt poses)."""
    from ..pipeline.map_store import KeyFrame, Map, MapPoint
    from ..pipeline.rig import Rig

    rng = np.random.RandomState(seed)
    Tbc, K, bf = make_rig(2, seed + 1)
    rig = Rig(Tbc=Tbc, K=K, bf=bf)
    m = Map()
    cam = rig.n_cams - 1

    step = np.array([1.2, 0, 0, 0, 0, 2 * np.pi / n_kf])
    gt = [np.eye(4)]
    for _ in range(n_kf - 1):
        gt.append(gt[-1] @ _np_exp_se3(step))
    est = [np.eye(4)]
    for k in range(n_kf - 1):
        noise = np.concatenate([rng.randn(3) * drift, rng.randn(3) * drift * 0.2])
        est.append(est[-1] @ _np_exp_se3(step + noise))

    # start-area landmarks (seen by the first and the last keyframe)
    X0 = rng.randn(n_lm, 3) * 2 + np.array([4.0, 0, 1.0])
    # per-step local clusters in front of the stereo camera at gt pose k,
    # co-observed by keyframes k and k+1
    Xloc = []
    for k in range(n_kf - 1):
        Xc = np.stack([rng.uniform(-4, 4, n_local), rng.uniform(-3, 3, n_local),
                       rng.uniform(5, 14, n_local)], 1)
        Twc = gt[k] @ Tbc[cam]
        Xloc.append(Xc @ Twc[:3, :3].T + Twc[:3, 3])
    n_total = n_lm + (n_kf - 1) * n_local
    descs = rng.randint(0, 256, (n_total, 32)).astype(np.uint8)

    def project(Twb_gt, Xw):
        Tcw = np.linalg.inv(Twb_gt @ Tbc[cam])
        Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = np.maximum(Xc[:, 2], 1e-9)
        u = K[cam, 0] * Xc[:, 0] / z + K[cam, 2]
        v = K[cam, 1] * Xc[:, 1] / z + K[cam, 3]
        return np.stack([u, v], 1), u - bf / z, Xc[:, 2] > 0.5

    mp_of = {}  # landmark index -> MapPoint
    kfs = []
    prev = None
    for k in range(n_kf):
        obs = []  # (landmark index, Xw_gt, anchor step)
        if k == 0 or k == n_kf - 1:
            obs += [(l, X0[l], 0) for l in range(n_lm)]  # noqa: E741
        for ck in (k - 1, k):
            if 0 <= ck < n_kf - 1:
                obs += [(n_lm + ck * n_local + i, Xloc[ck][i], ck) for i in range(n_local)]
        ids = np.array([o[0] for o in obs], int)
        Xw = np.stack([o[1] for o in obs]) if obs else np.zeros((0, 3))
        anchors = np.array([o[2] for o in obs], int)
        kp, ur, vis = project(gt[k], Xw)
        ids, Xw, anchors = ids[vis], Xw[vis], anchors[vis]
        kp, ur = kp[vis], ur[vis]
        kp = kp + rng.randn(*kp.shape) * noise_px
        ur = ur + rng.randn(*ur.shape) * noise_px

        kf = KeyFrame(
            timestamp=float(k), cam_times=np.array([k - 0.02, float(k)]), Twb=est[k].copy(),
            velocity=np.zeros(6), keypoints=[np.zeros((0, 2)), kp],
            kp_octaves=[np.zeros(0, np.int64), np.zeros(len(kp), np.int64)],
            descriptors=[np.zeros((0, 32), np.uint8), descs[ids]], kp_ur=ur,
        )
        kf.prev_kf = prev
        if prev is not None:
            prev.next_kf = kf
        m.add_keyframe(kf)
        kfs.append(kf)
        prev = kf

        for i, l in enumerate(ids):  # noqa: E741
            g = kf.global_index(1, i)
            if k == n_kf - 1 and l < n_lm:
                # the revisit: tracking would triangulate a drifted duplicate
                dT = est[k] @ np.linalg.inv(gt[k])
                mp = MapPoint(position=dT[:3, :3] @ Xw[i] + dT[:3, 3], descriptor=descs[l],
                              first_kf_id=kf.id)
                m.add_map_point(mp)
            elif l in mp_of:
                mp = mp_of[l]
            else:
                dT = est[anchors[i]] @ np.linalg.inv(gt[anchors[i]])
                mp = MapPoint(position=dT[:3, :3] @ Xw[i] + dT[:3, 3], descriptor=descs[l],
                              first_kf_id=kf.id)
                mp_of[l] = mp
                m.add_map_point(mp)
            mp.add_observation(kf, 1, g)
            kf.matches[g] = mp.id
    for kf in kfs:
        kf.update_connections(m.map_points)
    return m, rig, kfs, gt
