"""Synthetic local-BA problems (port of the local-BA part of
`amcslam_tpu/utils/synthetic.py`: `_np_exp_se3`, `make_rig`,
`make_local_ba_problem`).

The generator is the reference's numpy code, draw for draw from
`np.random.RandomState(seed)`, so for the same arguments it emits the same
arrays; only the final conversion differs (torch tensors on `device`, index
fields int64). No global RNG is touched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import ba_from_numpy, state_from_numpy
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
