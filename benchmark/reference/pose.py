"""The plain reference of the per-frame pose solve, in numpy float64.

Tracking solves each frame's 12-dof state (pose and body twist) with the
previous frame's (`Optimizer::PoseGPOptimizationFromeLastFrame`): async
camera observations at poses the WNOA GP interpolates between the two
frames, the stereo camera's observations at the current frame, the GP
prior between the two states and the lateral-velocity prior on each. Its
last round runs without the Huber kernel, so the answer it returns is the
least-squares optimum of that round's cost over its inlier edges.

`optimality_gap` takes the problem and the answer, writes the cost as a
stacked residual e(x) (each term from its definition, as in `ba_cost`),
differentiates it by central differences in float64 and returns the cost
that one Gauss-Newton step from the answer would still remove, over the
cost: e^T J (J^T J)^-1 J^T e / e^T e. At a float32 optimum it sits at
float32's rounding; an answer the solve did not reach, or altered after,
reads orders of magnitude higher.

A problem is a dict: "t_prev", "t_cur", the async edges "mg_obs", "mg_Xw",
"mg_t", "mg_cam", "mg_active" and the stereo edges "st_obs", "st_Xw",
"st_is_stereo", "st_active", "fix_prev"; the rig "Tbc", "K", "bf", "qc".
"""

from __future__ import annotations

import numpy as np

from . import lie
from .ba_cost import DELTA2_MONO, DELTA2_STEREO, project

STEP = 1e-6  # central-difference step (rad, m, m/s)


def edges(p: dict, rig: dict, T, v, m, s_):
    """Residuals and camera depths of the async edges m and the stereo edges
    s_ at states T (B,2,4,4), v (B,2,6): (B,Nm,2), (B,Nm), (B,Ns,3), (B,Ns);
    a stereo edge without a right match has its third row 0."""
    Tbc, K, bf = rig["Tbc"], rig["K"], rig["bf"]
    t0, t1 = float(p["t_prev"]), float(p["t_cur"])
    B = T.shape[0]
    r_m, z_m = np.zeros((B, 0, 2)), np.zeros((B, 0))
    if m.size:
        t, c = p["mg_t"][m], p["mg_cam"][m]
        xi = lie.log_se3(lie.rigid_inv(T[:, 0]) @ T[:, 1])                    # (B,6)
        nu2 = (lie.right_jacobian_inv(xi) @ v[:, 1, :, None])[..., 0]         # (B,6)
        dt = t1 - t0
        s = (t - t0) / dt
        a12, p11, p12 = dt * s * (1 - s) ** 2, s * s * (3 - 2 * s), dt * s * s * (s - 1)
        d = (a12[None, :, None] * v[:, None, 0] + p11[None, :, None] * xi[:, None]
             + p12[None, :, None] * nu2[:, None])                             # (B,Nm,6)
        Twc = T[:, None, 0] @ lie.exp_se3(d) @ Tbc[c][None]
        Xc, u, vv = project(K[c][None], Twc, p["mg_Xw"][m][None])
        r_m, z_m = p["mg_obs"][m][None] - np.stack([u, vv], -1), Xc[..., 2]
    r_s, z_s = np.zeros((B, 0, 3)), np.zeros((B, 0))
    if s_.size:
        Twc = (T[:, 1] @ Tbc[-1])[:, None]
        Xc, u, vv = project(K[-1], Twc, p["st_Xw"][s_][None])
        r_s = p["st_obs"][s_][None] - np.stack([u, vv, u - bf / Xc[..., 2]], -1)
        r_s[..., 2] *= p["st_is_stereo"][s_][None]
        z_s = Xc[..., 2]
    return r_m, z_m, r_s, z_s


def residuals(p: dict, rig: dict, T, v):
    """Stacked residuals (B, M) of states T (B,2,4,4), v (B,2,6)."""
    qc = np.asarray(rig["qc"], np.float64)
    t0, t1 = float(p["t_prev"]), float(p["t_cur"])
    B = T.shape[0]
    r_m, _, r_s, _ = edges(p, rig, T, v, np.nonzero(p["mg_active"])[0],
                           np.nonzero(p["st_active"])[0])
    out = [r_m.reshape(B, -1), r_s.reshape(B, -1)]

    # the GP prior through the Cholesky factor of its information
    dt = np.array(t1 - t0)
    xi = lie.log_se3(lie.rigid_inv(T[:, 0]) @ T[:, 1])
    r_gp = np.concatenate([xi - dt * v[:, 0],
                           (lie.right_jacobian_inv(xi) @ v[:, 1, :, None])[..., 0] - v[:, 0]], -1)
    q = np.diag(1.0 / qc)
    Qinv = np.block([[12.0 / dt ** 3 * q, -6.0 / dt ** 2 * q], [-6.0 / dt ** 2 * q, 4.0 / dt * q]])
    L = np.linalg.cholesky(Qinv)
    out.append(r_gp @ L)
    out.append(v[:, :, 2] / np.sqrt(qc[2]))
    return np.concatenate(out, 1)


def inlier_flips(p: dict, rig: dict, T, v, margin: float = 0.1) -> int:
    """Edges whose inlier flag in the answer contradicts their chi2 at the
    returned pose by more than `margin` of the threshold: an inlier above
    the largest threshold a flag can have (1.5 x 5.991 for a close mono
    edge, 7.815 stereo), or an outlier in front of the camera below the
    smallest (5.991 mono, 7.815 stereo). The solve flags each edge at the
    pose it returns, so a sound answer has none."""
    T, v = np.asarray(T, np.float64)[None], np.asarray(v, np.float64)[None]
    m = np.nonzero(p["mg_valid"])[0]
    s_ = np.nonzero(p["st_valid"])[0]
    r_m, z_m, r_s, z_s = edges(p, rig, T, v, m, s_)
    chi_m, chi_s = (r_m[0] ** 2).sum(-1), (r_s[0] ** 2).sum(-1)
    stereo = np.asarray(p["st_is_stereo"], bool)[s_]
    lo_s = np.where(stereo, DELTA2_STEREO, DELTA2_MONO)
    hi_s = np.where(stereo, DELTA2_STEREO, 1.5 * DELTA2_MONO)
    in_m, in_s = np.asarray(p["mg_inlier"], bool)[m], np.asarray(p["st_inlier"], bool)[s_]
    flips = ((in_m & (chi_m > 1.5 * DELTA2_MONO * (1 + margin))).sum()
             + (~in_m & (z_m[0] > 0) & (chi_m < DELTA2_MONO * (1 - margin))).sum()
             + (in_s & (chi_s > hi_s * (1 + margin))).sum()
             + (~in_s & (z_s[0] > 0) & (chi_s < lo_s * (1 - margin))).sum())
    return int(flips)


def optimality_gap(p: dict, rig: dict, T, v) -> float:
    """The share of the cost at (T (2,4,4), v (2,6)) that one Gauss-Newton
    step would remove."""
    T, v = np.asarray(T, np.float64), np.asarray(v, np.float64)
    free = range(1 if p["fix_prev"] else 0, 2)
    deltas = []
    for vert in free:
        for k in range(12):
            for sign in (1.0, -1.0):
                d = np.zeros((2, 12))
                d[vert, k] = sign * STEP
                deltas.append(d)
    D = np.stack(deltas)                                                       # (2n,2,12)
    Tb = np.concatenate([T[None], T[None] @ lie.exp_se3(D[:, :, :6])], 0)
    vb = np.concatenate([v[None], v[None] + D[:, :, 6:]], 0)
    e = residuals(p, rig, Tb, vb)
    e0 = e[0]
    J = ((e[1::2] - e[2::2]) / (2 * STEP)).T                                   # (M, n)
    g = J.T @ e0
    step = np.linalg.lstsq(J.T @ J, g, rcond=None)[0]
    return float(g @ step / (e0 @ e0))
