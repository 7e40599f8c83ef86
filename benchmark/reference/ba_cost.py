"""The plain reference of the bundle adjustment's cost, in numpy float64.

The cost that the local and the global BA minimise (the reference
implementation's `Optimizer::LocalGPBA` / `GlobalGPBA` terms, g2o's robust
chi2), written from its definition, never from the program's code:

- every async-camera observation at the body pose that the WNOA Gaussian
  process interpolates between its two keyframes, through the camera's
  extrinsic, pinhole-projected; Huber on the squared error, delta^2 = 5.991;
- every stereo-camera observation at a keyframe: (u, v, right u) with
  right u = u - bf / z, the right row left out where the point has no
  right-image match; delta^2 = 7.815 (5.991 without the right row);
- every stereo-camera observation between keyframes (GP-interpolated),
  delta^2 = 7.815;
- the GP prior between chained keyframes, r = [xi - dt v1 ;
  Jr^-1(xi) v2 - v1] with xi = log(T1^-1 T2), information Qi(dt)^-1 for
  Qc = diag(qc), Huber delta = 21.026 where the problem asks;
- the prior on the lateral body velocity, v_z^2 / qc_z, on free keyframes;
- the rotation prior of each async extrinsic, log(R_prior^T R)^T I log(..).

Every observation weighs 1: the generator's keypoints are all at pyramid
level 0. A problem is a dict of arrays with the field names of the BA's
data: "times", the observation sets "mg_*" (pair, lm, cam, t, obs), "st_*"
(pose, lm, obs, is_stereo), optionally "sg_*" (pair, lm, t, obs), each with
an optional "*_valid" mask; optionally "gp_pairs" / "gp_valid" (default:
consecutive keyframes) and "vel_valid" (default: every keyframe from
"n_fixed" on).
"""

from __future__ import annotations

import numpy as np

from . import lie

DELTA2_MONO = 5.991    # chi2(2 dof, 95 %): g2o's mono Huber delta^2 (Optimizer.cc)
DELTA2_STEREO = 7.815  # chi2(3 dof, 95 %)
DELTA_GP = 21.026      # the GP prior's Huber delta (Optimizer.cc:130)


def huber(s, delta2):
    """g2o's Huber on a squared error s: s inside, 2 delta sqrt(s) - delta^2
    outside."""
    s = np.asarray(s, np.float64)
    d = np.sqrt(delta2)
    return np.where(s <= delta2, s, 2.0 * d * np.sqrt(np.maximum(s, 0.0)) - delta2)


def gp_pose(Ti, vi, ti, Tj, vj, tj, t):
    """The body pose at time t in [ti, tj] that the WNOA GP interpolates from
    the two keyframe states (Hermite coefficients of Qi(t - ti) Phi(tj, t)^T
    Qi(tj - ti)^-1)."""
    xi = lie.log_se3(lie.rigid_inv(Ti) @ Tj)
    nu2 = (lie.right_jacobian_inv(xi) @ vj[..., None])[..., 0]
    dt = tj - ti
    s = (t - ti) / dt
    a12 = dt * s * (1.0 - s) ** 2
    p11 = s * s * (3.0 - 2.0 * s)
    p12 = dt * s * s * (s - 1.0)
    d = a12[..., None] * vi + p11[..., None] * xi + p12[..., None] * nu2
    return Ti @ lie.exp_se3(d)


def project(K, Twc, X):
    """Camera coordinates and pinhole pixels of world points X seen by
    cameras at Twc."""
    Tcw = lie.rigid_inv(Twc)
    Xc = np.einsum("...ij,...j->...i", Tcw[..., :3, :3], X) + Tcw[..., :3, 3]
    u = K[..., 0] * Xc[..., 0] / Xc[..., 2] + K[..., 2]
    v = K[..., 1] * Xc[..., 1] / Xc[..., 2] + K[..., 3]
    return Xc, u, v


def gp_prior_chi2(Ti, vi, ti, Tj, vj, tj, qc):
    """r^T Qi(dt)^-1 r of the GP prior, r = [xi - dt vi ; Jr^-1(xi) vj - vi]."""
    dt = tj - ti
    xi = lie.log_se3(lie.rigid_inv(Ti) @ Tj)
    rp = xi - dt[..., None] * vi
    rv = (lie.right_jacobian_inv(xi) @ vj[..., None])[..., 0] - vi
    q = 1.0 / qc
    return ((12.0 / dt ** 3)[..., None] * q * rp * rp - 2.0 * (6.0 / dt ** 2)[..., None] * q * rp * rv
            + (4.0 / dt)[..., None] * q * rv * rv).sum(-1)


def _rows(p, kind, n):
    valid = p.get(f"{kind}_valid")
    return np.arange(n) if valid is None else np.nonzero(np.asarray(valid, bool))[0]


def parts(p: dict, rig: dict, state: dict, gp_huber: bool) -> dict:
    """The cost's terms at `state` {"T", "v", "Text", "X"}. `rig`: "Tbc",
    "K", "bf", "qc" (the GP's power spectral density), "ext_info" (scalar
    information of the extrinsic rotation priors)."""
    Tbc, K, bf = rig["Tbc"], rig["K"], rig["bf"]
    qc = np.asarray(rig["qc"], np.float64)
    T, v, Text, X = (np.asarray(state[k], np.float64) for k in ("T", "v", "Text", "X"))
    times = np.asarray(p["times"], np.float64)
    Cx = len(K) - 1
    cams = np.concatenate([Text, Tbc[-1:]], 0)
    out = {}

    e = _rows(p, "mg", len(p["mg_lm"]))
    i, j = p["mg_pair"][e, 0], p["mg_pair"][e, 1]
    c = p["mg_cam"][e]
    Tt = gp_pose(T[i], v[i], times[i], T[j], v[j], times[j], np.asarray(p["mg_t"])[e])
    _, u, vv = project(K[c], Tt @ cams[c], X[p["mg_lm"][e]])
    r = np.asarray(p["mg_obs"])[e] - np.stack([u, vv], 1)
    out["mono_gp"] = float(huber((r * r).sum(1), DELTA2_MONO).sum())

    e = _rows(p, "st", len(p["st_lm"]))
    k = p["st_pose"][e]
    Xc, u, vv = project(K[-1], T[k] @ Tbc[-1], X[p["st_lm"][e]])
    st = np.asarray(p["st_is_stereo"], bool)[e]
    r = np.asarray(p["st_obs"])[e] - np.stack([u, vv, u - bf / Xc[:, 2]], 1)
    r[:, 2] = np.where(st, r[:, 2], 0.0)
    out["stereo"] = float(huber((r * r).sum(1), np.where(st, DELTA2_STEREO, DELTA2_MONO)).sum())

    if "sg_lm" in p and len(p["sg_lm"]):
        e = _rows(p, "sg", len(p["sg_lm"]))
        i, j = p["sg_pair"][e, 0], p["sg_pair"][e, 1]
        Tt = gp_pose(T[i], v[i], times[i], T[j], v[j], times[j], np.asarray(p["sg_t"])[e])
        Xc, u, vv = project(K[-1], Tt @ Tbc[-1], X[p["sg_lm"][e]])
        r = np.asarray(p["sg_obs"])[e] - np.stack([u, vv, u - bf / Xc[:, 2]], 1)
        out["stereo_gp"] = float(huber((r * r).sum(1), DELTA2_STEREO).sum())

    if "gp_pairs" in p:
        g = _rows(p, "gp", len(p["gp_pairs"]))
        a, b = p["gp_pairs"][g, 0], p["gp_pairs"][g, 1]
    else:
        a, b = np.arange(len(T) - 1), np.arange(1, len(T))
    s = gp_prior_chi2(T[a], v[a], times[a], T[b], v[b], times[b], qc)
    out["gp_prior"] = float((huber(s, DELTA_GP ** 2) if gp_huber else s).sum())

    free = (np.asarray(p["vel_valid"], bool) if "vel_valid" in p
            else np.arange(len(T)) >= int(p["n_fixed"]))
    out["velocity_prior"] = float((v[free, 2] ** 2 / qc[2]).sum())

    re = lie.log_so3(np.swapaxes(Tbc[:Cx, :3, :3], -1, -2) @ Text[:, :3, :3])
    out["extrinsic_prior"] = float(rig["ext_info"] * (re * re).sum())
    return out


def cost(p: dict, rig: dict, state: dict, gp_huber: bool) -> float:
    return float(sum(parts(p, rig, state, gp_huber).values()))
