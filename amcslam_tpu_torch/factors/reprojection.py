"""Reprojection factors: pinhole/stereo at a keyframe state and through the
GP-interpolated pose of an asynchronous camera.

Port of the slice of `amcslam_tpu/factors/reprojection.py` that the
table-driven local GP-BA runs: the projections and their Jacobians
(`:31-62`), `_se3_deriv`, `stereo_residual[_jac]` (`:98-117`), the pair and
interpolation packs (`gp_pair_pack` `:254`, `gp_interp_pack` `:348`) and the
interp-pack factors (`:371-419`). The per-edge/packed GP variants
(`:125-330`) are not ported yet.

Every function is batched over leading dimensions (the reference's `vmap`
written out). Conventions: state pose Twb (body->world), world landmark Xw,
camera extrinsic Tbc (camera->body), residual = obs - project(...),
intrinsics (fx, fy, cx, cy). Arguments broadcast against each other, so a
single (4, 4) extrinsic or (4,) intrinsics serves a batch of edges.
"""

from __future__ import annotations

import torch

from ..ops import gp, lie


def project_pinhole(K: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Pinhole projection. K = (fx, fy, cx, cy) -> (..., 2)."""
    invz = 1.0 / Xc[..., 2]
    return torch.stack(
        [K[..., 0] * Xc[..., 0] * invz + K[..., 2], K[..., 1] * Xc[..., 1] * invz + K[..., 3]],
        -1,
    )


def project_jac_pinhole(K: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) d(project)/dXc."""
    invz = 1.0 / Xc[..., 2]
    invz2 = invz * invz
    z = torch.zeros_like(invz)
    fx, fy = K[..., 0] * torch.ones_like(invz), K[..., 1] * torch.ones_like(invz)
    return torch.stack(
        [
            torch.stack([fx * invz, z, -fx * Xc[..., 0] * invz2], -1),
            torch.stack([z, fy * invz, -fy * Xc[..., 1] * invz2], -1),
        ],
        -2,
    )


def project_stereo(K: torch.Tensor, bf, Xc: torch.Tensor) -> torch.Tensor:
    """(u_l, v_l, u_r) with u_r = u_l - bf/z."""
    uv = project_pinhole(K, Xc)
    return torch.cat([uv, uv[..., :1] - (bf / Xc[..., 2])[..., None]], -1)


def project_jac_stereo(K: torch.Tensor, bf, Xc: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) stereo projection Jacobian (EdgeStereo::linearizeOplus)."""
    J2 = project_jac_pinhole(K, Xc)
    inv_z2 = 1.0 / (Xc[..., 2] * Xc[..., 2])
    row_r = J2[..., 0, :].clone()
    row_r[..., 2] = row_r[..., 2] + bf * inv_z2
    return torch.cat([J2, row_r[..., None, :]], -2)


def _se3_deriv(Rcb: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """(..., 3, 6) dXc/d(dxi) for Twb <- Twb exp(dxi): [-Rcb, Rcb*hat(Xb)]."""
    Rcb = Rcb.expand(*Xb.shape[:-1], 3, 3)
    return torch.cat([-Rcb, Rcb @ lie.hat(Xb)], -1)


def stereo_residual(Twb, Tbc, K, bf, Xw, obs):
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_stereo(K, bf, Xc), Xc


def stereo_residual_jac(Twb, Tbc, K, bf, Xw, obs):
    """(r, J_pose (...,3,12), J_point (...,3,3), Xc)."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    J_pose6 = -(pj @ _se3_deriv(Rcb, Xb))
    J_pose = torch.cat([J_pose6, torch.zeros_like(J_pose6)], -1)
    Rbw = Twb[..., :3, :3].transpose(-1, -2)
    J_point = -((pj @ Rcb) @ Rbw)
    return r, J_pose, J_point, Xc


# ---------------------------------------------------------------------------
# Interp packs: the GP chain per (pose-pair, timestamp)
# ---------------------------------------------------------------------------
# Every GP edge whose observation was triggered at the same camera timestamp
# shares the whole interpolation chain; the pose Jacobians factor exactly as
# [J1 | J2] = J1cam @ Q with J1cam the per-edge (2,6) camera chain and Q a
# per-(pair, t) (6, 24) matrix (see the reference, reprojection.py:333-345).


def gp_pair_pack(T1, v1, T2, v2):
    """Per-pose-pair quantities shared by all GP edges on (T1,v1)->(T2,v2)."""
    xi12 = lie.log_se3(lie.se3_inv(T1) @ T2)
    Jr_inv = lie.right_jacobian_pose3_inv(xi12)
    nu2 = (Jr_inv @ v2[..., None])[..., 0]
    ad_v2 = lie.se3_ad(v2)
    A1 = -(Jr_inv @ lie.adj_se3(lie.se3_inv(lie.exp_se3(xi12))))
    B1 = -0.5 * (ad_v2 @ A1)
    B2 = -0.5 * (ad_v2 @ Jr_inv)
    return {"xi12": xi12, "nu2": nu2, "Jr_inv": Jr_inv, "A1": A1,
            "B1": B1, "B2": B2}


def gp_interp_pack(pack, T1, v1, t1, t2, t):
    """Per-(pose-pair, timestamp) interpolation pack {"Twb", "Tbw", "Q"}:
    Twb the GP-interpolated body pose at t, Q (..., 6, 24) the right factor
    of the pose Jacobians (J1 = J1cam @ Q[:, :12], J2 = J1cam @ Q[:, 12:])."""
    _, a12, p11, p12 = gp.interp_coeffs(t1, t2, t)
    dxi = a12[..., None] * v1 + p11[..., None] * pack["xi12"] + p12[..., None] * pack["nu2"]
    dT = lie.exp_se3(dxi)
    Twb = T1 @ dT
    Ad_dT = lie.adj_se3(lie.se3_inv(dT))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    a12, p11, p12 = a12[..., None, None], p11[..., None, None], p12[..., None, None]
    Q1 = Jr_dxi @ (p11 * pack["A1"] + p12 * pack["B1"]) + Ad_dT
    Q2 = a12 * Jr_dxi
    Q3 = Jr_dxi @ (p11 * pack["Jr_inv"] + p12 * pack["B2"])
    Q4 = p12 * (Jr_dxi @ pack["Jr_inv"])
    Q = torch.cat([Q1, Q2, Q3, Q4], -1)
    return {"Twb": Twb, "Tbw": lie.se3_inv(Twb), "Q": Q}


def _ext_jac(pj: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """d r / d (Tbc exp(de)) = -pj @ [-I, hat(Xc)] (EdgeMonoGPExtrinsic)."""
    Hx = lie.hat(Xc)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(Hx)
    return -(pj @ torch.cat([-eye, Hx], -1))


def mono_gp_residual_jac_interp(ip, Tbc, K, Xw, obs):
    """EdgeMonoGP[Extrinsic] from an interp pack: one point transform, a
    projection and a (2,6)@(6,24) contraction per edge.

    Returns (r, J1 (...,2,12), J2 (...,2,12), J_point (...,2,3),
    J_ext (...,2,6), Xc)."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(ip["Tbw"], Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))
    J12 = J1cam @ ip["Q"]  # (..., 2, 24)
    J_point = -((pj @ Rcb) @ ip["Twb"][..., :3, :3].transpose(-1, -2))
    return r, J12[..., :12], J12[..., 12:], J_point, _ext_jac(pj, Xc), Xc


def stereo_gp_residual_jac_interp(ip, Tbc, K, bf, Xw, obs):
    """EdgeStereoGP from an interp pack: (r, J1, J2, J_point, Xc)."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(ip["Tbw"], Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))
    J12 = J1cam @ ip["Q"]  # (..., 3, 24)
    J_point = -((pj @ Rcb) @ ip["Twb"][..., :3, :3].transpose(-1, -2))
    return r, J12[..., :12], J12[..., 12:], J_point, Xc


def mono_gp_residual_interp(Tbw, Tbc, K, Xw, obs):
    """Residual-only mono-GP from a gathered interpolated pose inverse."""
    Xb = lie.transform_point(Tbw, Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc)


def stereo_gp_residual_interp(Tbw, Tbc, K, bf, Xw, obs):
    Xb = lie.transform_point(Tbw, Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_stereo(K, bf, Xc)
