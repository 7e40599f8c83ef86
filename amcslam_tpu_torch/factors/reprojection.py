"""Reprojection factors: pinhole/stereo at a keyframe state and through the
GP-interpolated pose of an asynchronous camera.

Port of `amcslam_tpu/factors/reprojection.py` as the table-driven local
GP-BA and the per-frame pose solver run it: the projections and their
Jacobians (`:31-62`), `_se3_deriv`, `mono_residual[_jac]` and
`stereo_residual[_jac]` (`:70-117`), the per-edge GP factors
(`_gp_vertex_chains`, `mono_gp_residual[_jac]`, `stereo_gp_residual_jac`,
`:125-233`), the pair and interpolation packs (`gp_pair_pack` `:254`,
`gp_interp_pack` `:348`), the packed factors that evaluate the chain per
edge from a pair pack (`_gp_edge_core`, `_gp_jac_from_M`,
`{mono,stereo}_gp_residual_jac_packed`, `:267-330`: the per-edge fallback of
`make_ba_problem` without interp-combo tables) and the interp-pack factors
(`:371-419`).

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


def mono_residual(Twb, Tbc, K, Xw, obs):
    """err = obs - pi(Tcb * Twb^-1 * Xw)  (EdgeMono/EdgeMonoOnlyPose)."""
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc), Xc


def mono_residual_jac(Twb, Tbc, K, Xw, obs):
    """(r, J_pose (...,2,12), J_point (...,2,3), Xc); the velocity block of
    J_pose is zero."""
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    J_pose6 = -(pj @ _se3_deriv(Rcb, Xb))
    J_pose = torch.cat([J_pose6, torch.zeros_like(J_pose6)], -1)
    Rbw = Twb[..., :3, :3].transpose(-1, -2)
    J_point = -((pj @ Rcb) @ Rbw)
    return r, J_pose, J_point, Xc


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
# Per-edge GP-interpolated reprojection (async cameras)
# ---------------------------------------------------------------------------
# The endpoint states (T1, v1, T2, v2) may be single (4,4)/(6,) tensors while
# t, Xw and obs carry an edge batch: the pair-level chain is then computed
# once and broadcast, which is what the reference's vmap over edges with the
# endpoints closed over computes.


def _cat(xs, dim: int) -> torch.Tensor:
    """torch.cat over tensors whose batch dimensions broadcast."""
    shape = torch.broadcast_shapes(*(x.shape[:-2] for x in xs))
    return torch.cat([x.expand(*shape, *x.shape[-2:]) for x in xs], dim)


def _gp_vertex_chains(dT, xi12, v2, t1, t2, t):
    """The shared Jacobian chain blocks of the GP-interpolated factors:
    (Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2), the maps from the
    endpoint-state perturbations to the perturbation of the interpolated
    local pose increment (G2oTypes.cc:177-223)."""
    dxi = lie.log_se3(dT)
    Ad_dT = lie.adj_se3(lie.exp_se3(-dxi))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    Jr_inv_xi12 = lie.right_jacobian_pose3_inv(xi12)
    ad_v2 = lie.se3_ad(v2)
    Ad_T12_inv = lie.adj_se3(lie.se3_inv(lie.exp_se3(xi12)))

    top_T1 = -(Jr_inv_xi12 @ Ad_T12_inv)
    z6 = torch.zeros_like(top_T1)
    eye6 = torch.eye(6, dtype=dT.dtype, device=dT.device)
    JinT1 = _cat([top_T1, -0.5 * (ad_v2 @ top_T1)], -2)  # (..., 12, 6)
    JinV1 = _cat([z6, eye6], -2)
    JinT2 = _cat([Jr_inv_xi12, -0.5 * (ad_v2 @ Jr_inv_xi12)], -2)
    JinV2 = _cat([z6, Jr_inv_xi12], -2)

    a11, a12, p11, p12 = (gp._s(c) for c in gp.interp_coeffs(t1, t2, t))
    At1 = _cat([a11 * eye6, a12 * eye6], -1)
    Pt1 = _cat([p11 * eye6, p12 * eye6], -1)
    return Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2


def _gp_pose_jacs(J1cam, dT, xi12, v2, t1, t2, t):
    """(J1, J2) (..., m, 12) of a GP edge from its camera chain J1cam."""
    Jr_dxi, Pt1, At1, Ad_dT, JinT1, JinV1, JinT2, JinV2 = _gp_vertex_chains(
        dT, xi12, v2, t1, t2, t)
    JrP = Jr_dxi @ Pt1  # (..., 6, 12)
    J1_T = J1cam @ (JrP @ JinT1 + Ad_dT)
    J1_V = J1cam @ ((Jr_dxi @ At1) @ JinV1)
    Jj1 = J1cam @ JrP
    return _cat([J1_T, J1_V], -1), _cat([Jj1 @ JinT2, Jj1 @ JinV2], -1)


def _gp_query(T1, v1, t1, T2, v2, t2, t):
    eye = torch.eye(6, dtype=T1.dtype, device=T1.device)
    return gp.query_pose_aux(T1, T2, v1, v2, t1, t2, t, eye, eye)


def mono_gp_residual(T1, v1, t1, T2, v2, t2, t, Tbc, K, Xw, obs):
    """err = obs - pi(Tcb * QueryPose(...)^-1 * Xw) (EdgeMonoGP*::computeError)."""
    Twb, _ = _gp_query(T1, v1, t1, T2, v2, t2, t)
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(lie.se3_inv(Tbc), Xb)
    return obs - project_pinhole(K, Xc), Xc


def mono_gp_residual_jac(T1, v1, t1, T2, v2, t2, t, Tbc, K, Xw, obs):
    """GP-interpolated mono reprojection with analytic Jacobians:
    (r, J1 (...,2,12), J2 (...,2,12), J_point (...,2,3), J_ext (...,2,6), Xc)
    wrt both endpoint pose-vel states, the landmark and the extrinsic."""
    Twb, (_, _, dT, xi12) = _gp_query(T1, v1, t1, T2, v2, t2, t)
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))  # d r / d (interpolated pose)
    J1, J2 = _gp_pose_jacs(J1cam, dT, xi12, v2, t1, t2, t)
    J_point = -((pj @ Rcb) @ Twb[..., :3, :3].transpose(-1, -2))
    return r, J1, J2, J_point, _ext_jac(pj, Xc), Xc


def stereo_gp_residual_jac(T1, v1, t1, T2, v2, t2, t, Tbc, K, bf, Xw, obs):
    """GP-interpolated stereo reprojection (EdgeStereoGP):
    (r, J1 (...,3,12), J2 (...,3,12), J_point (...,3,3), Xc)."""
    Twb, (_, _, dT, xi12) = _gp_query(T1, v1, t1, T2, v2, t2, t)
    Tcb = lie.se3_inv(Tbc)
    Rcb = Tcb[..., :3, :3]
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))
    J1, J2 = _gp_pose_jacs(J1cam, dT, xi12, v2, t1, t2, t)
    J_point = -((pj @ Rcb) @ Twb[..., :3, :3].transpose(-1, -2))
    return r, J1, J2, J_point, Xc


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


def _gp_edge_core(pack, T1, v1, t1, t2, t, Tbc, Xw):
    """Shared per-edge geometry of the packed factors: the interpolated pose
    from the pair pack, the point in body and camera frames and the
    pair-pack scalar coefficients (a12, p11, p12)."""
    _, a12, p11, p12 = gp.interp_coeffs(t1, t2, t)
    dxi = a12[..., None] * v1 + p11[..., None] * pack["xi12"] + p12[..., None] * pack["nu2"]
    dT = lie.exp_se3(dxi)
    Twb = T1 @ dT
    Tcb = lie.se3_inv(Tbc)
    Xb = lie.transform_point(lie.se3_inv(Twb), Xw)
    Xc = lie.transform_point(Tcb, Xb)
    Ad_dT = lie.adj_se3(lie.se3_inv(dT))
    Jr_dxi = lie.right_jacobian_pose3(dxi)
    return (a12, p11, p12), Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi


def _gp_jac_from_M(M, J1cam, Ad_dT, pack, coeffs):
    """(J1, J2) from M = J1cam @ Jr(dxi): the scalar-block products
    J1 = [p11 M A1 + p12 M B1 + J1cam Ad(dT^-1), a12 M],
    J2 = [p11 M Jr_inv + p12 M B2, p12 M Jr_inv]."""
    a12, p11, p12 = (c[..., None, None] for c in coeffs)
    J1 = _cat([p11 * (M @ pack["A1"]) + p12 * (M @ pack["B1"]) + J1cam @ Ad_dT, a12 * M], -1)
    MJr = M @ pack["Jr_inv"]
    J2 = _cat([p11 * MJr + p12 * (M @ pack["B2"]), p12 * MJr], -1)
    return J1, J2


def mono_gp_residual_jac_packed(pack, T1, v1, t1, t2, t, Tbc, K, Xw, obs):
    """EdgeMonoGP[Extrinsic] from a pair pack: (r, J1 (...,2,12),
    J2 (...,2,12), J_point (...,2,3), J_ext (...,2,6), Xc), identical to
    mono_gp_residual_jac."""
    coeffs, Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi = _gp_edge_core(pack, T1, v1, t1, t2, t, Tbc, Xw)
    r = obs - project_pinhole(K, Xc)
    pj = project_jac_pinhole(K, Xc)
    Rcb = Tcb[..., :3, :3]
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))
    J1, J2 = _gp_jac_from_M(J1cam @ Jr_dxi, J1cam, Ad_dT, pack, coeffs)
    J_point = -((pj @ Rcb) @ Twb[..., :3, :3].transpose(-1, -2))
    return r, J1, J2, J_point, _ext_jac(pj, Xc), Xc


def stereo_gp_residual_jac_packed(pack, T1, v1, t1, t2, t, Tbc, K, bf, Xw, obs):
    """EdgeStereoGP from a pair pack: (r, J1, J2, J_point, Xc)."""
    coeffs, Twb, Tcb, Xb, Xc, Ad_dT, Jr_dxi = _gp_edge_core(pack, T1, v1, t1, t2, t, Tbc, Xw)
    r = obs - project_stereo(K, bf, Xc)
    pj = project_jac_stereo(K, bf, Xc)
    Rcb = Tcb[..., :3, :3]
    J1cam = -(pj @ _se3_deriv(Rcb, Xb))
    J1, J2 = _gp_jac_from_M(J1cam @ Jr_dxi, J1cam, Ad_dT, pack, coeffs)
    J_point = -((pj @ Rcb) @ Twb[..., :3, :3].transpose(-1, -2))
    return r, J1, J2, J_point, Xc


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
