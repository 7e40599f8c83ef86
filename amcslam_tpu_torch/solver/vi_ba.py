"""Visual-inertial bundle adjustment (BASELINE config 4), in PyTorch.

Port of `amcslam_tpu/solver/vi_ba.py`: per-keyframe inertial states
(R, p, v) with gyro/accel biases, preintegrated IMU factors between
consecutive keyframes (factors/imu.py), bias random-walk factors, and mono
reprojection edges against free landmarks, which are Schur-eliminated with
batched 3x3 inverses. Parameter layout per keyframe: [dphi, dp, dv, dbg, dba]
(15). The reduced system is small (15 K) and dense: Cholesky, with a NaN
step where it is not positive definite (the reference's `cho_factor`
gives NaN there), so the LM driver rejects the trial as the reference's
does. The reference's one-hot segment reductions are `index_add_` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.imu import InertialState, imu_residual_jac
from ..factors.reprojection import project_jac_pinhole, project_pinhole
from ..ops import imu, lie
from . import robust
from .ba import _inv3x3
from .lm import LMProblem, lm_optimize


class VIBAData(NamedTuple):
    # IMU factors between consecutive KFs (K-1 of them, padded allowed)
    pre: imu.PreintState        # batched PreintState, leading dim (Ki,)
    imu_pairs: torch.Tensor     # (Ki,2) int64
    imu_valid: torch.Tensor     # (Ki,) bool
    bg_lin: torch.Tensor        # (Ki,3) linearization bias of each window
    ba_lin: torch.Tensor        # (Ki,3)
    walk_info: torch.Tensor     # (6,6) bias random-walk information per step
    gravity: torch.Tensor       # (3,)
    # reprojection edges
    obs: torch.Tensor           # (E,2)
    obs_kf: torch.Tensor        # (E,) int64
    obs_lm: torch.Tensor        # (E,) int64
    obs_cam: torch.Tensor       # (E,) int64
    w: torch.Tensor             # (E,)
    obs_valid: torch.Tensor     # (E,) bool
    Tbc: torch.Tensor           # (C,4,4)
    K_intr: torch.Tensor        # (C,4)
    pose_fixed: torch.Tensor    # (K,) bool
    huber_mono: float = 2.447   # sqrt(5.991)


class VIBAState(NamedTuple):
    R: torch.Tensor   # (K,3,3)
    p: torch.Tensor   # (K,3)
    v: torch.Tensor   # (K,3)
    bg: torch.Tensor  # (K,3)
    ba: torch.Tensor  # (K,3)
    X: torch.Tensor   # (L,3)


def _reproj_eval(data: VIBAData, state: VIBAState):
    """(r (E,2), J_pose (E,2,9), J_lm (E,2,3), z (E,)) of the mono edges
    under the retraction R <- R exp(dphi), p <- p + dp (not the SE(3)
    right retraction of the GP solver)."""
    R = state.R[data.obs_kf]
    Twb = lie.se3_matrix(R, state.p[data.obs_kf])
    Xb = lie.transform_point(lie.se3_inv(Twb), state.X[data.obs_lm])
    Tcb = lie.se3_inv(data.Tbc[data.obs_cam])
    Xc = lie.transform_point(Tcb, Xb)
    Kc = data.K_intr[data.obs_cam]
    r = data.obs - project_pinhole(Kc, Xc)
    pj = project_jac_pinhole(Kc, Xc)
    Rcb = Tcb[..., :3, :3]
    pjR = pj @ Rcb
    RT = R.transpose(-1, -2)
    J_pose = torch.cat([-(pjR @ lie.hat(Xb)), -(pjR @ -RT), torch.zeros_like(pj)], -1)
    J_lm = -(pjR @ RT)
    return r, J_pose, J_lm, Xc[..., 2]


def _imu_eval(data: VIBAData, state: VIBAState):
    i, j = data.imu_pairs[:, 0], data.imu_pairs[:, 1]
    si = InertialState(R=state.R[i], p=state.p[i], v=state.v[i])
    sj = InertialState(R=state.R[j], p=state.p[j], v=state.v[j])
    r, Ji, Jj, Jbg, Jba = imu_residual_jac(si, sj, state.bg[i], state.ba[i], data.pre,
                                           data.bg_lin, data.ba_lin, data.gravity)
    eye9 = torch.eye(9, dtype=r.dtype, device=r.device)
    info = torch.linalg.inv(data.pre.C[:, :9, :9] + 1e-10 * eye9)
    return r, Ji, Jj, Jbg, Jba, info


def _bias_walk(data: VIBAData, state: VIBAState):
    """(Ki,6) bias change [bg_j - bg_i, ba_j - ba_i] of each IMU pair."""
    i, j = data.imu_pairs[:, 0], data.imu_pairs[:, 1]
    db = torch.cat([state.bg[j] - state.bg[i], state.ba[j] - state.ba[i]], 1)
    return torch.where(data.imu_valid[:, None], db, torch.zeros_like(db))


def make_vi_ba_problem(data: VIBAData) -> LMProblem:
    """VI-BA with the landmark Schur complement. Reprojection edges reduce
    into per-keyframe 9x9 blocks, each IMU factor and bias-walk factor is
    one block of its own; Hpp assembles with one `index_put_` of every
    block onto its columns."""
    K = data.pose_fixed.shape[0]
    dtype, dev = data.obs.dtype, data.obs.device
    delta = torch.as_tensor(data.huber_mono, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    act_obs = data.obs_valid
    pose_act = (~data.pose_fixed).to(dtype)
    P = 15 * K
    act_vec = pose_act.repeat_interleave(15)
    i_, j_ = data.imu_pairs[:, 0], data.imu_pairs[:, 1]
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def chi2(state: VIBAState):
        r, _, _, _ = _reproj_eval(data, state)
        r = torch.where(act_obs[:, None], r, zero)
        s = (r * r).sum(-1) * data.w
        rho0, _ = robust.huber_rho01(s, delta, True)
        c = torch.where(act_obs, rho0, zero).sum()

        r_i, _, _, _, _, info = _imu_eval(data, state)
        r_i = torch.where(data.imu_valid[:, None], r_i, zero)
        c = c + torch.einsum("ei,eij,ej->e", r_i, info, r_i).sum()

        db = _bias_walk(data, state)
        return c + torch.einsum("ei,ij,ej->e", db, data.walk_info, db).sum()

    def linearize(state: VIBAState):
        L = state.X.shape[0]
        blocks = []  # (H (S,w,w), b (S,w), cols (S,w))

        # ===== reprojection edges: per-keyframe 9x9 blocks =====
        r, Jp, Jl, _ = _reproj_eval(data, state)
        m = act_obs[:, None]
        r = torch.where(m, r, zero)
        Jp = torch.where(m[..., None], Jp, zero) * pose_act[data.obs_kf][:, None, None]
        Jl = torch.where(m[..., None], Jl, zero)
        s = (r * r).sum(-1) * data.w
        _, rho1 = robust.huber_rho01(s, delta, True)
        wgt = torch.where(act_obs, data.w * rho1, zero)
        JpW = Jp * wgt[:, None, None]
        Hs = JpW.new_zeros((K, 9, 9)).index_add_(0, data.obs_kf, JpW.transpose(1, 2) @ Jp)
        bs = JpW.new_zeros((K, 9)).index_add_(0, data.obs_kf, -(JpW * r[:, :, None]).sum(1))
        blocks.append((Hs, bs, 15 * torch.arange(K, device=dev)[:, None]
                       + torch.arange(9, device=dev)))
        # landmark coupling (3,9) per edge -> (L,K) block grid
        JlW = Jl * wgt[:, None, None]
        Wp = JlW.new_zeros((L * K, 3, 9)).index_add_(
            0, data.obs_lm * K + data.obs_kf, JlW.transpose(1, 2) @ Jp)
        Wt = torch.nn.functional.pad(Wp.reshape(L, K, 3, 9), (0, 6))
        Wt = Wt.permute(0, 2, 1, 3).reshape(L, 3, P)
        Hll = JlW.new_zeros((L, 3, 3)).index_add_(0, data.obs_lm, JlW.transpose(1, 2) @ Jl)
        bl = JlW.new_zeros((L, 3)).index_add_(0, data.obs_lm, -(JlW * r[:, :, None]).sum(1))

        # ===== IMU factors (one block each) =====
        r_i, Ji, Jj, Jbg, Jba, info = _imu_eval(data, state)
        mi = data.imu_valid[:, None]
        r_i = torch.where(mi, r_i, zero)
        Ji, Jj, Jbg, Jba = (torch.where(mi[..., None], J, zero) for J in (Ji, Jj, Jbg, Jba))
        # the bias columns belong to keyframe i: a fixed keyframe keeps its
        # biases too
        act_i = pose_act[i_][:, None, None]
        Jfull = torch.cat([Ji * act_i, Jbg * act_i, Jba * act_i,
                           Jj * pose_act[j_][:, None, None]], 2)  # (Ki,9,24)
        cols_i = torch.cat([15 * i_[:, None] + torch.arange(15, device=dev),
                            15 * j_[:, None] + torch.arange(9, device=dev)], 1)
        JWi = info @ Jfull
        blocks.append((JWi.transpose(1, 2) @ Jfull,
                       -torch.einsum("eri,er->ei", JWi, r_i), cols_i))

        # ===== bias random walk (one block each) =====
        db = _bias_walk(data, state)
        Jw = torch.cat([-eye6, eye6], 1).expand(db.shape[0], 6, 12)
        Jw = torch.where(mi[..., None], Jw, zero)
        # each 6-column half masked by its keyframe's activity
        act_w = torch.cat([pose_act[i_][:, None].expand(-1, 6),
                           pose_act[j_][:, None].expand(-1, 6)], 1)
        Jw = Jw * act_w[:, None, :]
        cols_w = torch.cat([15 * i_[:, None] + 9 + torch.arange(6, device=dev),
                            15 * j_[:, None] + 9 + torch.arange(6, device=dev)], 1)
        JWw = data.walk_info @ Jw
        blocks.append((JWw.transpose(1, 2) @ Jw, -torch.einsum("eri,er->ei", JWw, db), cols_w))

        # ===== Hpp/bp =====
        Hpp = state.X.new_zeros((P, P))
        bp = state.X.new_zeros(P)
        for Hb, bb, cols in blocks:
            cols = cols.expand(Hb.shape[0], -1)
            Hpp.index_put_((cols[:, :, None], cols[:, None, :]), Hb, accumulate=True)
            bp.index_put_((cols,), bb, accumulate=True)
        return Hpp, bp, Wt, Hll, bl

    def max_abs_diag(lin):
        Hpp, _, _, Hll, _ = lin
        m1 = (torch.diagonal(Hpp).abs() * act_vec).max()
        return torch.maximum(m1, torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max())

    def solve(lin, lam):
        Hpp, bp, Wt, Hll, bl = lin
        L = Hll.shape[0]
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hll_inv = _inv3x3(Hll + lam * eye3)
        Y = Hll_inv @ Wt
        Y2, W2 = Y.reshape(3 * L, P), Wt.reshape(3 * L, P)
        Hs = Hpp + torch.diag(lam * act_vec + (1.0 - act_vec)) - Y2.T @ W2
        bs = bp - Y2.T @ bl.reshape(3 * L)
        Lc, info = torch.linalg.cholesky_ex(Hs)
        dxp = torch.cholesky_solve(bs[:, None], Lc)[:, 0]
        dxp = torch.where(info == 0, dxp, torch.full_like(dxp, float("nan")))
        dxl = (Hll_inv @ (bl - (Wt @ dxp))[:, :, None])[:, :, 0]
        dx = torch.cat([dxp, dxl.reshape(-1)])
        return dx, dxp @ dxp + (dxl * dxl).sum(), dxp @ bp + (dxl * bl).sum()

    def retract(state: VIBAState, dx):
        d = dx[:P].reshape(K, 15)
        return VIBAState(
            R=state.R @ lie.exp_so3(d[:, :3]),
            p=state.p + d[:, 3:6],
            v=state.v + d[:, 6:9],
            bg=state.bg + d[:, 9:12],
            ba=state.ba + d[:, 12:15],
            X=state.X + dx[P:].reshape(-1, 3),
        )

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def vi_ba(data: VIBAData, state: VIBAState, num_iterations=10, lambda_init=1e-2):
    """LM on the VI-BA problem; returns (state, LMStats)."""
    return lm_optimize(make_vi_ba_problem(data), state, num_iterations,
                       lambda_init=lambda_init)
