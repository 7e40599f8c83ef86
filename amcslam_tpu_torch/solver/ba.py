"""Windowed local GP bundle adjustment with landmark Schur complement.

Port of the table-driven path of `amcslam_tpu/solver/ba.py` (`:52-849`,
`:1363-1460`, host-side tables `:1624-1862`): `Optimizer::LocalGPBA` on the
g2o-exact LM loop (solver/lm.py), with

  graph = { a window of pose-vel keyframes (anchors fixed), per-async-camera
            extrinsic vertices (fixed unless refined), landmarks
            (marginalized) }
  edges = { velocity regularizers, GP motion priors along the chain,
            extrinsic rotation priors, async-camera GP-interpolated mono
            reprojections, GP-interpolated stereo reprojections,
            stereo-camera mono/stereo reprojections at KF timestamps }

Residuals and Jacobians evaluate as one batch per edge family; the GP
interpolation chain runs once per unique (structure, timestamp) combo
through `ops/interp_chain.gp_interp_packs` (the CUDA kernel on the card);
the pose Hessian assembles from 12x12 unit blocks; the Schur complement
Hpp - W Hll^-1 W^T is two dense contractions; the reduced system is solved
by Cholesky.

Only the table-driven path is ported: `mg_it`/`sg_it` (interp-combo tables)
and `lm_blk` (landmark gather tables) must be present, as the host-side
table functions below and the synthetic generator emit them; the
reference's per-edge and segment-sum fallbacks raise here.

TPU workarounds of the reference that are not ported:
  * `_onehot_gather` (one-hot matmul row gather) -> plain indexing (exact);
  * the one-hot `seg_reduce` and the segment sums -> `index_add_`;
  * the compile cache, `exact`/`smm` and pow2 re-trace bucketing. The
    host-side table functions still emit the reference's bucketed shapes,
    so arrays compare one for one.
Kept on purpose: the 12-wide phantom column groups of the extrinsic
vertices, so Hpp compares entry for entry with the reference.

On CUDA, `index_add_` accumulates with atomics: Hpp, bp and Wt change at
roundoff from run to run, and every on-card tolerance allows for that.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..factors import gp_prior, priors, reprojection
from ..ops import gp, interp_chain, lie
from ..utils.shapes import bucket_pow2
from . import robust
from .lm import LMProblem, lm_optimize

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
TH_HUBER_MONO = float(np.sqrt(5.991))
TH_HUBER_STEREO = float(np.sqrt(7.815))
TH_HUBER_GP = 21.026  # BundleAdjustment GP-prior delta (Optimizer.cc:130)


class LocalBAData(NamedTuple):
    """Problem data; field names, shapes and meaning as the reference's
    `LocalBAData`. Index fields are int64, masks bool, the rest float."""

    # --- pose vertices (K = window + fixed anchors)
    times: torch.Tensor          # (K,)
    pose_fixed: torch.Tensor     # (K,) bool
    vel_valid: torch.Tensor      # (K,) bool
    qcinv22: torch.Tensor        # ()
    # --- GP prior chain
    gp_pairs: torch.Tensor       # (Ng,2)
    gp_qi_inv: torch.Tensor      # (Ng,12,12)
    gp_valid: torch.Tensor       # (Ng,) bool
    gp_huber: torch.Tensor       # () bool
    # --- camera rig
    Tbc_stereo: torch.Tensor     # (4,4)
    K_stereo: torch.Tensor       # (4,)
    bf: torch.Tensor             # ()
    K_async: torch.Tensor        # (Cx,4)
    ext_fixed: torch.Tensor      # (Cx,) bool
    R_prior: torch.Tensor        # (Cx,3,3)
    ext_info: torch.Tensor       # (Cx,3,3)
    # --- async-camera GP mono edges
    mg_pair: torch.Tensor        # (Em,2)
    mg_lm: torch.Tensor          # (Em,)
    mg_cam: torch.Tensor         # (Em,) in [0, Cx]; Cx = the stereo camera
    mg_t: torch.Tensor           # (Em,)
    mg_obs: torch.Tensor         # (Em,2)
    mg_w: torch.Tensor           # (Em,)
    mg_valid: torch.Tensor       # (Em,) bool
    mg_close: torch.Tensor       # (Em,) bool
    mg_sid: torch.Tensor         # (Em,) structure id
    mg_sid_cols: torch.Tensor    # (Sm,30) column indices per structure
    # --- GP stereo edges
    sg_pair: torch.Tensor        # (Eg,2)
    sg_lm: torch.Tensor          # (Eg,)
    sg_t: torch.Tensor           # (Eg,)
    sg_obs: torch.Tensor         # (Eg,3)
    sg_w: torch.Tensor           # (Eg,)
    sg_valid: torch.Tensor       # (Eg,) bool
    sg_sid: torch.Tensor         # (Eg,)
    sg_sid_cols: torch.Tensor    # (Sg,24)
    # --- stereo-camera edges at KF time
    st_pose: torch.Tensor        # (Es,)
    st_lm: torch.Tensor          # (Es,)
    st_obs: torch.Tensor         # (Es,3)
    st_w: torch.Tensor           # (Es,)
    st_valid: torch.Tensor       # (Es,) bool
    st_is_stereo: torch.Tensor   # (Es,) bool
    st_close: torch.Tensor       # (Es,) bool
    # --- landmark-major gather tables (make_landmark_tables)
    lm_blk: torch.Tensor | None = None        # (L,D)
    lm_blk_g: torch.Tensor | None = None      # (L,D)
    lm_blk_valid: torch.Tensor | None = None  # (L,D) bool
    lm_edge: torch.Tensor | None = None       # (L,De)
    lm_edge_valid: torch.Tensor | None = None  # (L,De) bool
    # --- interp-combo tables (build_interp_tables)
    mg_it: torch.Tensor | None = None       # (Em,)
    mg_it_sid: torch.Tensor | None = None   # (Um,)
    mg_it_t: torch.Tensor | None = None     # (Um,)
    sg_it: torch.Tensor | None = None       # (Eg,)
    sg_it_sid: torch.Tensor | None = None   # (Ug,)
    sg_it_t: torch.Tensor | None = None     # (Ug,)

    @property
    def n_poses(self):
        return self.times.shape[0]

    @property
    def n_ext(self):
        return self.K_async.shape[0]


class BAState(NamedTuple):
    T: torch.Tensor     # (K,4,4)
    v: torch.Tensor     # (K,6)
    Text: torch.Tensor  # (Cx,4,4)
    X: torch.Tensor     # (L,3)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def _require_tables(table, what: str):
    if table is None:
        raise ValueError(
            f"LocalBAData lacks the {what} tables: only the table-driven path "
            "is ported (build them with build_interp_tables / "
            "with_landmark_tables)"
        )


def _combo_ends(data: LocalBAData, sid_cols, it_sid):
    """Pose indices (i, j) of each combo's structure. The dump combo
    (structure 0) has i == j, so dt = 0: redirect j to keep it finite (the
    edges that gather it are where-masked anyway)."""
    i_u = sid_cols[it_sid, 0] // 12
    j_u = sid_cols[it_sid, 12] // 12
    j_u = torch.where(j_u == i_u, torch.clamp(i_u + 1, max=data.n_poses - 1), j_u)
    return i_u, j_u


def _interp_packs(data: LocalBAData, state: BAState, sid_cols, it_sid, it_t):
    """Per-(structure, timestamp) interp packs {"Twb", "Tbw", "Q"}: the whole
    GP chain once per unique combo, gathered per edge by the caller."""
    i_u, j_u = _combo_ends(data, sid_cols, it_sid)
    return interp_chain.gp_interp_packs(
        state.T[i_u], state.v[i_u], state.T[j_u], state.v[j_u],
        data.times[i_u], data.times[j_u], it_t,
    )


def _interp_poses(data: LocalBAData, state: BAState, sid_cols, it_sid, it_t):
    """Residual-path variant of _interp_packs: only the interpolated pose
    inverse per unique combo (no Jacobian factor)."""
    i_u, j_u = _combo_ends(data, sid_cols, it_sid)
    eye = torch.eye(6, dtype=state.T.dtype, device=state.T.device)
    Twb, _ = gp.query_pose_aux(
        state.T[i_u], state.T[j_u], state.v[i_u], state.v[j_u],
        data.times[i_u], data.times[j_u], it_t, eye, eye,
    )
    return lie.se3_inv(Twb)


def _mono_cam_tables(data: LocalBAData, state: BAState):
    """Per-camera (Tbc, K) tables for mono-GP edges: the Cx async extrinsic
    vertices plus a last row for the stereo camera (mg_cam == Cx selects it;
    it is never optimizable), so the tables have Cx + 1 rows."""
    Text_all = torch.cat([state.Text, data.Tbc_stereo[None]], 0)
    K_all = torch.cat([data.K_async, data.K_stereo[None]], 0)
    return Text_all, K_all


def _mono_gp_eval(data: LocalBAData, state: BAState):
    E = data.mg_obs.shape[0]
    if E == 0:
        z = lambda *s: data.mg_obs.new_zeros(s)  # noqa: E731
        return z(0, 2), z(0, 2, 12), z(0, 2, 12), z(0, 2, 3), z(0, 2, 6), z(0, 3)
    _require_tables(data.mg_it, "mono-GP interp-combo")
    ips = _interp_packs(data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t)
    ip_e = {k: v[data.mg_it] for k, v in ips.items()}
    Text_all, K_all = _mono_cam_tables(data, state)
    return reprojection.mono_gp_residual_jac_interp(
        ip_e, Text_all[data.mg_cam], K_all[data.mg_cam], state.X[data.mg_lm],
        data.mg_obs,
    )


def _stereo_gp_eval(data: LocalBAData, state: BAState):
    E = data.sg_obs.shape[0]
    if E == 0:
        z = lambda *s: data.sg_obs.new_zeros(s)  # noqa: E731
        return z(0, 3), z(0, 3, 12), z(0, 3, 12), z(0, 3, 3), z(0, 3)
    _require_tables(data.sg_it, "stereo-GP interp-combo")
    ips = _interp_packs(data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t)
    ip_e = {k: v[data.sg_it] for k, v in ips.items()}
    return reprojection.stereo_gp_residual_jac_interp(
        ip_e, data.Tbc_stereo, data.K_stereo, data.bf, state.X[data.sg_lm],
        data.sg_obs,
    )


def _stereo_row_mask(data: LocalBAData):
    """(Es,3) row mask: mono observations of the stereo camera have no
    right-image row."""
    one = data.st_obs.new_ones(3)
    return torch.where(data.st_is_stereo[:, None], one, one.new_tensor([1.0, 1.0, 0.0]))


def _stereo_eval(data: LocalBAData, state: BAState):
    r3, J3, Jl, Xc = reprojection.stereo_residual_jac(
        state.T[data.st_pose], data.Tbc_stereo, data.K_stereo, data.bf,
        state.X[data.st_lm], data.st_obs,
    )
    row = _stereo_row_mask(data)
    return r3 * row, J3 * row[:, :, None], Jl * row[:, :, None], Xc[:, 2]


def _gp_chain_eval(data: LocalBAData, state: BAState):
    i, j = data.gp_pairs[:, 0], data.gp_pairs[:, 1]
    return gp_prior.gp_prior_residual_jac(
        state.T[i], state.v[i], data.times[i], state.T[j], state.v[j], data.times[j])


def _mono_gp_residuals(data: LocalBAData, state: BAState):
    """Residual-only async-camera GP evaluation (chi2 path)."""
    if data.mg_obs.shape[0] == 0:
        return data.mg_obs.new_zeros((0, 2))
    _require_tables(data.mg_it, "mono-GP interp-combo")
    Tbw_u = _interp_poses(data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t)
    Text_all, K_all = _mono_cam_tables(data, state)
    return reprojection.mono_gp_residual_interp(
        Tbw_u[data.mg_it], Text_all[data.mg_cam], K_all[data.mg_cam],
        state.X[data.mg_lm], data.mg_obs,
    )


def _stereo_gp_residuals(data: LocalBAData, state: BAState):
    if data.sg_obs.shape[0] == 0:
        return data.sg_obs.new_zeros((0, 3))
    _require_tables(data.sg_it, "stereo-GP interp-combo")
    Tbw_u = _interp_poses(data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t)
    return reprojection.stereo_gp_residual_interp(
        Tbw_u[data.sg_it], data.Tbc_stereo, data.K_stereo, data.bf,
        state.X[data.sg_lm], data.sg_obs,
    )


def _stereo_residuals(data: LocalBAData, state: BAState):
    r3, _ = reprojection.stereo_residual(
        state.T[data.st_pose], data.Tbc_stereo, data.K_stereo, data.bf,
        state.X[data.st_lm], data.st_obs,
    )
    return r3 * _stereo_row_mask(data)


def _gp_chain_residuals(data: LocalBAData, state: BAState):
    i, j = data.gp_pairs[:, 0], data.gp_pairs[:, 1]
    return gp_prior.gp_prior_residual(
        state.T[i], state.v[i], data.times[i], state.T[j], state.v[j], data.times[j])


def _masked(act, *xs):
    """NaN-safe masking: padded/invalid edges can hold degenerate geometry
    (z = 0, dt = 0) whose values are inf/NaN; `where` (not `* mask`) kills
    them before any product, since NaN * 0 = NaN."""
    out = []
    for x in xs:
        m = act.reshape(act.shape + (1,) * (x.ndim - 1))
        out.append(torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)))
    return out


def _gram(A, B):
    """sum_r A[e, r, a] B[e, r, b] -> (E, a, b)."""
    return A.transpose(1, 2) @ B


def make_ba_problem(
    data: LocalBAData,
    lvl_m,
    lvl_sg,
    lvl_st,
    huber_on: bool = True,
    ext_active=None,
) -> LMProblem:
    """Build the LM closures of the local BA. `ext_active` (Cx,) overrides
    the extrinsic fixed flags (phase-2 refinement)."""
    dtype = data.mg_obs.dtype
    dev = data.mg_obs.device
    K = data.n_poses
    Cx = data.n_ext
    # Extrinsic vertices occupy 12-wide phantom column groups (cols 6..11 of
    # each group inactive) so every landmark-coupling block is a uniform
    # (3,12) tile; inactive columns get identity rows in the damped system.
    G = K + Cx
    P = 12 * G
    _require_tables(data.lm_blk, "landmark gather")
    zero = torch.zeros((), dtype=dtype, device=dev)

    pose_act = (~data.pose_fixed).to(dtype)
    ext_act = (~data.ext_fixed if ext_active is None else ext_active.to(torch.bool)).to(dtype)
    phantom = torch.cat([torch.ones(6, dtype=dtype, device=dev),
                         torch.zeros(6, dtype=dtype, device=dev)]).repeat(Cx)
    act_vec = torch.cat([pose_act.repeat_interleave(12),
                         ext_act.repeat_interleave(12) * phantom])  # (P,)
    # mg_cam == Cx selects the stereo row (never optimizable)
    ext_act1 = torch.cat([ext_act, zero[None]])

    act_m = data.mg_valid & lvl_m
    act_sg = data.sg_valid & lvl_sg
    act_st = data.st_valid & lvl_st
    th_mono = torch.as_tensor(TH_HUBER_MONO, dtype=dtype, device=dev)
    th_stereo = torch.as_tensor(TH_HUBER_STEREO, dtype=dtype, device=dev)
    delta_st = torch.where(data.st_is_stereo, th_stereo, th_mono)

    arange12 = torch.arange(12, device=dev)
    u8 = (arange12 == 8).to(dtype)
    colK = 12 * torch.arange(K, device=dev)[:, None] + arange12[None, :]
    colE = 12 * K + 12 * torch.arange(Cx, device=dev)[:, None] + torch.arange(6, device=dev)[None, :]
    # landmark gather tables -> flat index lists, once per problem
    L = data.lm_blk.shape[0]
    blk_keys = (torch.arange(L, device=dev)[:, None] * G + data.lm_blk_g)[data.lm_blk_valid]
    blk_rows = data.lm_blk[data.lm_blk_valid]
    edge_valid = data.lm_edge_valid[..., None].to(dtype)

    def chi2(state: BAState):
        r_m = _mono_gp_residuals(data, state)
        s = (r_m * r_m).sum(-1) * data.mg_w
        rho0, _ = robust.huber_rho01(s, th_mono, huber_on)
        c = torch.where(act_m, rho0, zero).sum()

        r_sg = _stereo_gp_residuals(data, state)
        s = (r_sg * r_sg).sum(-1) * data.sg_w
        rho0, _ = robust.huber_rho01(s, th_stereo, huber_on)
        c = c + torch.where(act_sg, rho0, zero).sum()

        r_st = _stereo_residuals(data, state)
        s = (r_st * r_st).sum(-1) * data.st_w
        rho0, _ = robust.huber_rho01(s, delta_st, huber_on)
        c = c + torch.where(act_st, rho0, zero).sum()

        r_g = _gp_chain_residuals(data, state)
        s = torch.einsum("ei,eij,ej->e", r_g, data.gp_qi_inv, r_g)
        rho0, _ = robust.huber_rho01(s, TH_HUBER_GP, data.gp_huber)
        c = c + torch.where(data.gp_valid, rho0, zero).sum()

        c = c + torch.where(data.vel_valid, data.qcinv22 * state.v[:, 2] ** 2, zero).sum()

        r_e = priors.extrinsic_prior_residual(state.Text, data.R_prior)
        return c + torch.einsum("ci,cij,cj->c", r_e, data.ext_info, r_e).sum()

    def linearize(state: BAState):
        # pose-Hessian contributions: (segment blocks (S,30,30), (S,30), cols)
        seg_H, seg_b, seg_cols = [], [], []
        # landmark-coupling (3,12) blocks, in make_landmark_tables order:
        # [mono-i | mono-j | mono-ext | sg-i | sg-j | st]
        blk36 = []
        # landmark-system rows [Hll 9 | bl 3], in order [mono | sg | st]
        edge12 = []

        def add_seg(Hs, bs, cols):
            w_ = Hs.shape[1]
            seg_H.append(F.pad(Hs, (0, 30 - w_, 0, 30 - w_)))
            seg_b.append(F.pad(bs, (0, 30 - w_)))
            seg_cols.append(F.pad(cols, (0, 30 - w_)))

        def seg_reduce(Hblk, bblk, sid, n_sid):
            Hs = Hblk.new_zeros((n_sid,) + Hblk.shape[1:]).index_add_(0, sid, Hblk)
            bs = bblk.new_zeros((n_sid,) + bblk.shape[1:]).index_add_(0, sid, bblk)
            return Hs, bs

        def add_lm(JlW, Jl, r):
            E = r.shape[0]
            Hll_e = _gram(JlW, Jl).reshape(E, 9)
            bl_e = -(JlW * r[:, :, None]).sum(1)
            edge12.append(torch.cat([Hll_e, bl_e], 1))

        # ===== async-camera GP mono edges =====
        r, J1, J2, Jl, Jext, _ = _mono_gp_eval(data, state)
        r, J1, J2, Jl, Jext = _masked(act_m, r, J1, J2, Jl, Jext)
        s = (r * r).sum(-1) * data.mg_w
        _, rho1 = robust.huber_rho01(s, th_mono, huber_on)
        w = torch.where(act_m, data.mg_w * rho1, zero)
        i_, j_, c_ = data.mg_pair[:, 0], data.mg_pair[:, 1], data.mg_cam
        # fixed vertices: their Jacobian blocks vanish
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jext = Jext * ext_act1[c_][:, None, None]
        Jp = torch.cat([J1, J2, Jext], 2)  # (E,2,30)
        JpW = Jp * w[:, None, None]
        Em = Jp.shape[0]
        Hs, bs = seg_reduce(_gram(JpW, Jp), -(JpW * r[:, :, None]).sum(1),
                            data.mg_sid, data.mg_sid_cols.shape[0])
        add_seg(Hs, bs, data.mg_sid_cols)
        JlW = Jl * w[:, None, None]  # (E,2,3)
        Wblk = _gram(JlW, Jp)  # (E,3,30)
        blk36.append(Wblk[:, :, :12].reshape(Em, 36))
        blk36.append(Wblk[:, :, 12:24].reshape(Em, 36))
        blk36.append(F.pad(Wblk[:, :, 24:30], (0, 6)).reshape(Em, 36))
        add_lm(JlW, Jl, r)

        # ===== GP stereo edges =====
        r, J1, J2, Jl, _ = _stereo_gp_eval(data, state)
        r, J1, J2, Jl = _masked(act_sg, r, J1, J2, Jl)
        s = (r * r).sum(-1) * data.sg_w
        _, rho1 = robust.huber_rho01(s, th_stereo, huber_on)
        w = torch.where(act_sg, data.sg_w * rho1, zero)
        i_, j_ = data.sg_pair[:, 0], data.sg_pair[:, 1]
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jp = torch.cat([J1, J2], 2)  # (E,3,24)
        JpW = Jp * w[:, None, None]
        Eg = Jp.shape[0]
        Hs, bs = seg_reduce(_gram(JpW, Jp), -(JpW * r[:, :, None]).sum(1),
                            data.sg_sid, data.sg_sid_cols.shape[0])
        add_seg(Hs, bs, data.sg_sid_cols)
        JlW = Jl * w[:, None, None]
        Wblk = _gram(JlW, Jp)
        blk36.append(Wblk[:, :, :12].reshape(Eg, 36))
        blk36.append(Wblk[:, :, 12:24].reshape(Eg, 36))
        add_lm(JlW, Jl, r)

        # ===== stereo-camera KF edges =====
        r, J3, Jl, _ = _stereo_eval(data, state)
        r, J3, Jl = _masked(act_st, r, J3, Jl)
        s = (r * r).sum(-1) * data.st_w
        _, rho1 = robust.huber_rho01(s, delta_st, huber_on)
        w = torch.where(act_st, data.st_w * rho1, zero)
        p_ = data.st_pose
        J3 = J3 * pose_act[p_][:, None, None]
        JpW = J3 * w[:, None, None]
        Es = J3.shape[0]
        Hs, bs = seg_reduce(_gram(JpW, J3), -(JpW * r[:, :, None]).sum(1), p_, K)
        add_seg(Hs, bs, colK)
        JlW = Jl * w[:, None, None]
        blk36.append(_gram(JlW, J3).reshape(Es, 36))
        add_lm(JlW, Jl, r)

        # ===== GP prior chain (each edge its own segment) =====
        r, J1, J2 = _gp_chain_eval(data, state)
        r, J1, J2 = _masked(data.gp_valid, r, J1, J2)
        s = torch.einsum("ei,eij,ej->e", r, data.gp_qi_inv, r)
        _, rho1 = robust.huber_rho01(s, TH_HUBER_GP, data.gp_huber)
        wg = torch.where(data.gp_valid, rho1, zero)
        i_, j_ = data.gp_pairs[:, 0], data.gp_pairs[:, 1]
        J1 = J1 * pose_act[i_][:, None, None]
        J2 = J2 * pose_act[j_][:, None, None]
        Jp = torch.cat([J1, J2], 2)  # (Ng,12,24)
        JW = (data.gp_qi_inv * wg[:, None, None]) @ Jp  # Omega J
        cols = torch.cat([12 * i_[:, None] + arange12, 12 * j_[:, None] + arange12], 1)
        add_seg(_gram(JW, Jp), -(JW * r[:, :, None]).sum(1), cols)

        # ===== extrinsic priors =====
        r_e = priors.extrinsic_prior_residual(state.Text, data.R_prior)
        J_e = priors.extrinsic_prior_jac(state.Text, data.R_prior) * ext_act[:, None, None]
        JW_e = data.ext_info @ J_e
        add_seg(_gram(JW_e, J_e), -(JW_e * r_e[:, :, None]).sum(1), colE)

        # ===== Hpp/bp from 12x12 unit blocks =====
        # every segment block is made of 12-aligned unit sub-blocks
        # (make_structure_ids guarantees it), so the (S,30,30) blocks land on
        # the (G,G) grid of unit pairs with one index_add_
        H_all = torch.cat(seg_H, 0)
        b_all = torch.cat(seg_b, 0)
        cols_all = torch.cat(seg_cols, 0)
        S_tot = H_all.shape[0]
        H36 = F.pad(H_all, (0, 6, 0, 6))
        b36 = F.pad(b_all, (0, 6))
        units = cols_all[:, ::12] // 12  # (S,3)
        subs = H36.reshape(S_tot, 3, 12, 3, 12).permute(0, 1, 3, 2, 4)
        keys = (units[:, :, None] * G + units[:, None, :]).reshape(-1)
        Hu = H36.new_zeros((G * G, 12, 12)).index_add_(0, keys, subs.reshape(S_tot * 9, 12, 12))
        Hpp = Hu.reshape(G, G, 12, 12).permute(0, 2, 1, 3).reshape(P, P)
        bp = b36.new_zeros((G, 12)).index_add_(0, units.reshape(-1), b36.reshape(S_tot * 3, 12))
        bp = bp.reshape(P)

        # ===== velocity edges (diagonal) =====
        wv = torch.where(data.vel_valid, data.qcinv22, zero) * pose_act
        zext = torch.zeros(12 * Cx, dtype=dtype, device=dev)
        Hpp = Hpp + torch.diag(torch.cat([(wv[:, None] * u8).reshape(-1), zext]))
        bp = bp + torch.cat([(-(wv * state.v[:, 2])[:, None] * u8).reshape(-1), zext])

        # ===== landmark side =====
        blk_vals = torch.cat(blk36, 0)  # (B,36)
        Wt = blk_vals.new_zeros((L * G, 36)).index_add_(0, blk_keys, blk_vals[blk_rows])
        Wt = Wt.reshape(L, G, 3, 12).permute(0, 2, 1, 3).reshape(L, 3, P)
        ev = torch.cat(edge12, 0)  # (E_tot,12)
        se = (ev[data.lm_edge] * edge_valid).sum(1)  # (L,12)
        Hll = se[:, :9].reshape(L, 3, 3)
        bl = se[:, 9:12]
        return (Hpp, bp, Wt, Hll, bl)

    def max_abs_diag(lin):
        Hpp, bp, Wt, Hll, bl = lin
        m1 = (torch.diagonal(Hpp).abs() * act_vec).max()
        m2 = torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max()
        return torch.maximum(m1, m2)

    def solve(lin, lam):
        Hpp, bp, Wt, Hll, bl = lin
        L_ = Hll.shape[0]
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hll_inv = _inv3x3(Hll + lam * eye3)
        Y = Hll_inv @ Wt  # (L,3,P)
        Y2, W2 = Y.reshape(3 * L_, P), Wt.reshape(3 * L_, P)
        Hs = Hpp + torch.diag(lam * act_vec + (1.0 - act_vec)) - Y2.T @ W2
        bs = bp - Y2.T @ bl.reshape(3 * L_)
        # a non-PD Hs gives NaN dx (as the reference's cho_factor does), so
        # the LM loop rejects the trial and raises lambda
        Lc, info = torch.linalg.cholesky_ex(Hs)
        dxp = torch.cholesky_solve(bs[:, None], Lc)[:, 0]
        dxp = torch.where(info == 0, dxp, torch.full_like(dxp, float("nan")))
        dxl = (Hll_inv @ (bl - (Wt @ dxp))[:, :, None])[:, :, 0]
        dot_xx = dxp @ dxp + (dxl * dxl).sum()
        dot_xb = dxp @ bp + (dxl * bl).sum()
        return (dxp, dxl), dot_xx, dot_xb

    def retract(state: BAState, dx):
        dxp, dxl = dx
        dpose = dxp[: 12 * K].reshape(K, 12)
        dext = dxp[12 * K:].reshape(Cx, 12)[:, :6]  # drop phantom cols
        return BAState(
            T=state.T @ lie.exp_se3(dpose[:, :6]),
            v=state.v + dpose[:, 6:],
            Text=state.Text @ lie.exp_se3(dext),
            X=state.X + dxl,
        )

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


class LocalBAResult(NamedTuple):
    state: BAState
    ok: torch.Tensor            # divergence guard passed
    err_initial: torch.Tensor
    err_final: torch.Tensor
    erase_m: torch.Tensor       # outlier masks to erase (per edge type)
    erase_sg: torch.Tensor
    erase_st: torch.Tensor


def local_gp_ba(
    data: LocalBAData,
    state: BAState,
    b_large: bool = False,
    b_extrinsic: bool = False,
    ext_obs_count=None,
    ext_min_obs: int = 50,
) -> LocalBAResult:
    """Full LocalGPBA schedule (Optimizer.cc:1218-1432): optimize(10) with
    extrinsics fixed; optionally unfix extrinsics with >= ext_min_obs
    observations and optimize(10, or 4 if bLarge); detect outliers; the
    divergence guard `2*err < err_end or NaN -> keep the old state`
    (skipped when bLarge)."""
    lvl = (data.mg_valid, data.sg_valid, data.st_valid)
    lambda_init = 1e-2 if b_large else 1.0
    problem = make_ba_problem(data, *lvl, huber_on=True)
    err_initial = problem.chi2(state)
    new_state, _ = lm_optimize(problem, state, 10, lambda_init=lambda_init)

    if b_extrinsic:
        if ext_obs_count is None:
            # mg_cam == n_ext (the stereo camera) counts for no vertex
            counts = torch.bincount(data.mg_cam[data.mg_valid],
                                    minlength=data.n_ext + 1)[: data.n_ext]
        else:
            counts = ext_obs_count
        problem2 = make_ba_problem(data, *lvl, huber_on=True,
                                   ext_active=counts >= ext_min_obs)
        new_state, _ = lm_optimize(problem2, new_state, 4 if b_large else 10,
                                   lambda_init=lambda_init)

    return _lba_finalize(data, state, new_state, err_initial, b_large)


def _lba_finalize(data: LocalBAData, state: BAState, new_state: BAState,
                  err_initial, force_ok) -> LocalBAResult:
    """LocalGPBA epilogue: final chi2 + divergence guard + outlier detection
    at the final state (Optimizer.cc:1259-1338). `force_ok` skips the guard
    (bLarge)."""
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True)
    err_final = problem.chi2(new_state)
    ok = torch.as_tensor(bool(force_ok), device=err_final.device) | ~(
        (2.0 * err_initial < err_final)
        | torch.isnan(err_initial) | torch.isnan(err_final)
    )

    r_m, _, _, _, _, Xc_m = _mono_gp_eval(data, new_state)
    chi_m = (r_m * r_m).sum(-1) * data.mg_w
    erase_m = data.mg_valid & (
        ((chi_m > CHI2_MONO) & ~data.mg_close)
        | ((chi_m > 1.5 * CHI2_MONO) & data.mg_close)
        | (Xc_m[:, 2] <= 0)
    )
    r_sg = _stereo_gp_eval(data, new_state)[0]
    chi_sg = (r_sg * r_sg).sum(-1) * data.sg_w
    erase_sg = data.sg_valid & (chi_sg > CHI2_STEREO)
    r_st, _, _, z_st = _stereo_eval(data, new_state)
    chi_st = (r_st * r_st).sum(-1) * data.st_w
    erase_st = data.st_valid & torch.where(
        data.st_is_stereo,
        chi_st > CHI2_STEREO,
        ((chi_st > CHI2_MONO) & ~data.st_close)
        | ((chi_st > 1.5 * CHI2_MONO) & data.st_close)
        | (z_st <= 0),
    )

    # divergence guard: keep the original state on failure
    out_state = BAState(*(torch.where(ok, b, a) for a, b in zip(state, new_state)))
    return LocalBAResult(state=out_state, ok=ok, err_initial=err_initial,
                         err_final=err_final, erase_m=erase_m,
                         erase_sg=erase_sg, erase_st=erase_st)


# ----------------------------------------------------------------------
# Host-side table construction (numpy; copies of the reference's, ba.py:1624-1862)
# ----------------------------------------------------------------------


def make_structure_ids(pairs, cams, valid, n_poses: int, n_ext: int,
                       pad_to: int | None = None):
    """Compact structure ids + per-structure column tables for
    LocalBAData.mg_sid/mg_sid_cols (and sg_*, with cams=None).

    Returns (sid (E,), sid_cols (S, 24 or 30)) int32. Padded/invalid edges
    map to a zero-filled dump structure 0. Each column row decomposes into
    12-aligned, contiguous groups (asserted): the Hpp unit-block assembly
    relies on it."""
    pairs = np.asarray(pairs, np.int64)
    E = pairs.shape[0]
    valid = np.asarray(valid, bool)
    width = 30 if cams is not None else 24
    if E == 0:
        return np.zeros(0, np.int32), np.zeros((pad_to or 1, width), np.int32)
    # cam may equal n_ext (the stereo camera): n_ext + 1 camera slots
    n_slots = n_ext + 1
    if cams is not None:
        key = (pairs[:, 0] * n_poses + pairs[:, 1]) * n_slots + np.asarray(cams, np.int64)
    else:
        key = pairs[:, 0] * n_poses + pairs[:, 1]
    key = np.where(valid, key, -1)
    uniq, inv = np.unique(key, return_inverse=True)
    if uniq[0] != -1:
        uniq = np.concatenate([[-1], uniq])
        inv = inv + 1
    S = len(uniq)
    cols = np.zeros((max(pad_to or 0, S), width), np.int32)
    for s_i in range(1, S):
        k = uniq[s_i]
        ij = k // n_slots if cams is not None else k
        i, j = ij // n_poses, ij % n_poses
        base = np.concatenate([12 * i + np.arange(12), 12 * j + np.arange(12)])
        if cams is not None:
            # extrinsics live in 12-wide phantom groups; the stereo camera
            # (c == n_ext) has none and zero Jext blocks: clamp in bounds
            c = min(k % n_slots, max(n_ext - 1, 0))
            base = np.concatenate([base, 12 * n_poses + 12 * c + np.arange(6)])
        cols[s_i] = base
    starts = cols[:, ::12]
    if (starts % 12).any():
        raise AssertionError("make_structure_ids: group start not 12-aligned")
    for g0 in range(0, width, 12):
        gw = min(12, width - g0)
        grp = cols[:, g0:g0 + gw]
        # the 6-wide extrinsic tail only fills offsets 0..5; zeros are exempt
        bad = (grp != 0) & (grp != grp[:, :1] + np.arange(gw)[None, :])
        if bad.any():
            raise AssertionError("make_structure_ids: non-contiguous columns in group")
    return inv.astype(np.int32), cols


def build_interp_tables(sid, t, valid, pad_to: int | None = None):
    """Unique (structure id, timestamp) combo table for the interp-pack path
    (LocalBAData.mg_it/mg_it_sid/mg_it_t and sg_*). Invalid edges map to
    combo 0 (the dump). Returns (it (E,) int32, it_sid (U,) int32,
    it_t (U,) float64), U padded to `pad_to` or the next power of two."""
    sid = np.asarray(sid, np.int64)
    t = np.asarray(t, np.float64)
    valid = np.asarray(valid, bool)
    E = sid.shape[0]
    if E == 0:
        U = pad_to or 1
        return np.zeros(0, np.int32), np.zeros(U, np.int32), np.zeros(U, np.float64)
    # key on (sid, exact time bits); invalid edges -> dump combo 0
    key_t = t.view(np.int64)
    rows = np.stack([np.where(valid, sid, -1), np.where(valid, key_t, 0)], axis=1)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    if uniq[0, 0] != -1:
        uniq = np.concatenate([np.array([[-1, 0]], np.int64), uniq])
        inv = inv + 1
    U_real = len(uniq)
    U = pad_to if pad_to is not None else bucket_pow2(U_real, 4)
    if U < U_real:
        raise ValueError(f"pad_to={pad_to} < observed combos {U_real}")
    it_sid = np.zeros(U, np.int32)
    it_t = np.zeros(U, np.float64)
    it_sid[1:U_real] = uniq[1:, 0].astype(np.int32)
    it_t[1:U_real] = np.ascontiguousarray(uniq[1:, 1]).view(np.float64)
    return inv.astype(np.int32), it_sid, it_t


def make_landmark_tables(mg_lm, mg_pair, mg_cam, mg_valid,
                         sg_lm, sg_pair, sg_valid,
                         st_lm, st_pose, st_valid,
                         n_lm: int, n_poses: int, n_ext: int,
                         pad_d: int | None = None,
                         pad_de: int | None = None):
    """Landmark-major gather tables for the Wt/Hll/bl assembly.

    Block array layout (must match linearize): the per-edge (3,12) coupling
    blocks concatenate as [mono-i | mono-j | mono-ext | sg-i | sg-j | st];
    the per-edge landmark-system rows as [mono | sg | st]. Returns
    (lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid), slot counts
    bucketed to powers of two."""
    mg_lm = np.asarray(mg_lm, np.int64)
    sg_lm = np.asarray(sg_lm, np.int64)
    st_lm = np.asarray(st_lm, np.int64)
    mg_valid = np.asarray(mg_valid, bool)
    sg_valid = np.asarray(sg_valid, bool)
    st_valid = np.asarray(st_valid, bool)
    mg_pair = np.asarray(mg_pair, np.int64).reshape(-1, 2)
    sg_pair = np.asarray(sg_pair, np.int64).reshape(-1, 2)
    mg_cam = np.asarray(mg_cam, np.int64)
    st_pose = np.asarray(st_pose, np.int64)
    Em, Eg, Es = len(mg_lm), len(sg_lm), len(st_lm)

    # (landmark, block index, column group) for every valid block
    lm_parts, idx_parts, g_parts = [], [], []

    def add(lm, valid, idx, g):
        lm_parts.append(lm[valid])
        idx_parts.append(idx[valid])
        g_parts.append(g[valid])

    base = np.arange(Em, dtype=np.int64)
    add(mg_lm, mg_valid, base, mg_pair[:, 0])
    add(mg_lm, mg_valid, base + Em, mg_pair[:, 1])
    # the stereo camera row (cam == n_ext) has zero coupling blocks: clamp
    # it into the last real extrinsic group
    add(mg_lm, mg_valid, base + 2 * Em, n_poses + np.minimum(mg_cam, max(n_ext - 1, 0)))
    baseg = np.arange(Eg, dtype=np.int64)
    add(sg_lm, sg_valid, baseg + 3 * Em, sg_pair[:, 0])
    add(sg_lm, sg_valid, baseg + 3 * Em + Eg, sg_pair[:, 1])
    add(st_lm, st_valid, np.arange(Es, dtype=np.int64) + 3 * Em + 2 * Eg, st_pose)

    def pack(lms, vals, extra=None, pad=None):
        """Group (lms -> vals) into a padded (L, D) table."""
        order = np.argsort(lms, kind="stable")
        s_lm = lms[order]
        s_val = vals[order]
        starts = np.searchsorted(s_lm, np.arange(n_lm))
        counts = np.diff(np.append(starts, len(s_lm)))
        D = max(bucket_pow2(int(counts.max()) if len(counts) else 1, 4), pad or 0)
        pos = np.arange(len(s_lm)) - starts[s_lm]
        tab = np.zeros((n_lm, D), np.int32)
        val = np.zeros((n_lm, D), bool)
        tab[s_lm, pos] = s_val.astype(np.int32)
        val[s_lm, pos] = True
        ext = None
        if extra is not None:
            ext = np.zeros((n_lm, D), np.int32)
            ext[s_lm, pos] = extra[order].astype(np.int32)
        return tab, val, ext

    lm_blk, lm_blk_valid, lm_blk_g = pack(
        np.concatenate(lm_parts), np.concatenate(idx_parts),
        np.concatenate(g_parts), pad=pad_d)
    e_lm = np.concatenate([mg_lm[mg_valid], sg_lm[sg_valid], st_lm[st_valid]])
    e_idx = np.concatenate(
        [base[mg_valid], baseg[sg_valid] + Em,
         np.arange(Es, dtype=np.int64)[st_valid] + Em + Eg])
    lm_edge, lm_edge_valid, _ = pack(e_lm, e_idx, pad=pad_de)
    return lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid


def with_landmark_tables(data: LocalBAData, n_lm: int,
                         pad_d: int | None = None,
                         pad_de: int | None = None) -> LocalBAData:
    """Attach the landmark-major gather tables to a LocalBAData (built on
    the host, placed on the data's device)."""
    h = {k: data._asdict()[k].cpu().numpy() for k in (
        "mg_lm", "mg_pair", "mg_cam", "mg_valid", "sg_lm", "sg_pair",
        "sg_valid", "st_lm", "st_pose", "st_valid")}
    tabs = make_landmark_tables(
        h["mg_lm"], h["mg_pair"], h["mg_cam"], h["mg_valid"],
        h["sg_lm"], h["sg_pair"], h["sg_valid"],
        h["st_lm"], h["st_pose"], h["st_valid"],
        n_lm, data.n_poses, data.n_ext, pad_d=pad_d, pad_de=pad_de)
    dev = data.times.device
    names = ("lm_blk", "lm_blk_g", "lm_blk_valid", "lm_edge", "lm_edge_valid")
    out = {}
    for name, a in zip(names, tabs):
        t = torch.from_numpy(a)
        out[name] = (t if a.dtype == bool else t.to(torch.int64)).to(dev)
    return data._replace(**out)
