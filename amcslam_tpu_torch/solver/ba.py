"""Windowed local GP bundle adjustment with landmark Schur complement.

Port of `amcslam_tpu/solver/ba.py` (`:52-1360`, `:1363-1621`, host-side
tables `:1624-1862`): `Optimizer::LocalGPBA` and `GlobalBundleAdjustemnt`
on the g2o-exact LM loop (solver/lm.py), their abort-segmented variants and
the matrix-free PCG backend for at-scale global BA, with

  graph = { a window of pose-vel keyframes (anchors fixed), per-async-camera
            extrinsic vertices (fixed unless refined), landmarks
            (marginalized) }
  edges = { velocity regularizers, GP motion priors along the chain,
            extrinsic rotation priors, async-camera GP-interpolated mono
            reprojections, GP-interpolated stereo reprojections,
            stereo-camera mono/stereo reprojections at KF timestamps }

Residuals and Jacobians evaluate as one batch per edge family. With the
interp-combo tables (`mg_it`/`sg_it`) the GP interpolation chain runs once
per unique (structure, timestamp) combo through
`ops/interp_chain.gp_interp_packs_indexed` (the CUDA kernel on the card,
reading the endpoint states from the state tables by index); without them
the chain runs per edge from per-structure pair packs (the packed factors).
The pose Hessian assembles from 12x12 unit blocks. The landmark coupling Wt
assembles from the landmark gather tables (`lm_blk`) when present, else by
segment sums over (landmark, pose) keys. The dense solve forms the Schur
complement Hpp - W Hll^-1 W^T and factors it by Cholesky;
`make_ba_problem_pcg` never forms it and solves by preconditioned CG.

TPU workarounds of the reference that are not ported:
  * `_onehot_gather` (one-hot matmul row gather) -> plain indexing (exact);
  * the one-hot `seg_reduce`, the segment sums and the PCG's statically
    sorted `_sorted_segment` (a TPU scatter-rate workaround) -> `index_add_`;
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
from . import graphs, lm, robust
from .lm import LMCarry, LMProblem, LMStats, _read, lm_init, lm_optimize, lm_segment

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


def _combo_ends(data: LocalBAData, sid_cols, it_sid):
    """Pose indices (i, j) of each combo's structure. The dump combo
    (structure 0) has i == j, so dt = 0: redirect j to keep it finite (the
    edges that gather it are where-masked anyway)."""
    i_u = sid_cols[it_sid, 0] // 12
    j_u = sid_cols[it_sid, 12] // 12
    j_u = torch.where(j_u == i_u, torch.clamp(i_u + 1, max=data.n_poses - 1), j_u)
    return i_u, j_u


def _pair_packs(state: BAState, sid_cols):
    """Per-structure GP pair packs (factors/reprojection.gp_pair_pack): the
    pose-pair part of the chain once per structure, gathered per edge by the
    caller."""
    i_s = sid_cols[:, 0] // 12
    j_s = sid_cols[:, 12] // 12
    return reprojection.gp_pair_pack(state.T[i_s], state.v[i_s], state.T[j_s], state.v[j_s])


def _interp_packs(data: LocalBAData, state: BAState, sid_cols, it_sid, it_t):
    """Per-(structure, timestamp) interp packs {"Twb", "Tbw", "Q"}: the whole
    GP chain once per unique combo, gathered per edge by the caller. The
    kernel reads each combo's endpoint states from the state tables by index."""
    i_u, j_u = _combo_ends(data, sid_cols, it_sid)
    return interp_chain.gp_interp_packs_indexed(state.T, state.v, data.times, i_u, j_u, it_t)


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
    Text_all, K_all = _mono_cam_tables(data, state)
    if data.mg_it is not None:
        ips = _interp_packs(data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t)
        ip_e = {k: v[data.mg_it] for k, v in ips.items()}
        return reprojection.mono_gp_residual_jac_interp(
            ip_e, Text_all[data.mg_cam], K_all[data.mg_cam], state.X[data.mg_lm],
            data.mg_obs,
        )
    packs = _pair_packs(state, data.mg_sid_cols)
    pack_e = {k: v[data.mg_sid] for k, v in packs.items()}
    i, j = data.mg_pair[:, 0], data.mg_pair[:, 1]
    return reprojection.mono_gp_residual_jac_packed(
        pack_e, state.T[i], state.v[i], data.times[i], data.times[j], data.mg_t,
        Text_all[data.mg_cam], K_all[data.mg_cam], state.X[data.mg_lm], data.mg_obs,
    )


def _stereo_gp_eval(data: LocalBAData, state: BAState):
    E = data.sg_obs.shape[0]
    if E == 0:
        z = lambda *s: data.sg_obs.new_zeros(s)  # noqa: E731
        return z(0, 3), z(0, 3, 12), z(0, 3, 12), z(0, 3, 3), z(0, 3)
    if data.sg_it is not None:
        ips = _interp_packs(data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t)
        ip_e = {k: v[data.sg_it] for k, v in ips.items()}
        return reprojection.stereo_gp_residual_jac_interp(
            ip_e, data.Tbc_stereo, data.K_stereo, data.bf, state.X[data.sg_lm],
            data.sg_obs,
        )
    packs = _pair_packs(state, data.sg_sid_cols)
    pack_e = {k: v[data.sg_sid] for k, v in packs.items()}
    i, j = data.sg_pair[:, 0], data.sg_pair[:, 1]
    return reprojection.stereo_gp_residual_jac_packed(
        pack_e, state.T[i], state.v[i], data.times[i], data.times[j], data.sg_t,
        data.Tbc_stereo, data.K_stereo, data.bf, state.X[data.sg_lm], data.sg_obs,
    )


def _stereo_row_mask(data: LocalBAData):
    """(Es,3) row mask: mono observations of the stereo camera have no
    right-image row."""
    return torch.cat([data.st_obs.new_ones(data.st_obs.shape[0], 2),
                      data.st_is_stereo[:, None].to(data.st_obs.dtype)], 1)


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
    Text_all, K_all = _mono_cam_tables(data, state)
    if data.mg_it is not None:
        Tbw_u = _interp_poses(data, state, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t)
        return reprojection.mono_gp_residual_interp(
            Tbw_u[data.mg_it], Text_all[data.mg_cam], K_all[data.mg_cam],
            state.X[data.mg_lm], data.mg_obs,
        )
    i, j = data.mg_pair[:, 0], data.mg_pair[:, 1]
    r, _ = reprojection.mono_gp_residual(
        state.T[i], state.v[i], data.times[i], state.T[j], state.v[j], data.times[j],
        data.mg_t, Text_all[data.mg_cam], K_all[data.mg_cam], state.X[data.mg_lm],
        data.mg_obs,
    )
    return r


def _stereo_gp_residuals(data: LocalBAData, state: BAState):
    if data.sg_obs.shape[0] == 0:
        return data.sg_obs.new_zeros((0, 3))
    if data.sg_it is not None:
        Tbw_u = _interp_poses(data, state, data.sg_sid_cols, data.sg_it_sid, data.sg_it_t)
        Tbw_e = Tbw_u[data.sg_it]
    else:
        i, j = data.sg_pair[:, 0], data.sg_pair[:, 1]
        eye = torch.eye(6, dtype=state.T.dtype, device=state.T.device)
        Twb, _ = gp.query_pose_aux(
            state.T[i], state.T[j], state.v[i], state.v[j],
            data.times[i], data.times[j], data.sg_t, eye, eye,
        )
        Tbw_e = lie.se3_inv(Twb)
    return reprojection.stereo_gp_residual_interp(
        Tbw_e, data.Tbc_stereo, data.K_stereo, data.bf, state.X[data.sg_lm], data.sg_obs,
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


def active_columns(data: LocalBAData, ext_active=None) -> torch.Tensor:
    """(P,) 1.0 on the columns of the reduced pose system that move: the 12
    of each free pose and the first 6 of each free extrinsic's 12-wide
    phantom group; 0.0 elsewhere (they get identity rows when damped)."""
    dtype, dev = data.mg_obs.dtype, data.mg_obs.device
    pose_act = (~data.pose_fixed).to(dtype)
    ext_act = (~data.ext_fixed if ext_active is None else ext_active.to(torch.bool)).to(dtype)
    phantom = (torch.arange(12, device=dev) < 6).to(dtype)
    return torch.cat([pose_act[:, None].expand(-1, 12).reshape(-1),
                      (ext_act[:, None] * phantom).reshape(-1)])


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
    zero = torch.zeros((), dtype=dtype, device=dev)

    pose_act = (~data.pose_fixed).to(dtype)
    ext_act = (~data.ext_fixed if ext_active is None else ext_active.to(torch.bool)).to(dtype)
    act_vec = active_columns(data, ext_active)  # (P,)
    # mg_cam == Cx selects the stereo row (never optimizable)
    ext_act1 = torch.cat([ext_act, zero[None]])

    act_m = data.mg_valid & lvl_m
    act_sg = data.sg_valid & lvl_sg
    act_st = data.st_valid & lvl_st
    th_mono = torch.full((), TH_HUBER_MONO, dtype=dtype, device=dev)
    th_stereo = torch.full((), TH_HUBER_STEREO, dtype=dtype, device=dev)
    delta_st = torch.where(data.st_is_stereo, th_stereo, th_mono)

    arange12 = torch.arange(12, device=dev)
    u8 = (arange12 == 8).to(dtype)
    colK = 12 * torch.arange(K, device=dev)[:, None] + arange12[None, :]
    colE = 12 * K + 12 * torch.arange(Cx, device=dev)[:, None] + torch.arange(6, device=dev)[None, :]
    use_tab = data.lm_blk is not None
    if use_tab:
        # landmark gather tables -> flat index lists, once per problem; the
        # padded slots stay in the lists and add zeros (a CUDA graph needs
        # shapes that do not depend on the data)
        L = data.lm_blk.shape[0]
        blk_keys = (torch.arange(L, device=dev)[:, None] * G + data.lm_blk_g).reshape(-1)
        blk_rows = data.lm_blk.reshape(-1)
        blk_valid = data.lm_blk_valid.reshape(-1, 1)
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
        # with the gather tables: landmark-coupling (3,12) blocks, in
        # make_landmark_tables order [mono-i | mono-j | mono-ext | sg-i |
        # sg-j | st], and landmark-system rows [Hll 9 | bl 3] in order
        # [mono | sg | st]
        blk36 = []
        edge12 = []
        # without them: (3,12) blocks keyed landmark * K + pose, the (3,6)
        # extrinsic blocks keyed landmark * Cx + camera, and Hll/bl summed
        # per landmark
        wp_rows, wp_keys = [], []
        if not use_tab:
            Ls = state.X.shape[0]
            We = state.X.new_zeros((Ls * Cx, 3, 6))
            Hll_s = state.X.new_zeros((Ls, 3, 3))
            bl_s = state.X.new_zeros((Ls, 3))

        def add_seg(Hs, bs, cols):
            w_ = Hs.shape[1]
            seg_H.append(F.pad(Hs, (0, 30 - w_, 0, 30 - w_)))
            seg_b.append(F.pad(bs, (0, 30 - w_)))
            seg_cols.append(F.pad(cols, (0, 30 - w_)))

        def seg_reduce(Hblk, bblk, sid, n_sid):
            Hs = Hblk.new_zeros((n_sid,) + Hblk.shape[1:]).index_add_(0, sid, Hblk)
            bs = bblk.new_zeros((n_sid,) + bblk.shape[1:]).index_add_(0, sid, bblk)
            return Hs, bs

        def add_lm(JlW, Jl, r, lm):
            E = r.shape[0]
            Hll_e = _gram(JlW, Jl)
            bl_e = -(JlW * r[:, :, None]).sum(1)
            if use_tab:
                edge12.append(torch.cat([Hll_e.reshape(E, 9), bl_e], 1))
            else:
                Hll_s.index_add_(0, lm, Hll_e)
                bl_s.index_add_(0, lm, bl_e)

        def add_w(Wblk, lm, poses):
            """(E,3,12) coupling blocks of the edges' landmarks and poses,
            for the segment-sum Wt assembly."""
            wp_rows.append(Wblk)
            wp_keys.append(lm * K + poses)

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
        if use_tab:
            blk36.append(Wblk[:, :, :12].reshape(Em, 36))
            blk36.append(Wblk[:, :, 12:24].reshape(Em, 36))
            blk36.append(F.pad(Wblk[:, :, 24:30], (0, 6)).reshape(Em, 36))
        else:
            add_w(Wblk[:, :, :12], data.mg_lm, i_)
            add_w(Wblk[:, :, 12:24], data.mg_lm, j_)
            if Cx:
                # the stereo row (c_ == Cx) has zero blocks: clamp its key
                # in bounds rather than alias it into the next landmark
                We.index_add_(0, data.mg_lm * Cx + torch.clamp(c_, max=Cx - 1),
                              Wblk[:, :, 24:30])
        add_lm(JlW, Jl, r, data.mg_lm)

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
        if use_tab:
            blk36.append(Wblk[:, :, :12].reshape(Eg, 36))
            blk36.append(Wblk[:, :, 12:24].reshape(Eg, 36))
        else:
            add_w(Wblk[:, :, :12], data.sg_lm, i_)
            add_w(Wblk[:, :, 12:24], data.sg_lm, j_)
        add_lm(JlW, Jl, r, data.sg_lm)

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
        if use_tab:
            blk36.append(_gram(JlW, J3).reshape(Es, 36))
        else:
            add_w(_gram(JlW, J3), data.st_lm, p_)
        add_lm(JlW, Jl, r, data.st_lm)

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
        if not use_tab:
            Wp = state.X.new_zeros((Ls * K, 3, 12)).index_add_(
                0, torch.cat(wp_keys), torch.cat(wp_rows))
            Wt = Wp.reshape(Ls, K, 3, 12).permute(0, 2, 1, 3).reshape(Ls, 3, 12 * K)
            if Cx:
                Wt_ext = F.pad(We.reshape(Ls, Cx, 3, 6), (0, 6))
                Wt = torch.cat([Wt, Wt_ext.permute(0, 2, 1, 3).reshape(Ls, 3, 12 * Cx)], 2)
            return (Hpp, bp, Wt, Hll_s, bl_s)
        blk_vals = torch.cat(blk36, 0)  # (B,36)
        Wt = blk_vals.new_zeros((L * G, 36)).index_add_(
            0, blk_keys, torch.where(blk_valid, blk_vals[blk_rows], zero))
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


class PCGStep(NamedTuple):
    """The step of `make_ba_problem_pcg`'s solve: the pose, extrinsic and
    landmark increments (the reference's (x12, xe, dxl)), the CG steps it
    took and its final relative residual r.r / max(b.b, 1e-30), both read
    on the host as `sim3_opt._pcg` returns them."""

    dxp: torch.Tensor   # (K,12)
    dxe: torch.Tensor   # (Cx,6)
    dxl: torch.Tensor   # (L,3)
    cg_steps: int
    rel_res: float


def make_ba_problem_pcg(
    data: LocalBAData,
    lvl_m,
    lvl_sg,
    lvl_st,
    huber_on: bool = True,
    ext_active=None,
    pcg_iters: int = 200,
    pcg_tol: float = 1e-10,
    precond: str = "jacobi",
) -> LMProblem:
    """Matrix-free Schur-complement BA for at-scale keyframe counts (g2o's
    LinearSolverEigen of the global BA, Optimizer.cc:70): neither the PxP
    reduced pose system nor the (L,3,P) coupling is formed. The Schur
    product

        S x = Hpp x - W Hll^-1 W^T x

    evaluates edge by edge: Hpp x as J_e^T w_e (J_e x[cols_e]) with segment
    sums (`index_add_`), W^T x by reducing Jl_e^T w_e (J_e x[cols_e]) per
    landmark, W z by gathering z at each edge's landmark. Preconditioner
    `precond`: "jacobi" inverts the per-vertex 12x12 (pose) / 6x6
    (extrinsic) diagonal blocks of Hpp; "schur_jacobi" those of S, with each
    edge's W Hll^-1 W^T share subtracted. Memory is O(E + L + K).

    The CG loop is the reference's `while_loop`: its exit condition (step <
    pcg_iters and r.r > pcg_tol * max(b.b, 1e-30)) is evaluated on the
    device and read once per step, so it ends after the reference's number
    of steps. `solve(lin, lam, x0=None)` returns a `PCGStep`; `x0 = (x12,
    xe)` warm-starts the iteration. chi2 is the dense problem's, which
    allocates nothing of size P^2."""
    if precond not in ("jacobi", "schur_jacobi"):
        raise ValueError(f"precond must be 'jacobi' or 'schur_jacobi', not {precond!r}")
    dtype = data.mg_obs.dtype
    dev = data.mg_obs.device
    K = data.n_poses
    Cx = data.n_ext
    zero = torch.zeros((), dtype=dtype, device=dev)
    tiny = torch.tensor(1e-30, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye12 = torch.eye(12, dtype=dtype, device=dev)
    u8 = (torch.arange(12, device=dev) == 8).to(dtype)

    pose_act = (~data.pose_fixed).to(dtype)
    ext_act = (~data.ext_fixed if ext_active is None else ext_active.to(torch.bool)).to(dtype)
    ext_act1 = torch.cat([ext_act, zero[None]])  # mg_cam == Cx: the stereo row

    act_m = data.mg_valid & lvl_m
    act_sg = data.sg_valid & lvl_sg
    act_st = data.st_valid & lvl_st
    th_mono = torch.as_tensor(TH_HUBER_MONO, dtype=dtype, device=dev)
    th_stereo = torch.as_tensor(TH_HUBER_STEREO, dtype=dtype, device=dev)
    delta_st = torch.where(data.st_is_stereo, th_stereo, th_mono)

    im, jm, cm, lm_m = data.mg_pair[:, 0], data.mg_pair[:, 1], data.mg_cam, data.mg_lm
    ig, jg, lm_g = data.sg_pair[:, 0], data.sg_pair[:, 1], data.sg_lm
    p_, lm_s = data.st_pose, data.st_lm
    ip, jp = data.gp_pairs[:, 0], data.gp_pairs[:, 1]

    def seg(idx, vals, n):
        return vals.new_zeros((n,) + vals.shape[1:]).index_add_(0, idx, vals)

    def jtv(J, v):
        """J^T v per edge: (E,r,c), (E,r) -> (E,c)."""
        return torch.einsum("erc,er->ec", J, v)

    def jx(J, x):
        """J x per edge: (E,r,c), (E,c) -> (E,r)."""
        return torch.einsum("erc,ec->er", J, x)

    def gram_w(J, w):
        """J^T diag(w) J per edge."""
        return torch.einsum("eri,e,erj->eij", J, w, J)

    chi2 = make_ba_problem(data, lvl_m, lvl_sg, lvl_st, huber_on=huber_on,
                           ext_active=ext_active).chi2

    def linearize(state: BAState):
        L = state.X.shape[0]

        # ===== async-camera GP mono edges =====
        r_m, J1m, J2m, Jlm, Jem, _ = _mono_gp_eval(data, state)
        r_m, J1m, J2m, Jlm, Jem = _masked(act_m, r_m, J1m, J2m, Jlm, Jem)
        s = (r_m * r_m).sum(-1) * data.mg_w
        _, rho1 = robust.huber_rho01(s, th_mono, huber_on)
        w_m = torch.where(act_m, data.mg_w * rho1, zero)
        J1m = J1m * pose_act[im][:, None, None]
        J2m = J2m * pose_act[jm][:, None, None]
        Jem = Jem * ext_act1[cm][:, None, None]
        wr = w_m[:, None] * r_m
        bp12 = -seg(im, jtv(J1m, wr), K) - seg(jm, jtv(J2m, wr), K)
        D12 = seg(im, gram_w(J1m, w_m), K) + seg(jm, gram_w(J2m, w_m), K)
        if Cx:
            bext = -seg(cm, jtv(Jem, wr), Cx)
            Dext = seg(cm, gram_w(Jem, w_m), Cx)
        else:
            bext = state.X.new_zeros((0, 6))
            Dext = state.X.new_zeros((0, 6, 6))
        JlWm = Jlm * w_m[:, None, None]
        Hll = seg(lm_m, torch.einsum("eri,erj->eij", JlWm, Jlm), L)
        bl = -seg(lm_m, torch.einsum("eri,er->ei", JlWm, r_m), L)

        # ===== GP stereo edges =====
        r_g, J1g, J2g, Jlg, _ = _stereo_gp_eval(data, state)
        r_g, J1g, J2g, Jlg = _masked(act_sg, r_g, J1g, J2g, Jlg)
        s = (r_g * r_g).sum(-1) * data.sg_w
        _, rho1 = robust.huber_rho01(s, th_stereo, huber_on)
        w_g = torch.where(act_sg, data.sg_w * rho1, zero)
        J1g = J1g * pose_act[ig][:, None, None]
        J2g = J2g * pose_act[jg][:, None, None]
        wr = w_g[:, None] * r_g
        bp12 = bp12 - seg(ig, jtv(J1g, wr), K) - seg(jg, jtv(J2g, wr), K)
        D12 = D12 + seg(ig, gram_w(J1g, w_g), K) + seg(jg, gram_w(J2g, w_g), K)
        JlWg = Jlg * w_g[:, None, None]
        Hll = Hll + seg(lm_g, torch.einsum("eri,erj->eij", JlWg, Jlg), L)
        bl = bl - seg(lm_g, torch.einsum("eri,er->ei", JlWg, r_g), L)

        # ===== stereo-camera KF edges =====
        r_s, J3, Jls, _ = _stereo_eval(data, state)
        r_s, J3, Jls = _masked(act_st, r_s, J3, Jls)
        s = (r_s * r_s).sum(-1) * data.st_w
        _, rho1 = robust.huber_rho01(s, delta_st, huber_on)
        w_s = torch.where(act_st, data.st_w * rho1, zero)
        J3 = J3 * pose_act[p_][:, None, None]
        wr = w_s[:, None] * r_s
        bp12 = bp12 - seg(p_, jtv(J3, wr), K)
        D12 = D12 + seg(p_, gram_w(J3, w_s), K)
        JlWs = Jls * w_s[:, None, None]
        Hll = Hll + seg(lm_s, torch.einsum("eri,erj->eij", JlWs, Jls), L)
        bl = bl - seg(lm_s, torch.einsum("eri,er->ei", JlWs, r_s), L)

        # ===== GP prior chain =====
        r_p, J1p, J2p = _gp_chain_eval(data, state)
        r_p, J1p, J2p = _masked(data.gp_valid, r_p, J1p, J2p)
        s = torch.einsum("ei,eij,ej->e", r_p, data.gp_qi_inv, r_p)
        _, rho1 = robust.huber_rho01(s, TH_HUBER_GP, data.gp_huber)
        wg = torch.where(data.gp_valid, rho1, zero)
        J1p = J1p * pose_act[ip][:, None, None]
        J2p = J2p * pose_act[jp][:, None, None]
        Om = data.gp_qi_inv * wg[:, None, None]  # (Ng,12,12)
        OJ1, OJ2 = Om @ J1p, Om @ J2p
        bp12 = (bp12 - seg(ip, torch.einsum("eab,ea->eb", OJ1, r_p), K)
                - seg(jp, torch.einsum("eab,ea->eb", OJ2, r_p), K))
        D12 = (D12 + seg(ip, torch.einsum("eab,eac->ebc", OJ1, J1p), K)
               + seg(jp, torch.einsum("eab,eac->ebc", OJ2, J2p), K))

        # ===== velocity edges (diagonal) =====
        wv = torch.where(data.vel_valid, data.qcinv22, zero) * pose_act
        D12 = D12 + eye12 * (wv[:, None] * u8)[:, None, :]
        bp12 = bp12 - (wv * state.v[:, 2])[:, None] * u8

        # ===== extrinsic priors =====
        if Cx:
            r_e = priors.extrinsic_prior_residual(state.Text, data.R_prior)
            J_e = priors.extrinsic_prior_jac(state.Text, data.R_prior) * ext_act[:, None, None]
            JW_e = data.ext_info @ J_e
            Hext_prior = torch.einsum("cri,crj->cij", JW_e, J_e)
            Dext = Dext + Hext_prior
            bext = bext - torch.einsum("cri,cr->ci", JW_e, r_e)
        else:
            Hext_prior = state.X.new_zeros((0, 6, 6))

        edges = ((J1m, J2m, Jem, Jlm, w_m), (J1g, J2g, Jlg, w_g), (J3, Jls, w_s),
                 (J1p, J2p, Om))
        return edges, Hll, bl, bp12, bext, D12, Dext, wv, Hext_prior

    def max_abs_diag(lin):
        _, Hll, _, _, _, D12, Dext, _, _ = lin
        m = (torch.diagonal(D12, dim1=-2, dim2=-1).abs() * pose_act[:, None]).max()
        m = torch.maximum(m, torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max())
        if Cx:
            m = torch.maximum(
                m, (torch.diagonal(Dext, dim1=-2, dim2=-1).abs() * ext_act[:, None]).max())
        return m

    def solve(lin, lam, x0=None):
        edges, Hll, bl, bp12, bext, D12, Dext, wv, Hext_prior = lin
        (J1m, J2m, Jem, Jlm, w_m), (J1g, J2g, Jlg, w_g), (J3, Jls, w_s), (J1p, J2p, Om) = edges
        L = Hll.shape[0]
        Hll_inv = _inv3x3(Hll + lam * eye3)
        damp12 = lam * pose_act + (1.0 - pose_act)
        dampe = lam * ext_act + (1.0 - ext_act)

        def edge_u(xp, xe):
            """J_p x per edge for the three landmark families."""
            u_m = jx(J1m, xp[im]) + jx(J2m, xp[jm])
            if Cx:
                u_m = u_m + jx(Jem, xe[cm])
            return u_m, jx(J1g, xp[ig]) + jx(J2g, xp[jg]), jx(J3, xp[p_])

        def scatter_back(v_m, v_g, v_s):
            """J_p^T v accumulated onto the vertices (v already weighted)."""
            g12 = (seg(im, jtv(J1m, v_m), K) + seg(jm, jtv(J2m, v_m), K)
                   + seg(ig, jtv(J1g, v_g), K) + seg(jg, jtv(J2g, v_g), K)
                   + seg(p_, jtv(J3, v_s), K))
            ge = seg(cm, jtv(Jem, v_m), Cx) if Cx else v_m.new_zeros((0, 6))
            return g12, ge

        def lm_reduce(wu_m, wu_g, wu_s):
            """Jl^T (w J_p x) summed per landmark: W^T x."""
            return (seg(lm_m, torch.einsum("eri,er->ei", Jlm, wu_m), L)
                    + seg(lm_g, torch.einsum("eri,er->ei", Jlg, wu_g), L)
                    + seg(lm_s, torch.einsum("eri,er->ei", Jls, wu_s), L))

        def W_z(z):
            """W z: per-vertex accumulation of J_p^T w Jl z[lm]."""
            return scatter_back(w_m[:, None] * jx(Jlm, z[lm_m]),
                                w_g[:, None] * jx(Jlg, z[lm_g]),
                                w_s[:, None] * jx(Jls, z[lm_s]))

        def Sx(xp, xe):
            """S x for the pose and extrinsic blocks; the weighted edge
            products feed both the Hpp x scatter and W^T x."""
            u_m, u_g, u_s = edge_u(xp, xe)
            wu_m, wu_g, wu_s = w_m[:, None] * u_m, w_g[:, None] * u_g, w_s[:, None] * u_s
            g12, ge = scatter_back(wu_m, wu_g, wu_s)
            # GP chain: no landmark part, full 12x12 information
            Ot = torch.einsum("eab,eb->ea", Om, jx(J1p, xp[ip]) + jx(J2p, xp[jp]))
            g12 = g12 + seg(ip, jtv(J1p, Ot), K) + seg(jp, jtv(J2p, Ot), K)
            g12 = g12 + (wv * xp[:, 8])[:, None] * u8
            if Cx:
                ge = ge + torch.einsum("cij,cj->ci", Hext_prior, xe)
            z = torch.einsum("lab,lb->la", Hll_inv, lm_reduce(wu_m, wu_g, wu_s))
            c12, ce = W_z(z)
            g12 = g12 - c12 + damp12[:, None] * xp
            if Cx:
                ge = ge - ce + dampe[:, None] * xe
            return g12, ge

        # right-hand side: bs = bp - W Hll^-1 bl
        c12, ce = W_z(torch.einsum("lab,lb->la", Hll_inv, bl))
        bs12 = bp12 - c12
        bse = bext - ce if Cx else bext

        def schur_diag_sub(Jp, Jl, w, lm_idx, idx, n):
            A = torch.einsum("eri,e,erj->eij", Jp, w, Jl)  # (E,d,3)
            return seg(idx, (A @ Hll_inv[lm_idx]) @ A.transpose(1, 2), n)

        Dblk = D12
        if precond == "schur_jacobi":
            Dblk = D12 - (schur_diag_sub(J1m, Jlm, w_m, lm_m, im, K)
                          + schur_diag_sub(J2m, Jlm, w_m, lm_m, jm, K)
                          + schur_diag_sub(J1g, Jlg, w_g, lm_g, ig, K)
                          + schur_diag_sub(J2g, Jlg, w_g, lm_g, jg, K)
                          + schur_diag_sub(J3, Jls, w_s, lm_s, p_, K))
        P12 = torch.linalg.inv(Dblk + eye12 * damp12[:, None, None])
        if Cx:
            Ce = (schur_diag_sub(Jem, Jlm, w_m, lm_m, cm, Cx) if precond == "schur_jacobi"
                  else torch.zeros_like(Dext))
            Pe = torch.linalg.inv(Dext - Ce + eye6 * dampe[:, None, None])

        def apply_precond(r12, re):
            z12 = torch.einsum("kab,kb->ka", P12, r12)
            return z12, (torch.einsum("cab,cb->ca", Pe, re) if Cx else re)

        def dot(a12, ae, b12, be):
            d = (a12 * b12).sum()
            return d + (ae * be).sum() if Cx else d

        if x0 is None:
            x12, xe = torch.zeros_like(bp12), torch.zeros_like(bext)
            r12, re = bs12, bse
        else:
            x12, xe = x0
            Sx12, Sxe = Sx(x12, xe)
            r12 = bs12 - Sx12
            re = bse - Sxe if Cx else bse
        z12, ze = apply_precond(r12, re)
        p12, pe = z12, ze
        rz = dot(r12, re, z12, ze)
        bnorm = torch.maximum(dot(bs12, bse, bs12, bse), tiny)
        it = 0
        while True:
            rr = dot(r12, re, r12, re)
            go, rel = _read(torch.stack([(rr > pcg_tol * bnorm).to(dtype), rr / bnorm]))
            if not (it < pcg_iters and go):
                break
            Hp12, Hpe = Sx(p12, pe)
            alpha = rz / torch.maximum(dot(p12, pe, Hp12, Hpe), tiny)
            x12 = x12 + alpha * p12
            xe = xe + alpha * pe
            r12 = r12 - alpha * Hp12
            re = re - alpha * Hpe
            z12, ze = apply_precond(r12, re)
            rz_new = dot(r12, re, z12, ze)
            beta = rz_new / torch.maximum(rz, tiny)
            p12, pe = z12 + beta * p12, ze + beta * pe
            rz = rz_new
            it += 1

        # landmark back-substitution
        u_m, u_g, u_s = edge_u(x12, xe)
        y = lm_reduce(w_m[:, None] * u_m, w_g[:, None] * u_g, w_s[:, None] * u_s)
        dxl = torch.einsum("lab,lb->la", Hll_inv, bl - y)
        dot_xx = (x12 * x12).sum() + (dxl * dxl).sum()
        dot_xb = (x12 * bp12).sum() + (dxl * bl).sum()
        if Cx:
            dot_xx = dot_xx + (xe * xe).sum()
            dot_xb = dot_xb + (xe * bext).sum()
        return PCGStep(x12, xe, dxl, it, rel), dot_xx, dot_xb

    def retract(state: BAState, dx):
        dxp, dxe, dxl = dx[:3]
        Text = state.Text @ lie.exp_se3(dxe) if Cx else state.Text
        return BAState(T=state.T @ lie.exp_se3(dxp[:, :6]), v=state.v + dxp[:, 6:],
                       Text=Text, X=state.X + dxl)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def global_ba_pcg(data: LocalBAData, state: BAState, num_iterations: int = 10):
    """global_ba with the matrix-free PCG backend (ba.py:1353-1360): the same
    semantics in O(E) memory, for keyframe counts where the dense reduced
    system is out of reach. Returns (state, LMStats)."""
    problem = make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                  huber_on=True)
    return lm_optimize(problem, state, num_iterations, lambda_init=1e-5)


class LocalBAResult(NamedTuple):
    state: BAState
    ok: torch.Tensor            # divergence guard passed
    err_initial: torch.Tensor
    err_final: torch.Tensor
    erase_m: torch.Tensor       # outlier masks to erase (per edge type)
    erase_sg: torch.Tensor
    erase_st: torch.Tensor


class _LocalBARun:
    """The static buffers of one local-BA signature and the program of its
    steps: the problem data, the input state (the divergence guard keeps
    it), the LM carry, the initial chi2, the extrinsics the second phase
    frees and the result."""

    def __init__(self, program, data: LocalBAData, state: BAState, b_large: bool):
        static = program.graphed
        self.program, self.b_large = program, b_large
        self.lambda_init = 1e-2 if b_large else 1.0
        self.data = graphs.clone(data) if static else data
        self.state0 = graphs.clone(state) if static else state
        self.carry = lm.Carry.start(state, static)
        self.err_initial = self.carry.chi0.clone()
        self.ext_active = torch.zeros(data.n_ext, dtype=torch.bool, device=data.times.device)
        self.res = None

    def load(self, data: LocalBAData, state: BAState) -> None:
        graphs.copy_(self.data, data)
        graphs.copy_(self.state0, state)
        graphs.copy_(self.carry.state, state)

    def steps(self, phase: int) -> lm.Steps:
        """Phase 1 with the extrinsics fixed; phase 2 frees `ext_active`."""
        ext = None if phase == 1 else self.ext_active

        def problem():
            d = self.data
            return make_ba_problem(d, d.mg_valid, d.sg_valid, d.st_valid, huber_on=True,
                                   ext_active=ext)

        return lm.Steps(self.program, self.carry, problem, tag=f".phase{phase}",
                        lambda_init=self.lambda_init, kind="local_ba")

    def start(self, phase: int) -> LMCarry:
        steps = self.steps(phase)
        steps.chi0()
        if phase == 1:
            self.err_initial.copy_(self.carry.chi0)
        return self.carry.lm_carry()

    def free_extrinsics(self, ext_obs_count, ext_min_obs: int) -> None:
        counts = _ext_counts(self.data) if ext_obs_count is None else ext_obs_count
        self.ext_active.copy_(counts >= ext_min_obs)

    def finalize(self) -> LocalBAResult:
        def step():
            res = _lba_finalize(self.data, self.state0, self.carry.state, self.err_initial,
                                self.b_large)
            self.res = graphs.store(self.res, res, self.carry.static)

        self.program.run("finalize", step)
        return graphs.clone(self.res) if self.program.graphed else self.res


def _local_ba_run(data: LocalBAData, state: BAState, b_large: bool, eager: bool):
    """The run of this signature: cached with its graphs on a CUDA device,
    made anew otherwise; the inputs loaded."""
    dev = data.times.device
    key = (graphs.signature(data, state), bool(b_large))
    run = graphs.entry("local_ba", key, lambda prog: _LocalBARun(prog, data, state, b_large),
                       dev, eager)
    if run.program.graphed:
        run.load(data, state)
    return run


def local_gp_ba(
    data: LocalBAData,
    state: BAState,
    b_large: bool = False,
    b_extrinsic: bool = False,
    ext_obs_count=None,
    ext_min_obs: int = 50,
    *,
    eager: bool = False,
) -> LocalBAResult:
    """Full LocalGPBA schedule (Optimizer.cc:1218-1432): optimize(10) with
    extrinsics fixed; optionally unfix extrinsics with >= ext_min_obs
    observations and optimize(10, or 4 if bLarge); detect outliers; the
    divergence guard `2*err < err_end or NaN -> keep the old state`
    (skipped when bLarge).

    On a CUDA device the LM steps and the epilogue replay CUDA graphs
    captured once per input signature (solver/graphs.py), the counterpart of
    the reference's jitted `local_gp_ba`; `eager=True` runs them as plain
    calls (the comparison path). CPU tensors always run them as plain calls."""
    with graphs.on_stream(data.times.device, eager):
        run = _local_ba_run(data, state, b_large, eager)
        run.steps(1).segment(run.start(1), 10)
        if b_extrinsic:
            run.free_extrinsics(ext_obs_count, ext_min_obs)
            run.steps(2).segment(run.start(2), 4 if b_large else 10)
        return run.finalize()


def _lba_finalize(data: LocalBAData, state: BAState, new_state: BAState,
                  err_initial, force_ok) -> LocalBAResult:
    """LocalGPBA epilogue: final chi2 + divergence guard + outlier detection
    at the final state (Optimizer.cc:1259-1338). `force_ok` skips the guard
    (bLarge)."""
    problem = make_ba_problem(
        data, data.mg_valid, data.sg_valid, data.st_valid, huber_on=True)
    err_final = problem.chi2(new_state)
    ok = torch.full((), bool(force_ok), device=err_final.device) | ~(
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


def global_ba(data: LocalBAData, state: BAState, num_iterations: int = 10):
    """Full-map bundle adjustment (`Optimizer::GlobalBundleAdjustemnt` ->
    BundleAdjustment, Optimizer.cc:53-367): the LocalGPBA edges over every
    keyframe (only the first fixed; robustify the GP chain with
    data.gp_huber), lambda_0 = 1e-5. Returns (state, LMStats); there is no
    divergence guard, the caller stages the result."""
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid,
                              huber_on=True)
    return lm_optimize(problem, state, num_iterations, lambda_init=1e-5)


# ----------------------------------------------------------------------
# Interruptible schedules: host-segmented LM with abort checks between
# segments, the counterpart of g2o's setForceStopFlag (&mbAbortBA for
# LocalGPBA, &mbStopGBA for the detached global BA). The full LM carry is
# kept between segments, so a run that is not aborted is bit-identical to
# the monolithic one.
# ----------------------------------------------------------------------


def _run_segments(seg_fn, carry: LMCarry, total_iters: int, seg_iters: int,
                  should_abort) -> tuple[LMCarry, bool]:
    """Drive `seg_fn(carry, it_end)` to `total_iters` in `seg_iters` chunks,
    polling `should_abort()` (a host callable) between chunks. Returns
    (carry, aborted)."""
    it = 0
    aborted = False
    while it < total_iters:
        it = min(it + max(1, seg_iters), total_iters)
        carry = seg_fn(carry, it)
        if it >= total_iters or carry.term:
            break
        if should_abort is not None and should_abort():
            aborted = True
            break
    return carry, aborted


def _ext_counts(data: LocalBAData):
    """Valid mono-GP observations per extrinsic vertex (mg_cam == n_ext, the
    stereo camera, counts for none), with no read to the host."""
    counts = torch.zeros(data.n_ext + 1, dtype=torch.int64, device=data.mg_cam.device)
    return counts.index_add_(0, data.mg_cam, data.mg_valid.to(torch.int64))[: data.n_ext]


def local_gp_ba_interruptible(
    data: LocalBAData,
    state: BAState,
    b_large: bool = False,
    b_extrinsic: bool = False,
    ext_obs_count=None,
    ext_min_obs: int = 50,
    should_abort=None,
    seg_iters: int = 4,
    *,
    eager: bool = False,
):
    """local_gp_ba with the mbAbortBA force stop (LocalMapping.cc:131/215: a
    new keyframe interrupts the running LocalGPBA at the next iteration
    boundary, and the partial iterate is still written back). Returns
    (LocalBAResult, aborted). Bit-identical to local_gp_ba when no abort
    fires; an abort skips the rest of the schedule, the extrinsic phase
    included (bDoMore = false, LocalMapping.cc:148). It shares
    `local_gp_ba`'s graphs on a CUDA device (`eager` as there)."""
    with graphs.on_stream(data.times.device, eager):
        run = _local_ba_run(data, state, b_large, eager)
        steps = run.steps(1)
        _, aborted = _run_segments(steps.segment, run.start(1), 10, seg_iters, should_abort)
        if b_extrinsic and not aborted:
            run.free_extrinsics(ext_obs_count, ext_min_obs)
            steps = run.steps(2)
            _, aborted = _run_segments(steps.segment, run.start(2), 4 if b_large else 10,
                                       seg_iters, should_abort)
        return run.finalize(), aborted


def global_ba_interruptible(
    data: LocalBAData,
    state: BAState,
    num_iterations: int = 10,
    should_abort=None,
    seg_iters: int = 2,
):
    """global_ba with the detached-GBA stop flag (mbStopGBA,
    LoopClosing.cc:811-835): polls `should_abort` between LM segments.
    Returns (state, LMStats, aborted); the caller discards an aborted run's
    result (LoopClosing.cc:1249)."""
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid,
                              huber_on=True)
    carry, aborted = _run_segments(
        lambda c, e: lm_segment(problem, c, e, lambda_init=1e-5),
        lm_init(problem, state), num_iterations, seg_iters, should_abort)
    stats = LMStats(chi2=carry.chi, iterations=carry.it, lam=carry.lam,
                    initial_chi2=carry.chi0)
    return carry.state, stats, aborted


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
