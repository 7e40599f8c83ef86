"""Per-frame pose-velocity optimization (the tracking-time solver).

Port of `amcslam_tpu/solver/pose_solver.py`
(`Optimizer::PoseGPOptimizationFromeLastFrame`): two 12-dof pose-velocity
vertices (previous frame, optionally fixed, and current frame), connected by

  * one GP motion prior with information QiInv(dt) (no robust kernel)
  * a vertical-velocity regularizer on each vertex (info = QcInv[2,2])
  * per-feature reprojection edges:
      - async cameras -> GP-interpolated mono reprojection (both vertices)
      - stereo camera -> mono/stereo reprojection (current vertex only)
    each with a Huber kernel (delta = sqrt(5.991) mono / sqrt(7.815) stereo)

on g2o's schedule: 4 rounds x optimize(10) with chi2/depth outlier
re-leveling between rounds and the Huber kernel off in the last round.
Outlier sets are per-edge masks over padded arrays, as in the reference.

The async-camera edges take one of two branches, as in the reference:
  * table (`mg_it`/`it_t` set, as the pipeline's extraction builds it): the
    GP chain runs once per unique interpolation time through
    `ops/interp_chain.gp_interp_packs_pair` (the CUDA kernel on the card) and is
    gathered per edge with `index_select`;
  * per edge: `factors/reprojection.mono_gp_residual_jac` per edge.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..factors import gp_prior, reprojection
from ..ops import interp_chain, lie
from . import robust
from . import graphs, lm
from .lm import LMProblem

CHI2_MONO = (5.991, 5.991, 5.991, 5.991)
CHI2_STEREO = (15.6, 9.8, 7.815, 7.815)
TH_HUBER_MONO = float(np.sqrt(5.991))
TH_HUBER_STEREO = float(np.sqrt(7.815))


class PoseGPData(NamedTuple):
    """Problem data of one per-frame solve; field names, shapes and meaning
    as the reference's `PoseGPData`. Index fields are int64, masks bool."""

    # endpoint metadata
    t_prev: torch.Tensor         # ()
    t_cur: torch.Tensor          # ()
    qi_inv: torch.Tensor         # (12,12) GP prior information
    qcinv22: torch.Tensor        # () velocity-edge information
    fix_prev: torch.Tensor       # () bool: vertex 0 fixed
    # camera rig
    Tbc: torch.Tensor            # (C,4,4) camera-to-body extrinsics
    K: torch.Tensor              # (C,4) pinhole intrinsics (fx,fy,cx,cy)
    bf: torch.Tensor             # () stereo baseline*fx
    # async-camera GP edges (padded to Nm)
    mg_obs: torch.Tensor         # (Nm,2)
    mg_Xw: torch.Tensor          # (Nm,3)
    mg_t: torch.Tensor           # (Nm,)
    mg_cam: torch.Tensor         # (Nm,)
    mg_w: torch.Tensor           # (Nm,) invSigma2
    mg_valid: torch.Tensor       # (Nm,) bool padding mask
    mg_close: torch.Tensor       # (Nm,) bool trackDepth < 10
    # stereo-camera edges at t_cur (padded to Ns); mono rows have ur < 0 and
    # residual/Jacobian row 2 zeroed
    st_obs: torch.Tensor         # (Ns,3) (u,v,ur)
    st_Xw: torch.Tensor          # (Ns,3)
    st_w: torch.Tensor           # (Ns,)
    st_valid: torch.Tensor       # (Ns,) bool
    st_is_stereo: torch.Tensor   # (Ns,) bool (ur >= 0)
    st_close: torch.Tensor       # (Ns,) bool
    # optional interpolation table: edge -> unique interpolation time
    mg_it: torch.Tensor | None = None   # (Nm,) index into it_t
    it_t: torch.Tensor | None = None    # (U,) unique interpolation times


class PoseState(NamedTuple):
    T: torch.Tensor  # (2,4,4) body-to-world poses [prev, cur]
    v: torch.Tensor  # (2,6) world twists


def interp_table(mg_t: np.ndarray):
    """(mg_it, it_t): the table branch's edge -> unique-time index and the
    unique times. A real frame's async cameras fire once each, so there the
    unique times are the camera times (extraction.py:541-545); for edges with
    their own times every edge gets a row."""
    it_t, mg_it = np.unique(np.asarray(mg_t, np.float64), return_inverse=True)
    return mg_it.reshape(-1).astype(np.int64), it_t


def _interp_packs(data: PoseGPData, state: PoseState):
    """The table branch's packs {"Twb", "Tbw", "Q"} (U rows): the single pose
    pair at every unique time (the kernel reads the pair in place)."""
    return interp_chain.gp_interp_packs_pair(state.T, state.v, data.t_prev, data.t_cur,
                                             data.it_t)


def _mono_gp_all(data: PoseGPData, state: PoseState):
    """Residuals and Jacobians of all async-camera GP edges:
    (r (Nm,2), J1 (Nm,2,12), J2 (Nm,2,12), depth (Nm,))."""
    if data.mg_it is not None:
        ip_e = {k: a.index_select(0, data.mg_it) for k, a in _interp_packs(data, state).items()}
        r, J1, J2, _, _, Xc = reprojection.mono_gp_residual_jac_interp(
            ip_e, data.Tbc.index_select(0, data.mg_cam),
            data.K.index_select(0, data.mg_cam), data.mg_Xw, data.mg_obs)
        return r, J1, J2, Xc[:, 2]

    r, J1, J2, _, _, Xc = reprojection.mono_gp_residual_jac(
        state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur,
        data.mg_t, data.Tbc[data.mg_cam], data.K[data.mg_cam], data.mg_Xw, data.mg_obs)
    return r, J1, J2, Xc[:, 2]


def _mono_gp_residuals(data: PoseGPData, state: PoseState):
    """(r (Nm,2), depth (Nm,)) of the async-camera GP edges, by the same
    arithmetic as `_mono_gp_all` without the Jacobians. The reference's
    chi2 and re-leveling call the Jacobian path and XLA drops the unused
    part; run eagerly it would be most of the solve's launches."""
    if data.mg_it is not None:
        Tbw = _interp_packs(data, state)["Tbw"].index_select(0, data.mg_it)
        Tcb = lie.se3_inv(data.Tbc.index_select(0, data.mg_cam))
        Xc = lie.transform_point(Tcb, lie.transform_point(Tbw, data.mg_Xw))
        r = data.mg_obs - reprojection.project_pinhole(
            data.K.index_select(0, data.mg_cam), Xc)
    else:
        r, Xc = reprojection.mono_gp_residual(
            state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur,
            data.mg_t, data.Tbc[data.mg_cam], data.K[data.mg_cam], data.mg_Xw, data.mg_obs)
    return r, Xc[:, 2]


def _stereo_row_mask(data: PoseGPData):
    """(Ns,3): mono observations of the stereo camera have no right row."""
    return torch.cat([data.st_obs.new_ones(data.st_obs.shape[0], 2),
                      data.st_is_stereo[:, None].to(data.st_obs.dtype)], 1)


def _stereo_residuals(data: PoseGPData, state: PoseState):
    """(r (Ns,3), depth (Ns,)) of the stereo-camera edges, as `_stereo_all`
    computes them."""
    r3, Xc = reprojection.stereo_residual(
        state.T[1], data.Tbc[-1], data.K[-1], data.bf, data.st_Xw, data.st_obs)
    return r3 * _stereo_row_mask(data), Xc[:, 2]


def _stereo_all(data: PoseGPData, state: PoseState):
    """Residuals and Jacobians of the stereo-camera edges (unary on the
    current vertex): (r (Ns,3), J (Ns,3,12), depth (Ns,))."""
    r3, J3, _, Xc = reprojection.stereo_residual_jac(
        state.T[1], data.Tbc[-1], data.K[-1], data.bf, data.st_Xw, data.st_obs)
    row_mask = _stereo_row_mask(data)
    return r3 * row_mask, J3 * row_mask[:, :, None], Xc[:, 2]


def _edge_chi2(r, w):
    return w * (r * r).sum(-1)


def make_problem(data: PoseGPData, lvl_m, lvl_s, huber_on: bool) -> LMProblem:
    """LMProblem closures for the current outlier-level masks."""
    dtype = data.mg_obs.dtype
    dev = data.mg_obs.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    act_m = data.mg_valid & lvl_m
    act_s = data.st_valid & lvl_s
    th_mono = torch.full((), TH_HUBER_MONO, dtype=dtype, device=dev)
    delta_s = torch.where(
        data.st_is_stereo, torch.full((), TH_HUBER_STEREO, dtype=dtype, device=dev), th_mono)
    # fixed-vertex masking: vertex-0 rows/cols vanish when fix_prev
    act = torch.cat([torch.where(data.fix_prev, zero, zero + 1.0).expand(12),
                     torch.ones(12, dtype=dtype, device=dev)])

    def chi2(state: PoseState):
        r_m, _ = _mono_gp_residuals(data, state)
        rho0_m, _ = robust.huber_rho01(_edge_chi2(r_m, data.mg_w), th_mono, huber_on)
        c_m = torch.where(act_m, rho0_m, zero).sum()

        r_s, _ = _stereo_residuals(data, state)
        rho0_s, _ = robust.huber_rho01(_edge_chi2(r_s, data.st_w), delta_s, huber_on)
        c_s = torch.where(act_s, rho0_s, zero).sum()

        r_gp = gp_prior.gp_prior_residual(
            state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur)
        c_gp = r_gp @ data.qi_inv @ r_gp
        c_vel = data.qcinv22 * (state.v[0, 2] ** 2 + state.v[1, 2] ** 2)
        return c_m + c_s + c_gp + c_vel

    def linearize(state: PoseState):
        # --- mono GP edges (binary: vertices 0 and 1); where-masking is
        # NaN-safe for padded edges (NaN * 0 = NaN)
        r_m, J1, J2, _ = _mono_gp_all(data, state)
        m3 = act_m[:, None]
        r_m = torch.where(m3, r_m, zero)
        J1 = torch.where(m3[..., None], J1, zero)
        J2 = torch.where(m3[..., None], J2, zero)
        _, rho1_m = robust.huber_rho01(_edge_chi2(r_m, data.mg_w), th_mono, huber_on)
        w_m = torch.where(act_m, data.mg_w * rho1_m, zero)
        J = torch.cat([J1, J2], 2)  # (Nm,2,24)
        JW = J * w_m[:, None, None]
        H = torch.einsum("eri,erj->ij", JW, J)
        b = -torch.einsum("eri,er->i", JW, r_m)

        # --- stereo-camera edges (unary on vertex 1)
        r_s, J3, _ = _stereo_all(data, state)
        m3 = act_s[:, None]
        r_s = torch.where(m3, r_s, zero)
        J3 = torch.where(m3[..., None], J3, zero)
        _, rho1_s = robust.huber_rho01(_edge_chi2(r_s, data.st_w), delta_s, huber_on)
        w_s = torch.where(act_s, data.st_w * rho1_s, zero)
        JsW = J3 * w_s[:, None, None]
        H[12:, 12:] += torch.einsum("eri,erj->ij", JsW, J3)
        b[12:] += -torch.einsum("eri,er->i", JsW, r_s)

        # --- GP prior (full 12x12 information, no robust kernel)
        r_gp, Jg1, Jg2 = gp_prior.gp_prior_residual_jac(
            state.T[0], state.v[0], data.t_prev, state.T[1], state.v[1], data.t_cur)
        Jg = torch.cat([Jg1, Jg2], 1)  # (12,24)
        JgW = data.qi_inv @ Jg
        H = H + Jg.T @ JgW
        b = b - JgW.T @ r_gp

        # --- velocity edges (unary, 1-dim, info qcinv22)
        for vi in range(2):
            o = 12 * vi + 8
            H[o, o] += data.qcinv22
            b[o] += -data.qcinv22 * state.v[vi, 2]

        H = H * act[:, None] * act[None, :]
        return H, b * act, act

    def max_abs_diag(lin):
        H, _, act_ = lin
        return (torch.diagonal(H).abs() * act_).max()

    def solve(lin, lam):
        H, b, act_ = lin
        Hd = H + torch.diag(lam * act_ + (1.0 - act_))
        # a non-PD system gives a NaN step, as the reference's cho_factor
        # does, so the LM loop rejects the trial; cholesky_ex does not raise
        L, info = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve(b[:, None], L)[:, 0]
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        return dx, dx @ dx, dx @ b

    def retract(state: PoseState, dx):
        d = dx.reshape(2, 12)
        return PoseState(T=state.T @ lie.exp_se3(d[:, :6]), v=state.v + d[:, 6:])

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


class _PoseRun:
    """The static buffers of one pose-solve signature and the program of its
    steps: the problem data, the outlier levels of both edge sets, the
    round's chi2 thresholds (mono, stereo, mono close), the LM carry and the
    per-round stats (chi2, lambda, initial chi2)."""

    def __init__(self, program, data: PoseGPData, state: PoseState, outlier_m0, outlier_s0):
        static = program.graphed
        self.program = program
        self.data = graphs.clone(data) if static else data
        self.lvl_m, self.lvl_s = ~outlier_m0, ~outlier_s0
        self.carry = lm.Carry.start(state, static)
        dtype, dev = data.mg_obs.dtype, data.mg_obs.device
        self.th_table = torch.tensor([[CHI2_MONO[it], CHI2_STEREO[it], 1.5 * CHI2_MONO[it]]
                                      for it in range(4)], dtype=dtype, device=dev)
        self.th = self.th_table[0].clone()
        self.stats = torch.zeros(4, 3, dtype=dtype, device=dev)

    def load(self, data, state, outlier_m0, outlier_s0) -> None:
        """Copy a call's inputs into the static buffers."""
        graphs.copy_(self.data, data)
        graphs.copy_(self.carry.state, state)
        torch.logical_not(outlier_m0, out=self.lvl_m)
        torch.logical_not(outlier_s0, out=self.lvl_s)

    def reclassify(self) -> None:
        """Re-classification at the round's state (Optimizer.cc:575-675):
        the outlier levels of the next round, in place."""
        data, state, th = self.data, self.carry.state, self.th
        r_m, z_m = _mono_gp_residuals(data, state)
        chi_m = _edge_chi2(r_m, data.mg_w)
        bad_m = (((chi_m > th[0]) & ~data.mg_close)
                 | (data.mg_close & (chi_m > th[2]))
                 | (z_m <= 0))
        self.lvl_m.copy_(data.mg_valid & ~bad_m)

        r_s, z_s = _stereo_residuals(data, state)
        chi_s = _edge_chi2(r_s, data.st_w)
        bad_stereo = chi_s > th[1]
        bad_mono = (((chi_s > th[0]) & ~data.st_close)
                    | (data.st_close & (chi_s > th[2]))
                    | (z_s <= 0))
        self.lvl_s.copy_(data.st_valid & ~torch.where(data.st_is_stereo, bad_stereo, bad_mono))

    def solve(self):
        """g2o's 4 rounds; returns the per-round iteration counts."""
        iters = []
        for it in range(4):
            self.th.copy_(self.th_table[it])
            huber_on = it != 3
            steps = lm.Steps(
                self.program, self.carry,
                lambda h=huber_on: make_problem(self.data, self.lvl_m, self.lvl_s, h),
                tag=f".huber{int(huber_on)}", kind="pose")
            steps.chi0()
            c = steps.segment(self.carry.lm_carry(), 10)
            iters.append(c.it)
            self.stats[it].copy_(torch.stack([c.chi, c.lam, c.chi0]))
            self.program.run("reclassify", self.reclassify)
        return iters


def pose_gp_optimize(data: PoseGPData, state: PoseState, outlier_m0, outlier_s0, *,
                     eager: bool = False):
    """The full 4-round schedule. Returns (state, inlier_m, inlier_s,
    (round_stats, n_inliers)).

    outlier_*0: initial per-edge outlier flags (pFrame->mvbOutlier).

    On a CUDA device the rounds replay CUDA graphs captured once per input
    signature (solver/graphs.py), the counterpart of the reference's
    `jax.jit(pose_gp_optimize)`; `eager=True` runs them as plain calls (the
    comparison path). CPU tensors always run them as plain calls."""
    dev = data.mg_obs.device
    key = graphs.signature(data, state, outlier_m0, outlier_s0)
    with graphs.on_stream(dev, eager):
        run = graphs.entry("pose", key, lambda prog: _PoseRun(
            prog, data, state, outlier_m0, outlier_s0), dev, eager)
        if run.program.graphed:
            run.load(data, state, outlier_m0, outlier_s0)
        iters = run.solve()
        n_inliers = run.lvl_m.sum() + run.lvl_s.sum()
        out = (run.carry.state, run.lvl_m, run.lvl_s, run.stats)
        if run.program.graphed:
            out = graphs.clone(out)
    st, lvl_m, lvl_s, stats = out
    round_stats = [lm.LMStats(chi2=stats[it, 0], iterations=iters[it], lam=stats[it, 1],
                              initial_chi2=stats[it, 2]) for it in range(4)]
    return st, lvl_m, lvl_s, (round_stats, n_inliers)
