"""MC-RANSAC: velocity-model RANSAC for async multi-camera outlier removal.

Port of `amcslam_tpu/ransac/vel_ransac.py` (`Tracking::MCRansac` +
`Optimizer::OptimizeVel`). Per hypothesis: fit a 6-dof body twist to 3
sampled matches by LM (40 iterations, Huber delta = 5.991, information
invLevelSigma2), residual model

    err = obs - pi_cam( (T_last exp(v dt) Tbc[cam])^-1 Xw ),  dt = t_obs - t_last

then count the inliers over all matches, ||err|| <= threshold. The
reference's `vmap` over hypotheses becomes one batched LM run
(`solver/lm.lm_optimize_batched`): every hypothesis is a member with its own
control law, and the loop costs one host read per trial round for all of
them. The scoring is one (H, N) residual pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors import priors
from ..solver import robust
from ..solver import graphs, lm
from ..solver.lm import LMProblem, lm_optimize_batched

HUBER_DELTA = 5.991  # Optimizer.cc:2410


class VelRansacData(NamedTuple):
    T_last: torch.Tensor   # (4,4) last frame body-to-world pose
    v0: torch.Tensor       # (6,) initial velocity (current frame estimate)
    dt: torch.Tensor       # (N,) per-match t_obs(cam) - t_last
    Xw: torch.Tensor       # (N,3) world points
    obs: torch.Tensor      # (N,2) current-frame observations
    cam: torch.Tensor      # (N,) int64
    w: torch.Tensor        # (N,) invLevelSigma2
    valid: torch.Tensor    # (N,) bool
    Tbc: torch.Tensor      # (C,4,4)
    K: torch.Tensor        # (C,4)


def _residuals_all(v, data: VelRansacData):
    """Residuals (..., N, 2) and twist Jacobians (..., N, 2, 6) of every match
    for twists v (..., 6); data rows may carry the same leading dims."""
    return priors.vel_reproj_jac(
        v[..., None, :], data.T_last, data.dt, data.Tbc[data.cam], data.K[data.cam],
        data.Xw, data.obs)


def _residuals(v, data: VelRansacData):
    """The residuals of `_residuals_all` without the Jacobians (the same
    arithmetic; the reference's chi2 and scoring call the Jacobian path and
    XLA drops the unused part, which eager PyTorch would run)."""
    return priors.vel_reproj_point_residual(
        v[..., None, :], data.T_last, data.dt, data.Tbc[data.cam], data.K[data.cam],
        data.Xw, data.obs)


def _fit_problem(data: VelRansacData, act) -> LMProblem:
    """Batched LM closures of the twist fit: the rows of `data` carry a
    leading member dimension (B, n), `act` (B, n) selects each member's
    level-0 edges (the others are present but inactive: OptimizeVel)."""
    delta = HUBER_DELTA
    zero = torch.zeros((), dtype=data.obs.dtype, device=data.obs.device)
    eye = torch.eye(6, dtype=data.obs.dtype, device=data.obs.device)
    m = act[..., None]

    def chi2(v):
        r = torch.where(m, _residuals(v, data), zero)
        s = (r * r).sum(-1) * data.w
        rho0, _ = robust.huber_rho01(s, delta, True)
        return torch.where(act, rho0, zero).sum(-1)

    def linearize(v):
        r, J = _residuals_all(v, data)
        r = torch.where(m, r, zero)
        J = torch.where(m[..., None], J, zero)
        s = (r * r).sum(-1) * data.w
        _, rho1 = robust.huber_rho01(s, delta, True)
        w = torch.where(act, data.w * rho1, zero)
        H = torch.einsum("beri,be,berj->bij", J, w, J)
        b = -torch.einsum("beri,be,ber->bi", J, w, r)
        return H, b

    def solve(lin, lam):
        H, b = lin
        # a singular system gives a NaN step (jnp.linalg.solve's inf/NaN),
        # which the LM loop rejects: solve_ex does not raise or sync
        dx, info = torch.linalg.solve_ex(H + lam[:, None, None] * eye, b)
        dx = torch.where((info == 0)[:, None], dx, torch.full_like(dx, float("nan")))
        return dx, (dx * dx).sum(-1), (dx * b).sum(-1)

    return LMProblem(
        chi2=chi2,
        linearize=linearize,
        max_abs_diag=lambda lin: torch.diagonal(lin[0], dim1=-2, dim2=-1).abs().amax(-1),
        solve=solve,
        retract=lambda v, dx: v + dx,
    )


def _rows(data: VelRansacData, idx) -> VelRansacData:
    """The matches at idx (any shape), as rows of a VelRansacData."""
    return data._replace(dt=data.dt[idx], Xw=data.Xw[idx], obs=data.obs[idx],
                         cam=data.cam[idx], w=data.w[idx], valid=data.valid[idx])


def _fit_velocities(rows: VelRansacData, act, num_iterations: int = 40):
    """LM twist fits, one per member of the (B, n) rows, from data.v0."""
    v0 = rows.v0.expand(act.shape[0], 6)
    v, _ = lm_optimize_batched(_fit_problem(rows, act), v0, num_iterations)
    return v


def optimize_vel(data: VelRansacData, sample_mask, num_iterations: int = 40):
    """OptimizeVel parity (Optimizer.cc:2364-2447): LM twist fit on the
    level-0 (sampled) edges, then the residual norms over all matches.
    Returns (vel (6,), residual_norms (N,))."""
    rows = data._replace(dt=data.dt[None], Xw=data.Xw[None], obs=data.obs[None],
                         cam=data.cam[None], w=data.w[None], valid=data.valid[None])
    v = _fit_velocities(rows, (data.valid & sample_mask)[None], num_iterations)[0]
    return v, torch.linalg.vector_norm(_residuals(v, data), dim=-1)


def score_hypotheses(data: VelRansacData, samples, threshold: float = 3.0):
    """Fit every hypothesis on its sampled matches only (g2o puts the others
    on level 1, Optimizer.cc:2394-2423) and score it over all N matches.
    samples: (H, 3) int64. Returns (v (H,6), inliers (H,N), counts (H,))."""
    sub = _rows(data, samples)
    v = _fit_velocities(sub, sub.valid)
    inl = data.valid & (torch.linalg.vector_norm(_residuals(v, data), dim=-1) <= threshold)
    return v, inl, inl.sum(-1)


class _RansacRun:
    """The static buffers of one MC-RANSAC signature and the program of its
    steps: the frame's rows and samples, the sampled rows of every
    hypothesis, the batched LM carry of the fits and the result."""

    def __init__(self, program, data: VelRansacData, samples, threshold: float,
                 min_match: int):
        static = program.graphed
        self.program, self.threshold, self.min_match = program, threshold, min_match
        self.data = graphs.clone(data) if static else data
        self.samples = samples.clone() if static else samples
        self.sub = None
        self.carry = lm.BatchCarry(data.v0.expand(samples.shape[0], 6), static)
        self.out = None

    def load(self, data: VelRansacData, samples) -> None:
        graphs.copy_(self.data, data)
        self.samples.copy_(samples)

    def _gather(self) -> None:
        """The sampled rows of every hypothesis, and the fits' start."""
        self.sub = graphs.store(self.sub, _rows(self.data, self.samples), self.carry.static)
        self.carry.state.copy_(self.data.v0.expand_as(self.carry.state))

    def _score(self) -> None:
        """Every fit scored over all N matches; the best (the first of
        equal counts, as jnp.argmax)."""
        v = self.carry.state
        inl = self.data.valid & (
            torch.linalg.vector_norm(_residuals(v, self.data), dim=-1) <= self.threshold)
        n = inl.sum(-1)
        # index_select, not n[best]: a 0-d index tensor is read to the host
        best = torch.argmax(n).reshape(1)
        n_best = n.index_select(0, best)[0]
        out = (n_best >= self.min_match, v.index_select(0, best)[0],
               inl.index_select(0, best)[0], n_best)
        self.out = graphs.store(self.out, out, self.carry.static)

    def solve(self) -> None:
        self.program.run("gather", self._gather)
        lm.BatchSteps(self.program, self.carry,
                      lambda: _fit_problem(self.sub, self.sub.valid), kind="ransac").run(40)
        self.program.run("score", self._score)


def mc_ransac(data: VelRansacData, samples, threshold: float = 3.0,
              min_match: int = 30, *, eager: bool = False):
    """All hypotheses at once. samples: (H,3) int64 indices.

    Returns (ok, best_vel, best_inlier_mask, best_count), all tensors on the
    data's device. `ok` is False when the best hypothesis has fewer than
    `min_match` inliers (the caller then skips outlier marking,
    Tracking.cc:1987-1988).

    On a CUDA device the gather of the sampled rows, the batched fit and the
    scoring replay CUDA graphs captured once per input signature
    (solver/graphs.py), the counterpart of the reference's
    `jax.jit(mc_ransac)`; `eager=True` runs them as plain calls (the
    comparison path). CPU tensors always run them as plain calls."""
    dev = data.dt.device
    key = (graphs.signature(data, samples), float(threshold), int(min_match))
    with graphs.on_stream(dev, eager):
        run = graphs.entry("ransac", key, lambda prog: _RansacRun(
            prog, data, samples, threshold, min_match), dev, eager)
        if run.program.graphed:
            run.load(data, samples)
        run.solve()
        out = graphs.clone(run.out) if run.program.graphed else run.out
    return out
