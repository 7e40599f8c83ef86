"""Sim(3) optimizers for loop closure.

Port of `amcslam_tpu/solver/sim3_opt.py` on the port's five-closure
`LMProblem` (solver/lm.py):

  * optimize_sim3: bidirectional multi-camera Sim3 refinement between two
    keyframes (`Optimizer::OptimizeSim3`, Optimizer.cc:2049-2362): one Sim3
    vertex, fixed landmark pairs in each keyframe's camera frames, paired
    forward/inverse reprojection edges with Huber delta = sqrt(th2);
    optimize(5) -> chi2 pair-prune -> optimize(10 if any pair was pruned,
    else 5) -> inlier count.
  * the essential graph: a Sim3 pose graph over all keyframes
    (`Optimizer::OptimizeEssentialGraph`, Optimizer.cc:1434-1717): vertices
    S_cw with the left retraction, EdgeSim3 residuals log(C S_i S_j^-1)
    with identity information, LM with lambda_0 = 1e-16 for 20 iterations,
    the loop keyframe fixed. Two linear solvers: the dense 7N x 7N normal
    matrix and Cholesky (`make_essential_graph_problem`), and a
    matrix-free block-Jacobi PCG (`make_essential_graph_problem_pcg`).

The reference uses numeric Jacobians for every Sim3 edge (linearizeOplus is
commented out, OptimizableTypes.h:194,222; EdgeSim3 has none); the JAX
package takes `jax.jacfwd` per edge under `vmap`. Here the Jacobian is one
forward-mode pass (`torch.func.jvp`) of the batched residual over n copies
of the batch, copy k along basis tangent e_k (n = 7 per vertex), so no
Python loop runs over edges or tangents.

The reference's `_sorted_segment` (a TPU scatter workaround) is not ported:
the segment sums are `index_add_`.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..factors.reprojection import project_pinhole
from ..ops import lie, sim3
from ..ops.sim3 import Sim3
from . import robust
from .lm import LMProblem, _read, lm_optimize

# PyTorch's forward-AD dual levels are process-wide, not per thread: two
# threads inside `torch.func.jvp` at once break each other's level
_JVP_LOCK = threading.Lock()


def _value_and_jac(f, n: int, batch: tuple, like: torch.Tensor):
    """f at d = 0 (d of shape (*batch, n)) and its Jacobian with respect to
    d: one `torch.func.jvp` of f over n stacked copies of d, copy k moving
    along e_k, so f must accept d with a leading dimension of n and
    broadcast over it. Returns (outputs, Jacobians), each a tuple with one
    entry per output of f: outputs (*batch, ...), Jacobians (*batch, ..., n).
    """
    shape = (n, *batch, n)
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    tangent = eye.reshape(n, *(1,) * len(batch), n).expand(shape)
    with _JVP_LOCK:
        out, tan = torch.func.jvp(f, (like.new_zeros(shape),), (tangent,))
    return tuple(o[0] for o in out), tuple(t.movedim(0, -1) for t in tan)


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


class Sim3PairData(NamedTuple):
    """Paired forward/inverse Sim3 reprojection edges (padded SoA)."""

    X1: torch.Tensor      # (N,3) points in KF1 camera frame (camera cam1)
    X2: torch.Tensor      # (N,3) points in KF2 camera frame (camera cam2)
    obs1: torch.Tensor    # (N,2) observation in KF1 (image of cam1)
    obs2: torch.Tensor    # (N,2) observation in KF2
    cam1: torch.Tensor    # (N,) int64
    cam2: torch.Tensor    # (N,) int64
    w1: torch.Tensor      # (N,) invSigma2 of obs1
    w2: torch.Tensor      # (N,)
    valid: torch.Tensor   # (N,) bool
    K1: torch.Tensor      # (C1,4) intrinsics of KF1 cameras
    K2: torch.Tensor      # (C2,4)
    Tc1b: torch.Tensor    # (C1,4,4) camera-from-body, KF1
    Tc2b: torch.Tensor    # (C2,4,4)
    fix_scale: torch.Tensor  # () bool


def _sim3_pair_residuals(S12: Sim3, data: Sim3PairData):
    """(r12 (..., N, 2), r21 (..., N, 2)): forward and inverse reprojection
    residuals for S12 with any leading batch dimensions.

    r12 = obs1 - pi_c1(Tc1b[cam1] . S12 . Tc2b[cam2]^-1 . X2)
    r21 = obs2 - pi_c2(Tc2b[cam2] . S12^-1 . Tc1b[cam1]^-1 . X1)
    (OptimizableTypes.h:185-191, 212-219)
    """
    S = Sim3(S12.s[..., None], S12.R[..., None, :, :], S12.t[..., None, :])
    T1, T2 = data.Tc1b[data.cam1], data.Tc2b[data.cam2]
    Xb2 = lie.transform_point(lie.se3_inv(T2), data.X2)
    Xc1 = lie.transform_point(T1, sim3.act(S, Xb2))
    r12 = data.obs1 - project_pinhole(data.K1[data.cam1], Xc1)
    Xb1 = lie.transform_point(lie.se3_inv(T1), data.X1)
    Xc2 = lie.transform_point(T2, sim3.act(sim3.inv(S), Xb1))
    r21 = data.obs2 - project_pinhole(data.K2[data.cam2], Xc2)
    return r12, r21


def _pair_chi2_terms(r12, r21, data: Sim3PairData):
    return (r12 * r12).sum(-1) * data.w1, (r21 * r21).sum(-1) * data.w2


def _make_sim3_problem(data: Sim3PairData, lvl12, lvl21, delta) -> LMProblem:
    dtype = data.X1.dtype
    act12 = data.valid & lvl12
    act21 = data.valid & lvl21

    def chi2(S12: Sim3):
        s12, s21 = _pair_chi2_terms(*_sim3_pair_residuals(S12, data), data)
        rho12, _ = robust.huber_rho01(s12, delta, True)
        rho21, _ = robust.huber_rho01(s21, delta, True)
        return (torch.where(act12, rho12, torch.zeros_like(rho12)).sum()
                + torch.where(act21, rho21, torch.zeros_like(rho21)).sum())

    def linearize(S12: Sim3):
        def r_of_delta(d):
            return _sim3_pair_residuals(sim3.retract_left(S12, d, data.fix_scale), data)

        (r12, r21), (J12, J21) = _value_and_jac(r_of_delta, 7, (), data.X1)
        m12, m21 = act12[:, None], act21[:, None]
        r12 = torch.where(m12, r12, torch.zeros_like(r12))
        r21 = torch.where(m21, r21, torch.zeros_like(r21))
        J12 = torch.where(m12[..., None], J12, torch.zeros_like(J12))
        J21 = torch.where(m21[..., None], J21, torch.zeros_like(J21))

        s12, s21 = _pair_chi2_terms(r12, r21, data)
        _, rho12 = robust.huber_rho01(s12, delta, True)
        _, rho21 = robust.huber_rho01(s21, delta, True)
        w12 = torch.where(act12, data.w1 * rho12, torch.zeros_like(rho12))
        w21 = torch.where(act21, data.w2 * rho21, torch.zeros_like(rho21))

        H = (torch.einsum("eri,e,erj->ij", J12, w12, J12)
             + torch.einsum("eri,e,erj->ij", J21, w21, J21))
        b = (-torch.einsum("eri,e,er->i", J12, w12, r12)
             - torch.einsum("eri,e,er->i", J21, w21, r21))
        return H, b

    def max_abs_diag(lin):
        return torch.diagonal(lin[0]).abs().max()

    def solve(lin, lam):
        H, b = lin
        # a singular system gives a NaN step, which the LM loop rejects
        dx, info = torch.linalg.solve_ex(H + lam * torch.eye(7, dtype=dtype, device=H.device), b)
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        return dx, dx @ dx, dx @ b

    def retract(S12: Sim3, dx):
        return sim3.retract_left(S12, dx, data.fix_scale)

    return LMProblem(chi2, linearize, max_abs_diag, solve, retract)


def optimize_sim3(data: Sim3PairData, S12: Sim3, th2: float = 10.0):
    """Full OptimizeSim3 schedule. Returns (S12', n_inliers, inlier_mask);
    the count of pruned pairs is read on the host once."""
    delta = float(np.sqrt(th2))
    lvl = torch.ones_like(data.valid)

    S12, _ = lm_optimize(_make_sim3_problem(data, lvl, lvl, delta), S12, 5)

    # pair-prune: either side over th2 kills both edges (Optimizer.cc:2293-2320)
    s12, s21 = _pair_chi2_terms(*_sim3_pair_residuals(S12, data), data)
    bad = (s12 > th2) | (s21 > th2)
    lvl2 = data.valid & ~bad
    n_more = 10 if bool((bad & data.valid).any()) else 5

    S12, _ = lm_optimize(_make_sim3_problem(data, lvl2, lvl2, delta), S12, n_more)

    s12, s21 = _pair_chi2_terms(*_sim3_pair_residuals(S12, data), data)
    inlier = lvl2 & (s12 < th2) & (s21 < th2)
    return S12, inlier.sum(), inlier


# ---------------------------------------------------------------------------
# OptimizeEssentialGraph
# ---------------------------------------------------------------------------


class EssentialGraphData(NamedTuple):
    """Sim3 pose graph (padded SoA)."""

    pairs: torch.Tensor      # (E,2) int64 (i,j): edge residual log(C S_i S_j^-1)
    meas_s: torch.Tensor     # (E,)
    meas_R: torch.Tensor     # (E,3,3)
    meas_t: torch.Tensor     # (E,3)
    valid: torch.Tensor      # (E,) bool
    fixed: torch.Tensor      # (N,) bool: the loop keyframe
    fix_scale: torch.Tensor  # () bool


class Sim3Field(NamedTuple):
    """N Sim3 vertices as SoA."""

    s: torch.Tensor  # (N,)
    R: torch.Tensor  # (N,3,3)
    t: torch.Tensor  # (N,3)


def _vertices(state: Sim3Field, idx) -> Sim3:
    return Sim3(state.s[idx], state.R[idx], state.t[idx])


def _meas(data: EssentialGraphData) -> Sim3:
    return Sim3(data.meas_s, data.meas_R, data.meas_t)


def _eg_residuals(state: Sim3Field, data: EssentialGraphData):
    """All edge residuals (E,7)."""
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
    return sim3.sim3_error(_meas(data), _vertices(state, i_), _vertices(state, j_))


def _eg_residual_jacs(state: Sim3Field, data: EssentialGraphData):
    """(r (E,7), J (E,7,14)): per-edge residual and Jacobian with respect to
    the left retractions of both endpoint vertices."""
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
    Si, Sj, C = _vertices(state, i_), _vertices(state, j_), _meas(data)

    def f(d):
        return (sim3.sim3_error(C, sim3.retract_left(Si, d[..., :7], data.fix_scale),
                                sim3.retract_left(Sj, d[..., 7:], data.fix_scale)),)

    (r,), (J,) = _value_and_jac(f, 14, (i_.shape[0],), state.t)
    return r, J


def _eg_chi2(data: EssentialGraphData):
    def chi2(state: Sim3Field):
        r = _eg_residuals(state, data)
        r = torch.where(data.valid[:, None], r, torch.zeros_like(r))
        return (r * r).sum()
    return chi2


def _eg_jacobians(state: Sim3Field, data: EssentialGraphData):
    """(r, Ji, Jj, act): masked residuals, the Jacobian blocks of the two
    endpoints with the fixed vertices' columns zeroed, and the (N,) free
    mask in the state's dtype."""
    r, J = _eg_residual_jacs(state, data)
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
    act = (~data.fixed).to(state.t.dtype)
    m = data.valid[:, None]
    r = torch.where(m, r, torch.zeros_like(r))
    J = torch.where(m[..., None], J, torch.zeros_like(J))
    return r, J[:, :, :7] * act[i_][:, None, None], J[:, :, 7:] * act[j_][:, None, None], act


def _eg_retract(data: EssentialGraphData):
    def retract(state: Sim3Field, dx):
        S = sim3.retract_left(Sim3(*state), dx.reshape(-1, 7), data.fix_scale)
        return Sim3Field(s=S.s, R=S.R, t=S.t)
    return retract


def make_essential_graph_problem(data: EssentialGraphData) -> LMProblem:
    """Dense 7N x 7N normal matrix, assembled from the edges' 14x14 blocks
    with `index_add_` on the flattened matrix, solved by Cholesky."""

    def linearize(state: Sim3Field):
        N = state.s.shape[0]
        r, Ji, Jj, act = _eg_jacobians(state, data)
        J = torch.cat([Ji, Jj], -1)
        i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
        ar7 = torch.arange(7, device=i_.device)
        cols = torch.cat([7 * i_[:, None] + ar7, 7 * j_[:, None] + ar7], 1)  # (E,14)
        Hblk = torch.einsum("eri,erj->eij", J, J)
        bblk = -torch.einsum("eri,er->ei", J, r)
        flat = (cols[:, :, None] * (7 * N) + cols[:, None, :]).reshape(-1)
        H = J.new_zeros(7 * N * 7 * N).index_add_(0, flat, Hblk.reshape(-1))
        b = J.new_zeros(7 * N).index_add_(0, cols.reshape(-1), bblk.reshape(-1))
        return H.reshape(7 * N, 7 * N), b, act.repeat_interleave(7)

    def max_abs_diag(lin):
        H, _, act_vec = lin
        return (torch.diagonal(H).abs() * act_vec).max()

    def solve(lin, lam):
        H, b, act_vec = lin
        Hd = H + torch.diag(lam * act_vec + (1.0 - act_vec))
        # a non-PD system gives a NaN step (as the reference's cho_factor
        # does), which the LM loop rejects
        Lc, info = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve(b[:, None], Lc)[:, 0]
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        return dx, dx @ dx, dx @ b

    return LMProblem(_eg_chi2(data), linearize, max_abs_diag, solve, _eg_retract(data))


def _pcg(Ji, Jj, i_, j_, D, b, act, lam, pcg_iters: int, pcg_tol: float, reduce=None):
    """Block-Jacobi preconditioned CG on (J^T J + diag) x = b, matrix-free.

    The reference's `while_loop` exit, evaluated on the card and read on
    the host once per step: stop after `pcg_iters` steps, or when
    rr . rr <= pcg_tol * max(b . b, 1e-30). Returns (x (N,7), steps,
    rr . rr / max(b . b, 1e-30)).

    `reduce`, if given, maps the (N,7) segment sums of each product J^T J p
    before the damping is added: the edge-sharded problem passes an
    all-reduce over its ranks (parallel/sharded_eg.py), whose edges are
    then this call's share of the graph's."""
    dtype = b.dtype
    N = b.shape[0]
    tiny = torch.tensor(1e-30, dtype=dtype, device=b.device)
    eye7 = torch.eye(7, dtype=dtype, device=b.device)
    damp = lam * act + (1.0 - act)  # fixed vertices: identity (their b is 0)
    Minv = torch.linalg.inv(D + damp[:, None, None] * eye7)

    def seg(idx, vals):
        return vals.new_zeros((N,) + vals.shape[1:]).index_add_(0, idx, vals)

    def Hx(x):
        u = torch.einsum("erc,ec->er", Ji, x[i_]) + torch.einsum("erc,ec->er", Jj, x[j_])
        out = (seg(i_, torch.einsum("erc,er->ec", Ji, u))
               + seg(j_, torch.einsum("erc,er->ec", Jj, u)))
        if reduce is not None:
            out = reduce(out)
        return out + damp[:, None] * x

    def dot(a, c):
        return (a * c).sum()

    x = torch.zeros_like(b)
    rr = b
    z = torch.einsum("nij,nj->ni", Minv, rr)
    p = z
    rz = dot(rr, z)
    bnorm = torch.maximum(dot(b, b), tiny)
    it = 0
    while True:
        rrn = dot(rr, rr)
        go, rel = _read(torch.stack([(rrn > pcg_tol * bnorm).to(dtype), rrn / bnorm]))
        if not (it < pcg_iters and go):
            return x, it, rel
        Hp = Hx(p)
        alpha = rz / torch.maximum(dot(p, Hp), tiny)
        x = x + alpha * p
        rr = rr - alpha * Hp
        z = torch.einsum("nij,nj->ni", Minv, rr)
        rz_new = dot(rr, z)
        beta = rz_new / torch.maximum(rz, tiny)
        p = z + beta * p
        rz = rz_new
        it += 1


def make_essential_graph_problem_pcg(
    data: EssentialGraphData, pcg_iters: int = 250, pcg_tol: float = 1e-10
) -> LMProblem:
    """Matrix-free essential graph for at-scale pose graphs (the rebuild of
    LinearSolverEigen's sparse Cholesky, Optimizer.cc:1442-1444, as an
    iterative solver): H x evaluates edge by edge as J_e^T (J_e x[cols_e])
    with two segment sums, preconditioned by the inverted 7x7 block
    diagonal of each vertex (block-Jacobi). Memory is O(E), not O(N^2)."""
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]

    def linearize(state: Sim3Field):
        N = state.s.shape[0]
        r, Ji, Jj, act = _eg_jacobians(state, data)
        zeros = Ji.new_zeros
        D = (zeros((N, 7, 7)).index_add_(0, i_, torch.einsum("eri,erj->eij", Ji, Ji))
             + zeros((N, 7, 7)).index_add_(0, j_, torch.einsum("eri,erj->eij", Jj, Jj)))
        b = (zeros((N, 7)).index_add_(0, i_, -torch.einsum("eri,er->ei", Ji, r))
             + zeros((N, 7)).index_add_(0, j_, -torch.einsum("eri,er->ei", Jj, r)))
        return Ji, Jj, D, b, act

    def max_abs_diag(lin):
        *_, D, b, act = lin
        return (torch.diagonal(D, dim1=-2, dim2=-1).abs() * act[:, None]).max()

    def solve(lin, lam):
        Ji, Jj, D, b, act = lin
        x, _, _ = _pcg(Ji, Jj, i_, j_, D, b, act, lam, pcg_iters, pcg_tol)
        dx = x.reshape(-1)
        return dx, dx @ dx, dx @ b.reshape(-1)

    return LMProblem(_eg_chi2(data), linearize, max_abs_diag, solve, _eg_retract(data))


def optimize_essential_graph(data: EssentialGraphData, state: Sim3Field,
                             use_pcg: bool = False):
    """20 LM iterations, lambda_0 = 1e-16 (Optimizer.cc:1442-1447, 1665).
    `use_pcg` switches to the matrix-free block-Jacobi PCG backend for
    at-scale graphs (the reference's sparse-Cholesky capability)."""
    problem = (make_essential_graph_problem_pcg(data) if use_pcg
               else make_essential_graph_problem(data))
    return lm_optimize(problem, state, 20, lambda_init=1e-16)
