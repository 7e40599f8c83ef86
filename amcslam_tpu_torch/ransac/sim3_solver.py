"""Batched Horn Sim3 solver and RANSAC (rebuild of src/Sim3Solver.cc).

Port of `amcslam_tpu/ransac/sim3_solver.py`. The reference's serial RANSAC
(Sim3Solver::iterate, Sim3Solver.cc:181-342) fits Horn's closed-form
similarity to 3 point pairs per hypothesis (ComputeSim3, :343-464) and
counts the inliers by reprojecting through each keyframe's rig
(CheckInliers, :466-500). Here every hypothesis is evaluated at once: one
batched 4x4 symmetric eigendecomposition and one (H, N) inlier pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.reprojection import project_pinhole
from ..ops import lie


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, fix_scale):
    """Closed-form similarity S12 = (s, R, t) aligning P2 -> P1, batched.

    P1, P2: (..., N, 3) corresponding points (N >= 3). Horn 1987 quaternion
    method: the cross-covariance M, the 4x4 N matrix, its principal
    eigenvector as the rotation quaternion (`torch.linalg.eigh`: ascending
    eigenvalues, principal vector in the last column); s = <Pr1, R Pr2> /
    ||R Pr2||^2, or 1 under a fixed scale; t = O1 - s R O2. The quaternion
    is taken to axis-angle as the reference does; q and -q give the same R.
    """
    O1 = P1.mean(-2)
    O2 = P2.mean(-2)
    Pr1 = (P1 - O1[..., None, :]).transpose(-1, -2)  # (..., 3, N)
    Pr2 = (P2 - O2[..., None, :]).transpose(-1, -2)

    M = Pr2 @ Pr1.transpose(-1, -2)
    m = lambda i, j: M[..., i, j]  # noqa: E731
    N11 = m(0, 0) + m(1, 1) + m(2, 2)
    N12 = m(1, 2) - m(2, 1)
    N13 = m(2, 0) - m(0, 2)
    N14 = m(0, 1) - m(1, 0)
    N22 = m(0, 0) - m(1, 1) - m(2, 2)
    N23 = m(0, 1) + m(1, 0)
    N24 = m(2, 0) + m(0, 2)
    N33 = -m(0, 0) + m(1, 1) - m(2, 2)
    N34 = m(1, 2) + m(2, 1)
    N44 = -m(0, 0) - m(1, 1) + m(2, 2)
    Nm = torch.stack([
        torch.stack([N11, N12, N13, N14], -1),
        torch.stack([N12, N22, N23, N24], -1),
        torch.stack([N13, N23, N33, N34], -1),
        torch.stack([N14, N24, N34, N44], -1),
    ], -2)
    _, evecs = torch.linalg.eigh(Nm)
    q = evecs[..., :, -1]  # (w, x, y, z)
    vec = q[..., 1:]
    nv = torch.linalg.vector_norm(vec, dim=-1)
    ang = torch.atan2(nv, q[..., 0])
    axis = torch.where((nv > 1e-7)[..., None],
                       2.0 * ang[..., None] * vec / torch.clamp_min(nv, 1e-12)[..., None],
                       torch.zeros_like(vec))
    R = lie.exp_so3(axis)

    P3 = R @ Pr2
    nom = (Pr1 * P3).sum((-2, -1))
    den = (P3 * P3).sum((-2, -1))
    fix = torch.as_tensor(fix_scale, dtype=torch.bool, device=P1.device)
    s = torch.where(fix, torch.ones_like(nom), nom / den)
    t = O1 - s[..., None] * (R @ O2[..., None])[..., 0]
    return s, R, t


class Sim3RansacData(NamedTuple):
    """Correspondences between two multi-camera keyframes (SoA)."""

    Xb1: torch.Tensor        # (N,3) matched points in KF1 body frame
    Xb2: torch.Tensor        # (N,3) matched points in KF2 body frame
    obs1: torch.Tensor       # (N,2) image observation in KF1
    obs2: torch.Tensor       # (N,2) image observation in KF2
    cam1: torch.Tensor       # (N,) int64 camera index in KF1
    cam2: torch.Tensor       # (N,) int64
    max_err1: torch.Tensor   # (N,) 9.21*sigma2 per-point threshold in image 1
    max_err2: torch.Tensor   # (N,)
    valid: torch.Tensor      # (N,) bool
    K1: torch.Tensor         # (C1,4)
    K2: torch.Tensor         # (C2,4)
    Tc1b: torch.Tensor       # (C1,4,4) camera-from-body of KF1 cameras
    Tc2b: torch.Tensor       # (C2,4,4)
    fix_scale: torch.Tensor  # () bool


def _check_inliers(s, R, t, data: Sim3RansacData):
    """Project each match through the hypotheses (s (H,), R (H,3,3),
    t (H,3)) both ways (CheckInliers); returns the (H, N) inlier mask."""
    s_, R_, t_ = s[..., None], R[..., None, :, :], t[..., None, :]
    Xb1_from2 = s_[..., None] * (R_ @ data.Xb2[..., None])[..., 0] + t_
    u1 = project_pinhole(data.K1[data.cam1],
                         lie.transform_point(data.Tc1b[data.cam1], Xb1_from2))
    Xb2_from1 = (R_.transpose(-1, -2) @ (data.Xb1 - t_)[..., None])[..., 0] / s_[..., None]
    u2 = project_pinhole(data.K2[data.cam2],
                         lie.transform_point(data.Tc2b[data.cam2], Xb2_from1))
    e1 = ((data.obs1 - u1) ** 2).sum(-1)
    e2 = ((data.obs2 - u2) ** 2).sum(-1)
    return data.valid & (e1 < data.max_err1) & (e2 < data.max_err2)


def sim3_ransac(data: Sim3RansacData, samples: torch.Tensor):
    """All-hypotheses-parallel Sim3 RANSAC.

    samples: (H,3) int64 indices into the correspondence arrays (sampled on
    the host, as Sim3Solver::iterate draws its triples). Returns
    (best (s, R, t), best inlier mask, best count, per-hypothesis counts);
    the best is the first hypothesis of the largest count (`torch.argmax`
    returns the first maximum, as `jnp.argmax` does).
    """
    s_h, R_h, t_h = horn_sim3(data.Xb1[samples], data.Xb2[samples], data.fix_scale)
    inl_h = _check_inliers(s_h, R_h, t_h, data)
    n_h = inl_h.sum(-1)
    best = torch.argmax(n_h)
    return (s_h[best], R_h[best], t_h[best]), inl_h[best], n_h[best], n_h
