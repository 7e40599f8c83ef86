"""Sparse Gaussian-process motion prior on SE(3) x R^6 (WNOA), in PyTorch.

Port of `amcslam_tpu/ops/gp.py`: the process-noise kernel ``Qi(dt)`` and its
closed-form inverse, the constant-velocity transition ``Phi`` and GP pose
interpolation between two (pose, twist) states. State convention: the
12-dim local state ``x = [xi (6), nu (6)]`` with xi = [rho, omega].

Batched over leading dimensions: times are (...,), poses (..., 4, 4),
twists (..., 6). `Qc`/`Qc_inv` are single (6, 6) matrices.
"""

from __future__ import annotations

import torch

from . import lie


def _s(x: torch.Tensor) -> torch.Tensor:
    """Scalar batch (...,) -> (..., 1, 1) for scaling matrices."""
    return x[..., None, None]


def qi(dt: torch.Tensor, Qc: torch.Tensor) -> torch.Tensor:
    """Qi = [[dt^3/3 Qc, dt^2/2 Qc], [dt^2/2 Qc, dt Qc]]  (..., 12, 12)."""
    dt = torch.as_tensor(dt, dtype=Qc.dtype, device=Qc.device)
    dt2 = dt * dt
    dt3 = dt2 * dt
    return lie._block2(
        _s(dt3 / 3.0) * Qc, _s(dt2 / 2.0) * Qc, _s(dt2 / 2.0) * Qc, _s(dt) * Qc
    )


def qi_inv(dt: torch.Tensor, Qc_inv: torch.Tensor) -> torch.Tensor:
    """QiInv = [[12/dt^3 QcInv, -6/dt^2 QcInv], [-6/dt^2 QcInv, 4/dt QcInv]]."""
    dt = torch.as_tensor(dt, dtype=Qc_inv.dtype, device=Qc_inv.device)
    dt2 = dt * dt
    dt3 = dt2 * dt
    return lie._block2(
        _s(12.0 / dt3) * Qc_inv,
        _s(-6.0 / dt2) * Qc_inv,
        _s(-6.0 / dt2) * Qc_inv,
        _s(4.0 / dt) * Qc_inv,
    )


def transition(dt: torch.Tensor) -> torch.Tensor:
    """Constant-velocity transition Phi(t1,t2) = [[I, dt I],[0, I]] (..., 12, 12)."""
    eye6 = torch.eye(6, dtype=dt.dtype, device=dt.device).expand(*dt.shape, 6, 6)
    return lie._block2(eye6, _s(dt) * eye6, torch.zeros_like(eye6), eye6)


def interp_coeffs(t1, t2, t):
    """Cubic-Hermite interpolation coefficients (a11, a12, p11, p12), the
    closed form of Qi(t-t1) Phi(t,t2)^T QiInv(t2-t1) (see the reference's
    docstring): a11 = 1-3s^2+2s^3, a12 = dt s(1-s)^2, p11 = s^2(3-2s),
    p12 = dt s^2(s-1) with s = (t-t1)/dt."""
    dt = t2 - t1
    s = (t - t1) / dt
    s2 = s * s
    a11 = 1.0 - 3.0 * s2 + 2.0 * s2 * s
    a12 = dt * s * (1.0 - s) * (1.0 - s)
    p11 = s2 * (3.0 - 2.0 * s)
    p12 = dt * s2 * (s - 1.0)
    return a11, a12, p11, p12


def interp_matrices(t1, t2, t, Qc: torch.Tensor, Qc_inv: torch.Tensor):
    """Interpolation matrices (At1, Pt1) (..., 6, 12) from the Hermite form.
    Qc/Qc_inv only fix the dtype and device."""
    a11, a12, p11, p12 = interp_coeffs(t1, t2, t)
    eye6 = torch.eye(6, dtype=Qc.dtype, device=Qc.device)
    At1 = torch.cat([_s(a11) * eye6, _s(a12) * eye6], -1)
    Pt1 = torch.cat([_s(p11) * eye6, _s(p12) * eye6], -1)
    return At1, Pt1


def local_state(T1: torch.Tensor, T2: torch.Tensor, v2: torch.Tensor):
    """(xi12, x2) with x2 = [log(T1^-1 T2); Jr^-1(xi12) v2]."""
    xi12 = lie.log_se3(lie.se3_inv(T1) @ T2)
    nu2 = (lie.right_jacobian_pose3_inv(xi12) @ v2[..., None])[..., 0]
    return xi12, torch.cat([xi12, nu2], -1)


def query_pose(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv):
    """GP-interpolated body pose at time t in (t1, t2)."""
    T, _aux = query_pose_aux(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv)
    return T


def query_pose_aux(T1, T2, v1, v2, t1, t2, t, Qc, Qc_inv):
    """As :func:`query_pose` but also returns (At1, Pt1, dT, xi12)."""
    _, a12, p11, p12 = interp_coeffs(t1, t2, t)
    xi12 = lie.log_se3(lie.se3_inv(T1) @ T2)
    nu2 = (lie.right_jacobian_pose3_inv(xi12) @ v2[..., None])[..., 0]
    # dxi = At1 @ [0; v1] + Pt1 @ [xi12; nu2], expanded in the scalar form
    dxi = a12[..., None] * v1 + p11[..., None] * xi12 + p12[..., None] * nu2
    dT = lie.exp_se3(dxi)
    At1, Pt1 = interp_matrices(t1, t2, t, Qc, Qc_inv)
    return T1 @ dT, (At1, Pt1, dT, xi12)
