"""Sim(3) group functions in g2o's conventions (types/sim3.h), batched.

Port of `amcslam_tpu/ops/sim3.py`, used by loop closure: `optimize_sim3`
(two-keyframe similarity refinement) and the essential graph (Sim3 pose
graph, Optimizer.cc:1434-2048).

g2o conventions (different from the SE(3) module's):
  * 7-tangent order [omega (3), upsilon (3), sigma (1)]: rotation first;
  * the vertex update is on the LEFT: S <- exp(delta) * S
    (types_seven_dof_expmap.h:60-69), with delta[6] zeroed under a fixed
    scale;
  * exp through Strasdat's W matrix: R = exp(omega), s = e^sigma,
    t = W upsilon, W = A hat(omega) + B hat(omega)^2 + C I (sim3.h:70-142);
  * log solves upsilon = W^-1 t (sim3.h:148-225).

An element is the triple (s (...), R (..., 3, 3), t (..., 3)) with any
leading batch dimensions (the reference's `vmap` written out); arguments
broadcast against each other. `matrix` gives the 4x4 [[sR, t], [0, 1]].
Every branch is a `torch.where` over inputs made safe for the side not
taken, so no NaN or infinity reaches a value or a forward-mode tangent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class Sim3(NamedTuple):
    s: torch.Tensor  # (...) scale
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def matrix(self) -> torch.Tensor:
        top = torch.cat([self.s[..., None, None] * self.R, self.t[..., :, None]], -1)
        bottom = torch.zeros(*top.shape[:-2], 1, 4, dtype=top.dtype, device=top.device)
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], -2)


def identity(dtype=torch.float64, device="cpu") -> Sim3:
    return Sim3(s=torch.ones((), dtype=dtype, device=device),
                R=torch.eye(3, dtype=dtype, device=device),
                t=torch.zeros(3, dtype=dtype, device=device))


def from_se3(T: torch.Tensor) -> Sim3:
    return Sim3(s=torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device),
                R=T[..., :3, :3], t=T[..., :3, 3])


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (M @ x[..., None])[..., 0]


def mul(a: Sim3, b: Sim3) -> Sim3:
    """(s1,R1,t1)*(s2,R2,t2) = (s1 s2, R1 R2, s1 R1 t2 + t1)."""
    return Sim3(s=a.s * b.s, R=a.R @ b.R, t=a.s[..., None] * _mv(a.R, b.t) + a.t)


def inv(a: Sim3) -> Sim3:
    """S^-1 = (1/s, R^T, -(1/s) R^T t) (sim3.h:231-234)."""
    Rt = a.R.transpose(-1, -2)
    return Sim3(s=1.0 / a.s, R=Rt, t=-_mv(Rt, a.t) / a.s[..., None])


def act(a: Sim3, x: torch.Tensor) -> torch.Tensor:
    """map(): s R x + t."""
    return a.s[..., None] * _mv(a.R, x) + a.t


def _W_coeffs(theta2, sigma, s):
    """(A, B, C) of W = A hat + B hat^2 + C I; all four branches (small or
    general rotation angle x small or general log-scale) are evaluated on
    inputs that are safe where the branch is not taken."""
    f64 = theta2.dtype == torch.float64
    eps2 = 1e-8 if f64 else 1e-4
    epss = 1e-5 if f64 else 1e-3
    small_t = theta2 < eps2
    small_s = torch.abs(sigma) < epss
    one = torch.ones_like(theta2)
    t2 = torch.where(small_t, one, theta2)      # theta^2 where it is divided by
    th = torch.sqrt(t2)
    sig = torch.where(small_s, torch.ones_like(sigma), sigma)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    sig2 = sig * sig

    # sigma ~ 0
    C0 = torch.ones_like(sigma)
    A0 = torch.where(small_t, 0.5 - theta2 / 24.0, (1.0 - cos_t) / t2)
    B0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0, (th - sin_t) / (t2 * th))
    # general sigma
    C1 = (s - 1.0) / sig
    A1_smt = ((sig - 1.0) * s + 1.0) / sig2
    B1_smt = ((0.5 * sig2 - sig + 1.0) * s) / (sig2 * sig)
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = theta2 + sig2
    A1_gen = (a_ * sig + (1.0 - b_) * th) / (th * c_)
    B1_gen = (C1 - ((b_ - 1.0) * sig + a_ * th) / c_) / t2
    A1 = torch.where(small_t, A1_smt, A1_gen)
    B1 = torch.where(small_t, B1_smt, B1_gen)

    A = torch.where(small_s, A0, A1)
    B = torch.where(small_s, B0, B1)
    C = torch.where(small_s, C0, C1)
    return A, B, C


def _W(omega, sigma, s):
    theta2 = (omega * omega).sum(-1)
    A, B, C = (c[..., None, None] for c in _W_coeffs(theta2, sigma, s))
    Om = lie.hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return A * Om + B * (Om @ Om) + C * eye


def exp_sim3(v: torch.Tensor) -> Sim3:
    """7-tangent [omega, upsilon, sigma] -> Sim3 (sim3.h:70-142)."""
    omega, upsilon, sigma = v[..., :3], v[..., 3:6], v[..., 6]
    s = torch.exp(sigma)
    return Sim3(s=s, R=lie.exp_so3(omega), t=_mv(_W(omega, sigma, s), upsilon))


def log_sim3(a: Sim3) -> torch.Tensor:
    """Sim3 -> [omega, upsilon, sigma] (sim3.h:148-225)."""
    sigma = torch.log(a.s)
    omega = lie.log_so3(a.R)
    W = _W(omega, sigma, a.s)
    upsilon = torch.linalg.solve(W, a.t[..., None])[..., 0]
    return torch.cat([omega, upsilon, sigma[..., None]], -1)


def sim3_error(meas: Sim3, S1: Sim3, S2: Sim3) -> torch.Tensor:
    """EdgeSim3 residual: log(C * S1 * S2^-1) (types_seven_dof_expmap.h:106-114)."""
    return log_sim3(mul(mul(meas, S1), inv(S2)))


def retract_left(S: Sim3, delta: torch.Tensor, fix_scale) -> Sim3:
    """VertexSim3Expmap::oplusImpl: S <- exp(delta) * S, with delta[6] read
    as 0 under `fix_scale` (a bool or a 0-d bool tensor); the caller's
    `delta` is not written."""
    fix = torch.as_tensor(fix_scale, dtype=torch.bool, device=delta.device)
    sigma = torch.where(fix, torch.zeros_like(delta[..., 6:]), delta[..., 6:])
    return mul(exp_sim3(torch.cat([delta[..., :6], sigma], -1)), S)
