"""SE(3) in plain numpy float64, for the benchmark's generators and
references: twists are [rho, omega], poses (..., 4, 4). Written from the
textbook forms (Barfoot, State Estimation for Robotics, ch. 7), not from
the program."""

from __future__ import annotations

import math

import numpy as np


def hat(w):
    """(..., 3) -> (..., 3, 3) skew matrices."""
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def vee(W):
    return np.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def exp_se3(xi):
    """(..., 6) twists -> (..., 4, 4)."""
    xi = np.asarray(xi, np.float64)
    rho, w = xi[..., :3], xi[..., 3:]
    th2 = np.sum(w * w, -1)
    small = th2 < 1e-12
    th = np.where(small, 1.0, np.sqrt(th2))
    A = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / th)
    B = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / (th * th))
    C = np.where(small, 1.0 / 6.0 - th2 / 120.0, (th - np.sin(th)) / th ** 3)
    W = hat(w)
    W2 = W @ W
    eye = np.eye(3)
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = eye + A[..., None, None] * W + B[..., None, None] * W2
    T[..., :3, 3] = ((eye + B[..., None, None] * W + C[..., None, None] * W2)
                     @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def log_so3(R):
    """(..., 3, 3) rotations -> (..., 3) rotation vectors (angles below pi)."""
    a = vee(R - np.swapaxes(R, -1, -2)) / 2.0     # sin(th) * axis
    s = np.linalg.norm(a, axis=-1)
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    th = np.arctan2(s, c)
    small = s < 1e-8
    f = np.where(small, 1.0 + th * th / 6.0, th / np.where(small, 1.0, s))
    return f[..., None] * a


def log_se3(T):
    """(..., 4, 4) -> (..., 6) twists."""
    w = log_so3(T[..., :3, :3])
    th2 = np.sum(w * w, -1)
    small = th2 < 1e-10
    th = np.where(small, 1.0, np.sqrt(th2))
    # V^-1 = I - W/2 + (1/th^2 - (1 + cos th) / (2 th sin th)) W^2
    k = np.where(small, 1.0 / 12.0 + th2 / 720.0,
                 1.0 / (th * th) - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
    W = hat(w)
    Vinv = np.eye(3) - 0.5 * W + k[..., None, None] * (W @ W)
    rho = (Vinv @ T[..., :3, 3:4])[..., 0]
    return np.concatenate([rho, w], -1)


def rigid_inv(T):
    """Batched inverse of rigid (..., 4, 4) transforms."""
    R = T[..., :3, :3]
    Ti = np.zeros_like(T)
    Ti[..., :3, :3] = np.swapaxes(R, -1, -2)
    Ti[..., :3, 3] = -np.einsum("...ji,...j->...i", R, T[..., :3, 3])
    Ti[..., 3, 3] = 1.0
    return Ti


def curly(xi):
    """(..., 6) -> (..., 6, 6): ad(xi) = [[hat(w), hat(rho)], [0, hat(w)]]."""
    W, P = hat(xi[..., 3:]), hat(xi[..., :3])
    top = np.concatenate([W, P], -1)
    bottom = np.concatenate([np.zeros_like(W), W], -1)
    return np.concatenate([top, bottom], -2)


def left_jacobian(xi, terms: int = 24):
    """SE(3) left Jacobian by its series sum_n ad(xi)^n / (n + 1)!; for the
    twists between neighbouring keyframes (|ad| < ~2) 24 terms reach float64
    rounding."""
    A = curly(np.asarray(xi, np.float64))
    J = np.broadcast_to(np.eye(6), A.shape).copy()
    P = J.copy()
    for n in range(1, terms):
        P = P @ A
        J = J + P / math.factorial(n + 1)
    return J


def right_jacobian_inv(xi):
    """Jr(xi)^-1 = Jl(-xi)^-1."""
    return np.linalg.inv(left_jacobian(-np.asarray(xi, np.float64)))


def rot_angle(Ra, Rb):
    """Angle (rad) of Ra^T Rb, batched."""
    return np.linalg.norm(log_so3(np.swapaxes(Ra, -1, -2) @ Rb), axis=-1)
