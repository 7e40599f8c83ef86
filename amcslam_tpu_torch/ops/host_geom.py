"""Pure-NumPy host-side geometry: SE(3) exp/log, SE(3) Jacobians, and GP
pose interpolation.

A copy of `amcslam_tpu/ops/host_geom.py` (the reference module cannot be
imported without JAX). The pipeline's host glue (motion-model propagation,
per-camera pose interpolation in tracking / fuse / triangulation) operates
on SINGLE 4x4 matrices, where one device launch per op would cost more than
the op. These are the same closed forms as ops/lie.py / ops/gp.py (float64
NumPy, series-safe branches); tests/test_torch_pipeline_host.py pins the
copy to the reference.
"""

from __future__ import annotations

import numpy as np

_SMALL2 = 1e-12


def hat3(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def _trig_coeffs(theta2: float):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), series-safe."""
    if theta2 < _SMALL2:
        t4 = theta2 * theta2
        return (
            1.0 - theta2 / 6.0 + t4 / 120.0,
            0.5 - theta2 / 24.0 + t4 / 720.0,
            1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
        )
    theta = np.sqrt(theta2)
    s, c = np.sin(theta), np.cos(theta)
    return s / theta, (1.0 - c) / theta2, (theta - s) / (theta2 * theta)


def exp_so3(w):
    theta2 = float(w @ w)
    A, B, _ = _trig_coeffs(theta2)
    W = hat3(w)
    return np.eye(3) + A * W + B * (W @ W)


def log_so3(R):
    """Robust SO(3) log via quaternion extraction (Shepperd)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    # pick the largest pivot among w,x,y,z
    cand = [tr, R[0, 0], R[1, 1], R[2, 2]]
    k = int(np.argmax(cand))
    if k == 0:
        s = np.sqrt(max(tr + 1.0, 0.0)) * 2.0
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    elif k == 1:
        s = np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 0.0)) * 2.0
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
        )
    elif k == 2:
        s = np.sqrt(max(1.0 + R[1, 1] - R[0, 0] - R[2, 2], 0.0)) * 2.0
        q = np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
        )
    else:
        s = np.sqrt(max(1.0 + R[2, 2] - R[0, 0] - R[1, 1], 0.0)) * 2.0
        q = np.array(
            [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        )
    if q[0] < 0:
        q = -q
    w, v = q[0], q[1:]
    nv2 = float(v @ v)
    if nv2 < _SMALL2 * 0.25:
        w_safe = max(w, 1e-3)
        factor = 2.0 / w_safe * (1.0 - nv2 / (3.0 * w_safe * w_safe))
    else:
        nv = np.sqrt(nv2)
        factor = 2.0 * np.arctan2(nv, w) / nv
    return factor * v


def left_jacobian_so3(w):
    theta2 = float(w @ w)
    _, B, C = _trig_coeffs(theta2)
    W = hat3(w)
    return np.eye(3) + B * W + C * (W @ W)


def left_jacobian_so3_inv(w):
    theta2 = float(w @ w)
    W = hat3(w)
    if theta2 < _SMALL2:
        t4 = theta2 * theta2
        D = 1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0
    else:
        theta = np.sqrt(theta2)
        s, c = np.sin(theta), np.cos(theta)
        D = 1.0 / theta2 - (1.0 + c) / (2.0 * theta * s)
    return np.eye(3) - 0.5 * W + D * (W @ W)


def exp_se3(xi):
    """se(3) exponential, xi = [rho, omega] -> 4x4 transform."""
    xi = np.asarray(xi, np.float64)
    rho, w = xi[:3], xi[3:]
    T = np.eye(4)
    T[:3, :3] = exp_so3(w)
    T[:3, 3] = left_jacobian_so3(w) @ rho
    return T


def log_se3(T):
    """SE(3) logarithm -> [rho, omega]."""
    w = log_so3(np.asarray(T, np.float64)[:3, :3])
    rho = left_jacobian_so3_inv(w) @ np.asarray(T, np.float64)[:3, 3]
    return np.concatenate([rho, w])


def _Q_coeffs(theta2: float):
    if theta2 < _SMALL2:
        t4 = theta2 * theta2
        return (
            1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
            -1.0 / 24.0 + theta2 / 720.0 - t4 / 40320.0,
            -1.0 / 60.0 + theta2 / 1260.0 - t4 / 60480.0,
        )
    theta = np.sqrt(theta2)
    s, c = np.sin(theta), np.cos(theta)
    t3 = theta2 * theta
    t4 = theta2 * theta2
    t5 = t4 * theta
    cQ2 = (theta - s) / t3
    cQ3 = (1.0 - 0.5 * theta2 - c) / t4
    cQ4 = cQ3 - 3.0 * (theta - s - t3 / 6.0) / t5
    return cQ2, cQ3, cQ4


def left_jacobian_pose3_Q(xi):
    """Barfoot's 3x3 translation-rotation coupling block (eq. 7.86)."""
    rho, w = xi[:3], xi[3:]
    X = hat3(w)
    Y = hat3(rho)
    XY = X @ Y
    YX = Y @ X
    XYX = X @ YX
    cQ2, cQ3, cQ4 = _Q_coeffs(float(w @ w))
    return (
        0.5 * Y
        + cQ2 * (XY + YX + XYX)
        - cQ3 * (X @ XY + YX @ X - 3.0 * XYX)
        - 0.5 * cQ4 * (XYX @ X + X @ XYX)
    )


def left_jacobian_pose3_inv(xi):
    """[[Jl^-1, -Jl^-1 Q Jl^-1],[0, Jl^-1]]."""
    xi = np.asarray(xi, np.float64)
    Q = left_jacobian_pose3_Q(xi)
    Jinv = left_jacobian_so3_inv(xi[3:])
    out = np.zeros((6, 6))
    out[:3, :3] = Jinv
    out[:3, 3:] = -Jinv @ Q @ Jinv
    out[3:, 3:] = Jinv
    return out


def right_jacobian_pose3_inv(xi):
    return left_jacobian_pose3_inv(-np.asarray(xi, np.float64))


def gp_interp_pose(T1, v1, t1, T2, v2, t2, t):
    """GP-interpolated pose at t in (t1, t2) — the Lambda/Psi matrix form of
    ops/gp.py query_pose (GaussianProcess.cc QueryPose), float64 NumPy.

    Note the argument order (T, v, t per endpoint) matches the pipeline's
    interp_camera_pose call sites.
    """
    dt = t2 - t1
    d1 = t - t1
    d2 = t2 - t

    def Qi(d):
        Q = np.zeros((12, 12))
        Q[:6, :6] = d**3 / 3.0 * np.eye(6)
        Q[:6, 6:] = d**2 / 2.0 * np.eye(6)
        Q[6:, :6] = d**2 / 2.0 * np.eye(6)
        Q[6:, 6:] = d * np.eye(6)
        return Q

    def QiInv(d):
        Q = np.zeros((12, 12))
        Q[:6, :6] = 12.0 / d**3 * np.eye(6)
        Q[:6, 6:] = -6.0 / d**2 * np.eye(6)
        Q[6:, :6] = -6.0 / d**2 * np.eye(6)
        Q[6:, 6:] = 4.0 / d * np.eye(6)
        return Q

    def Phi(d):
        P = np.eye(12)
        P[:6, 6:] = d * np.eye(6)
        return P

    T1 = np.asarray(T1, np.float64)
    T2 = np.asarray(T2, np.float64)
    Pt = Qi(d1) @ Phi(d2).T @ QiInv(dt)
    At = Phi(d1) - Pt @ Phi(dt)
    xi12 = log_se3(np.linalg.inv(T1) @ T2)
    x1 = np.concatenate([np.zeros(6), np.asarray(v1, np.float64)])
    x2 = np.concatenate(
        [xi12, right_jacobian_pose3_inv(xi12) @ np.asarray(v2, np.float64)]
    )
    dxi = At[:6] @ x1 + Pt[:6] @ x2
    return T1 @ exp_se3(dxi)
