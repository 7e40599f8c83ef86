"""Batched SO(3)/SE(3) Lie-group functions in PyTorch.

Port of `amcslam_tpu/ops/lie.py`. Conventions are the reference's (Sophus):
se(3) tangents are ``xi = [rho, omega]`` (translation first), SE(3) elements
are 4x4 homogeneous matrices, retractions are ``T <- T @ exp_se3(delta)``.

Every function takes inputs with any number of leading batch dimensions
(the reference's `vmap` written out): vectors are (..., 3) / (..., 6),
matrices (..., 3, 3) / (..., 4, 4). Branches are `torch.where` over Taylor
series with the reference's dtype-aware thresholds (`lie.py:30-34`), so both
sides of each branch are evaluated exactly as in the reference. The
reference's `exact`/`smm` precision helpers are TPU bf16 workarounds and are
not ported: small matmuls use `@`, which is true float32/float64 here (see
`amcslam_tpu_torch/__init__.py`).
"""

from __future__ import annotations

import torch


def _small_threshold2(dtype) -> float:
    """Squared angle below which Taylor series replace closed forms."""
    if dtype == torch.float64:
        return 1e-4  # theta < 1e-2
    return 4e-2  # theta < 0.2


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (so(3) hat operator)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _trig_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), series-safe."""
    small = theta2 < _small_threshold2(theta2.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    s, c = torch.sin(theta), torch.cos(theta)
    t4 = theta2 * theta2
    A = torch.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0, s / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0, (1.0 - c) / safe2)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0, (theta - s) / (safe2 * theta)
    )
    return A, B, C


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """so(3) exponential map (Rodrigues), series-safe at the identity."""
    A, B, _ = _trig_coeffs(_dot(w, w))
    W = hat(w)
    return _eye(3, w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z] (branchless Shepperd).

    All four candidates are computed and the largest pivot is selected with
    `torch.argmax`, which, like `jnp.argmax`, returns the first index of a
    tie.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    p0 = 1.0 + tr
    p1 = 1.0 + 2.0 * m00 - tr
    p2 = 1.0 + 2.0 * m11 - tr
    p3 = 1.0 + 2.0 * m22 - tr
    pivots = torch.stack([p0, p1, p2, p3], -1)
    idx = torch.argmax(pivots, dim=-1)
    safe = torch.sqrt(torch.clamp_min(pivots, torch.finfo(R.dtype).tiny))

    q0 = torch.stack([p0, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * safe[..., 0:1])
    q1 = torch.stack([m21 - m12, p1, m01 + m10, m02 + m20], -1) / (2.0 * safe[..., 1:2])
    q2 = torch.stack([m02 - m20, m01 + m10, p2, m12 + m21], -1) / (2.0 * safe[..., 2:3])
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, p3], -1) / (2.0 * safe[..., 3:4])
    qs = torch.stack([q0, q1, q2, q3], -2)  # (..., 4 candidates, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # canonicalize to w >= 0 so log gives the short geodesic
    return torch.where(q[..., 0:1] < 0, -q, q)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm via quaternion extraction (robust up to theta = pi)."""
    q = quat_from_rotmat(R)
    w, v = q[..., 0], q[..., 1:]
    nv2 = _dot(v, v)
    small = nv2 < _small_threshold2(R.dtype) * 0.25
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    # theta = 2*atan2(|v|, w);  series of 2*atan2(|v|, w)/|v| around |v| = 0
    w_safe = torch.clamp_min(w, 1e-3)
    factor = torch.where(
        small,
        2.0 / w_safe * (1.0 - nv2 / (3.0 * w_safe * w_safe)),
        2.0 * torch.atan2(nv, w) / nv,
    )
    return factor[..., None] * v


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian Jl(w) = I + B*hat(w) + C*hat(w)^2."""
    _, B, C = _trig_coeffs(_dot(w, w))
    W = hat(w)
    return _eye(3, w) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def left_jacobian_so3_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian, Jl^{-1} = I - hat/2 + D*hat^2."""
    theta2 = _dot(w, w)
    small = theta2 < _small_threshold2(theta2.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    s, c = torch.sin(theta), torch.cos(theta)
    t4 = theta2 * theta2
    D = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0,
        1.0 / safe2 - (1.0 + c) / (2.0 * theta * s),
    )
    W = hat(w)
    return _eye(3, w) - 0.5 * W + D[..., None, None] * (W @ W)


def right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(w) = Jl(-w)."""
    return left_jacobian_so3(-w)


def right_jacobian_so3_inv(w: torch.Tensor) -> torch.Tensor:
    return left_jacobian_so3_inv(-w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) homogeneous transforms from rotation + translation."""
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = torch.zeros(*R.shape[:-2], 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential, xi = [rho, omega] -> (..., 4, 4) transform."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = (left_jacobian_so3(w) @ rho[..., None])[..., 0]
    return se3_matrix(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm -> [rho, omega]."""
    w = log_so3(T[..., :3, :3])
    rho = (left_jacobian_so3_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, w], -1)


def _block2(A, B, C, D) -> torch.Tensor:
    """[[A, B], [C, D]] from four (..., n, n) blocks."""
    return torch.cat([torch.cat([A, B], -1), torch.cat([C, D], -1)], -2)


def adj_se3(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3) for [rho, omega] tangents: [[R, hat(t)R],[0, R]]."""
    R = T[..., :3, :3]
    return _block2(R, hat(T[..., :3, 3]) @ R, torch.zeros_like(R), R)


def se3_ad(v: torch.Tensor) -> torch.Tensor:
    """Adjoint of an se(3) element, ad(v) = [[hat(w), hat(rho)],[0, hat(w)]]."""
    Wh = hat(v[..., 3:])
    return _block2(Wh, hat(v[..., :3]), torch.zeros_like(Wh), Wh)


def circle_dot(p: torch.Tensor) -> torch.Tensor:
    """Barfoot's 4x6 "circle-dot" operator [[I, -hat(p)],[0, 0]]."""
    Hp = hat(p)
    top = torch.cat([_eye(3, p).expand_as(Hp), -Hp], -1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], -2)


def _Q_coeffs(theta2: torch.Tensor):
    """Coefficients of Barfoot's Q block, series-safe (theta^4 accurate)."""
    small = theta2 < _small_threshold2(theta2.dtype)
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    s, c = torch.sin(theta), torch.cos(theta)
    t3 = safe2 * theta
    t4 = safe2 * safe2
    t5 = t4 * theta
    th4 = theta2 * theta2
    cQ2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + th4 / 5040.0, (theta - s) / t3)
    cQ3 = torch.where(
        small,
        -1.0 / 24.0 + theta2 / 720.0 - th4 / 40320.0,
        (1.0 - 0.5 * safe2 - c) / t4,
    )
    cQ4 = torch.where(
        small,
        -1.0 / 60.0 + theta2 / 1260.0 - th4 / 60480.0,
        cQ3 - 3.0 * (theta - s - t3 / 6.0) / t5,
    )
    return cQ2, cQ3, cQ4


def left_jacobian_pose3_Q(xi: torch.Tensor) -> torch.Tensor:
    """The 3x3 translation-rotation coupling block of the SE(3) left Jacobian
    (Barfoot, State Estimation eq. 7.86), with the reference's signs."""
    rho, w = xi[..., :3], xi[..., 3:]
    X = hat(w)
    Y = hat(rho)
    XY = X @ Y
    YX = Y @ X
    XYX = X @ YX
    cQ2, cQ3, cQ4 = (c[..., None, None] for c in _Q_coeffs(_dot(w, w)))
    return (
        0.5 * Y
        + cQ2 * (XY + YX + XYX)
        - cQ3 * (X @ XY + YX @ X - 3.0 * XYX)
        - 0.5 * cQ4 * (XYX @ X + X @ XYX)
    )


def left_jacobian_pose3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) left Jacobian [[Jl, Q],[0, Jl]]."""
    J = left_jacobian_so3(xi[..., 3:])
    return _block2(J, left_jacobian_pose3_Q(xi), torch.zeros_like(J), J)


def right_jacobian_pose3(xi: torch.Tensor) -> torch.Tensor:
    """Jr(xi) = Jl(-xi)."""
    return left_jacobian_pose3(-xi)


def left_jacobian_pose3_inv(xi: torch.Tensor) -> torch.Tensor:
    """[[Jl^-1, -Jl^-1 Q Jl^-1],[0, Jl^-1]]."""
    Q = left_jacobian_pose3_Q(xi)
    Jinv = left_jacobian_so3_inv(xi[..., 3:])
    return _block2(Jinv, -(Jinv @ Q @ Jinv), torch.zeros_like(Jinv), Jinv)


def right_jacobian_pose3_inv(xi: torch.Tensor) -> torch.Tensor:
    """Jr^-1(xi) = Jl^-1(-xi)."""
    return left_jacobian_pose3_inv(-xi)


def transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform(s) (..., 4, 4) to point(s) (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]
