"""Geometric camera models (rebuild of src/CameraModels/ + GeometricCamera.h).

Port of `amcslam_tpu/frontend/cameras.py`. Two models, as in the reference's
Settings camera-type enum (Settings.h:46-50):

  * Pinhole         (Pinhole.cpp)        — params (fx, fy, cx, cy)
  * KannalaBrandt8  (KannalaBrandt8.cpp) — fisheye theta-polynomial,
    params (fx, fy, cx, cy, k0, k1, k2, k3); Newton unprojection.

The reference works on single points and is batched by `jax.vmap`; here
every model function takes its parameter vector first and points on the
last axis (`Xc` (..., 3), `uv` (..., 2)), so one call serves one point or a
batch, on the device and in the dtype of its inputs. Jacobians are (..., 2,
3). The host-facing helpers (`rectify_kb8_points`, `kb8_ray_grid`) take numpy
and an explicit `device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..solver.sim3_opt import _value_and_jac

CAMERA_PINHOLE = 0
CAMERA_KB8 = 1


def _stack(*xs):
    return torch.stack(xs, dim=-1)


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------


def project_pinhole(params, Xc):
    invz = 1.0 / Xc[..., 2]
    return _stack(params[0] * Xc[..., 0] * invz + params[2],
                  params[1] * Xc[..., 1] * invz + params[3])


def project_jac_pinhole(params, Xc):
    invz = 1.0 / Xc[..., 2]
    invz2 = invz * invz
    z = torch.zeros_like(invz)
    return torch.stack([
        _stack(params[0] * invz, z, -params[0] * Xc[..., 0] * invz2),
        _stack(z, params[1] * invz, -params[1] * Xc[..., 1] * invz2),
    ], dim=-2)


def unproject_pinhole(params, uv):
    """Pixel -> unit-depth ray (Pinhole.cpp:61-68)."""
    return _stack((uv[..., 0] - params[2]) / params[0],
                  (uv[..., 1] - params[3]) / params[1],
                  torch.ones_like(uv[..., 0]))


def uncertainty2_pinhole(params, uv):
    return torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)


# ---------------------------------------------------------------------------
# Kannala-Brandt fisheye (8 params)
# ---------------------------------------------------------------------------


def _kb8_poly(params, theta):
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    return theta * (1 + params[4] * t2 + params[5] * t4 + params[6] * t6 + params[7] * t8)


def _kb8_poly_deriv(params, theta):
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    return 1 + 3 * params[4] * t2 + 5 * params[5] * t4 + 7 * params[6] * t6 + 9 * params[7] * t8


def project_kb8(params, Xc):
    """Fisheye projection (KannalaBrandt8.cpp:45-60): r(theta) polynomial."""
    x, y = Xc[..., 0], Xc[..., 1]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=torch.finfo(Xc.dtype).tiny))
    theta = torch.atan2(r, Xc[..., 2])
    f = _kb8_poly(params, theta)
    inv_r = torch.where(r2 > 1e-12, 1.0 / r, torch.zeros_like(r))
    return _stack(params[0] * f * x * inv_r + params[2],
                  params[1] * f * y * inv_r + params[3])


def project_jac_kb8(params, Xc):
    """Analytic 2x3 fisheye Jacobian (KannalaBrandt8.cpp:145-175)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    r2 = x2 + y2
    r = torch.sqrt(r2)
    r3 = r2 * r
    theta = torch.atan2(r, z)
    f = _kb8_poly(params, theta)
    fd = _kb8_poly_deriv(params, theta)
    rz = r2 * (r2 + z2)
    J00 = params[0] * (fd * z * x2 / rz + f * y2 / r3)
    J10 = params[1] * (fd * z * y * x / rz - f * y * x / r3)
    J01 = params[0] * (fd * z * y * x / rz - f * y * x / r3)
    J11 = params[1] * (fd * z * y2 / rz + f * x2 / r3)
    J02 = -params[0] * fd * x / (r2 + z2)
    J12 = -params[1] * fd * y / (r2 + z2)
    return torch.stack([_stack(J00, J01, J02), _stack(J10, J11, J12)], dim=-2)


def _newton_theta(params, theta_d, theta0, n_newton: int = 10):
    """`n_newton` Newton steps on poly(theta) = theta_d from theta0."""
    theta = theta0
    for _ in range(n_newton):
        theta = theta - (_kb8_poly(params, theta) - theta_d) / _kb8_poly_deriv(params, theta)
    return theta


def unproject_kb8(params, uv, n_newton: int = 10):
    """Pixel -> unit-depth ray by Newton inversion of the theta polynomial
    (KannalaBrandt8.cpp:116-143)."""
    px = (uv[..., 0] - params[2]) / params[0]
    py = (uv[..., 1] - params[3]) / params[1]
    theta_d = torch.sqrt(px * px + py * py)
    theta_d = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = _newton_theta(params, theta_d, theta_d, n_newton)
    safe = theta_d > 1e-8
    scale = torch.where(safe, torch.tan(theta) / torch.where(safe, theta_d, 1.0),
                        torch.ones_like(theta_d))
    return _stack(px * scale, py * scale, torch.ones_like(px))


def uncertainty2_kb8(params, uv):
    return torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)


# ---------------------------------------------------------------------------
# Triangulation (GeometricTools.cc Triangulate: DLT via SVD of 4x4)
# ---------------------------------------------------------------------------


def triangulate_dlt(ray1, ray2, Tcw1, Tcw2):
    """DLT triangulation of normalized rays under two world-to-camera poses.

    ray1/ray2 (N,3) normalized rays (x, y, 1), Tcw1/Tcw2 (N,4,4). Builds the
    4x4 linear systems rows x_i * P_i[2] - P_i[0] etc. and takes the
    smallest singular vector (one batched `torch.linalg.svd`). Returns the
    Euclidean points X (N,3) and the homogeneous scales w (N,) (|w| small =>
    at infinity). The null vector's sign is arbitrary (LAPACK, XLA and
    cuSOLVER each pick one); X does not depend on it and callers use |w|
    only."""
    P1 = Tcw1[:, :3, :]
    P2 = Tcw2[:, :3, :]
    A = torch.stack(
        [
            ray1[:, 0:1] * P1[:, 2] - P1[:, 0],
            ray1[:, 1:2] * P1[:, 2] - P1[:, 1],
            ray2[:, 0:1] * P2[:, 2] - P2[:, 0],
            ray2[:, 1:2] * P2[:, 2] - P2[:, 1],
        ],
        dim=1,
    )
    _, _, Vh = torch.linalg.svd(A)
    Xh = Vh[:, -1]
    w = Xh[:, 3]
    X = Xh[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))[:, None]
    return X, w


# ---------------------------------------------------------------------------
# Epipolar gating through the camera API (GeometricCamera::epipolarConstrain
# / matchAndtriangulate), batched over match candidates (axis N):
#   - Pinhole (Pinhole.cpp:107-129): point-to-epipolar-line distance through
#     F12 = K1^-T [t12]x R12 K2^-1, gate 3.84 * unc.
#   - KannalaBrandt8 (KannalaBrandt8.cpp:216-221, 306-392): the check IS a
#     triangulation: parallax gate (cos > 0.9998 rejects), DLT, cheirality in
#     both views, 5.991-sigma reprojection chi2 in both images.
# ---------------------------------------------------------------------------


def _K(p):
    z, o = torch.zeros_like(p[0]), torch.ones_like(p[0])
    return torch.stack([_stack(p[0], z, p[2]), _stack(z, p[1], p[3]), _stack(z, z, o)])


def epipolar_constrain_pinhole(params1, params2, kp1, kp2, R12, t12, unc):
    """Pinhole::epipolarConstrain, batched: kp1/kp2 (N,2), unc (N,) is the
    octave sigma2 of kp2. Returns (N,) bool."""
    z = torch.zeros_like(t12[0])
    tx = torch.stack([_stack(z, -t12[2], t12[1]), _stack(t12[2], z, -t12[0]),
                      _stack(-t12[1], t12[0], z)])
    F12 = torch.linalg.inv(_K(params1)).T @ tx @ R12 @ torch.linalg.inv(_K(params2))
    kp1h = torch.cat([kp1, torch.ones_like(kp1[:, :1])], dim=1)
    l2 = kp1h @ F12  # (N,3): epipolar line in image 2 (a,b,c)
    num = torch.sum(l2[:, :2] * kp2, dim=1) + l2[:, 2]
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2
    return (den > 0) & (num * num / torch.clamp(den, min=1e-30) < 3.84 * unc)


def triangulate_matches(unproject1, unproject2, project1, project2,
                        params1, params2, kp1, kp2, R12, t12, sigma2_1, sigma2_2):
    """GeometricCamera::matchAndtriangulate / KB8::TriangulateMatches,
    batched: unproject/project are the model functions above, kp* (N,2),
    sigma2_* (N,). Returns (z1 (N,), p3D (N,3) in camera-1 frame); z1 <= 0
    encodes rejection exactly as the reference's negative return codes
    (parallax, cheirality, chi2)."""
    r1 = unproject1(params1, kp1)  # (N,3)
    r2 = unproject2(params2, kp2)
    r21 = r2 @ R12.T
    cos_par = torch.sum(r1 * r21, 1) / (
        torch.linalg.norm(r1, dim=1) * torch.linalg.norm(r21, dim=1))
    n = kp1.shape[0]
    eye = torch.eye(4, dtype=kp1.dtype, device=kp1.device)
    R21 = R12.T
    Tcw2 = eye.clone()
    Tcw2[:3, :3] = R21
    Tcw2[:3, 3] = -R21 @ t12
    ray1 = r1 / r1[:, 2:3]
    ray2 = r2 / r2[:, 2:3]
    X, w = triangulate_dlt(ray1, ray2, eye.expand(n, 4, 4), Tcw2.expand(n, 4, 4))
    z1 = X[:, 2]
    X2 = X @ R21.T + (-R21 @ t12)
    uv1 = project1(params1, X)
    uv2 = project2(params2, X2)
    e1 = torch.sum((uv1 - kp1) ** 2, 1)
    e2 = torch.sum((uv2 - kp2) ** 2, 1)
    ok = ((cos_par <= 0.9998) & (z1 > 0) & (X2[:, 2] > 0)
          & (e1 <= 5.991 * sigma2_1) & (e2 <= 5.991 * sigma2_2) & (w.abs() > 1e-12))
    return torch.where(ok, z1, torch.full_like(z1, -1.0)), X


def epipolar_constrain_kb8(params1, params2, kp1, kp2, R12, t12, sigma2_1, sigma2_2):
    """KannalaBrandt8::epipolarConstrain (triangulation > 1e-4), batched."""
    z1, _ = triangulate_matches(
        unproject_kb8, unproject_kb8, project_kb8, project_kb8,
        params1, params2, kp1, kp2, R12, t12, sigma2_1, sigma2_2,
    )
    return z1 > 1e-4


# ---------------------------------------------------------------------------
# Fisheye -> rectified-pinhole keypoint lift (pipeline entry for KB8 rigs).
#
# The pipeline's solvers and matchers are pinhole-normalized, so a KB8
# camera enters it by lifting each detected keypoint through the model's
# exact Newton inversion onto the ideal-pinhole image plane of the SAME
# (fx, fy, cx, cy) (cameras.py:222-236 of the reference says why).
# ---------------------------------------------------------------------------

# Incidence-angle validity limit for the lift: beyond 90 deg the pinhole
# plane cannot represent the ray (tan wraps to the wrong side); just below
# it the tan stretch explodes. 85 deg keeps tan bounded (~11.4).
KB8_MAX_THETA_DEG = 85.0


def _lift_kb8(params, uv):
    """The lift of (..., 2) raw pixels. Unlike `unproject_kb8` the Newton
    solve is unclipped; only its initial value is clipped to [0, pi/2]
    (the reference's clipped unprojection saturates every detection whose
    distorted angle exceeds pi/2, cameras.py:331-350)."""
    pw = (uv - params[2:4]) / params[:2]
    theta_d = torch.sqrt(torch.sum(pw * pw, dim=-1))
    th = _newton_theta(params, theta_d, torch.clamp(theta_d, 0.0, math.pi / 2))
    safe = theta_d > 1e-8
    scale = torch.where(safe, torch.tan(th) / torch.where(safe, theta_d, 1.0),
                        torch.ones_like(theta_d))
    return pw * scale[..., None] * params[:2] + params[2:4], th


def rectify_kb8_points(params, pts, return_aux: bool = False,
                       max_theta_deg: float = KB8_MAX_THETA_DEG, *,
                       device, dtype=torch.float64):
    """(N,2) raw fisheye pixels -> (N,2) rectified-pinhole pixels (numpy),
    computed on `device` in `dtype`.

    params = [fx fy cx cy k1 k2 k3 k4]; the rectified plane reuses the same
    fx/fy/cx/cy, so callers keep rig.K[c] = params[:4].

    With ``return_aux=True`` also returns

      * ``valid`` (N,) bool — solved incidence angle < ``max_theta_deg`` and
        the lift finite,
      * ``sigma2_scale`` (N,) — measurement-variance inflation of the lift,
        the largest eigenvalue of J J^T for the 2x2 lift Jacobian
        J = d(rectified px)/d(raw px), taken in forward mode through the
        Newton solve (as the reference's `jax.jacfwd`); consumers divide
        their inv_sigma2 weights by it."""
    pts = np.asarray(pts)
    p = torch.as_tensor(np.asarray(params, np.float64), dtype=dtype, device=device)
    uv = torch.as_tensor(np.asarray(pts, np.float64).reshape(-1, 2), dtype=dtype,
                         device=device)
    n = uv.shape[0]
    (out, th), (J, _) = _value_and_jac(lambda d: _lift_kb8(p, uv + d), 2, (n,), uv)
    valid = (th < math.radians(max_theta_deg)) & torch.all(torch.isfinite(out), dim=1)
    JJt = J @ J.transpose(-1, -2)
    tr = JJt[:, 0, 0] + JJt[:, 1, 1]
    det = JJt[:, 0, 0] * JJt[:, 1, 1] - JJt[:, 0, 1] * JJt[:, 1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    s2 = tr / 2 + disc
    s2 = torch.where(torch.isfinite(s2), torch.clamp(s2, min=1e-6),
                     torch.full_like(s2, math.inf))
    out_np = out.cpu().numpy().astype(pts.dtype, copy=False)
    if not return_aux:
        return out_np
    return out_np, valid.cpu().numpy(), s2.cpu().numpy().astype(np.float64)


def kb8_ray_grid(params, width: int, height: int, *, device, dtype=torch.float64):
    """Per-pixel unit-depth ray directions (H,W,3) numpy for a KB8 camera —
    the fisheye analogue of the pinhole (u-cx)/fx grid; used by renderers
    and by dense-geometry consumers."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    uv = torch.as_tensor(np.stack([u.ravel(), v.ravel()], -1), dtype=dtype, device=device)
    p = torch.as_tensor(np.asarray(params, np.float64), dtype=dtype, device=device)
    return unproject_kb8(p, uv).cpu().numpy().reshape(height, width, 3)
