"""The port's camera models (amcslam_tpu_torch/frontend/cameras.py) against
the reference's (amcslam_tpu/frontend/cameras.py) in float64 on the inputs
of tests/test_cameras.py: closed-form functions to 1e-12 (relative, with an
absolute floor of 1e-12), results of a Newton solve to 1e-10; validity flags
equal and the KB8 lift's sigma^2 inflation to 1e-10, including detections
beyond 85 and beyond 90 degrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from amcslam_tpu.frontend import cameras as ref

from amcslam_tpu_torch.frontend import cameras as cam

KB8 = np.array([285.0, 286.0, 420.0, 400.0, -0.006, 0.04, -0.04, 0.008])
KB8_WIDE = np.array([300.0, 300.0, 320.0, 240.0, 0.05, -0.01, 0.002, 0.0])
PIN = np.array([420.0, 421.0, 480.0, 300.0])
CLOSED = dict(rtol=1e-12, atol=1e-12)
NEWTON = dict(rtol=1e-10, atol=1e-10)


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def j64(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _points(seed, n, lo=(-2, -1, 2), hi=(2, 1, 20)):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(lo[i], hi[i], n) for i in range(3)], 1)


def _ref_batch(fn, params, X):
    return np.asarray(jax.vmap(lambda x: fn(j64(params), x))(j64(X)))


@pytest.mark.parametrize("name,params,seed,lo,hi", [
    ("pinhole", PIN, 0, (-2, -1, 2), (2, 1, 20)),
    ("kb8", KB8, 1, (-3, -3, 1.5), (3, 3, 10)),
    ("kb8", KB8_WIDE, 2, (-2, -2, 1), (2, 2, 8)),
])
def test_projection_and_jacobian_equal_the_reference(name, params, seed, lo, hi):
    X = _points(seed, 32, lo, hi)
    proj, jac = getattr(cam, f"project_{name}"), getattr(cam, f"project_jac_{name}")
    np.testing.assert_allclose(proj(t64(params), t64(X)).numpy(),
                               _ref_batch(getattr(ref, f"project_{name}"), params, X), **CLOSED)
    np.testing.assert_allclose(jac(t64(params), t64(X)).numpy(),
                               _ref_batch(getattr(ref, f"project_jac_{name}"), params, X),
                               **CLOSED)
    # one point (no batch axis) gives the same as the batch's row
    np.testing.assert_array_equal(proj(t64(params), t64(X[3])).numpy(),
                                  proj(t64(params), t64(X)).numpy()[3])


def test_kb8_jacobian_matches_forward_mode():
    X = t64(_points(2, 5, (-2, -2, 1), (2, 2, 8)))
    J = cam.project_jac_kb8(t64(KB8), X)
    J_ad = torch.func.vmap(torch.func.jacfwd(lambda x: cam.project_kb8(t64(KB8), x)))(X)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name,params", [("pinhole", PIN), ("kb8", KB8), ("kb8", KB8_WIDE)])
def test_unprojection_equals_the_reference(name, params):
    X = _points(3, 40, (-3, -3, 1.5), (3, 3, 10))
    uv = _ref_batch(getattr(ref, f"project_{name}"), params, X)
    got = getattr(cam, f"unproject_{name}")(t64(params), t64(uv)).numpy()
    want = _ref_batch(getattr(ref, f"unproject_{name}"), params, uv)
    np.testing.assert_allclose(got, want, **(NEWTON if name == "kb8" else CLOSED))
    for fn in ("uncertainty2_pinhole", "uncertainty2_kb8"):
        np.testing.assert_array_equal(getattr(cam, fn)(t64(params), t64(uv)).numpy(),
                                      _ref_batch(getattr(ref, fn), params, uv))


def test_triangulate_dlt_equals_the_reference():
    from amcslam_tpu.ops import lie

    rng = np.random.RandomState(3)
    X = jnp.asarray([1.0, -0.5, 6.0])
    T1 = lie.exp_se3(jnp.asarray(rng.randn(6) * 0.1))
    T2 = lie.exp_se3(jnp.asarray(rng.randn(6) * 0.1 + np.array([1, 0, 0, 0, 0, 0])))
    Tcw1, Tcw2 = lie.se3_inv(T1), lie.se3_inv(T2)
    r1, r2 = lie.transform_point(Tcw1, X), lie.transform_point(Tcw2, X)
    want, w_ref = ref.triangulate_dlt(r1 / r1[2], r2 / r2[2], Tcw1, Tcw2)
    got, w = cam.triangulate_dlt(t64(r1 / r1[2])[None], t64(r2 / r2[2])[None],
                                 t64(Tcw1)[None], t64(Tcw2)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **CLOSED)
    assert abs(abs(float(w[0])) - abs(float(w_ref))) <= 1e-12


def _pair(seed, params, project, t12, n):
    rng = np.random.RandomState(seed)
    R12 = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], 1)
    X2 = (X1 - t12) @ R12
    kp1 = _ref_batch(project, params, X1)
    kp2 = _ref_batch(project, params, X2)
    return R12, kp1, kp2


def test_epipolar_constrain_pinhole_equals_the_reference():
    params = np.array([120.0, 121.0, 80.0, 60.0])
    t12 = np.array([0.3, 0.02, 0.0])
    R12, kp1, kp2 = _pair(3, params, ref.project_pinhole, t12, 40)
    kp2 = kp2 + np.random.RandomState(4).randn(*kp2.shape) * np.array([0.0, 3.0])
    unc = np.full(40, 1.44)
    got = cam.epipolar_constrain_pinhole(t64(params), t64(params), t64(kp1), t64(kp2),
                                         t64(R12), t64(t12), t64(unc)).numpy()
    want = np.asarray(ref.epipolar_constrain_pinhole(
        j64(params), j64(params), j64(kp1), j64(kp2), j64(R12), j64(t12), j64(unc)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 40


@pytest.mark.parametrize("baseline", [np.array([0.5, 0.05, 0.0]), np.zeros(3)])
def test_triangulate_matches_kb8_equals_the_reference(baseline):
    params = np.array([285.0, 285.0, 320.0, 240.0, -0.007, 0.04, -0.035, 0.005])
    R12, kp1, kp2 = _pair(4, params, ref.project_kb8, baseline, 16)
    kp2 = kp2 + np.random.RandomState(5).randn(*kp2.shape) * 2.0
    s2 = np.full(16, 1.2)
    z1, p3d = cam.triangulate_matches(
        cam.unproject_kb8, cam.unproject_kb8, cam.project_kb8, cam.project_kb8,
        t64(params), t64(params), t64(kp1), t64(kp2), t64(R12), t64(baseline), t64(s2), t64(s2))
    rz1, rp3d = ref.triangulate_matches(
        ref.unproject_kb8, ref.unproject_kb8, ref.project_kb8, ref.project_kb8,
        j64(params), j64(params), j64(kp1), j64(kp2), j64(R12), j64(baseline), j64(s2),
        j64(s2))
    np.testing.assert_allclose(z1.numpy(), np.asarray(rz1), **NEWTON)
    np.testing.assert_allclose(p3d.numpy(), np.asarray(rp3d), rtol=1e-8, atol=1e-8)
    ok = cam.epipolar_constrain_kb8(t64(params), t64(params), t64(kp1), t64(kp2), t64(R12),
                                    t64(baseline), t64(s2), t64(s2)).numpy()
    np.testing.assert_array_equal(ok, np.asarray(ref.epipolar_constrain_kb8(
        j64(params), j64(params), j64(kp1), j64(kp2), j64(R12), j64(baseline), j64(s2),
        j64(s2))))
    if baseline.any():
        assert 0 < ok.sum()
    else:
        assert not ok.any()


def test_rectify_kb8_points_equals_the_reference_beyond_85_and_90_degrees():
    thetas = np.deg2rad([0.0, 5.0, 40.0, 70.0, 84.0, 84.99, 85.01, 88.0, 90.5, 100.0, 110.0])
    phis = np.linspace(0, 2 * np.pi, len(thetas), endpoint=False)
    X = np.stack([np.sin(thetas) * np.cos(phis), np.sin(thetas) * np.sin(phis),
                  np.cos(thetas)], 1)
    uv = _ref_batch(ref.project_kb8, KB8_WIDE, X)
    uv = np.concatenate([uv, np.random.RandomState(6).uniform([0, 0], [640, 480], (40, 2))])
    out, valid, s2 = cam.rectify_kb8_points(KB8_WIDE, uv, return_aux=True, device="cpu")
    r_out, r_valid, r_s2 = ref.rectify_kb8_points(KB8_WIDE, uv, return_aux=True)
    np.testing.assert_array_equal(valid, r_valid)
    assert valid[:6].all() and not valid[6:11].any()
    fin = np.isfinite(r_out).all(1)
    np.testing.assert_array_equal(np.isfinite(out).all(1), fin)
    np.testing.assert_allclose(out[fin], r_out[fin], **NEWTON)
    np.testing.assert_array_equal(np.isfinite(s2), np.isfinite(r_s2))
    m = np.isfinite(r_s2)
    np.testing.assert_allclose(s2[m], r_s2[m], rtol=1e-10, atol=1e-10)
    assert s2.dtype == np.float64 and valid.dtype == bool
    np.testing.assert_allclose(cam.rectify_kb8_points(KB8_WIDE, uv, device="cpu"), out,
                               rtol=0, atol=0)


def test_kb8_ray_grid_equals_the_reference():
    got = cam.kb8_ray_grid(KB8_WIDE, 64, 48, device="cpu")
    want = ref.kb8_ray_grid(KB8_WIDE, 64, 48)
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, **NEWTON)


def test_camera_tags_equal_the_reference():
    assert (cam.CAMERA_PINHOLE, cam.CAMERA_KB8, cam.KB8_MAX_THETA_DEG) == (
        ref.CAMERA_PINHOLE, ref.CAMERA_KB8, ref.KB8_MAX_THETA_DEG)
