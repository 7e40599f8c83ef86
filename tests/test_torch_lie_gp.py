"""Parity of the port's Lie-group and GP functions with the JAX reference.

The same inputs, made with numpy from a seed, go through
`amcslam_tpu/ops/{lie,gp}.py` (vmapped, float64 on the CPU) and through
`amcslam_tpu_torch/ops/{lie,gp}.py` (batched, float64 on the CPU). Cases
follow tests/test_lie.py and tests/test_gp.py: generic angles, angles near
pi and tiny angles (the series branches). Tolerance: max |a-b|/(1+|b|)
<= 1e-12 — both sides evaluate the same formulas, so only roundoff of
differently ordered sums separates them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.ops import gp as jgp
from amcslam_tpu.ops import lie as jlie
from amcslam_tpu_torch.ops import gp as tgp
from amcslam_tpu_torch.ops import lie as tlie

TOL = 1e-12
N = 24


def max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size else 0.0


def tangents(case, seed=0, n=N):
    """(n, 6) se(3) tangents [rho, omega] for one of the three regimes."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.8, size=(n, 6))
    if case == "near_pi":
        ax = rng.normal(size=(n, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        xi[:, 3:] = ax * (np.pi - 1e-3)
    elif case == "tiny":
        xi *= 1e-6
    return xi


def both(fn_name, *args, module=("lie", jlie, tlie)):
    """Run fn on numpy args through vmap(JAX) and the batched port."""
    _, jm, tm = module
    ref = jax.vmap(getattr(jm, fn_name))(*(jnp.asarray(a) for a in args))
    got = getattr(tm, fn_name)(*(torch.tensor(np.asarray(a)) for a in args))
    return got, ref


CASES = ["generic", "near_pi", "tiny"]
VEC3_FNS = ["hat", "exp_so3", "left_jacobian_so3", "left_jacobian_so3_inv",
            "right_jacobian_so3", "right_jacobian_so3_inv"]
VEC6_FNS = ["exp_se3", "se3_ad", "left_jacobian_pose3_Q", "left_jacobian_pose3",
            "right_jacobian_pose3", "left_jacobian_pose3_inv",
            "right_jacobian_pose3_inv"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", VEC3_FNS)
def test_so3_functions_match_reference(fn, case):
    w = tangents(case)[:, 3:]
    got, ref = both(fn, w)
    assert max_rel(got, ref) <= TOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", VEC6_FNS)
def test_se3_functions_match_reference(fn, case):
    got, ref = both(fn, tangents(case, seed=1))
    assert max_rel(got, ref) <= TOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["log_so3", "quat_from_rotmat", "vee"])
def test_rotation_matrix_functions_match_reference(fn, case):
    R = np.asarray(jax.vmap(jlie.exp_so3)(jnp.asarray(tangents(case, seed=2)[:, 3:])))
    if fn == "vee":
        R = R - np.swapaxes(R, 1, 2)
    got, ref = both(fn, R)
    assert max_rel(got, ref) <= TOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["log_se3", "se3_inv", "adj_se3"])
def test_transform_functions_match_reference(fn, case):
    T = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(tangents(case, seed=3))))
    got, ref = both(fn, T)
    assert max_rel(got, ref) <= TOL


def test_points_and_matrix_assembly_match_reference():
    rng = np.random.default_rng(4)
    T = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(tangents("generic", seed=4))))
    p = rng.normal(scale=3.0, size=(N, 3))
    for fn, args in [("transform_point", (T, p)), ("circle_dot", (p,)),
                     ("se3_matrix", (T[:, :3, :3], p))]:
        got, ref = both(fn, *args)
        assert max_rel(got, ref) <= TOL, fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_series_thresholds_follow_dtype(dtype):
    """theta = 0.15 is below the float32 series threshold (theta < 0.2) and
    above the float64 one (theta < 1e-2): each dtype takes its own branch,
    as in the reference, and agrees with the reference in that dtype."""
    assert tlie._small_threshold2(dtype) == jlie._small_threshold2(
        jnp.float64 if dtype == torch.float64 else jnp.float32)
    w = np.array([[0.09, -0.12, 0.0], [0.3, 0.2, -0.1]])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tol = TOL if dtype == torch.float64 else 1e-6
    for fn in ["exp_so3", "left_jacobian_so3_inv", "log_so3"]:
        x = w if fn != "log_so3" else np.asarray(
            jax.vmap(jlie.exp_so3)(jnp.asarray(w)))
        ref = jax.vmap(getattr(jlie, fn))(jnp.asarray(x, jdt))
        got = getattr(tlie, fn)(torch.tensor(np.asarray(x), dtype=dtype))
        assert got.dtype == dtype
        assert max_rel(got, ref) <= tol, fn


# ---------------------------------------------------------------------------
# GP
# ---------------------------------------------------------------------------


def gp_inputs(case, seed=5):
    """Endpoint states and times as in tests/test_gp.py, batched."""
    rng = np.random.default_rng(seed)
    T1 = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(tangents(case, seed))))
    dxi = rng.normal(scale=1e-7 if case == "tiny" else 0.3, size=(N, 6))
    T2 = np.einsum("nij,njk->nik", T1,
                   np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(dxi))))
    v1 = rng.normal(scale=0.2, size=(N, 6))
    v2 = rng.normal(scale=0.2, size=(N, 6))
    t1 = rng.uniform(0.0, 10.0, N)
    t2 = t1 + rng.uniform(0.05, 0.5, N)
    s = rng.uniform(0.0, 1.0, N)
    s[:3], s[3:6] = 0.0, 1.0  # interval endpoints
    return T1, T2, v1, v2, t1, t2, t1 + s * (t2 - t1)


def make_qc(seed=0):
    d = np.random.RandomState(seed).uniform(0.5, 2.0, 6)
    return np.diag(d), np.diag(1.0 / d)


def test_qi_qi_inv_transition_match_reference():
    Qc, Qc_inv = make_qc()
    dt = np.array([0.05, 0.5, 2.0])
    for fn, mat in [("qi", Qc), ("qi_inv", Qc_inv)]:
        ref = jax.vmap(lambda d, f=getattr(jgp, fn): f(d, jnp.asarray(mat)))(jnp.asarray(dt))
        got = getattr(tgp, fn)(torch.as_tensor(dt), torch.as_tensor(mat))
        assert max_rel(got, ref) <= TOL, fn
    ref = jax.vmap(jgp.transition)(jnp.asarray(dt))
    assert max_rel(tgp.transition(torch.as_tensor(dt)), ref) <= TOL


@pytest.mark.parametrize("case", CASES)
def test_gp_interpolation_matches_reference(case):
    T1, T2, v1, v2, t1, t2, t = gp_inputs(case)
    Qc, Qc_inv = make_qc(1)
    J = [jnp.asarray(a) for a in (T1, T2, v1, v2, t1, t2, t)]
    P = [torch.tensor(np.asarray(a)) for a in (T1, T2, v1, v2, t1, t2, t)]
    jQ, tQ = (jnp.asarray(Qc), jnp.asarray(Qc_inv)), (torch.as_tensor(Qc), torch.as_tensor(Qc_inv))

    ref = jax.vmap(jgp.interp_coeffs)(J[4], J[5], J[6])
    got = tgp.interp_coeffs(P[4], P[5], P[6])
    for g, r in zip(got, ref):
        assert max_rel(g, r) <= TOL

    ref = jax.vmap(lambda a, b, c: jgp.interp_matrices(a, b, c, *jQ))(J[4], J[5], J[6])
    got = tgp.interp_matrices(P[4], P[5], P[6], *tQ)
    for g, r in zip(got, ref):
        assert max_rel(g, r) <= TOL

    ref = jax.vmap(jgp.local_state)(J[0], J[1], J[3])
    got = tgp.local_state(P[0], P[1], P[3])
    for g, r in zip(got, ref):
        assert max_rel(g, r) <= TOL

    ref_T, ref_aux = jax.vmap(lambda *a: jgp.query_pose_aux(*a, *jQ))(*J)
    got_T, got_aux = tgp.query_pose_aux(*P, *tQ)
    assert max_rel(got_T, ref_T) <= TOL
    for g, r in zip(got_aux, ref_aux):
        assert max_rel(g, r) <= TOL
    ref_q = jax.vmap(lambda *a: jgp.query_pose(*a, *jQ))(*J)
    assert max_rel(tgp.query_pose(*P, *tQ), ref_q) <= TOL


def test_quaternion_pivot_ties_pick_the_first_index():
    """A rotation by pi about (1,1,0)/sqrt(2) ties the x and y pivots; both
    packages take the first (jnp.argmax / torch.argmax rule)."""
    R = np.array([[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
                  np.eye(3)])
    for fn in ("quat_from_rotmat", "log_so3"):
        got, ref = both(fn, R)
        assert max_rel(got, ref) <= TOL, fn
