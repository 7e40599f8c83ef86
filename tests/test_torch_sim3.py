"""Parity of the port's Sim(3) modules with the JAX reference (float64, CPU).

  * `ops/sim3`: exp, log, mul, inv, act, the edge error and the left
    retraction on every branch of `_W_coeffs` (small or general rotation
    angle x small or general log-scale), to 1e-12;
  * `ransac/sim3_solver`: `horn_sim3` and `sim3_ransac` on the inputs of
    tests/test_sim3_and_ransac.py::test_horn_sim3_and_ransac (R compared,
    never the quaternion: q and -q give the same R), S12 to 1e-9, equal
    inlier masks and counts;
  * `solver/sim3_opt`: the linearized Sim3 pair problem and
    `optimize_sim3` on tests/test_sim3_and_ransac.py::_sim3_pair_instance,
    S12 to 1e-9 and equal inlier masks; the dense and the PCG essential
    graph on that file's `_make_pose_graph(24, seed=11)`: normal equations,
    chi2 and poses to 1e-9;
  * `utils/synthetic.make_essential_graph_numpy` array-equal to the
    reference's `make_essential_graph` at n_kf = 64, open arc and laps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.ops import sim3 as jsim3
from amcslam_tpu.ransac import sim3_solver as jss
from amcslam_tpu.solver import sim3_opt as jso
from amcslam_tpu.utils import synthetic as jsyn
from amcslam_tpu.utils.synthetic import make_rig
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.ops import sim3 as tsim3
from amcslam_tpu_torch.ransac import sim3_solver as tss
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.solver import sim3_opt as tso
from amcslam_tpu_torch.utils import synthetic as tsyn
from test_sim3_and_ransac import _make_pose_graph, _sim3_pair_instance, rand_sim3

F64 = jnp.float64


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want) / (1.0 + np.abs(want))) if got.size else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# ops/sim3
# ---------------------------------------------------------------------------

# (rotation angle, log-scale) per branch of _W_coeffs in float64: small
# means theta^2 < 1e-8 / |sigma| < 1e-5
BRANCHES = {
    "small_t_small_s": (3e-5, 2e-6),
    "small_t_gen_s": (3e-5, 0.3),
    "gen_t_small_s": (0.7, 2e-6),
    "gen_t_gen_s": (0.7, -0.25),
    "zero": (0.0, 0.0),
    "near_pi": (np.pi - 1e-4, 0.1),
}


def tangents(theta, sigma, n=8, seed=0):
    rng = np.random.RandomState(seed)
    ax = rng.randn(n, 3)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    return np.concatenate([ax * theta, rng.randn(n, 3), np.full((n, 1), sigma)], 1)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_exp_log_and_W_coeffs_match_reference(branch):
    v = tangents(*BRANCHES[branch])
    got = tsim3.exp_sim3(t64(v))
    want = jax.vmap(jsim3.exp_sim3)(jnp.asarray(v, F64))
    for a, b in zip(got, want):
        close(a, b, 1e-12)
    theta2 = (v[:, :3] ** 2).sum(1)
    s = np.exp(v[:, 6])
    gw = tsim3._W_coeffs(t64(theta2), t64(v[:, 6]), t64(s))
    ww = jsim3._W_coeffs(jnp.asarray(theta2), jnp.asarray(v[:, 6]), jnp.asarray(s), F64)
    for a, b in zip(gw, ww):
        close(a, b, 1e-12)
    close(tsim3.log_sim3(got), jax.vmap(jsim3.log_sim3)(want), 1e-12)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_group_ops_error_and_retraction_match_reference(fix_scale):
    rng = np.random.RandomState(1)
    va, vb, vc = (np.stack([rand_sim3(rng)[1] for _ in range(6)]) for _ in range(3))
    d = tangents(0.2, 0.05, n=6, seed=2)
    A, B, C = (tsim3.exp_sim3(t64(v)) for v in (va, vb, vc))
    jA, jB, jC = (jax.vmap(jsim3.exp_sim3)(jnp.asarray(v, F64)) for v in (va, vb, vc))
    x = rng.randn(6, 3)
    for a, b in zip(tsim3.mul(A, B), jax.vmap(jsim3.mul)(jA, jB)):
        close(a, b, 1e-12)
    for a, b in zip(tsim3.inv(A), jax.vmap(jsim3.inv)(jA)):
        close(a, b, 1e-12)
    close(tsim3.act(A, t64(x)), jax.vmap(jsim3.act)(jA, jnp.asarray(x)), 1e-12)
    close(A.matrix(), jax.vmap(lambda S: S.matrix())(jA), 1e-12)
    for a, b in zip(tsim3.identity(), jsim3.identity()):
        close(a, b, 0.0)
    T = np.tile(np.eye(4), (6, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = A.R.numpy(), A.t.numpy()
    for a, b in zip(tsim3.from_se3(t64(T)), jax.vmap(jsim3.from_se3)(jnp.asarray(T))):
        close(a, b, 0.0)
    close(tsim3.sim3_error(C, A, B), jax.vmap(jsim3.sim3_error)(jC, jA, jB), 1e-12)
    d_t = t64(d)
    got = tsim3.retract_left(A, d_t, torch.tensor(fix_scale))
    assert torch.equal(d_t, t64(d))  # the caller's tangent is not written
    want = jax.vmap(lambda S, dd: jsim3.retract_left(S, dd, jnp.asarray(fix_scale)))(
        jA, jnp.asarray(d))
    for a, b in zip(got, want):
        close(a, b, 1e-12)


# ---------------------------------------------------------------------------
# Horn + RANSAC
# ---------------------------------------------------------------------------


def ransac_case():
    """tests/test_sim3_and_ransac.py::test_horn_sim3_and_ransac's inputs as
    numpy: (P1, P2) for the 3-point Horn check, the RANSAC fields with 30 %
    corrupted correspondences, and the 32 samples."""
    rng = np.random.RandomState(7)
    S_gt, _ = rand_sim3(np.random.RandomState(8), scale_spread=0.4)
    P2 = rng.randn(16, 3) * 2
    P1 = np.asarray(jax.vmap(lambda x: jsim3.act(S_gt, x))(jnp.asarray(P2, F64)))
    n = 60
    Tbc, K, _ = make_rig(2, 9)
    Tc_b = np.stack([np.linalg.inv(T) for T in Tbc])
    X2 = rng.randn(n, 3) * 2 + np.array([0, 0, 10.0])
    X1 = np.asarray(jax.vmap(lambda x: jsim3.act(S_gt, x))(jnp.asarray(X2, F64)))
    bad = rng.rand(n) < 0.3
    X2c = X2.copy()
    X2c[bad] += rng.randn(int(bad.sum()), 3) * 5 + 3

    def proj(Xb, c):
        Xc = Tc_b[c, :3, :3] @ Xb + Tc_b[c, :3, 3]
        return np.array([K[c, 0] * Xc[0] / Xc[2] + K[c, 2], K[c, 1] * Xc[1] / Xc[2] + K[c, 3]])

    cam1 = rng.randint(0, 2, n)
    cam2 = rng.randint(0, 2, n)
    fields = dict(
        Xb1=X1, Xb2=X2c,
        obs1=np.stack([proj(X1[i], cam1[i]) for i in range(n)]),
        obs2=np.stack([proj(X2[i], cam2[i]) for i in range(n)]),
        cam1=cam1, cam2=cam2, max_err1=np.full(n, 9.21), max_err2=np.full(n, 9.21),
        valid=np.ones(n, bool), K1=K, K2=K, Tc1b=Tc_b, Tc2b=Tc_b, fix_scale=np.asarray(False))
    samples = np.stack([np.random.RandomState(100 + h).choice(n, 3, replace=False)
                        for h in range(32)])
    return (P1, P2), fields, samples, bad


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_reference(fix_scale):
    (P1, P2), _, _, _ = ransac_case()
    # every 3-point window of the 16 points, in one batched call
    idx = np.stack([np.arange(i, i + 3) for i in range(14)])
    s, R, t = tss.horn_sim3(t64(P1[idx]), t64(P2[idx]), fix_scale)
    js, jR, jt = jax.vmap(lambda a, b: jss.horn_sim3(a, b, jnp.asarray(fix_scale)))(
        jnp.asarray(P1[idx]), jnp.asarray(P2[idx]))
    close(s, js, 1e-9)
    close(R, jR, 1e-9)
    close(t, jt, 1e-9)
    if fix_scale:
        assert bool((s == 1.0).all())


def test_sim3_ransac_matches_reference():
    _, fields, samples, bad = ransac_case()
    (s, R, t), inl, n_best, n_all = tss.sim3_ransac(
        convert.sim3_ransac_from(fields), torch.tensor(samples))
    jdata = jss.Sim3RansacData(**{k: jnp.asarray(v) for k, v in fields.items()})
    (js, jR, jt), jinl, jn, jn_all = jax.jit(jss.sim3_ransac)(jdata, jnp.asarray(samples, jnp.int32))
    np.testing.assert_array_equal(n_all.numpy(), np.asarray(jn_all))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(n_best) == int(jn) >= 0.9 * int((~bad).sum())
    close(s, js, 1e-9)
    close(R, jR, 1e-9)
    close(t, jt, 1e-9)


def test_sim3_ransac_carrier_takes_the_reference_tuple():
    _, fields, samples, _ = ransac_case()
    jdata = jss.Sim3RansacData(**{k: jnp.asarray(v) for k, v in fields.items()})
    a, b = convert.sim3_ransac_from(jdata), convert.sim3_ransac_from(fields)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.cam1.dtype == torch.int64 and a.valid.dtype == torch.bool


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


def pair_case(outlier_frac=0.1):
    data, (s_gt, R_gt, t_gt), _ = _sim3_pair_instance(noise=0.2, outlier_frac=outlier_frac)
    d = np.array([0.03, -0.02, 0.04, 0.2, -0.1, 0.15, 0.05])
    S0 = jsim3.mul(jsim3.exp_sim3(jnp.asarray(d, F64)),
                   jsim3.Sim3(s=jnp.asarray(s_gt, F64), R=jnp.asarray(R_gt, F64),
                              t=jnp.asarray(t_gt, F64)))
    return data, S0


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_pair_normal_equations_match_reference(fix_scale):
    data, S0 = pair_case()
    data = data._replace(fix_scale=jnp.asarray(fix_scale))
    lvl = jnp.ones_like(data.valid)
    jp = jso._make_sim3_problem(data, lvl, lvl, jnp.asarray(np.sqrt(10.0)))
    tdata = convert.sim3_pair_from(data)
    tp = tso._make_sim3_problem(tdata, torch.ones_like(tdata.valid),
                                torch.ones_like(tdata.valid), float(np.sqrt(10.0)))
    S0t = convert.sim3_from(S0)
    H, b = tp.linearize(S0t)
    jH, jb = jax.jit(jp.linearize)(S0)
    close(H, jH, 1e-9)
    close(b, jb, 1e-9)
    close(tp.chi2(S0t), jp.chi2(S0), 1e-12)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.1])
def test_optimize_sim3_matches_reference(outlier_frac):
    data, S0 = pair_case(outlier_frac)
    S, n_inl, inlier = tso.optimize_sim3(convert.sim3_pair_from(data), convert.sim3_from(S0), 10.0)
    jS, jn, jinl = jax.jit(jso.optimize_sim3, static_argnums=2)(data, S0, 10.0)
    for a, b in zip(S, jS):
        close(a, b, 1e-9)
    np.testing.assert_array_equal(inlier.numpy(), np.asarray(jinl))
    assert int(n_inl) == int(jn)


# ---------------------------------------------------------------------------
# Essential graph
# ---------------------------------------------------------------------------


def lm_trace(problem, state, n_iter=20, lambda_init=1e-16):
    """chi2 after each LM iteration, from `lm_segment` steps (one
    `lm_optimize` run split at every iteration: the same op sequence)."""
    carry = tlm.lm_init(problem, state)
    chis = []
    for it in range(1, n_iter + 1):
        carry = tlm.lm_segment(problem, carry, it, lambda_init=lambda_init)
        chis.append(float(carry.chi))
        if carry.term:
            break
    return carry.state, chis


@pytest.mark.parametrize("use_pcg", [False, True])
def test_essential_graph_matches_reference(use_pcg):
    jstate, jdata = _make_pose_graph(24, seed=11)
    jout, jstats = jax.jit(jso.optimize_essential_graph, static_argnums=2)(jdata, jstate, use_pcg)
    data, state = convert.essential_graph_from(jdata), convert.sim3_field_from(jstate)
    out, stats = tso.optimize_essential_graph(data, state, use_pcg=use_pcg)
    assert stats.iterations == int(jstats.iterations)
    close(stats.initial_chi2, jstats.initial_chi2, 1e-9)
    close(stats.chi2, jstats.chi2, 1e-9)
    for a, b in zip(out, jout):
        close(a, b, 1e-9)
    # split at every iteration, the same run
    make = tso.make_essential_graph_problem_pcg if use_pcg else tso.make_essential_graph_problem
    traced, chis = lm_trace(make(data), state)
    assert chis[-1] == float(stats.chi2)
    for a, b in zip(traced, out):
        assert torch.equal(a, b)


def test_essential_graph_normal_equations_match_reference():
    """The dense H and b (a scatter of 14x14 blocks) and the PCG's block
    diagonal and gradient, against the reference's."""
    jstate, jdata = _make_pose_graph(24, seed=11, n_loops=3)
    data, state = convert.essential_graph_from(jdata), convert.sim3_field_from(jstate)
    H, b, act = tso.make_essential_graph_problem(data).linearize(state)
    jH, jb, jact = jax.jit(jso.make_essential_graph_problem(jdata).linearize)(jstate)
    close(H, jH, 1e-9)
    close(b, jb, 1e-9)
    close(act, jact, 0.0)
    *_, D, bp, _ = tso.make_essential_graph_problem_pcg(data).linearize(state)
    *_, jD, jbp, _ = jax.jit(jso.make_essential_graph_problem_pcg(jdata).linearize)(jstate)
    close(D, jD, 1e-9)
    close(bp, jbp, 1e-9)


def test_pcg_stops_where_the_reference_stops():
    """A tolerance reached before the step cap: the port's host-read exit
    stops at the same step with the same solution; a zero gradient takes no
    step."""
    jstate, jdata = _make_pose_graph(24, seed=11)
    data, state = convert.essential_graph_from(jdata), convert.sim3_field_from(jstate)
    p = tso.make_essential_graph_problem_pcg(data, pcg_iters=250, pcg_tol=1e-6)
    jp = jso.make_essential_graph_problem_pcg(jdata, pcg_iters=250, pcg_tol=1e-6)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    dx, xx, xb = p.solve(p.linearize(state), lam)
    jdx, jxx, jxb = jax.jit(lambda s_: jp.solve(jp.linearize(s_), jnp.asarray(1e-3)))(jstate)
    close(dx, jdx, 1e-9)
    Ji, Jj, D, b, act = p.linearize(state)
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
    _, steps, rel = tso._pcg(Ji, Jj, i_, j_, D, b, act, lam, 250, 1e-6)
    assert 0 < steps < 250 and rel <= 1e-6
    x0, steps0, _ = tso._pcg(Ji, Jj, i_, j_, D, torch.zeros_like(b), act, lam, 250, 1e-6)
    assert steps0 == 0 and not bool(x0.any())


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("laps", [None, 4])
def test_make_essential_graph_equals_reference(laps):
    kw = dict(n_kf=64, n_loop=6, drift=0.002, seed=4, step_m=5.0, laps=laps)
    jdata, jstate, jTs = jsyn.make_essential_graph(**kw)
    data, state, Ts = tsyn.make_essential_graph_numpy(**kw)
    np.testing.assert_array_equal(Ts, jTs)
    for k, v in jdata._asdict().items():
        np.testing.assert_array_equal(data[k], np.asarray(v), err_msg=k)
    for k, v in jstate._asdict().items():
        np.testing.assert_array_equal(state[k], np.asarray(v), err_msg=k)
    tdata, tstate, _ = tsyn.make_essential_graph(**kw)
    assert tdata.pairs.dtype == torch.int64 and tstate.R.dtype == torch.float64
