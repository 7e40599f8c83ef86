"""Parity of the port's IMU preintegration, IMU factor and visual-inertial
BA with the JAX reference (`ops/imu.py`, `factors/imu.py`,
`solver/vi_ba.py`, `utils/synthetic.make_vi_ba_synthetic`).

The VI problem is the reference bench's SMOKE size of config 4 (5 KF / 48
landmarks, bench.py:197), float64 on the CPU.
Tolerances: preintegration 1e-12; the generator's arrays exact (the
preintegrated windows 1e-12); the IMU factor's residual and Jacobians
1e-10 against the reference and 1e-6 against central differences
(solver/debug.check_jacobian); linearize rtol 1e-9; the vi_ba chi2
trajectory and final state 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.factors import imu as jfimu
from amcslam_tpu.ops import imu as jimu
from amcslam_tpu.solver import lm as jlm
from amcslam_tpu.solver import vi_ba as jvi
from amcslam_tpu.utils.synthetic import make_vi_ba_synthetic as jmake
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.factors import imu as tfimu
from amcslam_tpu_torch.ops import imu as timu
from amcslam_tpu_torch.solver import debug
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.solver import vi_ba as tvi
from amcslam_tpu_torch.utils.synthetic import make_vi_ba_synthetic, make_vi_ba_synthetic_numpy

F64 = torch.float64


def close(a, b, tol, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


def windows(n_win=3, n=25, seed=0):
    """Random measurement windows with padding masks and per-step dts."""
    rng = np.random.RandomState(seed)
    acc = rng.randn(n_win, n, 3) + np.array([0.0, 0.0, 9.81])
    gyro = rng.randn(n_win, n, 3) * 0.5
    dts = rng.uniform(0.004, 0.006, (n_win, n))
    valid = rng.rand(n_win, n) > 0.15
    return acc, gyro, dts, valid


NGA = np.eye(6) * 1e-6
WALK = np.eye(6) * 1e-8


def reference_pre(acc, gyro, dts, valid, bg, ba):
    f = jax.jit(jax.vmap(jimu.preintegrate, in_axes=(0, 0, 0, None, None, None, None, 0)))
    return f(acc, gyro, dts, bg, ba, NGA, WALK, valid)


def t(a):
    return torch.tensor(np.asarray(a))


def test_preintegration_matches_reference():
    acc, gyro, dts, valid = windows()
    bg, ba = np.array([0.01, -0.02, 0.005]), np.array([0.05, 0.0, -0.03])
    ref = reference_pre(acc, gyro, dts, valid, bg, ba)
    got = timu.preintegrate(t(acc), t(gyro), t(dts), t(bg), t(ba), t(NGA), t(WALK), t(valid))
    for name in timu.PreintState._fields:
        close(getattr(got, name), getattr(ref, name), 1e-12, name)
    # bias-corrected deltas
    dbg, dba = np.array([1e-3, 2e-3, -1e-3]), np.array([-2e-3, 1e-3, 3e-3])
    jd = jax.jit(jax.vmap(jimu.delta_with_bias, in_axes=(0, None, None)))(ref, dbg, dba)
    for a, b in zip(timu.delta_with_bias(got, t(dbg), t(dba)), jd):
        close(a, b, 1e-12)
    # MergePrevious and Reintegrate re-integrate the measurements
    halves = [tuple(x[:, :12] for x in (acc, gyro, dts, valid)),
              tuple(x[:, 12:] for x in (acc, gyro, dts, valid))]
    merged = timu.merge_previous(tuple(map(t, halves[0])), tuple(map(t, halves[1])), t(bg),
                                 t(ba), t(NGA), t(WALK))
    again = timu.reintegrate(tuple(map(t, (acc, gyro, dts, valid))), t(bg), t(ba), t(NGA),
                             t(WALK))
    jmerged = jimu.merge_previous(tuple(x[0] for x in halves[0]), tuple(x[0] for x in halves[1]),
                                  bg, ba, NGA, WALK)
    for name in timu.PreintState._fields:
        assert torch.equal(getattr(merged, name), getattr(got, name)), name
        assert torch.equal(getattr(again, name), getattr(got, name)), name
        close(getattr(merged, name)[0], getattr(jmerged, name), 1e-12, name)


@pytest.fixture(scope="module")
def factor_case():
    acc, gyro, dts, valid = windows(n_win=4, seed=1)
    bg_lin = np.zeros(3)
    pre_j = reference_pre(acc, gyro, dts, np.ones_like(valid), bg_lin, bg_lin)
    rng = np.random.RandomState(2)
    si = jfimu.InertialState(R=np.asarray(jax.vmap(jimu.lie.exp_so3)(rng.randn(4, 3) * 0.3)),
                             p=rng.randn(4, 3), v=rng.randn(4, 3))
    sj = jfimu.InertialState(R=np.asarray(jax.vmap(jimu.lie.exp_so3)(rng.randn(4, 3) * 0.3)),
                             p=rng.randn(4, 3), v=rng.randn(4, 3))
    bg, ba = rng.randn(4, 3) * 1e-2, rng.randn(4, 3) * 1e-2
    return pre_j, si, sj, bg, ba, np.zeros((4, 3))


def test_imu_factor_matches_reference_and_central_differences(factor_case):
    pre_j, si, sj, bg, ba, blin = factor_case
    pre = timu.PreintState(*map(t, pre_j))
    tsi, tsj = tfimu.InertialState(*map(t, si)), tfimu.InertialState(*map(t, sj))
    got = tfimu.imu_residual_jac(tsi, tsj, t(bg), t(ba), pre, t(blin), t(blin))
    ref = jax.jit(jax.vmap(jfimu.imu_residual_jac))(si, sj, bg, ba, pre_j, blin, blin)
    for a, b, name in zip(got, ref, ("r", "Ji", "Jj", "Jbg", "Jba")):
        close(a, b, 1e-10, name)
    close(got[0], tfimu.imu_residual(tsi, tsj, t(bg), t(ba), pre, t(blin), t(blin)), 0.0)

    # the analytic (forward-mode) Jacobian against central differences of
    # the residual over the 24-dof retraction, one factor at a time
    for e in range(2):
        s_i, s_j = (tfimu.InertialState(*(f[e] for f in s)) for s in (tsi, tsj))
        pre_e = timu.PreintState(*(x[e] for x in pre))

        def residual(d):
            return tfimu.imu_residual(tfimu.retract_inertial(s_i, d[:9]),
                                      tfimu.retract_inertial(s_j, d[9:18]),
                                      t(bg[e]) + d[18:21], t(ba[e]) + d[21:24], pre_e,
                                      t(blin[e]), t(blin[e]))

        J = torch.cat([got[k][e] for k in range(1, 5)], -1)
        err, _ = debug.check_jacobian(residual, lambda s, d: d, None, J, 24)
        assert err <= 1e-6, (e, err)


@pytest.fixture(scope="module")
def vi_problem():
    jd, js, jg = jmake(n_kf=5, n_lm=48, seed=0)
    td, ts = convert.vi_ba_from_reference(jd, js)
    return jd, js, jg, td, ts


def test_generator_arrays_equal_reference(vi_problem):
    jd, js, jg, _, _ = vi_problem
    nd, ns, ng = make_vi_ba_synthetic_numpy(n_kf=5, n_lm=48, seed=0)
    assert set(nd) == set(jd._fields) - {"huber_mono"}
    for name in jd._fields:
        if name == "pre":
            for f in jd.pre._fields:
                close(nd["pre"][f], getattr(jd.pre, f), 1e-12, "pre." + f)
        elif name != "huber_mono":
            ref = np.asarray(getattr(jd, name))
            assert nd[name].shape == ref.shape, name
            np.testing.assert_array_equal(nd[name], ref, err_msg=name)
    for name in js._fields:
        np.testing.assert_array_equal(ns[name], np.asarray(getattr(js, name)), err_msg=name)
        np.testing.assert_array_equal(ng[name], np.asarray(getattr(jg, name)), err_msg=name)
    td, ts, tg = make_vi_ba_synthetic(n_kf=5, n_lm=48, seed=0, dtype=torch.float32)
    assert td.obs.dtype == torch.float32 and td.obs_kf.dtype == torch.int64
    assert td.pre.C.dtype == torch.float32 and ts.X.dtype == torch.float32


def test_vi_linearize_solve_chi2_match_reference(vi_problem):
    jd, js, _, td, ts = vi_problem
    jp, tp = jvi.make_vi_ba_problem(jd), tvi.make_vi_ba_problem(td)
    jlin = jax.jit(jp.linearize)(js)
    tlin = tp.linearize(ts)
    for a, b, name in zip(tlin, jlin, ("Hpp", "bp", "Wt", "Hll", "bl")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9 * float(np.abs(np.asarray(b)).max()), err_msg=name)
    assert abs(float(tp.chi2(ts)) / float(jax.jit(jp.chi2)(js)) - 1) <= 1e-12
    jdx, _, _ = jax.jit(jp.solve)(jlin, jnp.asarray(1e-2))
    dx, _, _ = tp.solve(tlin, torch.tensor(1e-2, dtype=F64))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-7, atol=1e-9)


def test_vi_ba_trajectory_matches_reference(vi_problem):
    jd, js, jg, td, ts = vi_problem
    jp, tp = jvi.make_vi_ba_problem(jd), tvi.make_vi_ba_problem(td)
    seg = jax.jit(lambda c, n: jlm.lm_segment(jp, c, n, lambda_init=1e-2))
    jc = jax.jit(lambda s: jlm.lm_init(jp, s))(js)
    tc = tlm.lm_init(tp, ts)
    for it in range(1, 11):
        jc = seg(jc, it)
        tc = tlm.lm_segment(tp, tc, it, lambda_init=1e-2)
        assert tc.it == int(jc.it) and tc.term == bool(jc.term)
        assert abs(float(tc.chi) / float(jc.chi) - 1) <= 1e-8, it
    out, stats = tvi.vi_ba(td, ts, 10)
    assert float(stats.chi2) == float(tc.chi)
    for name in tvi.VIBAState._fields:
        close(getattr(out, name), getattr(jc.state, name), 1e-8, name)
    # it converges towards the ground truth
    assert float(stats.chi2) < 1e-3 * float(stats.initial_chi2)
    assert float((out.p - t(jg.p)).abs().max()) < float((ts.p - t(jg.p)).abs().max())


def test_vi_non_pd_system_gives_a_nan_step(vi_problem):
    """A reduced system that is not positive definite gives a NaN step (the
    reference's cho_factor), which the LM driver rejects."""
    *_, td, ts = vi_problem
    tp = tvi.make_vi_ba_problem(td)
    Hpp, *rest = tp.linearize(ts)
    Hpp = Hpp.clone()
    Hpp[20, 20] = -1e12
    dx, xx, _ = tp.solve((Hpp, *rest), torch.tensor(1.0, dtype=F64))
    assert torch.isnan(dx).all() and torch.isnan(xx)
