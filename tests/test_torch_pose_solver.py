"""Parity of the port's per-frame pose solver with the JAX reference.

Problems come from the reference's generator
(`amcslam_tpu.utils.synthetic.make_pose_problem`, float64, CPU) and are
carried into the port with `convert.pose_from_reference`. Both branches of
the async-camera edges run: per edge (as bench.py runs it) and through the
interpolation table (`mg_it`/`it_t`, as the pipeline's extraction builds
it; the port then takes its packs from `ops/interp_chain.gp_interp_packs`,
the plain chain on the CPU). The reference's closures run jitted.
Tolerances:

  * generator arrays: exact;
  * linearize H, b: rtol 1e-9 / atol 1e-10 (sums in another order);
    chi2 relative 1e-12; solve dx rtol 1e-7 / atol 1e-9 (as the BA tests);
  * lm_optimize: chi2 relative 1e-9 and the same iteration count
    (as tests/test_pose_solver.py:259-268);
  * pose_gp_optimize: equal masks and counts, state to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.solver import lm as jlm
from amcslam_tpu.solver import pose_solver as jps
from amcslam_tpu.utils.synthetic import make_pose_problem as jmake
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.solver import pose_solver as tps
from amcslam_tpu_torch.utils.synthetic import make_pose_problem as tmake
from amcslam_tpu_torch.utils.synthetic import make_pose_problem_numpy
from test_torch_ba import assert_field_equal, rel

F64 = torch.float64


def jax_problem_fn(name):
    """One jitted reference closure per name, shared by every test (the
    data is an argument, so each shape and branch compiles once)."""
    def f(d, s, *args):
        p = jps.make_problem(d, d.mg_valid, d.st_valid, huber_on=True)
        return getattr(p, name)(s, *args)
    return jax.jit(f)


J_CHI2 = jax_problem_fn("chi2")
J_LIN = jax_problem_fn("linearize")
J_SOLVE = jax.jit(lambda d, lin, lam: jps.make_problem(
    d, d.mg_valid, d.st_valid, huber_on=True).solve(lin, lam))
J_OPT = jax.jit(jps.pose_gp_optimize)
# the iteration budget is traced (lm_segment takes it as a traced cap), so
# every budget shares one compile per branch
J_LM = jax.jit(lambda d, s, iters: jlm.lm_optimize(
    jps.make_problem(d, d.mg_valid, d.st_valid, True), s, iters))


def with_table(jd, td):
    """Both problems with the interpolation table of their edge times."""
    it, it_t = tps.interp_table(np.asarray(jd.mg_t))
    return (jd._replace(mg_it=jnp.asarray(it, jnp.int32), it_t=jnp.asarray(it_t)),
            td._replace(mg_it=torch.tensor(it), it_t=torch.tensor(it_t)))


def problems(branch, fix_prev=True, **kw):
    """(reference data, state; port data, state; gt) for one branch."""
    jd, js, jg = jmake(**kw)
    jd = jd._replace(fix_prev=jnp.asarray(fix_prev))
    td, ts = convert.pose_from_reference(jd, js)
    if branch == "table":
        jd, td = with_table(jd, td)
    return jd, js, td, ts, jg


def pad_edges(jd, n_m, n_s):
    """Pad the edge arrays with n_m / n_s rows (valid False), as the
    pipeline's extraction pads to its buckets; the pad rows' observations
    are NaN, so their residuals and weights are NaN before masking."""
    def pad(a, n, value=0):
        a = np.asarray(a)
        return jnp.asarray(np.concatenate([a, np.full((n,) + a.shape[1:], value, a.dtype)]))
    rep = {k: pad(getattr(jd, k), n_m) for k in
           ("mg_Xw", "mg_t", "mg_cam", "mg_w", "mg_valid", "mg_close")}
    rep.update({k: pad(getattr(jd, k), n_s) for k in
                ("st_Xw", "st_w", "st_valid", "st_is_stereo", "st_close")})
    rep["mg_obs"] = pad(jd.mg_obs, n_m, np.nan)
    rep["st_obs"] = pad(jd.st_obs, n_s, np.nan)
    return jd._replace(**rep)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_mono=16, n_stereo=12, seed=0),
    dict(n_mono=24, n_stereo=16, n_cams=4, noise_px=0.0, seed=3),
    dict(n_mono=64, n_stereo=48, outlier_frac=0.15, seed=5),
])
def test_generator_arrays_equal_reference(kw):
    jd, js, jg = jmake(**kw)
    dn, sn, gn = make_pose_problem_numpy(**kw)
    assert set(dn) == {k for k in jd._fields if getattr(jd, k) is not None}
    td, ts, tg = tmake(**kw)
    for name in dn:
        np.testing.assert_array_equal(dn[name], np.asarray(getattr(jd, name)), err_msg=name)
        assert_field_equal(getattr(td, name), getattr(jd, name), name)
    assert td.mg_it is None and td.it_t is None
    for name in js._fields:
        assert_field_equal(getattr(ts, name), getattr(js, name), "state0." + name)
        assert_field_equal(getattr(tg, name), getattr(jg, name), "gt." + name)


def test_generator_float32_casts_like_reference():
    jd, js, _ = jmake(n_mono=16, n_stereo=12, seed=2, dtype=jnp.float32)
    td, ts, _ = tmake(n_mono=16, n_stereo=12, seed=2, dtype=torch.float32)
    for name in ("t_cur", "qi_inv", "Tbc", "mg_obs", "mg_t", "st_obs"):
        assert getattr(td, name).dtype == torch.float32
        assert_field_equal(getattr(td, name), getattr(jd, name), name)
    assert_field_equal(ts.T, js.T, "T")


def test_interp_table_indexes_the_edge_times():
    t = np.array([0.03, 0.05, 0.03, 0.07, 0.05])
    it, it_t = tps.interp_table(t)
    assert it.dtype == np.int64
    np.testing.assert_array_equal(it_t, [0.03, 0.05, 0.07])
    np.testing.assert_array_equal(it_t[it], t)


# ---------------------------------------------------------------------------
# make_problem: chi2 / linearize / solve / retract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fix_prev", [True, False])
@pytest.mark.parametrize("branch", ["edge", "table"])
def test_make_problem_matches_reference(branch, fix_prev):
    jd, js, td, ts, _ = problems(branch, fix_prev, n_mono=24, n_stereo=16,
                                 outlier_frac=0.15, seed=4)
    tp = tps.make_problem(td, td.mg_valid, td.st_valid, huber_on=True)
    assert rel(tp.chi2(ts), J_CHI2(jd, js)) <= 1e-12
    jlin = J_LIN(jd, js)
    tlin = tp.linearize(ts)
    for a, b, name in zip(tlin, jlin, ("H", "b", "act")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-10, err_msg=name)
    assert float(tlin[2][:12].sum()) == (0.0 if fix_prev else 12.0)
    assert rel(tp.max_abs_diag(tlin), np.max(np.abs(np.diag(np.asarray(jlin[0])))
                                             * np.asarray(jlin[2]))) <= 1e-12
    lam = 0.37
    jdx, jxx, jxb = J_SOLVE(jd, jlin, jnp.asarray(lam))
    dx, xx, xb = tp.solve(tlin, torch.tensor(lam, dtype=F64))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-7, atol=1e-9)
    assert rel(xx, jxx) <= 1e-8 and rel(xb, jxb) <= 1e-8
    new = tp.retract(ts, dx)
    jnew = jps.make_problem(jd, jd.mg_valid, jd.st_valid, True).retract(js, jdx)
    np.testing.assert_allclose(new.T.numpy(), np.asarray(jnew.T), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(new.v.numpy(), np.asarray(jnew.v), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("branch", ["edge", "table"])
def test_padded_edges_are_masked_nan_safely(branch):
    """Pad rows (valid False) with NaN residuals: where-masking keeps H, b
    and chi2 finite and equal to the reference."""
    jd, js, jg = jmake(n_mono=16, n_stereo=12, seed=6)
    jd = pad_edges(jd, 8, 4)
    td, ts = convert.pose_from_reference(jd, js)
    if branch == "table":
        jd, td = with_table(jd, td)
    tp = tps.make_problem(td, td.mg_valid, td.st_valid, huber_on=True)
    r_m = tps._mono_gp_all(td, ts)[0]
    assert not bool(torch.isfinite(r_m[16:]).all())
    H, b, _ = tp.linearize(ts)
    assert bool(torch.isfinite(H).all() and torch.isfinite(b).all())
    jlin = J_LIN(jd, js)
    np.testing.assert_allclose(H.numpy(), np.asarray(jlin[0]), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(b.numpy(), np.asarray(jlin[1]), rtol=1e-9, atol=1e-10)
    assert rel(tp.chi2(ts), J_CHI2(jd, js)) <= 1e-12


@pytest.mark.parametrize("branch", ["edge", "table"])
def test_residual_paths_equal_jacobian_paths(branch):
    """chi2 and the re-leveling take the Jacobian-free residual paths; they
    compute the residuals and depths of the Jacobian paths bit for bit."""
    _, _, td, ts, _ = problems(branch, n_mono=24, n_stereo=16, outlier_frac=0.15, seed=2)
    r, _, _, z = tps._mono_gp_all(td, ts)
    r2, z2 = tps._mono_gp_residuals(td, ts)
    assert torch.equal(r, r2) and torch.equal(z, z2)
    r, _, z = tps._stereo_all(td, ts)
    r2, z2 = tps._stereo_residuals(td, ts)
    assert torch.equal(r, r2) and torch.equal(z, z2)


def test_branches_agree():
    """Per-edge and table branches linearize the same problem."""
    _, _, td, ts, _ = problems("edge", n_mono=24, n_stereo=16, seed=7)
    _, _, tdt, _, _ = problems("table", n_mono=24, n_stereo=16, seed=7)
    H, b, _ = tps.make_problem(td, td.mg_valid, td.st_valid, True).linearize(ts)
    Ht, bt, _ = tps.make_problem(tdt, tdt.mg_valid, tdt.st_valid, True).linearize(ts)
    np.testing.assert_allclose(Ht.numpy(), H.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(bt.numpy(), b.numpy(), rtol=1e-9, atol=1e-10)


# ---------------------------------------------------------------------------
# LM on the pose problem and the full schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 3, 10])
@pytest.mark.parametrize("branch", ["edge", "table"])
def test_lm_optimize_matches_reference(branch, iters):
    """tests/test_pose_solver.py::test_pose_solver_oracle_parity_shared_jacobians:
    16 mono / 12 stereo edges, seed 4, budgets 1, 3, 10."""
    jd, js, td, ts, _ = problems(branch, n_mono=16, n_stereo=12, seed=4)
    jstate, jstats = J_LM(jd, js, iters)
    tp = tps.make_problem(td, td.mg_valid, td.st_valid, huber_on=True)
    tstate, tstats = tlm.lm_optimize(tp, ts, num_iterations=iters)
    assert tstats.iterations == int(jstats.iterations)
    assert rel(tstats.chi2, jstats.chi2) <= 1e-9
    assert rel(tstats.lam, jstats.lam) <= 1e-9
    np.testing.assert_allclose(tstate.T.numpy(), np.asarray(jstate.T), atol=1e-9)


@pytest.mark.parametrize("branch", ["edge", "table"])
def test_pose_gp_optimize_matches_reference(branch):
    """The 4 x 10 schedule with 15 % gross outliers and re-leveling: the same
    inlier masks and count, and the state to 1e-9."""
    jd, js, td, ts, jg = problems(branch, n_mono=24, n_stereo=16, outlier_frac=0.15, seed=3)
    out_m = np.zeros(24, bool)
    out_m[:2] = True  # initial outlier flags, as RANSAC would set them
    out_s = np.zeros(16, bool)
    jstate, jlvl_m, jlvl_s, (jstats, jn) = J_OPT(jd, js, jnp.asarray(out_m), jnp.asarray(out_s))
    tstate, lvl_m, lvl_s, (tstats, n) = tps.pose_gp_optimize(
        td, ts, torch.tensor(out_m), torch.tensor(out_s))
    np.testing.assert_array_equal(lvl_m.numpy(), np.asarray(jlvl_m))
    np.testing.assert_array_equal(lvl_s.numpy(), np.asarray(jlvl_s))
    assert int(n) == int(jn)
    assert [s.iterations for s in tstats] == [int(s.iterations) for s in jstats]
    np.testing.assert_allclose(tstate.T.numpy(), np.asarray(jstate.T), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), rtol=1e-9, atol=1e-9)
    # and it solved the frame (tests/test_pose_solver.py:290-294 bounds)
    assert float((tstate.T[1] - torch.tensor(np.asarray(jg.T[1]))).abs().max()) < 2e-2
    assert 0.8 * 40 * 0.85 <= int(n) <= 40 - 0.8 * 0.15 * 40


def test_non_pd_step_is_rejected_like_reference():
    """cho_factor returns NaN on a non-PD system where torch.linalg.cholesky
    raises; the port's cholesky_ex gives a NaN step, so the trial is
    rejected and lambda grows exactly as in the reference."""
    jd, js, td, ts, _ = problems("edge", n_mono=16, n_stereo=12, seed=4)
    col = 12 + 3  # a rotation slot of the free current vertex

    def corrupt(problem, is_jax):
        def lin(s):
            H, b, act = problem.linearize(s)
            if is_jax:
                H = H.at[col, col].set(-1e6)
            else:
                H = H.clone()
                H[col, col] = -1e6
            return H, b, act
        return problem._replace(linearize=lin)

    tbad = corrupt(tps.make_problem(td, td.mg_valid, td.st_valid, True), False)
    dx, xx, _ = tbad.solve(tbad.linearize(ts), torch.tensor(1.0, dtype=F64))
    assert torch.isnan(dx).all() and torch.isnan(xx)
    jstate, jstats = jax.jit(lambda d, s: jlm.lm_optimize(corrupt(
        jps.make_problem(d, d.mg_valid, d.st_valid, True), True), s, 10, lambda_init=1.0))(jd, js)
    tstate, tstats = tlm.lm_optimize(tbad, ts, 10, lambda_init=1.0)
    assert tstats.iterations == int(jstats.iterations) == 3
    assert float(tstats.lam) == float(jstats.lam) == 64.0
    assert torch.equal(tstate.T, ts.T) and torch.equal(tstate.v, ts.v)
    assert rel(tstats.chi2, jstats.chi2) <= 1e-12
