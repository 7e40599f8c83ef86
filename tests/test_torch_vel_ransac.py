"""Parity of the port's MC-RANSAC and its batched LM loop.

  * `lm_optimize_batched` against the port's scalar `lm_optimize` run on
    each member alone: the same iteration count, lambda and chi2 to 1e-12,
    and the twist to 1e-11 relative (the member dimension only changes which
    vectorized loop the transcendental functions take; 40 iterations of a
    diverging hypothesis, |v| ~ 200, carry those last bits to ~1e-12);
    members stop at different iterations, and a singular member takes
    rejected trials, not an exception;
  * `optimize_vel`, the per-hypothesis fits and `mc_ransac` against the JAX
    reference (float64, CPU) on the construction of
    tests/test_sim3_and_ransac.py::test_mc_ransac and on a pow2-padded
    bucket built as tracking.py:583-599 pads: the same best hypothesis,
    inlier mask and count, twists to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.ransac import vel_ransac as jvr
from amcslam_tpu.utils.synthetic import _np_exp_se3, make_rig
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.ransac import vel_ransac as tvr
from amcslam_tpu_torch.solver import lm as tlm

H_HYP = 23  # maxIt in TrackLocalMap (Tracking.cc:2029)


def mc_case(n=64, n_pad=0, seed=11):
    """tests/test_sim3_and_ransac.py::test_mc_ransac as numpy fields (n
    matches, 25 % gross outliers), padded with n_pad safe rows: a point 5 m
    ahead of the stereo camera of the last frame, seen at its principal
    point, dt = 0, valid False. Returns (fields, samples (23,3), bad)."""
    rng = np.random.RandomState(seed)
    Tbc, K, _ = make_rig(3, 12)
    T_last = _np_exp_se3(rng.randn(6) * 0.2)
    v_true = np.array([1.5, 0.2, -0.1, 0.02, -0.05, 0.3])
    cam = rng.randint(0, 3, n)
    dt = rng.uniform(0.02, 0.12, n)
    Xw = np.zeros((n, 3))
    obs = np.zeros((n, 2))
    for i in range(n):
        Twc = T_last @ _np_exp_se3(v_true * dt[i]) @ Tbc[cam[i]]
        Xc = np.array([rng.uniform(-2, 2), rng.uniform(-1.5, 1.5), rng.uniform(4, 15)])
        Xw[i] = Twc[:3, :3] @ Xc + Twc[:3, 3]
        obs[i] = [K[cam[i], 0] * Xc[0] / Xc[2] + K[cam[i], 2] + rng.randn() * 0.3,
                  K[cam[i], 1] * Xc[1] / Xc[2] + K[cam[i], 3] + rng.randn() * 0.3]
    bad = rng.rand(n) < 0.25
    obs[bad] += 30 + rng.randn(int(bad.sum()), 2) * 15
    v0 = v_true + rng.randn(6) * 0.3
    if n_pad:
        cs = len(Tbc) - 1
        Twc = T_last @ Tbc[cs]
        ahead = Twc[:3, :3] @ np.array([0.0, 0.0, 5.0]) + Twc[:3, 3]
        Xw = np.concatenate([Xw, np.tile(ahead, (n_pad, 1))])
        obs = np.concatenate([obs, np.tile(K[cs, 2:4], (n_pad, 1))])
        dt = np.concatenate([dt, np.zeros(n_pad)])
        cam = np.concatenate([cam, np.full(n_pad, cs)])
    fields = dict(T_last=T_last, v0=v0, dt=dt, Xw=Xw, obs=obs, cam=cam,
                  w=np.ones(n + n_pad), valid=np.arange(n + n_pad) < n, Tbc=Tbc, K=K)
    samples = np.stack([np.random.RandomState(h).choice(n, 3, replace=False)
                        for h in range(H_HYP)])
    return fields, samples, bad


def jax_data(fields):
    return jvr.VelRansacData(**{
        k: jnp.asarray(v, jnp.int32) if k == "cam" else jnp.asarray(v)
        for k, v in fields.items()})


def _jax_hypotheses(data, samples):
    """The reference's per-hypothesis fit and count (mc_ransac's `hypo`)."""
    def hypo(idx):
        sub = data._replace(dt=data.dt[idx], Xw=data.Xw[idx], obs=data.obs[idx],
                            cam=data.cam[idx], w=data.w[idx], valid=data.valid[idx])
        v = jvr._fit_velocity(sub, jnp.ones(idx.shape[0], bool))
        r, _ = jvr._residuals_all(v, data)
        inl = data.valid & (jnp.linalg.norm(r, axis=-1) <= 3.0)
        return v, inl, jnp.sum(inl)
    return jax.vmap(hypo)(samples)


J_HYP = jax.jit(_jax_hypotheses)
J_MC = jax.jit(lambda d, s: jvr.mc_ransac(d, s, threshold=3.0, min_match=30))
J_OPTVEL = jax.jit(jvr.optimize_vel)


def solo_problem(rows, act):
    """The scalar five-closure problem of one member (rows (n,), act (n,))
    for the port's `lm_optimize`."""
    pb = tvr._fit_problem(rows._replace(**{k: getattr(rows, k)[None] for k in
                                           ("dt", "Xw", "obs", "cam", "w", "valid")}),
                          act[None])

    def solve(lin, lam):
        dx, xx, xb = pb.solve(lin, lam[None])
        return dx[0], xx[0], xb[0]

    return tlm.LMProblem(
        chi2=lambda v: pb.chi2(v[None])[0],
        linearize=lambda v: pb.linearize(v[None]),
        max_abs_diag=lambda lin: pb.max_abs_diag(lin)[0],
        solve=solve,
        retract=lambda v, dx: v + dx,
    )


def assert_members_equal_solo(data, samples, num_iterations=40):
    sub = tvr._rows(data, samples)
    problem = tvr._fit_problem(sub, sub.valid)
    v0 = data.v0.expand(samples.shape[0], 6)
    v, stats = tlm.lm_optimize_batched(problem, v0, num_iterations)
    for h in range(samples.shape[0]):
        rows = tvr._rows(data, samples[h])
        vs, ss = tlm.lm_optimize(solo_problem(rows, rows.valid), data.v0, num_iterations)
        assert int(stats.iterations[h]) == ss.iterations, h
        assert float(stats.lam[h]) == pytest.approx(float(ss.lam), rel=1e-12, abs=0.0)
        assert float(stats.chi2[h]) == pytest.approx(float(ss.chi2), rel=1e-12, abs=1e-300)
        assert float(stats.initial_chi2[h]) == pytest.approx(float(ss.initial_chi2), rel=1e-14)
        np.testing.assert_allclose(v[h].numpy(), vs.numpy(), rtol=1e-11, atol=1e-12)
    return v, stats


# ---------------------------------------------------------------------------
# the batched LM loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_iterations", [1, 5, 40])
def test_batched_lm_members_equal_their_solo_runs(num_iterations):
    fields, samples, _ = mc_case()
    data = convert.vel_ransac_from_numpy(fields)
    _, stats = assert_members_equal_solo(data, torch.tensor(samples), num_iterations)
    if num_iterations == 40:
        # members stop at different outer iterations
        assert len(set(stats.iterations.tolist())) > 1


def test_batched_lm_degenerate_and_singular_members():
    """A duplicate-row sample (rank-2 system, regular with lambda > 0) and a
    sample whose Jacobians vanish (dt = 0: H = 0 and lambda_0 = 0, a singular
    solve) run beside normal members. The singular member's trials are
    rejected (NaN step, no exception) until the Raul rule stops it after 3
    iterations with its start twist, as in the reference."""
    fields, samples, _ = mc_case()
    fields["dt"][:3] = 0.0
    samples = samples[:6].copy()
    samples[1] = [7, 7, 7]
    samples[2] = [0, 1, 2]
    data = convert.vel_ransac_from_numpy(fields)
    v, stats = assert_members_equal_solo(data, torch.tensor(samples))
    assert int(stats.iterations[2]) == 3 and float(stats.lam[2]) == 0.0
    assert torch.equal(v[2], data.v0)
    jv, _, _ = J_HYP(jax_data(fields), jnp.asarray(samples, jnp.int32))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-9, atol=1e-9)


def test_singular_solve_gives_nan_step():
    fields, _, _ = mc_case(n=8)
    data = convert.vel_ransac_from_numpy(fields)
    rows = tvr._rows(data, torch.tensor([[0, 1, 2]]))
    problem = tvr._fit_problem(rows, torch.zeros(1, 3, dtype=torch.bool))  # H = 0
    lin = problem.linearize(data.v0[None])
    dx, xx, xb = problem.solve(lin, torch.zeros(1, dtype=torch.float64))
    assert torch.isnan(dx).all() and torch.isnan(xx).all() and torch.isnan(xb).all()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pad", [0, 14])
def test_hypotheses_and_mc_ransac_match_reference(n_pad):
    n = 64 if n_pad == 0 else 50
    fields, samples, bad = mc_case(n=n, n_pad=n_pad)
    jd = jax_data(fields)
    td = convert.vel_ransac_from_numpy(fields)
    js = jnp.asarray(samples, jnp.int32)
    jv, jinl, jn = J_HYP(jd, js)
    tv, tinl, tn = tvr.score_hypotheses(td, torch.tensor(samples))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(torch.argmax(tn)) == int(jnp.argmax(jn))

    ok, v, inl, count = tvr.mc_ransac(td, torch.tensor(samples), threshold=3.0, min_match=30)
    jok, jvb, jinlb, jcount = J_MC(jd, js)
    assert bool(ok) == bool(jok) and bool(ok)
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinlb))
    np.testing.assert_allclose(v.numpy(), np.asarray(jvb), rtol=1e-9, atol=1e-9)
    # the reference test's acceptance (tests/test_sim3_and_ransac.py:390-398)
    assert int(count) >= 0.85 * int((~bad).sum())
    assert inl[:n].numpy()[bad].mean() < 0.3
    assert not bool(inl[n:].any())


def test_mc_ransac_min_match_gate():
    fields, samples, _ = mc_case()
    td = convert.vel_ransac_from_numpy(fields)
    ok, _, _, count = tvr.mc_ransac(td, torch.tensor(samples), min_match=64)
    assert not bool(ok) and int(count) < 64


@pytest.mark.parametrize("sample", [[3, 17, 40], [5, 5, 5]])
def test_optimize_vel_matches_reference(sample):
    fields, _, _ = mc_case()
    mask = np.zeros(64, bool)
    mask[sample] = True
    jv, jnorm = J_OPTVEL(jax_data(fields), jnp.asarray(mask))
    tv, tnorm = tvr.optimize_vel(convert.vel_ransac_from_numpy(fields), torch.tensor(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm), rtol=1e-9, atol=1e-9)
