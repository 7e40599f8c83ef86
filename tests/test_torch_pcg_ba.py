"""Parity of the port's matrix-free PCG global BA (`make_ba_problem_pcg`,
`global_ba_pcg`; reference `solver/ba.py:876-1360`) with the JAX reference.

Problems: tests/test_ba.py's PCG problem (6 KF / 48 landmarks, noise 0.3,
seed 7) and the reference bench's SMOKE size (8 KF / 64 landmarks), in
float64 on the CPU. The reference's CG step count is read through its
`_PCG_DEBUG` print, routed to a callback. Tolerances: one solve the same CG
steps and dx to 1e-7 (tests/test_ba.py:162-185); a global_ba_pcg chi2
trajectory relative 1e-8 per LM iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.solver import ba as jba
from amcslam_tpu.solver import lm as jlm
from amcslam_tpu.utils.synthetic import make_local_ba_problem as jmake
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.solver import ba as tba
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.utils.synthetic import make_local_ba_problem_numpy

F64 = torch.float64
NO_TABLES = dict(mg_it=None, mg_it_sid=None, mg_it_t=None, sg_it=None, sg_it_sid=None,
                 sg_it_t=None, lm_blk=None, lm_blk_g=None, lm_blk_valid=None, lm_edge=None,
                 lm_edge_valid=None)


@pytest.fixture(scope="module")
def pcg_problem():
    """tests/test_ba.py::test_pcg_single_solve_matches_dense_solve's problem,
    with the reference's linearization (the same for every preconditioner
    and tolerance) computed once."""
    jd, js, _ = jmake(n_kf=6, n_fixed=1, n_lm=48, obs_per_lm=3, noise_px=0.3, seed=7)
    p = jba.make_ba_problem_pcg(jd, jd.mg_valid, jd.sg_valid, jd.st_valid)
    return jd, jax.jit(p.linearize)(js), *convert.from_reference(jd, js)


STEPS = []       # the reference's CG step counts, appended at run time
_SOLVERS = {}    # one compiled reference solve per solver setting


def reference_solve(jd, jlin, lam, x0=None, **kw):
    """The reference PCG's (dx, dot_xx, dot_xb) and its CG steps. A cold
    start runs as x0 = 0 (the reference's residual b - S 0 is b exactly), so
    cold and warm starts share one compiled program."""
    key = tuple(sorted(kw.items()))
    if x0 is None:
        x0 = (jnp.zeros_like(jlin[3]), jnp.zeros_like(jlin[4]))
    args = (jlin, jnp.asarray(lam), x0)
    STEPS.clear()
    if key in _SOLVERS:
        out = _SOLVERS[key](*args)
    else:
        def record(fmt, **kv):
            jax.debug.callback(lambda it, rr: STEPS.append(int(it)), kv["it"], kv["rr"])

        # the first call traces with the step print on; later calls with
        # the same shapes reuse the compiled program
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jba, "_PCG_DEBUG", True)
            mp.setattr(jax.debug, "print", record)
            p = jba.make_ba_problem_pcg(jd, jd.mg_valid, jd.sg_valid, jd.st_valid, **kw)
            _SOLVERS[key] = jax.jit(lambda lin, lam_, x: p.solve(lin, lam_, x))
            out = _SOLVERS[key](*args)
    return jax.block_until_ready(out), STEPS[-1]


def port_solve(td, ts, lam, x0=None, **kw):
    p = tba.make_ba_problem_pcg(td, td.mg_valid, td.sg_valid, td.st_valid, **kw)
    return p.solve(p.linearize(ts), torch.tensor(lam, dtype=F64), x0)


@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
def test_single_solve_matches_reference(pcg_problem, precond):
    jd, jlin, td, ts = pcg_problem
    kw = dict(pcg_iters=400, pcg_tol=1e-16, precond=precond)
    (jdx, jxx, jxb), jsteps = reference_solve(jd, jlin, 1e-3, **kw)
    dx, xx, xb = port_solve(td, ts, 1e-3, **kw)
    assert dx.cg_steps == jsteps and 0 < jsteps < 400
    assert dx.rel_res <= 1e-16
    for a, b in zip(dx[:3], jdx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    np.testing.assert_allclose(float(xx), float(jxx), rtol=1e-6)
    np.testing.assert_allclose(float(xb), float(jxb), rtol=1e-6)


def test_warm_start_matches_reference(pcg_problem):
    """`x0` warm-starts CG from a given step: from the converged step it
    stops at once; from a perturbed one it takes the reference's steps."""
    jd, jlin, td, ts = pcg_problem
    kw = dict(pcg_iters=400, pcg_tol=1e-16, precond="jacobi")
    dx, _, _ = port_solve(td, ts, 1e-3, **kw)
    rng = np.random.RandomState(0)
    x12 = dx.dxp.numpy() + 1e-3 * rng.randn(*dx.dxp.shape)
    xe = dx.dxe.numpy()
    (jdx, _, _), jsteps = reference_solve(jd, jlin, 1e-3, (jnp.asarray(x12), jnp.asarray(xe)),
                                          **kw)
    warm, _, _ = port_solve(td, ts, 1e-3, (torch.tensor(x12), torch.tensor(xe)), **kw)
    assert warm.cg_steps == jsteps
    for a, b in zip(warm[:3], jdx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    np.testing.assert_allclose(warm.dxp.numpy(), dx.dxp.numpy(), atol=1e-7)
    again, _, _ = port_solve(td, ts, 1e-3, (warm.dxp, warm.dxe), pcg_iters=400, pcg_tol=1e-6)
    assert again.cg_steps == 0


def test_pcg_step_equals_dense_step(pcg_problem):
    _, _, td, ts = pcg_problem
    lvl = (td.mg_valid, td.sg_valid, td.st_valid)
    dense = tba.make_ba_problem(td, *lvl)
    (dxp, dxl), xx, _ = dense.solve(dense.linearize(ts), torch.tensor(1e-3, dtype=F64))
    dx, pxx, _ = port_solve(td, ts, 1e-3, pcg_iters=400, pcg_tol=1e-16)
    K = td.n_poses
    np.testing.assert_allclose(dx.dxp.numpy(), dxp[:12 * K].reshape(K, 12).numpy(), atol=1e-7)
    np.testing.assert_allclose(dx.dxl.numpy(), dxl.numpy(), atol=1e-7)
    np.testing.assert_allclose(float(pxx), float(xx), rtol=1e-6)


def test_global_ba_pcg_trajectory_matches_reference():
    """global_ba_pcg's chi2 after each LM iteration (one lm_optimize run
    split at every iteration) at the SMOKE size with mono-GP edges, without
    the interp and landmark tables (the per-edge fallback; the table path's
    solve is held above)."""
    jd, js, _ = jmake(n_kf=8, n_fixed=1, n_lm=64, n_cams=6, obs_per_lm=4, gpobs_per_lm=2,
                      noise_px=0.5, seed=0)
    jd = jd._replace(gp_huber=jnp.asarray(True), **NO_TABLES)
    jp = jba.make_ba_problem_pcg(jd, jd.mg_valid, jd.sg_valid, jd.st_valid)
    td, ts = convert.from_reference(jd, js)
    tp = tba.make_ba_problem_pcg(td, td.mg_valid, td.sg_valid, td.st_valid)
    seg = jax.jit(lambda c, n: jlm.lm_segment(jp, c, n, lambda_init=1e-5))
    jc = jax.jit(lambda s: jlm.lm_init(jp, s))(js)
    tc = tlm.lm_init(tp, ts)
    for it in range(1, 5):
        jc = seg(jc, it)
        tc = tlm.lm_segment(tp, tc, it, lambda_init=1e-5)
        assert tc.it == int(jc.it)
        assert abs(float(tc.chi) - float(jc.chi)) <= 1e-8 * abs(float(jc.chi)), it
    out, stats = tba.global_ba_pcg(td, ts, num_iterations=4)
    assert float(stats.chi2) == float(tc.chi)
    assert torch.equal(out.T, tc.state.T)


@pytest.fixture
def one_thread():
    """Run on one intra-op thread: the test's many small ops on 20k-row
    tensors otherwise spin on every core while other test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pcg_problem_allocates_nothing_of_size_p_squared(one_thread):
    """A problem whose dense reduced system could not be held (P = 12 *
    (K + Cx) = 240k columns: P^2 float64 = 461 GB): the PCG problem (with
    the dense problem's chi2) builds, linearizes and solves, and on the
    keyframes that carry edges its first 20 CG steps give the small
    problem's step (the extra keyframes are fixed and carry no edge)."""
    d, s, _ = make_local_ba_problem_numpy(n_kf=8, n_fixed=1, n_lm=64, n_cams=3, obs_per_lm=3,
                                          gpobs_per_lm=0, seed=0)
    d = {**d, **NO_TABLES}
    small, s0 = convert.ba_from_numpy(d, s)
    extra = 20_000
    K = small.n_poses
    big = small._replace(
        times=torch.cat([small.times, small.times[-1] + 1.0 + torch.arange(extra, dtype=F64)]),
        pose_fixed=torch.cat([small.pose_fixed, torch.ones(extra, dtype=torch.bool)]),
        vel_valid=torch.cat([small.vel_valid, torch.zeros(extra, dtype=torch.bool)]))
    eye = torch.eye(4, dtype=F64).expand(extra, 4, 4)
    s_big = s0._replace(T=torch.cat([s0.T, eye]), v=torch.cat([s0.v, torch.zeros(extra, 6,
                                                                                 dtype=F64)]))
    lam = torch.tensor(1e-3, dtype=F64)
    kw = dict(pcg_iters=20, pcg_tol=1e-16)
    p_big = tba.make_ba_problem_pcg(big, big.mg_valid, big.sg_valid, big.st_valid, **kw)
    p_small = tba.make_ba_problem_pcg(small, small.mg_valid, small.sg_valid, small.st_valid, **kw)
    assert float(p_big.chi2(s_big)) == pytest.approx(float(p_small.chi2(s0)), rel=1e-12)
    dx_big, _, _ = p_big.solve(p_big.linearize(s_big), lam)
    dx_small, _, _ = p_small.solve(p_small.linearize(s0), lam)
    assert dx_big.cg_steps == dx_small.cg_steps == 20
    assert not bool(dx_big.dxp[K:].any())
    np.testing.assert_allclose(dx_big.dxp[:K].numpy(), dx_small.dxp.numpy(), atol=1e-9)
    np.testing.assert_allclose(dx_big.dxl.numpy(), dx_small.dxl.numpy(), atol=1e-9)
