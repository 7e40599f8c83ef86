"""The slice end to end: the port's LM loop and `local_gp_ba` against the
JAX reference on the same problems (float64, CPU; the port runs its plain
GP chain).

  * lm_optimize on entry()'s problem: same iterations; chi2 and lambda to
    relative 1e-9;
  * a 4+3+3 segmented run equals the monolithic one bit for bit (as
    tests/test_abort_ba.py pins for the reference);
  * local_gp_ba with and without the extrinsic phase: same `ok` and erase
    masks, err_initial/err_final to relative 1e-9, final T, v, Text, X to
    1e-8 absolute;
  * the divergence guard on NaN observations (as tests/test_ba.py:102).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.solver import ba as jba
from amcslam_tpu.solver import lm as jlm
from amcslam_tpu_torch.solver import ba as tba
from amcslam_tpu_torch.solver import lm as tlm
from test_torch_ba import both_problems, entry_problem, rel, small_problem

# one compiled reference schedule per static configuration, shared by tests
JAX_LOCAL_GP_BA = jax.jit(jba.local_gp_ba, static_argnames=("b_extrinsic", "ext_min_obs"))


def test_lm_optimize_matches_reference_on_entry_problem():
    jd, js, _ = entry_problem()
    jp, tp, td, ts = both_problems(jd, js)
    jstate, jstats = jax.jit(lambda s: jlm.lm_optimize(jp, s, 10, lambda_init=1.0))(js)
    tstate, tstats = tlm.lm_optimize(tp, ts, 10, lambda_init=1.0)
    assert tstats.iterations == int(jstats.iterations)
    assert rel(tstats.initial_chi2, jstats.initial_chi2) <= 1e-12
    assert rel(tstats.chi2, jstats.chi2) <= 1e-9
    assert rel(tstats.lam, jstats.lam) <= 1e-9
    np.testing.assert_allclose(tstate.T.numpy(), np.asarray(jstate.T), atol=1e-8)


def test_lm_lambda_from_max_diag_matches_reference():
    """lambda_init <= 0: lambda_0 = tau * max|diag H| (g2o's default)."""
    jd, js, _ = small_problem(seed=1)
    jp, tp, td, ts = both_problems(jd, js)
    _, jstats = jax.jit(lambda s: jlm.lm_optimize(jp, s, 4))(js)
    _, tstats = tlm.lm_optimize(tp, ts, 4)
    assert tstats.iterations == int(jstats.iterations)
    assert rel(tstats.chi2, jstats.chi2) <= 1e-9
    assert rel(tstats.lam, jstats.lam) <= 1e-9


def test_segmented_lm_equals_monolithic_bit_for_bit():
    jd, js, _ = small_problem(seed=11, noise_px=0.5)
    _, tp, td, ts = both_problems(jd, js)
    mono = tlm.lm_segment(tp, tlm.lm_init(tp, ts), 10, lambda_init=1.0)
    carry = tlm.lm_init(tp, ts)
    for it_end in (4, 7, 10):
        carry = tlm.lm_segment(tp, carry, it_end, lambda_init=1.0)
    assert (carry.it, carry.nbad, carry.term) == (mono.it, mono.nbad, mono.term)
    for a, b in zip(carry.state, mono.state):
        assert torch.equal(a, b)
    for name in ("chi", "lam", "ni", "chi0"):
        assert torch.equal(getattr(carry, name), getattr(mono, name)), name


def assert_results_match(tres, jres):
    assert bool(tres.ok) == bool(jres.ok)
    assert rel(tres.err_initial, jres.err_initial) <= 1e-9
    assert rel(tres.err_final, jres.err_final) <= 1e-9
    for name in ("erase_m", "erase_sg", "erase_st"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    for name in ("T", "v", "Text", "X"):
        np.testing.assert_allclose(getattr(tres.state, name).numpy(),
                                   np.asarray(getattr(jres.state, name)),
                                   rtol=0, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("b_extrinsic", [False, True])
def test_local_gp_ba_matches_reference(b_extrinsic):
    jd, js, _ = small_problem(seed=4, noise_px=0.5, gpobs_per_lm=2)
    kw = dict(b_extrinsic=True, ext_min_obs=5) if b_extrinsic else {}
    if b_extrinsic:  # perturb one extrinsic so phase 2 has work to do
        Text = np.asarray(js.Text).copy()
        Text[0, :3, 3] += np.array([0.02, -0.015, 0.01])
        js = js._replace(Text=jnp.asarray(Text))
    jres = JAX_LOCAL_GP_BA(jd, js, **kw)
    _, _, td, ts = both_problems(jd, js)
    tres = tba.local_gp_ba(td, ts, **kw)
    assert bool(tres.ok) and float(tres.err_final) < float(tres.err_initial)
    assert_results_match(tres, jres)
    if b_extrinsic:
        assert not torch.equal(tres.state.Text[0], ts.Text[0])


def test_local_gp_ba_divergence_guard_nan():
    """NaN observations trip the guard: ok is False and the state is the
    initial one, bit for bit."""
    jd, js, _ = small_problem(seed=4, noise_px=0.5, gpobs_per_lm=2)
    jd = jd._replace(st_obs=jd.st_obs.at[0].set(jnp.full(3, jnp.nan)))
    jres = JAX_LOCAL_GP_BA(jd, js)
    _, _, td, ts = both_problems(jd, js)
    tres = tba.local_gp_ba(td, ts)
    assert not bool(tres.ok) and not bool(jres.ok)
    assert torch.isnan(tres.err_initial) and np.isnan(float(jres.err_initial))
    for a, b in zip(tres.state, ts):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tres.erase_st.numpy(), np.asarray(jres.erase_st))
