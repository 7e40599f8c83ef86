"""The port's abort-segmented BA schedules against the monolithic runs and the
JAX reference.

Problems and flags follow tests/test_abort_ba.py (the reference's
generator, 6 KF / 48 landmarks / 3 obs, float64, CPU, carried over with
`convert.from_reference`):

  * `local_gp_ba_interruptible` with no abort is bit-identical to the port's
    `local_gp_ba`, with and without the extrinsic phase, and
    `global_ba_interruptible` to `global_ba`;
  * an abort after the first segment stops where the reference's does: the
    same `aborted` flag and iteration count, the state and chi2 to 1e-9;
    the extrinsic phase is skipped;
  * `global_ba` (GP chain with and without Huber) matches the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.solver import ba as jba
from amcslam_tpu.utils.synthetic import make_local_ba_problem as jmake
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.solver import ba as tba
from test_torch_ba import rel
from test_torch_lm_slice import assert_results_match

J_GLOBAL_BA = jax.jit(jba.global_ba, static_argnums=(2,))


def problem(**kw):
    """tests/test_abort_ba.py::_problem: (reference data, state, port data,
    port state)."""
    kw.setdefault("n_kf", 6)
    kw.setdefault("n_fixed", 1)
    kw.setdefault("n_lm", 48)
    kw.setdefault("obs_per_lm", 3)
    kw.setdefault("seed", 11)
    kw.setdefault("noise_px", 0.5)
    jd, js, _ = jmake(**kw)
    td, ts = convert.from_reference(jd, js)
    return jd, js, td, ts


def assert_local_results_equal(a, b):
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    for name in ("ok", "err_initial", "err_final", "erase_m", "erase_sg", "erase_st"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("seg_iters", [1, 3, 4])
def test_segmented_local_ba_is_bit_identical(seg_iters):
    _, _, td, ts = problem()
    mono = tba.local_gp_ba(td, ts)
    calls = []
    seg, aborted = tba.local_gp_ba_interruptible(
        td, ts, seg_iters=seg_iters, should_abort=lambda: calls.append(1) and False)
    assert not aborted and len(calls) >= 1
    assert_local_results_equal(seg, mono)


def test_segmented_local_ba_extrinsic_is_bit_identical():
    _, _, td, ts = problem(seed=4)
    mono = tba.local_gp_ba(td, ts, b_extrinsic=True, ext_min_obs=5)
    seg, aborted = tba.local_gp_ba_interruptible(td, ts, b_extrinsic=True, ext_min_obs=5,
                                                 seg_iters=4)
    assert not aborted
    assert_local_results_equal(seg, mono)
    assert not torch.equal(seg.state.Text, ts.Text)  # the extrinsic phase ran


@pytest.mark.parametrize("b_extrinsic", [False, True])
def test_local_ba_abort_matches_reference(b_extrinsic):
    """should_abort fires at the first check: one segment, then stop; with
    b_extrinsic the extrinsic phase is skipped (bDoMore = false)."""
    jd, js, td, ts = problem(seed=9)
    kw = dict(b_extrinsic=b_extrinsic, ext_min_obs=5, seg_iters=2)
    jres, jab = jba.local_gp_ba_interruptible(jd, js, should_abort=lambda: True, **kw)
    calls = []
    tres, tab = tba.local_gp_ba_interruptible(
        td, ts, should_abort=lambda: calls.append(1) or True, **kw)
    assert tab and jab and len(calls) == 1
    assert_results_match(tres, jres)
    assert np.isfinite(float(tres.err_final)) and bool(torch.isfinite(tres.state.T).all())
    assert torch.equal(tres.state.Text, ts.Text)  # no extrinsic phase after an abort
    # the partial iterate is the first segment of the full schedule
    full = tba.local_gp_ba(td, ts)
    assert float(tres.err_final) > float(full.err_final)


def test_global_ba_abort_matches_reference():
    jd, js, td, ts = problem(seed=9)
    jstate, jstats, jab = jba.global_ba_interruptible(jd, js, 10, should_abort=lambda: True,
                                                      seg_iters=2)
    tstate, tstats, tab = tba.global_ba_interruptible(td, ts, 10, should_abort=lambda: True,
                                                      seg_iters=2)
    assert tab and jab
    assert tstats.iterations == int(jstats.iterations) <= 2
    assert rel(tstats.chi2, jstats.chi2) <= 1e-9
    assert float(tstats.chi2) <= float(tstats.initial_chi2)
    for name in ("T", "v", "Text", "X"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("gp_huber", [False, True])
def test_global_ba_matches_reference_and_segments_bit_identically(gp_huber):
    jd, js, td, ts = problem(seed=7)
    jd = jd._replace(gp_huber=jnp.asarray(gp_huber))
    td = td._replace(gp_huber=torch.tensor(gp_huber))
    jstate, jstats = J_GLOBAL_BA(jd, js, 10)
    tstate, tstats = tba.global_ba(td, ts, 10)
    assert tstats.iterations == int(jstats.iterations)
    assert rel(tstats.chi2, jstats.chi2) <= 1e-9
    assert rel(tstats.initial_chi2, jstats.initial_chi2) <= 1e-12
    for name in ("T", "v", "Text", "X"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    sstate, sstats, aborted = tba.global_ba_interruptible(td, ts, 10, seg_iters=3)
    assert not aborted and sstats.iterations == tstats.iterations
    assert torch.equal(sstats.chi2, tstats.chi2) and torch.equal(sstats.lam, tstats.lam)
    for a, b in zip(sstate, tstate):
        assert torch.equal(a, b)
