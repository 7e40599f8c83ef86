"""Parity of the port's local GP-BA problem with the JAX reference.

Problems are built by the reference's generator
(`amcslam_tpu.utils.synthetic.make_local_ba_problem`, float64, CPU) at the
sizes of `__graft_entry__.entry()` (8 KF / 128 landmarks / 3 obs) and
`tests/test_ba.py::small_problem` (6 KF / 48 landmarks) and carried into
the port with `amcslam_tpu_torch.convert.from_reference`. The reference's
closures run jitted on the CPU; the port's run eagerly on the CPU (plain
GP chain). Tolerances:

  * host-side tables / generator arrays: exact;
  * linearize (Hpp, bp, Wt, Hll, bl): rtol 1e-9 / atol 1e-12, as the
    reference's own test_gather_tables_match_segment_sum_fallback — the
    sums are ordered differently (`index_add_` vs one-hot contractions);
  * solve: dx rtol 1e-7 / atol 1e-9 (as tests/test_ba.py:64);
  * chi2: relative 1e-12.
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
from amcslam_tpu_torch.utils.synthetic import make_local_ba_problem as tmake

F64 = torch.float64
LIN_NAMES = ("Hpp", "bp", "Wt", "Hll", "bl")


def entry_problem():
    """The problem of __graft_entry__.entry(), in float64."""
    return jmake(n_kf=8, n_fixed=1, n_lm=128, obs_per_lm=3, seed=0)


def small_problem(**kw):
    """tests/test_ba.py::small_problem."""
    kw.setdefault("n_kf", 6)
    kw.setdefault("n_fixed", 1)
    kw.setdefault("n_lm", 48)
    kw.setdefault("obs_per_lm", 3)
    kw.setdefault("seed", 0)
    return jmake(**kw)


def both_problems(jdata, jstate, **kw):
    """(reference LMProblem, port LMProblem, port data, port state)."""
    lvl = (jdata.mg_valid, jdata.sg_valid, jdata.st_valid)
    jp = jba.make_ba_problem(jdata, *lvl, **kw)
    tdata, tstate = convert.from_reference(jdata, jstate)
    tkw = dict(kw)
    if "ext_active" in kw:
        tkw["ext_active"] = torch.tensor(np.asarray(kw["ext_active"]))
    tp = tba.make_ba_problem(tdata, tdata.mg_valid, tdata.sg_valid, tdata.st_valid, **tkw)
    return jp, tp, tdata, tstate


def rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def assert_lin_close(tlin, jlin):
    for a, b, name in zip(tlin, jlin, LIN_NAMES):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def assert_field_equal(got, ref, name):
    if ref is None:
        assert got is None, name
        return
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.dtype == bool:
        assert got.dtype == bool, name
    elif np.issubdtype(ref.dtype, np.integer):
        assert got.dtype == np.int64, name
    np.testing.assert_array_equal(got, ref, err_msg=name)


# ---------------------------------------------------------------------------
# host-side tables and generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared_times", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_generator_arrays_equal_reference(seed, shared_times):
    kw = dict(n_kf=6, n_fixed=1, n_lm=48, n_cams=4, obs_per_lm=3,
              gpobs_per_lm=2, seed=seed, shared_times=shared_times)
    jd, js, jg = jmake(**kw)
    td, ts, tg = tmake(**kw)
    assert td._fields == jd._fields
    for name in jd._fields:
        assert_field_equal(getattr(td, name), getattr(jd, name), name)
    for name in js._fields:
        assert_field_equal(getattr(ts, name), getattr(js, name), "state0." + name)
        assert_field_equal(getattr(tg, name), getattr(jg, name), "gt." + name)


def test_generator_float32_casts_like_reference():
    jd, js, _ = jmake(n_kf=5, n_fixed=1, n_lm=32, seed=1, dtype=jnp.float32)
    td, ts, _ = tmake(n_kf=5, n_fixed=1, n_lm=32, seed=1, dtype=torch.float32)
    for name in ("times", "mg_obs", "mg_it_t", "gp_qi_inv", "Tbc_stereo"):
        assert getattr(td, name).dtype == torch.float32
        assert_field_equal(getattr(td, name), getattr(jd, name), name)
    assert_field_equal(ts.T, js.T, "T")


def test_host_tables_equal_reference_with_padding_and_invalid_edges():
    rng = np.random.RandomState(5)
    E, K, Cx, L = 40, 7, 3, 20
    i = rng.randint(0, K - 1, E)
    pairs = np.stack([i, i + 1], 1)
    cams = rng.randint(0, Cx + 1, E)  # includes the stereo row cam == Cx
    valid = rng.rand(E) > 0.2
    t = np.round(rng.rand(E) * 4, 1)
    for c in (cams, None):
        for pad in (None, 32):
            got = tba.make_structure_ids(pairs, c, valid, K, Cx, pad_to=pad)
            ref = jba.make_structure_ids(pairs, c, valid, K, Cx, pad_to=pad)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    sid, _ = tba.make_structure_ids(pairs, cams, valid, K, Cx)
    for pad in (None, 64):
        for g, r in zip(tba.build_interp_tables(sid, t, valid, pad_to=pad),
                        jba.build_interp_tables(sid, t, valid, pad_to=pad)):
            np.testing.assert_array_equal(g, r)
    lm = rng.randint(0, L, E)
    st_pose = rng.randint(0, K, 30)
    st_lm = rng.randint(0, L, 30)
    st_valid = rng.rand(30) > 0.1
    args = (lm, pairs, cams, valid, lm[:10], pairs[:10], valid[:10],
            st_lm, st_pose, st_valid, L, K, Cx)
    for pads in ({}, {"pad_d": 32, "pad_de": 16}):
        for g, r in zip(tba.make_landmark_tables(*args, **pads),
                        jba.make_landmark_tables(*args, **pads)):
            np.testing.assert_array_equal(g, r)


def test_missing_tables_raise():
    """Data without the landmark gather tables, or without the interp-combo
    tables, no longer raises: the port runs the reference's segment-sum and
    per-edge fallbacks and matches the reference's linearize, solve and
    chi2 on the same problem (tests/test_torch_ba_fallback.py holds them on
    more problems)."""
    jd, js, _ = small_problem()
    for strip in (dict(lm_blk=None, lm_blk_g=None, lm_blk_valid=None, lm_edge=None,
                       lm_edge_valid=None),
                  dict(mg_it=None, mg_it_sid=None, mg_it_t=None)):
        jp, tp, td, ts = both_problems(jd._replace(**strip), js)
        jlin = jax.jit(jp.linearize)(js)
        tlin = tp.linearize(ts)
        assert_lin_close(tlin, jlin)
        (jdxp, _), _, _ = jax.jit(jp.solve)(jlin, jnp.asarray(1.0))
        (dxp, _), _, _ = tp.solve(tlin, torch.tensor(1.0, dtype=F64))
        np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), rtol=1e-7, atol=1e-9)
        assert rel(tp.chi2(ts), jax.jit(jp.chi2)(js)) <= 1e-12


# ---------------------------------------------------------------------------
# linearize / solve / chi2 / retract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["entry", "small"])
def test_linearize_solve_chi2_match_reference(which):
    jd, js, _ = entry_problem() if which == "entry" else small_problem(seed=5)
    jp, tp, td, ts = both_problems(jd, js)
    jlin = jax.jit(jp.linearize)(js)
    tlin = tp.linearize(ts)
    assert_lin_close(tlin, jlin)
    assert rel(tp.max_abs_diag(tlin), jax.jit(jp.max_abs_diag)(jlin)) <= 1e-12

    lam = 0.37
    (jdxp, jdxl), jxx, jxb = jax.jit(jp.solve)(jlin, jnp.asarray(lam))
    (dxp, dxl), xx, xb = tp.solve(tlin, torch.tensor(lam, dtype=F64))
    np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(dxl.numpy(), np.asarray(jdxl), rtol=1e-7, atol=1e-9)
    assert rel(xx, jxx) <= 1e-8 and rel(xb, jxb) <= 1e-8

    assert rel(tp.chi2(ts), jax.jit(jp.chi2)(js)) <= 1e-12
    jnew = jax.jit(jp.retract)(js, (jdxp, jdxl))
    tnew = tp.retract(ts, (dxp, dxl))
    for name in ("T", "v", "Text", "X"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                   rtol=1e-7, atol=1e-9, err_msg=name)
    assert rel(tp.chi2(tnew), jax.jit(jp.chi2)(jnew)) <= 1e-9


def test_extrinsic_phase_problem_matches_reference():
    """ext_active unfixes extrinsic vertices (phase 2): their 6 active
    columns enter Hpp, the phantom columns stay identity rows."""
    jd, js, _ = small_problem(seed=4, gpobs_per_lm=2)
    ext_active = jnp.asarray([True, False])
    jp, tp, td, ts = both_problems(jd, js, ext_active=ext_active)
    jlin = jax.jit(jp.linearize)(js)
    tlin = tp.linearize(ts)
    assert_lin_close(tlin, jlin)
    K = jd.n_poses
    assert np.abs(tlin[0][12 * K:12 * K + 6].numpy()).max() > 0
    (jdxp, _), _, _ = jax.jit(jp.solve)(jlin, jnp.asarray(1.0))
    (dxp, _), _, _ = tp.solve(tlin, torch.tensor(1.0, dtype=F64))
    np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), rtol=1e-7, atol=1e-9)


def with_stereo_gp_edges(jd, n_sg=24, seed=0):
    """Add hand-built stereo-GP edges (the generator emits none) with the
    reference's own table functions: make_structure_ids(cams=None) and
    build_interp_tables. The last two edges are invalid (dump structure)."""
    rng = np.random.RandomState(seed)
    pairs = np.asarray(jd.mg_pair)[:n_sg]
    lm = np.asarray(jd.mg_lm)[:n_sg]
    t = np.asarray(jd.mg_t)[:n_sg]
    obs2 = np.asarray(jd.mg_obs)[:n_sg] + rng.randn(n_sg, 2)
    obs = np.concatenate([obs2, obs2[:, :1] - rng.uniform(2, 6, (n_sg, 1))], 1)
    valid = np.ones(n_sg, bool)
    valid[-2:] = False
    sid, sid_cols = jba.make_structure_ids(pairs, None, valid, jd.n_poses, jd.n_ext)
    it, it_sid, it_t = jba.build_interp_tables(sid, t, valid)
    d2 = jd._replace(
        sg_pair=jnp.asarray(pairs, jnp.int32), sg_lm=jnp.asarray(lm, jnp.int32),
        sg_t=jnp.asarray(t), sg_obs=jnp.asarray(obs), sg_w=jnp.ones(n_sg),
        sg_valid=jnp.asarray(valid), sg_sid=jnp.asarray(sid),
        sg_sid_cols=jnp.asarray(sid_cols), sg_it=jnp.asarray(it),
        sg_it_sid=jnp.asarray(it_sid), sg_it_t=jnp.asarray(it_t),
    )
    return jba.with_landmark_tables(d2, int(jd.lm_blk.shape[0]))


def test_stereo_gp_edges_match_reference():
    jd, js, _ = small_problem(seed=6)
    jd = with_stereo_gp_edges(jd)
    jp, tp, td, ts = both_problems(jd, js)
    assert td.sg_obs.shape[0] == 24 and bool(td.sg_valid.any())
    jlin = jax.jit(jp.linearize)(js)
    tlin = tp.linearize(ts)
    assert_lin_close(tlin, jlin)
    assert rel(tp.chi2(ts), jax.jit(jp.chi2)(js)) <= 1e-12
    (jdxp, _), _, _ = jax.jit(jp.solve)(jlin, jnp.asarray(1.0))
    (dxp, _), _, _ = tp.solve(tlin, torch.tensor(1.0, dtype=F64))
    np.testing.assert_allclose(dxp.numpy(), np.asarray(jdxp), rtol=1e-7, atol=1e-9)
    # the finalize pass flags stereo-GP outliers like the reference
    jres = jax.jit(lambda s: jba._lba_finalize(jd, s, s, jp.chi2(s), jnp.asarray(False)))(js)
    tres = tba._lba_finalize(td, ts, ts, tp.chi2(ts), False)
    np.testing.assert_array_equal(tres.erase_sg.numpy(), np.asarray(jres.erase_sg))


def corrupted(problem, col, value, is_jax):
    """The problem with Hpp[col, col] overwritten: a reduced system that is
    not positive definite until lambda outgrows |value|."""
    def lin(s):
        Hpp, *rest = problem.linearize(s)
        if is_jax:
            Hpp = Hpp.at[col, col].set(value)
        else:
            Hpp = Hpp.clone()
            Hpp[col, col] = value
        return (Hpp, *rest)

    return problem._replace(linearize=lin)


def test_non_pd_cholesky_gives_nan_trial_rejected_and_lambda_grows():
    """torch.linalg.cholesky raises on a non-PD matrix where the reference's
    cho_factor returns NaN; the port uses cholesky_ex and turns a failed
    factorization into a NaN dx, so the LM loop rejects the trial and
    raises lambda exactly as the reference does."""
    jd, js, _ = small_problem(seed=8)
    jp, tp, td, ts = both_problems(jd, js)
    col = 12 * int(np.argmin(np.asarray(jd.pose_fixed)))
    jbad = corrupted(jp, col, -1e4, True)
    tbad = corrupted(tp, col, -1e4, False)

    (dxp, dxl), xx, xb = tbad.solve(tbad.linearize(ts), torch.tensor(1.0, dtype=F64))
    (jdxp, _), jxx, _ = jax.jit(jbad.solve)(jax.jit(jbad.linearize)(js), jnp.asarray(1.0))
    assert torch.isnan(dxp).all() and torch.isnan(dxl).all() and torch.isnan(xx)
    assert np.isnan(np.asarray(jdxp)).all() and np.isnan(float(jxx))

    # a NaN rho ends the trial loop: one rejected trial, lambda *= nu (= 2),
    # state and chi2 kept, and the iteration counts towards the Raul stop
    carry = tlm.lm_segment(tbad, tlm.lm_init(tbad, ts), 1, lambda_init=1.0)
    assert float(carry.lam) == 2.0 and float(carry.ni) == 4.0 and carry.nbad == 1
    assert float(carry.chi) == float(carry.chi0)
    assert torch.equal(carry.state.T, ts.T) and torch.equal(carry.state.X, ts.X)
    clean = tlm.lm_segment(tp, tlm.lm_init(tp, ts), 1, lambda_init=1.0)
    assert float(clean.lam) < 1.0 and float(clean.chi) < float(clean.chi0)

    # lambda keeps growing (2 -> 8 -> 64) until three bad iterations stop
    # the run, in the reference as in the port
    jstate, jstats = jax.jit(lambda s: jlm.lm_optimize(jbad, s, 10, lambda_init=1.0))(js)
    tstate, tstats = tlm.lm_optimize(tbad, ts, 10, lambda_init=1.0)
    assert tstats.iterations == int(jstats.iterations) == 3
    assert float(tstats.lam) == float(jstats.lam) == 64.0
    assert rel(tstats.chi2, jstats.chi2) <= 1e-12


def test_convert_round_trip_keeps_every_field():
    jd, js, _ = small_problem(seed=2)
    td, ts = convert.from_reference(jd, js, dtype=torch.float32)
    assert td.mg_obs.dtype == torch.float32 and td.mg_lm.dtype == torch.int64
    back = convert.to_numpy(td)
    for name in jd._fields:
        ref = getattr(jd, name)
        if ref is None:
            assert back[name] is None
        elif np.asarray(ref).dtype.kind == "f":
            np.testing.assert_array_equal(back[name], np.asarray(ref).astype(np.float32))
        else:
            np.testing.assert_array_equal(back[name], np.asarray(ref))
    for name, a in convert.to_numpy(ts).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(js, name)).astype(np.float32))
