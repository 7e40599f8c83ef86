"""The port's entry points (`entry`, `dryrun_multichip`) and profiling
scripts on the CPU.

  * `amcslam_tpu_torch.entry.entry()` against the reference's
    `__graft_entry__.entry()`: one LM iteration of the 8-KF window in
    float32, the new chi2 and poses to 1e-5;
  * `dryrun_multichip(2, device="cpu", backend="gloo")` against the same
    problems unsharded (float32, chi2 to 1e-5), and its printed line;
  * `examples/profile_orb_device.py` and `examples/profile_pcg.py` at cut
    sizes on the CPU, so the scripts cannot rot;
  * `profile_pcg.profile_warm_start` (the reference's `profile_pcg.py
    --warm`, :180-241) at a cut 5d (12 KF / 120 landmarks / 3 cameras) in
    float64: the cold and the warm chain of 12 LM iterations against the
    same chains run with the reference's `make_ba_problem_pcg`, chi2 per
    iteration to rtol 1e-8 (tests/test_torch_pcg_ba.py's trajectory
    tolerance);
  * with no device given every entry point asks for the card, and raises
    where there is none.
"""

import math

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import jax.numpy as jnp
from amcslam_tpu.solver import ba as jba
from amcslam_tpu.utils.synthetic import make_local_ba_problem as jmake
from amcslam_tpu_torch import entry
from amcslam_tpu_torch.examples import profile_orb_device, profile_pcg


def test_entry_step_matches_reference():
    jstep, (jstate0, jlam) = jentry.entry()
    jstate, jchi = jax.jit(jstep)(jstate0, jlam)
    step, (state0, lam) = entry.entry(device="cpu")
    assert state0.T.dtype == torch.float32 and lam.dtype == torch.float32
    np.testing.assert_array_equal(state0.T.numpy(), np.asarray(jstate0.T))
    state, chi = step(state0, lam)
    np.testing.assert_allclose(float(chi), float(jchi), rtol=1e-5)
    np.testing.assert_allclose(state.T.numpy(), np.asarray(jstate.T), atol=1e-5)
    assert math.isfinite(float(chi))


def test_dryrun_multichip_matches_single_device(capsys):
    chi, chi_eg = entry.dryrun_multichip(2, device="cpu", backend="gloo")
    want, want_eg = entry.dryrun_single_device(2, device="cpu")
    np.testing.assert_allclose(chi, want, rtol=1e-5)
    np.testing.assert_allclose(chi_eg, want_eg, rtol=1e-5)
    assert f"dryrun_multichip(2): ok, chi2={chi:.3f}" in capsys.readouterr().out


def test_profile_orb_device_runs_on_the_cpu():
    """~16 extractor passes of ~5,000 small ops each: on one intra-op thread,
    so that CPU workers running beside it do not stall every op's
    thread barrier."""
    imgs = np.random.default_rng(0).integers(0, 256, (2, 240, 320), dtype=np.uint8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = profile_orb_device.profile(imgs, n_features=300, device="cpu", n_timed=1)
    finally:
        torch.set_num_threads(threads)
    assert out["device"] == "cpu" and out["images"] == 2
    assert set(out["stages"]) == set(profile_orb_device.STAGES)
    for rec in [out["full"], *out["stages"].values()]:
        assert rec["cpu_ms"] > 0 and rec["launches"] is None and "device_ms" not in rec
    assert all(math.isfinite(s["share"]) for s in out["stages"].values())


def test_profile_pcg_runs_on_the_cpu():
    dev = torch.device("cpu")
    eg = profile_pcg.profile_eg(dev, config=dict(n_kf=60, n_loop=8, seed=0), tols=(1e-3,),
                                cap=20, split_caps=(2, 4), n_timed=1)
    (row,) = eg["by_tolerance"]
    assert 0 < row["cg_steps"] <= 20 and math.isfinite(row["chi2_after"])
    assert eg["cg_step_bound"]["bound_by"] in ("bytes", "operations")
    assert eg["cg_step_bound"]["bound_ms"] > 0 and math.isfinite(eg["ms_per_cg_step"])
    gba = profile_pcg.profile_global_ba(
        dev, config=dict(n_kf=12, n_fixed=1, n_lm=120, n_cams=3, obs_per_lm=4, gpobs_per_lm=0,
                         noise_px=0.5, seed=0),
        tols=(1e-3,), caps=(5,), split_caps=(2, 4), n_timed=1)
    assert [r["precond"] for r in gba["runs"]] == ["jacobi", "schur_jacobi"]
    assert all(0 < r["cg_steps"] <= 5 and math.isfinite(r["chi2_after"]) for r in gba["runs"])
    assert gba["cg_step_bound"]["bytes"] > 0 and math.isfinite(gba["fixed_ms"])


WARM_CUT_5D = dict(n_kf=12, n_fixed=1, n_lm=120, n_cams=3, obs_per_lm=4, gpobs_per_lm=0,
                   noise_px=0.5, seed=0)


def reference_chains(config, n_chain, cap, tol):
    """examples/profile_pcg.py:200-233 on `config` in float64: the cold
    chain (x0 = None) and the warm chain (x0 = the previous (dxp, dxe))."""
    data, state0, _ = jmake(**config, dtype=jnp.float64)
    data = data._replace(gp_huber=jnp.asarray(True))
    problem = jba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                      pcg_iters=cap, pcg_tol=tol)
    lam = jnp.asarray(profile_pcg.LAM_5D, jnp.float64)

    @jax.jit
    def cold_iter(state):
        dx, _, _ = problem.solve(problem.linearize(state), lam)
        s2 = problem.retract(state, dx)
        return s2, problem.chi2(s2)

    @jax.jit
    def warm_iter(state, x0):
        dx, _, _ = problem.solve(problem.linearize(state), lam, x0=x0)
        s2 = problem.retract(state, dx)
        return s2, problem.chi2(s2), (dx[0], dx[1])

    s, cold = state0, []
    for _ in range(n_chain):
        s, chi = cold_iter(s)
        cold.append(float(chi))
    s, warm = state0, []
    x0 = (jnp.zeros((int(data.n_poses), 12)), jnp.zeros((int(data.n_ext), 6)))
    for _ in range(n_chain):
        s, chi, x0 = warm_iter(s, x0)
        warm.append(float(chi))
    return cold, warm


def test_profile_pcg_warm_start_matches_reference():
    cap, tol = profile_pcg.WARM_CAP, profile_pcg.WARM_TOL
    out = profile_pcg.profile_warm_start(torch.device("cpu"), config=WARM_CUT_5D,
                                         dtype=torch.float64)
    cold, warm = reference_chains(WARM_CUT_5D, profile_pcg.WARM_CHAIN, cap, tol)
    assert (out["n_chain"], out["cap"], out["tol"]) == (12, 40, 1e-3)
    np.testing.assert_allclose(out["cold"]["chi2"], cold, rtol=1e-8)
    np.testing.assert_allclose(out["warm"]["chi2"], warm, rtol=1e-8)
    assert out["cold"]["chi2"] != out["warm"]["chi2"]
    for rec in (out["cold"], out["warm"]):
        assert len(rec["cg_steps"]) == 12 and all(0 < n <= cap for n in rec["cg_steps"])
        assert rec["ms_per_lm_iteration"] > 0
    want = abs(warm[-1] - cold[-1]) / abs(cold[-1])
    np.testing.assert_allclose(out["final_chi2_rel_diff"], want, rtol=1e-6, atol=1e-14)


def test_entry_points_ask_for_the_card():
    """With no device given the entry points run on the card, and raise on
    a machine without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_orb_device.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_pcg.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_pcg.main(["--warm"])
