"""The port's entry points (`entry`, `dryrun_multichip`) and profiling
scripts on the CPU.

  * `amcslam_tpu_torch.entry.entry()` against the reference's
    `__graft_entry__.entry()`: one LM iteration of the 8-KF window in
    float32, the new chi2 and poses to 1e-5;
  * `dryrun_multichip(2, device="cpu", backend="gloo")` against the same
    problems unsharded (float32, chi2 to 1e-5), and its printed line;
  * `examples/profile_orb_device.py` and `examples/profile_pcg.py` at cut
    sizes on the CPU, so the scripts cannot rot;
  * with no device given every entry point asks for the card, and raises
    where there is none.
"""

import math

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
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
