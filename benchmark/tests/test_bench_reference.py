"""The plain references on answers known beforehand."""

import numpy as np
import pytest

from benchmark import run
from benchmark.reference import ba_cost, ba_opt, drive, lie
from benchmark.tests import map_fixture
from benchmark.traffic import synthetic

SPEC = run.load_spec()
MAP_CFG = map_fixture.config()
DRIVE_CELL = run.cell_of(SPEC, "amv6_rig.kp_drive")


def rig():
    Tbc, K, bf, _ = synthetic.rig_arrays(MAP_CFG["rig"])
    mp = MAP_CFG["map"]
    return {"Tbc": Tbc, "K": K, "bf": bf, "qc": mp["qc_diag"], "ext_info": mp["ext_prior_info"]}


def small_map(noise, **kw):
    mp = dict(MAP_CFG["map"], n_kf=16, n_lm=160, noise_px=noise, **kw)
    return synthetic.map_problem(MAP_CFG["rig"], mp, 11), mp


def truth(p):
    return {"T": p["gt_T"], "v": p["gt_v"], "Text": rig()["Tbc"][:-1], "X": p["gt_X"]}


def test_the_ground_truth_of_a_noiseless_constant_twist_map_costs_nothing():
    p, mp = small_map(0.0, wiggle=[0.0] * 6)
    parts = ba_cost.parts(p, rig(), truth(p), mp["gp_huber"])
    vz = parts.pop("velocity_prior")
    assert max(parts.values()) < 1e-12, parts
    assert vz == pytest.approx(15 * MAP_CFG["map"]["twist"][2] ** 2)  # 15 free keyframes
    # with the drawn twist varying between keyframes, the GP's interpolated
    # poses and its prior part from the truth
    p, mp = small_map(0.0)
    parts = ba_cost.parts(p, rig(), truth(p), mp["gp_huber"])
    assert parts["gp_prior"] > 0.0 and parts["stereo"] < 1e-12


def test_pixel_noise_costs_about_its_variance_per_row():
    p, mp = small_map(0.5)
    parts = ba_cost.parts(p, rig(), truth(p), mp["gp_huber"])
    rows = 2 * len(p["mg_lm"]) + 2 * len(p["st_lm"]) + int(np.sum(p["st_is_stereo"]))
    assert parts["mono_gp"] + parts["stereo"] == pytest.approx(0.25 * rows, rel=0.15)


def test_the_drifted_start_costs_more_than_the_truth():
    p, mp = small_map(0.5)
    start = {"T": p["T0"], "v": p["v0"], "Text": rig()["Tbc"][:-1], "X": p["X0"]}
    assert ba_cost.cost(p, rig(), start, True) > 5 * ba_cost.cost(p, rig(), truth(p), True)


def test_gp_interpolation_meets_its_keyframes_and_follows_a_constant_twist():
    T1 = lie.exp_se3(np.array([0.3, -0.2, 0.1, 0.05, -0.02, 0.1]))
    v = np.array([2.0, 0.1, 0.0, 0.0, 0.0, 0.3])
    T2 = T1 @ lie.exp_se3(0.4 * v)
    one = lambda a: a[None]  # noqa: E731
    for t, want in ((0.0, T1), (0.4, T2), (0.1, T1 @ lie.exp_se3(0.1 * v))):
        got = ba_cost.gp_pose(one(T1), one(v), np.array([0.0]), one(T2), one(v), np.array([0.4]),
                          np.array([t]))[0]
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_huber_is_quadratic_inside_and_linear_outside():
    assert ba_cost.huber(4.0, 5.991) == 4.0
    d = np.sqrt(5.991)
    assert ba_cost.huber(100.0, 5.991) == pytest.approx(2 * d * 10.0 - 5.991)


def test_the_truth_scores_zero_against_itself():
    mix = dict(run.mix_of(DRIVE_CELL), n_frames=10)
    d = synthetic.keypoint_drive(MAP_CFG["rig"], mix, 4)
    frames = [(k, "OK", d["poses"][k]) for k in range(3, 10)]
    kfs = []
    for k in (3, 6, 9):
        ids = np.concatenate(d["frames"][k]["landmark_ids"])
        kfs.append((k, d["poses"][k], [d["descriptors"][i] for i in ids],
                    [d["landmarks"][i] for i in ids]))
    out = {"frames": frames, "keyframes": kfs, "loops": [(9, 3)],
           "trajectory": (d["times"], d["poses"])}
    n = drive.compare(d, out, loop_radius_m=5.0)
    for key in ("frames_not_ok", "step_err_mm", "step_err_mrad", "kf_step_err_mm",
                "point_err_pct", "wrong_matches", "false_loops", "ate_m"):
        assert n[key] == pytest.approx(0.0, abs=1e-9), key
    # a wrong association, a far loop and a bent pose each show
    kfs[1][2][0] = d["descriptors"][np.concatenate(d["frames"][6]["landmark_ids"])[1]]
    frames[4] = (frames[4][0], "LOST", frames[4][2] @ lie.exp_se3(np.r_[0.01, 0, 0, 0, 0, 0]))
    out = dict(out, frames=frames, loops=[(0, 9)])
    n = drive.compare(d, out, loop_radius_m=0.5)
    assert n["wrong_matches"] == 1 and n["false_loops"] == 1 and n["frames_not_ok"] == 1
    assert n["step_err_mm"] > 1.0


def test_gauss_newton_predicts_its_decrease_and_reaches_the_optimum():
    p, mp = small_map(0.5)
    s = {"T": p["T0"], "v": p["v0"], "Text": rig()["Tbc"][:-1], "X": p["X0"]}
    assert ba_opt.optimality_gap(p, rig(), s, True) > 0.1   # the drifted start
    gaps = []
    for _ in range(5):
        decrease, total, after = ba_opt.gauss_newton(p, rig(), s, True)
        gaps.append(decrease / total)
        if decrease / total < 1e-3:   # near the optimum the model is the cost
            assert total - ba_cost.cost(p, rig(), after, True) == pytest.approx(
                decrease, rel=1e-3, abs=1e-9)
        s = after
    assert gaps[-1] < 1e-12 and gaps[-1] < gaps[0] * 1e-9, gaps
