"""A map configuration for the CPU tests of the `global_ba` traffic kind and
of the BA references: `synthetic.map_problem`"s smooth drive under the
amv6_rig configuration"s rig, at a size a test holds. No cell of
BENCHMARK.json runs it: a map cell needs a configuration sized from a
public source (PERF.md, Open questions)."""

from benchmark import run

MAP = {
    "n_kf": 30, "n_fixed": 1, "n_lm": 300, "obs_per_lm": 4, "gpobs_per_lm": 2, "noise_px": 0.5,
    "kf_dt": 0.4, "frames_per_interval": 4, "stereo_frac": 0.7, "min_depth": 0.2,
    "gp_huber": True, "twist": [2.0, 0.15, -0.05, 0.01, -0.02, 0.15],
    "wiggle": [0.15, 0.075, 0.03, 0.015, 0.015, 0.045], "wiggle_rate": 0.4,
    "landmark_box_min": [-4.0, -2.5, 5.0], "landmark_box_max": [4.0, 2.5, 25.0],
    "drift_pose": [0.03, 0.03, 0.03, 0.005, 0.005, 0.005], "drift_vel": 0.05,
    "drift_landmark": 0.03, "qc_diag": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    "ext_prior_info": 10000.0,
}
SOLVER = {"num_iterations": 10, "dtype": "float32"}
MIX = {"kind": "global_ba", "warm_solves": 1, "trace_seconds": 5}
LIMITS = {"numbers": {"chi2_gap": {"limit": 3e-4}, "chi2_over_gt": {"limit": 6}}}
CELL = {"name": "map.gba_pcg", "config": "map", "traffic": "gba_pcg", "chips": 1}


def rig() -> dict:
    spec = run.load_spec()
    return run.config_of(spec, run.cell_of(spec, "amv6_rig.kp_drive"))["rig"]


def config(**sizes) -> dict:
    return {"solver": dict(SOLVER), "rig": rig(), "map": dict(MAP, **sizes)}


def run_map(seed: int, seconds: float = 1.0, control: bool = False, **sizes) -> dict:
    """One run of the map"s global BA solves on the CPU; returns the result."""
    return run.run_cell(run.load_spec(), CELL, seed, seconds, False, device="cpu",
                        control=control, config=config(**sizes), mix=MIX, limits=LIMITS,
                        log=lambda **k: None)
