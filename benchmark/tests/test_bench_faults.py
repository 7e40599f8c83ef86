"""A run with the timed path broken underneath comes out not correct, for
each fault the cell can have; a sound run at the same size comes out
correct. The harness's look for a chip is skipped (the program runs on the
CPU at a size a test can hold); everything else is a run as the driver's.

Faults: a step that returns its state unchanged (with the chi2 it reported,
or with its start's, as a solve that took no step would); a local BA whose
answer is thrown away; a pose solve whose inlier flags are wrong; an answer altered where it is produced; for the
global BA of the `global_ba` kind (`map_fixture`), half of the observations
left out of the solve, its chi2 taken over the rest. The cell runs on one
chip, so no exchange between chips can be left out."""

import pytest
import torch

from benchmark import run
from benchmark.tests import map_fixture

SPEC = run.load_spec()


def small_limits(cell):
    """The cell's limits at a test's size: the keyframe step error is held at
    the cell's size only (a test drive's one or two keyframe steps, early in
    its map, read up to 4.4 mm against a limit set from full windows)."""
    limits = run.limits_of(cell)
    return {"numbers": {k: v for k, v in limits["numbers"].items() if k != "kf_step_err_mm"}}


def drive_run(seed=21):
    cell = run.cell_of(SPEC, "amv6_rig.kp_drive")
    mix = dict(run.mix_of(cell), n_frames=18, lm_per_frame=40, warm_frames=8)
    return run.run_cell(SPEC, cell, seed, 1e6, False, device="cpu", mix=mix,
                        limits=small_limits(cell), log=lambda **k: None)


def map_run(seed=22):
    return map_fixture.run_map(seed)


# ---------------------------------------------------------------- the drive

def pose_unchanged(monkeypatch):
    from amcslam_tpu_torch.pipeline import tracking

    real = tracking.pose_gp_optimize

    def solve(data, state, *args, **kw):
        _, lvl_m, lvl_s, stats = real(data, state, *args, **kw)
        return state, lvl_m, lvl_s, stats

    monkeypatch.setattr(tracking, "pose_gp_optimize", solve)


def local_ba_unchanged(monkeypatch):
    from amcslam_tpu_torch.pipeline import local_mapping

    real = local_mapping.local_gp_ba

    def solve(data, state, *args, **kw):
        return real(data, state, *args, **kw)._replace(state=state)

    monkeypatch.setattr(local_mapping, "local_gp_ba", solve)


def pose_inliers_dropped(monkeypatch):
    """A pose solve that flags every other inlier of its answer an outlier."""
    from amcslam_tpu_torch.pipeline import tracking

    real = tracking.pose_gp_optimize

    def solve(*args, **kw):
        state, lvl_m, lvl_s, stats = real(*args, **kw)
        keep = lambda f: f & (torch.arange(f.shape[0], device=f.device) % 2 == 0)  # noqa: E731
        return state, keep(lvl_m), keep(lvl_s), stats

    monkeypatch.setattr(tracking, "pose_gp_optimize", solve)


def local_ba_noop(monkeypatch):
    """A local BA that returns its input state and reports that state's own
    chi2, as a solve that took no step would."""
    from amcslam_tpu_torch.pipeline import local_mapping

    real = local_mapping.local_gp_ba

    def solve(data, state, *args, **kw):
        res = real(data, state, *args, **kw)
        return res._replace(state=state, err_final=res.err_initial)

    monkeypatch.setattr(local_mapping, "local_gp_ba", solve)


def local_ba_not_ok(monkeypatch):
    """A local BA whose divergence guard throws its answer away."""
    from amcslam_tpu_torch.pipeline import local_mapping

    real = local_mapping.local_gp_ba

    def solve(data, state, *args, **kw):
        res = real(data, state, *args, **kw)
        return res._replace(state=state, ok=res.ok & False)

    monkeypatch.setattr(local_mapping, "local_gp_ba", solve)


def pose_altered(monkeypatch):
    from amcslam_tpu_torch.pipeline import tracking

    real = tracking.pose_gp_optimize

    def solve(*args, **kw):
        state, lvl_m, lvl_s, stats = real(*args, **kw)
        T = state.T.clone()
        T[1, 0, 3] += 0.02   # the frame's pose, 2 cm off
        return state._replace(T=T), lvl_m, lvl_s, stats

    monkeypatch.setattr(tracking, "pose_gp_optimize", solve)


def test_a_sound_drive_is_correct():
    res = drive_run()
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [pose_unchanged, pose_inliers_dropped, local_ba_unchanged,
                                   local_ba_noop, local_ba_not_ok, pose_altered])
def test_a_broken_drive_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = drive_run()
    assert not res["correct"], res["checks"]


# ------------------------------------------ the global BA (map_fixture)

def gba_unchanged(monkeypatch):
    from amcslam_tpu_torch.solver import ba

    real = ba.global_ba_pcg

    def solve(data, state, n):
        _, stats = real(data, state, n)
        return state, stats._replace(chi2=stats.initial_chi2)

    monkeypatch.setattr(ba, "global_ba_pcg", solve)


def gba_half(monkeypatch):
    from amcslam_tpu_torch.solver import ba

    real = ba.global_ba_pcg

    def solve(data, state, n):
        half = lambda v: v & (torch.arange(v.shape[0]) % 2 == 0)  # noqa: E731
        return real(data._replace(mg_valid=half(data.mg_valid), st_valid=half(data.st_valid)),
                    state, n)

    monkeypatch.setattr(ba, "global_ba_pcg", solve)


def gba_altered(monkeypatch):
    from amcslam_tpu_torch.solver import ba

    real = ba.global_ba_pcg

    def solve(data, state, n):
        out, stats = real(data, state, n)
        X = out.X.clone()
        X[0, 2] += 1.0   # one landmark, 1 m off
        return out._replace(X=X), stats

    monkeypatch.setattr(ba, "global_ba_pcg", solve)


def test_a_sound_solve_is_correct():
    res = map_run()
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [gba_unchanged, gba_half, gba_altered])
def test_a_broken_solve_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = map_run()
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct():
    """The control (float32 products in TF32) at the test's size, on the CPU;
    on the card `test_bench_card.py` runs it."""
    res = map_fixture.run_map(23, control=True)
    assert not res["correct"], res["checks"]
