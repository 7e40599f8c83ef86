"""The JAX reference's three remaining end-to-end scenarios
(tests/test_e2e_scenarios.py) on the port, on the CPU, marked slow as the
reference marks them; the reference's parameters and assertions unchanged:

  * the figure-eight (:38-60): 160 frames over two circles that share a
    junction passed in the same direction; at least 2 sequential loop
    closures, ATE under 0.5 % of the path, at least 2 loop-edge records;
  * relocalization after a blackout (:90-125): the 90-frame circle with
    frames 66-71 black: OK -> RECENTLY_LOST -> MLPnP relocalization -> OK,
    post-recovery ATE under 1 %;
  * threaded tracking off the critical path (:157-200): the threaded
    median tracking time under 0.5x the sequential one, both ATEs under 2 %.

Each runs `amcslam_tpu_torch.examples.e2e_rendered.run(..., device="cpu")`
as the reference's test runs the reference. Then the figure-eight and the
blackout run are held against the reference's run of the same scenario,
both in the parity setup of tests/scenario_trace.py (one id counter start,
the bucket preset off, the port's native ORB build in both): the same
closures at the same frames, the same tracking state at every frame, the
same keyframe count, and the ATE to 1e-4 m (tests/test_torch_e2e_rendered.py's
float32 tolerance; the figure-eight's to ten times the port's own move
under another order of its CPU reductions, see WITNESS_FACTOR). The comparison prints both traces (results, states,
closures, the closer's candidates keyframe by keyframe; `-s` shows them), as
`python tests/scenario_trace.py <scenario>` does.

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=2 python -m pytest -m slow \
        tests/test_torch_e2e_scenarios.py -k "not threaded" -p xdist -n 4 -rA
    JAX_PLATFORMS=cpu OMP_NUM_THREADS=2 python -m pytest -m slow \
        tests/test_torch_e2e_scenarios.py -k threaded

The threaded pin compares two latencies, so it runs alone (beside four
busy workers of an 8-core host it failed at 0.78); even alone the port's
ratio sits near the bound, where the reference's is ~0.07 (ROADMAP §3).
"""

import numpy as np
import pytest
import torch

from scenario_trace import SCENARIOS, candidate_lines, summary, trace

from amcslam_tpu_torch.examples import e2e_rendered as e2e
from amcslam_tpu_torch.pipeline.tracking import TrackState
from amcslam_tpu_torch.utils.io import ate_rmse

POSE_TOL_M = 1e-4
# The figure-eight's far walls leave some map points weakly constrained:
# float32 rounding moves them by metres from frame 2 on, and the
# port against itself with another intra-op thread count (another order of
# its CPU reductions) parts as far as from the reference. Its ATE is held
# to ten times that run's own move (as chip_smoke.py's PAD_TOL_FACTOR and
# DRYRUN_WITNESS_FACTOR do), never below POSE_TOL_M.
WITNESS_FACTOR = 10.0


def run(name):
    collect = {}
    ate, dist, n_loops = e2e.run(**SCENARIOS[name], collect=collect, device="cpu")
    return ate, dist, n_loops, collect


# The reference fails this test's first assertion itself: its own CPU run of
# tests/test_e2e_scenarios.py:38-60 fires one closure (frame 71, t = 14.2 s
# on t = 0.4 s) and keeps one loop-edge record. On the second revisit
# (frames 140-159) the first lap's keyframes are covisible with the current
# ones (tracking already matches the first lap's map points), so the
# database query excludes them, and no other candidate reaches the Sim3
# solve's 20 matches. ROADMAP §3 lists it; the port's run equals the
# reference's in test_scenario_matches_the_reference.
REFERENCE_FIRES_ONE_CLOSURE = (
    "the reference's own run fires 1 closure and keeps 1 loop-edge record on the "
    "figure-eight (the second revisit's keyframes are covisible with the first lap's "
    "and excluded from the database query; ROADMAP §3)")


@pytest.mark.slow
@pytest.mark.xfail(strict=True, raises=AssertionError, reason=REFERENCE_FIRES_ONE_CLOSURE)
def test_figure_eight_fires_multiple_loop_closures():
    """One continuous run over a course that revisits two distinct regions
    (both circles of the eight pass the junction in the SAME direction):
    the keyframe database must fire >= 2 sequential closures and the final
    loop-consistent trajectory must hold <= 0.5% ATE."""
    ate, dist, n_loops, collect = run("eight")
    assert n_loops >= 2, f"expected >=2 sequential closures, got {n_loops}"
    assert np.isfinite(ate)
    assert ate < 0.005 * dist, (ate, dist)
    # prior closures' loop edges are re-added in later essential graphs
    # (Optimizer.cc:1540-1560): with >= 2 closures there must be >= 2
    # loop-edge records in the map
    m = collect["system"].atlas.active
    n_loop_edges = sum(len(k.loop_edges) for k in m.keyframes.values()) // 2
    assert n_loop_edges >= 2


@pytest.mark.slow
def test_relocalization_after_blackout():
    """Black frames mid-revisit: OK -> RECENTLY_LOST -> MLPnP reloc -> OK,
    with the post-recovery trajectory still loop-consistent."""
    # 1.5 laps: blackout shortly into lap 2, i.e. inside mapped territory,
    # so relocalization candidates exist when the images return
    ate, dist, n_loops, collect = run("blackout")
    states = collect["states"]
    assert all(s == TrackState.OK for s in states[30:66])
    lost_span = states[67:80]
    assert TrackState.RECENTLY_LOST in lost_span, lost_span
    # recovered and stayed OK to the end
    assert states[-1] == TrackState.OK
    k_rec = next(i for i in range(72, 90) if states[i] == TrackState.OK)
    assert all(s == TrackState.OK for s in states[k_rec:]), states[k_rec:]
    # post-recovery accuracy: compare recomposed estimates vs GT after the
    # recovery frame (lost frames are excluded from trajectory_poses)
    est_t, est_T = collect["est"]
    gt_t, gt_T = collect["gt"]
    t_rec = k_rec / 5.0
    sel = est_t >= t_rec
    gsel = gt_t >= t_rec
    ate_post, _ = ate_rmse(est_t[sel], est_T[sel], gt_t[gsel], gt_T[gsel])
    assert ate_post < 0.01 * dist, (ate_post, dist)


@pytest.mark.slow
def test_threaded_mapping_off_tracking_critical_path():
    """System(threaded=True): the background mapper/loop-closer (mbAbortBA
    force-stop, detached GBA) keeps per-frame tracking latency well below
    the sequential mode's, where local BA runs inline on the tracking
    thread. Both modes must produce a sane trajectory."""
    results = {}
    for threaded in (False, True):
        ate, dist, _, collect = run("threaded" if threaded else "threaded_sequential")
        states = collect["states"]
        if threaded:
            # how many frames dip to RECENTLY_LOST while the mapper shares
            # the interpreter with tracking is a scheduling matter; the
            # invariants are that tracking keeps recovering (OK near the
            # end) and the recomposed trajectory stays sane
            ok = sum(s == TrackState.OK for s in states[1:])
            assert ok >= 0.4 * (len(states) - 1), (ok, states)
            assert TrackState.OK in states[-5:], states[-5:]
        else:
            assert all(s == TrackState.OK for s in states[1:]), states
        assert ate < 0.02 * dist, (threaded, ate, dist)
        # the first 10 frames are dropped from the latency statistic
        lat = collect["timing"]["track_ms"][10:]
        results[threaded] = float(np.median(lat))
    print(f"threaded pin: median tracking ms from frame 10, {results}")
    # mapping+BA off the critical path: threaded median is far below the
    # sequential median that pays local BA inline
    assert results[True] < 0.5 * results[False], results


@pytest.mark.slow
@pytest.mark.parametrize("name", ["eight", "blackout"])
def test_scenario_matches_the_reference(name):
    ref = trace("ref", name)
    port = trace("port", name)
    # the trace of both runs (shown by -rA or -s): results, states, closures and
    # the closer's candidates keyframe by keyframe
    for pkg, r in (("ref", ref), ("port", port)):
        print(summary(pkg, name, r))
        print("\n".join(candidate_lines(r, 0)))
    mp = [(i, r["n_mp"], p["n_mp"]) for i, (r, p) in
          enumerate(zip(ref["per_frame"], port["per_frame"])) if r["n_mp"] != p["n_mp"]]
    print(f"{name}: map-point counts differ at {len(mp)} frames, first {mp[:1]}")
    assert len(port["states"]) == len(ref["states"]) == SCENARIOS[name]["n_frames"]
    assert [c["frame"] for c in port["closures"]] == [c["frame"] for c in ref["closures"]]
    assert [(c["t"], c["loop_t"]) for c in port["closures"]] == \
        [(c["t"], c["loop_t"]) for c in ref["closures"]]
    assert port["n_loops"] == ref["n_loops"] == len(ref["closures"])
    assert port["loop_edge_records"] == ref["loop_edge_records"]
    bad = [(i, r, p) for i, (r, p) in enumerate(zip(ref["states"], port["states"])) if r != p]
    assert not bad, bad
    assert port["n_kf"] == ref["n_kf"] and port["kf_times"] == ref["kf_times"]
    assert port["dist"] == ref["dist"]
    tol = POSE_TOL_M
    if name == "eight":
        threads = 1 if torch.get_num_threads() > 1 else 2
        witness = abs(trace("port", name, threads=threads)["ate"] - port["ate"])
        tol = max(POSE_TOL_M, WITNESS_FACTOR * witness)
        print(f"eight: the port's ATE moves {witness:.3e} m at {threads} intra-op threads")
    assert abs(port["ate"] - ref["ate"]) <= tol, (port["ate"], ref["ate"], tol)
