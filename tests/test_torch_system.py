"""The port's System (amcslam_tpu_torch.pipeline.system) against the
reference's, and the System's own behaviours on the port alone.

The whole-System comparison runs both packages once (a module fixture) on
make_sequence(n_frames=8, n_cams=3, n_lm=250, seed=1) with loop closing on
(both defaults; the sequence makes fewer than 12 keyframes, so each closer
only fills its keyframe database) and the reference's bucket presets off (AMCSLAM_NO_BUCKET_PRESET=1: the
reference then compiles small programs; its run is ~80 s of XLA compiles on
the CPU). Both pipelines run their solves in float32, the reference
pipeline's dtype. Per frame they must give the same tracking state, the same
keyframe count and timestamps and the same map-point count; poses agree to
1e-4 m / 1e-4 rad.

Keyframes, map points and frames take ids from one process-wide counter in
each package, and the map iterates sets of ids (set order depends on the id
values), so both runs start their counters at the same value.
"""

import itertools
import os
import sys
import time

import numpy as np
import pytest
import torch

import amcslam_tpu.pipeline.map_store as ref_map_store
from amcslam_tpu.pipeline import extraction as ref_extraction
from amcslam_tpu.pipeline.system import System as RefSystem
from amcslam_tpu.pipeline.tracking import TrackingConfig as RefTrackingConfig
from amcslam_tpu.utils import synthetic as ref_synthetic
from amcslam_tpu.utils.io import ate_rmse as ref_ate_rmse

import amcslam_tpu_torch.pipeline.map_store as port_map_store
from amcslam_tpu_torch.pipeline import extraction as port_extraction
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.pipeline.tracking import TrackingConfig, TrackState
from amcslam_tpu_torch.utils import synthetic as port_synthetic

SEQ = dict(n_frames=8, n_cams=3, n_lm=250, seed=1)
CFG = dict(max_frames_between_kf=3, ransac_min_match=15, kf_translation_th=0.25)
ID_START = 10_000_000
POSE_TOL_M = 1e-4
POSE_TOL_RAD = 1e-4


def _rot_angle(Ra, Rb):
    """Angle of Ra^T Rb by atan2(sin, cos): well conditioned near 0, where
    arccos of the trace is not (float32 poses are orthonormal to ~1e-7)."""
    R = Ra.T @ Rb
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


def _run(map_store, extraction, make_sequence, make_system, seq=SEQ, n=None):
    map_store._ids = itertools.count(ID_START)
    extraction.reset_bucket_high_water()
    frames, rig, Ts, _ = make_sequence(**seq)
    sys_ = make_system(rig)
    per_frame = []
    for f in frames[:n]:
        st = sys_.track_multicamera(f)
        m = sys_.atlas.active
        per_frame.append({
            "state": st.name,
            "kf_times": sorted(k.timestamp for k in m.keyframes.values()),
            "n_mp": m.n_map_points(),
            "Twb": np.array(f.Twb, np.float64),
        })
    return sys_, frames, Ts, per_frame


@pytest.fixture(scope="module")
def runs():
    old = os.environ.get("AMCSLAM_NO_BUCKET_PRESET")
    os.environ["AMCSLAM_NO_BUCKET_PRESET"] = "1"
    try:
        ref = _run(ref_map_store, ref_extraction, ref_synthetic.make_sequence,
                   lambda rig: RefSystem(rig, RefTrackingConfig(**CFG)))
        port = _run(port_map_store, port_extraction, port_synthetic.make_sequence,
                    lambda rig: System(rig, TrackingConfig(**CFG), device="cpu"))
    finally:
        if old is None:
            os.environ.pop("AMCSLAM_NO_BUCKET_PRESET", None)
        else:
            os.environ["AMCSLAM_NO_BUCKET_PRESET"] = old
    return {"ref": ref, "port": port}


def test_same_states_per_frame(runs):
    ref, port = runs["ref"][3], runs["port"][3]
    assert [r["state"] for r in port] == [r["state"] for r in ref]
    assert all(r["state"] == "OK" for r in port)


def test_same_keyframes_per_frame(runs):
    ref, port = runs["ref"][3], runs["port"][3]
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p["kf_times"] == r["kf_times"], i
    assert len(port[-1]["kf_times"]) >= 3


def test_same_map_point_counts_per_frame(runs):
    ref, port = runs["ref"][3], runs["port"][3]
    assert [p["n_mp"] for p in port] == [r["n_mp"] for r in ref]


def test_both_databases_hold_the_same_keyframes(runs):
    """Each closer filled its System's keyframe database with every
    keyframe (the 12-keyframe guard of LoopClosing.cc:212-217)."""
    ref_sys, port_sys = runs["ref"][0], runs["port"][0]
    port_ids = sorted(port_sys.kfdb.kfs)
    assert port_ids == sorted(ref_sys.kfdb.kfs)
    assert port_ids == sorted(port_sys.atlas.active.keyframes)
    assert port_sys.tracker.kfdb is port_sys.kfdb is port_sys.loop_closer.kfdb
    assert port_sys.loop_closer.loops_closed == ref_sys.loop_closer.loops_closed == 0


def test_poses_agree_per_frame(runs):
    ref, port = runs["ref"][3], runs["port"][3]
    for i, (r, p) in enumerate(zip(ref, port)):
        dt = np.abs(p["Twb"][:3, 3] - r["Twb"][:3, 3]).max()
        dr = _rot_angle(p["Twb"][:3, :3], r["Twb"][:3, :3])
        assert dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, (i, dt, dr)


def test_trajectories_and_ate_agree(runs):
    """The recomposed trajectories (trajectory_poses) agree, and so does
    their ATE against the ground truth (to 1e-4 m)."""
    ref_sys, _, Ts, _ = runs["ref"]
    port_sys, _, Ts_p, _ = runs["port"]
    np.testing.assert_array_equal(Ts_p, Ts)
    rt = ref_sys.tracker.trajectory_poses()
    pt = port_sys.tracker.trajectory_poses()
    assert [t for t, _ in pt] == [t for t, _ in rt]
    for (_, a), (_, b) in zip(pt, rt):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= POSE_TOL_M
    # the frames' own timestamps (k * 0.1): k / 10 differs in the last bit
    # for some k, and the nearest-timestamp association would shift by one
    gt_t = np.array([f.timestamp for f in runs["port"][1]])
    ate = [ref_ate_rmse(np.array([t for t, _ in tr]), np.stack([T for _, T in tr]), gt_t, Ts)[0]
           for tr in (pt, rt)]
    assert abs(ate[0] - ate[1]) <= POSE_TOL_M, ate


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_trajectory_savers(runs, tmp_path):
    """As tests/test_system.py:29-59 checks them on the reference."""
    sys_, frames, _, _ = runs["port"]
    traj_path = str(tmp_path / "traj.tum")
    sys_.save_trajectory_tum(traj_path)
    rows = np.loadtxt(traj_path)
    assert rows.shape == (len(frames), 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-6)

    kf_path = str(tmp_path / "kfs.tum")
    sys_.save_keyframe_trajectory_tum(kf_path)
    assert np.loadtxt(kf_path).shape == (sys_.atlas.active.n_keyframes(), 8)

    euroc_path = str(tmp_path / "traj.euroc")
    sys_.save_trajectory_euroc(euroc_path)
    erows = np.loadtxt(euroc_path)
    assert erows.shape == rows.shape
    np.testing.assert_allclose(erows[:, 0], rows[:, 0] * 1e9, rtol=1e-12)
    np.testing.assert_allclose(erows[:, 1:4], rows[:, 1:4], atol=1e-6)
    sys_.save_keyframe_trajectory_euroc(str(tmp_path / "kfs.euroc"))
    assert np.loadtxt(str(tmp_path / "kfs.euroc")).shape[1] == 8

    kitti_path = str(tmp_path / "traj.kitti")
    sys_.save_trajectory_kitti(kitti_path)
    krows = np.loadtxt(kitti_path)
    assert krows.shape == (len(frames), 12)
    kf0 = min(sys_.atlas.active.keyframes.values(), key=lambda k: k.id)
    M0 = krows[np.argmin(np.abs(rows[:, 0] - kf0.timestamp))].reshape(3, 4)
    np.testing.assert_allclose(M0[:, :3], np.eye(3), atol=1e-9)
    np.testing.assert_allclose(M0[:, 3], 0.0, atol=1e-9)


def test_atlas_round_trip_and_corrupt_checkpoint(runs, tmp_path):
    sys_, _, _, _ = runs["port"]
    atlas_path = str(tmp_path / "atlas.bin")
    sys_.save_atlas(atlas_path)
    m = sys_.atlas.active
    sys2 = System(sys_.rig, enable_loop_closing=False, device="cpu")
    sys2.load_atlas(atlas_path)
    m2 = sys2.atlas.active
    assert m2.n_keyframes() == m.n_keyframes()
    assert m2.n_map_points() == m.n_map_points()
    assert sorted(m2.keyframes) == sorted(m.keyframes)
    for kid, k in m.keyframes.items():
        np.testing.assert_array_equal(m2.keyframes[kid].Twb, k.Twb)
        np.testing.assert_array_equal(m2.keyframes[kid].matches, k.matches)
    assert sorted(sys2.kfdb.kfs) == sorted(m.keyframes)
    assert len(sys2.tracker.trajectory) == len(sys_.tracker.trajectory)

    blob = open(atlas_path, "rb").read()
    bad_path = str(tmp_path / "bad.bin")
    open(bad_path, "wb").write(blob[:-5] + bytes(5))
    with pytest.raises(Exception):
        sys2.load_atlas(bad_path)


def test_reset_active_map():
    """ResetActiveMap: a fresh map, and the next frame re-initializes."""
    frames, rig, _, _ = port_synthetic.make_sequence(n_frames=2, n_cams=3, n_lm=250, seed=1)
    sys_ = System(rig, TrackingConfig(**CFG), enable_loop_closing=False, device="cpu")
    assert sys_.track_multicamera(frames[0]) == TrackState.OK
    assert sys_.atlas.active.n_keyframes() == 1
    sys_.reset_active_map()
    assert sys_.atlas.active.n_keyframes() == 0
    assert len(sys_.atlas.maps) == 2
    assert sys_.local_mapper.map is sys_.atlas.active
    assert sys_.track_multicamera(frames[0]) == TrackState.OK  # stereo re-initialization
    assert sys_.atlas.active.n_keyframes() == 1


def test_system_runs_with_its_defaults():
    """System(rig, device=...) with every default: loop closing on, the
    closer sharing the System's database, device and dtype."""
    frames, rig, Ts, _ = port_synthetic.make_sequence(n_frames=4, n_cams=3, n_lm=250, seed=1)
    sys_ = System(rig, device="cpu")
    lc = sys_.loop_closer
    assert lc is not None and lc.kfdb is sys_.kfdb and sys_.local_mapper.loop_closer is lc
    assert lc.device == torch.device("cpu") and lc.dtype == torch.float32 and not lc.detached_gba
    states = [sys_.track_multicamera(f) for f in frames]
    assert all(st == TrackState.OK for st in states), states
    assert sorted(sys_.kfdb.kfs) == sorted(sys_.atlas.active.keyframes)
    assert np.linalg.norm(frames[-1].Twb[:3, 3] - Ts[-1][:3, 3]) < 0.05
    sys_.shutdown()


def midway(loop_closing=False):
    """The port's System after 6 of 10 frames of another sequence, with the
    four frames that follow (a fresh run per test: the System holds thread
    primitives and does not deep-copy)."""
    old = os.environ.get("AMCSLAM_NO_BUCKET_PRESET")
    os.environ["AMCSLAM_NO_BUCKET_PRESET"] = "1"
    try:
        sys_, frames, Ts, per_frame = _run(
            port_map_store, port_extraction, port_synthetic.make_sequence,
            lambda rig: System(rig, TrackingConfig(**CFG), enable_loop_closing=loop_closing,
                               device="cpu"),
            seq=dict(n_frames=10, n_cams=3, n_lm=300, seed=6), n=6)
    finally:
        if old is None:
            os.environ.pop("AMCSLAM_NO_BUCKET_PRESET", None)
        else:
            os.environ["AMCSLAM_NO_BUCKET_PRESET"] = old
    assert all(r["state"] == "OK" for r in per_frame)
    return sys_, frames, Ts


def test_localization_only_mode():
    """ActivateLocalizationMode: tracking continues against a frozen map."""
    sys_, frames, Ts = midway()
    m = sys_.atlas.active
    n_kf, n_mp = m.n_keyframes(), m.n_map_points()
    sys_.activate_localization_mode()
    for f in frames[6:]:
        assert sys_.track_multicamera(f) == TrackState.OK
    assert m.n_keyframes() == n_kf
    assert m.n_map_points() == n_mp
    assert np.linalg.norm(frames[-1].Twb[:3, 3] - Ts[-1][:3, 3]) < 0.5
    sys_.deactivate_localization_mode()
    assert not sys_.tracker.cfg.localization_only


def test_relocalization_recovers():
    """A tracker forced to RECENTLY_LOST with a wrong pose relocalizes on
    the next frame through the keyframe database and MLPnP RANSAC, and
    comes back OK near the ground truth."""
    sys_, frames, Ts = midway()
    tr = sys_.tracker
    for kf in sys_.atlas.active.keyframes.values():
        tr.kfdb.add(kf)
    wrong = np.eye(4)
    wrong[:3, 3] = [3.0, -2.0, 1.0]
    tr.last_frame.Twb = tr.last_frame.Twb @ wrong
    tr.velocity_model = np.zeros(6)
    tr.state = TrackState.RECENTLY_LOST
    f = frames[6]
    assert sys_.track_multicamera(f) == TrackState.OK
    assert tr.frames_since_reloc == 0
    assert np.linalg.norm(f.Twb[:3, 3] - Ts[6][:3, 3]) < 0.05
    assert _rot_angle(f.Twb[:3, :3], Ts[6][:3, :3]) < 0.01


def test_live_run_relocalizes_from_the_closers_database():
    """With loop closing on, the keyframe database is the one the closer
    filled during the run (nothing added by hand): a tracker forced to
    RECENTLY_LOST with a wrong pose relocalizes from it on the next frame."""
    sys_, frames, Ts = midway(loop_closing=True)
    tr = sys_.tracker
    assert tr.kfdb is sys_.loop_closer.kfdb
    assert sorted(tr.kfdb.kfs) == sorted(sys_.atlas.active.keyframes)
    wrong = np.eye(4)
    wrong[:3, 3] = [3.0, -2.0, 1.0]
    tr.last_frame.Twb = tr.last_frame.Twb @ wrong
    tr.velocity_model = np.zeros(6)
    tr.state = TrackState.RECENTLY_LOST
    f = frames[6]
    assert sys_.track_multicamera(f) == TrackState.OK
    assert tr.frames_since_reloc == 0
    assert np.linalg.norm(f.Twb[:3, 3] - Ts[6][:3, 3]) < 0.05
    assert _rot_angle(f.Twb[:3, :3], Ts[6][:3, :3]) < 0.01


def test_background_and_detached_ba_errors_reach_the_caller():
    """An exception in the background thread (here the loop closer's) or in
    the detached global BA is raised by the next track_multicamera and by
    shutdown."""
    frames, rig, _, _ = port_synthetic.make_sequence(n_frames=3, n_cams=3, n_lm=250, seed=2)
    sys_ = System(rig, TrackingConfig(**CFG), threaded=True, device="cpu")
    try:
        def failing():
            raise ValueError("closer failed")

        sys_.loop_closer.run_once = failing
        deadline = time.time() + 30
        while sys_._worker_error is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="mapper/loop closer failed") as info:
            sys_.track_multicamera(frames[0])
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        sys_._stop = True
        sys_._worker.join(timeout=30)
    assert not sys_._worker.is_alive()

    seq = System(rig, TrackingConfig(**CFG), device="cpu")
    assert seq.track_multicamera(frames[0]) == TrackState.OK
    seq.loop_closer.gba_error = ValueError("global BA failed")
    with pytest.raises(RuntimeError, match="detached global BA failed"):
        seq.track_multicamera(frames[1])
    with pytest.raises(RuntimeError, match="detached global BA failed"):
        seq.shutdown()


def test_threaded_schedule_keeps_the_map_consistent():
    """System(threaded=True): the background mapper serializes against
    tracking through the map mutex, per stage (as tests/test_system.py:141-181
    checks the reference). With a short thread switch interval, the run
    completes, tracks, and every registered observation still points at a
    keyframe slot that holds its map point."""
    frames, rig, _, _ = port_synthetic.make_sequence(n_frames=8, n_cams=3, n_lm=250, seed=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    sys_ = System(rig, TrackingConfig(**CFG), enable_loop_closing=False, threaded=True,
                  device="cpu")
    try:
        states = [sys_.track_multicamera(f) for f in frames]
        deadline = time.time() + 120
        while sys_.local_mapper.queue and time.time() < deadline:
            time.sleep(0.05)
        assert not sys_.local_mapper.queue
    finally:
        sys.setswitchinterval(old)
        sys_.shutdown()
    assert not sys_._worker.is_alive()
    assert states[-1] == TrackState.OK, states
    m = sys_.atlas.active
    assert m.n_keyframes() >= 2
    for mp in m.map_points.values():
        for kf_id, slots in mp.observations.items():
            kf = m.keyframes.get(kf_id)
            if kf is None:
                continue
            for g in slots:
                if g >= 0:
                    assert kf.matches[g] == mp.id or kf.matches[g] < 0

