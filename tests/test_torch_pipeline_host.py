"""The port's numpy copies of the reference's host modules, held against
the reference on the same seeded inputs: ops/host_geom (to 1e-14),
utils/synthetic.make_sequence (array for array, exactly), the keyframe
database (the same candidates), utils/io (ate_rmse to 1e-12, read_tum),
pipeline/rig, and utils/timing. host_geom is also held against the port's
batched torch Lie/GP functions in float64, as tests/test_lie.py holds the
reference's against its JAX kernels. The map's batched viewing-geometry
refresh (map_store.update_normals_and_depths) is held against the
reference's per-point MapPoint.update_normal_and_depth, and local mapping's
single refresh per stage against a refresh after every added observation."""

import copy

import numpy as np
import pytest
import torch

from amcslam_tpu.ops import host_geom as ref_hg
from amcslam_tpu.pipeline.keyframe_database import KeyFrameDatabase as RefKFDB
from amcslam_tpu.pipeline.map_store import KeyFrame as RefKeyFrame
from amcslam_tpu.pipeline.map_store import MapPoint as RefMapPoint
from amcslam_tpu.utils import io as ref_io
from amcslam_tpu.utils.synthetic import make_sequence as ref_make_sequence

from amcslam_tpu_torch.ops import gp, lie
from amcslam_tpu_torch.ops import host_geom as hg
from amcslam_tpu_torch.pipeline import local_mapping
from amcslam_tpu_torch.pipeline.keyframe_database import KeyFrameDatabase
from amcslam_tpu_torch.pipeline.map_store import KeyFrame, MapPoint, update_normals_and_depths
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.pipeline.tracking import TrackingConfig
from amcslam_tpu_torch.utils import io
from amcslam_tpu_torch.utils.synthetic import make_sequence
from amcslam_tpu_torch.utils.timing import StageTimer, Verbose, VerbosityLevel

HOST_TOL = 1e-14


def _xis(seed, n=12):
    """Twists at generic, tiny and near-pi angles."""
    rng = np.random.RandomState(seed)
    xis = []
    for i in range(n):
        xi = rng.randn(6) * (2.0 if i % 3 == 0 else 0.01 if i % 3 == 1 else 0.5)
        if i % 4 == 3:
            ax = rng.randn(3)
            xi[3:] = ax / np.linalg.norm(ax) * (np.pi - 1e-4)
        xis.append(xi)
    xis.append(np.zeros(6))
    return xis


@pytest.mark.parametrize("name", ["exp_se3", "left_jacobian_pose3_Q", "left_jacobian_pose3_inv",
                                  "right_jacobian_pose3_inv"])
def test_host_geom_se3_functions(name):
    for xi in _xis(0):
        np.testing.assert_allclose(getattr(hg, name)(xi), getattr(ref_hg, name)(xi),
                                   rtol=0, atol=HOST_TOL)


@pytest.mark.parametrize("name", ["hat3", "exp_so3", "left_jacobian_so3",
                                  "left_jacobian_so3_inv"])
def test_host_geom_so3_functions(name):
    for xi in _xis(1):
        np.testing.assert_allclose(getattr(hg, name)(xi[3:]), getattr(ref_hg, name)(xi[3:]),
                                   rtol=0, atol=HOST_TOL)


def test_host_geom_logs():
    for xi in _xis(2):
        T = ref_hg.exp_se3(xi)
        np.testing.assert_allclose(hg.log_se3(T), ref_hg.log_se3(T), rtol=0, atol=HOST_TOL)
        np.testing.assert_allclose(hg.log_so3(T[:3, :3]), ref_hg.log_so3(T[:3, :3]),
                                   rtol=0, atol=HOST_TOL)


def test_host_geom_gp_interp_pose():
    rng = np.random.RandomState(3)
    for _ in range(8):
        T1 = ref_hg.exp_se3(rng.randn(6) * 0.5)
        v1, v2 = rng.randn(6) * 0.5, rng.randn(6) * 0.5
        T2 = T1 @ ref_hg.exp_se3(v1 * 0.4 * 0.9)
        t = rng.uniform(0.0, 0.4)
        np.testing.assert_allclose(hg.gp_interp_pose(T1, v1, 0.0, T2, v2, 0.4, t),
                                   ref_hg.gp_interp_pose(T1, v1, 0.0, T2, v2, 0.4, t),
                                   rtol=0, atol=HOST_TOL)


def test_host_geom_matches_torch_lie_and_gp():
    """The host closed forms against the port's batched torch versions
    (float64): exp/log SE(3) and Jr^-1 to 1e-12 / 1e-9, GP interpolation to
    1e-9 (the bounds of tests/test_lie.py)."""
    f64 = dict(dtype=torch.float64)
    rng = np.random.RandomState(4)
    for i in range(10):
        xi = rng.randn(6) * (2.0 if i % 2 else 0.01)
        T = hg.exp_se3(xi)
        np.testing.assert_allclose(T, lie.exp_se3(torch.tensor(xi, **f64)).numpy(), atol=1e-12)
        np.testing.assert_allclose(hg.log_se3(T), lie.log_se3(torch.tensor(T, **f64)).numpy(),
                                   atol=1e-9)
        np.testing.assert_allclose(
            hg.right_jacobian_pose3_inv(xi),
            lie.right_jacobian_pose3_inv(torch.tensor(xi, **f64)).numpy(), atol=1e-9)
    eye = torch.eye(6, **f64)
    for _ in range(5):
        T1 = hg.exp_se3(rng.randn(6) * 0.5)
        v1, v2 = rng.randn(6) * 0.5, rng.randn(6) * 0.5
        T2 = T1 @ hg.exp_se3(v1 * 0.4 * 0.9)
        got = gp.query_pose(*(torch.tensor(a, **f64) for a in (T1, T2, v1, v2, 0.0, 0.4, 0.17)),
                            eye, eye)
        np.testing.assert_allclose(hg.gp_interp_pose(T1, v1, 0.0, T2, v2, 0.4, 0.17),
                                   got.numpy(), atol=1e-9)


@pytest.mark.parametrize("args", [dict(n_frames=6, n_cams=3, n_lm=200, seed=2),
                                  dict(n_frames=4, n_cams=2, n_lm=150, noise_px=0.5,
                                       stereo_depth_frac=0.6, seed=5)])
def test_make_sequence_equals_reference(args):
    frames, rig, Ts, (X, descs) = make_sequence(**args)
    rframes, rrig, rTs, (rX, rdescs) = ref_make_sequence(**args)
    np.testing.assert_array_equal(Ts, rTs)
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_array_equal(descs, rdescs)
    for name in ("Tbc", "K", "qc_diag", "ini_vel", "cam_time_offsets", "Rbc_ini",
                 "ext_prior_info", "level_sigma2", "inv_level_sigma2", "qc_inv_diag"):
        np.testing.assert_array_equal(getattr(rig, name), getattr(rrig, name))
    assert rig.bf == rrig.bf and rig.n_cams == rrig.n_cams
    np.testing.assert_array_equal(rig.qi_inv(0.1), rrig.qi_inv(0.1))
    assert len(frames) == len(rframes)
    for f, r in zip(frames, rframes):
        assert f.timestamp == r.timestamp
        np.testing.assert_array_equal(f.cam_times, r.cam_times)
        for c in range(rig.n_cams):
            np.testing.assert_array_equal(f.keypoints[c], r.keypoints[c])
            np.testing.assert_array_equal(f.kp_octaves[c], r.kp_octaves[c])
            np.testing.assert_array_equal(f.descriptors[c], r.descriptors[c])
        np.testing.assert_array_equal(f.kp_ur, r.kp_ur)
        np.testing.assert_array_equal(f.kp_depth, r.kp_depth)
        np.testing.assert_array_equal(f.kp_offsets, r.kp_offsets)
        assert f.keypoints[0].dtype == r.keypoints[0].dtype


def _keyframes(cls, frames, ids):
    return [cls(timestamp=f.timestamp, cam_times=f.cam_times, Twb=np.eye(4),
                velocity=np.zeros(6), keypoints=f.keypoints, kp_octaves=f.kp_octaves,
                descriptors=f.descriptors, id=i) for f, i in zip(frames, ids)]


def test_keyframe_database_same_candidates():
    """Both databases, filled with the same keyframes (same ids), return the
    same candidates for every query; covisibility groups included."""
    frames, _, _, _ = make_sequence(n_frames=10, n_cams=2, n_lm=200, seed=3)
    ids = list(range(500, 510))
    kfs, rkfs = _keyframes(KeyFrame, frames, ids), _keyframes(RefKeyFrame, frames, ids)
    for group in (kfs, rkfs):
        for a, b in zip(group[:-1], group[1:]):
            a.covisibility[b.id] = 20
            b.covisibility[a.id] = 20
    db, rdb = KeyFrameDatabase(), RefKFDB()
    for k, r in zip(kfs[:-1], rkfs[:-1]):
        db.add(k)
        rdb.add(r)
    np.testing.assert_array_equal(db.bit_idx, rdb.bit_idx)
    for k, r in zip(kfs, rkfs):
        np.testing.assert_array_equal(db._words(k), rdb._words(r))
        for n in (1, 3, 10):
            assert ([c.id for c in db.detect_n_best_candidates(k, n)]
                    == [c.id for c in rdb.detect_n_best_candidates(r, n)])
        assert ([c.id for c in db.detect_relocalization_candidates(k, 5)]
                == [c.id for c in rdb.detect_relocalization_candidates(r, 5)])
    db.erase(kfs[0])
    rdb.erase(rkfs[0])
    assert sorted(db.kf_words) == sorted(rdb.kf_words)
    assert ([c.id for c in db.detect_n_best_candidates(kfs[1], 3)]
            == [c.id for c in rdb.detect_n_best_candidates(rkfs[1], 3)])


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_equals_reference(align):
    rng = np.random.RandomState(7)
    gt_t = np.arange(40) * 0.1
    gt_T = np.stack([ref_hg.exp_se3(rng.randn(6) * 0.3) for _ in gt_t])
    est_t = gt_t[::2] + 1e-3
    est_T = np.stack([T @ ref_hg.exp_se3(rng.randn(6) * 0.01) for T in gt_T[::2]])
    got, err = io.ate_rmse(est_t, est_T, gt_t, gt_T, align=align)
    want, werr = ref_io.ate_rmse(est_t, est_T, gt_t, gt_T, align=align)
    assert abs(got - want) <= 1e-12
    np.testing.assert_allclose(err, werr, rtol=0, atol=1e-12)


def test_read_tum_equals_reference(tmp_path):
    rng = np.random.RandomState(8)
    path = tmp_path / "traj.tum"
    rows = np.concatenate([np.arange(5)[:, None] * 0.1, rng.randn(5, 3), rng.randn(5, 4)], 1)
    np.savetxt(path, rows)
    got, want = io.read_tum(str(path)), ref_io.read_tum(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_timing_and_verbose(capsys):
    t = StageTimer()
    with t.span("stage_a"):
        sum(range(1000))
    with t.span("stage_a"):
        sum(range(1000))
    s = t.stats()
    assert s["stage_a"]["n"] == 2 and s["stage_a"]["mean_ms"] >= 0
    Verbose.set_level(VerbosityLevel.QUIET)
    Verbose.print_mess("hidden", VerbosityLevel.NORMAL)
    Verbose.set_level(VerbosityLevel.NORMAL)
    Verbose.print_mess("shown", VerbosityLevel.NORMAL)
    Verbose.set_level(VerbosityLevel.QUIET)
    out = capsys.readouterr().out
    assert "shown" in out and "hidden" not in out


def _geometry_map(seed=11):
    """Keyframes of a make_sequence drive at their true poses, keypoint
    octaves drawn over the 8 levels, and map points at its landmarks, each
    observed in a few cameras of several keyframes; with the cases the
    per-point rules single out (returned by name)."""
    frames, rig, Ts, (X, _) = make_sequence(n_frames=8, n_cams=3, n_lm=300, seed=seed)
    rng = np.random.RandomState(seed)
    ids = list(range(700, 700 + len(frames)))
    kfs, rkfs = _keyframes(KeyFrame, frames, ids), _keyframes(RefKeyFrame, frames, ids)
    for kf, rkf, T in zip(kfs, rkfs, Ts):
        kf.Twb = rkf.Twb = T
        kf.kp_octaves = rkf.kp_octaves = [rng.randint(0, 8, len(k)) for k in kf.keypoints]
    table = {kf.id: kf for kf in kfs}
    rtable = {kf.id: kf for kf in rkfs}
    absent = 699  # observed by some points, in neither table
    C = rig.n_cams
    points = []
    for j in range(60):
        obs = {}
        for k in rng.choice(len(kfs), rng.randint(1, 6), replace=False):
            row = -np.ones(C, dtype=np.int64)
            for c in rng.choice(C, rng.randint(1, C + 1), replace=False):
                row[c] = kfs[k].kp_offsets[c] + rng.randint(len(kfs[k].keypoints[c]))
            obs[ids[k]] = row
        if j % 7 == 0:
            obs[absent] = np.array([0] + [-1] * (C - 1))
        points.append((X[j % len(X)] + rng.randn(3), obs, int(rng.choice(list(obs)))))
    row = -np.ones(C, dtype=np.int64)
    row[1] = kfs[2].kp_offsets[1]
    first_absent = (X[1], {absent: np.array([0] + [-1] * (C - 1)), ids[2]: row.copy(),
                           ids[5]: row.copy()}, absent)
    first_unseen = (X[2], {ids[3]: row.copy(), ids[4]: row.copy()}, ids[6])
    empty_first_row = (X[3], {ids[1]: -np.ones(C, dtype=np.int64), ids[4]: row.copy()}, ids[1])
    only_absent = (X[4], {absent: row.copy()}, absent)
    no_obs = (X[5], {}, ids[0])
    Ow = (Ts[3] @ rig.Tbc[0])[:3, 3]  # a point on a camera center: one direction dropped
    on_center = (Ow, {ids[3]: np.array([5, kfs[3].kp_offsets[1] + 2] + [-1] * (C - 2)),
                      ids[6]: row.copy()}, ids[3])
    bad = (X[6], {ids[2]: row.copy()}, ids[2])
    cases = dict(first_absent=first_absent, first_unseen=first_unseen,
                 empty_first_row=empty_first_row, only_absent=only_absent, no_obs=no_obs,
                 on_center=on_center, bad=bad)
    names = [None] * len(points) + list(cases)
    points += list(cases.values())

    def make(cls):
        out = []
        for pos, obs, first in points:
            mp = cls(position=np.array(pos, np.float64), first_kf_id=first,
                     observations={k: v.copy() for k, v in obs.items()})
            mp.normal, mp.min_dist, mp.max_dist = np.full(3, 7.0), -1.0, -2.0
            out.append(mp)
        out[names.index("bad")].bad = True
        return out

    return rig, table, rtable, make(MapPoint), make(RefMapPoint), names


@pytest.mark.parametrize("how", ["batch", "one_point"])
def test_batched_refresh_equals_the_reference_per_point(how):
    """Normal, min_dist and max_dist of every point to 1e-12 relative of the
    reference's MapPoint.update_normal_and_depth, octaves 0-7; the points the
    rules leave alone are left exactly as they were."""
    rig, table, rtable, pts, rpts, names = _geometry_map()
    args = (rig.Tbc, rig.scale_factor, rig.n_levels)
    if how == "batch":
        update_normals_and_depths(pts, table, *args)
    else:
        for mp in pts:
            mp.update_normal_and_depth(table, *args)
    for mp, rmp, name in zip(pts, rpts, names):
        if name != "bad":  # the port skips a bad point; the reference does not check
            RefMapPoint.update_normal_and_depth(rmp, rtable, *args)
        else:
            rmp.normal, rmp.min_dist, rmp.max_dist = np.full(3, 7.0), -1.0, -2.0
        assert np.linalg.norm(mp.normal - rmp.normal) <= 1e-12 * np.linalg.norm(rmp.normal), name
        assert mp.min_dist == pytest.approx(rmp.min_dist, rel=1e-12, abs=0), name
        assert mp.max_dist == pytest.approx(rmp.max_dist, rel=1e-12, abs=0), name
    by = dict(zip(names, pts))
    for name in ("only_absent", "no_obs", "bad"):  # unchanged: no direction to average
        assert (by[name].normal == 7.0).all() and by[name].min_dist == -1.0, name
    # the reference row is all -1: a normal, but the range stays
    assert (by["empty_first_row"].normal != 7.0).all() and by["empty_first_row"].min_dist == -1.0
    for name in ("first_absent", "first_unseen", "on_center"):
        assert by[name].max_dist > 0 and (by[name].normal != 7.0).any(), name
    assert by["on_center"].min_dist == 0.0  # its reference slot sits on the center
    levels = np.concatenate([o for kf in table.values() for o in kf.kp_octaves])
    assert set(levels.tolist()) == set(range(8))


def _mapping_snapshot():
    """The map as local mapping receives the second keyframe it fuses, on a
    short make_sequence drive: (map, keyframe, rig), deep copies."""
    snaps = []
    fuse = local_mapping.LocalMapping.fuse_neighbors

    def keep(self, kf):
        snaps.append(copy.deepcopy((self.map, kf, self.rig)))
        return fuse(self, kf)

    frames, rig, _, _ = make_sequence(n_frames=8, n_cams=3, n_lm=250, seed=1)
    system = System(rig, TrackingConfig(max_frames_between_kf=3, ransac_min_match=15,
                                        kf_translation_th=0.25),
                    device="cpu", enable_loop_closing=False)
    local_mapping.LocalMapping.fuse_neighbors = keep
    try:
        for f in frames:
            system.track_multicamera(f)
            if len(snaps) > 1:
                return snaps[1]
    finally:
        local_mapping.LocalMapping.fuse_neighbors = fuse
    raise AssertionError("the drive fused fewer than two keyframes")


def _map_state(map_):
    """Every point's position, viewing geometry and observations, and every
    keyframe's matches, as plain values."""
    return ({i: (mp.position.tolist(), mp.normal.tolist(), mp.min_dist, mp.max_dist,
                 [(k, v.tolist()) for k, v in mp.observations.items()])
             for i, mp in map_.map_points.items()},
            {i: kf.matches.tolist() for i, kf in map_.keyframes.items()})


def test_one_refresh_per_stage_equals_a_refresh_per_observation(monkeypatch):
    """fuse_neighbors then the local BA's write-back, on copies of one map:
    as the code runs them (one batched refresh at the end of each stage), and
    with the refresh after every added observation and the write-back's
    point-by-point loop restored. Every point and keyframe is the same after
    each stage."""
    snap = _mapping_snapshot()
    runs = []
    for old in (False, True):
        map_, kf, rig = copy.deepcopy(snap)
        mapper = local_mapping.LocalMapping(rig, map_, device="cpu")
        args = (map_.keyframes, rig.Tbc, rig.scale_factor, rig.n_levels)
        n_obs = sum(mp.n_obs() for mp in map_.map_points.values())
        n_mp = len(map_.map_points)
        if old:
            add = MapPoint.add_observation

            def add_and_refresh(self, kf_, cam, g):
                add(self, kf_, cam, g)
                self.update_normal_and_depth(*args)

            monkeypatch.setattr(MapPoint, "add_observation", add_and_refresh)
            monkeypatch.setattr(local_mapping, "update_normals_and_depths",
                                lambda *a, **k: None)
        mapper.fuse_neighbors(kf)
        monkeypatch.undo()
        assert len(map_.map_points) < n_mp  # fuse merged points
        assert sum(mp.n_obs() for mp in map_.map_points.values()) > n_obs  # and added some
        fused = _map_state(map_)
        if old:
            def point_by_point(points, *a):
                for mp in points:
                    if not mp.bad:
                        mp.update_normal_and_depth(*a)

            monkeypatch.setattr(local_mapping, "update_normals_and_depths", point_by_point)
        mapper.local_ba(kf)
        monkeypatch.undo()
        runs.append((fused, _map_state(map_)))
    (fused, adjusted), (old_fused, old_adjusted) = runs
    assert fused == old_fused
    assert adjusted == old_adjusted
    assert adjusted != fused  # the BA moved points and refreshed them
