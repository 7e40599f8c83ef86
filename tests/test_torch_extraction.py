"""Map -> solver-problem extraction (pipeline/extraction.py) against the
reference on one map. The map is built by the port's System on the CPU;
`convert.atlas_from_reference` carries it into a second object graph for the
port, while the reference's extraction reads the original (it walks the map
by attribute). Both extract in float64: every LocalBAData / BAState /
PoseGPData / PoseState field is equal, exactly for ints and bools and to
1e-12 for floats, and so are the handles. One map is built with
produce_gp_obs=True, so the stereo-GP (sg_*) edges and the GPObs mono edges
are covered."""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcslam_tpu.pipeline.map_store as ref_map_store
from amcslam_tpu.pipeline import extraction as ref_extraction
from amcslam_tpu.pipeline.system import System as RefSystem
from amcslam_tpu.pipeline.tracking import TrackingConfig as RefTrackingConfig
from amcslam_tpu.utils.synthetic import make_sequence as ref_make_sequence

from amcslam_tpu_torch import convert
from amcslam_tpu_torch.pipeline import extraction
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.pipeline.tracking import TrackingConfig
from amcslam_tpu_torch.utils.synthetic import make_sequence

FLOAT_TOL = 1e-12
CFG = dict(max_frames_between_kf=3, ransac_min_match=15, kf_translation_th=0.25)


@pytest.fixture(scope="module", params=[False, True], ids=["kf_obs", "gp_obs"])
def built(request):
    old = os.environ.get("AMCSLAM_NO_BUCKET_PRESET")
    os.environ["AMCSLAM_NO_BUCKET_PRESET"] = "1"
    try:
        frames, rig, _, _ = make_sequence(n_frames=8, n_cams=3, n_lm=250, seed=1)
        sys_ = System(rig, TrackingConfig(**CFG, produce_gp_obs=request.param),
                      enable_loop_closing=False, device="cpu")
        for f in frames:
            sys_.track_multicamera(f)
    finally:
        if old is None:
            os.environ.pop("AMCSLAM_NO_BUCKET_PRESET", None)
        else:
            os.environ["AMCSLAM_NO_BUCKET_PRESET"] = old
    return sys_, frames, convert.atlas_from_reference(sys_.atlas)


def _compare(port_nt, ref_nt, what):
    got = convert.to_numpy(port_nt)
    for name in ref_nt._fields:
        want = ref_nt._asdict()[name]
        if want is None:
            assert got[name] is None, (what, name)
            continue
        want = np.asarray(want)
        g = got[name]
        assert g.shape == want.shape, (what, name, g.shape, want.shape)
        if want.dtype == bool:
            assert g.dtype == bool, (what, name)
            np.testing.assert_array_equal(g, want, err_msg=f"{what}.{name}")
        elif np.issubdtype(want.dtype, np.integer):
            assert g.dtype == np.int64, (what, name)
            np.testing.assert_array_equal(g, want, err_msg=f"{what}.{name}")
        else:
            assert g.dtype == np.float64, (what, name)
            np.testing.assert_allclose(g, want, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=f"{what}.{name}")


def _ids(xs):
    return [x.id for x in xs]


def _meta_key(meta):
    """An erase-target record by ids: keyframes and map points by id, a
    GPObs by (time, cam)."""
    return tuple(x.id if hasattr(x, "id") else (x.time, x.cam) if hasattr(x, "time") else x
                 for x in meta)


def test_carried_map_is_the_same_graph(built):
    sys_, _, atlas = built
    src, dst = sys_.atlas.active, atlas.active
    assert dst is not src and sorted(dst.keyframes) == sorted(src.keyframes)
    assert sorted(dst.map_points) == sorted(src.map_points)
    assert dst.origin_kf.id == src.origin_kf.id
    for kid, k in src.keyframes.items():
        c = dst.keyframes[kid]
        assert c is not k and c.kf_seq == k.kf_seq
        for name in ("prev_kf", "next_kf", "parent"):
            a, b = getattr(k, name), getattr(c, name)
            assert (a is None) == (b is None) and (a is None or (a.id == b.id and
                                                               b is dst.keyframes[a.id]))
        assert c.covisibility == k.covisibility
        np.testing.assert_array_equal(c.matches, k.matches)
        np.testing.assert_array_equal(c.Twb, k.Twb)
        assert c.Twb.dtype == k.Twb.dtype
    for pid, p in src.map_points.items():
        c = dst.map_points[pid]
        np.testing.assert_array_equal(c.position, p.position)
        assert sorted(c.observations) == sorted(p.observations)
        for kid in p.observations:
            np.testing.assert_array_equal(c.observations[kid], p.observations[kid])
        assert [(k, o.time, o.cam, o.ur) for k, o in c.gp_observations] == \
            [(k, o.time, o.cam, o.ur) for k, o in p.gp_observations]
        assert (c.first_kf_id, c.n_found, c.n_visible, c.min_dist, c.max_dist) == \
            (p.first_kf_id, p.n_found, p.n_visible, p.min_dist, p.max_dist)


def test_carry_a_reference_built_map():
    """A map of the reference's own classes (stereo initialization, no
    solver) carries over with its observations, links and counters."""
    ref_map_store._ids = itertools.count(20_000_000)
    frames, rig, _, _ = ref_make_sequence(n_frames=2, n_cams=3, n_lm=200, seed=2)
    old = os.environ.get("AMCSLAM_NO_BUCKET_PRESET")
    os.environ["AMCSLAM_NO_BUCKET_PRESET"] = "1"
    try:
        ref = RefSystem(rig, RefTrackingConfig(**CFG), enable_loop_closing=False)
        ref.track_multicamera(frames[0])
    finally:
        if old is None:
            os.environ.pop("AMCSLAM_NO_BUCKET_PRESET", None)
        else:
            os.environ["AMCSLAM_NO_BUCKET_PRESET"] = old
    m = ref.atlas.active
    kf0 = next(iter(m.keyframes.values()))
    kf1 = ref_map_store.KeyFrame(
        timestamp=0.1, cam_times=frames[1].cam_times, Twb=np.eye(4), velocity=np.zeros(6),
        keypoints=frames[1].keypoints, kp_octaves=frames[1].kp_octaves,
        descriptors=frames[1].descriptors)
    kf1.prev_kf, kf1.parent, kf0.next_kf = kf0, kf0, kf1
    m.add_keyframe(kf1)
    mp = next(iter(m.map_points.values()))
    mp.add_gp_observation(kf0.id, ref_map_store.GPObs(time=0.05, cam=0, uv=np.ones(2), ur=-1.0))
    carried = convert.atlas_from_reference(ref.atlas)
    cm = carried.active
    assert type(cm).__module__ == "amcslam_tpu_torch.pipeline.map_store"
    assert sorted(cm.keyframes) == sorted(m.keyframes)
    assert sorted(cm.map_points) == sorted(m.map_points)
    c1 = cm.keyframes[kf1.id]
    assert c1.prev_kf is cm.keyframes[kf0.id] and c1.parent is cm.keyframes[kf0.id]
    assert cm.keyframes[kf0.id].next_kf is c1 and c1.kf_seq == 1
    cmp = cm.map_points[mp.id]
    assert type(cmp.gp_observations[0][1]).__module__ == "amcslam_tpu_torch.pipeline.map_store"
    for pid, p in m.map_points.items():
        assert {k: list(v) for k, v in cm.map_points[pid].observations.items()} == \
            {k: list(v) for k, v in p.observations.items()}


def test_local_ba_fields_equal(built):
    sys_, _, atlas = built
    src, dst = sys_.atlas.active, atlas.active
    n_sg = n_gp_mg = 0
    for kid in sorted(src.keyframes):
        ref_extraction.reset_bucket_high_water()
        extraction.reset_bucket_high_water()
        rd, rs, rh = ref_extraction.extract_local_ba(
            src.keyframes[kid], src.map_points, sys_.rig, dtype=jnp.float64,
            kf_table=src.keyframes)
        pd, ps, ph = extraction.extract_local_ba(
            dst.keyframes[kid], dst.map_points, sys_.rig, device="cpu", dtype=torch.float64,
            kf_table=dst.keyframes)
        _compare(pd, rd, f"kf {kid} data")
        _compare(ps, rs, f"kf {kid} state")
        assert ph["n_opt"] == rh["n_opt"]
        assert _ids(ph["kfs"]) == _ids(rh["kfs"]) and _ids(ph["lms"]) == _ids(rh["lms"])
        for key in ("mg_refs", "st_refs", "sg_refs", "mg_meta", "st_meta", "sg_meta"):
            assert len(ph[key]) == len(rh[key]), key
        np.testing.assert_array_equal(ph["mg_refs"], np.array(rh["mg_refs"]).reshape(-1, 8))
        np.testing.assert_array_equal(ph["st_refs"], np.array(rh["st_refs"]).reshape(-1, 7))
        for key in ("mg_meta", "st_meta", "sg_meta"):
            assert [_meta_key(m) for m in ph[key]] == [_meta_key(m) for m in rh[key]], key
        n_sg += len(ph["sg_refs"])
        n_gp_mg += sum(m[0] == "gp" for m in ph["mg_meta"])
    if sys_.tracker.cfg.produce_gp_obs:
        assert n_sg > 0 and n_gp_mg > 0, (n_sg, n_gp_mg)


def test_global_ba_fields_equal(built):
    sys_, _, atlas = built
    ref_extraction.reset_bucket_high_water()
    extraction.reset_bucket_high_water()
    rd, rs, rh = ref_extraction.extract_global_ba(sys_.atlas.active, sys_.rig, dtype=jnp.float64)
    pd, ps, ph = extraction.extract_global_ba(atlas.active, sys_.rig, device="cpu",
                                              dtype=torch.float64)
    _compare(pd, rd, "global data")
    _compare(ps, rs, "global state")
    assert _ids(ph["kfs"]) == _ids(rh["kfs"])


@pytest.mark.parametrize("fix_prev", [False, True])
def test_pose_problem_fields_equal(built, fix_prev):
    sys_, frames, atlas = built
    for prev, frame in zip(frames[-3:-1], frames[-2:]):
        ref_extraction.reset_bucket_high_water()
        extraction.reset_bucket_high_water()
        rd, rs, rh = ref_extraction.extract_pose_problem(
            frame, prev, sys_.atlas.active.map_points, sys_.rig, fix_prev=fix_prev,
            dtype=jnp.float64)
        pd, ps, ph = extraction.extract_pose_problem(
            frame, prev, atlas.active.map_points, sys_.rig, fix_prev=fix_prev,
            device="cpu", dtype=torch.float64)
        _compare(pd, rd, "pose data")
        _compare(ps, rs, "pose state")
        assert pd.it_t.shape == (sys_.rig.n_cams,)  # U = n_cams rows
        assert int(pd.mg_it.max()) < sys_.rig.n_cams - 1
        for key in ("Nm", "Ns", "n_mg", "n_st"):
            assert ph[key] == rh[key], key
        np.testing.assert_array_equal(ph["mg_idx"], rh["mg_idx"])
        np.testing.assert_array_equal(ph["st_idx"], rh["st_idx"])


def test_serving_buckets_match_the_reference():
    assert extraction.SERVING_BUCKETS == ref_extraction.SERVING_BUCKETS
    for n in (1, 15, 16, 17, 300, 5000):
        for kw in (dict(), dict(minimum=64, factor=4), dict(minimum=4)):
            assert extraction._bucket(n, **kw) == ref_extraction._bucket(n, **kw)


def test_apply_local_ba_writes_back(built):
    """apply_local_ba writes the solve's poses, velocities and landmarks in
    the solve's dtype (float32 here, as the reference's host copies)."""
    sys_, _, atlas = built
    m = atlas.active
    kf = m.keyframes[max(m.keyframes)]
    extraction.reset_bucket_high_water()
    data, state, h = extraction.extract_local_ba(kf, m.map_points, sys_.rig, device="cpu",
                                                 kf_table=m.keyframes)
    moved = state._replace(T=state.T.clone(), X=state.X + 0.5)
    moved.T[:, 0, 3] += 1.0
    extraction.apply_local_ba(moved, h, m.map_points)
    for i in range(h["n_opt"]):
        np.testing.assert_array_equal(h["kfs"][i].Twb, moved.T[i].numpy())
        assert h["kfs"][i].Twb.dtype == np.float32
    for l, mp in enumerate(h["lms"]):  # noqa: E741
        np.testing.assert_array_equal(mp.position, moved.X[l].numpy())
