"""Parity of the port's loop closing (amcslam_tpu_torch.pipeline.loop_closing)
with the JAX reference's, float64 on the CPU.

  * `utils/synthetic.build_loop_map` builds the reference test's drifted
    loop (tests/test_loop_closing.py::build_loop_map) array for array, with
    the same ids;
  * both closers detect and correct that loop from the same map (a module
    fixture runs each package once with and once without the global BA):
    the same loop keyframe, S12 to 1e-9, every keyframe pose to 1e-8 and
    every map point to 1e-8 m after `correct_loop`, the same fused count and
    the same map-point ids. The reference extracts its global BA in float32
    whatever the dtype of its other solves (`extract_global_ba`'s default);
    the port's closer runs every solve in its one dtype, so the reference
    runs here with its global BA extracted in float64. The reference's
    known fault is kept (ROADMAP §3): the essential graph of a first
    closure starts at chi2 0 and moves nothing (pinned below);
  * the two-revolution incremental run of
    tests/test_loop_closing.py::_run_incremental (two sequential closures,
    the first loop edge re-added in the second essential graph) closes the
    same loops with the same poses;
  * `matcher.search_by_sim3` on the densification case of
    tests/test_loop_closing.py::test_search_by_sim3_densification;
  * the two detached-global-BA cases of tests/test_abort_ba.py:159-217 on
    the port, and an exception in the detached BA reaching the caller.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amcslam_tpu.pipeline.extraction as ref_extraction
import amcslam_tpu.pipeline.map_store as ref_ms
from amcslam_tpu.pipeline import matcher as ref_matcher
from amcslam_tpu.pipeline.keyframe_database import KeyFrameDatabase as RefKFDB
from amcslam_tpu.pipeline.loop_closing import LoopClosing as RefLoopClosing
from amcslam_tpu.pipeline.rig import Rig as RefRig
from amcslam_tpu.utils.synthetic import _np_exp_se3 as ref_exp, make_rig as ref_make_rig

import amcslam_tpu_torch.pipeline.map_store as port_ms
from amcslam_tpu_torch.pipeline import matcher as port_matcher
from amcslam_tpu_torch.pipeline.keyframe_database import KeyFrameDatabase
from amcslam_tpu_torch.pipeline.loop_closing import LoopClosing
from amcslam_tpu_torch.pipeline.rig import Rig
from amcslam_tpu_torch.solver import ba as tba
from amcslam_tpu_torch.solver import sim3_opt as tso
from amcslam_tpu_torch.utils import synthetic as tsyn
from amcslam_tpu_torch.utils.synthetic import _np_exp_se3, make_rig
from test_loop_closing import build_loop_map as ref_build_loop_map

ID_START = 30_000_000
POSE_TOL = 1e-8


def port_closer(rig, m, db, **kw):
    return LoopClosing(rig, m, db, device="cpu", dtype=torch.float64, **kw)


def rot_angle(Ra, Rb):
    R = Ra.T @ Rb
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


def assert_poses_close(kfs_a, kfs_b, tol=POSE_TOL):
    for a, b in zip(kfs_a, kfs_b):
        assert a.id == b.id
        assert np.abs(a.Twb[:3, 3] - b.Twb[:3, 3]).max() <= tol, a.id
        assert rot_angle(a.Twb[:3, :3], b.Twb[:3, :3]) <= tol, a.id


# ---------------------------------------------------------------------------
# one drifted loop, closed by each package
# ---------------------------------------------------------------------------


def close_once(pkg: str, run_gba: bool):
    """build_loop_map(), the closer of `pkg` with the reference test's
    settings, the database filled with every keyframe but the last, one
    detection and one correction. Records what the comparison reads."""
    if pkg == "ref":
        ref_ms._ids = itertools.count(ID_START)
        m, rig, kfs, gt = ref_build_loop_map()
        lc = RefLoopClosing(rig, m, RefKFDB(), fix_scale=True, min_matches=15,
                            consistency_needed=1, run_global_ba=run_gba)
    else:
        port_ms._ids = itertools.count(ID_START)
        m, rig, kfs, gt = tsyn.build_loop_map()
        lc = port_closer(rig, m, KeyFrameDatabase(), fix_scale=True, min_matches=15,
                         consistency_needed=1, run_global_ba=run_gba)
    for k in kfs[:-1]:
        lc.kfdb.add(k)
    fused, eg_poses = [], []
    fuse, eg = lc._search_and_fuse, lc._essential_graph

    def counting_fuse(*a):
        fused.append(fuse(*a))
        return fused[-1]

    def recording_eg(*a):
        eg_poses.append([k.Twb.copy() for k in kfs])
        eg(*a)
        eg_poses.append([k.Twb.copy() for k in kfs])

    lc._search_and_fuse, lc._essential_graph = counting_fuse, recording_eg
    err_before = np.linalg.norm(kfs[-1].Twb[:3, 3] - gt[-1][:3, 3])
    loop_kf, S12 = lc.detect_common_regions(kfs[-1])
    lc.correct_loop(kfs[-1], loop_kf, S12)
    return {"m": m, "kfs": kfs, "gt": gt, "lc": lc, "loop_kf": loop_kf.id,
            "S12": tuple(np.asarray(x, np.float64) for x in S12), "fused": fused,
            "eg_poses": eg_poses, "err_before": err_before}


@pytest.fixture(scope="module")
def ref_gba_f64():
    """The reference's global BA extracted in float64 (its closer imports
    `extract_global_ba` at call time)."""
    mp = pytest.MonkeyPatch()
    real = ref_extraction.extract_global_ba
    mp.setattr(ref_extraction, "extract_global_ba",
               lambda m, rig, dtype=jnp.float64: real(m, rig, dtype=dtype))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def closures(ref_gba_f64):
    return {(pkg, gba): close_once(pkg, gba) for gba in (False, True) for pkg in ("ref", "port")}


def test_build_loop_map_equals_reference():
    ref_ms._ids = itertools.count(ID_START)
    rm, rrig, rkfs, rgt = ref_build_loop_map(n_kf=10, n_lm=60, n_local=15, seed=2)
    port_ms._ids = itertools.count(ID_START)
    pm, prig, pkfs, pgt = tsyn.build_loop_map(n_kf=10, n_lm=60, n_local=15, seed=2)
    np.testing.assert_array_equal(np.stack(pgt), np.stack(rgt))
    for name in ("Tbc", "K"):
        np.testing.assert_array_equal(getattr(prig, name), getattr(rrig, name))
    assert prig.bf == rrig.bf
    assert [k.id for k in pkfs] == [k.id for k in rkfs]
    for p, r in zip(pkfs, rkfs):
        for name in ("Twb", "cam_times", "kp_ur", "matches"):
            np.testing.assert_array_equal(getattr(p, name), getattr(r, name), err_msg=name)
        for name in ("keypoints", "kp_octaves", "descriptors"):
            for a, b in zip(getattr(p, name), getattr(r, name)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert p.covisibility == r.covisibility
        assert (p.prev_kf and p.prev_kf.id) == (r.prev_kf and r.prev_kf.id)
    assert sorted(pm.map_points) == sorted(rm.map_points)
    for i, r in rm.map_points.items():
        p = pm.map_points[i]
        np.testing.assert_array_equal(p.position, r.position)
        np.testing.assert_array_equal(p.descriptor, r.descriptor)
        assert p.first_kf_id == r.first_kf_id
        assert {k: list(v) for k, v in p.observations.items()} == \
            {k: list(v) for k, v in r.observations.items()}


@pytest.mark.parametrize("gba", [False, True])
def test_same_loop_and_sim3(closures, gba):
    ref, port = closures[("ref", gba)], closures[("port", gba)]
    assert port["loop_kf"] == ref["loop_kf"] == port["kfs"][0].id
    for a, b in zip(port["S12"], ref["S12"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("gba", [False, True])
def test_same_poses_after_correct_loop(closures, gba):
    ref, port = closures[("ref", gba)], closures[("port", gba)]
    assert_poses_close(port["kfs"], ref["kfs"])
    assert port["lc"].loops_closed == ref["lc"].loops_closed == 1
    assert port["lc"].n_gba_applied == ref["lc"].n_gba_applied == int(gba)
    err_after = np.linalg.norm(port["kfs"][-1].Twb[:3, 3] - port["gt"][-1][:3, 3])
    assert err_after < 0.5 * port["err_before"]


@pytest.mark.parametrize("gba", [False, True])
def test_same_fuse_and_map_points(closures, gba):
    ref, port = closures[("ref", gba)], closures[("port", gba)]
    assert port["fused"] == ref["fused"] and port["fused"][0] > 0
    assert sorted(port["m"].map_points) == sorted(ref["m"].map_points)
    for i, r in ref["m"].map_points.items():
        np.testing.assert_allclose(port["m"].map_points[i].position, r.position,
                                   rtol=0, atol=POSE_TOL)


def test_first_closure_essential_graph_moves_nothing(closures):
    """The reference's known fault, kept (ROADMAP §3): every edge of the
    first closure's essential graph is measured from the already-propagated
    poses, so its chi2 starts at 0 and each pose leaves it as it entered, up
    to the rounding of the S_cw round trip; the reference's does the same."""
    for pkg in ("port", "ref"):
        before, after = closures[(pkg, False)]["eg_poses"]
        assert max(np.abs(a - b).max() for a, b in zip(before, after)) <= 1e-12, pkg


# ---------------------------------------------------------------------------
# two sequential closures (tests/test_loop_closing.py::_run_incremental)
# ---------------------------------------------------------------------------


def run_incremental(pkg: str, seed=7, close_loops=True, n_per=14, n_lm=100, n_local=20,
                    drift=0.05, noise_px=0.3):
    """The reference test's incremental two-revolution run on either
    package's map store and closer."""
    ms = ref_ms if pkg == "ref" else port_ms
    make_rig_, exp = (ref_make_rig, ref_exp) if pkg == "ref" else (make_rig, _np_exp_se3)
    ms._ids = itertools.count(ID_START)
    rng = np.random.RandomState(seed)
    Tbc, K, bf = make_rig_(2, seed + 1)
    if pkg == "ref":
        rig = RefRig(Tbc=Tbc, K=K, bf=bf)
        m = ms.Map()
        lc = RefLoopClosing(rig, m, RefKFDB(), fix_scale=True, min_matches=15,
                            consistency_needed=1, run_global_ba=close_loops)
    else:
        rig = Rig(Tbc=Tbc, K=K, bf=bf)
        m = ms.Map()
        lc = port_closer(rig, m, KeyFrameDatabase(), fix_scale=True, min_matches=15,
                         consistency_needed=1, run_global_ba=close_loops)
    if not close_loops:
        lc.min_matches = 10**9
    cam = rig.n_cams - 1
    n_kf = 2 * n_per
    step = np.array([1.2, 0, 0, 0, 0, 2 * np.pi / n_per])
    gt = [np.eye(4)]
    for _ in range(n_kf - 1):
        gt.append(gt[-1] @ exp(step))
    X0 = rng.randn(n_lm, 3) * 2 + np.array([4.0, 0, 1.0])
    descs = rng.randint(0, 256, (n_lm + n_kf * n_local, 32)).astype(np.uint8)

    def project(Twb_gt, Xw):
        Tcw = np.linalg.inv(Twb_gt @ Tbc[cam])
        Xc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = np.maximum(Xc[:, 2], 1e-9)
        u = K[cam, 0] * Xc[:, 0] / z + K[cam, 2]
        v = K[cam, 1] * Xc[:, 1] / z + K[cam, 3]
        return np.stack([u, v], 1), u - bf / z, Xc[:, 2] > 0.5

    mp_of, Xloc_gt, kfs, prev = {}, {}, [], None
    for k in range(n_kf):
        est_k = (np.eye(4) if k == 0 else kfs[-1].Twb @ exp(
            step + np.concatenate([rng.randn(3) * drift, rng.randn(3) * drift * 0.2])))
        revisit = k in (n_per - 1, 2 * n_per - 1)
        obs = []
        if k == 0 or revisit:
            obs += [(l, X0[l], None) for l in range(n_lm)]  # noqa: E741
        if k > 0 and (k - 1) in Xloc_gt:
            obs += [(n_lm + (k - 1) * n_local + i, Xloc_gt[k - 1][i], k - 1)
                    for i in range(n_local)]
        Xc = np.stack([rng.uniform(-4, 4, n_local), rng.uniform(-3, 3, n_local),
                       rng.uniform(5, 14, n_local)], 1)
        Twc_gt = gt[k] @ Tbc[cam]
        Xloc_gt[k] = Xc @ Twc_gt[:3, :3].T + Twc_gt[:3, 3]
        obs += [(n_lm + k * n_local + i, Xloc_gt[k][i], k) for i in range(n_local)]
        ids = np.array([o[0] for o in obs], int)
        Xw = np.stack([o[1] for o in obs])
        anch = [o[2] for o in obs]
        kp, ur, vis = project(gt[k], Xw)
        sel = np.where(vis)[0]
        kp = kp[sel] + rng.randn(len(sel), 2) * noise_px
        ur = ur[sel] + rng.randn(len(sel)) * noise_px
        kf = ms.KeyFrame(
            timestamp=float(k), cam_times=np.array([k - 0.02, float(k)]), Twb=est_k.copy(),
            velocity=np.zeros(6), keypoints=[np.zeros((0, 2)), kp],
            kp_octaves=[np.zeros(0, np.int64), np.zeros(len(sel), np.int64)],
            descriptors=[np.zeros((0, 32), np.uint8), descs[ids[sel]]], kp_ur=ur)
        kf.prev_kf = prev
        if prev is not None:
            prev.next_kf = kf
        m.add_keyframe(kf)
        kfs.append(kf)
        prev = kf
        drift_T = est_k @ np.linalg.inv(gt[k])
        for i, si in enumerate(sel):
            l = int(ids[si])  # noqa: E741
            g = kf.global_index(1, i)
            if revisit and l < n_lm:
                mp = ms.MapPoint(position=drift_T[:3, :3] @ Xw[si] + drift_T[:3, 3],
                                 descriptor=descs[l], first_kf_id=kf.id)
                m.add_map_point(mp)
            elif l in mp_of:
                mp = mp_of[l]
            else:
                a = anch[si]
                aT = (kfs[a].Twb @ np.linalg.inv(gt[a])) if a is not None else drift_T
                mp = ms.MapPoint(position=aT[:3, :3] @ Xw[si] + aT[:3, 3],
                                 descriptor=descs[l], first_kf_id=kf.id)
                mp_of[l] = mp
                m.add_map_point(mp)
            mp.add_observation(kf, 1, g)
            kf.matches[g] = mp.id
        kf.update_connections(m.map_points)
        lc.insert_keyframe(kf)
        lc.run_once()
    ate = float(np.mean([np.linalg.norm(k_.Twb[:3, 3] - g[:3, 3]) for k_, g in zip(kfs, gt)]))
    return kfs, gt, m, lc, ate


def test_two_sequential_loops_match_reference(ref_gba_f64):
    rkfs, _, rm, rlc, rate = run_incremental("ref")
    pkfs, gt, pm, plc, pate = run_incremental("port")
    assert plc.loops_closed == rlc.loops_closed == 2
    assert [[i for i, _ in k.loop_edges] for k in pkfs] == \
        [[i for i, _ in k.loop_edges] for k in rkfs]
    assert sum(len(k.loop_edges) for k in pkfs) >= 4
    assert_poses_close(pkfs, rkfs)
    assert sorted(pm.map_points) == sorted(rm.map_points)
    assert abs(pate - rate) <= POSE_TOL
    # the first revisit keyframe stays consistent after the second closure
    assert np.linalg.norm(pkfs[13].Twb[:3, 3] - gt[13][:3, 3]) < 0.5


def test_search_by_sim3_densification_matches_reference():
    """tests/test_loop_closing.py::test_search_by_sim3_densification on
    both matchers: equal index vectors, under the true and a wrong Sim3."""
    rng = np.random.RandomState(5)
    Tbc, K, _ = make_rig(2, 3)
    Tcb = np.stack([np.linalg.inv(T) for T in Tbc])
    cam, n = 1, 40
    Xc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    Xb1 = Xc @ Tbc[cam][:3, :3].T + Tbc[cam][:3, 3]
    R12 = _np_exp_se3(np.array([0, 0, 0, 0.1, -0.05, 0.3]))[:3, :3]
    t12 = np.array([0.4, -0.2, 0.1])
    Xb2 = (Xb1 - t12) @ R12

    def project(Xb):
        X = Xb @ Tcb[cam][:3, :3].T + Tcb[cam][:3, 3]
        return np.stack([K[cam, 0] * X[:, 0] / X[:, 2] + K[cam, 2],
                         K[cam, 1] * X[:, 1] / X[:, 2] + K[cam, 3]], 1)

    uv1, uv2 = project(Xb1), project(Xb2)
    descs = rng.randint(0, 256, (n, 32)).astype(np.uint8)
    cams = np.full(n, cam, np.int32)
    perm = rng.permutation(n)
    for R, t in ((R12, t12), (np.eye(3), t12 + 5.0)):
        args = (Xb1, cams, uv1, descs, Xb2[perm], cams, uv2[perm], descs[perm], 1.0, R, t,
                Tcb, K)
        got = port_matcher.search_by_sim3(*args)
        np.testing.assert_array_equal(got, ref_matcher.search_by_sim3(*args))
    good = port_matcher.search_by_sim3(Xb1, cams, uv1, descs, Xb2[perm], cams, uv2[perm],
                                       descs[perm], 1.0, R12, t12, Tcb, K)
    assert (good == np.argsort(perm)).mean() > 0.9


# ---------------------------------------------------------------------------
# the detached global BA (tests/test_abort_ba.py:159-217 on the port)
# ---------------------------------------------------------------------------


def _empty_kf(timestamp, Twb, prev):
    kf = port_ms.KeyFrame(
        timestamp=timestamp, cam_times=np.array([timestamp - 0.02, timestamp]),
        Twb=Twb.copy(), velocity=np.zeros(6),
        keypoints=[np.zeros((0, 2)), np.zeros((0, 2))],
        kp_octaves=[np.zeros(0, np.int64), np.zeros(0, np.int64)],
        descriptors=[np.zeros((0, 32), np.uint8), np.zeros((0, 32), np.uint8)],
        kp_ur=np.zeros(0))
    kf.prev_kf = prev
    if prev is not None:
        prev.next_kf = kf
    return kf


def _held_gba(monkeypatch):
    """The port's global_ba_interruptible, held on `hold` after the
    snapshot: a deterministic stand-in for 'the GBA is still running'."""
    started, hold = threading.Event(), threading.Event()
    real = tba.global_ba_interruptible

    def slow(data, state, num_iterations=10, should_abort=None, seg_iters=2):
        started.set()
        assert hold.wait(60), "test released the hold too late"
        return real(data, state, num_iterations, should_abort=should_abort,
                    seg_iters=seg_iters)

    monkeypatch.setattr(tba, "global_ba_interruptible", slow)
    return started, hold


def test_detached_gba_corrects_keyframe_inserted_mid_solve(monkeypatch):
    m, rig, kfs, _ = tsyn.build_loop_map(n_kf=8, n_lm=60, n_local=15, seed=5)
    lc = port_closer(rig, m, KeyFrameDatabase(), detached_gba=True)
    started, hold = _held_gba(monkeypatch)
    lc._launch_global_ba(num_iterations=4)
    assert started.wait(30)
    assert lc.running_gba
    parent = kfs[-1]
    parent_before = parent.Twb.copy()
    offset = np.eye(4)
    offset[:3, 3] = [0.7, 0.1, 0.0]
    new_kf = _empty_kf(parent.timestamp + 1.0, parent.Twb @ offset, parent)
    with m.mutex:
        m.add_keyframe(new_kf)
    new_before = new_kf.Twb.copy()
    hold.set()
    lc.join_gba(timeout=120)
    assert not lc.gba_thread.is_alive()
    assert not lc.running_gba
    assert lc.n_gba_applied == 1 and lc.n_gba_aborted == 0
    delta = parent.Twb @ np.linalg.inv(parent_before)
    assert np.linalg.norm(delta - np.eye(4)) > 1e-8, "GBA moved nothing"
    np.testing.assert_allclose(new_kf.Twb, delta @ new_before, atol=1e-9)


def test_detached_gba_superseded_discards_result(monkeypatch):
    m, rig, kfs, _ = tsyn.build_loop_map(n_kf=8, n_lm=60, n_local=15, seed=6)
    lc = port_closer(rig, m, KeyFrameDatabase(), detached_gba=True)
    started, hold = _held_gba(monkeypatch)
    poses_before = {k.id: k.Twb.copy() for k in kfs}
    lc._launch_global_ba(num_iterations=4)
    assert started.wait(30)
    with lc._gba_lock:
        lc.gba_abort.set()
        lc.full_ba_idx += 1
    hold.set()
    lc.join_gba(timeout=120)
    assert not lc.gba_thread.is_alive()
    assert lc.n_gba_applied == 0 and lc.n_gba_aborted == 1
    for k in kfs:
        np.testing.assert_array_equal(k.Twb, poses_before[k.id])


def test_detached_gba_error_reaches_the_caller(monkeypatch):
    m, rig, kfs, _ = tsyn.build_loop_map(n_kf=8, n_lm=60, n_local=15, seed=5)
    lc = port_closer(rig, m, KeyFrameDatabase(), detached_gba=True)

    def failing(*a, **kw):
        raise ValueError("solver failed")

    monkeypatch.setattr(tba, "global_ba_interruptible", failing)
    lc._launch_global_ba(num_iterations=4)
    with pytest.raises(RuntimeError, match="detached global BA failed") as info:
        lc.join_gba(timeout=60)
    assert isinstance(info.value.__cause__, ValueError)
    assert not lc.gba_thread.is_alive() and not lc.running_gba


def test_detached_gba_equals_the_synchronous_one():
    """The same closure with the global BA detached and then joined gives
    the synchronous run's poses."""
    out = {}
    for detached in (False, True):
        port_ms._ids = itertools.count(ID_START)
        m, rig, kfs, _ = tsyn.build_loop_map()
        lc = port_closer(rig, m, KeyFrameDatabase(), fix_scale=True, min_matches=15,
                         consistency_needed=1, detached_gba=detached)
        for k in kfs[:-1]:
            lc.kfdb.add(k)
        loop_kf, S12 = lc.detect_common_regions(kfs[-1])
        lc.correct_loop(kfs[-1], loop_kf, S12)
        lc.join_gba(timeout=120)
        assert lc.n_gba_applied == 1
        out[detached] = kfs
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a.Twb, b.Twb)


def test_pcg_backend_seam_records_steps():
    """`_pcg` is the PCG solve's one seam: the chip smoke run counts its
    steps there."""
    data, state, _ = tsyn.make_essential_graph(n_kf=40, n_loop=4, drift=0.002, seed=4,
                                               step_m=5.0, laps=2)
    steps = []
    real = tso._pcg

    def counting(*a):
        x, it, rel = real(*a)
        steps.append((it, rel))
        return x, it, rel

    try:
        tso._pcg = counting
        out, stats = tso.optimize_essential_graph(data, state, use_pcg=True)
    finally:
        tso._pcg = real
    assert steps and all(0 < it <= 250 for it, _ in steps)
    assert float(stats.chi2) < float(stats.initial_chi2)
