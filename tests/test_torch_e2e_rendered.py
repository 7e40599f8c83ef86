"""The port's entry points on rendered images against the reference's.

- `make_world` draws the reference's textures array for array, and the
  host ray-caster `render` (pinhole and KB8 ray grid), the rig and the
  ground-truth paths equal the reference's; the device renderer, run here
  on the CPU, agrees with the host renderer on >= 99 % of the pixels (it
  runs in float32, the host in float64, so texel boundaries move).
- `run` of both packages, frame by frame, on 6 rendered frames (2 async +
  stereo, 400 features, host ORB, both on the CPU): the same tracking
  states, keyframe timestamps and map-point counts after every frame, and
  poses to 1e-4 m / 1e-4 rad. Both run their solves in float32: the
  reference's tracking builds its problems in float32 whatever x64 says
  (amcslam_tpu/pipeline/tracking.py:601-610), so the two Systems cannot be
  held to each other in float64; the 1e-4 tolerance is the one of
  tests/test_torch_system.py's float32 comparison. Both extract with the
  port's native build of the shared ORB source (see tests/test_torch_frontend.py)
  and start their id counters at one value.
- The port's AMV replay CLI in a subprocess with `--device cpu` on the
  dataset of tests/test_amv_cli.py (written with `write_png_gray`): exit 0
  and that test's TUM checks.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import amcslam_tpu.pipeline.map_store as ref_map_store
from amcslam_tpu import native as ref_native
from amcslam_tpu.pipeline import extraction as ref_extraction
from amcslam_tpu.frontend.cameras import kb8_ray_grid as ref_kb8_ray_grid

import amcslam_tpu_torch.pipeline.map_store as port_map_store
from amcslam_tpu_torch import native
from amcslam_tpu_torch.examples import e2e_rendered as e2e
from amcslam_tpu_torch.pipeline import extraction as port_extraction
from amcslam_tpu_torch.utils.io import write_png_gray

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))
import e2e_rendered as ref_e2e  # noqa: E402

ID_START = 10_000_000
POSE_TOL_M = 1e-4
POSE_TOL_RAD = 1e-4
KB8 = np.array([300.0, 300.0, 320.0, 240.0, 0.05, -0.01, 0.002, 0.0])


def _rot_angle(Ra, Rb):
    R = Ra.T @ Rb
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, half=12.0, ceiling=6.0, span=40.0)])
def test_make_world_equals_the_reference(kw):
    got, want = e2e.make_world(**kw), ref_e2e.make_world(**kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_rig_and_paths_equal_the_reference():
    for n in (2, 5):
        r, w = e2e.make_rig(n), ref_e2e.make_rig(n)
        for f in ("Tbc", "K", "qc_diag", "cam_time_offsets"):
            np.testing.assert_array_equal(getattr(r, f), getattr(w, f))
        assert (r.bf, r.n_levels) == (w.bf, w.n_levels)
    for t in (0.0, 0.7, 3.3, 17.9, 29.0):
        np.testing.assert_array_equal(e2e.gt_pose(t), ref_e2e.gt_pose(t))
        np.testing.assert_array_equal(e2e.gt_pose_circle(t, 12.0, 4.0),
                                      ref_e2e.gt_pose_circle(t, 12.0, 4.0))
        np.testing.assert_array_equal(e2e.gt_pose_eight(t, 14.0, 4.5),
                                      ref_e2e.gt_pose_eight(t, 14.0, 4.5))
    assert (e2e.W, e2e.H) == (ref_e2e.W, ref_e2e.H)
    np.testing.assert_array_equal(e2e.K4, ref_e2e.K4)


def _views(rig, k, pose_fn, fps=5.0):
    cam_t = rig.cam_times(k / fps)
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    return ([pose_fn(cam_t[c]) @ rig.Tbc[c] for c in range(rig.n_cams)]
            + [pose_fn(k / fps) @ rig.Tbc[-1] @ Tright])


def _circle(t):
    return e2e.gt_pose_circle(t, 12.0, 4.0)


@pytest.mark.parametrize("world,pose_fn", [(dict(seed=1), e2e.gt_pose),
                                           (dict(seed=0, half=14.0, ceiling=6.0, span=40.0),
                                            _circle)])
def test_render_equals_the_reference(world, pose_fn):
    planes = e2e.make_world(**world)
    rig = e2e.make_rig(2)
    grid = e2e.kb8_ray_grid(KB8, e2e.W, e2e.H, device="cpu")
    np.testing.assert_allclose(grid, ref_kb8_ray_grid(KB8, e2e.W, e2e.H), rtol=1e-10,
                               atol=1e-10)
    with np.errstate(invalid="ignore"):
        for k in (0, 7):
            views = _views(rig, k, pose_fn)
            for T in views:
                np.testing.assert_array_equal(e2e.render(T, planes), ref_e2e.render(T, planes))
            np.testing.assert_array_equal(e2e.render(views[0], planes, ray_grid=grid),
                                          ref_e2e.render(views[0], planes, ray_grid=grid))


def test_device_renderer_agrees_with_the_host_renderer():
    """The AMV-width corridor run (seed 1, 5 async + stereo), pinhole and KB8
    views: >= 99 % of the pixels equal."""
    planes = e2e.make_world(1)
    rig = e2e.make_rig(5)
    grid = e2e.kb8_ray_grid(KB8, e2e.W, e2e.H, device="cpu")
    pin = e2e.DeviceRenderer(planes, device="cpu")
    fish = e2e.DeviceRenderer(planes, np.stack([grid] * 7), device="cpu")
    for k in (0, 15):
        views = _views(rig, k, e2e.gt_pose)
        with np.errstate(invalid="ignore"):
            host = [e2e.render(T, planes) for T in views]
            host_fe = e2e.render(views[0], planes, ray_grid=grid)
        dev = pin(views)
        assert len(dev) == 7 and dev[0].shape == (e2e.H, e2e.W) and dev[0].dtype == np.uint8
        for d, h in zip(dev, host):
            assert (d == h).mean() >= 0.99, (d == h).mean()
        assert (fish(views)[0] == host_fe).mean() >= 0.99


def test_device_renderer_agrees_with_the_reference_device_renderer():
    """In the loop-closure world the float32 renderers part from the float64
    host renderer on up to ~2 % of a forward view's pixels (distant texel
    boundaries; the reference's own device renderer does the same), so here
    the port's renderer is held to the reference's jitted one."""
    planes = e2e.make_world(0, half=14.0, ceiling=6.0, span=40.0)
    views = _views(e2e.make_rig(2), 0, _circle)
    for d, r in zip(e2e.DeviceRenderer(planes, device="cpu")(views),
                    ref_e2e.make_device_renderer(planes)(views)):
        assert (d == r).mean() >= 0.995, (d == r).mean()


def _recording(System, log):
    class Recording(System):
        def track_multicamera(self, frame):
            st = super().track_multicamera(frame)
            m = self.atlas.active
            log.append({"state": st.name,
                        "kf_times": sorted(k.timestamp for k in m.keyframes.values()),
                        "n_mp": m.n_map_points(), "Twb": np.array(frame.Twb, np.float64)})
            return st
    return Recording


@pytest.fixture(scope="module")
def runs():
    assert ref_native.available("orb_fast")
    out = {}
    with mock.patch.dict(os.environ, {"AMCSLAM_NO_BUCKET_PRESET": "1"}), \
            mock.patch.object(ref_native, "orb_extract", native.orb_extract):
        for name, mod, map_store, extraction, kw in [
                ("ref", ref_e2e, ref_map_store, ref_extraction, {}),
                ("port", e2e, port_map_store, port_extraction, dict(device="cpu"))]:
            map_store._ids = itertools.count(ID_START)
            extraction.reset_bucket_high_water()
            log, collect = [], {}
            with mock.patch.object(mod, "System", _recording(mod.System, log)):
                res = mod.run(n_frames=6, fps=10.0, seed=0, n_features=400, collect=collect,
                              **kw)
            out[name] = (res, log, collect)
    return out


def test_same_states_keyframes_and_map_points_per_frame(runs):
    ref, port = runs["ref"][1], runs["port"][1]
    assert len(port) == len(ref) == 6
    assert [p["state"] for p in port] == [r["state"] for r in ref]
    assert all(p["state"] == "OK" for p in port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p["kf_times"] == r["kf_times"], i
        assert p["n_mp"] == r["n_mp"], i
    assert len(port[-1]["kf_times"]) >= 3 and port[-1]["n_mp"] > 100


def test_poses_agree_per_frame(runs):
    for i, (r, p) in enumerate(zip(runs["ref"][1], runs["port"][1])):
        dt = np.abs(p["Twb"][:3, 3] - r["Twb"][:3, 3]).max()
        dr = _rot_angle(p["Twb"][:3, :3], r["Twb"][:3, :3])
        assert dt <= POSE_TOL_M and dr <= POSE_TOL_RAD, (i, dt, dr)


def test_run_results_agree(runs):
    (ate, dist, n_loops), _, collect = runs["port"]
    (r_ate, r_dist, r_loops), _, r_collect = runs["ref"]
    assert dist == r_dist and n_loops == r_loops == 0
    assert abs(ate - r_ate) <= POSE_TOL_M and ate < 0.02 * dist
    np.testing.assert_array_equal(collect["gt"][0], r_collect["gt"][0])
    np.testing.assert_array_equal(collect["est"][0], r_collect["est"][0])
    np.testing.assert_allclose(collect["est"][1], r_collect["est"][1], rtol=0, atol=POSE_TOL_M)
    assert len(collect["timing"]["track_ms"]) == 6 and collect["system"].device.type == "cpu"


def _write_dataset(root: Path, n_frames=6, fps=10.0) -> Path:
    """tests/test_amv_cli.py:24-70's dataset, written with the port's PNG writer."""
    planes = e2e.make_world(0)
    rig = e2e.make_rig()
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    ds = root / "seq"
    for d in ("cam0", "cam1", "cam2", "cam2_right"):
        (ds / d).mkdir(parents=True)
    times = [[] for _ in range(3)]
    with np.errstate(invalid="ignore"):
        for k in range(n_frames):
            ts = k / fps
            cam_t = rig.cam_times(ts)
            for c in range(3):
                img = e2e.render(e2e.gt_pose(cam_t[c]) @ rig.Tbc[c], planes)
                write_png_gray(str(ds / f"cam{c}" / f"{k:06d}.png"), img)
                times[c].append(cam_t[c])
            img_r = e2e.render(e2e.gt_pose(ts) @ rig.Tbc[2] @ Tright, planes)
            write_png_gray(str(ds / "cam2_right" / f"{k:06d}.png"), img_r)
    for c in range(3):
        np.savetxt(ds / f"cam{c}" / "times.txt", times[c])
        K4 = rig.K[c]
        Km = [[K4[0], 0.0, K4[2]], [0.0, K4[1], K4[3]], [0.0, 0.0, 1.0]]
        (root / f"cam{c}.json").write_text(json.dumps(
            {"sensor_to_vehicle": rig.Tbc[c].tolist(), "intrinsics": Km}))
    yaml_path = root / "run.yaml"
    yaml_path.write_text(
        "Camera.number: 3\n"
        "Camera.calibfiles: [cam0.json, cam1.json, cam2.json]\n"
        f"Camera.bf: {rig.bf}\n"
        f"dataset: {ds}\n"
        "Gaussian.Qc: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]\n"
        "ORBextractor.nFeatures: 800\n"
        "loopClosing: 1\n")
    return yaml_path


def check_tum(out: Path):
    """The TUM checks of tests/test_amv_cli.py:84-96."""
    traj = np.loadtxt(out / "f_0.txt").reshape(-1, 8)
    kf_traj = np.loadtxt(out / "kf_0.txt").reshape(-1, 8)
    assert len(traj) >= 4 and len(kf_traj) >= 1
    assert np.isfinite(traj).all() and np.isfinite(kf_traj).all()
    assert np.allclose(np.linalg.norm(traj[:, 4:], axis=1), 1.0, atol=1e-6)
    assert (np.diff(traj[:, 0]) > 0).all()
    path = np.linalg.norm(np.diff(traj[:, 1:4], axis=0), axis=1).sum()
    assert 0.05 < path < 2.0, path


def test_amv_cli_replays_on_the_cpu(tmp_path):
    yaml_path = _write_dataset(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "amcslam_tpu_torch.examples.multicam_amv", str(yaml_path),
         "--no-realtime", "--device", "cpu", "--out", str(tmp_path),
         "--trace-out", str(tmp_path / "trace.json")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "median tracking time" in proc.stdout and "6 ticks, 3 cameras" in proc.stdout
    check_tum(tmp_path)
    # the stage timeline: every tracked frame's spans under its `sys.frame`
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e["ph"] == "X"]
    roots = {e["args"]["root"] for e in events if e["name"] == "sys.frame"}
    assert len(roots) == 6
    tracked = [e for e in events if e["name"].startswith(("track.", "tlm."))]
    assert {e["name"] for e in tracked} >= {"track.local_map", "tlm.pose_lm"}
    assert {e["args"]["root"] for e in tracked} <= roots
