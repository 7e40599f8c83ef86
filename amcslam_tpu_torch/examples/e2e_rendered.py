"""End-to-end on RENDERED IMAGES: textured-corridor world -> per-camera
pinhole rendering -> ORB extraction -> full SLAM pipeline -> ATE.

Port of `examples/e2e_rendered.py`: the whole stack the way a user runs it
(multicam_amv.cc semantics: images in, trajectory out), on the port's
System on an explicit device (default the card; `--device cpu` asks for
the CPU). `make_world` draws the reference's textures array for array and
`render` is its host ray-caster; `DeviceRenderer` is the counterpart of
its jitted renderer (all views in one batched pass on the device). The
ORB backend is "host" (native/numpy, per-camera threads) or "device" (one
batched pass on the device).

Usage: python -m amcslam_tpu_torch.examples.e2e_rendered [--frames N]
       [--device cuda|cpu] [--backend host|device] [--plot out.png] ...
Prints per-stage timing and the final ATE RMSE vs the ground-truth
trajectory.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..frontend.cameras import CAMERA_KB8, kb8_ray_grid
from ..frontend.features import build_frame, make_extractors
from ..pipeline.rig import Rig
from ..pipeline.system import System
from ..pipeline.tracking import TrackingConfig, resolve_device
from ..utils.io import ate_rmse
from ..utils.timing import GLOBAL_TIMER

W, H = 640, 480
K4 = np.array([400.0, 400.0, 320.0, 240.0])


def make_world(seed=0, half=4.0, ceiling=4.0, span=12.0):
    """Textured box: ground, ceiling, two walls (at y = +-half). Blocky
    random textures (strong FAST corners at block edges) + fine noise; the
    texture tiles every `span` meters — keep `span` >= the scene extent for
    loop-closure scenarios so places stay visually distinct."""
    rng = np.random.RandomState(seed)

    def tex(n_blocks=96, up=6):
        t = rng.randint(30, 226, (n_blocks, n_blocks)).astype(np.float64)
        t = np.kron(t, np.ones((up, up)))
        t += rng.randn(*t.shape) * 6.0
        return np.clip(t, 0, 255)

    # (p0, n, e1, e2, texture, scale [texels per meter])
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    s = 96 * 6 / span
    return [
        (np.array([0, 0, 0.0]), ez, ex, ey, tex(), s),          # ground z=0
        (np.array([0, 0, ceiling]), -ez, ex, ey, tex(), s),     # ceiling
        (np.array([0, -half, 0]), ey, ex, ez, tex(), s),        # wall y=-h
        (np.array([0, half, 0]), -ey, ex, ez, tex(), s),        # wall y=+h
    ]


def render(Twc: np.ndarray, planes, ray_grid: np.ndarray | None = None) -> np.ndarray:
    """Ray-cast one view of the textured box (nearest-texel). Default is
    the pinhole K4 camera; pass `ray_grid` (H,W,3 unit-depth rays, e.g.
    cameras.kb8_ray_grid) to render through another camera model."""
    if ray_grid is not None:
        d_cam = ray_grid.reshape(-1, 3).T
    else:
        fx, fy, cx, cy = K4
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack(
            [(u.ravel() - cx) / fx, (v.ravel() - cy) / fy, np.ones(W * H)], 0
        )
    Rwc, t = Twc[:3, :3], Twc[:3, 3]
    d = Rwc @ d_cam  # (3, N)
    best_t = np.full(W * H, np.inf)
    val = np.zeros(W * H)
    for p0, n, e1, e2, texture, scale in planes:
        denom = n @ d
        with np.errstate(divide="ignore", invalid="ignore"):
            ti = (n @ (p0 - t)) / denom
        ok = (denom < -1e-9) & (ti > 0.2) & (ti < best_t)
        if not ok.any():
            continue
        hit = t[:, None] + d * ti[None, :]
        s1 = ((hit - p0[:, None]).T @ e1) * scale
        s2 = ((hit - p0[:, None]).T @ e2) * scale
        hh, ww = texture.shape
        i1 = np.mod(np.floor(s1).astype(np.int64), hh)
        i2 = np.mod(np.floor(s2).astype(np.int64), ww)
        sample = texture[i1, i2]
        val = np.where(ok, sample, val)
        best_t = np.where(ok, ti, best_t)
    return np.clip(val, 0, 255).astype(np.uint8).reshape(H, W)


class DeviceRenderer:
    """The ray-caster as one batched program on `device`: all cameras'
    views render in one pass (the same plane-intersection + nearest-texel
    semantics as `render`, in float32 as the reference's jitted renderer,
    e2e_rendered.py:95-161). `dispatch` queues a render and returns the
    device tensor, so the next frame's render overlaps host work; `fetch`
    reads it back."""

    def __init__(self, planes, ray_grids: np.ndarray | None = None, *, device):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.p0 = torch.as_tensor(np.stack([p[0] for p in planes]), **f32)
        self.nrm = torch.as_tensor(np.stack([p[1] for p in planes]), **f32)
        self.e1 = torch.as_tensor(np.stack([p[2] for p in planes]), **f32)
        self.e2 = torch.as_tensor(np.stack([p[3] for p in planes]), **f32)
        self.tex = torch.as_tensor(np.stack([p[4] for p in planes]), **f32)
        self.scale = torch.as_tensor(np.array([p[5] for p in planes]), **f32)
        fx, fy, cx, cy = K4
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones((H, W))],
                         axis=-1).astype(np.float32)  # (H, W, 3)
        # per-view ray grids (V,H,W,3): views with a camera model other than
        # the default pinhole (e.g. KB8 fisheye) carry their own rays
        self.grids = (torch.as_tensor(d_cam, **f32)[None] if ray_grids is None
                      else torch.as_tensor(np.asarray(ray_grids, np.float32), **f32))

    def dispatch(self, Twc_list) -> torch.Tensor:
        """(C,4,4) poses -> (C,H,W) uint8 views on the device (queued)."""
        T = torch.as_tensor(np.stack(Twc_list), dtype=torch.float32, device=self.device)
        R, t = T[:, :3, :3], T[:, :3, 3]
        d = self.grids @ R[:, None].transpose(-1, -2)      # (C,H,W,3) world rays
        denom = d @ self.nrm.T                              # (C,H,W,P)
        num = torch.sum(self.nrm * (self.p0 - t[:, None, :]), dim=-1)  # (C,P)
        ti = num[:, None, None, :] / denom
        ok = (denom < -1e-9) & (ti > 0.2)
        ti = torch.where(ok, ti, torch.full_like(ti, float("inf")))
        tbest, best = torch.min(ti, dim=-1)                 # first minimum
        valid = torch.isfinite(tbest)
        tsafe = torch.where(valid, tbest, torch.ones_like(tbest))
        hit = t[:, None, None, :] + d * tsafe[..., None]
        rel = hit - self.p0[best]
        s1 = torch.sum(rel * self.e1[best], dim=-1) * self.scale[best]
        s2 = torch.sum(rel * self.e2[best], dim=-1) * self.scale[best]
        i1 = torch.remainder(torch.floor(s1).long(), self.tex.shape[1])
        i2 = torch.remainder(torch.floor(s2).long(), self.tex.shape[2])
        val = torch.where(valid, self.tex[best, i1, i2], torch.zeros_like(tsafe))
        return torch.clamp(val, 0, 255).to(torch.uint8)

    @staticmethod
    def fetch(views: torch.Tensor) -> list[np.ndarray]:
        return list(views.cpu().numpy())

    def __call__(self, Twc_list) -> list[np.ndarray]:
        return self.fetch(self.dispatch(Twc_list))


def make_rig(n_async: int = 2) -> Rig:
    """`n_async` async monos (yawed around the body) + forward stereo pair.

    n_async=2 is the compact test rig; n_async=5 reproduces the reference's
    AMV convention of 5 async cameras + 1 stereo pair = 7 images per tick
    (orb_multicam.yaml:3-14, System.cc:213-218)."""

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def cam_T(yaw):
        # camera: +z optical forward, +x right, +y down -> body (+x fwd,
        # +y left, +z up)
        T = np.eye(4)
        R_b_cam = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
        T[:3, :3] = rotz(yaw) @ R_b_cam
        return T

    if n_async == 2:
        yaws = [0.5, -0.5]
    else:
        # spread across the forward hemisphere + flanks (AMV-style surround)
        yaws = list(np.linspace(1.6, -1.6, n_async))
    Tbc = np.stack([cam_T(y) for y in yaws] + [cam_T(0.0)])
    K = np.tile(K4, (n_async + 1, 1))
    return Rig(Tbc=Tbc, K=K, bf=400.0 * 0.2,
               qc_diag=np.full(6, 1.0), n_levels=8)


def gt_pose(t: float) -> np.ndarray:
    """Smooth forward trajectory with gentle yaw/lateral wiggle."""
    x = 1.0 * t
    y = 0.35 * np.sin(0.35 * t)
    yaw = 0.35 * 0.35 * np.cos(0.35 * t)  # dy/dx heading
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [x, y, 1.5]
    return T


def gt_pose_circle(t: float, period: float = 10.0, radius: float = 1.5):
    """Closed circular trajectory (tangent heading): revisits its start
    after `period` seconds, driving the loop-closing path."""
    a = 2 * np.pi * t / period
    yaw = a + np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 1.5]
    return T


def gt_pose_eight(t: float, period: float = 16.0, radius: float = 5.0):
    """Figure-eight of two externally tangent circles, both transited
    through the tangent point (0,0) heading +y — so the junction region is
    revisited in the SAME direction on every transit, and each circle's lap
    closure revisits its own start. `period` is the time for ONE circle;
    the full eight takes 2*period. Circle A (center (-R,0)) runs
    counter-clockwise, circle B (center (+R,0)) clockwise:

      A: p = (-R + R cos u,  R sin u),  yaw = u + pi/2
      B: p = ( R - R cos u,  R sin u),  yaw = pi/2 - u

    (headings match at u = 0 mod 2pi, so the path is C1 at the junction).
    Driving 2+ transits fires MULTIPLE sequential loop closures from the
    keyframe database — the reference's continuous multi-loop replay shape
    (multicam_amv.cc:61-137 over a course with several revisits)."""
    u = 2 * np.pi * (t % period) / period
    on_b = int(t // period) % 2 == 1
    if on_b:
        pos = [radius - radius * np.cos(u), radius * np.sin(u)]
        yaw = np.pi / 2 - u
    else:
        pos = [-radius + radius * np.cos(u), radius * np.sin(u)]
        yaw = np.pi / 2 + u
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T[:3, 3] = [pos[0], pos[1], 1.5]
    return T


def run(n_frames=50, fps=10.0, seed=0, plot=None, threaded=False,
        circle=False, circle_period=16.0, circle_radius=5.0,
        n_features=800, device_render=False, eight=False, n_async=2,
        blackout=None, collect=None, fisheye=False, pace=False, *,
        device="cuda", backend=None):
    """The reference's `run` (e2e_rendered.py:223-) on the port: `device`
    runs the System, the device renderer, the device ORB backend and the
    KB8 lift; `backend` is the ORB backend ("host" or "device"; None reads
    AMCSLAM_ORB_BACKEND, then "host"). Returns (ate, dist, n_loops).

    `eight=True`: figure-eight course with multiple same-direction
    revisits. `n_async`: async mono count (5 = the AMV rig width, 7 images
    per tick). `blackout=(k0, n)`: frames k0..k0+n-1 render black.
    `fisheye=True`: async camera 0 becomes a KannalaBrandt8 fisheye,
    rendered through kb8_ray_grid, keypoints lifted by the Newton
    inversion. `pace=True`: frame k is not submitted before wall time
    k/fps. `plot`: a PNG path for the top-down map render
    (pipeline/viewer.draw_map; needs matplotlib). `collect`: optional dict that receives per-frame states, the
    System, the trajectories and per-frame timings (ms)."""
    device = resolve_device(device)
    if eight:
        half = max(12.0, 2.0 * circle_radius + 10.0)
        planes = make_world(seed, half=half, ceiling=6.0,
                            span=max(40.0, 2.0 * half + 8.0))
        pose_fn = lambda t: gt_pose_eight(t, circle_period, circle_radius)  # noqa: E731
    elif circle:
        # a big circle in a big non-repeating box: the far side looks
        # different from the start, drift accumulates over the lap and the
        # revisit must be closed by the loop closer
        half = max(12.0, circle_radius + 10.0)
        planes = make_world(seed, half=half, ceiling=6.0,
                            span=max(40.0, 2.0 * half + 8.0))
        pose_fn = lambda t: gt_pose_circle(t, circle_period, circle_radius)  # noqa: E731
    else:
        planes = make_world(seed)
        pose_fn = gt_pose
    rig = make_rig(n_async)
    C = rig.n_cams
    ray_grids = None
    if fisheye:
        # async camera 0 becomes a KB8 fisheye: shorter focal (wider FOV)
        # + a theta-polynomial with visible distortion at the image edges
        kb8 = np.array([300.0, 300.0, 320.0, 240.0, 0.05, -0.01, 0.002, 0.0])
        rig.K[0] = kb8[:4]
        rig.cam_model = np.zeros(C, np.int32)
        rig.cam_model[0] = CAMERA_KB8
        rig.kb8_params = np.zeros((C, 8))
        rig.kb8_params[0] = kb8
        fx, fy, cx, cy = K4
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        pin = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones((H, W))], -1)
        ray_grids = np.stack([kb8_ray_grid(kb8, W, H, device=device)] + [pin] * C)
    renderer = DeviceRenderer(planes, ray_grids, device=device) if device_render else None
    extractors = make_extractors(C + 1, n_features, backend, device=device)
    cfg = TrackingConfig(max_frames_between_kf=5, min_local_matches=15,
                         ransac_min_match=15)
    slam = System(rig, tracking_config=cfg, threaded=threaded, device=device)

    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]  # stereo right offset in camera frame

    def frame_views(k):
        ts = k / fps
        cam_times = rig.cam_times(ts)
        views = [pose_fn(cam_times[c]) @ rig.Tbc[c] for c in range(C)]
        views.append(pose_fn(ts) @ rig.Tbc[C - 1] @ Tright)
        return views

    gt_t, gt_T = [], []
    track_times, render_times, extract_times = [], [], []
    states = []
    pending = renderer.dispatch(frame_views(0)) if renderer is not None else None
    t_wall0 = time.time()
    for k in range(n_frames):
        ts = k / fps
        cam_times = rig.cam_times(ts)
        if pace:
            lag = t_wall0 + k / fps - time.time()
            if lag > 0:
                time.sleep(lag)
        t0 = time.time()
        if renderer is not None:
            *imgs, img_r = renderer.fetch(pending)
            if k + 1 < n_frames:  # overlap next render with this frame's work
                pending = renderer.dispatch(frame_views(k + 1))
        else:
            *imgs, img_r = [
                render(T, planes, ray_grid=ray_grids[i] if ray_grids is not None else None)
                for i, T in enumerate(frame_views(k))
            ]
        if blackout is not None and blackout[0] <= k < blackout[0] + blackout[1]:
            # sensor dropout: the tracker sees featureless black frames
            imgs = [np.zeros_like(im) for im in imgs]
            img_r = np.zeros_like(img_r)
        render_times.append(time.time() - t0)

        t0 = time.time()
        frame = build_frame(imgs, cam_times, rig, extractors, right_image=img_r, device=device)
        extract_times.append(time.time() - t0)

        t0 = time.time()
        state = slam.track_multicamera(frame)
        track_times.append(time.time() - t0)
        states.append(state)

        gt_t.append(ts)
        gt_T.append(pose_fn(ts))
        if (k + 1) % 50 == 0:
            n_loops = slam.loop_closer.loops_closed if slam.loop_closer else 0
            recent = track_times[-50:]
            print(f"  [{k+1}/{n_frames}] kf={len(slam.atlas.active.keyframes)}"
                  f" mp={len(slam.atlas.active.map_points)} loops={n_loops}"
                  f" track_med={np.median(recent)*1e3:.0f}ms", flush=True)

    slam.shutdown()
    traj = slam.tracker.trajectory_poses()
    est_t = np.array([t for t, _ in traj])
    est_T = np.stack([T for _, T in traj])
    ate, _ = ate_rmse(est_t, est_T, np.array(gt_t), np.stack(gt_T))
    dist = np.sum(np.linalg.norm(np.diff(np.stack(gt_T)[:, :3, 3], axis=0), axis=1))
    n_kf = len(slam.atlas.active.keyframes)
    n_mp = len(slam.atlas.active.map_points)
    n_loops = slam.loop_closer.loops_closed if slam.loop_closer else 0
    print(f"frames={n_frames} dist={dist:.1f}m kf={n_kf} mp={n_mp} loops={n_loops}")
    print(f"render  {np.mean(render_times)*1e3:7.1f} ms/frame (synthetic world, "
          "not part of the pipeline)")
    print(f"extract {np.mean(extract_times)*1e3:7.1f} ms/frame ({C + 1} images)")
    tail = track_times[-10:] if len(track_times) >= 20 else track_times
    print(f"track   {np.mean(track_times)*1e3:7.1f} ms/frame mean, "
          f"{np.median(track_times)*1e3:.1f} ms median, "
          f"{np.mean(tail)*1e3:.1f} ms steady-state (last {len(tail)}) "
          "(matching+solvers+mapping)")
    print(f"ATE RMSE {ate:.4f} m  ({100*ate/max(dist,1e-9):.2f}% of {dist:.1f} m)")
    if os.environ.get("AMCSLAM_STAGE_STATS"):
        GLOBAL_TIMER.print_stats()
    if plot:
        from ..pipeline.viewer import draw_map

        draw_map(slam.atlas.active, trajectory=traj, path=plot)
        print(f"map render -> {plot}")
    if collect is not None:
        collect["states"] = states
        collect["system"] = slam
        collect["est"] = (est_t, est_T)
        collect["gt"] = (np.array(gt_t), np.stack(gt_T))
        collect["timing"] = {
            "extract_ms": float(np.mean(extract_times) * 1e3),
            "track_ms_median": float(np.median(track_times) * 1e3),
            "track_ms": [float(x * 1e3) for x in track_times],
            "render_ms": [float(x * 1e3) for x in render_times],
            "extract_ms_frames": [float(x * 1e3) for x in extract_times],
        }
    return ate, dist, n_loops



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--circle", action="store_true",
                    help="closed circular trajectory (exercises loop closing)")
    ap.add_argument("--period", type=float, default=16.0)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--plot", default=None,
                    help="write a top-down map render to this PNG (needs matplotlib)")
    ap.add_argument("--features", type=int, default=800)
    ap.add_argument("--threaded", action="store_true",
                    help="run mapping/loop-closing in a background thread "
                         "(the reference's thread layout); tracking latency "
                         "then excludes local BA")
    ap.add_argument("--device-render", action="store_true",
                    help="ray-cast the world on the device (all cameras in "
                         "one batched pass) instead of host NumPy")
    ap.add_argument("--eight", action="store_true",
                    help="figure-eight course: multiple same-direction "
                         "revisits -> multiple sequential loop closures")
    ap.add_argument("--n-async", type=int, default=2,
                    help="async mono cameras (5 = AMV rig, 7 images/tick)")
    ap.add_argument("--fisheye", action="store_true",
                    help="async camera 0 is a KannalaBrandt8 fisheye")
    ap.add_argument("--pace", action="store_true",
                    help="replay at the sensor rate (real-time pacing, as "
                         "multicam_amv does) — required for meaningful "
                         "--threaded runs")
    ap.add_argument("--blackout", default=None,
                    help="K0:N — render frames K0..K0+N-1 black "
                         "(relocalization scenario)")
    ap.add_argument("--device", default="cuda",
                    help="device of the System, the renderer and the device ORB "
                         "(default cuda; cpu runs on the host)")
    ap.add_argument("--backend", choices=("host", "device"), default=None,
                    help="ORB backend (default: AMCSLAM_ORB_BACKEND, else host)")
    args = ap.parse_args(argv)
    n = args.frames
    if args.circle and n == 50:
        n = int(args.period * args.fps) + int(2 * args.fps)  # lap + revisit
    if args.eight and n == 50:
        # A, B, then re-enter A: three junction transits + two lap closures
        n = int(2.2 * args.period * args.fps)
    blackout = None
    if args.blackout:
        k0, nb = args.blackout.split(":")
        blackout = (int(k0), int(nb))
    run(n_frames=n, fps=args.fps, plot=args.plot, circle=args.circle,
        circle_period=args.period, circle_radius=args.radius,
        n_features=args.features, threaded=args.threaded,
        device_render=args.device_render, eight=args.eight,
        n_async=args.n_async, blackout=blackout, fisheye=args.fisheye,
        pace=args.pace, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
