"""AMV-Bench replay CLI (rebuild of Examples/MultiCamera/multicam_amv.cc).

Port of `examples/multicam_amv.py`: loads the run YAML + per-camera JSON
calibration (pipeline/config.py), reads per-camera timestamp files with
zero-padded image names (System::LoadAmvImages) and the PNGs with the port's
own reader (utils/io.read_png_gray), replays the sequence with real-time
pacing on the port's System, prints the median and mean tracking time
(multicam_amv.cc:120-128) and saves the TUM trajectories named by sequence
index. `--trace-out PATH` writes the run's stage spans as Chrome trace-event
JSON (chrome://tracing or Perfetto): the timeline of the tracker's stages,
and in threaded mode the mapper's beside them.

Usage:
    python -m amcslam_tpu_torch.examples.multicam_amv <config.yaml> [--seq N]
        [--out DIR] [--no-realtime] [--max-frames N] [--device cuda|cpu]
        [--backend host|device] [--trace-out PATH]

The System runs on `--device` (default cuda: without a card it raises;
`--device cpu` asks for the host).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..frontend.features import build_frame, make_extractors
from ..pipeline.config import load_config
from ..pipeline.system import System
from ..pipeline.tracking import resolve_device
from ..utils.io import load_amv_images, read_png_gray
from ..utils.timing import GLOBAL_TIMER


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the System and the device ORB (default cuda)")
    ap.add_argument("--backend", choices=("host", "device"), default=None,
                    help="ORB backend (default: AMCSLAM_ORB_BACKEND, else host)")
    ap.add_argument("--trace-out", default=None,
                    help="write the stage spans to this path as Chrome trace-event JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    rig = cfg.rig
    n_cams = rig.n_cams
    ticks, stamps = load_amv_images(cfg.dataset_path, n_cams)
    if args.max_frames:
        ticks, stamps = ticks[: args.max_frames], stamps[: args.max_frames]
    print(f"{len(ticks)} ticks, {n_cams} cameras")

    extractors = make_extractors(n_cams, cfg.n_features, args.backend, device=device)
    slam = System(rig, cfg.tracking, enable_loop_closing=cfg.loop_closing,
                  b_extrinsic=cfg.extrinsic_refine, device=device)

    track_times = []
    t_wall0 = time.time()
    for k, (paths, ts) in enumerate(zip(ticks, stamps)):
        if not all(os.path.isfile(p) for p in paths[:-1]):
            print(f"missing image at tick {k}; skipping")
            continue
        imgs = [read_png_gray(p) for p in paths[:-1]]
        right = read_png_gray(paths[-1])
        with GLOBAL_TIMER.span("frame_total"):
            frame = build_frame(imgs, ts, rig, extractors, right_image=right, device=device)
            t0 = time.time()
            slam.track_multicamera(frame)
            track_times.append(time.time() - t0)
        if not args.no_realtime and k + 1 < len(ticks):
            lag = (stamps[k + 1][-1] - ts[-1]) - (time.time() - t_wall0)
            if lag > 0:
                time.sleep(lag)

    tt = np.array(track_times)
    print(f"median tracking time: {np.median(tt)*1e3:.2f} ms")
    print(f"mean tracking time:   {np.mean(tt)*1e3:.2f} ms")
    GLOBAL_TIMER.print_stats()

    out = os.path.join(args.out, f"f_{args.seq}.txt")
    slam.save_trajectory_tum(out)
    kf_out = os.path.join(args.out, f"kf_{args.seq}.txt")
    slam.save_keyframe_trajectory_tum(kf_out)
    print(f"saved {out}, {kf_out}")
    slam.shutdown()
    if args.trace_out:
        n = GLOBAL_TIMER.write_trace(args.trace_out)
        print(f"wrote {n} spans to {args.trace_out}")


if __name__ == "__main__":
    main()
