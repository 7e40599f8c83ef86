"""Stage profile of the device ORB extractor (frontend/orb_device.py) on one
rig tick.

Port of `examples/profile_orb_tpu.py`: each stage of the per-level pipeline
runs as its own program over every pyramid level of one tick (the order and
inputs of `build_orb_device`): the pyramid resize, FAST (both thresholds),
NMS and the cell logic, the top-K, orientation, the 7x7 blur and the
rotated-BRIEF gathers; then the full batched extractor. For each stage:
the time per tick (CUDA events behind a sync on a card: `device_ms`; the
host clock on the CPU: `cpu_ms`), its kernel launches (torch.profiler, on
a card only) and its share of the full extractor's time.

    python -m amcslam_tpu_torch.examples.profile_orb_device [--device cuda|cpu]

The tick is 12a's of chip_smoke.py: the seed-1 corridor of
`e2e_rendered`, the AMV rig (5 async cameras + the stereo pair, 7 images,
640x480). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..frontend import orb_device as od
from ..frontend.orb import _BRIEF, _PATCH_OFF
from ..pipeline.tracking import resolve_device

STAGES = ("resize", "fast", "nms_cells", "top_k", "orientation", "blur", "brief")


def rig_tick(seed: int = 1, n_async: int = 5) -> np.ndarray:
    """(n_async + 2, 480, 640) uint8: frame 0 of the `e2e_rendered` corridor
    of `seed` through the AMV rig's cameras and the stereo pair's right
    camera, rendered on the host."""
    from . import e2e_rendered as e2e

    planes = e2e.make_world(seed)
    rig = e2e.make_rig(n_async)
    cam_t = rig.cam_times(0.0)
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    views = ([e2e.gt_pose(cam_t[c]) @ rig.Tbc[c] for c in range(rig.n_cams)]
             + [e2e.gt_pose(0.0) @ rig.Tbc[-1] @ Tright])
    with np.errstate(invalid="ignore"):
        return np.stack([e2e.render(T, planes) for T in views])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, device, n: int) -> float:
    """ms per call of fn over n calls after one warm-up: CUDA events on a
    card (the device's timeline between the first launch and the last
    kernel's end), the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def kernel_launches(fn, device, tries: int = 2) -> int | None:
    """CUDA kernels one call of fn launches (torch.profiler), the largest
    count of `tries` profiles: a short profile on the H100 once delivered
    no kernel activity at all. None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(tries):
        _sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(device)
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))))
    return max(counts)


def stage_programs(images: torch.Tensor, n_features: int, scale_factor: float = 1.2,
                   n_levels: int = 8, ini_th: int = 20, min_th: int = 7) -> dict:
    """Stage name -> a function running that stage over every level of the
    batch, on inputs the earlier stages computed once."""
    B, H, W = images.shape
    dev = images.device
    sizes = od._level_sizes(H, W, n_levels, scale_factor)
    budgets = od._budgets(n_features, n_levels, scale_factor)
    brief = torch.as_tensor(_BRIEF, device=dev).float()
    patch = torch.as_tensor(_PATCH_OFF, device=dev)
    levels = [images] + [od._resize_bilinear(images, h, w) for h, w in sizes[1:]]
    fast = [od._fast_masks_pair(img, ini_th, min_th) for img in levels]
    cand = [od._candidates(*f) for f in fast]
    sel = [od._top_k(s, prio, k) for (s, prio), k in zip(cand, budgets)]
    ang = [od._orientation(img, ys, xs, patch) for img, (ys, xs, _, _) in zip(levels, sel)]
    blur = [od._gaussian_blur7(img) for img in levels]
    return {
        "resize": lambda: [od._resize_bilinear(images, h, w) for h, w in sizes[1:]],
        "fast": lambda: [od._fast_masks_pair(img, ini_th, min_th) for img in levels],
        "nms_cells": lambda: [od._candidates(*f) for f in fast],
        "top_k": lambda: [od._top_k(s, prio, k) for (s, prio), k in zip(cand, budgets)],
        "orientation": lambda: [od._orientation(img, ys, xs, patch)
                                for img, (ys, xs, _, _) in zip(levels, sel)],
        "blur": lambda: [od._gaussian_blur7(img) for img in levels],
        "brief": lambda: [od._brief(b, ys, xs, a, brief)
                          for b, (ys, xs, _, _), a in zip(blur, sel, ang)],
    }


def profile(images: np.ndarray, n_features: int = 1200, device="cuda", n_timed: int = 20) -> dict:
    """The stage profile of one tick `images` (B,H,W) uint8 on `device`."""
    dev = resolve_device(device)
    imgs = torch.as_tensor(images, device=dev)
    B, H, W = imgs.shape
    full = od.build_orb_device(H, W, n_features, device=dev)
    key = "device_ms" if dev.type == "cuda" else "cpu_ms"
    full_ms = _time_ms(lambda: full(imgs), dev, n_timed)
    stages = {}
    for name, fn in stage_programs(imgs, n_features).items():
        ms = _time_ms(fn, dev, n_timed)
        stages[name] = {key: ms, "launches": kernel_launches(fn, dev), "share": ms / full_ms}
    return {"profile": "orb_device", "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu", "images": B, "shape": [H, W],
            "n_features": n_features, "timed": n_timed,
            "full": {key: full_ms, "launches": kernel_launches(lambda: full(imgs), dev)},
            "stages": stages, "stages_share_sum": sum(s["share"] for s in stages.values())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)  # before rendering: no card, no work
    out = profile(rig_tick(), device=dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
