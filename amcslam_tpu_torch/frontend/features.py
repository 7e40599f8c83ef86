"""Feature front-end (rebuild of src/ORBextractor.cc + Frame construction).

Port of `amcslam_tpu/frontend/features.py`. Extraction runs on one of two
backends: "host", the numpy/native ORB of frontend/orb.py fanned out over a
thread pool per camera (the reference's OpenMP axis, Frame.cc:213-227), or
"device", frontend/orb_device.py, the whole rig in one batched pass on the
extractor's device (the counterpart of the reference's "tpu" backend).
Keypoints are undistorted when the rig carries distortion coefficients
(Frame.cc:697-737) and lifted to the rectified-pinhole plane for KB8
cameras; stereo depth comes from row-banded Hamming matching
(`ComputeStereoMatches`, Frame.cc:763ff).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..pipeline.map_store import Frame
from ..pipeline.matcher import hamming
from ..pipeline.rig import Rig
from .cameras import rectify_kb8_points
from .orb import OrbPipeline, undistort_points
from .orb_device import ORBExtractorDevice


class ORBExtractor:
    """Per-camera host ORB with the reference's defaults (ORBextractor.h:44-112):
    8-level pyramid, scale 1.2, FAST ini/min thresholds 20/7, per-camera
    feature budgets (SetNum, ORBextractor.h:61)."""

    def __init__(self, n_features=1200, scale_factor=1.2, n_levels=8,
                 ini_th_fast=20, min_th_fast=7):
        self._orb = OrbPipeline(
            n_features=n_features, scale_factor=scale_factor,
            n_levels=n_levels, ini_th=ini_th_fast, min_th=min_th_fast,
        )
        self.n_features = n_features

    def set_num(self, n: int):
        self.n_features = n
        self._orb.set_num(n)

    def extract(self, image: np.ndarray):
        """-> (keypoints (N,2), octaves (N,), descriptors (N,32),
        angles (N,) rad)."""
        return self._orb.extract(np.asarray(image))


def make_extractors(n: int, n_features=1200, backend: str | None = None, *,
                    device="cuda", **kw) -> list:
    """The per-camera extractor bank with a selectable backend:

    - "host" (default): frontend/orb.py — the native C++ path when g++ is
      present, its numpy oracle otherwise; one thread per camera.
    - "device": frontend/orb_device.py on `device` — the whole rig in one
      batched pass. A CUDA device that is not present raises.

    Resolution order: explicit arg > AMCSLAM_ORB_BACKEND env > "host".
    `device` is used by the device backend only."""
    backend = backend or os.environ.get("AMCSLAM_ORB_BACKEND", "host")
    if backend == "device":
        return [ORBExtractorDevice(n_features=n_features, device=device, **kw)
                for _ in range(n)]
    if backend != "host":
        raise ValueError(f"unknown ORB backend {backend!r} (host or device)")
    return [ORBExtractor(n_features=n_features, **kw) for _ in range(n)]


def stereo_match_depth(kp_l, desc_l, kp_r, desc_r, bf: float, row_tol: float = 2.0,
                       max_dist: int = 60, min_disp: float = 0.1, *, device):
    """Row-banded stereo matching -> (ur, depth) per left keypoint
    (MultiFrame::ComputeStereoMatches). The Hamming table is the native
    popcount's, or the torch bit-plane product on `device` without g++."""
    n, m = len(kp_l), len(kp_r)
    if n == 0 or m == 0:
        return -np.ones(n), -np.ones(n)
    D = hamming(desc_l, desc_r, device)
    row_ok = np.abs(kp_l[:, 1:2] - kp_r[None, :, 1]) <= row_tol
    disp = kp_l[:, 0:1] - kp_r[None, :, 0]
    disp_ok = disp > min_disp
    D = np.where(row_ok & disp_ok, D, 1 << 30)
    best = np.argmin(D, axis=1)
    bestd = D[np.arange(n), best]
    ok = bestd <= max_dist
    ur = np.where(ok, kp_r[best, 0], -1.0)
    depth = np.where(ok, bf / np.maximum(kp_l[:, 0] - ur, 1e-6), -1.0)
    depth = np.where(ok & (depth > 0), depth, -1.0)
    ur = np.where(depth > 0, ur, -1.0)
    return ur, depth


def build_frame(images: list[np.ndarray], timestamps: np.ndarray, rig: Rig,
                extractors: list, right_image: np.ndarray | None = None, *,
                device) -> Frame:
    """MultiFrame construction (Frame.cc:179-281): extraction, undistortion,
    the KB8 lift and stereo depth; `images` holds the N async + left-stereo
    images, `right_image` the stereo right. `device` runs the KB8 lift (and
    the stereo Hamming table without g++).

    When every extractor is the device backend with one feature budget and
    all images share one shape, the whole rig (async cameras + stereo left
    + stereo right) extracts in a single batched pass; otherwise one thread
    per image extracts."""
    all_imgs = list(images) + ([right_image] if right_image is not None else [])
    batched = (
        all(isinstance(e, ORBExtractorDevice) for e in extractors)
        and len({e.n_features for e in extractors}) == 1
        and len({np.asarray(im).shape for im in all_imgs}) == 1
    )
    if batched:
        xys, octs_b, descs_b, angs_b = extractors[-1].extract_batch(
            np.stack([np.asarray(im) for im in all_imgs]))
        results = list(zip(xys, octs_b, descs_b, angs_b))[: len(images)]
        right = (tuple(z[len(images)] for z in (xys, octs_b, descs_b, angs_b))
                 if right_image is not None else None)
    else:
        with ThreadPoolExecutor(max_workers=len(images) + 1) as pool:
            futs = [pool.submit(extractors[c].extract, images[c]) for c in range(len(images))]
            fut_r = (pool.submit(extractors[-1].extract, right_image)
                     if right_image is not None else None)
            results = [f.result() for f in futs]
            right = fut_r.result() if fut_r is not None else None

    kps = [r[0] for r in results]
    octs = [r[1] for r in results]
    descs = [r[2] for r in results]
    angs = [r[3] for r in results]
    # the reference's literal 1 for KB8 (features.py:156; ROADMAP §3)
    kb8_cams = (set(np.nonzero(np.asarray(rig.cam_model) == 1)[0].tolist())
                if rig.cam_model is not None else set())
    if rig.dist is not None:
        # radtan undistort — but NOT for KB8 cameras: their distortion lives
        # in the camera model (Frame.cc:697-707), so both would double-correct
        kps = [undistort_points(kps[c], rig.K[c], rig.dist[c])
               if len(kps[c]) and c not in kb8_cams else kps[c]
               for c in range(len(kps))]
    kp_s2 = None
    if kb8_cams:
        # lift raw fisheye detections onto the rectified pinhole plane; drop
        # those beyond the lift's validity limit and carry the lift's
        # variance inflation (cameras.rectify_kb8_points)
        kp_s2 = [None] * len(kps)
        for c in sorted(kb8_cams):
            if not len(kps[c]):
                continue
            pts, valid, s2 = rectify_kb8_points(rig.kb8_params[c], kps[c], return_aux=True,
                                                device=device)
            kps[c] = pts[valid]
            octs[c] = octs[c][valid]
            descs[c] = descs[c][valid]
            angs[c] = angs[c][valid]
            kp_s2[c] = s2[valid]
    ur = depth = None
    if right is not None:
        ur, depth = stereo_match_depth(kps[-1], descs[-1], right[0], right[2], rig.bf,
                                       device=device)
    return Frame(
        timestamp=float(timestamps[-1]),
        cam_times=np.asarray(timestamps, float),
        Twb=np.eye(4),
        velocity=np.zeros(6),
        keypoints=kps,
        kp_octaves=octs,
        descriptors=descs,
        kp_ur=ur,
        kp_depth=depth,
        kp_angles=angs,
        kp_sigma2_scale=kp_s2,
    )
