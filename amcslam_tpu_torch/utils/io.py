"""Dataset IO (rebuild of System::LoadAmvImages, System.cc:1316-1400).

A copy of `amcslam_tpu/utils/io.py`, pinned to it in
tests/test_torch_pipeline_host.py.

AMV-Bench layout: per-camera timestamp files plus zero-padded 6-digit image
names; the first stereo timestamp anchors alignment. Also TUM-format
trajectory reading and ATE evaluation for the benchmark harness.
"""

from __future__ import annotations

import os

import numpy as np


def load_amv_images(dataset_path: str, n_cams: int, ext: str = ".png"):
    """Returns (image_paths: list per tick of [cam0..camN-1, right],
    timestamps: (T, n_cams) — per-camera times aligned to the stereo left).

    Mirrors LoadAmvImages: reads `cam{c}/times.txt` (or `timestamps.txt`),
    builds zero-padded 6-digit frame paths, aligns the async streams to the
    first stereo timestamp.
    """
    cam_times = []
    for c in range(n_cams):
        base = os.path.join(dataset_path, f"cam{c}")
        tfile = None
        for cand in ("times.txt", "timestamps.txt"):
            if os.path.exists(os.path.join(base, cand)):
                tfile = os.path.join(base, cand)
                break
        if tfile is None:
            raise FileNotFoundError(f"no timestamp file under {base}")
        cam_times.append(np.loadtxt(tfile))

    t0 = cam_times[-1][0]  # first stereo timestamp anchors the run
    ticks = []
    stamps = []
    idx = [int(np.searchsorted(ct, t0)) for ct in cam_times]
    n_ticks = len(cam_times[-1])
    for k in range(n_ticks):
        t_stereo = cam_times[-1][k]
        row_paths = []
        row_times = np.zeros(n_cams)
        ok = True
        for c in range(n_cams - 1):
            # latest async frame at or before the stereo time
            j = int(np.searchsorted(cam_times[c], t_stereo, side="right")) - 1
            if j < 0:
                ok = False
                break
            row_times[c] = cam_times[c][j]
            row_paths.append(
                os.path.join(dataset_path, f"cam{c}", f"{j:06d}{ext}")
            )
        if not ok:
            continue
        row_times[-1] = t_stereo
        row_paths.append(os.path.join(dataset_path, f"cam{n_cams-1}", f"{k:06d}{ext}"))
        row_paths.append(
            os.path.join(dataset_path, f"cam{n_cams-1}_right", f"{k:06d}{ext}")
        )
        ticks.append(row_paths)
        stamps.append(row_times)
    return ticks, np.stack(stamps) if stamps else np.zeros((0, n_cams))


def read_tum(path: str):
    """(T,) times, (T,4,4) poses from a TUM trajectory file."""
    from scipy.spatial.transform import Rotation

    rows = np.loadtxt(path).reshape(-1, 8)
    Ts = np.tile(np.eye(4), (len(rows), 1, 1))
    Ts[:, :3, :3] = Rotation.from_quat(rows[:, 4:]).as_matrix()
    Ts[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], Ts


def ate_rmse(est_t, est_T, gt_t, gt_T, align: bool = True):
    """Absolute trajectory error (RMSE of translation) with optional SE(3)
    alignment (Horn), after nearest-timestamp association."""
    idx = np.searchsorted(gt_t, est_t)
    idx = np.clip(idx, 0, len(gt_t) - 1)
    P_est = est_T[:, :3, 3]
    P_gt = gt_T[idx, :3, 3]
    if align and len(P_est) >= 3:
        mu_e, mu_g = P_est.mean(0), P_gt.mean(0)
        E, G = P_est - mu_e, P_gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        R = (U @ D @ Vt).T
        P_est = (P_est - mu_e) @ R.T + mu_g
    err = np.linalg.norm(P_est - P_gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), err
