"""Two-view DLT triangulation (GeometricTools.cc Triangulate).

Port of `triangulate_dlt` from `amcslam_tpu/frontend/cameras.py:151-172`,
the only camera function on the mapping path; the rest of that module (the
KB8 lift and the image frontend) belongs to a later slice. The reference is
per point and batched by `jax.vmap`; this version is batched over N: one
`torch.linalg.svd` of the (N,4,4) systems on their device.
"""

from __future__ import annotations

import torch


def triangulate_dlt(ray1, ray2, Tcw1, Tcw2):
    """DLT triangulation of normalized rays under two world-to-camera poses.

    ray1/ray2 (N,3) normalized rays (x, y, 1), Tcw1/Tcw2 (N,4,4). Builds the
    4x4 linear systems rows x_i * P_i[2] - P_i[0] etc. and takes the
    smallest singular vector. Returns the Euclidean points X (N,3) and the
    homogeneous scales w (N,) (|w| small => at infinity). The null vector's
    sign is arbitrary (LAPACK, XLA and cuSOLVER each pick one); X does not
    depend on it and callers use |w| only."""
    P1 = Tcw1[:, :3, :]
    P2 = Tcw2[:, :3, :]
    A = torch.stack(
        [
            ray1[:, 0:1] * P1[:, 2] - P1[:, 0],
            ray1[:, 1:2] * P1[:, 2] - P1[:, 1],
            ray2[:, 0:1] * P2[:, 2] - P2[:, 0],
            ray2[:, 1:2] * P2[:, 2] - P2[:, 1],
        ],
        dim=1,
    )
    _, _, Vh = torch.linalg.svd(A)
    Xh = Vh[:, -1]
    w = Xh[:, 3]
    X = Xh[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))[:, None]
    return X, w
