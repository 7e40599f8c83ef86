"""Feature matching (rebuild of src/ORBmatcher.cc, multi-camera variants).

Port of `amcslam_tpu/pipeline/matcher.py`. The native C++ matcher (the
reference's own `native/graph_builder.cpp`, built by `..native`) stays the
primary path, as in the reference. The reference's JAX popcount fallback
(`hamming_table`, `_match_reduce`) becomes a torch bit-plane product on the
caller's device: with bits b1, b2 in {0,1}, popcount(a XOR b) =
sum(b1) + sum(b2) - 2 b1.b2, one float32 matmul. The package keeps TF32 off,
so the product is exact (sums of 0/1 up to 256). It serves tables above the
native size cap and runs without a C++ compiler.

Provided searches (multi-camera aware, SURVEY.md §2.7):
  * match_descriptors        — mutual-best with ratio + absolute threshold,
                               optional rotation-histogram consistency
  * search_by_projection     — map points -> frame through each camera's
                               GP-interpolated pose with pixel window
                               (ORBmatcher.cc:43, :1439)
  * search_by_projection_frustum — the local-map search with the full
                               frustum gates (Frame.cc:463-530)
  * search_for_triangulation — epipolar-gated matching between keyframes,
                               optional rotation-histogram consistency
  * search_by_sim3           — Sim3-guided densification (loop closing)
  * rotation_consistency     — the reference's rotHist filter
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..utils.timing import GLOBAL_TIMER

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
_BIG = 1 << 30
_NATIVE_TABLE_MAX = 1 << 25  # entries of the largest table built natively


def _bits(desc_u8: np.ndarray, device) -> torch.Tensor:
    """(N,32) uint8 -> (N,256) float32 bit planes (MSB first, as
    np.unpackbits) on `device`."""
    d = torch.as_tensor(np.ascontiguousarray(desc_u8, np.uint8), device=device)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], -1).to(torch.float32)


def hamming_table(d1: np.ndarray, d2: np.ndarray, device=None) -> torch.Tensor:
    """(N,32)x(M,32) uint8 -> (N,M) int32 Hamming distances on `device`."""
    b1, b2 = _bits(d1, device), _bits(d2, device)
    dot = b1 @ b2.T
    return (b1.sum(1, keepdim=True) + b2.sum(1)[None, :] - 2.0 * dot).to(torch.int32)


def match_reduce(d1: np.ndarray, d2: np.ndarray, device=None):
    """Hamming table + nearest/second-nearest reduction on `device`; only
    O(N+M) vectors come back (one host copy). Returns numpy (best_j (N,),
    best_d (N,), second_d (N,), col_best (M,)); ties take the first index,
    as the native reduction does."""
    D = hamming_table(d1, d2, device)
    best_d, best_j = D.min(dim=1)
    D2 = D.clone()
    D2[torch.arange(D.shape[0], device=D.device), best_j] = _BIG
    second_d = D2.min(dim=1).values
    col_best = D.argmin(dim=0)
    n = D.shape[0]
    with GLOBAL_TIMER.span("host.read"):
        out = torch.cat([best_j, best_d.long(), second_d.long(), col_best]).cpu().numpy()
    return out[:n], out[n:2 * n].astype(np.int32), out[2 * n:3 * n].astype(np.int32), out[3 * n:]


def hamming(d1: np.ndarray, d2: np.ndarray, device=None) -> np.ndarray:
    """Host-facing Hamming table: native C++ popcount for tables up to 2^25
    entries, the torch bit-plane product on `device` beyond that (or without
    a C++ compiler)."""
    n, m = len(d1), len(d2)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.int32)
    if native.available() and n * m <= _NATIVE_TABLE_MAX:
        return native.hamming_matrix(d1, d2)
    table = hamming_table(d1, d2, device)
    with GLOBAL_TIMER.span("host.read"):
        return table.cpu().numpy()


def rotation_consistency(idx: np.ndarray, ang1: np.ndarray, ang2: np.ndarray,
                         n_bins: int = HISTO_LENGTH, n_keep: int = 3):
    """Reject matches whose keypoint-angle difference disagrees with the
    dominant image rotation: histogram the differences into `n_bins` and
    keep only the `n_keep` most-populated bins (ComputeThreeMaxima +
    rotHist, ORBmatcher.cc). `idx` is a per-idx1 match array (-1 = none);
    returns a filtered copy."""
    idx = np.asarray(idx)
    valid = idx >= 0
    if valid.sum() < 3:
        return idx
    d = np.degrees(
        np.asarray(ang1)[valid] - np.asarray(ang2)[idx[valid]]
    ) % 360.0
    bins = np.minimum((d * n_bins / 360.0).round().astype(int), n_bins - 1) % n_bins
    counts = np.bincount(bins, minlength=n_bins)
    order = np.argsort(-counts)
    keep_bins = {int(order[0])}
    # the reference drops bins 2/3 when much smaller than the best
    if counts[order[1]] > 0.1 * counts[order[0]] and n_keep >= 2:
        keep_bins.add(int(order[1]))
    if counts[order[2]] > 0.1 * counts[order[0]] and n_keep >= 3:
        keep_bins.add(int(order[2]))
    ok = np.isin(bins, list(keep_bins))
    out = idx.copy()
    bad_pos = np.where(valid)[0][~ok]
    out[bad_pos] = -1
    return out


def match_descriptors(
    d1: np.ndarray,
    d2: np.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    mutual: bool = True,
    ang1: np.ndarray | None = None,
    ang2: np.ndarray | None = None,
    device=None,
):
    """Mutual-best Hamming matching with Lowe ratio (SearchByBoW-style
    gating without the vocabulary buckets). When keypoint angles are given,
    the rotation-histogram consistency filter applies (ORBmatcher.cc
    mbCheckOrientation). Returns (idx2 per idx1, -1 none)."""
    if len(d1) == 0 or len(d2) == 0:
        return -np.ones(len(d1), np.int64)
    n = len(d1)
    if native.available():
        # fused native reduction: no (N,M) table, threaded over rows
        best2, bestd, second = native.hamming_best(d1, d2)
        best1 = native.hamming_best(d2, d1)[0] if mutual else None
    else:
        best2, bestd, second, best1 = match_reduce(d1, d2, device)
    ok = (bestd <= max_dist) & (bestd <= ratio * second)
    if mutual:
        ok &= best1[best2] == np.arange(n)
    out = np.where(ok, best2, -1).astype(np.int64)
    if ang1 is not None and ang2 is not None:
        out = rotation_consistency(out, ang1, ang2)
    return out


def search_by_projection(
    mp_positions: np.ndarray,     # (M,3) world
    mp_descriptors: np.ndarray,   # (M,32)
    kp: np.ndarray,               # (N,2) frame keypoints (one camera)
    kp_desc: np.ndarray,          # (N,32)
    kp_octave: np.ndarray,        # (N,)
    Tcw: np.ndarray,              # (4,4) world-to-camera at this camera's time
    K: np.ndarray,                # (4,)
    radius: float = 7.0,
    max_dist: int = TH_HIGH,
    scale_factors: np.ndarray | None = None,
    device=None,
):
    """Project map points into one camera and match within a pixel window
    (ORBmatcher::SearchByProjection core, per camera c of the multi-camera
    loop ORBmatcher.cc:1458ff). Returns (match kp index per map point, -1)."""
    M = len(mp_positions)
    if M == 0 or len(kp) == 0:
        return -np.ones(M, np.int64)
    Xc = mp_positions @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Xc[:, 2]
    u = K[0] * Xc[:, 0] / np.maximum(z, 1e-9) + K[2]
    v = K[1] * Xc[:, 1] / np.maximum(z, 1e-9) + K[3]
    vis = z > 0.1

    if scale_factors is not None:
        kp_r = radius * scale_factors[kp_octave]
    else:
        kp_r = np.full(len(kp), float(radius))

    if native.available():
        # sorted-u window walk in C++: O(M log N + M*k) instead of the
        # O(M*N) mask + table
        zeros = np.zeros(M, np.float32)
        best, _ = native.match_window(
            u, v, vis, zeros, np.zeros(M, np.int32),
            np.full(M, 1 << 20, np.int32), zeros, mp_descriptors,
            kp[:, 0], kp[:, 1], kp_octave, kp_r, np.full(len(kp), -1.0),
            kp_desc, max_dist, ratio=0.0, use_pt_radius=False,
        )
        return best

    du = np.abs(u[:, None] - kp[None, :, 0])
    dv = np.abs(v[:, None] - kp[None, :, 1])
    r = kp_r[None, :]
    admissible = (du <= r) & (dv <= r) & vis[:, None]

    D = hamming(mp_descriptors, kp_desc, device)
    D = np.where(admissible, D, _BIG)
    best = np.argmin(D, axis=1)
    bestd = D[np.arange(M), best]
    return np.where(bestd <= max_dist, best, -1).astype(np.int64)


def search_by_projection_frustum(
    mp_positions: np.ndarray,     # (M,3) world
    mp_descriptors: np.ndarray,   # (M,32)
    mp_normals: np.ndarray,       # (M,3) mean viewing directions (0 = none)
    mp_min_dist: np.ndarray,      # (M,) scale-invariance range
    mp_max_dist: np.ndarray,      # (M,)
    kp: np.ndarray,               # (N,2) frame keypoints (one camera)
    kp_desc: np.ndarray,          # (N,32)
    kp_octave: np.ndarray,        # (N,)
    Tcw: np.ndarray,              # (4,4) world-to-camera at this camera's time
    K: np.ndarray,                # (4,)
    scale_factor: float = 1.2,
    n_levels: int = 8,
    th: float = 1.0,
    view_cos_limit: float = 0.5,
    max_dist: int = TH_HIGH,
    ratio: float = 0.8,
    kp_ur: np.ndarray | None = None,  # (N,) stereo right-u (<0 = mono)
    bf: float = 0.0,
    device=None,
):
    """Frustum-gated local-map projection search: the vectorized form of
    MultiFrame::isInFrustum (Frame.cc:463-530) + ORBmatcher::SearchByProjection
    (ORBmatcher.cc:43-147):

      * positive depth + scale-invariance distance range [minDist, maxDist]
      * viewing-cone check  cos(angle(P-Ow, normal)) >= 0.5
      * predicted octave from dist (MapPoint::PredictScale) -> the search
        window is r(viewCos) * scaleFactor^level px with r = 2.5 if
        viewCos > 0.998 else 4.0, and only keypoints in octave
        [level-1, level] are admissible
      * stereo right-u gate when the candidate keypoint has a disparity
      * Lowe ratio applied only when best/second share the octave

    Returns (match kp index per map point (-1 none), in_frustum mask (M,))."""
    M = len(mp_positions)
    if M == 0:
        return -np.ones(0, np.int64), np.zeros(0, bool)
    Xc = mp_positions @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Xc[:, 2]
    u = K[0] * Xc[:, 0] / np.maximum(z, 1e-9) + K[2]
    v = K[1] * Xc[:, 1] / np.maximum(z, 1e-9) + K[3]

    # camera center and viewing geometry (world frame)
    Ow = -Tcw[:3, :3].T @ Tcw[:3, 3]
    PO = mp_positions - Ow
    dist = np.linalg.norm(PO, axis=1)
    have_range = mp_max_dist > 0
    dist_ok = np.where(
        have_range,
        (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist),
        True,
    )
    have_normal = np.linalg.norm(mp_normals, axis=1) > 1e-6
    view_cos = np.where(
        have_normal,
        np.einsum("md,md->m", PO, mp_normals)
        / np.maximum(dist * np.linalg.norm(mp_normals, axis=1), 1e-9),
        1.0,
    )
    in_frustum = (z > 0.1) & dist_ok & (view_cos >= view_cos_limit)

    # predicted scale level (MapPoint::PredictScale, MapPoint.cc:722-737)
    ratio_d = np.where(
        have_range & (dist > 1e-9), mp_max_dist / np.maximum(dist, 1e-9), 1.0
    )
    level = np.ceil(np.log(np.maximum(ratio_d, 1e-9)) / np.log(scale_factor))
    level = np.clip(level, 0, n_levels - 1).astype(int)

    if len(kp) == 0:
        return -np.ones(M, np.int64), in_frustum

    # radius by viewing direction (ORBmatcher::RadiusByViewingCos)
    r = np.where(view_cos > 0.998, 2.5, 4.0) * th
    r = r * scale_factor ** level  # (M,)

    use_ur = kp_ur is not None and bf > 0
    ur_pred = (
        u - bf / np.maximum(z, 1e-9) if use_ur else np.zeros(M, np.float32)
    )

    if native.available():
        lvl_lo = np.where(have_range, level - 1, 0).astype(np.int32)
        lvl_hi = np.where(have_range, level, n_levels).astype(np.int32)
        best, _ = native.match_window(
            u, v, in_frustum, r, lvl_lo, lvl_hi, ur_pred, mp_descriptors,
            kp[:, 0], kp[:, 1], kp_octave, np.zeros(len(kp), np.float32),
            kp_ur if use_ur else np.full(len(kp), -1.0), kp_desc,
            max_dist, ratio=ratio, use_pt_radius=True, use_ur=use_ur,
        )
        return best, in_frustum

    du = np.abs(u[:, None] - kp[None, :, 0])
    dv = np.abs(v[:, None] - kp[None, :, 1])
    # points without distance-range info (max_dist unset) cannot predict a
    # scale level — skip their octave gate rather than forcing level 0
    oct_ok = (kp_octave[None, :] >= (level[:, None] - 1)) & (
        kp_octave[None, :] <= level[:, None]
    ) | ~have_range[:, None]
    admissible = (
        (du <= r[:, None]) & (dv <= r[:, None]) & oct_ok & in_frustum[:, None]
    )
    if use_ur:
        has_ur = kp_ur[None, :] > 0
        ur_ok = ~has_ur | (
            np.abs(ur_pred[:, None] - kp_ur[None, :]) <= r[:, None]
        )
        admissible &= ur_ok

    D = hamming(mp_descriptors, kp_desc, device)
    D = np.where(admissible, D, _BIG)
    if D.shape[1] > 1:
        # top-2 via argpartition: O(NM) instead of the full-row argsort
        top2 = np.argpartition(D, 1, axis=1)[:, :2]
        d2v = np.take_along_axis(D, top2, 1)
        swap = d2v[:, 0] > d2v[:, 1]
        best = np.where(swap, top2[:, 1], top2[:, 0])
        second = np.where(swap, top2[:, 0], top2[:, 1])
        bestd = np.where(swap, d2v[:, 1], d2v[:, 0])
        secondd = np.where(swap, d2v[:, 0], d2v[:, 1])
        same_level = kp_octave[best] == kp_octave[second]
        ratio_ok = ~same_level | (bestd <= ratio * secondd)
    else:
        best = np.zeros(M, np.int64)
        bestd = D[:, 0]
        ratio_ok = np.ones(M, bool)
    ok = (bestd <= max_dist) & ratio_ok
    return np.where(ok, best, -1).astype(np.int64), in_frustum


def search_by_sim3(
    Xb1: np.ndarray, cams1: np.ndarray, uvs1: np.ndarray, d1: np.ndarray,
    Xb2: np.ndarray, cams2: np.ndarray, uvs2: np.ndarray, d2: np.ndarray,
    s12: float, R12: np.ndarray, t12: np.ndarray,
    Tcb: np.ndarray, K: np.ndarray,
    radius: float = 7.5, max_dist: int = TH_HIGH, device=None,
):
    """Sim3-guided match densification (ORBmatcher::SearchBySim3): given a
    candidate Sim3 aligning KF2 body coords into KF1 body coords, admit a
    (i, j) pair only when point j lands within `radius` px of point i's
    MEASURED keypoint through i's own camera — and symmetrically for i
    through j's camera under the inverse Sim3. Inputs are per-KF observation
    records (body-frame positions, observing camera ids, measured pixels,
    descriptors); returns idx2 per idx1 (-1 none), mutual-best.
    """
    n1, n2 = len(Xb1), len(Xb2)
    if n1 == 0 or n2 == 0:
        return -np.ones(n1, np.int64)
    cams1 = np.asarray(cams1, int)
    cams2 = np.asarray(cams2, int)

    def _project(Xb, cams_obs):
        """Project body-frame points through the camera of EACH observation:
        returns (n_obs, n_pts, 2) pixels + (n_obs, n_pts) depth."""
        Rc = Tcb[cams_obs, :3, :3]
        tc = Tcb[cams_obs, :3, 3]
        Xc = np.einsum("oij,pj->opi", Rc, Xb) + tc[:, None, :]
        z = Xc[..., 2]
        f = K[cams_obs]
        u = f[:, 0:1] * Xc[..., 0] / np.maximum(z, 1e-9) + f[:, 2:3]
        v = f[:, 1:2] * Xc[..., 1] / np.maximum(z, 1e-9) + f[:, 3:4]
        return np.stack([u, v], -1), z

    # KF2 points into KF1 body coords, projected through each obs1 camera
    Y2in1 = s12 * Xb2 @ R12.T + t12
    px21, z21 = _project(Y2in1, cams1)         # (n1, n2, 2)
    err21 = np.linalg.norm(px21 - uvs1[:, None, :], axis=-1)
    ok21 = (z21 > 0.1) & (err21 <= radius)
    # KF1 points into KF2 body coords (inverse Sim3), through obs2 cameras
    X1in2 = (Xb1 - t12) @ R12 / max(s12, 1e-12)
    px12, z12 = _project(X1in2, cams2)          # (n2, n1, 2)
    err12 = np.linalg.norm(px12 - uvs2[:, None, :], axis=-1)
    ok12 = (z12 > 0.1) & (err12 <= radius)

    admissible = ok21 & ok12.T
    D = hamming(d1, d2, device)
    D = np.where(admissible, D, _BIG)
    best2 = np.argmin(D, axis=1)
    bestd = D[np.arange(n1), best2]
    best1 = np.argmin(D, axis=0)
    ok = (bestd <= max_dist) & (best1[best2] == np.arange(n1))
    return np.where(ok, best2, -1).astype(np.int64)


def search_for_triangulation(
    kp1: np.ndarray, d1: np.ndarray, kp2: np.ndarray, d2: np.ndarray,
    F12: np.ndarray, max_dist: int = TH_LOW, epi_th: float = 3.84,
    ang1: np.ndarray | None = None, ang2: np.ndarray | None = None,
    device=None,
):
    """Epipolar-constrained matching between two keyframes
    (ORBmatcher::SearchForTriangulation, ORBmatcher.cc:947), with the
    rotation-histogram filter when keypoint angles are given. Returns idx2
    per idx1 (-1 none)."""
    if len(kp1) == 0 or len(kp2) == 0:
        return -np.ones(len(kp1), np.int64)
    x1 = np.concatenate([kp1, np.ones((len(kp1), 1))], 1)
    x2 = np.concatenate([kp2, np.ones((len(kp2), 1))], 1)
    lines2 = x1 @ F12.T  # epipolar lines of kp1 in image 2
    num = lines2 @ x2.T
    den = np.maximum(lines2[:, 0] ** 2 + lines2[:, 1] ** 2, 1e-12)[:, None]
    d_epi2 = num * num / den
    admissible = d_epi2 < epi_th
    D = hamming(d1, d2, device)
    D = np.where(admissible, D, _BIG)
    best = np.argmin(D, axis=1)
    bestd = D[np.arange(len(kp1)), best]
    # mutual check
    best1 = np.argmin(np.where(admissible, D, _BIG), axis=0)
    ok = (bestd <= max_dist) & (best1[best] == np.arange(len(kp1)))
    out = np.where(ok, best, -1).astype(np.int64)
    if ang1 is not None and ang2 is not None:
        out = rotation_consistency(out, ang1, ang2)
    return out
