"""From-scratch ORB extraction front-end (rebuild of src/ORBextractor.cc).

A copy of `amcslam_tpu/frontend/orb.py` (numpy only; tests/test_torch_orb.py
pins every table and function equal to the reference's). `OrbPipeline.extract`
dispatches to the port's native build of the same C++ source
(`csrc/orb_fast.cpp`, through `amcslam_tpu_torch.native`); with
`force_python=True`, or without g++, the numpy body below runs: it is the
oracle the native path equals bit for bit.

The reference extractor (ORBextractor.cc:410-1160) is a per-cell scalar
pipeline: an 8-level image pyramid, FAST-9/16 per 35px cell with an
initial/minimum threshold retry, quadtree redistribution to the per-level
budget (`DistributeOctTree`, :571), intensity-centroid orientation (:75-108),
a 7x7 sigma-2 Gaussian blur, and rotated-BRIEF descriptors; keypoints are
undistorted afterwards (Frame.cc:697-737).

This rebuild keeps the *behavioral contract* (same pyramid geometry, same
cell retry semantics, same quadtree budget policy, same descriptor length
and matching metric) but restructures every stage as whole-image vectorized
array programs:

  * FAST segment test: the 16 circle comparisons become a (16,H,W) boolean
    volume packed into a uint16 bitmask per pixel; "9 contiguous on the
    circle" is one lookup in a precomputed 65536-entry LUT. Two thresholds
    (ini/min) are two passes over the same volume, and the per-cell retry
    reduces to a masked selection — no per-cell FAST calls.
  * non-max suppression is a vectorized 3x3 max filter on the score map.
  * orientation / BRIEF sampling are batched gathers over all keypoints.

The BRIEF sampling pattern is generated from a fixed-seed Gaussian layout
(the original BRIEF construction) instead of transcribing the reference's
learned 256-pair table; descriptors are self-consistent across the whole
framework, which is what matching requires.
"""

from __future__ import annotations

import numpy as np

HALF_PATCH = 15
PATCH_SIZE = 31
EDGE_THRESHOLD = 19
CELL_W = 35


# ---------------------------------------------------------------------------
# FAST-9/16
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3 (16 points), clockwise from 12 o'clock.
_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int64,
)  # (dx, dy)


def _build_arc_lut(min_arc: int = 9) -> np.ndarray:
    """LUT over all 16-bit circle masks: does any circular run of >=min_arc
    consecutive set bits exist?"""
    masks = np.arange(1 << 16, dtype=np.uint32)
    # duplicate the circle so circular runs become linear runs
    ext = (masks.astype(np.uint64) << np.uint64(16)) | masks.astype(np.uint64)
    run = np.zeros(1 << 16, np.uint8)
    cur = np.zeros(1 << 16, np.uint8)
    for b in range(32):
        bit = ((ext >> np.uint64(b)) & np.uint64(1)).astype(np.uint8)
        cur = (cur + 1) * bit
        run = np.maximum(run, cur)
    return run >= min_arc


_ARC_LUT = _build_arc_lut(9)


def fast_detect(img: np.ndarray, threshold: int):
    """Vectorized FAST-9/16: -> (corner_mask (H,W) bool, score (H,W) int32).

    Score is the sum of absolute circle differences exceeding the threshold
    (the usual FAST ranking response), computed only where the segment test
    passes.
    """
    H, W = img.shape
    I = img.astype(np.int32)
    ok = np.zeros((H, W), bool)
    score = np.zeros((H, W), np.int32)
    if H <= 6 or W <= 6:
        return ok, score
    c = I[3:-3, 3:-3]
    bright = np.zeros((16,) + c.shape, bool)
    dark = np.zeros((16,) + c.shape, bool)
    diffs = np.zeros((16,) + c.shape, np.int32)
    for k, (dx, dy) in enumerate(_CIRCLE):
        p = I[3 + dy: H - 3 + dy, 3 + dx: W - 3 + dx]
        d = p - c
        diffs[k] = d
        bright[k] = d > threshold
        dark[k] = d < -threshold
    weights = (1 << np.arange(16, dtype=np.uint32))[:, None, None]
    mb = np.sum(bright.astype(np.uint32) * weights, axis=0)
    md = np.sum(dark.astype(np.uint32) * weights, axis=0)
    corner = _ARC_LUT[mb] | _ARC_LUT[md]
    a = np.abs(diffs)
    resp = np.sum(np.where(a > threshold, a - threshold, 0), axis=0)
    ok[3:-3, 3:-3] = corner
    score[3:-3, 3:-3] = np.where(corner, resp, 0)
    return ok, score


def _nms3(score: np.ndarray) -> np.ndarray:
    """3x3 non-max suppression mask (strict local maxima, ties broken by
    raster order like a sequential scan would)."""
    H, W = score.shape
    pad = np.full((H + 2, W + 2), -1, np.int64)
    pad[1:-1, 1:-1] = score
    center = pad[1:-1, 1:-1]
    keep = np.ones((H, W), bool)
    # earlier neighbors (raster order) must be strictly smaller; later ones <=
    for dy, dx, strict in [(-1, -1, True), (-1, 0, True), (-1, 1, True),
                           (0, -1, True), (0, 1, False), (1, -1, False),
                           (1, 0, False), (1, 1, False)]:
        nb = pad[1 + dy: H + 1 + dy, 1 + dx: W + 1 + dx]
        keep &= (center > nb) if strict else (center >= nb)
    return keep


# ---------------------------------------------------------------------------
# Quadtree distribution (DistributeOctTree semantics)
# ---------------------------------------------------------------------------


def distribute_quadtree(xy: np.ndarray, resp: np.ndarray, min_x, max_x,
                        min_y, max_y, budget: int) -> np.ndarray:
    """Keep <= budget keypoints, spatially uniform: recursively split the
    region into quads until there are >= budget leaf nodes (or no node holds
    more than one keypoint), then keep the best-response keypoint per node.
    Returns indices into xy."""
    n = len(xy)
    if n == 0:
        return np.zeros(0, np.int64)
    if n <= budget:
        return np.arange(n)
    n_ini = max(1, round((max_x - min_x) / max(max_y - min_y, 1)))
    hx = (max_x - min_x) / n_ini
    # node: (x0, x1, y0, y1, indices)
    nodes = []
    for i in range(n_ini):
        x0, x1 = min_x + i * hx, min_x + (i + 1) * hx
        sel = np.where((xy[:, 0] >= x0) & (xy[:, 0] < x1))[0]
        if len(sel):
            nodes.append((x0, x1, min_y, max_y, sel))
    while True:
        splittable = [i for i, nd in enumerate(nodes) if len(nd[4]) > 1]
        if not splittable or len(nodes) >= budget:
            break
        # split the most populated nodes first so the budget fills evenly
        splittable.sort(key=lambda i: -len(nodes[i][4]))
        new_nodes = [nd for i, nd in enumerate(nodes) if i not in set(splittable)]
        for pos, i in enumerate(splittable):
            x0, x1, y0, y1, sel = nodes[i]
            xm, ym = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
            pts = xy[sel]
            for qx0, qx1, qy0, qy1 in [(x0, xm, y0, ym), (xm, x1, y0, ym),
                                       (x0, xm, ym, y1), (xm, x1, ym, y1)]:
                m = ((pts[:, 0] >= qx0) & (pts[:, 0] < qx1)
                     & (pts[:, 1] >= qy0) & (pts[:, 1] < qy1))
                if m.any():
                    new_nodes.append((qx0, qx1, qy0, qy1, sel[m]))
            if len(new_nodes) >= budget:
                # enough granularity mid-sweep; keep the rest unsplit
                new_nodes.extend(nodes[j] for j in splittable[pos + 1:])
                break
        if len(new_nodes) == len(nodes):
            break
        nodes = new_nodes
    picks = [nd[4][np.argmax(resp[nd[4]])] for nd in nodes]
    picks = np.asarray(picks, np.int64)
    if len(picks) > budget:
        # stable so tie order is deterministic (and matches the native path)
        order = np.argsort(-resp[picks], kind="stable")
        picks = picks[order[:budget]]
    return picks


# ---------------------------------------------------------------------------
# Orientation + rBRIEF
# ---------------------------------------------------------------------------


def _circular_umax():
    """Per-row half-width of the radius-15 circular patch (symmetric, as the
    reference builds it for the intensity centroid, ORBextractor.cc:453-470)."""
    umax = np.zeros(HALF_PATCH + 1, np.int64)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH**2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


_UMAX = _circular_umax()
# flattened (dy, dx) offsets of the circular patch, for batched gathers
_PATCH_OFF = np.array(
    [(v, u)
     for v in range(-HALF_PATCH, HALF_PATCH + 1)
     for u in range(-int(_UMAX[abs(v)]), int(_UMAX[abs(v)]) + 1)],
    np.int64,
)


def orientations(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Intensity-centroid angle per keypoint (IC_Angle semantics)."""
    if len(xy) == 0:
        return np.zeros(0)
    I = img.astype(np.float64)
    ys = xy[:, 1].astype(np.int64)[:, None] + _PATCH_OFF[None, :, 0]
    xs = xy[:, 0].astype(np.int64)[:, None] + _PATCH_OFF[None, :, 1]
    ys = np.clip(ys, 0, img.shape[0] - 1)
    xs = np.clip(xs, 0, img.shape[1] - 1)
    vals = I[ys, xs]
    m01 = np.sum(vals * _PATCH_OFF[None, :, 0], axis=1)
    m10 = np.sum(vals * _PATCH_OFF[None, :, 1], axis=1)
    return np.arctan2(m01, m10)


def make_brief_pattern(n_pairs: int = 256, seed: int = 31):
    """(n_pairs, 4) int offsets (x1,y1,x2,y2), Gaussian-distributed within
    the 31px patch (the original BRIEF construction; the framework is
    self-consistent, so a learned table is not required)."""
    rng = np.random.RandomState(seed)
    sigma = PATCH_SIZE / 5.0
    pat = np.clip(np.round(rng.randn(n_pairs, 4) * sigma), -HALF_PATCH + 1,
                  HALF_PATCH - 1).astype(np.int64)
    return pat


_BRIEF = make_brief_pattern()


def brief_descriptors(img_blur: np.ndarray, xy: np.ndarray,
                      angles: np.ndarray) -> np.ndarray:
    """Rotated-BRIEF 256-bit descriptors -> (N, 32) uint8."""
    n = len(xy)
    if n == 0:
        return np.zeros((0, 32), np.uint8)
    ca, sa = np.cos(angles), np.sin(angles)
    px1, py1, px2, py2 = _BRIEF[:, 0], _BRIEF[:, 1], _BRIEF[:, 2], _BRIEF[:, 3]

    def rot(px, py):
        xs = np.round(ca[:, None] * px[None, :] - sa[:, None] * py[None, :])
        ys = np.round(sa[:, None] * px[None, :] + ca[:, None] * py[None, :])
        xs = np.clip(xy[:, 0:1] + xs, 0, img_blur.shape[1] - 1).astype(np.int64)
        ys = np.clip(xy[:, 1:2] + ys, 0, img_blur.shape[0] - 1).astype(np.int64)
        return img_blur[ys, xs]

    bits = rot(px1, py1) < rot(px2, py2)  # (N, 256)
    return np.packbits(bits, axis=1)


def gaussian_blur7(img: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Separable 7x7 Gaussian with reflect-101 borders (the blur applied
    before descriptor sampling, ORBextractor.cc:1149)."""
    r = 3
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img.astype(np.float64), r, mode="reflect")
    tmp = np.zeros_like(pad)
    for i, kv in enumerate(k):
        tmp[:, r:-r] += kv * pad[:, i: i + img.shape[1]]
    out = np.zeros_like(img, np.float64)
    for i, kv in enumerate(k):
        out += kv * tmp[i: i + img.shape[0], r:-r]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (pyramid construction)."""
    H, W = img.shape
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None]
    fx = np.clip(xs - x0, 0, 1)[None, :]
    I = img.astype(np.float64)
    out = (I[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
           + I[np.ix_(y0, x1)] * (1 - fy) * fx
           + I[np.ix_(y1, x0)] * fy * (1 - fx)
           + I[np.ix_(y1, x1)] * fy * fx)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# The extractor
# ---------------------------------------------------------------------------


class OrbPipeline:
    """Full ORB extraction pipeline with the reference's parameters
    (ORBextractor.h:44-112 defaults)."""

    def __init__(self, n_features=1200, scale_factor=1.2, n_levels=8,
                 ini_th=20, min_th=7):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th
        self.min_th = min_th
        self._per_level_budgets()

    def _per_level_budgets(self):
        # geometric budget split across levels (ORBextractor.cc:424-441)
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = []
        total = 0
        for lv in range(self.n_levels - 1):
            b = int(round(n0 * f**lv))
            budgets.append(b)
            total += b
        budgets.append(max(self.n_features - total, 0))
        self.budgets = budgets

    def set_num(self, n: int):
        self.n_features = n
        self._per_level_budgets()

    def extract(self, image: np.ndarray, force_python: bool = False):
        """-> (keypoints (N,2) level-0 px, octaves (N,), descriptors (N,32),
        angles (N,) rad).

        Dispatches to the native C++ pipeline (csrc/orb_fast.cpp — same
        algorithm, production throughput) when g++ is available; this NumPy
        body is the oracle and the path without a compiler."""
        if image.ndim == 3:
            # ITU-R 601 luma
            image = np.clip(
                0.114 * image[..., 0] + 0.587 * image[..., 1]
                + 0.299 * image[..., 2], 0, 255
            ).astype(np.uint8)
        if not force_python:
            from .. import native

            if native.available("orb_fast"):
                return native.orb_extract(
                    image, self.n_levels, self.scale_factor, self.ini_th,
                    self.min_th, np.asarray(self.budgets, np.int32),
                    _BRIEF, _PATCH_OFF,
                )
        pyr = [image]
        for lv in range(1, self.n_levels):
            s = self.scale_factor ** lv
            h = max(int(round(image.shape[0] / s)), 8)
            w = max(int(round(image.shape[1] / s)), 8)
            pyr.append(_resize_bilinear(image, h, w))

        all_xy, all_oct, all_desc, all_ang = [], [], [], []
        for lv, img in enumerate(pyr):
            xy, resp = self._detect_level(img)
            if len(xy) == 0:
                continue
            keep = distribute_quadtree(
                xy, resp,
                EDGE_THRESHOLD - 3, img.shape[1] - EDGE_THRESHOLD + 3,
                EDGE_THRESHOLD - 3, img.shape[0] - EDGE_THRESHOLD + 3,
                self.budgets[lv],
            )
            xy = xy[keep]
            ang = orientations(img, xy)
            desc = brief_descriptors(gaussian_blur7(img), xy, ang)
            all_xy.append(xy * self.scale_factor**lv)
            all_oct.append(np.full(len(xy), lv, np.int64))
            all_desc.append(desc)
            all_ang.append(ang)
        if not all_xy:
            z = np.zeros((0, 2))
            return (z, np.zeros(0, np.int64), np.zeros((0, 32), np.uint8),
                    np.zeros(0))
        return (np.concatenate(all_xy).astype(float),
                np.concatenate(all_oct),
                np.concatenate(all_desc),
                np.concatenate(all_ang))

    def _detect_level(self, img: np.ndarray):
        """Whole-level FAST with the per-cell ini/min retry: cells that have
        no corner at the initial threshold fall back to the minimum one
        (ComputeKeyPointsOctTree, ORBextractor.cc:821-889)."""
        b = EDGE_THRESHOLD - 3
        H, W = img.shape
        if H <= 2 * b or W <= 2 * b:
            return np.zeros((0, 2), np.int64), np.zeros(0, np.int32)
        ok_min, score = fast_detect(img, self.min_th)
        ok_ini, _ = fast_detect(img, self.ini_th)
        nms = _nms3(np.where(ok_min, score, 0))
        inside = np.zeros_like(ok_min)
        inside[b:H - b, b:W - b] = True
        cand_min = ok_min & nms & inside
        cand_ini = ok_ini & cand_min

        ys, xs = np.nonzero(cand_min)
        if len(ys) == 0:
            return np.zeros((0, 2), np.int64), np.zeros(0, np.int32)
        is_ini = cand_ini[ys, xs]
        # cell ids on the CELL_W grid inside the border
        ci = (ys - b) // CELL_W * ((W - 2 * b) // CELL_W + 1) + (xs - b) // CELL_W
        has_ini = np.zeros(ci.max() + 1, bool)
        np.maximum.at(has_ini, ci, is_ini)
        keep = is_ini | ~has_ini[ci]
        ys, xs = ys[keep], xs[keep]
        return np.stack([xs, ys], 1), score[ys, xs]


def undistort_points(pts: np.ndarray, K4: np.ndarray,
                     dist: np.ndarray, n_iter: int = 8) -> np.ndarray:
    """Iteratively invert the radial-tangential model (k1,k2,p1,p2,k3) —
    MultiFrame::UndistortKeyPoints (Frame.cc:697-737) without the cv2
    dependency. `K4` = (fx, fy, cx, cy)."""
    if not np.any(dist):
        return np.asarray(pts, float)
    fx, fy, cx, cy = K4
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x = (pts[:, 0] - cx) / fx
    y = (pts[:, 1] - cy) / fy
    x0, y0 = x.copy(), y.copy()
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x * fx + cx, y * fy + cy], 1)


def distort_points(pts: np.ndarray, K4: np.ndarray, dist: np.ndarray):
    """Forward radial-tangential distortion (test/validation helper)."""
    fx, fy, cx, cy = K4
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x = (pts[:, 0] - cx) / fx
    y = (pts[:, 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], 1)
