"""On-device ORB extraction — the accelerator path of the front-end.

Port of `amcslam_tpu/frontend/orb_tpu.py`: the whole extraction pipeline of
frontend/orb.py as one batched pass over a rig's images on the extractor's
device (pyramid resize, FAST-9/16 for both thresholds in one pass, raster-
order 3x3 NMS, the per-cell ini/min threshold retry, spatially distributed
top-K selection, intensity-centroid orientation, 7x7 Gaussian blur and
rotated BRIEF with the same pattern as the host backend), float32 as the
reference runs on its accelerator.

The reference's one documented deviation from the host extractor is kept:
the quadtree (DistributeOctTree, ORBextractor.cc:571) is replaced by "the
best keypoint of every 35px cell first, then the remaining budget by
response" (orb_tpu.py:16-20). Where the TPU needed workarounds the GPU's own
idiom is used: the keypoint windows are direct gathers at clipped image
indices instead of one-hot window matmuls (orb_tpu.py:253-276); the values
are the same. The top-K selection orders by (priority, then the lower flat
index), the tie order of `jax.lax.top_k`, through one composite int64 key,
so the card, the CPU and the reference pick the same slots.

All outputs are fixed-size per level (the per-level budget) with a validity
mask.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..pipeline.tracking import resolve_device
from .orb import _BRIEF, _CIRCLE, _PATCH_OFF, CELL_W, EDGE_THRESHOLD

_CELL_BONUS = 1 << 20  # priority offset for per-cell winners (scores < 2^16)
_BLUR_R = 3


def _level_sizes(H, W, n_levels, scale_factor):
    sizes = [(H, W)]
    for lv in range(1, n_levels):
        s = scale_factor ** lv
        sizes.append((max(int(round(H / s)), 8), max(int(round(W / s)), 8)))
    return sizes


def _budgets(n_features, n_levels, scale_factor):
    f = 1.0 / scale_factor
    n0 = n_features * (1 - f) / (1 - f ** n_levels)
    out, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n0 * f ** lv))
        out.append(b)
        total += b
    out.append(max(n_features - total, 0))
    return out


def _grid(n_out: int, n_in: int):
    """Sample rows/columns of a bilinear resize: (i0, i1, f) float32 with
    the reference's rounding. Computed on the CPU: CUDA divides a tensor by
    a Python number as a product with its reciprocal, which rounds
    differently from the reference's division."""
    x = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out - 0.5
    i0 = torch.clamp(torch.floor(x).long(), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    return i0, i1, torch.clamp(x - i0, 0, 1)


def _resize_bilinear(img, h, w):
    """(B,H,W) uint8 -> (B,h,w) uint8, the formula of orb_tpu.py:66-83 in
    float32 (sample grid, weights, four products summed left to right, one
    round half to even)."""
    H, W = img.shape[1:]
    y0, y1, fy, x0, x1, fx = (t.to(img.device) for t in (*_grid(h, H), *_grid(w, W)))
    fy, fx = fy[:, None], fx[None, :]
    I = img.float()
    r0, r1 = I[:, y0], I[:, y1]
    out = (r0[:, :, x0] * (1 - fy) * (1 - fx)
           + r0[:, :, x1] * (1 - fy) * fx
           + r1[:, :, x0] * fy * (1 - fx)
           + r1[:, :, x1] * fy * fx)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _run9(m):
    """Circular run of >= 9 set bits in a 16-bit mask (int32), by shift-AND
    doubling; equal to `_ARC_LUT[m]` (orb.py:51)."""
    m32 = m | (m << 16)           # duplicate: circular runs become linear
    r = m32 & (m32 >> 1)          # run >= 2 starting at each bit
    r = r & (r >> 2)              # run >= 4
    r = r & (r >> 4)              # run >= 8
    r = r & (m32 >> 8)            # run >= 9
    return (r & 0xFFFF) != 0


def _fast_masks_pair(img, ini_th, min_th):
    """One pass over the 16 circle offsets for both thresholds -> (ok_min,
    ok_ini, score) (B,H,W): the min-threshold response (sum of |d| - th over
    exceeding circle pixels), zero outside min-corners."""
    B, H, W = img.shape
    I = img.to(torch.int32)
    c = I[:, 3:-3, 3:-3]
    mb_min = torch.zeros_like(c)
    md_min, mb_ini, md_ini, resp = (torch.zeros_like(c) for _ in range(4))
    for k, (dx, dy) in enumerate(_CIRCLE.tolist()):
        d = I[:, 3 + dy: H - 3 + dy, 3 + dx: W - 3 + dx] - c
        mb_min |= (d > min_th).to(torch.int32) << k
        md_min |= (d < -min_th).to(torch.int32) << k
        mb_ini |= (d > ini_th).to(torch.int32) << k
        md_ini |= (d < -ini_th).to(torch.int32) << k
        a = d.abs()
        resp += torch.where(a > min_th, a - min_th, 0)
    corner_min = _run9(mb_min) | _run9(md_min)
    corner_ini = _run9(mb_ini) | _run9(md_ini)
    pad = (3, 3, 3, 3)
    ok_min = F.pad(corner_min, pad)
    ok_ini = F.pad(corner_ini, pad)
    score = F.pad(torch.where(corner_min, resp, 0), pad)
    return ok_min, ok_ini, score


def _nms3(score):
    """3x3 non-max suppression (orb_tpu.py:123-134): earlier raster
    neighbours strictly smaller, later ones smaller or equal."""
    H, W = score.shape[1:]
    pad = F.pad(score, (1, 1, 1, 1), value=-1)
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy, dx, strict in [(-1, -1, True), (-1, 0, True), (-1, 1, True),
                           (0, -1, True), (0, 1, False), (1, -1, False),
                           (1, 0, False), (1, 1, False)]:
        nb = pad[:, 1 + dy: H + 1 + dy, 1 + dx: W + 1 + dx]
        keep &= (score > nb) if strict else (score >= nb)
    return keep


def _cells(x, H, W, fill):
    """The interior (inside the FAST border) of x (B,H,W), padded with
    `fill` to whole 35px cells -> (B, ncy, CELL_W, ncx, CELL_W)."""
    b = EDGE_THRESHOLD - 3
    hi, wi = H - 2 * b, W - 2 * b
    ncy, ncx = -(-hi // CELL_W), -(-wi // CELL_W)
    inner = F.pad(x[:, b: b + hi, b: b + wi], (0, ncx * CELL_W - wi, 0, ncy * CELL_W - hi),
                  value=fill)
    return inner.reshape(x.shape[0], ncy, CELL_W, ncx, CELL_W)


def _uncells(c, H, W):
    """Inverse of `_cells`: back to (B,H,W), False outside the interior."""
    b = EDGE_THRESHOLD - 3
    hi, wi = H - 2 * b, W - 2 * b
    B, ncy, _, ncx, _ = c.shape
    inner = c.reshape(B, ncy * CELL_W, ncx * CELL_W)[:, :hi, :wi]
    return F.pad(inner, (b, b, b, b), value=False)


def _cell_retry(cand_min, cand_ini, H, W):
    """Keep ini corners; where a 35px cell has none, admit its min-threshold
    corners (ComputeKeyPointsOctTree semantics, orb_tpu.py:137-153)."""
    has_ini = _cells(cand_ini, H, W, False).any(dim=4, keepdim=True).any(dim=2, keepdim=True)
    has_pix = _uncells(has_ini.expand(-1, -1, CELL_W, -1, CELL_W), H, W)
    inside = _uncells(torch.ones_like(has_ini).expand(-1, -1, CELL_W, -1, CELL_W), H, W)
    return inside & (cand_ini | (cand_min & ~has_pix))


def _cell_best_mask(score, H, W):
    """The best-scoring pixels of every 35px cell (orb_tpu.py:156-170)."""
    cells = _cells(score, H, W, 0)
    cmax = cells.amax(dim=(2, 4), keepdim=True)
    return _uncells((cells == cmax) & (cells > 0), H, W)


def _gaussian_blur7(img, sigma=2.0):
    """Separable 7x7 Gaussian, reflect-101 borders, float32, rounded and
    clipped but kept float32 (orb_tpu.py:185-200: the row pass runs over the
    padded rows, the column pass over the row pass's interior columns; each
    sum accumulates the taps left to right)."""
    r = _BLUR_R
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32).tolist()
    H, W = img.shape[1:]
    pad = F.pad(img.float()[:, None], (r, r, r, r), mode="reflect")[:, 0]
    tmp = 0
    for i in range(7):
        tmp = tmp + k[i] * pad[:, :, i: i + W]
    out = 0
    for i in range(7):
        out = out + k[i] * tmp[:, i: i + H, :]
    return torch.clamp(torch.round(out), 0, 255)


def _candidates(ok_min, ok_ini, score):
    """NMS and the cell logic of one level: (s, prio) (B,H,W), the scores of
    the surviving corners and their selection priority (per-cell winners
    lifted by _CELL_BONUS)."""
    H, W = score.shape[1:]
    nms = _nms3(torch.where(ok_min, score, 0))
    cand_min = ok_min & nms
    cand_ini = ok_ini & cand_min
    cand = _cell_retry(cand_min, cand_ini, H, W)
    s = torch.where(cand, score, 0)
    return s, s + torch.where(_cell_best_mask(s, H, W), _CELL_BONUS, 0)


def _top_k(s, prio, budget):
    """The `budget` best pixels by priority, ties to the lower flat index
    (jax.lax.top_k's order): (ys, xs, valid, score) (B,K)."""
    B, H, W = prio.shape
    n = H * W
    key = prio.reshape(B, n).long() * n + (n - 1 - torch.arange(n, device=prio.device))
    flat = n - 1 - torch.topk(key, budget, dim=1).values % n
    vals = prio.reshape(B, n).gather(1, flat)
    return flat // W, flat % W, vals > 0, s.reshape(B, n).gather(1, flat)


def _orientation(img, ys, xs, patch):
    """Intensity-centroid angle over the circular patch (exact integer sums
    in float32: |m| <= 255 * 15 * 749 < 2^24)."""
    B, H, W = img.shape
    bidx = torch.arange(B, device=img.device)[:, None, None]
    py = torch.clamp(ys[:, :, None] + patch[:, 0], 0, H - 1)
    px = torch.clamp(xs[:, :, None] + patch[:, 1], 0, W - 1)
    vals_p = img[bidx, py, px].float()
    m10 = (vals_p * patch[:, 1].float()).sum(-1)
    m01 = (vals_p * patch[:, 0].float()).sum(-1)
    return torch.atan2(m01, m10)


def _brief(blur, ys, xs, ang, brief):
    """Rotated BRIEF on the blurred level, sampled at clipped image indices:
    (B,K,32) uint8."""
    B, H, W = blur.shape
    K = ys.shape[1]
    bidx = torch.arange(B, device=blur.device)[:, None, None]
    ca, sa = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]

    def samp(bx, by):
        rx = torch.round(ca * bx - sa * by).long()
        ry = torch.round(sa * bx + ca * by).long()
        yy = torch.clamp(ys[:, :, None] + ry, 0, H - 1)
        xx = torch.clamp(xs[:, :, None] + rx, 0, W - 1)
        return blur[bidx, yy, xx]

    bits = samp(brief[:, 0], brief[:, 1]) < samp(brief[:, 2], brief[:, 3])  # (B,K,256)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=blur.device)
    return (bits.reshape(B, K, 32, 8).to(torch.int32) * weights).sum(-1).to(torch.uint8)


def _extract_level(img, brief, patch, ini_th, min_th, budget):
    """One pyramid level of B images -> (xy (B,K,2) f32 level px, score,
    angle, desc (B,K,32) uint8, valid), K = budget: FAST, NMS and the cell
    logic, the top-K, orientation, blur and BRIEF (the stages that
    examples/profile_orb_device.py times one by one)."""
    ok_min, ok_ini, score = _fast_masks_pair(img, ini_th, min_th)
    s, prio = _candidates(ok_min, ok_ini, score)
    ys, xs, valid, sc = _top_k(s, prio, budget)
    ang = _orientation(img, ys, xs, patch)
    desc = _brief(_gaussian_blur7(img), ys, xs, ang, brief)
    xy = torch.stack([xs, ys], dim=-1).float()
    return xy, sc, ang, desc, valid


def build_orb_device(H, W, n_features=1200, scale_factor=1.2, n_levels=8,
                     ini_th=20, min_th=7, *, device):
    """Extractor for images of a fixed size on `device`: a function (B,H,W)
    uint8 tensor -> dict of (B,K) per-keypoint tensors, K = n_features slots
    ordered by pyramid level (`build_orb_tpu`, orb_tpu.py:288-319)."""
    device = torch.device(device)
    sizes = _level_sizes(H, W, n_levels, scale_factor)
    budgets = _budgets(n_features, n_levels, scale_factor)
    brief = torch.as_tensor(_BRIEF, device=device).float()
    patch = torch.as_tensor(_PATCH_OFF, device=device)
    scales = [float(np.float32(scale_factor ** lv)) for lv in range(n_levels)]

    def run(images):
        if images.device != device or images.dtype != torch.uint8 or images.shape[1:] != (H, W):
            raise ValueError(f"expected (B,{H},{W}) uint8 on {device}, got "
                             f"{tuple(images.shape)} {images.dtype} on {images.device}")
        outs = []
        for lv in range(n_levels):
            h, w = sizes[lv]
            lvl = images if lv == 0 else _resize_bilinear(images, h, w)
            xy, sc, ang, desc, valid = _extract_level(lvl, brief, patch, ini_th, min_th,
                                                      budgets[lv])
            octave = torch.full(valid.shape, lv, dtype=torch.int32, device=device)
            outs.append((xy * scales[lv], octave, ang, desc, valid, sc))
        names = ("xy", "octave", "angle", "desc", "valid", "score")
        return {k: torch.cat([o[i] for o in outs], dim=1) for i, k in enumerate(names)}

    return run


def brief_edge_bits(angle: np.ndarray, tol: float = 1e-4) -> np.ndarray:
    """(..., 256) bool: the descriptor bits of keypoints at `angle` (rad)
    whose rotated BRIEF sample lies within `tol` px of a .5 rounding edge in
    any of its four coordinates. A last-place difference in atan2/cos/sin
    between two backends can round such a sample to the other pixel, so a
    comparison of two backends' descriptors exempts these bits."""
    a = np.asarray(angle, np.float64)[..., None]
    ca, sa = np.cos(a), np.sin(a)
    bx1, by1, bx2, by2 = (_BRIEF[:, i].astype(np.float64) for i in range(4))
    edge = np.zeros(a.shape[:-1] + (len(_BRIEF),), bool)
    for v in (ca * bx1 - sa * by1, sa * bx1 + ca * by1,
              ca * bx2 - sa * by2, sa * bx2 + ca * by2):
        edge |= np.abs(v - np.floor(v) - 0.5) < tol
    return edge


def bgr_to_gray(images: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma of (..., 3) BGR uint8 images, the host backend's
    conversion (orb.py:325-329)."""
    return np.clip(0.114 * images[..., 0] + 0.587 * images[..., 1]
                   + 0.299 * images[..., 2], 0, 255).astype(np.uint8)


class ORBExtractorDevice:
    """Drop-in .extract() with the on-device pipeline, one extractor
    function per (H, W, n_features) (cached on the instance)."""

    def __init__(self, n_features=1200, scale_factor=1.2, n_levels=8,
                 ini_th=20, min_th=7, *, device):
        self.device = resolve_device(device)
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th
        self.min_th = min_th
        self._fns = {}

    def set_num(self, n):
        self.n_features = n

    def _fn(self, H, W):
        key = (H, W, self.n_features)
        if key not in self._fns:
            self._fns[key] = build_orb_device(
                H, W, self.n_features, self.scale_factor, self.n_levels,
                self.ini_th, self.min_th, device=self.device,
            )
        return self._fns[key]

    def extract(self, image: np.ndarray):
        out = self.extract_batch(np.asarray(image)[None])
        return tuple(o[0] for o in out)

    def extract_batch(self, images: np.ndarray):
        """(B,H,W) uint8 grayscale or (B,H,W,3) uint8 **BGR** -> per-image
        lists (xy, octave, desc, angle) of the valid slots, with one upload
        and one device-to-host read for the whole batch."""
        images = np.asarray(images)
        if images.ndim == 4:
            if images.shape[-1] != 3:
                raise ValueError(f"4D input must be (B,H,W,3) BGR, got {images.shape}")
            images = bgr_to_gray(images)
        B, H, W = images.shape
        out = self._fn(H, W)(torch.as_tensor(images, device=self.device))
        K = out["valid"].shape[1]
        specs = [("xy", np.float32, (K, 2)), ("octave", np.int32, (K,)),
                 ("angle", np.float32, (K,)), ("desc", np.uint8, (K, 32)),
                 ("valid", np.bool_, (K,))]
        # one read: every output's bytes side by side in one buffer
        parts = [out[k].reshape(B, -1).view(torch.uint8) for k, _, _ in specs]
        host = torch.cat(parts, dim=1).cpu().numpy()
        cols = np.cumsum([0] + [p.shape[1] for p in parts])
        xy, octv, ang, desc, valid = (
            host[:, a:b].copy().view(dt).reshape((B,) + shp)
            for (_, dt, shp), a, b in zip(specs, cols[:-1], cols[1:]))
        xys, octs, descs, angs = [], [], [], []
        for b in range(B):
            m = valid[b]
            xys.append(xy[b][m].astype(np.float64))
            octs.append(octv[b][m].astype(np.int64))
            descs.append(desc[b][m])
            angs.append(ang[b][m].astype(np.float64))
        return xys, octs, descs, angs
