"""Dataset IO (rebuild of System::LoadAmvImages, System.cc:1316-1400).

A copy of `amcslam_tpu/utils/io.py`, pinned to it in
tests/test_torch_pipeline_host.py, plus a PNG reader and writer of its own
(`read_png_gray`, `write_png_gray`: the reference reads images with OpenCV,
which the port does not use).

AMV-Bench layout: per-camera timestamp files plus zero-padded 6-digit image
names; the first stereo timestamp anchors alignment. Also TUM-format
trajectory reading and ATE evaluation for the benchmark harness.
"""

from __future__ import annotations

import os
import struct
import zlib

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


# ---------------------------------------------------------------------------
# PNG (ISO/IEC 15948): 8-bit grayscale and truecolor, non-interlaced
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five per-row PNG filters -> (h, w * bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:       # None
            cur = line.copy()
        elif ftype == 1:     # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint64)
            cur = (cur % 256).astype(np.uint8).reshape(stride)
        elif ftype == 2:     # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(stride)
            f, up = line.tolist(), prior.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (f[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8 image of an 8-bit non-interlaced PNG. Grayscale files
    are returned as stored; truecolor (RGB) files become ITU-R 601 luma the
    way the ORB backends convert a BGR image (frontend/orb.py). 16-bit,
    palette, alpha and interlaced files raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])[0]
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filt, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit grayscale or RGB PNGs are read "
                         f"(bit depth {depth}, colour type {colour})")
    if compression != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNGs are not read")
    bpp = _PNG_CHANNELS[colour]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    if bpp == 1:
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    return np.clip(0.114 * b + 0.587 * g + 0.299 * r, 0, 255).astype(np.uint8)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG (no filtering)."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected an (H, W) uint8 image, got {img.shape} {img.dtype}")
    h, w = img.shape

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
