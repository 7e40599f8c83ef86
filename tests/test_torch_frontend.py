"""The port's frame construction, config reader and PNG reader against the
reference's.

- `build_frame` of both packages (host backend) on rendered frames of the
  pinhole rig (2 async + stereo) and of the fisheye rig (async camera 0
  KB8): keypoints, octaves, descriptors, angles, `kp_ur` and `kp_depth`
  exact; the KB8 camera's lifted keypoints and `kp_sigma2_scale` to 1e-10
  (a Newton solve in float64). Both extract with the port's native build of
  the shared C++ source: the reference's own build fuses multiply-adds and
  departs from its numpy oracle on rendered frames (tests/test_torch_orb.py).
  The reference's module is loaded before its first frame: its lazy loader
  marks the module missing while it loads, so threads that ask at the same
  time take the numpy path (amcslam_tpu/native/__init__.py:26-28).
- `load_config` of both packages on the YAML of tests/test_amv_cli.py, on a
  `%YAML:1.0` variant, on a scalar `Gaussian.Qc` and on the flat-key
  fallback: every field equal. The port's reader raises on YAML outside
  the flat subset.
- `read_png_gray` against `cv2.imread` (cv2 is only an oracle here) on
  PNGs that cv2 wrote with each of the five row filters, grayscale and
  RGB, and a round trip through `write_png_gray`.
"""

import json
import struct
import zlib
from pathlib import Path
from unittest import mock

import cv2
import numpy as np
import pytest

from amcslam_tpu import native as ref_native
from amcslam_tpu.frontend import features as ref_features
from amcslam_tpu.pipeline import config as ref_config
from amcslam_tpu.pipeline.rig import Rig as RefRig

from amcslam_tpu_torch import native
from amcslam_tpu_torch.examples import e2e_rendered as e2e
from amcslam_tpu_torch.frontend import features
from amcslam_tpu_torch.frontend.cameras import CAMERA_KB8
from amcslam_tpu_torch.pipeline import config
from amcslam_tpu_torch.utils.io import read_png_gray, write_png_gray

KB8 = np.array([300.0, 300.0, 320.0, 240.0, 0.05, -0.01, 0.002, 0.0])
LIFT_TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True)
def _reference_native_loaded():
    assert ref_native.available("orb_fast")


def _rig(fisheye: bool):
    rig = e2e.make_rig(2)
    if fisheye:
        rig.K[0] = KB8[:4]
        rig.cam_model = np.zeros(rig.n_cams, np.int32)
        rig.cam_model[0] = CAMERA_KB8
        rig.kb8_params = np.zeros((rig.n_cams, 8))
        rig.kb8_params[0] = KB8
    return rig


def _frame_images(rig, fisheye: bool, k: int):
    planes = e2e.make_world(0)
    grid = e2e.kb8_ray_grid(KB8, e2e.W, e2e.H, device="cpu") if fisheye else None
    ts = k / 10.0
    cam_t = rig.cam_times(ts)
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    with np.errstate(invalid="ignore"):
        imgs = [e2e.render(e2e.gt_pose(cam_t[c]) @ rig.Tbc[c], planes,
                           ray_grid=grid if c == 0 else None) for c in range(rig.n_cams)]
        right = e2e.render(e2e.gt_pose(ts) @ rig.Tbc[-1] @ Tright, planes)
    return imgs, cam_t, right


@pytest.mark.parametrize("fisheye", [False, True])
@pytest.mark.parametrize("k", [0, 3])
def test_build_frame_equals_the_reference(fisheye, k):
    rig = _rig(fisheye)
    ref_rig = RefRig(Tbc=rig.Tbc, K=rig.K, bf=rig.bf, qc_diag=rig.qc_diag,
                     n_levels=rig.n_levels, cam_model=rig.cam_model,
                     kb8_params=rig.kb8_params)
    imgs, cam_t, right = _frame_images(rig, fisheye, k)
    got = features.build_frame(imgs, cam_t, rig, features.make_extractors(4, 400, "host"),
                               right_image=right, device="cpu")
    with mock.patch.object(ref_native, "orb_extract", native.orb_extract):
        want = ref_features.build_frame(imgs, cam_t, ref_rig,
                                        ref_features.make_extractors(4, 400, "host"),
                                        right_image=right)
    for c in range(rig.n_cams):
        if fisheye and c == 0:
            np.testing.assert_allclose(got.keypoints[c], want.keypoints[c], **LIFT_TOL)
            np.testing.assert_allclose(got.kp_sigma2_scale[c], want.kp_sigma2_scale[c],
                                       **LIFT_TOL)
        else:
            np.testing.assert_array_equal(got.keypoints[c], want.keypoints[c])
        np.testing.assert_array_equal(got.kp_octaves[c], want.kp_octaves[c])
        np.testing.assert_array_equal(got.descriptors[c], want.descriptors[c])
        np.testing.assert_array_equal(got.kp_angles[c], want.kp_angles[c])
        assert len(got.keypoints[c]) > 200
    assert (got.kp_sigma2_scale is None) == (want.kp_sigma2_scale is None) == (not fisheye)
    if fisheye:
        assert got.kp_sigma2_scale[1] is None and want.kp_sigma2_scale[1] is None
    np.testing.assert_array_equal(got.kp_ur, want.kp_ur)
    np.testing.assert_array_equal(got.kp_depth, want.kp_depth)
    assert (got.kp_depth > 0).sum() > 50
    np.testing.assert_array_equal(got.cam_times, want.cam_times)
    assert got.timestamp == want.timestamp


def test_radtan_undistortion_equals_the_reference():
    rig = _rig(False)
    rig.dist = np.tile([-0.05, 0.01, 1e-3, -1e-3, 0.0], (rig.n_cams, 1))
    ref_rig = RefRig(Tbc=rig.Tbc, K=rig.K, bf=rig.bf, qc_diag=rig.qc_diag, dist=rig.dist)
    imgs, cam_t, right = _frame_images(rig, False, 1)
    got = features.build_frame(imgs, cam_t, rig, features.make_extractors(4, 300, "host"),
                               right_image=right, device="cpu")
    with mock.patch.object(ref_native, "orb_extract", native.orb_extract):
        want = ref_features.build_frame(imgs, cam_t, ref_rig,
                                        ref_features.make_extractors(4, 300, "host"),
                                        right_image=right)
    for c in range(rig.n_cams):
        np.testing.assert_array_equal(got.keypoints[c], want.keypoints[c])
    np.testing.assert_array_equal(got.kp_depth, want.kp_depth)


def test_device_backend_builds_one_batched_frame():
    rig = _rig(False)
    imgs, cam_t, right = _frame_images(rig, False, 2)
    exts = features.make_extractors(4, 300, "device", device="cpu")
    calls = []
    orig = exts[-1].extract_batch
    with mock.patch.object(exts[-1], "extract_batch",
                           side_effect=lambda x: calls.append(x.shape) or orig(x)):
        f = features.build_frame(imgs, cam_t, rig, exts, right_image=right, device="cpu")
    assert calls == [(4, e2e.H, e2e.W)]
    assert all(len(k) > 100 for k in f.keypoints) and (f.kp_depth > 0).sum() > 20


def test_make_extractors_backends(monkeypatch):
    assert all(isinstance(e, features.ORBExtractor) for e in features.make_extractors(2))
    monkeypatch.setenv("AMCSLAM_ORB_BACKEND", "device")
    exts = features.make_extractors(2, 500, device="cpu")
    assert [type(e).__name__ for e in exts] == ["ORBExtractorDevice"] * 2
    assert exts[0].n_features == 500
    with pytest.raises(ValueError, match="unknown ORB backend"):
        features.make_extractors(2, backend="tpu")


# ---------------------------------------------------------------------------
# load_config
# ---------------------------------------------------------------------------


def _write_calib(root: Path, rig):
    for c in range(rig.n_cams):
        K4 = rig.K[c]
        Km = [[K4[0], 0.0, K4[2]], [0.0, K4[1], K4[3]], [0.0, 0.0, 1.0]]
        (root / f"cam{c}.json").write_text(json.dumps(
            {"sensor_to_vehicle": rig.Tbc[c].tolist(), "intrinsics": Km}))


AMV_YAML = ("Camera.number: 3\n"
            "Camera.calibfiles: [cam0.json, cam1.json, cam2.json]\n"
            "Camera.bf: 80.0\n"
            "dataset: {ds}\n"
            "Gaussian.Qc: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]\n"
            "ORBextractor.nFeatures: 800\n"
            "loopClosing: 1\n")

VARIANTS = {
    "amv_cli": AMV_YAML,
    "opencv_header": "%YAML:1.0\n---\n# run config\n" + AMV_YAML.replace(
        "Camera.bf: 80.0", "Camera.bf: 80.0   # baseline * fx") + (
        "Velocity: [0.1, 0.0, 0.0, 0.0, 0.0, 0.02]\nRansac.threshold: 2.5\n"
        "ORBextractor.scaleFactor: 1.25\nORBextractor.nLevels: 6\nExtrinsic: 1\n"
        "thFarPoints: 20.0\n"),
    "scalar_qc": AMV_YAML.replace("Gaussian.Qc: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]",
                                  "Gaussian.Qc: 0.25").replace("loopClosing: 1",
                                                               "loopClosing: 0"),
    "flat_keys": ("Camera.number: 4\nCamera.fx: 410.5\nCamera.cx: 330.0\n"
                  "Camera.cy: 250.5\nCamera.bf: 41.0\ndataset: '{ds}'\n"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_config_equals_the_reference(tmp_path, variant):
    _write_calib(tmp_path, e2e.make_rig(2))
    path = tmp_path / "run.yaml"
    path.write_text(VARIANTS[variant].format(ds=tmp_path / "seq"))
    got, want = config.load_config(str(path)), ref_config.load_config(str(path))
    for f in ("loop_closing", "extrinsic_refine", "dataset_path", "n_features",
              "th_far_points"):
        assert getattr(got, f) == getattr(want, f), f
        assert type(getattr(got, f)) is type(getattr(want, f)), f
    for f in ("Tbc", "K", "qc_diag", "ini_vel", "level_sigma2", "cam_time_offsets"):
        np.testing.assert_array_equal(getattr(got.rig, f), getattr(want.rig, f), err_msg=f)
    for f in ("bf", "scale_factor", "n_levels"):
        assert getattr(got.rig, f) == getattr(want.rig, f), f
    assert got.tracking.ransac_threshold == want.tracking.ransac_threshold
    assert got.dataset_path == str(tmp_path / "seq")


@pytest.mark.parametrize("text", [
    "Camera:\n  number: 3\n",             # block mapping
    "Camera.calibfiles:\n  - cam0.json\n",  # block sequence
    "a: &anchor 1\nb: *anchor\n",          # anchors and aliases
    "Gaussian.Qc: [1.0, 1.0,\n  1.0]\n",   # a multi-line flow list
    "M: !!opencv-matrix\n",                # a tag
    "a: {b: 1}\n",                         # a flow mapping
    "text: |\n  line\n",                   # a block scalar
])
def test_config_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        config.parse_flat_yaml(text)


def test_config_reader_types_scalars_as_pyyaml():
    import yaml

    text = ("i: 12\nneg: -3\nf: 1.5\ne: 1.0e+3\nexp_str: 1e-3\nt: true\nn: ~\n"
            "q: 'it''s'\ndq: \"a # b\"\np: /data/run#1\nl: [1, 2.5, x, 'y z']\nempty: []\n")
    assert config.parse_flat_yaml(text) == yaml.safe_load(text)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _filters(path: Path) -> set:
    """The row filter types of a PNG file."""
    data, pos, idat, hdr = path.read_bytes(), 8, [], None
    while pos < len(data):
        n, t = struct.unpack(">I4s", data[pos: pos + 8])
        if t == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8: pos + 8 + n])
        if t == b"IDAT":
            idat.append(data[pos + 8: pos + 8 + n])
        pos += 12 + n
    w, h, _, colour = hdr[:4]
    stride = w * (3 if colour == 2 else 1) + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride)
    return set(raw[:, 0].tolist())


FILTERS = {"none": (cv2.IMWRITE_PNG_FILTER_NONE, 0), "sub": (cv2.IMWRITE_PNG_FILTER_SUB, 1),
           "up": (cv2.IMWRITE_PNG_FILTER_UP, 2), "average": (cv2.IMWRITE_PNG_FILTER_AVG, 3),
           "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, 4)}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_read_png_gray_equals_cv2(tmp_path, name):
    flag, ftype = FILTERS[name]
    rng = np.random.RandomState(ftype)
    gray = rng.randint(0, 256, (37, 53)).astype(np.uint8)
    gray[:, :20] = np.arange(20, dtype=np.uint8) * 11
    bgr = rng.randint(0, 256, (29, 41, 3)).astype(np.uint8)
    for img in (gray, bgr):
        p = tmp_path / f"{img.ndim}.png"
        assert cv2.imwrite(str(p), img, [cv2.IMWRITE_PNG_FILTER, flag])
        assert ftype in _filters(p)
        if img.ndim == 2:
            want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        else:
            c = cv2.imread(str(p), cv2.IMREAD_COLOR).astype(np.float64)
            want = np.clip(0.114 * c[..., 0] + 0.587 * c[..., 1] + 0.299 * c[..., 2],
                           0, 255).astype(np.uint8)
        np.testing.assert_array_equal(read_png_gray(str(p)), want)


def test_png_round_trip(tmp_path):
    with np.errstate(invalid="ignore"):
        img = e2e.render(e2e.gt_pose(0.0) @ e2e.make_rig(2).Tbc[0], e2e.make_world(0))
    p = tmp_path / "frame.png"
    write_png_gray(str(p), img)
    np.testing.assert_array_equal(read_png_gray(str(p)), img)
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE), img)


def test_read_png_gray_raises_on_unsupported_files(tmp_path):
    p16 = tmp_path / "deep.png"
    cv2.imwrite(str(p16), np.arange(600, dtype=np.uint16).reshape(20, 30) * 100)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png_gray(str(p16))
    # interlaced: flip IHDR's interlace byte and its CRC
    p = tmp_path / "gray.png"
    write_png_gray(str(p), np.zeros((8, 8), np.uint8))
    data = bytearray(p.read_bytes())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png_gray(str(p))
    # palette (colour type 3)
    data[25], data[28] = 3, 0
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="colour type 3"):
        read_png_gray(str(p))
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_gray(str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="uint8"):
        write_png_gray(str(p), np.zeros((4, 4), np.float32))
