"""The port's host ORB (amcslam_tpu_torch/frontend/orb.py and its native
build of csrc/orb_fast.cpp) against the reference's.

The numpy module is a copy: its tables and every function must equal the
reference's bit for bit on structured images (blocky textures with noise,
soft blobs, and a rendered 640x480 frame of the end-to-end world).

The native path must equal the numpy oracle: keypoints, octaves and
descriptors bit for bit, angles to 1e-12 rad (numpy's vectorized arctan2 and
libm's atan2 differ in the last place on a few keypoints; the reference's own
test allows the same, tests/test_orb.py:189-207). The port builds the C++
source with `-ffp-contract=off` (native.EXTRA_FLAGS), which its oracle
promise needs: with the reference's flags g++ fuses multiply-adds, and on
noisy images the pyramid and the BRIEF rotation then round a few values to
the other integer. The port's native output equals the reference's native
output on the reference's own test image, where that build matches its
oracle too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from amcslam_tpu import native as ref_native
from amcslam_tpu.frontend import orb as ref

from amcslam_tpu_torch import native
from amcslam_tpu_torch.frontend import orb

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import e2e_rendered as ref_e2e  # noqa: E402

ANGLE_TOL = 1e-12


def _blocky(h, w, seed):
    rng = np.random.RandomState(seed)
    t = np.kron(rng.randint(30, 226, (h // 6 + 1, w // 6 + 1)), np.ones((6, 6)))[:h, :w]
    return np.clip(t + rng.randn(h, w) * 6, 0, 255).astype(np.uint8)


def _blobs(h, w, seed, n_blobs=300):
    """The reference's test image (tests/test_orb.py:21-30)."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 120.0)
    ys = rng.randint(10, h - 10, n_blobs)
    xs = rng.randint(10, w - 10, n_blobs)
    for y, x in zip(ys, xs):
        sz = rng.randint(3, 9)
        img[y:y + sz, x:x + sz] = rng.randint(0, 255)
    return img.astype(np.uint8)


def _rendered():
    planes = ref_e2e.make_world(1)
    rig = ref_e2e.make_rig(5)
    with np.errstate(invalid="ignore"):
        return ref_e2e.render(ref_e2e.gt_pose(0.3) @ rig.Tbc[0], planes)


IMAGES = {
    "blocky": lambda: _blocky(240, 324, 0),
    "blobs": lambda: _blobs(300, 400, 7),
    "rendered": _rendered,
}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def image(request):
    return IMAGES[request.param]()


def test_tables_equal_the_reference():
    np.testing.assert_array_equal(orb._ARC_LUT, ref._ARC_LUT)
    np.testing.assert_array_equal(orb._CIRCLE, ref._CIRCLE)
    np.testing.assert_array_equal(orb._UMAX, ref._UMAX)
    np.testing.assert_array_equal(orb._PATCH_OFF, ref._PATCH_OFF)
    np.testing.assert_array_equal(orb._BRIEF, ref._BRIEF)
    np.testing.assert_array_equal(orb.make_brief_pattern(64, 5), ref.make_brief_pattern(64, 5))
    assert (orb.HALF_PATCH, orb.PATCH_SIZE, orb.EDGE_THRESHOLD, orb.CELL_W) == (
        ref.HALF_PATCH, ref.PATCH_SIZE, ref.EDGE_THRESHOLD, ref.CELL_W)


@pytest.mark.parametrize("threshold", [7, 20])
def test_fast_and_nms_equal_the_reference(image, threshold):
    ok, score = orb.fast_detect(image, threshold)
    ok_r, score_r = ref.fast_detect(image, threshold)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(score, score_r)
    np.testing.assert_array_equal(orb._nms3(score), ref._nms3(score_r))
    assert ok.sum() > 50


def test_pyramid_blur_orientation_brief_equal_the_reference(image):
    H, W = image.shape
    for s in (1.2, 1.44, 2.0736):
        h, w = int(round(H / s)), int(round(W / s))
        np.testing.assert_array_equal(orb._resize_bilinear(image, h, w),
                                      ref._resize_bilinear(image, h, w))
    blur = orb.gaussian_blur7(image)
    np.testing.assert_array_equal(blur, ref.gaussian_blur7(image))
    rng = np.random.RandomState(3)
    xy = np.stack([rng.randint(0, W, 200), rng.randint(0, H, 200)], 1)
    ang = orb.orientations(image, xy)
    np.testing.assert_array_equal(ang, ref.orientations(image, xy))
    np.testing.assert_array_equal(orb.brief_descriptors(blur, xy, ang),
                                  ref.brief_descriptors(blur, xy, ang))


def test_quadtree_equals_the_reference(image):
    ok, score = orb.fast_detect(image, 7)
    ys, xs = np.nonzero(ok & orb._nms3(score))
    xy, resp = np.stack([xs, ys], 1), score[ys, xs]
    H, W = image.shape
    for budget in (10, 77, 300):
        args = (xy, resp, 16, W - 16, 16, H - 16, budget)
        np.testing.assert_array_equal(orb.distribute_quadtree(*args),
                                      ref.distribute_quadtree(*args))


def test_undistort_and_distort_equal_the_reference():
    rng = np.random.RandomState(2)
    pts = np.stack([rng.uniform(0, 640, 50), rng.uniform(0, 480, 50)], 1)
    K4 = np.array([420.0, 421.0, 320.0, 240.0])
    for dist in (np.zeros(5), np.array([-0.2, 0.05, 1e-3, -2e-3, 0.01])):
        np.testing.assert_array_equal(orb.undistort_points(pts, K4, dist),
                                      ref.undistort_points(pts, K4, dist))
        np.testing.assert_array_equal(orb.distort_points(pts, K4, dist),
                                      ref.distort_points(pts, K4, dist))


@pytest.mark.parametrize("n_features,n_levels", [(500, 8), (1200, 8), (300, 4)])
def test_numpy_extract_equals_the_reference(image, n_features, n_levels):
    p, r = orb.OrbPipeline(n_features, n_levels=n_levels), ref.OrbPipeline(n_features,
                                                                           n_levels=n_levels)
    assert p.budgets == r.budgets
    got, want = p.extract(image, force_python=True), r.extract(image, force_python=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 100


def test_bgr_input_is_converted_as_the_reference():
    img = np.stack([_blocky(120, 160, s) for s in (1, 2, 3)], -1)
    got = orb.OrbPipeline(200, n_levels=4).extract(img, force_python=True)
    want = ref.OrbPipeline(200, n_levels=4).extract(img, force_python=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_equals_the_numpy_oracle(image):
    assert native.available("orb_fast")
    p = orb.OrbPipeline(1200)
    xy, oc, de, an = p.extract(image)
    xyP, ocP, deP, anP = p.extract(image, force_python=True)
    assert len(xy) == len(xyP) > 300
    np.testing.assert_array_equal(xy, xyP)
    np.testing.assert_array_equal(oc, ocP)
    np.testing.assert_array_equal(de, deP)
    np.testing.assert_allclose(an, anP, rtol=0, atol=ANGLE_TOL)


def test_native_equals_the_reference_native_on_its_test_image():
    if not ref_native.available("orb_fast"):
        pytest.skip("the reference's native ORB does not build here")
    img = _blobs(300, 400, 7)
    p = orb.OrbPipeline(n_features=500)
    got = p.extract(img)
    want = ref.OrbPipeline(n_features=500).extract(img)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=ANGLE_TOL)


def test_native_module_is_built_into_the_port_build_dir():
    path = native.build("orb_fast")
    assert path.parent == native.BUILD_DIR and path.name.startswith("_orb_fast_")
    assert native.SOURCES["orb_fast"].read_bytes() == (
        Path(ref_native.__file__).parent / "orb_fast.cpp").read_bytes()
