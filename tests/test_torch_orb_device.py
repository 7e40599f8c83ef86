"""The port's device ORB (amcslam_tpu_torch/frontend/orb_device.py) on
torch-CPU against the reference's `build_orb_tpu` (frontend/orb_tpu.py) on
JAX-CPU: 2 images of 120x160, 4 levels, 300 features, float32 (the
reference's x64 switched off, as it runs on its accelerator).

Every slot must agree: keypoints, octaves, validity and scores exactly,
angles to 1e-5 rad (XLA's and PyTorch's float32 atan2 differ in the last
place), and the descriptor bits exactly except bits whose rotated sample
coordinate lies within 1e-4 px of a .5 rounding edge (`brief_edge_bits`): a
last-place difference in cos/sin may round such a sample to the other
pixel. The test counts those bits and asserts that no other bit differs.

The reference's extraction is evaluated per level: its bilinear resize
(orb_tpu.py:66-83) op by op, then its jitted `_extract_level` under `vmap`.
Jitted as one program, XLA fuses the resize's multiply-adds, and a few
pixels of a level then round to the other integer; the port reproduces the
formula as written, which is what op-by-op evaluation computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.frontend import orb_tpu as ref
from amcslam_tpu.frontend.orb import _ARC_LUT

from amcslam_tpu_torch.frontend import orb_device as dev

H, W, N_FEATURES, N_LEVELS, SCALE = 120, 160, 300, 4, 1.2
ANGLE_TOL = 1e-5
EDGE_TOL = 1e-4


def _images():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(2):
        t = np.kron(rng.randint(30, 226, (H // 6 + 1, W // 6 + 1)), np.ones((6, 6)))[:H, :W]
        out.append(np.clip(t + rng.randn(H, W) * 6, 0, 255).astype(np.uint8))
    return np.stack(out)


def _reference(images):
    sizes = ref._level_sizes(H, W, N_LEVELS, SCALE)
    budgets = ref._budgets(N_FEATURES, N_LEVELS, SCALE)
    brief = jnp.asarray(ref._BRIEF, jnp.int32)
    outs = []
    with jax.enable_x64(False):
        imgs = jnp.asarray(images)
        for lv in range(N_LEVELS):
            h, w = sizes[lv]
            lvl = imgs if lv == 0 else jnp.stack(
                [ref._resize_bilinear_jnp(im, h, w) for im in imgs])
            fn = jax.jit(jax.vmap(lambda im, b=budgets[lv]: ref._extract_level(
                im, brief, 20, 7, b)))
            xy, sc, ang, desc, valid = (np.asarray(a) for a in fn(lvl))
            outs.append((xy * np.float32(SCALE ** lv), np.full(xy.shape[:2], lv, np.int32),
                         ang, desc.astype(np.uint8), valid, sc))
    names = ("xy", "octave", "angle", "desc", "valid", "score")
    return {k: np.concatenate([o[i] for o in outs], axis=1) for i, k in enumerate(names)}


@pytest.fixture(scope="module")
def outputs():
    images = _images()
    want = _reference(images)
    fn = dev.build_orb_device(H, W, N_FEATURES, SCALE, N_LEVELS, device="cpu")
    got = {k: v.numpy() for k, v in fn(torch.as_tensor(images)).items()}
    return images, got, want


def test_slots_equal_the_reference(outputs):
    _, got, want = outputs
    for k in ("xy", "octave", "valid", "score"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["valid"].sum() > 400


def test_angles_equal_the_reference(outputs):
    _, got, want = outputs
    np.testing.assert_allclose(got["angle"], want["angle"], rtol=0, atol=ANGLE_TOL)


def test_descriptor_bits_equal_away_from_rounding_edges(outputs):
    _, got, want = outputs
    diff = np.unpackbits(got["desc"], axis=-1) != np.unpackbits(want["desc"], axis=-1)
    edge = dev.brief_edge_bits(want["angle"], EDGE_TOL)
    assert not (diff & ~edge).any(), int((diff & ~edge).sum())
    # the exemption stays small: a handful of bits of the 2 x 300 x 256
    assert edge.sum() < 0.01 * edge.size and diff.sum() <= edge.sum()


def test_run9_equals_the_arc_lut():
    m = torch.arange(1 << 16, dtype=torch.int32)
    np.testing.assert_array_equal(dev._run9(m).numpy(), _ARC_LUT)


def test_stages_equal_the_reference():
    img = _images()[0]
    t = torch.as_tensor(img)[None]
    with jax.enable_x64(False):
        j = jnp.asarray(img)
        for h, w in ref._level_sizes(H, W, N_LEVELS, SCALE)[1:]:
            np.testing.assert_array_equal(dev._resize_bilinear(t, h, w)[0].numpy(),
                                          np.asarray(ref._resize_bilinear_jnp(j, h, w)))
        np.testing.assert_array_equal(dev._gaussian_blur7(t)[0].numpy(),
                                      np.asarray(jax.jit(ref._gaussian_blur7_jnp)(j)))
        ok_min, ok_ini, score = dev._fast_masks_pair(t, 20, 7)
        r_min, r_ini, r_score = (np.asarray(a) for a in ref._fast_masks_pair(j, 20, 7))
        np.testing.assert_array_equal(ok_min[0].numpy(), r_min)
        np.testing.assert_array_equal(ok_ini[0].numpy(), r_ini)
        np.testing.assert_array_equal(score[0].numpy(), r_score)
        s = torch.where(ok_min, score, 0)
        nms = dev._nms3(s)
        np.testing.assert_array_equal(nms[0].numpy(),
                                      np.asarray(ref._nms3_jnp(jnp.asarray(s[0].numpy()))))
        cand_min = ok_min & nms
        cand_ini = ok_ini & cand_min
        cand = dev._cell_retry(cand_min, cand_ini, H, W)
        np.testing.assert_array_equal(cand[0].numpy(), np.asarray(ref._cell_retry(
            jnp.asarray(cand_min[0].numpy()), jnp.asarray(cand_ini[0].numpy()), H, W)))
        sc = torch.where(cand, score, 0)
        np.testing.assert_array_equal(dev._cell_best_mask(sc, H, W)[0].numpy(),
                                      np.asarray(ref._cell_best_mask(jnp.asarray(sc[0].numpy()),
                                                                     H, W)))
    assert dev._budgets(1200, 8, 1.2) == ref._budgets(1200, 8, 1.2)
    assert dev._level_sizes(480, 640, 8, 1.2) == ref._level_sizes(480, 640, 8, 1.2)


def test_extractor_returns_the_valid_slots(outputs):
    images, got, _ = outputs
    ext = dev.ORBExtractorDevice(N_FEATURES, n_levels=N_LEVELS, device="cpu")
    xys, octs, descs, angs = ext.extract_batch(images)
    for b in range(2):
        m = got["valid"][b]
        np.testing.assert_array_equal(xys[b], got["xy"][b][m].astype(np.float64))
        np.testing.assert_array_equal(octs[b], got["octave"][b][m])
        np.testing.assert_array_equal(descs[b], got["desc"][b][m])
        np.testing.assert_array_equal(angs[b], got["angle"][b][m].astype(np.float64))
    # a BGR image is converted to luma as the host backend converts it
    bgr = np.stack([images[1], images[0], images[1][::-1]], -1)
    gray = dev.bgr_to_gray(bgr)
    np.testing.assert_array_equal(
        gray, np.clip(0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2],
                      0, 255).astype(np.uint8))
    for a, b in zip(ext.extract(bgr), ext.extract(gray)):
        np.testing.assert_array_equal(a, b)


def test_extractor_checks_its_input():
    fn = dev.build_orb_device(H, W, 100, SCALE, 2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        fn(torch.zeros((1, H, W + 1), dtype=torch.uint8))
    with pytest.raises(ValueError, match="BGR"):
        dev.ORBExtractorDevice(100, device="cpu").extract_batch(np.zeros((1, H, W, 4), np.uint8))
