"""The port's matcher (pipeline/matcher.py) against the reference's on the
same seeded inputs: every search returns the same integer outputs, through
the native C++ path (both packages build the reference's graph_builder.cpp)
and through the fallback (the reference's JAX popcount against the port's
torch bit-plane product). The torch Hamming table equals the native one
exactly (float32 sums of 0/1 up to 256, TF32 off)."""

import numpy as np
import pytest

import amcslam_tpu.native as ref_native
from amcslam_tpu.ops import host_geom
from amcslam_tpu.pipeline import matcher as ref_matcher
from amcslam_tpu.utils.synthetic import make_sequence

from amcslam_tpu_torch import native
from amcslam_tpu_torch.pipeline import matcher


def _noisy(desc, rng, frac=0.3, bits=12):
    """Copies of descriptors with `bits` random bit flips in a fraction."""
    out = desc.copy()
    for i in np.nonzero(rng.rand(len(out)) < frac)[0]:
        for b in rng.randint(0, 256, bits):
            out[i, b // 8] ^= np.uint8(1 << (b % 8))
    return out


@pytest.fixture(scope="module")
def scene():
    frames, rig, Ts, (X, descs) = make_sequence(n_frames=3, n_cams=3, n_lm=300, seed=4)
    rng = np.random.RandomState(11)
    f0, f1 = frames[0], frames[2]
    return dict(rig=rig, Ts=Ts, X=X, descs=_noisy(descs, rng), f0=f0, f1=f1, rng=rng,
                ang0=[rng.uniform(-np.pi, np.pi, len(k)) for k in f0.keypoints],
                ang1=[rng.uniform(-np.pi, np.pi, len(k)) for k in f1.keypoints])


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(ref_native, "available", lambda name="graph_builder": False)
    else:
        assert native.available() and ref_native.available()
    return request.param


def _tcw(Twb, Tbc):
    return np.linalg.inv(Twb @ Tbc)


def test_hamming_table_equals_native(scene):
    a = scene["descs"]
    b = scene["f1"].descriptors[2]
    D = matcher.hamming_table(a, b).numpy()
    np.testing.assert_array_equal(D, native.hamming_matrix(a, b))
    np.testing.assert_array_equal(D, np.asarray(ref_matcher.hamming_table(a, b)))
    bits = np.unpackbits(a, axis=1)[:, None, :] != np.unpackbits(b, axis=1)[None, :, :]
    np.testing.assert_array_equal(D, bits.sum(-1))


def test_match_reduce_equals_native(scene):
    a, b = scene["descs"], scene["f1"].descriptors[0]
    bj, bd, sd, cb = matcher.match_reduce(a, b)
    nbj, nbd, nsd = native.hamming_best(a, b)
    np.testing.assert_array_equal(bj, nbj)
    np.testing.assert_array_equal(bd, nbd)
    np.testing.assert_array_equal(sd, nsd)
    np.testing.assert_array_equal(cb, native.hamming_best(b, a)[0])


@pytest.mark.parametrize("variant", ["plain", "angles", "loose"])
def test_match_descriptors(scene, path, variant):
    f0, f1 = scene["f0"], scene["f1"]
    for c in range(3):
        kw = dict(max_dist=matcher.TH_LOW, ratio=0.7)
        if variant == "angles":
            kw.update(ang1=scene["ang0"][c], ang2=scene["ang1"][c])
        if variant == "loose":
            kw = dict(max_dist=matcher.TH_HIGH, ratio=0.95, mutual=False)
        d1 = _noisy(f0.descriptors[c], np.random.RandomState(c))
        got = matcher.match_descriptors(d1, f1.descriptors[c], **kw)
        want = ref_matcher.match_descriptors(d1, f1.descriptors[c], **kw)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() > 20


@pytest.mark.parametrize("scaled", [False, True])
def test_search_by_projection(scene, path, scaled):
    rig, f1 = scene["rig"], scene["f1"]
    sf = rig.scale_factor ** np.arange(rig.n_levels) if scaled else None
    for c in range(rig.n_cams):
        Tcw = _tcw(scene["Ts"][2] @ host_geom.exp_se3(np.full(6, 2e-3)), rig.Tbc[c])
        args = (scene["X"], scene["descs"], f1.keypoints[c], f1.descriptors[c],
                f1.kp_octaves[c], Tcw, rig.K[c])
        got = matcher.search_by_projection(*args, radius=5.0, scale_factors=sf)
        want = ref_matcher.search_by_projection(*args, radius=5.0, scale_factors=sf)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() > 20


@pytest.mark.parametrize("stereo", [False, True])
def test_search_by_projection_frustum(scene, path, stereo):
    rig, f1, rng = scene["rig"], scene["f1"], np.random.RandomState(5)
    X = scene["X"]
    n = len(X)
    normals = rng.randn(n, 3) * 0.2 + np.array([0.0, 0.0, 1.0])
    normals[: n // 10] = 0.0
    dist = np.linalg.norm(X - scene["Ts"][0][:3, 3], axis=1)
    max_d = dist * rng.uniform(0.9, 1.6, n)
    max_d[n // 10: n // 5] = 0.0
    min_d = max_d / rig.scale_factor ** (rig.n_levels - 1)
    c = rig.n_cams - 1 if stereo else 0
    octs = rng.randint(0, 3, len(f1.keypoints[c]))
    Tcw = _tcw(scene["Ts"][2], rig.Tbc[c])
    args = (X, scene["descs"], normals, min_d, max_d, f1.keypoints[c], f1.descriptors[c],
            octs, Tcw, rig.K[c])
    kw = dict(scale_factor=rig.scale_factor, n_levels=rig.n_levels)
    if stereo:
        kw.update(kp_ur=f1.kp_ur, bf=rig.bf)
    got, vis = matcher.search_by_projection_frustum(*args, **kw)
    want, rvis = ref_matcher.search_by_projection_frustum(*args, **kw)
    np.testing.assert_array_equal(vis, rvis)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 10


@pytest.mark.parametrize("angles", [False, True])
def test_search_for_triangulation(scene, path, angles):
    rig, f0, f1 = scene["rig"], scene["f0"], scene["f1"]
    Kinv = np.linalg.inv(np.array([[rig.K[0, 0], 0, rig.K[0, 2]], [0, rig.K[0, 1], rig.K[0, 3]],
                                   [0, 0, 1.0]]))
    T12 = _tcw(scene["Ts"][0], rig.Tbc[0]) @ np.linalg.inv(_tcw(scene["Ts"][2], rig.Tbc[0]))
    t = T12[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F12 = Kinv.T @ tx @ T12[:3, :3] @ Kinv
    kw = dict(ang1=scene["ang0"][0], ang2=scene["ang1"][0]) if angles else {}
    args = (f0.keypoints[0], _noisy(f0.descriptors[0], np.random.RandomState(3)),
            f1.keypoints[0], f1.descriptors[0], F12)
    got = matcher.search_for_triangulation(*args, epi_th=40.0, **kw)
    want = ref_matcher.search_for_triangulation(*args, epi_th=40.0, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 10


def test_rotation_consistency(scene):
    rng = np.random.RandomState(9)
    idx = np.where(rng.rand(200) < 0.7, rng.randint(0, 150, 200), -1)
    ang1 = rng.uniform(-np.pi, np.pi, 200)
    ang2 = np.concatenate([ang1[:150] + 0.3 + rng.randn(150) * 0.02, np.zeros(0)])
    ang2[rng.rand(150) < 0.2] += 1.5
    np.testing.assert_array_equal(matcher.rotation_consistency(idx, ang1, ang2),
                                  ref_matcher.rotation_consistency(idx, ang1, ang2))
