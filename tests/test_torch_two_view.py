"""Parity of the port's two-view initializer (`ransac/two_view.py`) with the
JAX reference, on the scenes of tests/test_two_view_and_pnp.py.

Singular vectors are defined only up to sign, and LAPACK (the port on the
CPU), cuSOLVER (the card) and XLA need not pick the same one. So the best
F is compared up to sign and scale, H (normalized by H[2, 2]) to 1e-9, and
the result exactly where it is discrete (`ok`, `used_homography`,
`n_good`, the triangulated mask) and to 1e-8 where it is not (R, t, the
points). The chosen motion is compared where the reconstruction is `ok`:
then it is the unique best candidate (`n_similar == 1`); where every
candidate ties (say at 0 good points) `argmax` takes the first, and which
motion comes first depends on the signs. One run flips the signs of every
SVD's singular vectors: the four E motions and the eight homography
motions then come in another order, and the chosen motion must be the
same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.ransac import two_view as jtv
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.ransac import two_view as ttv
from test_two_view_and_pnp import make_two_view

F64 = torch.float64
# (planar, seed, hypotheses, outlier share): test_two_view_fundamental_path,
# a planar scene, a clean general scene and a planar scene with more
# outliers. The reference's scoring takes F on its planar scenes (F fits a
# plane's points as well as H, and its 1-D transfer error scores higher),
# so those end not `ok`.
CASES = {"general": (False, 1, 64, 0.1), "planar": (True, 2, 64, 0.1),
         "general_clean": (False, 2, 64, 0.0), "planar_outliers": (True, 4, 64, 0.25)}


def samples(n, n_hyp, seed=0):
    return np.stack([np.random.RandomState(seed + h).choice(n, 8, replace=False)
                     for h in range(n_hyp)])


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's jitted reconstruct on every case (one compile)."""
    run = jax.jit(jtv.reconstruct)
    out = {}
    for name, (planar, seed, n_hyp, out_frac) in CASES.items():
        data, R_gt, t_gt, _ = make_two_view(planar=planar, seed=seed, outlier_frac=out_frac)
        S = samples(120, n_hyp)
        out[name] = (data, S, run(data, jnp.asarray(S, jnp.int32)), R_gt)
    return out


def best_models(data, S):
    """The port's best F and H of the hypotheses, as reconstruct picks them."""
    kpn1, T1 = ttv._normalize(data.kp1, data.valid)
    kpn2, T2 = ttv._normalize(data.kp2, data.valid)
    p1, p2 = kpn1[S], kpn2[S]
    F_h = T2.T @ ttv._fundamental_8pt(p1, p2) @ T1
    H_h = torch.linalg.inv(T2) @ ttv._homography_4pt(p1, p2) @ T1
    H_h = H_h / H_h[:, 2:3, 2:3]
    return F_h[torch.argmax(ttv._score_F(F_h, data)[0])], H_h[torch.argmax(ttv._score_H(H_h,
                                                                                       data)[0])]


def reference_models(data, S):
    kpn1, T1 = jtv._normalize(data.kp1, data.valid)
    kpn2, T2 = jtv._normalize(data.kp2, data.valid)

    def hypo(idx):
        F = T2.T @ jtv._fundamental_8pt(kpn1[idx], kpn2[idx]) @ T1
        H = jnp.linalg.inv(T2) @ jtv._homography_4pt(kpn1[idx], kpn2[idx]) @ T1
        H = H / H[2, 2]
        return F, jtv._score_F(F, data)[0], H, jtv._score_H(H, data)[0]

    F, sF, H, sH = jax.jit(jax.vmap(hypo))(jnp.asarray(S))
    return np.asarray(F[jnp.argmax(sF)]), np.asarray(H[jnp.argmax(sH)])


def assert_same_result(got, ref, name):
    assert bool(got.ok) == bool(ref.ok), name
    assert bool(got.used_homography) == bool(ref.used_homography), name
    assert int(got.n_good) == int(ref.n_good), name
    np.testing.assert_array_equal(got.triangulated.numpy(), np.asarray(ref.triangulated),
                                  err_msg=name)
    if not bool(ref.ok):
        return
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-8, err_msg=name)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-8, err_msg=name)
    m = np.asarray(ref.triangulated)
    np.testing.assert_allclose(got.X.numpy()[m], np.asarray(ref.X)[m], rtol=1e-8, atol=1e-8,
                               err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reconstruct_matches_reference(reference_runs, case):
    data, S, ref, R_gt = reference_runs[case]
    tdata = convert.two_view_from_reference(data)
    got = ttv.reconstruct(tdata, torch.tensor(S))
    assert_same_result(got, ref, case)
    F, H = best_models(tdata, torch.tensor(S))
    jF, jH = reference_models(data, S)
    Fn, jFn = F.numpy() / np.linalg.norm(F.numpy()), jF / np.linalg.norm(jF)
    assert min(np.abs(Fn - jFn).max(), np.abs(Fn + jFn).max()) <= 1e-9, case
    np.testing.assert_allclose(H.numpy(), jH, rtol=1e-9, atol=1e-9, err_msg=case)
    if case.startswith("general"):  # tests/test_two_view_and_pnp.py:49-65
        assert bool(got.ok) and not bool(got.used_homography) and int(got.n_good) > 80
        np.testing.assert_allclose(got.R.numpy(), R_gt, atol=5e-2)


def flipped_svd(svd):
    """torch.linalg.svd with the signs of singular-vector pairs 0 and last
    flipped (and, past the rank, the last right vector alone): still an SVD
    of the same matrix."""
    def run(A, full_matrices=True, **kw):
        U, S, Vh = svd(A, full_matrices=full_matrices, **kw)
        U, Vh = U.clone(), Vh.clone()
        k = min(A.shape[-2:]) - 1
        for j in (0, k):
            U[..., :, j] = -U[..., :, j]
            Vh[..., j, :] = -Vh[..., j, :]
        if Vh.shape[-2] > k + 1:
            Vh[..., -1, :] = -Vh[..., -1, :]
        return U, S, Vh

    return run


@pytest.mark.parametrize("case", ["general", "planar"])
def test_flipped_singular_vectors_choose_the_same_motion(reference_runs, case, monkeypatch):
    data, S, ref, _ = reference_runs[case]
    tdata = convert.two_view_from_reference(data)
    plain = ttv.reconstruct(tdata, torch.tensor(S))
    Rs, ts, _ = ttv._faugeras_motions(best_models(tdata, torch.tensor(S))[1], tdata.K)
    F = best_models(tdata, torch.tensor(S))[0]
    Km = ttv._K_matrix(tdata.K)
    R1, R2, tE = ttv._decompose_E(Km.T @ F @ Km)
    monkeypatch.setattr(torch.linalg, "svd", flipped_svd(torch.linalg.svd))
    flipped = ttv.reconstruct(tdata, torch.tensor(S))
    fR1, fR2, ftE = ttv._decompose_E(Km.T @ F @ Km)
    fRs, fts, _ = ttv._faugeras_motions(best_models(tdata, torch.tensor(S))[1], tdata.K)
    monkeypatch.undo()
    # the flip swaps R1 and R2 and negates t: the E motions are reordered
    np.testing.assert_allclose(fR1.numpy(), R2.numpy(), atol=1e-12)
    np.testing.assert_allclose(fR2.numpy(), R1.numpy(), atol=1e-12)
    np.testing.assert_allclose(ftE.numpy(), -tE.numpy(), atol=1e-12)
    # the homography's 8 motions are the same set in another order
    order = [int(np.argmin([float((fRs[i] - Rs[j]).abs().max() + (fts[i] - ts[j]).abs().max())
                            for j in range(8)])) for i in range(8)]
    assert sorted(order) == list(range(8)) and order != list(range(8))
    np.testing.assert_allclose(fRs.numpy(), Rs[order].numpy(), atol=1e-10)
    np.testing.assert_allclose(fts.numpy(), ts[order].numpy(), atol=1e-10)
    assert_same_result(flipped, ref, case + " flipped")
    assert_same_result(plain, ref, case)


def test_faugeras_motions_match_reference():
    """The 8 candidates of a plane-induced homography
    (tests/test_two_view_and_pnp.py:68-100) against the reference's, and
    one of them the true motion."""
    from amcslam_tpu.ops import lie as jlie

    R_gt = np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.2, 0.1])))
    t_gt = np.array([0.4, -0.1, 0.2])
    n = np.array([0.1, -0.05, 1.0])
    n /= np.linalg.norm(n)
    Km = np.array([[420.0, 0, 480.0], [0, 420.0, 300.0], [0, 0, 1]])
    H = Km @ (R_gt + np.outer(t_gt, n) / 8.0) @ np.linalg.inv(Km)
    K4 = np.array([420.0, 420.0, 480.0, 300.0])
    Rs, ts, degen = ttv._faugeras_motions(torch.tensor(H), torch.tensor(K4))
    jRs, jts, jdegen = jtv._faugeras_motions(jnp.asarray(H), jnp.asarray(K4), jnp.float64)
    assert bool(degen) == bool(jdegen) is False
    # up to the order the SVD signs give
    for i in range(8):
        err = [np.abs(Rs[i].numpy() - np.asarray(jRs[j])).max()
               + np.abs(ts[i].numpy() - np.asarray(jts[j])).max() for j in range(8)]
        assert min(err) <= 1e-10, (i, err)
    t_unit = t_gt / np.linalg.norm(t_gt)
    assert min(np.abs(Rs[i].numpy() - R_gt).max()
               + min(np.abs(ts[i].numpy() - t_unit).max(), np.abs(ts[i].numpy() + t_unit).max())
               for i in range(8)) < 1e-5
