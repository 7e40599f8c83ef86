"""The port's host utilities against the JAX reference's: `solver/debug.py`
(CSV dumps, central-difference Jacobians, edge Hessians) and
`pipeline/viewer.py` (the map render and the keypoint mosaic), on the
reference's `tests/test_loop_closing.py` loop map (the port's
`build_loop_map`, draw for draw) and a `make_sequence` frame.
Tolerances: the CSV dump byte for byte; central differences 1e-6 against
the reference's and 1e-5 against the analytic Jacobian; Hessians 1e-10;
the drawn coordinates exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from amcslam_tpu.ops import lie as jlie
from amcslam_tpu.pipeline import viewer as jviewer
from amcslam_tpu.solver import debug as jdebug
from amcslam_tpu_torch.factors import reprojection as trep
from amcslam_tpu_torch.ops import lie
from amcslam_tpu_torch.pipeline import viewer
from amcslam_tpu_torch.solver import debug
from amcslam_tpu_torch.utils.synthetic import build_loop_map, make_sequence
from test_loop_closing import build_loop_map as ref_build_loop_map


def test_save_matrix_writes_the_reference_csv(tmp_path):
    M = np.random.RandomState(0).randn(5, 7)
    debug.save_matrix(str(tmp_path / "port.csv"), torch.tensor(M))
    jdebug.save_matrix(str(tmp_path / "ref.csv"), jnp.asarray(M))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def test_numerical_jacobian_and_edge_hessian_match_reference():
    """A stereo reprojection edge under the SE(3) right retraction: the
    port's central differences equal the reference's, and both the
    analytic Jacobian; J^T Omega J as the reference's."""
    rng = np.random.RandomState(1)
    T = lie.exp_se3(torch.tensor(rng.randn(6) * 0.3))
    Tbc = lie.exp_se3(torch.tensor(rng.randn(6) * 0.05))
    K = torch.tensor([420.0, 420.0, 480.0, 300.0], dtype=torch.float64)
    X = torch.tensor(rng.randn(3) + np.array([0.0, 0.0, 6.0]))
    X = lie.transform_point(T, lie.transform_point(Tbc, X))
    obs = torch.tensor([470.0, 310.0, 463.0], dtype=torch.float64)

    def residual(Twb):
        return trep.stereo_residual(Twb, Tbc, K, 40.0, X, obs)[0]

    def retract(Twb, d):
        return Twb @ lie.exp_se3(d)

    _, J, Jl, _ = trep.stereo_residual_jac(T, Tbc, K, 40.0, X, obs)
    err, J_num = debug.check_jacobian(residual, retract, T, J[:, :6], 6)
    assert err <= 1e-5

    def jresidual(Twb):
        Xc = jlie.transform_point(jlie.se3_inv(jnp.asarray(Tbc.numpy())),
                                  jlie.transform_point(jlie.se3_inv(Twb), jnp.asarray(X.numpy())))
        u = 420.0 * Xc[0] / Xc[2] + 480.0
        return jnp.asarray(obs.numpy()) - jnp.stack([u, 420.0 * Xc[1] / Xc[2] + 300.0,
                                                     u - 40.0 / Xc[2]])

    J_ref = jdebug.numerical_jacobian(jresidual, lambda Twb, d: Twb @ jlie.exp_se3(d),
                                      jnp.asarray(T.numpy()), 6)
    np.testing.assert_allclose(J_num, np.asarray(J_ref), rtol=1e-6, atol=1e-6)
    info = np.diag([1.0, 2.0, 0.5])
    H = debug.edge_hessian([J[:, :6], Jl], info)
    H_ref = jdebug.edge_hessian([jnp.asarray(J[:, :6].numpy()), jnp.asarray(Jl.numpy())], info)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=1e-10, atol=1e-10)


def scatter_and_lines(fig):
    ax = fig.axes[0]
    return ([np.asarray(c.get_offsets()) for c in ax.collections],
            [np.asarray(line.get_xydata()) for line in ax.lines])


def test_viewer_draws_the_reference_map_and_writes_a_png(tmp_path):
    import matplotlib.pyplot as plt

    m, _, kfs, _ = build_loop_map(n_kf=14, n_lm=60, n_local=10, seed=0)
    rm, _, rkfs, _ = ref_build_loop_map(n_kf=14, n_lm=60, n_local=10, seed=0)
    traj = [(k.timestamp, k.Twb) for k in kfs]
    rtraj = [(k.timestamp, k.Twb) for k in rkfs]
    fig, rfig = viewer.draw_map(m, trajectory=traj), jviewer.draw_map(rm, trajectory=rtraj)
    (pts, lines), (rpts, rlines) = scatter_and_lines(fig), scatter_and_lines(rfig)
    plt.close(fig)
    plt.close(rfig)
    assert len(pts) == len(rpts) == 1 and len(pts[0]) == len(m.map_points)
    np.testing.assert_array_equal(pts[0], rpts[0])
    assert len(lines) == len(rlines) >= 2  # keyframes, covisibility edges, trajectory
    for a, b in zip(lines, rlines):
        np.testing.assert_array_equal(a, b)
    out = viewer.draw_map(m, trajectory=traj, path=str(tmp_path / "map.png"))
    assert out == str(tmp_path / "map.png")
    assert (tmp_path / "map.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_frame_mosaic_writes_a_png(tmp_path):
    frames, _, _, _ = make_sequence(n_frames=1, n_cams=3, n_lm=80, seed=0)
    f = frames[0]
    f.matches[::2] = 0  # every other keypoint matched
    path = viewer.draw_frame_mosaic(f, images=[np.zeros((600, 960))] * 3,
                                    path=str(tmp_path / "mosaic.png"))
    assert (tmp_path / "mosaic.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert path == str(tmp_path / "mosaic.png")
