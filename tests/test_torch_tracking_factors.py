"""Parity of the port's tracking-path factors with the JAX reference.

The per-edge factors of the pose solver (`mono_residual[_jac]`,
`mono_gp_residual[_jac]`, `stereo_gp_residual_jac`) and the MC-RANSAC
velocity model (`vel_reproj_residual`, `vel_reproj_jac`): the same numpy
inputs go through the reference (vmapped, float64, CPU) and the port
(batched, float64, CPU), over generic, near-pi and tiny rotations.
Tolerance: max |a-b|/(1+|b|) <= 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.factors import priors as jpriors
from amcslam_tpu.factors import reprojection as jrep
from amcslam_tpu.ops import lie as jlie
from amcslam_tpu_torch.factors import priors as tpriors
from amcslam_tpu_torch.factors import reprojection as trep
from amcslam_tpu_torch.ops import interp_chain
from test_torch_factors import assert_tree_close, tt

N = 16
CASES = ["generic", "near_pi", "tiny"]


def expse3(xi):
    return np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(xi)))


def in_front(Twc, rng, n=N):
    """World points 4-12 m in front of each camera pose Twc (n,4,4)."""
    Xc = rng.uniform([-2, -2, 4], [2, 2, 12], (n, 3))
    return np.einsum("nij,nj->ni", Twc[:, :3, :3], Xc) + Twc[:, :3, 3]


def setup(seed, case):
    """Endpoint states, camera and landmarks of N GP edges. near_pi: the
    first pose and the pair's relative rotation are pi - 1e-3 turns; tiny:
    every rotation, twist and increment is of order 1e-6."""
    rng = np.random.RandomState(seed)
    xi1 = rng.randn(N, 6) * 0.3
    dxi = rng.randn(N, 6) * 0.05
    scale_v = 0.4
    if case == "near_pi":
        ax = rng.randn(N, 2, 3)
        ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
        xi1[:, 3:] = ax[:, 0] * (np.pi - 1e-3)
        dxi[:, 3:] = ax[:, 1] * (np.pi - 1e-3)
    if case == "tiny":
        xi1 *= 1e-6
        dxi *= 1e-6
        scale_v = 1e-6
    T1 = expse3(xi1)
    T2 = np.einsum("nij,njk->nik", T1, expse3(dxi))
    v1 = rng.randn(N, 6) * scale_v
    v2 = rng.randn(N, 6) * scale_v
    t1 = rng.uniform(0.0, 5.0, N)
    t2 = t1 + rng.uniform(0.05, 0.5, N)
    t = t1 + rng.uniform(0.0, 1.0, N) * (t2 - t1)
    Tbc = expse3(rng.randn(N, 6) * 0.2)
    K = np.tile([420.0, 420.0, 480.0, 300.0], (N, 1))
    obs = rng.rand(N, 2) * 100 + 400
    return dict(T1=T1, v1=v1, T2=T2, v2=v2, t1=t1, t2=t2, t=t, Tbc=Tbc, K=K,
                obs=obs, obs3=np.concatenate([obs, obs[:, :1] - 3.0], 1),
                bf=np.full(N, 40.0), rng=rng)


def gp_inputs(d):
    """Landmarks in front of the GP-interpolated camera of each edge."""
    eye = jnp.eye(6)
    Twb = jax.vmap(lambda T1, T2, v1, v2, t1, t2, t: jrep.gp.query_pose(
        T1, T2, v1, v2, t1, t2, t, eye, eye))(
        *(jnp.asarray(d[k]) for k in ("T1", "T2", "v1", "v2", "t1", "t2", "t")))
    return in_front(np.einsum("nij,njk->nik", np.asarray(Twb), d["Tbc"]), d["rng"])


def run(jfn, tfn, *args):
    ref = jax.vmap(jfn)(*(jnp.asarray(a) for a in args))
    got = tfn(*(tt(a) for a in args))
    assert_tree_close(got, ref)
    return got


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["mono_residual", "mono_residual_jac"])
def test_mono_factor_matches_reference(fn, case):
    d = setup(1, case)
    Xw = in_front(np.einsum("nij,njk->nik", d["T1"], d["Tbc"]), d["rng"])
    run(getattr(jrep, fn), getattr(trep, fn), d["T1"], d["Tbc"], d["K"], Xw, d["obs"])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["mono_gp_residual", "mono_gp_residual_jac"])
def test_mono_gp_factor_matches_reference(fn, case):
    d = setup(2, case)
    ends = [d[k] for k in ("T1", "v1", "t1", "T2", "v2", "t2", "t")]
    run(getattr(jrep, fn), getattr(trep, fn), *ends, d["Tbc"], d["K"], gp_inputs(d), d["obs"])


@pytest.mark.parametrize("case", CASES)
def test_stereo_gp_factor_matches_reference(case):
    d = setup(3, case)
    ends = [d[k] for k in ("T1", "v1", "t1", "T2", "v2", "t2", "t")]
    run(jrep.stereo_gp_residual_jac, trep.stereo_gp_residual_jac, *ends,
        d["Tbc"], d["K"], d["bf"], gp_inputs(d), d["obs3"])


@pytest.mark.parametrize("case", CASES)
def test_per_edge_mono_gp_equals_interp_pack_path(case):
    """The per-edge factor and the interp-pack path (the plain chain the
    kernel replaces, then mono_gp_residual_jac_interp) agree: the pose
    solver's two branches compute the same edges. The two are different
    factorizations of one chain (J1 sums terms of size ~100 that cancel), so
    they are compared relative to each output's largest entry,
    max |a-b| / (1 + max |b|) <= 1e-12; the reference's own two forms differ
    by the same amount (tests/test_interp_tables.py holds them at 1e-10)."""
    d = setup(4, case)
    Xw = gp_inputs(d)
    a = {k: tt(v) for k, v in d.items() if k != "rng"}
    per_edge = trep.mono_gp_residual_jac(a["T1"], a["v1"], a["t1"], a["T2"], a["v2"], a["t2"],
                                         a["t"], a["Tbc"], a["K"], tt(Xw), a["obs"])
    ip = interp_chain.gp_interp_packs(a["T1"], a["v1"], a["T2"], a["v2"], a["t1"], a["t2"], a["t"])
    packed = trep.mono_gp_residual_jac_interp(ip, a["Tbc"], a["K"], tt(Xw), a["obs"])
    for x, y in zip(per_edge, packed):
        assert float((x - y).abs().max() / (1.0 + y.abs().max())) <= 1e-12


def test_single_pose_pair_broadcasts_like_vmap():
    """The pose solver's per-edge call: one (4,4)/(6,) pose pair and scalar
    endpoint times against a batch of edge times, landmarks and cameras,
    equals the reference's vmap with the endpoints closed over."""
    d = setup(5, "generic")
    Xw = gp_inputs(d)
    pair = {k: d[k][0] for k in ("T1", "v1", "t1", "T2", "v2", "t2")}
    t = pair["t1"] + d["rng"].uniform(0.0, 1.0, N) * (pair["t2"] - pair["t1"])
    ref = jax.vmap(lambda tt_, Tbc, K, X, o: jrep.mono_gp_residual_jac(
        *(jnp.asarray(pair[k]) for k in ("T1", "v1", "t1", "T2", "v2", "t2")),
        tt_, Tbc, K, X, o))(*(jnp.asarray(x) for x in (t, d["Tbc"], d["K"], Xw, d["obs"])))
    got = trep.mono_gp_residual_jac(
        *(tt(pair[k]) for k in ("T1", "v1", "t1", "T2", "v2", "t2")),
        *(tt(x) for x in (t, d["Tbc"], d["K"], Xw, d["obs"])))
    assert_tree_close(got, ref)


def vel_inputs(d, case):
    """Twist, last pose, dt and landmarks in front of T exp(v dt) Tbc."""
    rng = d["rng"]
    scale = 1e-6 if case == "tiny" else 1.0
    v = rng.randn(N, 6) * np.array([1.5, 0.3, 0.3, 0.1, 0.1, 0.4]) * scale
    if case == "near_pi":  # a rotation of nearly pi over dt
        ax = rng.randn(N, 3)
        v[:, 3:] = ax / np.linalg.norm(ax, axis=1, keepdims=True) * (np.pi - 1e-3) / 0.1
    dt = rng.uniform(0.0, 0.1, N)
    if case == "near_pi":
        dt[:] = 0.1
    dt[0] = 0.0  # the RANSAC pad rows have dt = 0
    T = d["T1"]
    Twc = np.einsum("nij,njk,nkl->nil", T, expse3(v * dt[:, None]), d["Tbc"])
    return v, T, dt, in_front(Twc, rng)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["vel_reproj_residual", "vel_reproj_jac"])
def test_vel_reproj_matches_reference(fn, case):
    d = setup(6, case)
    v, T, dt, Xw = vel_inputs(d, case)
    got = run(getattr(jpriors, fn), getattr(tpriors, fn), v, T, dt, d["Tbc"], d["K"], Xw, d["obs"])
    if fn == "vel_reproj_jac":
        # the RANSAC scoring residual is the fit's residual, bit for bit
        r = tpriors.vel_reproj_point_residual(*(tt(a) for a in (v, T, dt, d["Tbc"], d["K"], Xw,
                                                                d["obs"])))
        assert torch.equal(r, got[0])
        assert torch.count_nonzero(got[1][0]) == 0  # dt = 0: no twist sensitivity
