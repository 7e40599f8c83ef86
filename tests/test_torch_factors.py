"""Parity of the port's factors and robust kernel with the JAX reference.

Reprojection (pinhole/stereo at a KF state, interp-pack GP factors), the
GP motion prior, the velocity and extrinsic priors and the Huber kernel:
the same numpy inputs go through the reference (vmapped, float64, CPU) and
the port (batched, float64, CPU). Inputs follow tests/test_factors.py.
Tolerance: max |a-b|/(1+|b|) <= 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.factors import gp_prior as jgp_prior
from amcslam_tpu.factors import priors as jpriors
from amcslam_tpu.factors import reprojection as jrep
from amcslam_tpu.ops import lie as jlie
from amcslam_tpu.solver import robust as jrobust
from amcslam_tpu_torch.factors import gp_prior as tgp_prior
from amcslam_tpu_torch.factors import priors as tpriors
from amcslam_tpu_torch.factors import reprojection as trep
from amcslam_tpu_torch.solver import robust as trobust

TOL = 1e-12
N = 16


def max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))) if a.size else 0.0


def tt(a):
    return torch.tensor(np.asarray(a))


def assert_tree_close(got, ref, tol=TOL):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert max_rel(got[k], ref[k]) <= tol, k
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert max_rel(g, r) <= tol, i
    else:
        assert max_rel(got, ref) <= tol


def expse3(xi):
    return np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(xi)))


def setup(seed=0, n=N):
    """Batched version of tests/test_factors.py::setup."""
    rng = np.random.RandomState(seed)
    T1 = expse3(rng.randn(n, 6) * 0.3)
    v1 = rng.randn(n, 6) * 0.4
    v2 = rng.randn(n, 6) * 0.4
    T2 = np.einsum("nij,njk->nik", T1, expse3(v1 * 0.1 + rng.randn(n, 6) * 0.01))
    Tbc = expse3(rng.randn(n, 6) * 0.2)
    K = np.tile([420.0, 420.0, 480.0, 300.0], (n, 1))
    Xw = rng.randn(n, 3) * 2.0 + np.array([0.0, 0.0, 8.0])
    obs = rng.rand(n, 2) * 100 + 400
    t1 = rng.uniform(0.0, 5.0, n)
    t2 = t1 + rng.uniform(0.05, 0.5, n)
    t = t1 + rng.uniform(0.0, 1.0, n) * (t2 - t1)
    return dict(T1=T1, v1=v1, T2=T2, v2=v2, Tbc=Tbc, K=K, Xw=Xw, obs=obs,
                obs3=np.concatenate([obs, obs[:, :1] - 3.0], 1),
                bf=np.full(n, 40.0), t1=t1, t2=t2, t=t)


def run(name, jfn, tfn, *args):
    ref = jax.vmap(jfn)(*(jnp.asarray(a) for a in args))
    got = tfn(*(tt(a) for a in args))
    assert_tree_close(got, ref)


def Xc_of(d):
    Tcw = np.linalg.inv(np.einsum("nij,njk->nik", d["T1"], d["Tbc"]))
    return np.einsum("nij,nj->ni", Tcw[:, :3, :3], d["Xw"]) + Tcw[:, :3, 3]


@pytest.mark.parametrize("fn", ["project_pinhole", "project_jac_pinhole"])
def test_pinhole_projection_matches_reference(fn):
    d = setup(1)
    run(fn, getattr(jrep, fn), getattr(trep, fn), d["K"], Xc_of(d))


@pytest.mark.parametrize("fn", ["project_stereo", "project_jac_stereo"])
def test_stereo_projection_matches_reference(fn):
    d = setup(2)
    run(fn, getattr(jrep, fn), getattr(trep, fn), d["K"], d["bf"], Xc_of(d))


def test_se3_deriv_matches_reference():
    d = setup(3)
    run("_se3_deriv", jrep._se3_deriv, trep._se3_deriv, d["Tbc"][:, :3, :3], d["Xw"])


@pytest.mark.parametrize("fn", ["stereo_residual", "stereo_residual_jac"])
def test_stereo_factor_matches_reference(fn):
    d = setup(4)
    run(fn, getattr(jrep, fn), getattr(trep, fn),
        d["T1"], d["Tbc"], d["K"], d["bf"], d["Xw"], d["obs3"])


def test_pair_and_interp_packs_match_reference():
    d = setup(5)
    pack_ref = jax.vmap(jrep.gp_pair_pack)(
        *(jnp.asarray(d[k]) for k in ("T1", "v1", "T2", "v2")))
    pack = trep.gp_pair_pack(*(tt(d[k]) for k in ("T1", "v1", "T2", "v2")))
    assert_tree_close(pack, pack_ref)
    ip_ref = jax.vmap(jrep.gp_interp_pack)(
        pack_ref, *(jnp.asarray(d[k]) for k in ("T1", "v1", "t1", "t2", "t")))
    ip = trep.gp_interp_pack(pack, *(tt(d[k]) for k in ("T1", "v1", "t1", "t2", "t")))
    assert_tree_close(ip, ip_ref)


def _interp_pack_inputs(d):
    pack = jax.vmap(jrep.gp_pair_pack)(*(jnp.asarray(d[k]) for k in ("T1", "v1", "T2", "v2")))
    ip = jax.vmap(jrep.gp_interp_pack)(
        pack, *(jnp.asarray(d[k]) for k in ("T1", "v1", "t1", "t2", "t")))
    # landmarks in front of the interpolated camera
    Tcw = np.linalg.inv(np.einsum("nij,njk->nik", np.asarray(ip["Twb"]), d["Tbc"]))
    Twc = np.linalg.inv(Tcw)
    Xc = np.random.RandomState(9).uniform([-2, -2, 4], [2, 2, 12], (N, 3))
    Xw = np.einsum("nij,nj->ni", Twc[:, :3, :3], Xc) + Twc[:, :3, 3]
    return {k: np.asarray(v) for k, v in ip.items()}, Xw


def test_mono_gp_interp_factors_match_reference():
    d = setup(6)
    ip, Xw = _interp_pack_inputs(d)
    ref = jax.vmap(jrep.mono_gp_residual_jac_interp)(
        {k: jnp.asarray(v) for k, v in ip.items()},
        *(jnp.asarray(a) for a in (d["Tbc"], d["K"], Xw, d["obs"])))
    got = trep.mono_gp_residual_jac_interp(
        {k: tt(v) for k, v in ip.items()}, *(tt(a) for a in (d["Tbc"], d["K"], Xw, d["obs"])))
    assert_tree_close(got, ref)
    run("mono_gp_residual_interp", jrep.mono_gp_residual_interp,
        trep.mono_gp_residual_interp, ip["Tbw"], d["Tbc"], d["K"], Xw, d["obs"])


def test_stereo_gp_interp_factors_match_reference():
    d = setup(7)
    ip, Xw = _interp_pack_inputs(d)
    ref = jax.vmap(jrep.stereo_gp_residual_jac_interp)(
        {k: jnp.asarray(v) for k, v in ip.items()},
        *(jnp.asarray(a) for a in (d["Tbc"], d["K"], d["bf"], Xw, d["obs3"])))
    got = trep.stereo_gp_residual_jac_interp(
        {k: tt(v) for k, v in ip.items()},
        *(tt(a) for a in (d["Tbc"], d["K"], d["bf"], Xw, d["obs3"])))
    assert_tree_close(got, ref)
    run("stereo_gp_residual_interp", jrep.stereo_gp_residual_interp,
        trep.stereo_gp_residual_interp, ip["Tbw"], d["Tbc"], d["K"], d["bf"], Xw, d["obs3"])


def test_shared_extrinsic_broadcasts_like_vmap():
    """A single (4,4) extrinsic and (4,) intrinsics serve a batch of edges
    (the stereo-GP call site) and equal the per-edge reference."""
    d = setup(8)
    ip, Xw = _interp_pack_inputs(d)
    Tbc, K, bf = d["Tbc"][0], d["K"][0], 40.0
    ref = jax.vmap(lambda i, x, o: jrep.stereo_gp_residual_jac_interp(
        i, jnp.asarray(Tbc), jnp.asarray(K), jnp.asarray(bf), x, o))(
        {k: jnp.asarray(v) for k, v in ip.items()}, jnp.asarray(Xw), jnp.asarray(d["obs3"]))
    got = trep.stereo_gp_residual_jac_interp(
        {k: tt(v) for k, v in ip.items()}, tt(Tbc), tt(K), torch.tensor(bf, dtype=torch.float64),
        tt(Xw), tt(d["obs3"]))
    assert_tree_close(got, ref)


@pytest.mark.parametrize("fn", ["gp_prior_residual", "gp_prior_residual_jac"])
def test_gp_prior_matches_reference(fn):
    d = setup(10)
    run(fn, getattr(jgp_prior, fn), getattr(tgp_prior, fn),
        d["T1"], d["v1"], d["t1"], d["T2"], d["v2"], d["t2"])


@pytest.mark.parametrize("fn", ["extrinsic_prior_residual", "extrinsic_prior_jac"])
def test_extrinsic_prior_matches_reference(fn):
    d = setup(11)
    R_prior = expse3(np.random.RandomState(3).randn(N, 6) * 0.1)[:, :3, :3]
    run(fn, getattr(jpriors, fn), getattr(tpriors, fn), d["Tbc"], R_prior)


@pytest.mark.parametrize("fn", ["velocity_residual", "velocity_jac"])
def test_velocity_prior_matches_reference(fn):
    run(fn, getattr(jpriors, fn), getattr(tpriors, fn), setup(12)["v1"])


@pytest.mark.parametrize("enabled", [True, False])
def test_huber_matches_reference(enabled):
    s = np.concatenate([np.linspace(0.0, 20.0, 41), [1e-30, 0.0, 5.991, 1e6]])
    delta = np.sqrt(5.991)
    ref = jrobust.huber_rho01(jnp.asarray(s), jnp.asarray(delta), enabled)
    got = trobust.huber_rho01(tt(s), delta, enabled)
    assert_tree_close(got, ref)
    # per-edge deltas (the stereo-camera edges mix two)
    deltas = np.where(np.arange(s.size) % 2 == 0, np.sqrt(5.991), np.sqrt(7.815))
    ref = jrobust.huber_rho01(jnp.asarray(s), jnp.asarray(deltas), enabled)
    got = trobust.huber_rho01(tt(s), tt(deltas), torch.tensor(enabled))
    assert_tree_close(got, ref)
