"""Parity of the port's multi-device solvers with the JAX reference (float64,
CPU): `amcslam_tpu_torch/parallel/` on 4 gloo ranks (processes) against
`amcslam_tpu/parallel/` on a 4-device virtual mesh and against the
reference's single-device problems, at the shapes and tolerances of
tests/test_sharded_ba.py.

  * `shard_ba_data` / `shard_eg_data` equal the reference's array for
    array at n = 2 and 4, on a problem whose mono-GP edges avoid one shard
    (and, as every generated problem, with no GP-stereo edge at all);
  * the landmark-sharded BA: chi2 1e-12, Hpp/bp 1e-8, the pose step 1e-9,
    dx.dx / dx.b 1e-9, the landmark step through `lm_perm` 1e-9; 3 LM
    iterations chi2 1e-10, T 1e-9; the gp_huber global BA chi2 1e-8, T 1e-8;
  * the edge-sharded essential graph: chi2 1e-12, D/b 1e-9, the step 1e-7,
    5 LM iterations chi2 1e-9, t 1e-7;
  * every rank returns the same replicated state, bit for bit;
  * `sim3_opt._pcg` with `reduce=None` is bit-equal to the unsharded
    solve, and a one-rank sharded problem to the single-device one.

One `run_ranks` spawn of 4 ranks runs the sharded jobs of both families
(a module fixture); the reference's jitted closures compile on threads
meanwhile.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from amcslam_tpu.parallel import sharded_ba as jsba
from amcslam_tpu.parallel import sharded_eg as jseg
from amcslam_tpu.solver.ba import make_ba_problem as j_make_ba_problem
from amcslam_tpu.solver.lm import lm_optimize as j_lm_optimize
from amcslam_tpu.solver.sim3_opt import make_essential_graph_problem_pcg as j_eg_pcg
from amcslam_tpu.utils.synthetic import make_essential_graph as j_make_eg
from amcslam_tpu.utils.synthetic import make_local_ba_problem as j_make_ba
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.parallel import group, sharded_ba, sharded_eg
from amcslam_tpu_torch.solver import ba as tba
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.solver import sim3_opt as tso

N = 4  # ranks / mesh devices
LAM_BA = 0.5
LAM_EG = 1e-6
DEADLINE_S = 300.0


def np_(x):
    return np.asarray(x)


def mesh(axis):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def blocks_cat(results, key):
    return np.concatenate([r[key] for r in results])


# ---------------------------------------------------------------------------
# host-side sharding
# ---------------------------------------------------------------------------


def ba_problem_avoiding_a_shard(n_shards):
    """A problem (n_kf=6, 48 landmarks, seed 11) whose mono-GP edges all
    avoid shard 1 of `n_shards`, and which has no GP-stereo edge at all (the
    generator makes none): the padding of a shard without edges of one
    family (tests/test_sharded_ba.py:98-105)."""
    data, state0, _ = j_make_ba(n_kf=6, n_fixed=1, n_lm=48, obs_per_lm=3, gpobs_per_lm=2,
                                seed=11)
    keep = np_(data.mg_lm) % n_shards != 1
    assert keep.any() and not keep.all() and data.sg_lm.shape[0] == 0
    cut = {k: jnp.asarray(np_(getattr(data, k))[keep])
           for k in ("mg_pair", "mg_lm", "mg_cam", "mg_t", "mg_obs", "mg_w", "mg_valid",
                     "mg_close", "mg_sid", "mg_it")}
    return data._replace(**cut), state0


def assert_equal_fields(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_ba_data_equals_reference(n_shards):
    for data, state0 in (ba_problem_avoiding_a_shard(n_shards),
                         j_make_ba(n_kf=4, n_fixed=1, n_lm=32, obs_per_lm=2, seed=7)[:2]):
        want = convert.sharded_ba_from_reference(jsba.shard_ba_data(data, state0, n_shards))
        got = sharded_ba.shard_ba_data(data, state0, n_shards)
        assert_equal_fields(got.data, want.data)
        assert_equal_fields(got.state0, want.state0)
        assert np.array_equal(got.lm_perm, want.lm_perm)
        assert (got.n_shards, got.lm_per_shard) == (want.n_shards, want.lm_per_shard)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_eg_data_equals_reference(n_shards):
    data, _, _ = j_make_eg(n_kf=48, n_loop=6, seed=3)
    want = convert.sharded_eg_from_reference(jseg.shard_eg_data(data, n_shards))
    got = sharded_eg.shard_eg_data(data, n_shards)
    assert_equal_fields(got.data, want.data)
    assert (got.n_shards, got.e_per_shard) == (want.n_shards, want.e_per_shard)
    assert got.data["pairs"].shape[0] > data.pairs.shape[0]  # padded rows exist


def test_local_blocks_and_unshard_round_trip():
    data, state0, _ = j_make_ba(n_kf=4, n_fixed=1, n_lm=30, obs_per_lm=2, seed=7)
    sb = sharded_ba.shard_ba_data(data, state0, N)
    X = [sb.local(r)[1]["X"] for r in range(N)]
    assert all(x.shape == (sb.lm_per_shard, 3) for x in X)
    assert np.array_equal(sharded_ba.unshard_X(sb, X), np_(state0.X))
    d0, _ = sb.local(0)
    assert d0["mg_lm"].shape[0] * N == sb.data["mg_lm"].shape[0]
    assert d0["times"] is sb.data["times"]  # replicated fields are shared


# ---------------------------------------------------------------------------
# the landmark-sharded BA
# ---------------------------------------------------------------------------


def ref_ba_single(data, state0):
    """The reference's single-device problem at seed 7: linearization, one
    solve, a 3-iteration LM (whose initial chi2 is chi2 at the start)."""
    single = j_make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    lin = jax.jit(single.linearize)(state0)
    (dxp, dxl), xx, xb = jax.jit(single.solve)(lin, jnp.asarray(LAM_BA, jnp.float64))
    s, st = jax.jit(lambda s: j_lm_optimize(single, s, 3, lambda_init=1.0))(state0)
    return {"chi2": float(st.initial_chi2), "Hpp": np_(lin[0]), "bp": np_(lin[1]),
            "dxp": np_(dxp), "dxl": np_(dxl), "xx": float(xx), "xb": float(xb),
            "lm_chi2": float(st.chi2), "lm_T": np_(s.T)}


def ref_ba_sharded(data, state0):
    """The reference's sharded problem on a 4-device mesh: chi2,
    linearization and one solve."""
    sb = jsba.shard_ba_data(data, state0, N)
    sharded = jsba.make_sharded_ba_problem(mesh("l"), sb)
    lin = jax.jit(sharded.linearize)(sb.state0)
    (dxp, dxl), xx, xb = jax.jit(sharded.solve)(lin, jnp.asarray(LAM_BA, jnp.float64))
    return {"chi2": float(jax.jit(sharded.chi2)(sb.state0)), "Hpp": np_(lin[0]),
            "bp": np_(lin[1]), "dxp": np_(dxp), "dxl": np_(dxl), "xx": float(xx),
            "xb": float(xb)}


def ref_ba_global(data, state0):
    """The reference's gp_huber global BA, single-device: 4 LM iterations."""
    single = j_make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid,
                               huber_on=True)
    s, st = jax.jit(lambda s: j_lm_optimize(single, s, 4, lambda_init=1e-5))(state0)
    return {"chi2": float(st.initial_chi2), "lm_chi2": float(st.chi2), "lm_T": np_(s.T)}


def ref_eg_single(data, state0):
    """The reference's single-device PCG essential graph: D, b, one solve,
    5 LM iterations (whose initial chi2 is chi2 at the start)."""
    single = j_eg_pcg(data)
    lin = jax.jit(single.linearize)(state0)
    dx, xx, xb = jax.jit(single.solve)(lin, jnp.asarray(LAM_EG, jnp.float64))
    s, st = jax.jit(lambda s: j_lm_optimize(single, s, 5, lambda_init=1e-16))(state0)
    return {"chi2": float(st.initial_chi2), "D": np_(lin[4]), "b": np_(lin[5]), "dx": np_(dx),
            "xx": float(xx), "xb": float(xb), "lm_chi2": float(st.chi2), "lm_t": np_(s.t)}


def ref_eg_sharded(data, state0):
    """The reference's edge-sharded problem on a 4-device mesh: chi2, D, b."""
    sharded = jseg.make_sharded_eg_problem(mesh("e"), jseg.shard_eg_data(data, N))
    lin = jax.jit(sharded.linearize)(state0)
    return {"chi2": float(jax.jit(sharded.chi2)(state0)), "D": np_(lin[4]), "b": np_(lin[5])}


@pytest.fixture(scope="module")
def runs():
    """One spawn of 4 gloo ranks runs every sharded job of both families;
    the reference's closures compile on threads meanwhile."""
    data, state0, _ = j_make_ba(n_kf=4, n_fixed=1, n_lm=32, obs_per_lm=2, seed=7)
    gdata, gstate0, _ = j_make_ba(n_kf=6, n_fixed=1, n_lm=48, obs_per_lm=3, seed=11)
    gdata = gdata._replace(gp_huber=jnp.asarray(True))
    eg_data, eg_state0, _ = j_make_eg(n_kf=48, n_loop=6, seed=3)
    sb = sharded_ba.shard_ba_data(data, state0, N)
    gsb = sharded_ba.shard_ba_data(gdata, gstate0, N)
    se = sharded_eg.shard_eg_data(eg_data, N)
    eg_state = sharded_ba.host_fields(eg_state0)
    jobs = [(sharded_ba.first_step, (sb, LAM_BA)),
            (sharded_ba.run_lm, (sb, 3, 1.0)),
            (sharded_ba.run_lm, (gsb, 4, 1e-5)),
            (sharded_eg.first_step, (se, eg_state, LAM_EG)),
            (sharded_eg.run_lm, (se, eg_state, 5, 1e-16))]
    with ThreadPoolExecutor(2) as pool:
        refs = {"ba": pool.submit(ref_ba_single, data, state0),
                "ba_sharded": pool.submit(ref_ba_sharded, data, state0),
                "global": pool.submit(ref_ba_global, gdata, gstate0),
                "eg": pool.submit(ref_eg_single, eg_data, eg_state0),
                "eg_sharded": pool.submit(ref_eg_sharded, eg_data, eg_state0)}
        ranks = group.run_ranks(group.sequence, N, device="cpu", backend="gloo", args=(jobs,),
                                deadline_s=DEADLINE_S)
        refs = {k: f.result() for k, f in refs.items()}
    assert all(len(r["seconds"]) == len(jobs) for r in ranks)
    out = {"sb": sb, "ref": refs}
    for i, k in enumerate(("step", "lm", "global", "eg_step", "eg_lm")):
        out[k] = [r["results"][i] for r in ranks]
    return out


@pytest.mark.parametrize("against", ["single", "sharded"])
def test_sharded_ba_first_step_matches_reference(runs, against):
    ref = runs["ref"]["ba" if against == "single" else "ba_sharded"]
    step = runs["step"]
    np.testing.assert_allclose(step[0]["chi2"], ref["chi2"], rtol=1e-12)
    np.testing.assert_allclose(step[0]["Hpp"], ref["Hpp"], atol=1e-8)
    np.testing.assert_allclose(step[0]["bp"], ref["bp"], atol=1e-8)
    np.testing.assert_allclose(step[0]["dxp"], ref["dxp"], atol=1e-9)
    np.testing.assert_allclose(step[0]["xx"], ref["xx"], rtol=1e-9)
    np.testing.assert_allclose(step[0]["xb"], ref["xb"], rtol=1e-9)
    dxl = blocks_cat(step, "dxl")
    if against == "sharded":  # the same sharded layout
        np.testing.assert_allclose(dxl, ref["dxl"], atol=1e-9)
    else:
        perm = runs["sb"].lm_perm
        valid = perm >= 0
        np.testing.assert_allclose(dxl[valid], ref["dxl"][perm[valid]], atol=1e-9)
        assert np.all(dxl[~valid] == 0.0)


def test_sharded_ba_lm_matches_reference(runs):
    ref, lm = runs["ref"]["ba"], runs["lm"]
    np.testing.assert_allclose(lm[0]["chi2"], ref["lm_chi2"], rtol=1e-10)
    np.testing.assert_allclose(lm[0]["state"].T, ref["lm_T"], atol=1e-9)


def test_sharded_global_ba_gp_huber_matches_reference(runs):
    """The gp_huber global BA (config 5b's Huber chain over the whole
    sequence) shards the same way."""
    ref, glob = runs["ref"]["global"], runs["global"]
    np.testing.assert_allclose(glob[0]["initial_chi2"], ref["chi2"], rtol=1e-12)
    np.testing.assert_allclose(glob[0]["chi2"], ref["lm_chi2"], rtol=1e-8)
    np.testing.assert_allclose(glob[0]["state"].T, ref["lm_T"], atol=1e-8)


def test_sharded_ba_ranks_agree_bit_for_bit(runs):
    """Every rank returns the same replicated results (the pose states, the
    reduced system, chi2 and the iteration count), and its own landmarks
    moved as the single-device run moved them."""
    for lm in (runs["lm"], runs["global"]):
        for r in lm[1:]:
            for k in ("T", "v", "Text"):
                assert np.array_equal(getattr(r["state"], k), getattr(lm[0]["state"], k)), k
            assert r["chi2"] == lm[0]["chi2"] and r["iterations"] == lm[0]["iterations"]
    for r in runs["step"][1:]:
        for k in ("chi2", "Hpp", "bp", "dxp", "xx", "xb"):
            assert np.array_equal(r[k], runs["step"][0][k]), k
    X = sharded_ba.unshard_X(runs["sb"], [r["state"].X for r in runs["lm"]])
    assert np.isfinite(X).all()


# ---------------------------------------------------------------------------
# the edge-sharded essential graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("against", ["single", "sharded"])
def test_sharded_eg_linearization_matches_reference(runs, against):
    ref = runs["ref"]["eg" if against == "single" else "eg_sharded"]
    step = runs["eg_step"][0]
    np.testing.assert_allclose(step["chi2"], ref["chi2"], rtol=1e-12)
    np.testing.assert_allclose(step["D"], ref["D"], atol=1e-9)
    np.testing.assert_allclose(step["b"], ref["b"], atol=1e-9)


def test_sharded_eg_solve_and_lm_match_reference(runs):
    ref, step, lm = runs["ref"]["eg"], runs["eg_step"][0], runs["eg_lm"][0]
    np.testing.assert_allclose(step["dx"], ref["dx"], atol=1e-7)
    np.testing.assert_allclose(step["xx"], ref["xx"], rtol=1e-7)
    np.testing.assert_allclose(step["xb"], ref["xb"], rtol=1e-7)
    np.testing.assert_allclose(lm["chi2"], ref["lm_chi2"], rtol=1e-9)
    np.testing.assert_allclose(lm["state"].t, ref["lm_t"], atol=1e-7)
    assert lm["cg_steps"] > 0 and lm["cg_all_reduces"] == lm["cg_steps"]


def test_sharded_eg_ranks_agree_bit_for_bit(runs):
    """The CG exit and the LM trials read one all-reduced scalar on every
    rank: all ranks take the same branches and return identical states."""
    lm = runs["eg_lm"]
    for r in lm[1:]:
        for k in ("s", "R", "t"):
            assert np.array_equal(getattr(r["state"], k), getattr(lm[0]["state"], k)), k
        assert (r["chi2"], r["iterations"], r["cg_steps"]) == (
            lm[0]["chi2"], lm[0]["iterations"], lm[0]["cg_steps"])
    for r in runs["eg_step"][1:]:
        for k in ("chi2", "D", "b", "dx", "xx", "xb"):
            assert np.array_equal(r[k], runs["eg_step"][0][k]), k


# ---------------------------------------------------------------------------
# the reduce hook and one-rank groups
# ---------------------------------------------------------------------------


def test_pcg_without_reduce_is_unchanged():
    """`_pcg(reduce=None)` is the unsharded solve: an identity hook gives
    the same bits, and so does the single-device problem's solve."""
    data, state0, _ = tso_eg()
    p = tso.make_essential_graph_problem_pcg(data)
    Ji, Jj, D, b, act = p.linearize(state0)
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]
    lam = torch.tensor(LAM_EG, dtype=torch.float64)
    x0, n0, r0 = tso._pcg(Ji, Jj, i_, j_, D, b, act, lam, 250, 1e-10)
    calls = []
    x1, n1, r1 = tso._pcg(Ji, Jj, i_, j_, D, b, act, lam, 250, 1e-10,
                          reduce=lambda t: calls.append(1) or t)
    assert torch.equal(x0, x1) and (n0, r0) == (n1, r1) and len(calls) == n0 > 0
    dx, _, _ = p.solve((Ji, Jj, D, b, act), lam)
    assert torch.equal(dx, x0.reshape(-1))


def tso_eg():
    data, state0, Ts = j_make_eg(n_kf=48, n_loop=6, seed=3)
    return (convert.essential_graph_from(data), convert.sim3_field_from(state0), Ts)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                         rank=0, world_size=1)
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_problems_equal_the_single_device_ones(one_rank_group):
    """On one rank the all-reduces are identities: the sharded problems give
    the single-device results bit for bit."""
    data, state0, _ = tso_eg()
    se = sharded_eg.shard_eg_data(data, 1)
    got = tlm.lm_optimize(sharded_eg.make_sharded_eg_problem(se, 0, one_rank_group, "cpu"),
                          state0, 5, lambda_init=1e-16)
    want = tlm.lm_optimize(tso.make_essential_graph_problem_pcg(data), state0, 5,
                           lambda_init=1e-16)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1].chi2, want[1].chi2)

    jdata, jstate0, _ = j_make_ba(n_kf=4, n_fixed=1, n_lm=32, obs_per_lm=2, seed=7)
    data, state0 = convert.from_reference(jdata, jstate0)
    sb = sharded_ba.shard_ba_data(data, state0, 1)
    got = tlm.lm_optimize(sharded_ba.make_sharded_ba_problem(sb, 0, one_rank_group, "cpu"),
                          sb.local_state(0, "cpu"), 3, lambda_init=1.0)
    want = tlm.lm_optimize(tba.make_ba_problem(data, data.mg_valid, data.sg_valid,
                                               data.st_valid), state0, 3, lambda_init=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1].chi2, want[1].chi2)


def test_run_ranks_turns_failures_into_errors():
    """A rank that raises fails the call with its traceback; a deadline that
    passes kills every rank and raises instead of waiting."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank [01] raised"):
        group.run_ranks(sharded_ba.first_step, 2, device="cpu", backend="gloo",
                        args=(None, LAM_BA), deadline_s=DEADLINE_S)
    with pytest.raises(TimeoutError):
        group.run_ranks(sharded_ba.first_step, 2, device="cpu", backend="gloo",
                        args=(None, LAM_BA), deadline_s=0.5)
    assert not multiprocessing.active_children()
