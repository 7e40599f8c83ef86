"""The solvers' graphed path (solver/graphs.py) on the CPU.

On a CUDA device the pose solve, MC-RANSAC and the local BA run as replays
of CUDA graphs captured once per input signature; the steps are in-place
updates of static buffers. A CUDA graph cannot run here, so a stand-in
(`FakeGraph`: a capture records the step and runs nothing, a replay runs
it) drives the same code path on CPU tensors: the first call of each step
plain, the capture on its second call, replays from then on, over the
static buffers of an entry cached per thread, and a second call on other
inputs that runs from replays alone. A replay raises on an op that a
real capture refuses (a copy from the host, a read to the host, an
output shaped by the data). Float64 throughout.

  * graphed local_gp_ba and mc_ransac against the JAX reference
    (local_gp_ba, and mc_ransac with its vmap of the LM fit): states and
    twists to 1e-12 relative, the same inlier masks and counts; graphed
    local_gp_ba with the extrinsic phase, and the graphed pose solve (both
    branches), equal to their eager runs bit for bit, rounds, iteration
    counts and masks included (the eager runs are held against the
    reference in test_torch_lm_slice.py and test_torch_pose_solver.py);
  * the segmented static-carry run (local_gp_ba_interruptible, segments
    of 4 iterations) equals the monolithic one bit for bit;
  * CPU tensors build no graph: the counts of solver/graphs.py and the
    chain's launches stay at zero;
  * a replay adds the chain launches its capture recorded (a stand-in
    record), the capture itself none;
  * entries are per thread and at most MAX_ENTRIES of a kind.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from amcslam_tpu.ransac import vel_ransac as jvr
from amcslam_tpu.solver import ba as jba
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.ops import interp_chain
from amcslam_tpu_torch.ransac import vel_ransac as tvr
from amcslam_tpu_torch.solver import ba as tba
from amcslam_tpu_torch.solver import graphs
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.solver import pose_solver as tps
from test_torch_ba import small_problem
from test_torch_pose_solver import problems
from test_torch_vel_ransac import jax_data, mc_case

TOL = 1e-12
J_LOCAL_GP_BA = jax.jit(jba.local_gp_ba, static_argnames=("b_extrinsic", "ext_min_obs"))
J_MC = jax.jit(lambda d, s: jvr.mc_ransac(d, s, threshold=3.0, min_match=30))


# ops a CUDA graph capture refuses: a tensor from host data (a copy from
# the host on the card), a read to the host, an output shaped by the data
NOT_CAPTURABLE = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default",
                  "aten._local_scalar_dense.default", "aten.nonzero.default",
                  "aten.masked_select.default", "aten.bincount.default",
                  "aten._unique2.default", "aten.unique_dim.default",
                  "aten.unique_consecutive.default", "aten.repeat_interleave.Tensor"}


class Capturable(TorchDispatchMode):
    """Raises on an op that a CUDA graph capture refuses (NOT_CAPTURABLE, or
    indexing by a bool mask, which reads the mask's count to the host)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        masked = name.startswith(("aten.index.", "aten.index_put")) and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name in NOT_CAPTURABLE or masked:
            raise AssertionError(f"{name} inside a captured step")
        return func(*args, **(kwargs or {}))


class FakeGraph:
    """A stand-in for a captured CUDA graph: the capture runs nothing, a
    replay runs the step; the first replay (the ops a real capture would
    record) raises on an op the capture refuses."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        with Capturable() if self.replays == 1 else contextlib.nullcontext():
            self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    """solver/graphs.py's graphed path on CPU tensors, through FakeGraph."""
    captured = []

    def capture(fn, pool):
        captured.append(FakeGraph(fn))
        return captured[-1]

    monkeypatch.setattr(graphs, "graphed", lambda device, eager: not eager)
    monkeypatch.setattr(graphs, "on_stream", lambda device, eager: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    monkeypatch.setattr(graphs, "_capture_graph", capture)
    # the chain's index check reads to the host on the CPU only
    monkeypatch.setattr(interp_chain, "_check_rows", lambda *args: None)
    graphs.clear()
    yield captured
    graphs.clear()


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(graphs.leaves(a), graphs.leaves(b),
                                                  strict=True))


def ba_case(seed, b_extrinsic, move=0.0):
    """tests/test_torch_lm_slice.py's local-BA problem; `move` shifts the
    start's landmarks by that many metres (seeded), which keeps the
    signature."""
    jd, js, _ = small_problem(seed=seed, noise_px=0.5, gpobs_per_lm=2)
    if b_extrinsic:  # perturb one extrinsic so phase 2 has work to do
        Text = np.asarray(js.Text).copy()
        Text[0, :3, 3] += np.array([0.02, -0.015, 0.01])
        js = js._replace(Text=jnp.asarray(Text))
    if move:
        X = np.asarray(js.X)
        js = js._replace(X=jnp.asarray(X + move * np.random.RandomState(seed).randn(*X.shape)))
    td, ts = convert.from_reference(jd, js)
    return jd, js, td, ts


def test_graphed_local_gp_ba_matches_reference(fake_graphs):
    """Two starts of one signature, the second run from replays alone,
    against the reference; then the extrinsic phase (the extrinsics freed)
    against the eager path."""
    for move in (0.0, 0.01):
        jd, js, td, ts = ba_case(4, False, move)
        jres = J_LOCAL_GP_BA(jd, js)
        tres = tba.local_gp_ba(td, ts)
        assert bool(tres.ok) == bool(jres.ok)
        assert max_rel(tres.err_initial, jres.err_initial) <= TOL
        assert max_rel(tres.err_final, jres.err_final) <= TOL
        for name in ("erase_m", "erase_sg", "erase_st"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                          np.asarray(getattr(jres, name)), err_msg=name)
        for name in ("T", "v", "Text", "X"):
            assert max_rel(getattr(tres.state, name), getattr(jres.state, name)) <= TOL, name
        assert leaves_equal(tres, tba.local_gp_ba(td, ts, eager=True))
    assert len(graphs._local().entries) == 1
    assert fake_graphs and all(g.replays for g in fake_graphs)
    kw = dict(b_extrinsic=True, ext_min_obs=5)
    for move in (0.0, 0.01):
        _, _, td, ts = ba_case(4, True, move)
        got = tba.local_gp_ba(td, ts, **kw)
        assert not torch.equal(got.state.Text[0], ts.Text[0])
        assert leaves_equal(got, tba.local_gp_ba(td, ts, eager=True, **kw))
    names = {n for e in graphs._local().entries.values() for n in e.program.steps}
    assert {"linearize.phase1", "linearize.phase2", "finalize"} <= names


def test_graphed_mc_ransac_matches_reference(fake_graphs):
    """The batched fits of all hypotheses (the reference's vmap over its
    LM loop), the scoring and the argmax, on a pow2-padded bucket; two
    frames of one signature."""
    for seed in (11, 12):
        fields, samples, _ = mc_case(n=50, n_pad=14, seed=seed)
        jok, jv, jinl, jn = J_MC(jax_data(fields), jnp.asarray(samples, jnp.int32))
        td = convert.vel_ransac_from_numpy(fields)
        ok, v, inl, n = tvr.mc_ransac(td, torch.tensor(samples), threshold=3.0, min_match=30)
        assert bool(ok) == bool(jok) and int(n) == int(jn)
        np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
        assert max_rel(v, jv) <= TOL
        want = tvr.mc_ransac(td, torch.tensor(samples), threshold=3.0, min_match=30,
                             eager=True)
        assert all(torch.equal(a, b) for a, b in zip((ok, v, inl, n), want))
    assert graphs.counts()["entries"] == 1


@pytest.mark.parametrize("branch", ["edge", "table"])
def test_graphed_pose_gp_optimize_equals_eager(fake_graphs, branch):
    """The 4 rounds (two Huber settings) and the re-classification between
    them, replayed over the entry's static buffers: every output equal to
    the eager run's, on two frames of one signature."""
    for seed in (3, 4):
        _, _, td, ts, _ = problems(branch, n_mono=24, n_stereo=16, outlier_frac=0.15,
                                   seed=seed)
        out_m = torch.zeros(24, dtype=torch.bool)
        out_m[:2] = True
        out_s = torch.zeros(16, dtype=torch.bool)
        got = tps.pose_gp_optimize(td, ts, out_m, out_s)
        want = tps.pose_gp_optimize(td, ts, out_m, out_s, eager=True)
        assert leaves_equal(got[:3], want[:3])
        assert torch.equal(got[3][1], want[3][1])
        for a, b in zip(got[3][0], want[3][0], strict=True):
            assert a.iterations == b.iterations
            assert leaves_equal((a.chi2, a.lam, a.initial_chi2), (b.chi2, b.lam, b.initial_chi2))
    names = {n for e in graphs._local().entries.values() for n in e.program.steps}
    assert {"linearize.huber1", "linearize.huber0", "reclassify"} <= names


def test_segmented_static_carry_equals_monolithic(fake_graphs):
    _, _, td, ts = ba_case(6, False)
    mono = tba.local_gp_ba(td, ts)
    polls = []
    seg, aborted = tba.local_gp_ba_interruptible(
        td, ts, seg_iters=4, should_abort=lambda: polls.append(1) and False)
    assert not aborted and polls
    assert leaves_equal(seg, mono)
    # the public lm_segment on the same problem: 4+3+3 against one run
    p = tba.make_ba_problem(td, td.mg_valid, td.sg_valid, td.st_valid)
    one = tlm.lm_segment(p, tlm.lm_init(p, ts), 10, lambda_init=1.0)
    carry = tlm.lm_init(p, ts)
    for it_end in (4, 7, 10):
        carry = tlm.lm_segment(p, carry, it_end, lambda_init=1.0)
    assert (carry.it, carry.nbad, carry.term) == (one.it, one.nbad, one.term)
    assert leaves_equal((carry.state, carry.chi, carry.lam, carry.ni),
                        (one.state, one.chi, one.lam, one.ni))
    assert leaves_equal(mono.state, tba._lba_finalize(td, ts, one.state, one.chi0, False).state)


def test_cpu_tensors_build_no_graph():
    graphs.clear()
    before = graphs.counts()
    launches = interp_chain.LAUNCHES
    _, _, td, ts = ba_case(4, False)
    tba.local_gp_ba(td, ts)
    fields, samples, _ = mc_case(n=50, n_pad=14)
    tvr.mc_ransac(convert.vel_ransac_from_numpy(fields), torch.tensor(samples))
    _, _, pd, ps, _ = problems("table", n_mono=24, n_stereo=16, seed=3)
    tps.pose_gp_optimize(pd, ps, torch.zeros(24, dtype=torch.bool),
                         torch.zeros(16, dtype=torch.bool))
    after = graphs.counts()
    assert (after["captures"], after["replays"], after["entries"]) == (
        before["captures"], before["replays"], 0)
    assert after["eager_steps"] > before["eager_steps"]
    assert interp_chain.LAUNCHES == launches


def test_replay_counts_the_captured_chain_launches(monkeypatch):
    """A capture records the chain launches inside it (here a stand-in
    record: two of the indexed entry at S = 8, one of the pair entry at
    S = 6) and counts none; every replay adds them."""
    def capture(fn, pool):
        interp_chain._count("indexed", 8)
        interp_chain._count("indexed", 8)
        interp_chain._count("pair", 6)
        return FakeGraph(fn)

    monkeypatch.setattr(graphs, "_new_pool", lambda: None)
    monkeypatch.setattr(graphs, "_capture_graph", capture)
    interp_chain.reset_launches()
    prog = graphs.Program(True)
    runs = []
    prog.run("step", lambda: runs.append(1))      # first call: plain
    assert interp_chain.LAUNCHES == 0 and runs == [1]
    prog.run("step", lambda: runs.append(1))      # capture (records), one replay
    assert interp_chain.LAUNCHES == 3
    assert interp_chain.BY_SIZE == {"indexed S=8": 2, "pair S=6": 1}
    for _ in range(2):
        prog.run("step", lambda: runs.append(1))
    assert interp_chain.LAUNCHES == 9 and interp_chain.BY_SIZE["indexed S=8"] == 6
    assert len(runs) == 4
    interp_chain.reset_launches()
    assert interp_chain.LAUNCHES == 0 and interp_chain.BY_SIZE == {}


def test_entries_are_per_thread_and_bounded(fake_graphs):
    made = []

    def make(program):
        made.append(program)
        return program

    for n in range(graphs.MAX_ENTRIES + 2):
        graphs.entry("k", (n,), make, "cpu", False)
    assert graphs.entry("k", (graphs.MAX_ENTRIES + 1,), make, "cpu", False) is made[-1]
    assert len(graphs._local().entries) == graphs.MAX_ENTRIES
    assert graphs.entry("k", (0,), make, "cpu", True) is not made[0]  # eager: made anew
    other = []
    t = threading.Thread(target=lambda: other.append(graphs.entry("k", (1,), make, "cpu", False)))
    t.start()
    t.join()
    assert other[0] is made[-1] and len(graphs._local().entries) == graphs.MAX_ENTRIES
