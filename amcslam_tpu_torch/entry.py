"""Entry points: one LM iteration of the local BA, and the
multi-device dry run.

Port of `__graft_entry__.py`: `entry()` (`:6-26`) and
`dryrun_multichip(n)` (`:28-97`). Both run on the card unless the caller
passes `device="cpu"`; a missing card raises.

    python -c "from amcslam_tpu_torch.entry import dryrun_multichip as d; d(4)"
"""

from __future__ import annotations

import math

import torch

from . import _build
from .parallel import group as pgroup
from .parallel.sharded_ba import make_sharded_ba_problem, shard_ba_data
from .parallel.sharded_eg import make_sharded_eg_problem, shard_eg_data
from .pipeline.tracking import resolve_device
from .solver.ba import make_ba_problem
from .solver.lm import lm_optimize
from .solver.sim3_opt import make_essential_graph_problem_pcg
from .utils.synthetic import make_essential_graph, make_local_ba_problem

DRYRUN_ITERATIONS = 3  # >= 3 LM iterations, so the trial loop's control flow runs
DRYRUN_PCG_ITERS = 30


def entry(device="cuda"):
    """(step, (state0, lam)): one LM iteration of the local GP-BA
    (linearize -> Schur solve -> retract -> chi2) on the reference's small
    window (8 KF, 128 landmarks, float32) on `device`; `step(state, lam)`
    returns (new_state, new_chi2)."""
    dev = resolve_device(device)
    data, state0, _ = make_local_ba_problem(n_kf=8, n_fixed=1, n_lm=128, obs_per_lm=3,
                                            seed=0, dtype=torch.float32, device=dev)
    problem = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)

    def step(state, lam):
        lin = problem.linearize(state)
        dx, _, _ = problem.solve(lin, lam)
        new_state = problem.retract(state, dx)
        return new_state, problem.chi2(new_state)

    return step, (state0, torch.tensor(1.0, dtype=torch.float32, device=dev))


def _dryrun_problems(n_devices: int):
    """The dry run's two problems on the host, float32, at the reference's
    shapes (`__graft_entry__.py:64-94`): the local BA over 4 KF with
    4 landmarks per rank, and the essential graph of 4 KF per rank."""
    ba = make_local_ba_problem(n_kf=4, n_fixed=1, n_lm=4 * n_devices, obs_per_lm=2, seed=0,
                               dtype=torch.float32)
    eg = make_essential_graph(n_kf=4 * n_devices, n_loop=4, seed=0, dtype=torch.float32)
    return ba[:2], eg[:2]


def dryrun_rank(rank: int, group, device, n_devices: int) -> tuple[float, float]:
    """A rank function (for `parallel.group.run_ranks`): the dry run's two
    sharded LM runs on this rank. Returns (chi2, eg_chi2), the same on
    every rank."""
    (data, state0), (eg_data, eg_state0) = _dryrun_problems(n_devices)
    sb = shard_ba_data(data, state0, n_devices)
    problem = make_sharded_ba_problem(sb, rank, group, device)
    _, stats = lm_optimize(problem, sb.local_state(rank, device), DRYRUN_ITERATIONS,
                           lambda_init=1.0)
    se = shard_eg_data(eg_data, n_devices)
    eg_problem = make_sharded_eg_problem(se, rank, group, device, pcg_iters=DRYRUN_PCG_ITERS)
    _, eg_stats = lm_optimize(eg_problem, type(eg_state0)(*(t.to(device) for t in eg_state0)),
                              DRYRUN_ITERATIONS, lambda_init=1e-16)
    return float(stats.chi2), float(eg_stats.chi2)


def dryrun_single_device(n_devices: int, device="cuda") -> tuple[float, float]:
    """The dry run's two problems unsharded on one device: the chi2 values
    the sharded run must reproduce."""
    dev = resolve_device(device)
    (data, state0), (eg_data, eg_state0) = _dryrun_problems(n_devices)
    data, state0 = (type(x)(*(None if t is None else t.to(dev) for t in x))
                    for x in (data, state0))
    _, stats = lm_optimize(make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid),
                           state0, DRYRUN_ITERATIONS, lambda_init=1.0)
    eg_data, eg_state0 = (type(x)(*(t.to(dev) for t in x)) for x in (eg_data, eg_state0))
    _, eg_stats = lm_optimize(
        make_essential_graph_problem_pcg(eg_data, pcg_iters=DRYRUN_PCG_ITERS),
        eg_state0, DRYRUN_ITERATIONS, lambda_init=1e-16)
    return float(stats.chi2), float(eg_stats.chi2)


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "gloo",
                     deadline_s: float = 600.0) -> tuple[float, float]:
    """The landmark-sharded local BA and the edge-sharded essential graph
    over `n_devices` ranks, 3 LM iterations each, at the reference's dry-run
    shapes. `device` is the ranks' device (one for all, or one per rank);
    gloo runs any number of ranks on one card or on the CPU, NCCL needs a
    card per rank. Prints the reference's line and returns (chi2, eg_chi2);
    raises if either is not finite."""
    devices = [device] * n_devices if isinstance(device, (str, torch.device)) else list(device)
    devices = [resolve_device(d) for d in devices]
    if any(d.type == "cuda" for d in devices):
        _build.build("interp_chain")
    results = pgroup.run_ranks(dryrun_rank, n_devices, device=devices, backend=backend,
                               args=(n_devices,), deadline_s=deadline_s)
    chi, chi_eg = results[0]
    if not (math.isfinite(chi) and math.isfinite(chi_eg)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): chi2 {chi}, eg_chi2 {chi_eg}")
    print(f"dryrun_multichip({n_devices}): ok, chi2={chi:.3f} eg_chi2={chi_eg:.6f}")
    return chi, chi_eg
