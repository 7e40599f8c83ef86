"""Edge-sharded essential graph (matrix-free PCG) over ranks.

Port of `amcslam_tpu/parallel/sharded_eg.py`. The at-scale pose graph
(`solver/sim3_opt.make_essential_graph_problem_pcg`) spends its time on
per-edge work: the (E,7,14) Jacobians and the two segment-sum passes of
every H x product. The decomposition is the reference's:

  * the Sim3 vertex field (N,7), the block-Jacobi preconditioner and the
    PCG's vectors and scalars: replicated
  * the edges (pairs, measurements, residuals, Jacobians): sharded, one
    contiguous block per rank

D and b are summed by one all-reduce per linearization; each CG step
all-reduces the (N,7) segment sums of the rank's share of H p (the `reduce`
hook of `sim3_opt._pcg`). Every rank then holds the same vectors, reads the
same scalar for the CG exit and the LM trial, and takes the same branch.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import convert
from ..solver import sim3_opt
from ..solver.lm import LMProblem, lm_optimize
from .group import all_reduce_sum
from .sharded_ba import host_fields, torch_dtype

EDGE_FIELDS = ("pairs", "meas_s", "meas_R", "meas_t", "valid")

# CG steps of the sharded solves in this process, and the all-reduces they
# made (one per step): all-reduces per CG step = CG_REDUCES / CG_STEPS
CG_STEPS = 0
CG_REDUCES = 0


class ShardedEG(NamedTuple):
    data: dict[str, Any]  # EssentialGraphData fields, edges padded to n * e_per_shard
    n_shards: int
    e_per_shard: int

    def local(self, rank: int) -> dict[str, Any]:
        """Rank `rank`'s edge block and the replicated fields."""
        a, b = rank * self.e_per_shard, (rank + 1) * self.e_per_shard
        return {k: v[a:b] if k in EDGE_FIELDS else v for k, v in self.data.items()}


def shard_eg_data(data, n_shards: int) -> ShardedEG:
    """Pad the edge axis to a multiple of `n_shards` (sharded_eg.py:51-77):
    padding rows have meas_s = 1, identity meas_R and valid = False, so
    they add exact zeros. `data` is an EssentialGraphData of either package
    or a field mapping."""
    d = host_fields(data)
    E = d["pairs"].shape[0]
    per = max(-(-E // n_shards), 1)
    E_pad = per * n_shards
    eye = np.broadcast_to(np.eye(3, dtype=d["meas_R"].dtype), (E_pad - E, 3, 3))
    out = {**d,
           "pairs": _pad_to(d["pairs"], E_pad),
           "meas_s": _pad_to(d["meas_s"], E_pad, fill=1),
           "meas_R": np.concatenate([d["meas_R"], eye]),
           "meas_t": _pad_to(d["meas_t"], E_pad),
           "valid": _pad_to(d["valid"], E_pad, fill=False)}
    return ShardedEG(out, n_shards, per)


def _pad_to(a, n, fill=0):
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1), constant_values=fill)


def make_sharded_eg_problem(se: ShardedEG, rank: int, group, device, pcg_iters: int = 250,
                            pcg_tol: float = 1e-10) -> LMProblem:
    """LMProblem of rank `rank` (sharded_eg.py:80-200) on the replicated
    Sim3Field: chi2, D and b summed over `group`, the PCG's Schur products
    summed per step, the retraction replicated. Float dtype: the data's."""
    data = convert.essential_graph_from(se.local(rank), device=device,
                                        dtype=torch_dtype(se.data["meas_t"]))
    local = sim3_opt.make_essential_graph_problem_pcg(data, pcg_iters, pcg_tol)
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]

    def chi2(state):
        return all_reduce_sum(local.chi2(state).reshape(1), group)[0]

    def linearize(state):
        Ji, Jj, D, b, act = local.linearize(state)
        n = D.numel()
        Db = all_reduce_sum(torch.cat([D.reshape(-1), b.reshape(-1)]), group)
        return Ji, Jj, Db[:n].reshape(D.shape), Db[n:].reshape(b.shape), act

    def solve(lin, lam):
        global CG_STEPS, CG_REDUCES
        Ji, Jj, D, b, act = lin
        reduces = []

        def reduce(t):
            reduces.append(1)
            return all_reduce_sum(t, group)

        x, steps, _ = sim3_opt._pcg(Ji, Jj, i_, j_, D, b, act, lam, pcg_iters, pcg_tol,
                                    reduce=reduce)
        CG_STEPS += steps
        CG_REDUCES += len(reduces)
        dx = x.reshape(-1)
        return dx, dx @ dx, dx @ b.reshape(-1)

    return LMProblem(chi2, linearize, local.max_abs_diag, solve, local.retract)


def run_lm(rank: int, group, device, se: ShardedEG, state0, num_iterations: int,
           lambda_init: float, pcg_iters: int = 250, pcg_tol: float = 1e-10) -> dict:
    """A rank function (for `group.run_ranks`): `lm_optimize` of the sharded
    problem from the Sim3Field fields `state0`. Returns the final (replicated)
    state, the LM stats, the CG steps and their all-reduces, and the run's
    seconds (host clock, synchronized on a card)."""
    problem = make_sharded_eg_problem(se, rank, group, device, pcg_iters, pcg_tol)
    state = convert.sim3_field_from(host_fields(state0), device=device,
                                    dtype=torch_dtype(se.data["meas_t"]))
    steps0, reduces0 = CG_STEPS, CG_REDUCES
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, stats = lm_optimize(problem, state, num_iterations, lambda_init=lambda_init)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"state": state, "chi2": stats.chi2, "initial_chi2": stats.initial_chi2,
            "iterations": stats.iterations, "seconds": time.perf_counter() - t0,
            "cg_steps": CG_STEPS - steps0, "cg_all_reduces": CG_REDUCES - reduces0}


def first_step(rank: int, group, device, se: ShardedEG, state0, lam: float) -> dict:
    """A rank function: chi2 at the Sim3Field fields `state0`, the
    linearization's D and b, and one damped solve at `lam` (dx, dx.dx,
    dx.b): the closures' results that a parity check compares."""
    problem = make_sharded_eg_problem(se, rank, group, device)
    state = convert.sim3_field_from(host_fields(state0), device=device,
                                    dtype=torch_dtype(se.data["meas_t"]))
    chi2 = problem.chi2(state)
    lin = problem.linearize(state)
    dx, xx, xb = problem.solve(lin, torch.tensor(lam, dtype=lin[3].dtype, device=device))
    return {"chi2": chi2, "D": lin[2], "b": lin[3], "dx": dx, "xx": xx, "xb": xb}

