"""Landmark-sharded local and global BA over ranks.

Port of `amcslam_tpu/parallel/sharded_ba.py`. The decomposition is the
reference's:

  * pose-vel states, extrinsics and the dense reduced system: replicated
  * landmarks, their observations (edges), Hll, bl and the W coupling
    blocks: sharded, one block per rank

Each rank linearizes its own block with the single-device closures of
`solver/ba.make_ba_problem` (the chain kernel runs on every rank through
`_interp_packs`; the combo tables are replicated, so each rank evaluates
all U combos, as the reference's shards do), then

  Hpp, bp          -> one all-reduce
  W Hll^-1 W^T and W Hll^-1 bl
                   -> contracted over the rank's landmarks, one (P,P) + (P,)
                      all-reduce per trial
  reduced solve    -> replicated dense Cholesky
  dx_landmarks     -> local back-substitution

Pose-level terms (the GP chain, velocity and extrinsic priors) are counted
on rank 0 only: the other ranks get `gp_valid` and `vel_valid` all False
and a zero `ext_info`, so they add exact zeros. The reference instead
evaluates them on every shard and subtracts a second linearize with every
edge masked off, adding back 1/n of it (`:258-292`); that changes only the
order of the sums, at twice the linearize cost.

`shard_ba_data` is a numpy host function; `ShardedBA` holds numpy arrays
and is what ranks receive (it pickles by value).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import convert
from ..ops import interp_chain
from ..solver.ba import (BAState, LocalBAData, _inv3x3, active_columns, make_ba_problem,
                         make_landmark_tables)
from ..solver.lm import LMProblem, lm_optimize
from .group import all_reduce_max, all_reduce_sum

# LocalBAData fields sharded along their leading axis (`_shard_fields`,
# sharded_ba.py:204-214); every other field is replicated
SHARD_FIELDS = frozenset({
    "mg_pair", "mg_lm", "mg_cam", "mg_t", "mg_obs", "mg_w", "mg_valid", "mg_close",
    "mg_sid", "mg_it",
    "sg_pair", "sg_lm", "sg_t", "sg_obs", "sg_w", "sg_valid", "sg_sid", "sg_it",
    "st_pose", "st_lm", "st_obs", "st_w", "st_valid", "st_is_stereo", "st_close",
    "lm_blk", "lm_blk_g", "lm_blk_valid", "lm_edge", "lm_edge_valid",
})
# pose-level terms, kept on rank 0 only
POSE_LEVEL_OFF = {"gp_valid": False, "vel_valid": False, "ext_info": 0.0}


def host_fields(x) -> dict[str, np.ndarray | None]:
    """Field name -> numpy array of a NamedTuple (the port's tensors or the
    reference's arrays) or a mapping."""
    d = x._asdict() if hasattr(x, "_asdict") else dict(x)
    return {k: None if v is None else
            (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in d.items()}


def torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


class ShardedBA(NamedTuple):
    data: dict[str, Any]    # LocalBAData fields; sharded ones hold n equal blocks
    state0: dict[str, Any]  # BAState fields, X in shard blocks
    lm_perm: np.ndarray     # sharded position -> original landmark id (-1: padding)
    n_shards: int
    lm_per_shard: int

    def local(self, rank: int) -> tuple[dict, dict]:
        """Rank `rank`'s block of the sharded fields and the replicated
        ones, as (LocalBAData fields, BAState fields)."""
        def block(a):
            return a.reshape(self.n_shards, -1, *a.shape[1:])[rank]

        data = {k: (block(v) if k in SHARD_FIELDS and v is not None else v)
                for k, v in self.data.items()}
        return data, {**self.state0, "X": block(self.state0["X"])}

    def local_state(self, rank: int, device) -> BAState:
        """Rank `rank`'s starting BAState as tensors on `device`."""
        _, state = self.local(rank)
        return convert.state_from_numpy(state, device=device,
                                        dtype=torch_dtype(self.data["mg_obs"]))


def _pad_to(arr, n, fill=0):
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr[:n]
    return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1), constant_values=fill)


def shard_ba_data(data, state, n_shards: int) -> ShardedBA:
    """Reorder and pad a BA problem into `n_shards` landmark blocks
    (sharded_ba.py:56-201, on the host): landmark `l` lives on shard
    `l % n` at local slot `l // n`; each edge family's arrays are split by
    their landmark's shard into blocks padded to the widest shard (padding
    rows are invalid, their combo index 0, the dump combo); each shard's
    landmark gather tables are rebuilt on its block with local landmark ids
    and padded to the widest shard's slot counts. `data` / `state` are
    LocalBAData / BAState of either package, or field mappings."""
    data, state = host_fields(data), host_fields(state)
    X = state["X"]
    L = X.shape[0]
    lm_per = -(-L // n_shards)
    L_pad = lm_per * n_shards

    def shard_edges(lm_ids, arrays, valid):
        """Partition edge arrays by landmark shard; pad each block equally.
        Returns (arrays', valid', lm_local')."""
        shard = lm_ids % n_shards
        local = lm_ids // n_shards
        counts = np.bincount(shard, minlength=n_shards)
        per = max(int(counts.max()) if counts.size else 1, 1)
        masks = [shard == s for s in range(n_shards)]
        outs = [np.concatenate([_pad_to(a[m], per) for m in masks]) for a in arrays]
        return (outs, np.concatenate([_pad_to(valid[m], per, fill=False) for m in masks]),
                np.concatenate([_pad_to(local[m], per) for m in masks]))

    dtype = data["mg_obs"].dtype

    def it_col(name, lm):
        return data[name] if data.get(name) is not None else np.zeros(len(lm), np.int32)

    mg, mg_valid, mg_lm = shard_edges(
        data["mg_lm"],
        [data[k] for k in ("mg_pair", "mg_cam", "mg_t", "mg_obs", "mg_w", "mg_close",
                           "mg_sid")] + [it_col("mg_it", data["mg_lm"])],
        data["mg_valid"])
    sg, sg_valid, sg_lm = shard_edges(
        data["sg_lm"],
        [data[k] for k in ("sg_pair", "sg_t", "sg_obs", "sg_w", "sg_sid")]
        + [it_col("sg_it", data["sg_lm"])],
        data["sg_valid"])
    st, st_valid, st_lm = shard_edges(
        data["st_lm"],
        [data[k] for k in ("st_pose", "st_obs", "st_w", "st_is_stereo", "st_close")],
        data["st_valid"])

    # sharded position (s * lm_per + i) holds original landmark (i * n + s)
    Xs = np.zeros((L_pad, 3), X.dtype)
    perm = np.full(L_pad, -1, np.int64)
    ids = np.arange(L)
    dst = (ids % n_shards) * lm_per + ids // n_shards
    Xs[dst] = X
    perm[dst] = ids

    out = dict(data)
    out.update(
        mg_pair=mg[0].astype(np.int32), mg_cam=mg[1].astype(np.int32),
        mg_t=mg[2].astype(dtype), mg_obs=mg[3].astype(dtype), mg_w=mg[4].astype(dtype),
        mg_close=mg[5], mg_sid=mg[6].astype(np.int32), mg_valid=mg_valid,
        mg_lm=mg_lm.astype(np.int32),
        sg_pair=sg[0].astype(np.int32), sg_t=sg[1].astype(dtype), sg_obs=sg[2].astype(dtype),
        sg_w=sg[3].astype(dtype), sg_sid=sg[4].astype(np.int32), sg_valid=sg_valid,
        sg_lm=sg_lm.astype(np.int32),
        st_pose=st[0].astype(np.int32), st_obs=st[1].astype(dtype), st_w=st[2].astype(dtype),
        st_is_stereo=st[3], st_close=st[4], st_valid=st_valid, st_lm=st_lm.astype(np.int32),
        # interp-combo tables: the per-edge index shards with its edge, the
        # combo tables replicate
        mg_it=mg[7].astype(np.int32) if data.get("mg_it") is not None else None,
        sg_it=sg[5].astype(np.int32) if data.get("sg_it") is not None else None,
    )

    def blocks(a):
        return a.reshape(n_shards, -1, *a.shape[1:])

    n_poses, n_ext = data["times"].shape[0], data["K_async"].shape[0]
    tabs = [make_landmark_tables(
        blocks(out["mg_lm"])[s], blocks(out["mg_pair"])[s], blocks(out["mg_cam"])[s],
        blocks(out["mg_valid"])[s], blocks(out["sg_lm"])[s], blocks(out["sg_pair"])[s],
        blocks(out["sg_valid"])[s], blocks(out["st_lm"])[s], blocks(out["st_pose"])[s],
        blocks(out["st_valid"])[s], lm_per, n_poses, n_ext) for s in range(n_shards)]
    D = max(t[0].shape[1] for t in tabs)
    De = max(t[3].shape[1] for t in tabs)

    def stacked(i, w):
        return np.concatenate([np.pad(t[i], ((0, 0), (0, w - t[i].shape[1]))) for t in tabs])

    out.update(lm_blk=stacked(0, D), lm_blk_g=stacked(1, D),
               lm_blk_valid=stacked(2, D).astype(bool), lm_edge=stacked(3, De),
               lm_edge_valid=stacked(4, De).astype(bool))
    return ShardedBA(out, {**state, "X": Xs}, perm, n_shards, lm_per)


def unshard_X(sb: ShardedBA, X_blocks) -> np.ndarray:
    """(L,3) landmarks in their original order from the ranks' (lm_per,3)
    blocks (in rank order)."""
    Xs = np.concatenate([np.asarray(x) for x in X_blocks])
    valid = sb.lm_perm >= 0
    X = np.zeros((int(valid.sum()), 3), Xs.dtype)
    X[sb.lm_perm[valid]] = Xs[valid]
    return X


def local_data(sb: ShardedBA, rank: int, device) -> LocalBAData:
    """Rank `rank`'s LocalBAData on `device`: its block, with the pose-level
    terms switched off unless it is rank 0."""
    fields, state = sb.local(rank)
    if rank != 0:
        fields = {**fields, **{k: np.full_like(fields[k], v) for k, v in POSE_LEVEL_OFF.items()}}
    data, _ = convert.ba_from_numpy(fields, state, device=device,
                                    dtype=torch_dtype(sb.data["mg_obs"]))
    return data


def make_sharded_ba_problem(sb: ShardedBA, rank: int, group, device,
                            huber_on: bool = True) -> LMProblem:
    """LMProblem of rank `rank` (sharded_ba.py:217-364): its closures run the
    single-device ones on the rank's block and sum over `group` with
    all-reduce, so every rank sees the same chi2, the same reduced system
    and the same pose step; its state is `sb.local_state(rank, device)`.
    Every rank of the group must call each closure in the same order."""
    data = local_data(sb, rank, device)
    local = make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid,
                            huber_on=huber_on)
    dtype, dev = data.mg_obs.dtype, data.mg_obs.device
    act_vec = active_columns(data)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def chi2(state: BAState):
        return all_reduce_sum(local.chi2(state).reshape(1), group)[0]

    def linearize(state: BAState):
        Hpp, bp, Wt, Hll, bl = local.linearize(state)
        P = bp.shape[0]
        pose = all_reduce_sum(torch.cat([Hpp.reshape(-1), bp]), group)
        return pose[:P * P].reshape(P, P), pose[P * P:], Wt, Hll, bl

    def max_abs_diag(lin):
        Hpp, _, _, Hll, _ = lin
        m1 = (torch.diagonal(Hpp).abs() * act_vec).max()
        m2 = all_reduce_max(torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max(), group)
        return torch.maximum(m1, m2)

    def solve(lin, lam):
        # make_ba_problem's solve with the landmark contractions summed
        # over the ranks: one (P,P) + (P,) all-reduce
        Hpp, bp, Wt, Hll, bl = lin
        L_, P = Hll.shape[0], bp.shape[0]
        Hll_inv = _inv3x3(Hll + lam * eye3)
        Y = Hll_inv @ Wt  # (L,3,P)
        Y2, W2 = Y.reshape(3 * L_, P), Wt.reshape(3 * L_, P)
        corr = all_reduce_sum(torch.cat([(Y2.T @ W2).reshape(-1), Y2.T @ bl.reshape(3 * L_)]),
                              group)
        Hs = Hpp + torch.diag(lam * act_vec + (1.0 - act_vec)) - corr[:P * P].reshape(P, P)
        bs = bp - corr[P * P:]
        # a non-PD Hs gives NaN dx on every rank, so the LM loop rejects the
        # trial everywhere
        Lc, info = torch.linalg.cholesky_ex(Hs)
        dxp = torch.cholesky_solve(bs[:, None], Lc)[:, 0]
        dxp = torch.where(info == 0, dxp, torch.full_like(dxp, float("nan")))
        dxl = (Hll_inv @ (bl - (Wt @ dxp))[:, :, None])[:, :, 0]
        dots = all_reduce_sum(torch.stack([(dxl * dxl).sum(), (dxl * bl).sum()]), group)
        return (dxp, dxl), dxp @ dxp + dots[0], dxp @ bp + dots[1]

    return LMProblem(chi2, linearize, max_abs_diag, solve, local.retract)


def run_lm(rank: int, group, device, sb: ShardedBA, num_iterations: int,
           lambda_init: float, huber_on: bool = True) -> dict:
    """A rank function (for `group.run_ranks`): `lm_optimize` of the sharded
    problem from `sb`'s start. Returns the rank's final state (X is its
    block), the LM stats, its chain-kernel launches and the run's seconds
    (host clock, synchronized on a card)."""
    problem = make_sharded_ba_problem(sb, rank, group, device, huber_on=huber_on)
    state0 = sb.local_state(rank, device)
    launches0 = interp_chain.LAUNCHES
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, stats = lm_optimize(problem, state0, num_iterations, lambda_init=lambda_init)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"state": state, "chi2": stats.chi2, "initial_chi2": stats.initial_chi2,
            "iterations": stats.iterations, "seconds": time.perf_counter() - t0,
            "chain_launches": interp_chain.LAUNCHES - launches0}


def chain_launches(rank: int, group, device) -> int:
    """A rank function: the chain kernel's launches in this rank's process
    so far (`interp_chain.LAUNCHES`; a rank starts at 0)."""
    return interp_chain.LAUNCHES


def first_step(rank: int, group, device, sb: ShardedBA, lam: float) -> dict:
    """A rank function: chi2 at `sb`'s start, the reduced pose system of
    its linearization (Hpp, bp) and one damped solve at `lam` (the pose
    step, the rank's landmark step, dx.dx and dx.b): the closures' results
    that a parity check compares."""
    problem = make_sharded_ba_problem(sb, rank, group, device)
    state0 = sb.local_state(rank, device)
    chi2 = problem.chi2(state0)
    lin = problem.linearize(state0)
    (dxp, dxl), xx, xb = problem.solve(lin, torch.tensor(lam, dtype=lin[0].dtype, device=device))
    return {"chi2": chi2, "Hpp": lin[0], "bp": lin[1], "dxp": dxp, "dxl": dxl, "xx": xx,
            "xb": xb}

