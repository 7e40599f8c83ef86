"""Traffic kind `global_ba`: back-to-back solves of the map's global BA, each
from the same drifted start.

Set-up draws the map problem from the seed (`synthetic.map_problem`), hands
it to the program's own builders (structure ids, interpolation combos,
landmark tables: what the program derives for itself) and warms the solve
`warm_solves` times. A unit is one `global_ba_pcg(data, state0, n)` call,
timed to its returned chi2 on the host; it fails when it raises or its chi2
is not finite. The window keeps every solve's returned state and chi2; the
check (`benchmark/reference/ba_cost.py`) evaluates the cost of each returned
state, of the start and of the ground truth in float64 from the raw
observations, and compares:

- `chi2_gap`: the largest relative gap between the chi2 that a solve (or
  its start) reports and the reference's cost of the state it returned;
- `chi2_over_gt`: the largest ratio of a returned state's reference cost to
  the ground truth's.
"""

from __future__ import annotations

import gc

import numpy as np

from benchmark.reference import ba_cost as reference
from benchmark.traffic import synthetic


def program_fields(raw: dict, config: dict) -> tuple[dict, dict]:
    """The program's LocalBAData and BAState fields for the raw problem, built
    with the program's own table builders."""
    from amcslam_tpu_torch.solver.ba import (build_interp_tables, make_landmark_tables,
                                             make_structure_ids)

    Tbc, K, bf, _ = synthetic.rig_arrays(config["rig"])
    mp = config["map"]
    Cx = len(K) - 1
    times = raw["times"]
    n_kf, n_lm = len(times), len(raw["gt_X"])
    qc_inv = 1.0 / np.asarray(mp["qc_diag"], np.float64)
    dts = np.diff(times)
    qi = np.zeros((len(dts), 12, 12))
    for a, b, f in ((slice(0, 6), slice(0, 6), 12.0 / dts ** 3), (slice(0, 6), slice(6, 12), -6.0 / dts ** 2),
                    (slice(6, 12), slice(0, 6), -6.0 / dts ** 2), (slice(6, 12), slice(6, 12), 4.0 / dts)):
        qi[:, a, b] = f[:, None, None] * np.diag(qc_inv)
    pose_fixed = np.arange(n_kf) < raw["n_fixed"]
    Em, Es = len(raw["mg_lm"]), len(raw["st_lm"])
    mg_pair, mg_lm, mg_cam = (raw[k].astype(np.int64) for k in ("mg_pair", "mg_lm", "mg_cam"))
    mg_valid = np.ones(Em, bool)
    mg_sid, mg_sid_cols = make_structure_ids(mg_pair, mg_cam, mg_valid, n_kf, Cx)
    sg_sid, sg_sid_cols = make_structure_ids(np.zeros((0, 2), np.int64), None, np.zeros(0, bool),
                                             n_kf, Cx)
    mg_it, mg_it_sid, mg_it_t = build_interp_tables(mg_sid, raw["mg_t"], mg_valid)
    sg_it, sg_it_sid, sg_it_t = build_interp_tables(np.zeros(0, np.int32), np.zeros(0),
                                                    np.zeros(0, bool))
    st_pose, st_lm = raw["st_pose"].astype(np.int64), raw["st_lm"].astype(np.int64)
    st_valid = np.ones(Es, bool)
    sg_pair, sg_lm, sg_valid = np.zeros((0, 2), np.int64), np.zeros(0, np.int64), np.ones(0, bool)
    lm_blk, lm_blk_g, lm_blk_valid, lm_edge, lm_edge_valid = make_landmark_tables(
        mg_lm, mg_pair, mg_cam, mg_valid, sg_lm, sg_pair, sg_valid, st_lm, st_pose, st_valid,
        n_lm, n_kf, Cx)
    data = dict(
        times=times, pose_fixed=pose_fixed, vel_valid=~pose_fixed,
        qcinv22=np.asarray(qc_inv[2]), gp_pairs=np.stack([np.arange(n_kf - 1), np.arange(1, n_kf)], 1),
        gp_qi_inv=qi, gp_valid=np.ones(n_kf - 1, bool), gp_huber=np.asarray(bool(mp["gp_huber"])),
        Tbc_stereo=Tbc[-1], K_stereo=K[-1], bf=np.asarray(bf), K_async=K[:Cx],
        ext_fixed=np.ones(Cx, bool), R_prior=Tbc[:Cx, :3, :3],
        ext_info=np.tile(np.eye(3) * mp["ext_prior_info"], (Cx, 1, 1)),
        mg_pair=mg_pair, mg_lm=mg_lm, mg_cam=mg_cam, mg_t=raw["mg_t"], mg_obs=raw["mg_obs"],
        mg_w=np.ones(Em), mg_valid=mg_valid, mg_close=np.zeros(Em, bool), mg_sid=mg_sid,
        mg_sid_cols=mg_sid_cols, sg_pair=sg_pair, sg_lm=sg_lm, sg_t=np.zeros(0),
        sg_obs=np.zeros((0, 3)), sg_w=np.ones(0), sg_valid=sg_valid, sg_sid=sg_sid,
        sg_sid_cols=sg_sid_cols, st_pose=st_pose, st_lm=st_lm, st_obs=raw["st_obs"],
        st_w=np.ones(Es), st_valid=st_valid, st_is_stereo=raw["st_is_stereo"],
        st_close=np.zeros(Es, bool), lm_blk=lm_blk, lm_blk_g=lm_blk_g, lm_blk_valid=lm_blk_valid,
        lm_edge=lm_edge, lm_edge_valid=lm_edge_valid, mg_it=mg_it, mg_it_sid=mg_it_sid,
        mg_it_t=mg_it_t, sg_it=sg_it, sg_it_sid=sg_it_sid, sg_it_t=sg_it_t)
    state = dict(T=raw["T0"], v=raw["v0"], Text=Tbc[:Cx].copy(), X=raw["X0"])
    return data, state


class Session:
    unit = "solve"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        import torch

        from amcslam_tpu_torch import convert
        from amcslam_tpu_torch.solver import ba

        self.torch, self.ba = torch, ba
        self.config, self.mix, self.device = config, mix, torch.device(device)
        solver = config["solver"]
        self.dtype_name = solver["dtype"]
        self.dtype = getattr(torch, solver["dtype"])
        self.iterations = int(solver["num_iterations"])
        self.raw = synthetic.map_problem(config["rig"], config["map"], seed)
        data, state = program_fields(self.raw, config)
        self.data, self.state0 = convert.ba_from_numpy(data, state, device=self.device,
                                                       dtype=self.dtype)
        self.solves = []   # (returned state, chi2, initial chi2) per window solve

    def _solve(self):
        torch = self.torch
        try:
            state, stats = self.ba.global_ba_pcg(self.data, self.state0, self.iterations)
            chi2, chi0 = (float(x) for x in torch.stack([stats.chi2, stats.initial_chi2]).cpu())
        except RuntimeError as e:  # a solve that raises counts as failed
            print(f"solve raised: {e}", flush=True)
            return None, float("nan"), float("nan")
        return state, chi2, chi0

    def warm(self) -> None:
        for _ in range(int(self.mix["warm_solves"])):
            self._solve()

    def step(self) -> dict:
        state, chi2, chi0 = self._solve()
        if state is not None:
            state = tuple(t.detach().clone() for t in state)
        self.solves.append((state, chi2, chi0))
        return {"failed": not np.isfinite(chi2)}

    def summary(self, rec: dict) -> dict:
        raw = self.raw
        return {"keyframes": len(raw["times"]), "landmarks": len(raw["gt_X"]),
                "stereo_observations": len(raw["st_lm"]),
                "async_observations": len(raw["mg_lm"]), "solves": len(rec["units"]),
                "solve_s": [round(u["ms"] / 1e3, 4) for u in rec["units"]],
                "chi2": [s[1] for s in self.solves[:4]], "chi2_initial": self.solves[0][2]
                if self.solves else None}

    def outputs(self) -> list:
        """Every window solve's (state as float64 arrays, chi2, initial chi2);
        then the program's problem and states are freed."""
        out = [(None if s is None else dict(zip(("T", "v", "Text", "X"),
                                                (t.double().cpu().numpy() for t in s))), c, c0)
               for s, c, c0 in self.solves]
        self.solves, self.data, self.state0 = [], None, None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        solves = self.outputs()
        raw, mp = self.raw, self.config["map"]
        Tbc, K, bf, _ = synthetic.rig_arrays(self.config["rig"])
        rig = {"Tbc": Tbc, "K": K, "bf": bf, "qc": mp["qc_diag"], "ext_info": mp["ext_prior_info"]}
        np_dtype = np.float32 if self.dtype == self.torch.float32 else np.float64
        given = lambda a: np.asarray(a, np_dtype).astype(np.float64)  # noqa: E731  as the program got it
        start = {"T": given(raw["T0"]), "v": given(raw["v0"]), "Text": given(Tbc[:-1]),
                 "X": given(raw["X0"])}
        gt = {"T": raw["gt_T"], "v": raw["gt_v"], "Text": Tbc[:-1], "X": raw["gt_X"]}
        cost = lambda state: reference.cost(raw, rig, state, mp["gp_huber"])  # noqa: E731
        c_start, c_gt = cost(start), cost(gt)
        gaps, ratios = [], []
        for state, chi2, chi0 in solves:
            gaps.append(abs(chi0 - c_start) / c_start)
            if state is None:
                gaps.append(float("inf"))
                continue
            c = cost(state)
            gaps.append(abs(chi2 - c) / c)
            ratios.append(c / c_gt)
        return {"chi2_gap": max(gaps, default=float("inf")),
                "chi2_over_gt": max(ratios, default=float("inf")),
                "cost_start_over_gt": c_start / c_gt, "cost_gt": c_gt, "solves_checked": len(solves)}
