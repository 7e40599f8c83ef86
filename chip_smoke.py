#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`amcslam_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each printing one JSON line; any failure raises (nonzero exit, no
result line):

  1. device  — a CUDA device is required (there is no CPU path);
  2. build   — nvcc builds csrc/interp_chain.cu into build/kernels/;
  3. kernel  — the GP-interpolation-chain kernel against its plain PyTorch
               version on the card: float64 to max-rel 1e-12, float32 within
               max(5e-5, 10x the plain float32 distance from float64), and
               batches of 1, 130 and 1024 combos agree on their prefix bit
               for bit;
  4. slice   — `local_gp_ba` at the headline shape of the reference's bench
               (50 KF, 5000 landmarks, 6 cameras, 4 obs/landmark, 2 GP obs/
               landmark, seed 0, float32) through the kernel: ok, chi2
               decreasing, at least one kernel launch per linearization;
               then one float64 linearize + solve on the card against the
               port on the CPU (plain chain);
  5. timing  — ms per chained LM iteration (linearize -> solve -> retract ->
               chi2, lambda = 1; 3 warm-up + median of 5 blocks of 20), once
               through the kernel and once with the plain chain bound in, in
               the order plain, kernel, kernel, plain; and the chain alone at
               the headline's 1024 combos;
  6. profile — torch.profiler over 5 LM iterations: device time and busy
               share per iteration, kernel launches per iteration, and a
               table by kernel in build/profile/lm_iteration_profile.txt;
  7. interruptible — `local_gp_ba_interruptible` at the phase-4 problem:
               with no abort it equals `local_gp_ba` field for field
               (`torch.equal`, deterministic index_add_ on); an abort after
               the first segment reports `aborted` and a finite state;
  8. tracking — the per-frame tracking solve at the reference bench's
               pose-only size (192 async-mono + 128 stereo-camera matches,
               6 cameras, noise 0.5 px, 15 % gross outliers, seed 0,
               float32): `mc_ransac` on the frame's 320 matches padded to
               512 (23 hypotheses, 3 px, min 30), then `pose_gp_optimize`
               with the RANSAC outlier flags, per edge and through the
               interpolation table (the kernel); float64 card vs CPU;
               ms per solve (median of 3 blocks of 10), kernel launches and
               host reads per solve, and a torch.profiler table in
               build/profile/tracking_profile.txt.
  9. system — the port's entry point `System.track_multicamera` (loop
               closing off) on make_sequence(60 frames, 6 cameras, 3000
               landmarks, 0.3 px, seed 0) with the tracking config of
               tests/test_system.py; g++ builds the native matcher into
               build/native/ first. 9a: float32, sequential: every frame
               OK, ATE <= 0.5 % of the path, >= 15 keyframes, at least one
               chain-kernel launch per tracked frame plus one per local-BA
               linearization; per-frame tracking ms, local-BA ms per
               keyframe, the largest problem sizes, peak memory. 9b: float64
               on the card against the port on the CPU, first 15 frames,
               deterministic algorithms on: the same states, keyframe ids and
               map-point counts, poses to 1e-8 m / 1e-8 rad. 9c: the threaded
               schedule, float32, the first 30 frames: OK in the last 5, a
               finite trajectory, ATE <= 2 % of the path.

Phase 8's timing runs 3 blocks of 10 solves (5 of 20 before phase 9 was
added) and 9c runs 30 of the 60 frames, so that the whole run stays near
ten minutes.

The last three lines are the card's `nvidia-smi` name and power limit, the
kernels' JSON record and the result line.
"""

from __future__ import annotations

import copy
import itertools
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from amcslam_tpu_torch import _build, convert, native
from amcslam_tpu_torch.ops import interp_chain, lie
from amcslam_tpu_torch.pipeline import extraction, local_mapping, map_store, tracking
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.ransac import vel_ransac
from amcslam_tpu_torch.solver import ba, pose_solver
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.utils.io import ate_rmse
from amcslam_tpu_torch.utils.synthetic import (make_local_ba_problem_numpy,
                                               make_pose_problem_numpy, make_sequence)
from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER

HEADLINE = dict(n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
                gpobs_per_lm=2, noise_px=0.5, seed=0)
# bench.py:155-160 (pose-only config) plus the outliers the tracking path
# rejects (tests/test_pose_solver.py:279-294)
TRACKING = dict(n_mono=192, n_stereo=128, n_cams=6, noise_px=0.5, outlier_frac=0.15,
                seed=0)
RANSAC_HYPOTHESES = 23  # Tracking.cc:2029
RANSAC_THRESHOLD = 3.0
RANSAC_MIN_MATCH = 30
KEYS = ("Twb", "Tbw", "Q")
CHAIN_ARGS = ("T1", "v1", "T2", "v2", "t1", "t2", "t")
# tests/test_system.py:21-22; the rig of 5 async monos + a stereo camera is
# the AMV width (tests/test_e2e_scenarios.py:63-66)
SYSTEM_SEQ = dict(n_frames=60, n_cams=6, n_lm=3000, noise_px=0.3, seed=0)
SYSTEM_CFG = dict(max_frames_between_kf=3, ransac_min_match=15, kf_translation_th=0.25)
SYSTEM_MIN_KP = 300        # mean keypoints per camera per frame
SYSTEM_MAX_LM = 6000
SYSTEM_F64_FRAMES = 15
SYSTEM_THREADED_FRAMES = 30
SYSTEM_ATE_PCT = 0.5        # ATE bound of 9a, % of the path length
ID_START = 10_000_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def random_case(seed: int, n: int, case: str, device) -> tuple:
    """tests/test_pallas_chain.py::_random_case (float64): generic, near-pi or
    tiny rotations; a quarter of the queries at s = 0, a quarter at s = 1."""
    rng = np.random.default_rng(seed)
    xi1 = rng.normal(scale=0.8, size=(n, 6))
    if case == "near_pi":
        ax = rng.normal(size=(n, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        xi1[:, 3:] = ax * (np.pi - 1e-3)
    if case == "tiny":
        xi1 *= 1e-6
    dxi = rng.normal(scale=(1e-7 if case == "tiny" else 0.3), size=(n, 6))
    f64 = dict(dtype=torch.float64, device=device)
    T1 = lie.exp_se3(torch.tensor(xi1, **f64))
    T2 = T1 @ lie.exp_se3(torch.tensor(dxi, **f64))
    v1 = torch.tensor(rng.normal(scale=0.5, size=(n, 6)), **f64)
    v2 = torch.tensor(rng.normal(scale=0.5, size=(n, 6)), **f64)
    t1 = torch.tensor(rng.uniform(0.0, 1.0, n), **f64)
    t2 = t1 + torch.tensor(rng.uniform(0.05, 0.5, n), **f64)
    s = rng.uniform(0.0, 1.0, n)
    s[: n // 4] = 0.0
    s[n // 4: n // 2] = 1.0
    t = t1 + torch.tensor(s, **f64) * (t2 - t1)
    return tuple(a.contiguous() for a in (T1, v1, T2, v2, t1, t2, t))


def check_f32(args64: tuple) -> dict:
    """float32 kernel vs the float64 plain oracle, within
    max(5e-5, 10x the float32 plain version's own distance)."""
    oracle = interp_chain.gp_interp_packs_ref(*args64)
    args32 = tuple(a.float() for a in args64)
    got = interp_chain.gp_interp_packs(*args32)
    plain = interp_chain.gp_interp_packs_ref(*args32)
    out = {"max_abs_vs_plain32": 0.0}
    for k in KEYS:
        d_kernel = max_rel(got[k], oracle[k])
        d_plain = max_rel(plain[k], oracle[k])
        bound = max(5e-5, 10.0 * d_plain)
        if not d_kernel < bound:
            raise AssertionError(f"f32 {k}: kernel {d_kernel:.3e} >= bound {bound:.3e}")
        out[k] = {"kernel_vs_f64": d_kernel, "plain32_vs_f64": d_plain}
        out["max_abs_vs_plain32"] = max(out["max_abs_vs_plain32"],
                                        float((got[k] - plain[k]).abs().max()))
    return out


def phase_kernel(device) -> None:
    cases = {}
    for case in ("generic", "near_pi", "tiny"):
        args = random_case(3, 1024, case, device)
        got = interp_chain.gp_interp_packs(*args)
        ref = interp_chain.gp_interp_packs_ref(*args)
        errs = {k: max_rel(got[k], ref[k]) for k in KEYS}
        if not max(errs.values()) <= 1e-12:
            raise AssertionError(f"f64 {case}: kernel vs plain {errs}")
        for n in (1, 130):
            head = interp_chain.gp_interp_packs(*(a[:n] for a in args))
            for k in KEYS:
                if not torch.equal(head[k], got[k][:n]):
                    raise AssertionError(f"{case}: S={n} prefix differs in {k}")
        cases[case] = {"f64_max_rel": max(errs.values()), "f32": check_f32(args)}
    sync()
    emit("kernel", S=[1, 130, 1024], tol_f64=1e-12, cases=cases)


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def chain_inputs(data, state) -> tuple:
    """The kernel's inputs on the main path: one row per mono-GP combo."""
    i_u, j_u = ba._combo_ends(data, data.mg_sid_cols, data.mg_it_sid)
    return (state.T[i_u], state.v[i_u], state.T[j_u], state.v[j_u],
            data.times[i_u], data.times[j_u], data.mg_it_t)


def run_slice(data, state):
    """local_gp_ba with a count of the linearizations it runs."""
    n_lin = 0
    make = ba.make_ba_problem

    def counting(*args, **kw):
        problem = make(*args, **kw)

        def linearize(s):
            nonlocal n_lin
            n_lin += 1
            return problem.linearize(s)

        return problem._replace(linearize=linearize)

    with mock.patch.object(ba, "make_ba_problem", counting):
        res = ba.local_gp_ba(data, state)
    return res, n_lin


def assert_close(name, got, ref, rtol, atol) -> float:
    got, ref = got.cpu(), ref.cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    excess = float(((got - ref).abs() - (atol + rtol * ref.abs())).max())
    if not excess <= 0.0:
        raise AssertionError(f"{name}: card vs cpu beyond rtol {rtol} / atol {atol}")
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def phase_slice(device, np_data, np_state):
    data, state0 = convert.ba_from_numpy(np_data, np_state, device=device,
                                         dtype=torch.float32)
    shapes = {"K": data.n_poses, "Cx": data.n_ext, "P": 12 * (data.n_poses + data.n_ext),
              "L": int(state0.X.shape[0]), "Em": int(data.mg_obs.shape[0]),
              "Es": int(data.st_obs.shape[0]), "U": int(data.mg_it_t.shape[0]),
              "structures": int(data.mg_sid_cols.shape[0])}
    chain = dict(zip(CHAIN_ARGS, chain_inputs(data, state0)))
    real = check_f32(tuple(a.double() for a in chain.values()))

    torch.cuda.reset_peak_memory_stats()
    interp_chain.LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    res, n_lin = run_slice(data, state0)
    sync()
    seconds = time.perf_counter() - t0
    launches = interp_chain.LAUNCHES
    err0, err1, ok = float(res.err_initial), float(res.err_final), bool(res.ok)
    if not (ok and np.isfinite(err1) and err1 < err0):
        raise AssertionError(f"local_gp_ba: ok={ok} err {err0} -> {err1}")
    if launches < n_lin + 1:  # + the outlier pass of the finalize step
        raise AssertionError(f"kernel launched {launches}x for {n_lin} linearizations")
    for name, a in res.state._asdict().items():
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite final {name}")
    emit("slice", shapes=shapes, dtype="float32", ok=ok, err_initial=err0,
         err_final=err1, linearizations=n_lin, kernel_launches=launches,
         seconds=seconds, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         erased=[int(res.erase_m.sum()), int(res.erase_st.sum())],
         kernel_on_slice_inputs=real)

    # float64: the card (kernel, atomics) against the CPU (plain chain)
    errs = {}
    outs = {}
    for dev in (device, "cpu"):
        d64, s64 = convert.ba_from_numpy(np_data, np_state, device=dev, dtype=torch.float64)
        p = ba.make_ba_problem(d64, d64.mg_valid, d64.sg_valid, d64.st_valid)
        lin = p.linearize(s64)
        (dxp, dxl), _, _ = p.solve(lin, torch.tensor(1.0, dtype=torch.float64, device=dev))
        outs[dev] = (*lin, dxp, dxl)
    names = ("Hpp", "bp", "Wt", "Hll", "bl", "dxp", "dxl")
    for i, name in enumerate(names):
        rtol, atol = (1e-9, 1e-10) if i < 5 else (1e-7, 1e-9)
        errs[name] = assert_close(name, outs[device][i], outs["cpu"][i], rtol, atol)
    emit("slice_f64_card_vs_cpu", worst_fraction_of_tolerance=errs,
         tolerances={"lin": [1e-9, 1e-10], "dx": [1e-7, 1e-9]})
    return data, state0, chain, launches, real["max_abs_vs_plain32"]


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_lm_iteration(problem, state0, lam, n_warm=3, n_iter=20, n_rep=5):
    """ms per chained LM iteration: median and all blocks."""
    def step(s):
        lin = problem.linearize(s)
        dx, _, _ = problem.solve(lin, lam)
        s = problem.retract(s, dx)
        return s, problem.chi2(s)

    s = state0
    for _ in range(n_warm):
        s, chi = step(s)
    sync()
    samples = []
    for _ in range(n_rep):
        s = state0
        sync()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            s, chi = step(s)
        sync()
        samples.append((time.perf_counter() - t0) / n_iter * 1e3)
    return statistics.median(samples), samples, float(chi)


def time_chain(fn, args, n=200) -> float:
    for _ in range(5):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    sync()
    return start.elapsed_time(end) / n


def phase_timing(data, state0, chain):
    problem = ba.make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    lam = torch.tensor(1.0, dtype=data.mg_obs.dtype, device=data.mg_obs.device)
    runs = []
    for variant in ("plain", "kernel", "kernel", "plain"):
        if variant == "plain":
            with mock.patch.object(interp_chain, "gp_interp_packs",
                                   interp_chain.gp_interp_packs_ref):
                ms, samples, chi = time_lm_iteration(problem, state0, lam)
        else:
            ms, samples, chi = time_lm_iteration(problem, state0, lam)
        runs.append({"chain": variant, "ms_median": ms, "ms_blocks": samples, "chi2": chi})
    args = tuple(chain.values())
    chain_ms = {"kernel": [], "plain": []}
    for variant in ("kernel", "plain", "plain", "kernel"):
        fn = interp_chain.gp_interp_packs if variant == "kernel" else interp_chain.gp_interp_packs_ref
        chain_ms[variant].append(time_chain(fn, args))
    emit("timing", lm_iteration=runs, chain_S=int(args[0].shape[0]), chain_ms=chain_ms)
    lm_ms = {v: statistics.median(r["ms_median"] for r in runs if r["chain"] == v)
             for v in ("kernel", "plain")}
    return lm_ms, {v: statistics.median(t) for v, t in chain_ms.items()}


def profile(data, state0, out_dir) -> None:
    """torch.profiler over 5 chained LM iterations: a table by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    problem = ba.make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    lam = torch.tensor(1.0, dtype=data.mg_obs.dtype, device=data.mg_obs.device)
    time_lm_iteration(problem, state0, lam, n_warm=2, n_iter=2, n_rep=1)
    n_iter = 5
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        s = state0
        for _ in range(n_iter):
            lin = problem.linearize(s)
            dx, _, _ = problem.solve(lin, lam)
            s = problem.retract(s, dx)
            problem.chi2(s)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    events = prof.key_averages()
    table = events.table(sort_by="self_device_time_total", row_limit=60)
    (out_dir / "lm_iteration_profile.txt").write_text(table)
    # device kernels only (an aten op's self device time repeats its kernels')
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    emit("profile", iterations=n_iter, wall_ms_per_iter=wall_ms / n_iter,
         device_ms_per_iter=dev_ms / n_iter,
         device_busy_share=dev_ms / wall_ms, kernel_launches_per_iter=launches / n_iter,
         table=str(out_dir / "lm_iteration_profile.txt"))


# ---------------------------------------------------------------------------
# phase 7: the interruptible local BA
# ---------------------------------------------------------------------------


def phase_interruptible(data, state0) -> None:
    """local_gp_ba_interruptible against local_gp_ba. index_add_ on CUDA
    sums with atomics unless deterministic algorithms are on; with them on,
    two runs of one op sequence are bitwise equal."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mono = ba.local_gp_ba(data, state0)
        seg, aborted = ba.local_gp_ba_interruptible(data, state0, seg_iters=4)
        polls = []
        cut, cut_aborted = ba.local_gp_ba_interruptible(
            data, state0, seg_iters=4, should_abort=lambda: polls.append(1) or True)
    finally:
        torch.use_deterministic_algorithms(False)
    sync()
    if aborted:
        raise AssertionError("local_gp_ba_interruptible aborted with no abort flag")
    def fields(res):
        return {**{f"state.{k}": v for k, v in res.state._asdict().items()},
                **{k: getattr(res, k) for k in res._fields if k != "state"}}

    want, got = fields(mono), fields(seg)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    if differ:
        raise AssertionError(f"interruptible != monolithic in {differ}")
    finite = all(bool(torch.isfinite(a).all()) for a in cut.state)
    if not (cut_aborted and len(polls) == 1 and finite
            and np.isfinite(float(cut.err_final))):
        raise AssertionError(f"abort run: aborted={cut_aborted} polls={len(polls)} "
                             f"finite={finite} err_final={float(cut.err_final)}")
    emit("interruptible", equal_fields=len(want), err_final=float(seg.err_final),
         aborted_err_final=float(cut.err_final), aborted_ok=bool(cut.ok))


# ---------------------------------------------------------------------------
# phase 8: the tracking solve
# ---------------------------------------------------------------------------


def ransac_input(dn, sn):
    """The MC-RANSAC input of the frame as tracking.py:562-615 builds it:
    every match (async-mono rows at their camera times, stereo-camera rows
    at t_cur on the last camera), dt = t_obs - t_last, padded to a pow2
    bucket with a safe row (a point 5 m ahead of the stereo camera of the
    last frame, at its principal point, dt = 0); 23 samples of 3 from a
    seeded generator (tracking.py:125, :612-615)."""
    n_m, n_s = dn["mg_t"].shape[0], dn["st_obs"].shape[0]
    cs = dn["Tbc"].shape[0] - 1
    t_last, t_cur = float(dn["t_prev"]), float(dn["t_cur"])
    n = n_m + n_s
    nb = 16
    while nb < n:
        nb *= 2
    Twc = sn["T"][0] @ dn["Tbc"][cs]
    ahead = Twc[:3, :3] @ np.array([0.0, 0.0, 5.0]) + Twc[:3, 3]
    pad = nb - n
    fields = dict(
        T_last=sn["T"][0],
        v0=sn["v"][1],
        dt=np.concatenate([dn["mg_t"] - t_last, np.full(n_s, t_cur - t_last), np.zeros(pad)]),
        Xw=np.concatenate([dn["mg_Xw"], dn["st_Xw"], np.tile(ahead, (pad, 1))]),
        obs=np.concatenate([dn["mg_obs"], dn["st_obs"][:, :2],
                            np.tile(dn["K"][cs, 2:4], (pad, 1))]),
        cam=np.concatenate([dn["mg_cam"], np.full(n_s, cs), np.full(pad, cs)]),
        w=np.concatenate([dn["mg_w"], dn["st_w"], np.ones(pad)]),
        valid=np.arange(nb) < n,
        Tbc=dn["Tbc"],
        K=dn["K"],
    )
    rng = np.random.RandomState(0)
    samples = np.stack([rng.choice(n, 3, replace=False) for _ in range(RANSAC_HYPOTHESES)])
    return fields, samples


def tracking_frame():
    """The frame's numpy arrays: pose problem (per-edge and table), start
    state, ground truth, RANSAC input, and the mask of injected outliers
    (the rows whose observation differs from the same seed's clean run)."""
    dn, sn, gn = make_pose_problem_numpy(**TRACKING)
    clean, _, _ = make_pose_problem_numpy(**{**TRACKING, "outlier_frac": 0.0})
    injected = np.concatenate([(dn["mg_obs"] != clean["mg_obs"]).any(1),
                               (dn["st_obs"] != clean["st_obs"]).any(1)])
    mg_it, it_t = pose_solver.interp_table(dn["mg_t"])
    branches = {"edge": dn, "table": {**dn, "mg_it": mg_it, "it_t": it_t}}
    rf, samples = ransac_input(dn, sn)
    return branches, sn, gn, rf, samples, injected


class Counts:
    """Host reads of the LM loops and linearizations of the pose solver,
    counted through the solvers' own seams while a `with` block runs."""

    def __init__(self):
        self.reads = 0
        self.lin = 0

    def __enter__(self):
        read, make = tlm._read, pose_solver.make_problem

        def counting_read(t):
            self.reads += 1
            return read(t)

        def counting_make(*args, **kw):
            problem = make(*args, **kw)

            def linearize(s):
                self.lin += 1
                return problem.linearize(s)

            return problem._replace(linearize=linearize)

        self._patches = [mock.patch.object(tlm, "_read", counting_read),
                         mock.patch.object(pose_solver, "make_problem", counting_make)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def pose_flags(ok, inl, n_m, n_s):
    """Initial outlier flags from the RANSAC result (none when it failed,
    Tracking.cc:1987-1988)."""
    if not bool(ok):
        inl = torch.ones_like(inl)
    return ~inl[:n_m], ~inl[n_m:n_m + n_s]


def check_pose(name, res, gt_T1, n_edges):
    state, _, _, (_, n_inl) = res
    t_err = float((state.T[1].double() - gt_T1.double()).abs().max())
    n_inl = int(n_inl)
    lo, hi = 0.8 * n_edges * 0.85, n_edges - 0.8 * 0.15 * n_edges
    if not (t_err < 2e-2 and lo <= n_inl <= hi):
        raise AssertionError(f"pose_gp_optimize[{name}]: |T - gt| {t_err:.3e}, "
                             f"inliers {n_inl} not in [{lo}, {hi}]")
    return {"T_err": t_err, "inliers": n_inl, "bounds": [lo, hi]}


def time_calls(fn, n_warm=2, n_iter=10, n_rep=3):
    """ms per call: median of n_rep blocks of n_iter, behind synchronize."""
    for _ in range(n_warm):
        fn()
    sync()
    samples = []
    for _ in range(n_rep):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        sync()
        samples.append((time.perf_counter() - t0) / n_iter * 1e3)
    return statistics.median(samples), samples


def phase_tracking(device):
    branches, sn, gn, rf, samples, injected = tracking_frame()
    n_m, n_s = branches["edge"]["mg_t"].shape[0], branches["edge"]["st_obs"].shape[0]
    n = n_m + n_s
    f32 = dict(device=device, dtype=torch.float32)
    rdata = convert.vel_ransac_from_numpy(rf, **f32)
    samp = torch.tensor(samples, device=device)
    pose = {b: convert.pose_from_numpy(d, sn, **f32) for b, d in branches.items()}
    gt_T1 = torch.tensor(gn["T"][1], **f32)
    ransac = lambda d: vel_ransac.mc_ransac(  # noqa: E731
        d, samp.to(d.dt.device), RANSAC_THRESHOLD, RANSAC_MIN_MATCH)

    # the main path: counts set to 0 just before, read just after
    per = {}
    sync()
    interp_chain.LAUNCHES = 0
    with Counts() as c:
        ok, v_best, inl, n_in = ransac(rdata)
        flags = pose_flags(ok, inl, n_m, n_s)
        sync()
        per["mc_ransac"] = {"host_reads": c.reads, "kernel_launches": interp_chain.LAUNCHES}
        res = {}
        for b in ("edge", "table"):
            reads0, lin0, launches0 = c.reads, c.lin, interp_chain.LAUNCHES
            res[b] = pose_solver.pose_gp_optimize(*pose[b], *flags)
            sync()
            per[b] = {"host_reads": c.reads - reads0, "linearizations": c.lin - lin0,
                      "kernel_launches": interp_chain.LAUNCHES - launches0}
    launches = interp_chain.LAUNCHES

    true_in = int((~injected).sum())
    kept_out = float(inl[:n].cpu().numpy()[injected].mean())
    if not (bool(ok) and int(n_in) >= 0.85 * true_in and kept_out < 0.3):
        raise AssertionError(f"mc_ransac: ok={bool(ok)} inliers {int(n_in)} of {true_in} "
                             f"true, outliers kept {kept_out:.2f}")
    pose_checks = {b: check_pose(b, res[b], gt_T1, n) for b in res}
    need = per["table"]["linearizations"] + 4  # + the 4 re-levelings
    if per["table"]["kernel_launches"] < need:
        raise AssertionError(f"table branch launched the kernel "
                             f"{per['table']['kernel_launches']}x, needs >= {need}")
    if per["edge"]["kernel_launches"] or per["mc_ransac"]["kernel_launches"]:
        raise AssertionError(f"kernel launched off the table branch: {per}")
    emit("tracking", shapes={"mono": n_m, "stereo": n_s, "ransac_rows": int(rdata.dt.shape[0]),
                             "hypotheses": RANSAC_HYPOTHESES,
                             "U": int(pose["table"][0].it_t.shape[0])},
         dtype="float32", ransac={"ok": bool(ok), "inliers": int(n_in), "true_inliers": true_in,
                                  "injected_outliers_kept": kept_out},
         pose=pose_checks, per_solve=per)

    # float64: the card against the CPU on the same inputs
    out = {}
    for dev in (device, "cpu"):
        f64 = dict(device=dev, dtype=torch.float64)
        rd = convert.vel_ransac_from_numpy(rf, **f64)
        v_h, inl_h, n_h = vel_ransac.score_hypotheses(rd, samp.to(dev), RANSAC_THRESHOLD)
        best = int(torch.argmax(n_h))
        o = {"best": best, "inl": inl_h[best], "count": int(n_h[best]), "v": v_h[best]}
        fl = pose_flags(n_h[best] >= RANSAC_MIN_MATCH, inl_h[best], n_m, n_s)
        for b, d in branches.items():
            pd, ps = convert.pose_from_numpy(d, sn, **f64)
            H, bv, _ = pose_solver.make_problem(pd, pd.mg_valid, pd.st_valid, True).linearize(ps)
            st, lm_, ls_, _ = pose_solver.pose_gp_optimize(pd, ps, *fl)
            o[b] = {"H": H, "b": bv, "T": st.T, "v": st.v, "masks": torch.cat([lm_, ls_])}
        out[dev] = o
    card, cpu = out[device], out["cpu"]
    if not (card["best"] == cpu["best"] and card["count"] == cpu["count"]
            and torch.equal(card["inl"].cpu(), cpu["inl"])):
        raise AssertionError(f"mc_ransac f64 card vs cpu: best {card['best']}/{cpu['best']}, "
                             f"count {card['count']}/{cpu['count']}")
    errs = {"ransac_v": assert_close("ransac v", card["v"], cpu["v"], 1e-9, 1e-9)}
    masks_equal = {}
    for b in branches:
        errs[f"{b}.H"] = assert_close(f"{b} H", card[b]["H"], cpu[b]["H"], 1e-9, 1e-10)
        errs[f"{b}.b"] = assert_close(f"{b} b", card[b]["b"], cpu[b]["b"], 1e-9, 1e-10)
        errs[f"{b}.T"] = assert_close(f"{b} T", card[b]["T"], cpu[b]["T"], 1e-7, 1e-7)
        errs[f"{b}.v"] = assert_close(f"{b} v", card[b]["v"], cpu[b]["v"], 1e-7, 1e-7)
        masks_equal[b] = bool(torch.equal(card[b]["masks"].cpu(), cpu[b]["masks"]))
    emit("tracking_f64_card_vs_cpu", worst_fraction_of_tolerance=errs,
         best_hypothesis=card["best"], inliers=card["count"], final_masks_equal=masks_equal,
         tolerances={"ransac_v": [1e-9, 1e-9], "H_b": [1e-9, 1e-10], "state": [1e-7, 1e-7]})

    # timing (float32)
    ms = {}
    ms["mc_ransac"] = time_calls(lambda: ransac(rdata))
    for b in ("edge", "table"):
        ms[f"pose_gp_optimize_{b}"] = time_calls(
            lambda b=b: pose_solver.pose_gp_optimize(*pose[b], *flags))
    emit("tracking_timing", ms_median={k: v[0] for k, v in ms.items()},
         ms_blocks={k: v[1] for k, v in ms.items()}, blocks="3 x 10 after 2 warm-up")
    return launches, {k: v[0] for k, v in ms.items()}, per, (rdata, ransac, pose, flags)


def profile_tracking(rdata, ransac, pose, flags, out_dir) -> None:
    """torch.profiler over one mc_ransac and one pose solve per branch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    calls = {"mc_ransac": lambda: ransac(rdata)}
    for b in ("edge", "table"):
        calls[f"pose_gp_optimize_{b}"] = lambda b=b: pose_solver.pose_gp_optimize(*pose[b], *flags)
    out_dir.mkdir(parents=True, exist_ok=True)
    report, tables = {}, []
    for name, fn in calls.items():
        fn()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type != DeviceType.CPU]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        report[name] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                        "device_busy_share": dev_ms / wall_ms,
                        "device_kernel_launches": sum(e.count for e in kernels)}
        tables.append(f"== {name}\n" + events.table(sort_by="self_device_time_total",
                                                     row_limit=25))
    (out_dir / "tracking_profile.txt").write_text("\n\n".join(tables))
    emit("tracking_profile", per_solve=report, table=str(out_dir / "tracking_profile.txt"))


# ---------------------------------------------------------------------------
# phase 9: the System entry point
# ---------------------------------------------------------------------------


def system_sequence():
    """The phase's sequence; n_lm is raised (to at most 6,000) while the
    mean keypoints per camera per frame stay below 300."""
    seq = dict(SYSTEM_SEQ)
    t0 = time.perf_counter()
    while True:
        frames, rig, Ts, _ = make_sequence(**seq)
        kp = float(np.mean([len(k) for f in frames for k in f.keypoints]))
        if kp >= SYSTEM_MIN_KP or seq["n_lm"] >= SYSTEM_MAX_LM:
            break
        seq["n_lm"] = min(SYSTEM_MAX_LM, 2 * seq["n_lm"])
    path = float(np.linalg.norm(np.diff(Ts[:, :3, 3], axis=0), axis=1).sum())
    emit("system_sequence", **seq, mean_keypoints_per_camera_per_frame=kp,
         path_m=path, seconds=time.perf_counter() - t0)
    if kp < SYSTEM_MIN_KP:
        raise AssertionError(f"{kp:.1f} keypoints per camera per frame at n_lm={seq['n_lm']}")
    return frames, rig, Ts, path


class SystemProbe:
    """Counts and sizes on the System's path, taken through its seams while a
    `with` block runs: local-BA linearizations, the largest local-BA window
    and pose problem (real and padded), the local-mapping time of each
    `track_multicamera` call."""

    def __init__(self):
        self.lin = 0
        self.lba = {}
        self.pose = {}

    def __enter__(self):
        make, ext_lba = ba.make_ba_problem, local_mapping.extract_local_ba
        ext_pose = tracking.extract_pose_problem

        def counting_make(*args, **kw):
            problem = make(*args, **kw)

            def linearize(s):
                self.lin += 1
                return problem.linearize(s)

            return problem._replace(linearize=linearize)

        def lba(*args, **kw):
            data, state, h = ext_lba(*args, **kw)
            real = {"K": len(h["kfs"]), "Em": len(h["mg_refs"]), "Es": len(h["st_refs"]),
                    "L": len(h["lms"])}
            if real["Em"] + real["Es"] > self.lba.get("real", {}).get("edges", -1):
                self.lba = {"real": {**real, "edges": real["Em"] + real["Es"]},
                            "padded": {"K": data.n_poses, "Em": int(data.mg_obs.shape[0]),
                                       "Es": int(data.st_obs.shape[0]),
                                       "L": int(state.X.shape[0])}}
            return data, state, h

        def pose(*args, **kw):
            data, state, h = ext_pose(*args, **kw)
            if h["n_mg"] + h["n_st"] > self.pose.get("real", {}).get("edges", -1):
                self.pose = {"real": {"Nm": h["n_mg"], "Ns": h["n_st"],
                                      "edges": h["n_mg"] + h["n_st"]},
                             "padded": {"Nm": h["Nm"], "Ns": h["Ns"],
                                        "U": int(data.it_t.shape[0])}}
            return data, state, h

        self._patches = [mock.patch.object(ba, "make_ba_problem", counting_make),
                         mock.patch.object(local_mapping, "extract_local_ba", lba),
                         mock.patch.object(tracking, "extract_pose_problem", pose)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def run_system(frames, rig, device, dtype, threaded=False):
    """One System run over `frames` (copies; tracking mutates them). Keyframe
    and map-point ids start at ID_START and the shape buckets start empty,
    so two runs of one sequence see the same ids and shapes. Returns the
    System and per-frame records: state, wall ms of the call (synchronized),
    ms of local mapping inside it (sequential mode), keyframe ids, map-point
    count, pose."""
    frames = copy.deepcopy(frames)
    on_card = torch.device(device).type == "cuda"
    map_store._ids = itertools.count(ID_START)
    extraction.reset_bucket_high_water()
    sys_ = System(copy.deepcopy(rig), tracking.TrackingConfig(**SYSTEM_CFG),
                  enable_loop_closing=False, threaded=threaded, device=device, dtype=dtype)
    mapping_ms = [0.0]
    run_once = sys_.local_mapper.run_once

    def timed_run_once(*args, **kw):
        t0 = time.perf_counter()
        try:
            return run_once(*args, **kw)
        finally:
            mapping_ms[0] += (time.perf_counter() - t0) * 1e3

    if not threaded:
        sys_.local_mapper.run_once = timed_run_once
    records = []
    for f in frames:
        n_kf = sys_.atlas.active.n_keyframes()
        mapping_ms[0] = 0.0
        if on_card:
            sync()
        t0 = time.perf_counter()
        st = sys_.track_multicamera(f)
        if on_card:
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        m = sys_.atlas.active
        records.append({"state": st.name, "ms": ms, "mapping_ms": mapping_ms[0],
                        "kf": m.n_keyframes() > n_kf, "kf_ids": sorted(m.keyframes),
                        "n_mp": m.n_map_points(), "Twb": np.array(f.Twb, np.float64)})
    return sys_, records


def trajectory_ate(sys_, frames, Ts) -> float:
    """ATE of `trajectory_poses()` against the ground truth, associated by
    the frames' own timestamps (k * 0.1 in make_sequence: k / 10 differs from
    it in the last bit for some k, and nearest-timestamp association would
    then pair a pose with the next frame's ground truth)."""
    poses = sys_.tracker.trajectory_poses()
    est_t = np.array([t for t, _ in poses])
    est_T = np.stack([T for _, T in poses])
    if not np.isfinite(est_T).all():
        raise AssertionError("non-finite trajectory")
    gt_t = np.array([f.timestamp for f in frames])
    return ate_rmse(est_t, est_T, gt_t, Ts)[0]


def rot_angle(Ra, Rb) -> float:
    R = Ra.T @ Rb
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


def pct(xs, q) -> float | None:
    return float(np.percentile(xs, q)) if len(xs) else None


def system_sequential(frames, rig, Ts, path_m, device):
    """9a: float32, sequential, all frames; the counts are set to 0 just
    before the run. Returns (chain launches, the phase's record)."""
    GLOBAL_TIMER.samples.clear()
    torch.cuda.reset_peak_memory_stats()
    sync()
    interp_chain.LAUNCHES = 0
    t0 = time.perf_counter()
    with SystemProbe() as probe:
        sys_, rec = run_system(frames, rig, device, torch.float32)
    sync()
    seconds = time.perf_counter() - t0
    launches = interp_chain.LAUNCHES
    states = [r["state"] for r in rec]
    n_kf = sys_.atlas.active.n_keyframes()
    ate = trajectory_ate(sys_, frames, Ts)
    n_tracked = sum(s == "OK" for s in states[1:])
    track_ms = {kind: [r["ms"] - r["mapping_ms"] for r in rec[1:] if r["kf"] == kind]
                for kind in (True, False)}
    lba_ms = [1e3 * s for s in GLOBAL_TIMER.samples["lm.local_ba"]]
    out = {
        "dtype": "float32", "frames": len(rec), "states_ok": states.count("OK"),
        "keyframes": n_kf, "map_points": sys_.atlas.active.n_map_points(),
        "ate_m": ate, "ate_pct_of_path": 100 * ate / path_m, "path_m": path_m,
        "ate_bound_pct": SYSTEM_ATE_PCT,
        "tracking_ms": {"kf_frames": {"median": pct(track_ms[True], 50),
                                      "p90": pct(track_ms[True], 90), "n": len(track_ms[True])},
                        "non_kf_frames": {"median": pct(track_ms[False], 50),
                                          "p90": pct(track_ms[False], 90),
                                          "n": len(track_ms[False])}},
        "frame_ms_median_incl_mapping": pct([r["ms"] for r in rec[1:]], 50),
        "local_ba_ms_per_kf": {"median": pct(lba_ms, 50), "n": len(lba_ms)},
        "local_ba_linearizations": probe.lin, "largest_local_ba": probe.lba,
        "largest_pose_problem": probe.pose, "chain_kernel_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "seconds": seconds,
        "spans_median_ms": {k: v["median_ms"] for k, v in GLOBAL_TIMER.stats().items()},
    }
    emit("system_sequential", **out)
    if states.count("OK") != len(states):
        raise AssertionError(f"9a: not every frame OK: {states}")
    if not ate <= SYSTEM_ATE_PCT / 100 * path_m:
        raise AssertionError(f"9a: ATE {ate:.4f} m > {SYSTEM_ATE_PCT} % of {path_m:.3f} m")
    if n_kf < 15:
        raise AssertionError(f"9a: {n_kf} keyframes < 15")
    if launches < n_tracked + probe.lin:
        raise AssertionError(f"9a: {launches} chain launches < {n_tracked} tracked frames "
                             f"+ {probe.lin} local-BA linearizations")
    return launches, out


def system_f64(frames, rig, device):
    """9b: float64, the card against the port on the CPU, deterministic
    algorithms on for the comparison only."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {dev: run_system(frames[:SYSTEM_F64_FRAMES], rig, dev, torch.float64)[1]
                for dev in (device, "cpu")}
    finally:
        torch.use_deterministic_algorithms(False)
    card, cpu = runs[device], runs["cpu"]
    worst = {"t_m": 0.0, "r_rad": 0.0}
    for i, (a, b) in enumerate(zip(card, cpu)):
        if (a["state"], a["kf_ids"], a["n_mp"]) != (b["state"], b["kf_ids"], b["n_mp"]):
            raise AssertionError(f"9b frame {i}: card {a['state']} {len(a['kf_ids'])} KF "
                                 f"{a['n_mp']} MP vs cpu {b['state']} {len(b['kf_ids'])} KF "
                                 f"{b['n_mp']} MP")
        worst["t_m"] = max(worst["t_m"], float(np.abs(a["Twb"][:3, 3] - b["Twb"][:3, 3]).max()))
        worst["r_rad"] = max(worst["r_rad"], rot_angle(a["Twb"][:3, :3], b["Twb"][:3, :3]))
    emit("system_f64_card_vs_cpu", frames=len(card), keyframes=len(card[-1]["kf_ids"]),
         map_points=card[-1]["n_mp"], worst=worst, tolerance={"t_m": 1e-8, "r_rad": 1e-8},
         card_ms_median=pct([r["ms"] for r in card[1:]], 50),
         cpu_ms_median=pct([r["ms"] for r in cpu[1:]], 50))
    if not (worst["t_m"] <= 1e-8 and worst["r_rad"] <= 1e-8):
        raise AssertionError(f"9b: poses differ by {worst}")


def system_threaded(frames, rig, Ts, device):
    """9c: the threaded schedule, float32."""
    t0 = time.perf_counter()
    n = SYSTEM_THREADED_FRAMES
    sys_t, rec_t = run_system(frames[:n], rig, device, torch.float32, threaded=True)
    deadline = time.time() + 300
    while sys_t.local_mapper.queue and time.time() < deadline:
        time.sleep(0.05)
    sys_t.shutdown()
    sync()
    states_t = [r["state"] for r in rec_t]
    path_t = float(np.linalg.norm(np.diff(Ts[:n, :3, 3], axis=0), axis=1).sum())
    ate_t = trajectory_ate(sys_t, frames[:n], Ts[:n])
    emit("system_threaded", frames=len(rec_t), states_ok=states_t.count("OK"),
         last5=states_t[-5:], keyframes=sys_t.atlas.active.n_keyframes(),
         n_ba_aborted=sys_t.local_mapper.n_ba_aborted,
         tracking_ms_median=pct([r["ms"] for r in rec_t[1:]], 50),
         ate_m=ate_t, ate_pct_of_path=100 * ate_t / path_t, path_m=path_t,
         seconds=time.perf_counter() - t0)
    if any(s != "OK" for s in states_t[-5:]):
        raise AssertionError(f"9c: last 5 states {states_t[-5:]}")
    if not ate_t <= 0.02 * path_t:
        raise AssertionError(f"9c: ATE {ate_t:.4f} m > 2 % of {path_t:.3f} m")


def phase_system(device, smi):
    t_phase = time.perf_counter()
    path = native.build()
    native._require()
    emit("system_build", native=str(path))
    frames, rig, Ts, path_m = system_sequence()
    launches, out = system_sequential(frames, rig, Ts, path_m, device)
    system_f64(frames, rig, device)
    system_threaded(frames, rig, Ts, device)
    emit("system_summary", seconds=time.perf_counter() - t_phase, card=smi,
         tracking_ms=out["tracking_ms"], local_ba_ms_per_kf=out["local_ba_ms_per_kf"],
         chain_kernel_launches=launches, peak_mem_bytes=out["peak_mem_bytes"])
    return launches


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's smoke run needs a GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)

    # 2. build
    res = _build.build("interp_chain")
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    interp_chain._library()
    emit("build", seconds=res.seconds, library=str(res.path), ptxas=ptxas)

    # 3. the kernel against its plain version
    phase_kernel(device)

    # 4. the slice
    np_data, np_state, _ = make_local_ba_problem_numpy(**HEADLINE)
    data, state0, chain, launches, max_abs_err = phase_slice(device, np_data, np_state)

    # 5. timing
    lm_ms, chain_ms = phase_timing(data, state0, chain)
    emit("summary", lm_iteration_ms=lm_ms, chain_ms=chain_ms, card=smi)
    # 6. profile
    profile(data, state0, _build.BUILD_DIR.parent / "profile")
    # 7. the interruptible local BA
    phase_interruptible(data, state0)
    # 8. the tracking solve
    t_launches, t_ms, t_per, prof_args = phase_tracking(device)
    emit("tracking_summary", ms=t_ms, per_solve=t_per, card=smi)
    profile_tracking(*prof_args, _build.BUILD_DIR.parent / "profile")
    # 9. the System entry point
    s_launches = phase_system(device, smi)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gp_interp_chain",
        "route": "cuda",
        "source": "amcslam_tpu_torch/csrc/interp_chain.cu",
        "replaces": "amcslam_tpu/ops/pallas_chain.py:296",
        "launches": launches + t_launches + s_launches,
        "max_abs_err": max_abs_err,
        "ms": chain_ms["kernel"],
        "plain_ms": chain_ms["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
