#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`amcslam_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each printing one JSON line; any failure raises (nonzero exit, no
result line):

  1. device  — a CUDA device is required (there is no CPU path);
  2. build   — nvcc builds csrc/interp_chain.cu into build/kernels/;
  3. kernel  — the GP-interpolation-chain kernel against its plain PyTorch
               version on the card at S = 1, 6, 130, 256, 1024, 2048 and
               8192 combos (one block of 8 combos to 1,024 blocks): float64 to max-rel
               1e-12, float32 within max(5e-5, 10x the plain float32
               distance from float64); heads of 1, 6 and 130 combos equal
               the full batch's bit for bit; the indexed entry equals
               `gp_interp_packs` bit for bit; the pair entry (a tracked
               frame's pose solve, S = 6) likewise;
  4. slice   — `local_gp_ba` at the headline shape of the reference's bench
               (50 KF, 5000 landmarks, 6 cameras, 4 obs/landmark, 2 GP obs/
               landmark, seed 0, float32) through the kernel: ok, chi2
               decreasing, at least one kernel launch per linearization;
               then one float64 linearize + solve on the card against the
               port on the CPU (plain chain);
  5. timing  — ms per chained LM iteration (linearize -> solve -> retract ->
               chi2, lambda = 1; 3 warm-up + median of 5 blocks of 20), once
               through the kernel and once with the plain chain bound in, in
               the order plain, kernel, kernel, plain; and the chain's entry
               (host included) at the headline's 1024 combos;
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
               ms per solve (median of 3 blocks of 5), kernel launches and
               host reads per solve, and a torch.profiler table in
               build/profile/tracking_profile.txt.
  9. system — the port's entry point `System.track_multicamera` (loop
               closing off) on make_sequence(60 frames, 6 cameras, 3000
               landmarks, 0.3 px, seed 0) with the tracking config of
               tests/test_system.py; g++ builds the native matcher into
               build/native/ first. 9a: float32, sequential, the first 16
               frames: every frame OK, ATE <= 0.5 % of the path, >= 4
               keyframes, at least one chain-kernel launch per tracked frame
               plus one per local-BA linearization; per-frame tracking ms,
               local-BA ms per keyframe, the largest problem sizes, peak
               memory. 9b: float64 on the card against the port on the CPU,
               first 8 frames, deterministic algorithms on: the same states,
               keyframe ids and map-point counts, poses to 1e-8 m / 1e-8 rad.
               9c: the threaded schedule, float32, the first 12 frames: OK
               in the last 5, a
               finite trajectory, ATE <= 2 % of the path, loop closing on
               (the reference's default). 9a also counts the chain's
               launches by entry and size.
 10. sizes  — the chain at the sizes 9a launched it: a tracked frame's pose
               pair (S = U = 6), the largest local-BA window's combos (the
               live lba.Um bucket), the headline's 1024 combos in float32 and
               float64, on the inputs those calls had: kernel vs plain
               (float64 1e-12 on the live combos, the derived tolerance of
               `check_padded` on the padded ones, the float32 envelope), the
               entry bit-equal to `gp_interp_packs` on gathered rows; then
               device ms per launch (CUDA events around 200 launches queued
               behind a spin kernel, so the host's launch cost is hidden) of
               the kernel, the kernel on gathered rows and an empty kernel of
               the same library (the launch floor), in turns; host-inclusive
               ms of the entry and of the plain version; the bound at each
               size; and the same at the global BA's live lba.Um (11a). It
               runs after 9 and 11 because those sizes are known only there.
 11. loop   — loop closing. 11a: the System with loop closing on over
               the first 12 frames of make_sequence(64 frames, 6 cameras,
               3000 landmarks, 1 frame/s, 0.3 px, seed 0), float32,
               sequential, 9a's tracking config: every frame OK, the closer
               ran detection on every keyframe past its 12-keyframe guard and
               its database holds every keyframe, ATE <= 0.5 % of the path;
               the candidates tried and the loops closed (the JAX reference
               on a CPU closed none); then the closer's own full-map global
               BA on the final map: applied, finite chi2, the chain kernel
               launched at least once per linearization (counted by entry and
               size), ATE <= 0.5 %; ms per detection, the global BA's
               extraction / solve / write-back ms, its sizes, peak memory.
               11b: build_loop_map(120 KF, 600 + 119 x 120 landmarks, drift
               0.04, seed 0) closed by LoopClosing(fix_scale, min_matches 15,
               consistency 1): float32 detects KF 0, halves the last
               keyframe's position error at least, applies one global BA;
               the optimize_sim3 inliers and Sim3, the ms of detection,
               propagation, essential graph, fuse and global BA; then the
               same closure in float64 on the card and on the CPU
               (deterministic algorithms on; the CPU run on a thread beside
               the card's): every pose to 1e-8 m / 1e-8 rad after the
               essential graph, and after the global BA to LM_FLOOR_TOL (see
               `loop_map`), equal fused counts and
               map-point ids; then detached (joined): one global BA applied,
               poses those of the synchronous run to 1e-8. 11c: the
               essential graph of config 5a (500 KF, 40 loops, seed 0, dense):
               float64 card vs CPU chi2 per LM iteration to rtol 1e-9 and the
               vertices to LM_FLOOR_TOL (see `essential_graphs`), ms per
               optimize_essential_graph in float32;
               config 5e (2,000 KF on 4 laps of 10 km, 60 loops, drift 0.002,
               seed 4) by PCG in float32: aligned ATE <= 0.5 % of the path,
               the ATE before and after, the solve's ms, the CG steps of each
               LM iteration and the final relative residual.

 12. frontend — the image frontend and the entry points, float32. 12a:
               one rendered 640x480 tick of the AMV rig (7 images, the seed-1
               corridor), 1,200 features: the native ORB equals its numpy
               oracle (keypoints, octaves, descriptors; angles to 1e-12), the
               device ORB on the card equals the same function on the CPU
               (slots and scores exact, angles to 1e-5, descriptor bits off
               the .5 rounding edges exact), the device renderer agrees with
               the host renderer on >= 99 % of each view's pixels; the share
               of host keypoints the device ORB also finds (within 1 px, same
               octave), ms per rig frame of the host thread pool and of the
               batched device call, the device call's kernel launches. 12b:
               `e2e_rendered.run` of tests/test_e2e_scenarios.py:63-88 (seed
               1, 5 fps, 5 async + stereo, 400 features) on its first 16
               frames with the device ORB and the device renderer: every
               frame after the first OK, ATE < 0.5 % of the path, async-camera
               observations in the map, at least one chain launch per tracked
               frame; then :128-155 (seed 2, async camera 0 KB8) on its first
               10 frames: the same with ATE < 1 % and KB8 observations in the
               map; median render / extract / track ms, local-BA ms per
               keyframe, peak memory. 12c: the blackout run of
               tests/test_e2e_scenarios.py:90-125 unchanged (90 frames, 5
               fps, seed 0, a circle of period 12 s and radius 4 m, 500
               features, host ORB, frames 66-71 black; its frames 0-65 are
               tests/test_loop_e2e.py:41-48's, whose closure fires before
               the blackout): at least one loop closed, ATE < 1 % of the
               path, OK over frames 30-65, RECENTLY_LOST within 67-79, OK
               from the recovery frame (the first OK from 72) to the end,
               post-recovery ATE < 1 %; the closer's stage ms, the closure
               frames, loop-edge records and chain launches. 12d: tests/test_amv_cli.py's 6-frame, 3-camera
               dataset written to build/amv_cli/ with the port's PNG writer,
               then `python -m amcslam_tpu_torch.examples.multicam_amv
               <yaml> --no-realtime --device cuda` in a subprocess: exit 0
               and that test's TUM checks.
 13. solvers — the rest of the single-chip solver library. 13a: at the
               headline window, make_ba_problem with the interp-combo and
               landmark tables and without them (the per-edge packed GP
               factors, the segment-sum Wt): float64 to phase 4's
               tolerances, float32 within max(5e-5, 10x the table path's own
               distance from float64); ms of one linearize on each path.
               13b: at the headline window in float64, make_ba_problem_pcg
               (400 CG steps, tolerance 1e-20) gives the dense step to 1e-7
               with both preconditioners; global_ba_pcg for 10 iterations
               beside global_ba (final chi2 relative 1e-6) and beside the
               same run on the CPU (equal iterations, final chi2 relative
               1e-6); the chain kernel launched in every linearization.
               13c: config 5d at full size (bench.py:265-294: 2,000 KF, 10k
               landmarks, float32, 40 CG steps / 1e-3, lambda 1e-3): 3
               warm-up and 5 timed chained LM iterations with ms, CG steps,
               relative residual, the fixed part (linearize + the solve
               without CG steps) and ms per CG step; kernel launches per CG
               step (profiler), peak memory, the host build's seconds, and
               the chi2 after 2 iterations in float32 against float64 on the
               card (relative 1e-4); then the reference's warm-start study
               (examples/profile_pcg.py --warm) on the same problem: 12
               chained LM iterations cold (x0 = 0) and warm (x0 = the last
               step), ms per LM iteration and both chi2 chains, each finite
               and ending below the start. 13d: config 4 (20 KF, 500 landmarks),
               vi_ba for 10 iterations in float32 and float64 on the card,
               float64 card vs CPU (chi2 per iteration 1e-9, states 1e-8);
               ms per LM iteration, the final chi2 beside the ground
               truth's. 13e: two_view.reconstruct with 200 hypotheses over
               1,000 matches (10 % outliers), general and planar scenes of
               seeds 0-7, float64: card = CPU on each; every general scene
               takes F, at least one is ok and the ok ones recover R within
               0.05; every planar scene's best homography holds R within
               0.05; ms per reconstruct.
 14. multidevice — the sharded solvers (parallel/): one `run_ranks` spawn
               of 4 ranks on cuda:0, joined by gloo (NCCL takes one card
               per rank), runs 14a-14c; every rank's failure fails the run.
               14a: `entry.dryrun_rank(4)` (the dry run's landmark-sharded
               BA and edge-sharded essential graph, float32, 3 LM
               iterations): both chi2 finite and within max(1e-5, 10x the
               single-device run's own move under a 4-ulp float32
               perturbation of its start) of the single-device run. 14b: the landmark-sharded local BA at
               the headline window (tests/test_sharded_ba.py:98-123: 50 KF,
               5000 landmarks, 6 cameras, seed 0), float64, 10 LM
               iterations from lambda 1: the single-device run's iteration
               count, chi2 rtol 1e-10, T and v atol 1e-8, X through
               lm_perm atol 1e-7, the same replicated state on every rank;
               chain launches per rank, ms per LM iteration sharded beside
               single-device (4 ranks sharing one card: not a scaling
               figure); then the same problem on a world of one rank (this
               process) under NCCL equals the deterministic single-device
               run to rtol 1e-12. 14c: the edge-sharded essential graph
               (PCG from lambda 1e-16): config 5a in float64 for 5 LM
               iterations against the single-device PCG problem (chi2 rtol
               1e-9, t atol 1e-7), config 5e in float32 for 3 (ATE <= 0.5 %
               of the path); ms per LM iteration, all-reduces per CG step;
               the ranks' start-up and each job's seconds.
 15. orb profile — examples/profile_orb_device.py on 12a's tick (7
               images, 1,200 features): device ms (CUDA events), kernel
               launches and share of the tick of each stage (resize, FAST,
               NMS and the cells, top-K, orientation, blur, BRIEF) and of
               the full batched extractor.

Phases 13, 14 and 15 run after phase 12 and before phase 10; the kernels
line's launches include phase 14's in every rank. The kernels line keeps
`ms` and `plain_ms` as phase 5 measures them (the
entry and the plain version at the headline's 1024 combos, host included);
phase 10's device time per launch at that size is `device_ms`.

Cuts, so that the whole run stays near 10 minutes, half of its 20-minute
limit: phase 8's timing runs 3 blocks of 5 solves (5 of 20 before phase 9
was added, then 3 of 10); since phase 11 was added, 9a runs 16 of its
sequence's 60 frames (all before), 9b 8 (15, then 10) and 9c 12 (30, then
20); since phase 12 was added, 11a runs 16 frames of its 64-frame sequence
(56 before, so that the oracle path came back to its start at frame 51; it
formed no loop candidate there, and 12c now drives a live revisit and
closure from rendered images: 16 frames keep 5 detections past the
closer's guard and its full-map global BA), and since phase 14 was added
12 (one detection and the global BA); 12b 16 of its scenario's 40
frames and the fisheye run 10 of its 30. 12c became the 90-frame blackout
run (20 frames more than tests/test_loop_e2e.py's 70) with nothing cut
elsewhere. Every line carries `t_s`, the seconds since the start.

`python3 chip_smoke.py --scenarios` runs, after phase 10, the opt-in
scenarios of tests/test_e2e_scenarios.py at full size, host ORB, with the
checks of tests/test_torch_e2e_scenarios.py: the figure-eight (:38-60,
160 frames: at least 2 closures, ATE < 0.5 %, at least 2 loop-edge
records) and the threaded pin (:157-200, 40 frames sequential then
threaded: the threaded median tracking ms from frame 10 on under 0.5x the
sequential one, both ATEs under 2 %). Each prints its closures and their
frames, loop-edge records, ATE, per-frame tracking median and p90, the
closer's stage ms and chain launches, and every check by name; a check the
reference's own CPU run fails (`KNOWN_REFERENCE_FAULTS`) is reported as
that fault, and must fail on the card too. Any other failed check fails
the run. The default run does not run them.

The last three lines are the card's `nvidia-smi` name and power limit, the
kernels' JSON record and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from amcslam_tpu_torch import _build, convert, entry, native
from amcslam_tpu_torch.examples import e2e_rendered as e2e
from amcslam_tpu_torch.examples import profile_orb_device
from amcslam_tpu_torch.examples.profile_pcg import (HBM_BYTES_PER_S, PEAK_FLOPS, cg_step_bound,
                                                    profile_warm_start)
from amcslam_tpu_torch.frontend import features, orb, orb_device
from amcslam_tpu_torch.ops import interp_chain, lie
from amcslam_tpu_torch.parallel import group as pgroup
from amcslam_tpu_torch.parallel import sharded_ba, sharded_eg
from amcslam_tpu_torch.pipeline import extraction, local_mapping, map_store, tracking
from amcslam_tpu_torch.pipeline.keyframe_database import KeyFrameDatabase
from amcslam_tpu_torch.pipeline.loop_closing import LoopClosing
from amcslam_tpu_torch.pipeline.system import System
from amcslam_tpu_torch.ransac import two_view, vel_ransac
from amcslam_tpu_torch.solver import ba, pose_solver, sim3_opt, vi_ba
from amcslam_tpu_torch.solver import lm as tlm
from amcslam_tpu_torch.utils.io import ate_rmse, write_png_gray
from amcslam_tpu_torch.utils.synthetic import (build_loop_map, make_essential_graph_numpy,
                                               make_local_ba_problem_numpy,
                                               make_pose_problem_numpy, make_sequence,
                                               make_vi_ba_synthetic_numpy)
from amcslam_tpu_torch.utils.timing import GLOBAL_TIMER
from tools.time_chain_kernel import time_device

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
# from one block of 8 combos (csrc/interp_chain.cu) to several blocks an SM
CHECK_SIZES = (1, 6, 130, 256, 1024, 2048, 8192)
CHAIN_ARGS = ("T1", "v1", "T2", "v2", "t1", "t2", "t")
# tests/test_system.py:21-22; the rig of 5 async monos + a stereo camera is
# the AMV width (tests/test_e2e_scenarios.py:63-66)
SYSTEM_SEQ = dict(n_frames=60, n_cams=6, n_lm=3000, noise_px=0.3, seed=0)
SYSTEM_CFG = dict(max_frames_between_kf=3, ransac_min_match=15, kf_translation_th=0.25)
SYSTEM_MIN_KP = 300        # mean keypoints per camera per frame
SYSTEM_MAX_LM = 6000
SYSTEM_FRAMES = 16            # 9a: of the sequence's 60
SYSTEM_MIN_KF = 4             # 9a: a keyframe every 2 frames expected
SYSTEM_F64_FRAMES = 8
SYSTEM_THREADED_FRAMES = 12
SYSTEM_ATE_PCT = 0.5        # ATE bound of 9a, % of the path length
ID_START = 10_000_000


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line; `t_s` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 3)}), flush=True)


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


def assert_equal_packs(what, got, want) -> None:
    for k in KEYS:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")


def check_f64(what, got, ref) -> float:
    err = max(max_rel(got[k], ref[k]) for k in KEYS)
    if not err <= 1e-12:
        raise AssertionError(f"f64 {what}: kernel vs plain {err:.3e} > 1e-12")
    return err


def table_form(args: tuple) -> tuple:
    """Per-row chain inputs as the indexed entry takes them: both endpoints'
    rows in one shuffled state table, and the rows of each combo."""
    T1, v1, T2, v2, t1, t2, t = args
    S = t.shape[0]
    perm = torch.randperm(2 * S, generator=torch.Generator().manual_seed(S)).to(t.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(2 * S, device=t.device)
    T, v, times = (torch.cat([a, b])[perm].contiguous() for a, b in ((T1, T2), (v1, v2), (t1, t2)))
    return T, v, times, inv[:S].contiguous(), inv[S:].contiguous(), t


def gathered(T, v, times, i, j, t) -> tuple:
    """The indexed entry's inputs as per-row inputs of `gp_interp_packs`."""
    return (T[i].contiguous(), v[i].contiguous(), T[j].contiguous(), v[j].contiguous(),
            times[i].contiguous(), times[j].contiguous(), t)


def expanded(T, v, t1, t2, t) -> tuple:
    """The pair entry's inputs as per-row inputs of `gp_interp_packs`."""
    S = t.shape[0]
    return tuple(a.expand(S, *a.shape).contiguous()
                 for a in (T[0], v[0], T[1], v[1], t1, t2)) + (t,)


def f32_summary(rec: dict) -> dict:
    """check_f32's record as the worst kernel and plain distances over the
    three outputs."""
    return {"f32_kernel_vs_f64": max(rec[k]["kernel_vs_f64"] for k in KEYS),
            "f32_plain_vs_f64": max(rec[k]["plain32_vs_f64"] for k in KEYS)}


def phase_kernel(device) -> None:
    cases = {}
    for case in ("generic", "near_pi", "tiny"):
        per = {}
        for n in CHECK_SIZES:
            args = random_case(3 + n, n, case, device)
            got = interp_chain.gp_interp_packs(*args)
            err = check_f64(f"{case} S={n}", got, interp_chain.gp_interp_packs_ref(*args))
            for h in (1, 6, 130):
                if h < n:
                    head = interp_chain.gp_interp_packs(*(a[:h] for a in args))
                    assert_equal_packs(f"{case}: S={h} head of S={n}", head,
                                       {k: got[k][:h] for k in KEYS})
            assert_equal_packs(f"{case} S={n}: indexed vs gp_interp_packs",
                               interp_chain.gp_interp_packs_indexed(*table_form(args)), got)
            per[n] = {"f64_max_rel": err, **f32_summary(check_f32(args))}
        # the pose solver's form: the first combo's pair at 6 times in its interval
        T1, v1, T2, v2, t1, t2, _ = random_case(3, 1, case, device)
        t = t1[0] + torch.linspace(0.0, 1.0, 6, dtype=t1.dtype, device=device) * (t2[0] - t1[0])
        pair = (torch.stack([T1[0], T2[0]]), torch.stack([v1[0], v2[0]]), t1[0], t2[0],
                t.contiguous())
        got = interp_chain.gp_interp_packs_pair(*pair)
        assert_equal_packs(f"{case}: pair vs gp_interp_packs", got,
                           interp_chain.gp_interp_packs(*expanded(*pair)))
        per["pair_6"] = {"f64_max_rel": check_f64(f"{case} pair", got,
                                                  interp_chain.gp_interp_packs_pair_ref(*pair)),
                         **f32_summary(check_f32(expanded(*pair)))}
        cases[case] = per
    sync()
    emit("kernel", S=list(CHECK_SIZES), heads=[1, 6, 130], tol_f64=1e-12, cases=cases)


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
            with mock.patch.object(interp_chain, "gp_interp_packs_indexed",
                                   interp_chain.gp_interp_packs_indexed_ref):
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


def time_calls(fn, n_warm=1, n_iter=5, n_rep=3):
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
         ms_blocks={k: v[1] for k, v in ms.items()}, blocks="3 x 5 after 1 warm-up")
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
        self.chain_calls = {}   # "entry S=n" -> calls (one launch each on the card)
        self.chain_args = {}    # entry -> (S, inputs) of its largest call
        self.lba_combos = (-1,)  # (U, data, state, sid_cols, it_sid, it_t), largest U

    def __enter__(self):
        make, ext_lba = ba.make_ba_problem, local_mapping.extract_local_ba
        ext_pose = tracking.extract_pose_problem
        entries = {"indexed": interp_chain.gp_interp_packs_indexed,
                   "pair": interp_chain.gp_interp_packs_pair}
        packs = ba._interp_packs

        def lba_packs(data, state, sid_cols, it_sid, it_t):
            if it_t.shape[0] >= self.lba_combos[0]:
                self.lba_combos = (it_t.shape[0], data, state, sid_cols, it_sid, it_t)
            return packs(data, state, sid_cols, it_sid, it_t)

        def sized(name):
            def call(*args):
                S = int(args[-1].shape[0])
                key = f"{name} S={S}"
                if S:
                    self.chain_calls[key] = self.chain_calls.get(key, 0) + 1
                if S >= self.chain_args.get(name, (-1,))[0]:
                    self.chain_args[name] = (S, args)
                return entries[name](*args)
            return call

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
                                       "L": int(state.X.shape[0]),
                                       "U": int(data.mg_it_t.shape[0])}}
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
                         mock.patch.object(tracking, "extract_pose_problem", pose),
                         mock.patch.object(ba, "_interp_packs", lba_packs),
                         *(mock.patch.object(interp_chain, f"gp_interp_packs_{name}", sized(name))
                           for name in entries)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def run_system(frames, rig, device, dtype, threaded=False, loop_closing=False):
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
                  enable_loop_closing=loop_closing, threaded=threaded, device=device,
                  dtype=dtype)
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


def system_sequential(frames, rig, Ts, device):
    """9a: float32, sequential, the first SYSTEM_FRAMES frames; the counts
    are set to 0 just before the run. Returns (chain launches, the phase's
    record, the probe)."""
    frames, Ts = frames[:SYSTEM_FRAMES], Ts[:SYSTEM_FRAMES]
    path_m = float(np.linalg.norm(np.diff(Ts[:, :3, 3], axis=0), axis=1).sum())
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
        "chain_calls_by_size": probe.chain_calls,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "seconds": seconds,
        "spans_median_ms": {k: v["median_ms"] for k, v in GLOBAL_TIMER.stats().items()},
    }
    emit("system_sequential", **out)
    if states.count("OK") != len(states):
        raise AssertionError(f"9a: not every frame OK: {states}")
    if not ate <= SYSTEM_ATE_PCT / 100 * path_m:
        raise AssertionError(f"9a: ATE {ate:.4f} m > {SYSTEM_ATE_PCT} % of {path_m:.3f} m")
    if n_kf < SYSTEM_MIN_KF:
        raise AssertionError(f"9a: {n_kf} keyframes < {SYSTEM_MIN_KF}")
    if launches < n_tracked + probe.lin:
        raise AssertionError(f"9a: {launches} chain launches < {n_tracked} tracked frames "
                             f"+ {probe.lin} local-BA linearizations")
    if launches != sum(probe.chain_calls.values()):
        raise AssertionError(f"9a: {launches} chain launches, {probe.chain_calls} entry calls")
    return launches, out, probe


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
    """9c: the threaded schedule with loop closing on (the reference's
    default), float32."""
    t0 = time.perf_counter()
    n = SYSTEM_THREADED_FRAMES
    sys_t, rec_t = run_system(frames[:n], rig, device, torch.float32, threaded=True,
                              loop_closing=True)
    deadline = time.time() + 300
    while sys_t.local_mapper.queue and time.time() < deadline:
        time.sleep(0.05)
    sys_t.shutdown()
    sync()
    states_t = [r["state"] for r in rec_t]
    path_t = float(np.linalg.norm(np.diff(Ts[:n, :3, 3], axis=0), axis=1).sum())
    ate_t = trajectory_ate(sys_t, frames[:n], Ts[:n])
    lc = sys_t.loop_closer
    emit("system_threaded", frames=len(rec_t), states_ok=states_t.count("OK"),
         last5=states_t[-5:], keyframes=sys_t.atlas.active.n_keyframes(),
         n_ba_aborted=sys_t.local_mapper.n_ba_aborted, loop_closing=True,
         database_keyframes=len(lc.kfdb.kfs), loops_closed=lc.loops_closed,
         n_gba_applied=lc.n_gba_applied,
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
    frames, rig, Ts, _ = system_sequence()
    launches, out, probe = system_sequential(frames, rig, Ts, device)
    system_f64(frames, rig, device)
    system_threaded(frames, rig, Ts, device)
    emit("system_summary", seconds=time.perf_counter() - t_phase, card=smi,
         tracking_ms=out["tracking_ms"], local_ba_ms_per_kf=out["local_ba_ms_per_kf"],
         chain_kernel_launches=launches, chain_calls_by_size=out["chain_calls_by_size"],
         peak_mem_bytes=out["peak_mem_bytes"])
    return launches, probe


# ---------------------------------------------------------------------------
# phase 11: loop closing
# ---------------------------------------------------------------------------

# make_sequence drives the body at the twist [1.5, 0.1, 0, 0, 0, 0.12] per
# second: a circle of ~12.5 m radius, one lap in 52.4 s (~1,385 keypoints per
# camera per frame at 1 frame/s); the first 12 frames are under a quarter of a lap.
LOOP_SEQ = dict(n_frames=64, n_cams=6, n_lm=3000, fps=1.0, noise_px=0.3, seed=0)
LOOP_FRAMES = 12  # of the 64: a detection past the closer's guard, a full-map global BA
LOOP_ATE_PCT = 0.5
# a drifted revisit built by hand (the reference's own loop tests do so:
# with oracle keypoints a live revisit drifts too little to need a closure),
# closed with the settings of tests/test_loop_closing.py:124-162; 15,034
# landmarks, the essential graph's 120 keyframes in a bucket of 128
LOOP_MAP = dict(n_kf=120, n_lm=600, n_local=120, drift=0.04, seed=0)
LOOP_CLOSER = dict(fix_scale=True, min_matches=15, consistency_needed=1)
EG_5A = dict(n_kf=500, n_loop=40, seed=0)                                    # bench.py:204-210
EG_5E = dict(n_kf=2000, laps=4, step_m=5.0, n_loop=60, drift=0.002, seed=4)  # bench.py:227-260
EG_5A_TIMED = 3
# float64 card vs CPU after an LM run that ends at its noise floor (11b's
# global BA, 5a's essential graph): see loop_map
LM_FLOOR_TOL = 1e-5
EG_ATE_PCT = 0.5  # the project's headline: ATE < 0.5 % over 10 km
# what the JAX reference gave on a CPU for 11a (3 cameras, 1,500 landmarks,
# 741 s) and for 11b (JAX defaults, 63 s), printed beside the port's
REFERENCE_11A = {"cams": 3, "n_lm": 1500, "frames_ok": 64, "keyframes": 64,
                 "candidates": 0, "loops_closed": 0, "map_points_at_frame_50": 1721,
                 "map_points_at_frame_51": 1499, "map_points_final": 1500}
REFERENCE_11B = {"loop_kf": 0, "last_kf_err_before_m": 3.949, "last_kf_err_after_m": 0.00037,
                 "mean_kf_err_after_m": 0.129, "n_gba_applied": 1}


class Timed:
    """Wall ms, chain-kernel launches and the last result of each call of
    the named attributes ({name: (owner, attribute)}), patched in for a
    `with` block, the card synchronized around each call unless the timed
    work runs on the CPU."""

    def __init__(self, targets: dict, on_card: bool = True):
        self.targets = targets
        self.ms = {name: [] for name in targets}
        self.launches = dict.fromkeys(targets, 0)
        self.last = {}
        self.sync = sync if on_card else (lambda: None)

    def __enter__(self):
        self._patches = []
        for name, (owner, attr) in self.targets.items():
            def timed(*args, _real=getattr(owner, attr), _name=name, **kw):
                self.sync()
                t0, n0 = time.perf_counter(), interp_chain.LAUNCHES
                try:
                    self.last[_name] = _real(*args, **kw)
                    return self.last[_name]
                finally:
                    self.sync()
                    self.ms[_name].append((time.perf_counter() - t0) * 1e3)
                    self.launches[_name] += interp_chain.LAUNCHES - n0
            p = mock.patch.object(owner, attr, timed)
            p.start()
            self._patches.append(p)
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.stop()

    def total(self, name) -> float:
        return float(sum(self.ms[name]))


def loop_live(device):
    """11a: the System with loop closing on, float32, sequential (the closer
    detects on every keyframe); then the closer's own full-map global BA on
    the final map.
    Returns (chain launches of both runs, the global BA's chain inputs
    (U, data, state, sid_cols, it_sid, it_t), the record)."""
    t_phase = time.perf_counter()
    frames, rig, Ts, _ = make_sequence(**LOOP_SEQ)
    frames, Ts = frames[:LOOP_FRAMES], Ts[:LOOP_FRAMES]
    kp = float(np.mean([len(k) for f in frames for k in f.keypoints]))
    path_m = float(np.linalg.norm(np.diff(Ts[:, :3, 3], axis=0), axis=1).sum())
    closer = {"detect_common_regions": (LoopClosing, "detect_common_regions"),
              "try_pair": (LoopClosing, "_try_pair")}
    GLOBAL_TIMER.samples.clear()
    torch.cuda.reset_peak_memory_stats()
    sync()
    interp_chain.LAUNCHES = 0
    t0 = time.perf_counter()
    with SystemProbe() as probe, Timed(closer) as tc:
        sys_, rec = run_system(frames, rig, device, torch.float32, loop_closing=True)
    sync()
    run_s = time.perf_counter() - t0
    launches = interp_chain.LAUNCHES
    lc, m = sys_.loop_closer, sys_.atlas.active
    states = [r["state"] for r in rec]
    n_kf = m.n_keyframes()
    ate = trajectory_ate(sys_, frames, Ts)
    detect_ms = tc.ms["detect_common_regions"]
    out = {"sequence": {**LOOP_SEQ, "frames_run": LOOP_FRAMES,
                        "mean_keypoints_per_camera_per_frame": kp, "path_m": path_m},
           "dtype": "float32", "frames": len(rec), "states_ok": states.count("OK"),
           "keyframes": n_kf, "database_keyframes": len(lc.kfdb.kfs),
           "closer_detections": len(detect_ms), "candidates_tried": len(tc.ms["try_pair"]),
           "loops_closed": lc.loops_closed, "map_points": m.n_map_points(),
           "map_points_at_frames_50_51": [rec[50]["n_mp"], rec[51]["n_mp"]]
           if len(rec) > 51 else None,
           "ate_m": ate, "ate_pct_of_path": 100 * ate / path_m, "ate_bound_pct": LOOP_ATE_PCT,
           "detect_common_regions_ms": {"median": pct(detect_ms, 50), "p90": pct(detect_ms, 90),
                                        "max": max(detect_ms, default=None)},
           "tracking_ms_median": pct([r["ms"] - r["mapping_ms"] for r in rec[1:]], 50),
           "run_chain_launches": launches, "run_chain_calls_by_size": probe.chain_calls,
           "run_seconds": run_s, "reference_cpu": REFERENCE_11A}
    if states.count("OK") != len(states):
        raise AssertionError(f"11a: not every frame OK: {states}")
    if sorted(lc.kfdb.kfs) != sorted(m.keyframes) or lc.queue:
        raise AssertionError(f"11a: the database holds {len(lc.kfdb.kfs)} of {n_kf} keyframes")
    if len(detect_ms) != n_kf - 11:  # every keyframe past the 12-keyframe guard
        raise AssertionError(f"11a: {len(detect_ms)} detections for {n_kf} keyframes")
    if not ate <= LOOP_ATE_PCT / 100 * path_m:
        raise AssertionError(f"11a: ATE {ate:.4f} m > {LOOP_ATE_PCT} % of {path_m:.3f} m")

    # the full-map global BA a closure runs, on the final map
    gba = {"extract": (extraction, "extract_global_ba"), "solve": (ba, "global_ba"),
           "write_back": (extraction, "apply_global_ba")}
    applied0 = lc.n_gba_applied
    torch.cuda.reset_peak_memory_stats()
    sync()
    interp_chain.LAUNCHES = 0
    with SystemProbe() as gprobe, Timed(gba) as tg:
        lc._run_global_ba()
    sync()
    g_launches = interp_chain.LAUNCHES
    data, state, h = tg.last["extract"]
    _, stats = tg.last["solve"]
    chi2 = float(stats.chi2)
    ate_ba = trajectory_ate(sys_, frames, Ts)
    out["global_ba"] = {
        "applied": lc.n_gba_applied - applied0, "chi2_initial": float(stats.initial_chi2),
        "chi2": chi2, "iterations": stats.iterations, "linearizations": gprobe.lin,
        "chain_kernel_launches": g_launches, "chain_calls_by_size": gprobe.chain_calls,
        "ms": {k: tg.total(k) for k in gba},
        "sizes": {"real": {"K": len(h["kfs"]), "Em": len(h["mg_refs"]), "Es": len(h["st_refs"]),
                           "L": len(h["lms"])},
                  "padded": {"K": data.n_poses, "Cx": data.n_ext,
                             "P": 12 * (data.n_poses + data.n_ext),
                             "Em": int(data.mg_obs.shape[0]), "Es": int(data.st_obs.shape[0]),
                             "Eg": int(data.sg_obs.shape[0]), "L": int(state.X.shape[0]),
                             "U": int(data.mg_it_t.shape[0])}},
        "ate_m": ate_ba, "ate_pct_of_path": 100 * ate_ba / path_m,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    out["seconds"] = time.perf_counter() - t_phase
    emit("loop_live", **out)
    if lc.n_gba_applied != applied0 + 1 or not np.isfinite(chi2):
        raise AssertionError(f"11a: global BA applied {lc.n_gba_applied - applied0}x, chi2 {chi2}")
    if g_launches < gprobe.lin or g_launches != sum(gprobe.chain_calls.values()):
        raise AssertionError(f"11a: {g_launches} chain launches for {gprobe.lin} global-BA "
                             f"linearizations, {gprobe.chain_calls} entry calls")
    if not ate_ba <= LOOP_ATE_PCT / 100 * path_m:
        raise AssertionError(f"11a: ATE after the global BA {ate_ba:.4f} m > {LOOP_ATE_PCT} % "
                             f"of {path_m:.3f} m")
    return launches + g_launches, gprobe.lba_combos, out


def loop_map_case():
    """build_loop_map(**LOOP_MAP) with the ids starting at ID_START, so every
    case holds the same ids."""
    map_store._ids = itertools.count(ID_START)
    return build_loop_map(**LOOP_MAP)


def ulp_perturbed(tensors, seed=0):
    """Each float tensor times (1 +- PAD_PERTURB_ULPS eps of its dtype),
    random signs from `seed`; other tensors as they are."""
    gen = torch.Generator(device=tensors[0].device).manual_seed(seed)

    def perturb(a):
        if not a.is_floating_point():
            return a
        sign = torch.randint(0, 2, a.shape, generator=gen, device=a.device).to(a.dtype) * 2 - 1
        return a * (1 + PAD_PERTURB_ULPS * torch.finfo(a.dtype).eps * sign)

    out = [perturb(a) for a in tensors]
    return type(tensors)(*out) if hasattr(tensors, "_fields") else tuple(out)


def close_loop_map(case, device, dtype, detached=False) -> dict:
    """A loop_map_case() closed once by a LoopClosing on `device` in `dtype`:
    the database holds every keyframe but the last, one detection, one
    correction (the global BA joined when detached). Returns what the checks
    read: poses after the essential graph and at the end, the fused count,
    the map-point ids, the stages' ms."""
    m, rig, kfs, gt = case
    on_card = torch.device(device).type == "cuda"
    lc = LoopClosing(rig, m, KeyFrameDatabase(), **LOOP_CLOSER, detached_gba=detached,
                     device=device, dtype=dtype)
    for k in kfs[:-1]:
        lc.kfdb.add(k)
    eg_poses = []
    real_eg = lc._essential_graph

    def eg(*args):
        real_eg(*args)
        eg_poses.append(np.stack([k.Twb for k in kfs]))

    lc._essential_graph = eg
    stages = {name: (lc, attr) for name, attr in (
        ("detect_common_regions", "detect_common_regions"), ("solve_sim3", "_solve_sim3"),
        ("correct_loop", "correct_loop"), ("essential_graph", "_essential_graph"),
        ("search_and_fuse", "_search_and_fuse"), ("global_ba", "_run_global_ba"))}
    err_before = float(np.linalg.norm(kfs[-1].Twb[:3, 3] - gt[-1][:3, 3]))
    with Timed(stages, on_card) as tm:
        hit = lc.detect_common_regions(kfs[-1])
        if hit is None:
            raise AssertionError(f"11b ({dtype}, {device}): loop not detected")
        lc.correct_loop(kfs[-1], *hit)
        lc.join_gba(timeout=600)
    S12, n_inl, _ = tm.last["solve_sim3"]
    parts = {k: tm.total(k) for k in ("essential_graph", "search_and_fuse", "global_ba")}
    return {
        "landmarks": len(m.map_points), "loop_kf_index": [k.id for k in kfs].index(hit[0].id),
        "optimize_sim3": {"inliers": n_inl, "s": float(S12.s), "R": np.asarray(S12.R).tolist(),
                          "t": np.asarray(S12.t).tolist()},
        "last_kf_err_before_m": err_before,
        "last_kf_err_after_m": float(np.linalg.norm(kfs[-1].Twb[:3, 3] - gt[-1][:3, 3])),
        "mean_kf_err_after_m": float(np.mean([np.linalg.norm(k.Twb[:3, 3] - g[:3, 3])
                                              for k, g in zip(kfs, gt)])),
        "n_gba_applied": lc.n_gba_applied, "fused": tm.last["search_and_fuse"],
        "ms": {"detect_common_regions": tm.total("detect_common_regions"),
               "propagation": tm.total("correct_loop") - sum(parts.values()), **parts},
        "eg_poses": eg_poses[0], "poses": np.stack([k.Twb for k in kfs]),
        "map_point_ids": sorted(m.map_points)}


def pose_gap(A, B) -> dict:
    """Largest translation (m) and rotation (rad) gap between two stacks of
    poses."""
    return {"t_m": float(np.abs(A[:, :3, 3] - B[:, :3, 3]).max()),
            "r_rad": max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(A, B))}


def within(gap: dict, tol: float) -> bool:
    return gap["t_m"] <= tol and gap["r_rad"] <= tol


def loop_map(device) -> None:
    """11b: the drifted loop detected and corrected in float32; the same
    closure in float64 on the card and on the CPU (the CPU one on a thread
    of its own while the card runs the rest: it is ~70 s of CPU BLAS); the
    detached global BA.

    After the essential graph the float64 poses agree to 1e-8. After the
    global BA they agree only as far as its LM control law lets them: on
    this map its last iterations try steps whose chi2 change is at the
    rounding of the state, so whether a trial is taken depends on the order
    of summation, and the runs end apart by such a step (two CPU runs with
    different thread counts do too; 11c's 5a witness shows the same law at
    work). They are held to LM_FLOOR_TOL there, and whether they are within
    1e-8 is reported."""
    t_phase = time.perf_counter()
    r32 = close_loop_map(loop_map_case(), device, torch.float32)
    public = {k: v for k, v in r32.items()
              if k not in ("eg_poses", "poses", "map_point_ids")}
    emit("loop_map", loop_map=LOOP_MAP, closer=LOOP_CLOSER, dtype="float32", **public,
         reference_cpu=REFERENCE_11B)
    if r32["loop_kf_index"] != 0:
        raise AssertionError(f"11b: loop keyframe {r32['loop_kf_index']}, not 0")
    if not r32["last_kf_err_after_m"] < 0.5 * r32["last_kf_err_before_m"]:
        raise AssertionError(f"11b: last keyframe error {r32['last_kf_err_before_m']:.4f} -> "
                             f"{r32['last_kf_err_after_m']:.4f} m")
    if r32["n_gba_applied"] != 1:
        raise AssertionError(f"11b: {r32['n_gba_applied']} global BAs applied")

    cases = {name: loop_map_case() for name in ("card", "cpu", "detached")}
    cpu_out = {}

    def on_cpu():
        try:
            cpu_out["run"] = close_loop_map(cases["cpu"], "cpu", torch.float64)
        except Exception as e:  # raised below, on the main thread
            cpu_out["error"] = e

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        worker = threading.Thread(target=on_cpu)
        worker.start()
        card = close_loop_map(cases["card"], device, torch.float64)
        detached = close_loop_map(cases["detached"], device, torch.float64, detached=True)
        worker.join()
    finally:
        torch.use_deterministic_algorithms(False)
    if "error" in cpu_out:
        raise cpu_out["error"]
    cpu = cpu_out["run"]
    gaps = {"essential_graph": pose_gap(card["eg_poses"], cpu["eg_poses"]),
            "final": pose_gap(card["poses"], cpu["poses"])}
    final_tol = LM_FLOOR_TOL
    same = card["fused"] == cpu["fused"] and card["map_point_ids"] == cpu["map_point_ids"]
    dgap = pose_gap(detached["poses"], card["poses"])
    emit("loop_map_f64", card_vs_cpu=gaps,
         tolerance={"essential_graph": 1e-8, "final": final_tol},
         final_within_1e_8=within(gaps["final"], 1e-8),
         fused=[card["fused"], cpu["fused"]],
         same_map_point_ids=card["map_point_ids"] == cpu["map_point_ids"],
         loop_kf_index=[card["loop_kf_index"], cpu["loop_kf_index"]],
         ms={"card": card["ms"], "cpu_concurrent": cpu["ms"]},
         detached={"n_gba_applied": detached["n_gba_applied"], "vs_synchronous": dgap,
                   "bitwise_equal": bool(np.array_equal(detached["poses"], card["poses"]))},
         seconds=time.perf_counter() - t_phase)
    if not (within(gaps["essential_graph"], 1e-8) and within(gaps["final"], final_tol)
            and same):
        raise AssertionError(f"11b f64: card vs cpu {gaps} (final bound {final_tol:.3e}), "
                             f"fused {card['fused']} / {cpu['fused']}, same ids {same}")
    if detached["n_gba_applied"] != 1 or not within(dgap, 1e-8):
        raise AssertionError(f"11b detached: applied {detached['n_gba_applied']}, vs "
                             f"synchronous {dgap}")


def lm_trace(problem, state, n_iter=20, lambda_init=1e-16):
    """chi2 after each LM iteration: one `lm_optimize` run split at every
    iteration by `lm_segment` (the same op sequence)."""
    carry = tlm.lm_init(problem, state)
    chis = [float(carry.chi)]
    while carry.it < n_iter and not carry.term:
        carry = tlm.lm_segment(problem, carry, carry.it + 1, lambda_init=lambda_init)
        chis.append(float(carry.chi))
    return carry.state, chis


def eg_ate(field, Ts) -> float:
    """Aligned ATE (rigid Horn alignment, RMSE) of the camera centres
    -R^T t / s of the S_cw vertices against the ground truth."""
    s, R, t = (a.double().cpu().numpy() for a in field)
    est = np.tile(np.eye(4), (len(s), 1, 1))
    est[:, :3, 3] = -np.einsum("kji,kj->ki", R, t) / s[:, None]
    n = np.arange(len(s), dtype=np.float64)
    return ate_rmse(n, est, n, Ts)[0]


def state_gap(a, b) -> float:
    """Largest absolute difference between two Sim3Fields."""
    return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a, b))


def essential_graphs(device) -> None:
    """11c: config 5a dense (float64 card vs CPU per iteration, float32
    timing) and config 5e (the 10 km graph) by PCG in float32.

    5a's chi2 agrees per iteration to rtol 1e-9. Its vertices end apart by
    the steps its last LM iterations take or refuse at the noise floor, as
    in 11b's global BA: they are held to LM_FLOOR_TOL, and whether they are
    within 1e-8 is reported beside each device's witness (the distance its
    run moves when its input moves by PAD_PERTURB_ULPS)."""
    t_phase = time.perf_counter()
    np_data, np_state, _ = make_essential_graph_numpy(**EG_5A)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        res, witness = {}, {}
        for dev in (device, "cpu"):
            data = convert.essential_graph_from(np_data, device=dev, dtype=torch.float64)
            state = convert.sim3_field_from(np_state, device=dev, dtype=torch.float64)
            res[dev] = lm_trace(sim3_opt.make_essential_graph_problem(data), state)
            moved, _ = lm_trace(sim3_opt.make_essential_graph_problem(data), ulp_perturbed(state))
            witness["card" if dev != "cpu" else "cpu"] = state_gap(moved, res[dev][0])
    finally:
        torch.use_deterministic_algorithms(False)
    (out_c, chi_c), (out_h, chi_h) = res[device], res["cpu"]
    chi_err = max(abs(a - b) / max(abs(b), 1e-300) for a, b in zip(chi_c, chi_h))
    pose_err = state_gap(out_c, out_h)
    pose_tol = LM_FLOOR_TOL
    data = convert.essential_graph_from(np_data, device=device, dtype=torch.float32)
    state = convert.sim3_field_from(np_state, device=device, dtype=torch.float32)
    ms = []
    for _ in range(EG_5A_TIMED):
        sync()
        t0 = time.perf_counter()
        _, st32 = sim3_opt.optimize_essential_graph(data, state)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec5a = {"config": EG_5A, "N": EG_5A["n_kf"], "E": int(np_data["pairs"].shape[0]),
             "H_side": 7 * EG_5A["n_kf"], "iterations_f64": len(chi_c) - 1,
             "chi2_f64": chi_c, "chi2_card_vs_cpu_max_rel": chi_err,
             "state_card_vs_cpu_max_abs": pose_err, "state_within_1e_8": pose_err <= 1e-8,
             "state_witness_gap": witness,
             "tolerance": {"chi2_rtol": 1e-9, "state": pose_tol},
             "ms_f32": ms, "ms_f32_median": statistics.median(ms),
             "chi2_f32": [float(st32.initial_chi2), float(st32.chi2)]}
    emit("essential_graph_5a", **rec5a)
    if len(chi_c) != len(chi_h) or not chi_err <= 1e-9 or not pose_err <= pose_tol:
        raise AssertionError(f"11c 5a: iterations {len(chi_c)}/{len(chi_h)}, chi2 {chi_err:.3e}, "
                             f"state {pose_err:.3e} (bound {pose_tol:.3e})")

    np_data, np_state, Ts = make_essential_graph_numpy(**EG_5E)
    data = convert.essential_graph_from(np_data, device=device, dtype=torch.float32)
    state = convert.sim3_field_from(np_state, device=device, dtype=torch.float32)
    path_m = float(np.linalg.norm(np.diff(Ts[:, :3, 3], axis=0), axis=1).sum())
    steps = []
    pcg = sim3_opt._pcg

    def counting(*args):
        x, it, rel = pcg(*args)
        steps.append((it, rel))
        return x, it, rel

    lin = []
    make = sim3_opt.make_essential_graph_problem_pcg

    def counting_make(*args, **kw):
        problem = make(*args, **kw)

        def linearize(s):
            lin.append(len(steps))
            return problem.linearize(s)

        return problem._replace(linearize=linearize)

    ate0 = eg_ate(state, Ts)
    with mock.patch.object(sim3_opt, "_pcg", counting), \
            mock.patch.object(sim3_opt, "make_essential_graph_problem_pcg", counting_make):
        sync()
        t0 = time.perf_counter()
        out, st = sim3_opt.optimize_essential_graph(data, state, use_pcg=True)
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
    ate1 = eg_ate(out, Ts)
    bounds = lin + [len(steps)]
    per_iter = [[it for it, _ in steps[a:b]] for a, b in zip(bounds[:-1], bounds[1:])]
    rec5e = {"config": EG_5E, "N": EG_5E["n_kf"], "E": int(np_data["pairs"].shape[0]),
             "dtype": "float32", "path_m": path_m, "ate_before_m": ate0, "ate_after_m": ate1,
             "ate_before_pct": 100 * ate0 / path_m, "ate_after_pct": 100 * ate1 / path_m,
             "ate_bound_pct": EG_ATE_PCT, "chi2": [float(st.initial_chi2), float(st.chi2)],
             "lm_iterations": st.iterations, "solve_ms": solve_ms,
             "cg_steps_per_lm_iteration": per_iter, "final_relative_residual": steps[-1][1],
             "seconds": time.perf_counter() - t_phase}
    emit("essential_graph_5e", **rec5e)
    if not ate1 <= EG_ATE_PCT / 100 * path_m:
        raise AssertionError(f"11c 5e: ATE {ate1:.3f} m > {EG_ATE_PCT} % of {path_m:.0f} m")


def phase_loop(device, smi):
    t_phase = time.perf_counter()
    launches, gba_combos, live = loop_live(device)
    loop_map(device)
    essential_graphs(device)
    emit("loop_summary", seconds=time.perf_counter() - t_phase, card=smi,
         chain_kernel_launches=launches, global_ba=live["global_ba"]["sizes"])
    return launches, gba_combos


# ---------------------------------------------------------------------------
# phase 12: the image frontend and the entry points
# ---------------------------------------------------------------------------

ORB_FEATURES = 1200   # the reference's default (frontend/features.py:33)
ORB_RIG_ASYNC = 5     # the AMV rig width: 5 async + stereo, 7 images per tick
ORB_ANGLE_TOL_NATIVE = 1e-12  # numpy's arctan2 vs libm's atan2, last place
ORB_ANGLE_TOL = 1e-5          # card vs CPU float32 atan2 (tests/test_torch_orb_device.py)
ORB_EDGE_TOL = 1e-4           # px from a .5 rounding edge of a rotated BRIEF sample
ORB_TIMED = 5
RENDER_AGREE = 0.99
# tests/test_e2e_scenarios.py:63-88 (the AMV rig width), cut to 16 of its 40
# frames; :128-155 (async camera 0 KB8), cut to 10 of its 30
E2E_AMV = dict(n_frames=16, fps=5.0, seed=1, n_async=5, n_features=400)
E2E_AMV_ATE_PCT = 0.5
E2E_FISHEYE = dict(n_frames=10, fps=5.0, seed=2, n_features=400, fisheye=True)
E2E_FISHEYE_ATE_PCT = 1.0
# tests/test_e2e_scenarios.py:90-125 unchanged: the blackout run, which is
# tests/test_loop_e2e.py:41-48's lap and revisit (the same seed, world,
# circle, fps and features: its closure fires at frame 56-59, before the
# blackout) run 90 frames with frames 66-71 black; host ORB, host renderer
E2E_LOOP = dict(n_frames=90, fps=5.0, seed=0, circle=True, circle_period=12.0,
                circle_radius=4.0, n_features=500, blackout=(66, 6))
E2E_LOOP_ATE_PCT = 1.0
E2E_LOOP_OK_FROM = 30         # OK over frames 30-65 (the reference's states[30:66])
E2E_LOST_WITHIN = (67, 80)    # RECENTLY_LOST somewhere in states[67:80]
E2E_RECOVERY_FROM = 72        # the first OK frame from 72 on is the recovery frame
# the opt-in scenarios (`--scenarios`) at the reference's full sizes:
# tests/test_e2e_scenarios.py:38-60 (the figure-eight) and :157-200 (the
# threaded pin, sequential then threaded)
E2E_EIGHT = dict(n_frames=160, fps=5.0, seed=0, eight=True, circle_period=14.0,
                 circle_radius=4.5, n_features=500)
E2E_EIGHT_ATE_PCT = 0.5
E2E_EIGHT_MIN_LOOPS = 2       # closures, and loop-edge records in the map
E2E_THREADED = dict(n_frames=40, fps=5.0, seed=3, n_features=400)
E2E_THREADED_ATE_PCT = 2.0
E2E_THREADED_RATIO = 0.5      # threaded median tracking ms < 0.5x the sequential one
E2E_THREADED_SKIP = 10        # the first frames, dropped from the latency statistic
E2E_THREADED_MIN_OK = 0.4     # share of OK frames after the first, threaded
CLI_DIR = _build.BUILD_DIR.parent / "amv_cli"


def orb_frame():
    """One tick of 12b's run (frame 0 of the seed-1 corridor, AMV rig):
    the 7 views' poses, the world and the host renders."""
    planes = e2e.make_world(E2E_AMV["seed"])
    rig = e2e.make_rig(ORB_RIG_ASYNC)
    cam_t = rig.cam_times(0.0)
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    views = ([e2e.gt_pose(cam_t[c]) @ rig.Tbc[c] for c in range(rig.n_cams)]
             + [e2e.gt_pose(0.0) @ rig.Tbc[-1] @ Tright])
    with np.errstate(invalid="ignore"):
        imgs = np.stack([e2e.render(T, planes) for T in views])
    return planes, views, imgs


def host_extract(extractors, imgs):
    """The host backend's rig extraction: one thread per image (build_frame)."""
    with ThreadPoolExecutor(max_workers=len(imgs)) as pool:
        return [f.result() for f in [pool.submit(e.extract, im)
                                     for e, im in zip(extractors, imgs)]]


def matched_share(host, dev) -> float:
    """Share of host keypoints with a device keypoint of the same octave
    within 1 px (level-0 pixels)."""
    found = total = 0
    for (xy_h, oc_h, _, _), (xy_d, oc_d, _, _) in zip(host, dev):
        d = np.linalg.norm(xy_h[:, None, :] - xy_d[None, :, :], axis=-1)
        same = oc_h[:, None] == oc_d[None, :]
        found += int(((d <= 1.0) & same).any(axis=1).sum())
        total += len(xy_h)
    return found / max(total, 1)


def kernel_launches(fn) -> int:
    """CUDA kernels launched by one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def frontend_orb(device) -> dict:
    """12a: one rendered 640x480 tick of the AMV rig (7 images), 1,200
    features: the native ORB against its numpy oracle, the device ORB on the
    card against the same function on the CPU, the device renderer against
    the host renderer; the host thread pool's and the batched device call's
    ms per rig frame."""
    t_phase = time.perf_counter()
    planes, views, imgs = orb_frame()
    renderer = e2e.DeviceRenderer(planes, device=device)
    agree = [float((d == h).mean()) for d, h in zip(renderer(views), imgs)]

    pipe = orb.OrbPipeline(ORB_FEATURES)
    native_gap = 0.0
    for img in imgs:
        got, want = pipe.extract(img), pipe.extract(img, force_python=True)
        for name, g, w in zip(("xy", "octave", "desc"), got[:3], want[:3]):
            if not np.array_equal(g, w):
                raise AssertionError(f"12a: native ORB {name} differs from the numpy oracle")
        native_gap = max(native_gap, float(np.abs(got[3] - want[3]).max(initial=0.0)))
    if not native_gap <= ORB_ANGLE_TOL_NATIVE:
        raise AssertionError(f"12a: native ORB angles {native_gap} from the numpy oracle")

    H, W = imgs.shape[1:]
    card = orb_device.build_orb_device(H, W, ORB_FEATURES, device=device)
    cpu = orb_device.build_orb_device(H, W, ORB_FEATURES, device="cpu")
    a = {k: v.cpu().numpy() for k, v in card(torch.as_tensor(imgs, device=device)).items()}
    b = {k: v.numpy() for k, v in cpu(torch.as_tensor(imgs)).items()}
    for k in ("xy", "octave", "valid", "score"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"12a: device ORB {k}: card and CPU differ in "
                                 f"{int((a[k] != b[k]).sum())} entries")
    ang_gap = float(np.abs(a["angle"] - b["angle"]).max())
    diff = np.unpackbits(a["desc"], axis=-1) != np.unpackbits(b["desc"], axis=-1)
    edge = orb_device.brief_edge_bits(b["angle"], ORB_EDGE_TOL)
    if not ang_gap <= ORB_ANGLE_TOL or (diff & ~edge).any():
        raise AssertionError(f"12a: device ORB angles {ang_gap} apart, "
                             f"{int((diff & ~edge).sum())} descriptor bits off the edges")

    host_ext = features.make_extractors(len(imgs), ORB_FEATURES, "host")
    dev_ext = features.make_extractors(len(imgs), ORB_FEATURES, "device", device=device)[-1]
    host = host_extract(host_ext, imgs)
    dev = list(zip(*dev_ext.extract_batch(imgs)))
    host_ms, dev_ms = [], []
    for _ in range(ORB_TIMED):
        t0 = time.perf_counter()
        host_extract(host_ext, imgs)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        sync()
        t0 = time.perf_counter()
        dev_ext.extract_batch(imgs)
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"images": len(imgs), "shape": [H, W], "n_features": ORB_FEATURES,
           "native_equals_numpy": True, "native_angle_gap_rad": native_gap,
           "device_card_vs_cpu": {"slots": int(a["valid"].size), "valid": int(a["valid"].sum()),
                                  "angle_gap_rad": ang_gap, "desc_bits_differing": int(diff.sum()),
                                  "edge_bits": int(edge.sum())},
           "host_keypoints_found_by_device": matched_share(host, dev),
           "host_ms_per_rig_frame": statistics.median(host_ms),
           "device_ms_per_rig_frame": statistics.median(dev_ms),
           "device_launches_per_rig_frame": kernel_launches(lambda: dev_ext.extract_batch(imgs)),
           "render_agreement": {"min": min(agree), "per_view": agree},
           "seconds": time.perf_counter() - t_phase}
    emit("frontend_orb", **out)
    if min(agree) < RENDER_AGREE:
        raise AssertionError(f"12a: device renderer agrees on {min(agree):.5f} of the pixels")
    return out


def e2e_run(device, kw, timed=None, **extra) -> dict:
    """One `e2e_rendered.run` on `device`, the chain's counts set to 0 just
    before it; returns its results, per-frame timings and counts, the
    frames at which the loop closer's count rose, and the System and the
    run's `collect` under "_system" and "_collect"."""
    GLOBAL_TIMER.samples.clear()
    torch.cuda.reset_peak_memory_stats()
    sync()
    loops = []

    class Counted(e2e.System):
        def track_multicamera(self, frame):
            state = super().track_multicamera(frame)
            loops.append(self.loop_closer.loops_closed if self.loop_closer else 0)
            return state

    interp_chain.LAUNCHES = 0
    collect = {}
    t0 = time.perf_counter()
    with (timed or contextlib.nullcontext()), mock.patch.object(e2e, "System", Counted):
        ate, dist, n_loops = e2e.run(**kw, **extra, device=device, collect=collect)
    sync()
    t = collect["timing"]
    sys_ = collect["system"]
    m = sys_.atlas.active
    lba_ms = [1e3 * x for x in GLOBAL_TIMER.samples["lm.local_ba"]]
    closure_frames = [k for k, n in enumerate(loops)
                      for _ in range(n - (loops[k - 1] if k else 0))]
    return {"run": kw, **extra, "ate_m": ate, "path_m": float(dist),
            "ate_pct_of_path": 100 * ate / dist, "loops_closed": n_loops,
            "closure_frames": closure_frames,
            "loop_edge_records": sum(len(k.loop_edges) for k in m.keyframes.values()) // 2,
            "states": [s.name for s in collect["states"]],
            "keyframes": m.n_keyframes(), "map_points": m.n_map_points(),
            "render_ms_median": pct(t["render_ms"], 50),
            "extract_ms_median": pct(t["extract_ms_frames"], 50),
            "track_ms_median_incl_mapping": pct(t["track_ms"][1:], 50),
            "track_ms_p90_incl_mapping": pct(t["track_ms"][1:], 90),
            "local_ba_ms_per_kf": {"median": pct(lba_ms, 50), "n": len(lba_ms)},
            "chain_kernel_launches": interp_chain.LAUNCHES,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0, "_system": sys_, "_collect": collect}


def map_observations(m, cams) -> int:
    """Map-point observations by the cameras `cams` (the reference's count,
    tests/test_e2e_scenarios.py:84-88)."""
    return sum(1 for mp in m.map_points.values() for slots in mp.observations.values()
               for c, g in enumerate(slots) if c in cams and g >= 0)


def frontend_rendered(device) -> int:
    """12b: the AMV-width rendered run (device ORB, device renderer), then
    the fisheye run. Returns the chain's launches of both."""
    launches = 0
    for name, kw, bound in (("amv", E2E_AMV, E2E_AMV_ATE_PCT),
                            ("fisheye", E2E_FISHEYE, E2E_FISHEYE_ATE_PCT)):
        r = e2e_run(device, kw, backend="device", device_render=True)
        sys_ = r.pop("_system")
        r.pop("_collect")
        m, C = sys_.atlas.active, sys_.rig.n_cams
        cams = range(C - 1) if name == "amv" else (0,)
        r["observations_by_cameras"] = {"cameras": list(cams),
                                        "count": map_observations(m, set(cams))}
        r["ate_bound_pct"] = bound
        emit(f"frontend_rendered_{name}", **r)
        launches += r["chain_kernel_launches"]
        if any(s != "OK" for s in r["states"][1:]):
            raise AssertionError(f"12b {name}: not every frame after the first OK: {r['states']}")
        if not r["ate_m"] < bound / 100 * r["path_m"]:
            raise AssertionError(f"12b {name}: ATE {r['ate_m']:.4f} m >= {bound} % of "
                                 f"{r['path_m']:.3f} m")
        if r["observations_by_cameras"]["count"] == 0:
            raise AssertionError(f"12b {name}: no observations of cameras {list(cams)} in the map")
        if name == "fisheye" and sys_.rig.cam_model[0] != 1:
            raise AssertionError("12b fisheye: camera 0 is not KB8")
        if r["chain_kernel_launches"] < len(r["states"]) - 1:
            raise AssertionError(f"12b {name}: {r['chain_kernel_launches']} chain launches for "
                                 f"{len(r['states']) - 1} tracked frames")
    return launches


def closer_timed() -> Timed:
    """The loop closer's stages, timed (LoopClosing's methods)."""
    return Timed({name: (LoopClosing, attr) for name, attr in (
        ("detect_common_regions", "detect_common_regions"), ("solve_sim3", "_solve_sim3"),
        ("correct_loop", "correct_loop"), ("essential_graph", "_essential_graph"),
        ("search_and_fuse", "_search_and_fuse"), ("global_ba", "_run_global_ba"))})


def closer_record(timed: Timed) -> dict:
    """ms of detection (per call and total), Sim3 solves, propagation (the
    correction less its named parts), essential graph, fuse and global BA."""
    parts = {k: timed.total(k) for k in ("essential_graph", "search_and_fuse", "global_ba")}
    return {"detection": {"calls": len(timed.ms["detect_common_regions"]),
                          "median": pct(timed.ms["detect_common_regions"], 50),
                          "total": timed.total("detect_common_regions")},
            "sim3": {"calls": len(timed.ms["solve_sim3"]), "total": timed.total("solve_sim3")},
            "corrections": len(timed.ms["correct_loop"]),
            "propagation": timed.total("correct_loop") - sum(parts.values()), **parts}


def blackout_checks(r: dict) -> dict:
    """tests/test_e2e_scenarios.py:106-125 on a blackout run: {check: ok},
    and the recovery frame and the post-recovery ATE into `r`."""
    states, n = r["states"], len(r["states"])
    lo, hi = E2E_LOST_WITHIN
    k_rec = next((i for i in range(E2E_RECOVERY_FROM, n) if states[i] == "OK"), None)
    r["recovery_frame"] = k_rec
    post = None
    if k_rec is not None:
        est_t, est_T = r["_collect"]["est"]
        gt_t, gt_T = r["_collect"]["gt"]
        t_rec = k_rec / r["run"]["fps"]
        post, _ = ate_rmse(est_t[est_t >= t_rec], est_T[est_t >= t_rec],
                           gt_t[gt_t >= t_rec], gt_T[gt_t >= t_rec])
    r["ate_post_recovery_m"] = post
    k0 = r["run"]["blackout"][0]
    return {"ok_before_blackout": all(x == "OK" for x in states[E2E_LOOP_OK_FROM:k0]),
            "recently_lost_in_blackout": "RECENTLY_LOST" in states[lo:hi],
            "ok_at_end": states[-1] == "OK",
            "ok_from_recovery": k_rec is not None and all(x == "OK" for x in states[k_rec:]),
            "post_recovery_ate": post is not None
            and post < E2E_LOOP_ATE_PCT / 100 * r["path_m"]}


def frontend_loop(device) -> int:
    """12c: the blackout run of tests/test_e2e_scenarios.py:90-125 on the
    card, a live image-driven loop closure before the blackout: at least one
    closure, ATE < 1 % of the path, and the reference's relocalization
    checks (OK over 30-65, RECENTLY_LOST within 67-79, OK from the recovery
    frame to the end, post-recovery ATE < 1 %). Returns the chain's
    launches."""
    timed = closer_timed()
    r = e2e_run(device, E2E_LOOP, timed=timed, backend="host")
    r.pop("_system")
    r["closer_ms"] = closer_record(timed)
    r["closer_chain_launches"] = timed.launches
    r["ate_bound_pct"] = E2E_LOOP_ATE_PCT
    checks = blackout_checks(r)
    r.pop("_collect")
    r["checks"] = checks
    emit("frontend_loop", **r)
    if r["loops_closed"] < 1:
        raise AssertionError("12c: no loop closure on the rendered revisit")
    if not r["ate_m"] < E2E_LOOP_ATE_PCT / 100 * r["path_m"]:
        raise AssertionError(f"12c: ATE {r['ate_m']:.4f} m >= {E2E_LOOP_ATE_PCT} % of "
                             f"{r['path_m']:.3f} m")
    if not all(checks.values()):
        raise AssertionError(f"12c: relocalization checks failed: {checks}, states "
                             f"{r['states']}")
    return r["chain_kernel_launches"]


# Checks of the opt-in scenarios that the JAX reference's own CPU run fails,
# with what the reference gives. On the card such a check must come out
# as on the port's CPU run (tests/test_torch_e2e_scenarios.py), and is
# reported by name as the reference's fault instead of passing.
KNOWN_REFERENCE_FAULTS = {
    # the reference's own run of tests/test_e2e_scenarios.py:38-60 fires one
    # closure (frame 71) and keeps one loop-edge record: on the second
    # revisit the first lap's keyframes are covisible with the current ones
    # and excluded from the database query (ROADMAP §3)
    "closures_at_least_2": "the reference fires 1 closure on the figure-eight",
    "loop_edge_records_at_least_2": "the reference keeps 1 loop-edge record on the "
                                    "figure-eight",
}


def settle(name: str, r: dict, checks: dict) -> None:
    """Record `checks` in `r`, the reference's known faults by name; raise
    on a failed check, or on a known fault that comes out otherwise than on
    the port's CPU run."""
    r["checks"] = {k: ("ok" if v else "FAILED") for k, v in checks.items()}
    bad = []
    for k, v in checks.items():
        if k in KNOWN_REFERENCE_FAULTS:
            r["checks"][k] = {"result": "ok" if v else "failed",
                              "known_reference_fault": KNOWN_REFERENCE_FAULTS[k]}
            if v:
                bad.append(f"{k} passed, where the reference and the port's CPU run fail it")
        elif not v:
            bad.append(k)
    emit(f"scenario_{name}", **r)
    if bad:
        raise AssertionError(f"scenario {name}: {bad}")


def scenario_record(r: dict, timed: Timed) -> dict:
    r.pop("_system")
    r["closer_ms"] = closer_record(timed)
    r["closer_chain_launches"] = timed.launches
    return r


def scenario_eight(device) -> int:
    """tests/test_e2e_scenarios.py:38-60 at full size (160 frames): at least
    2 closures, a finite ATE under 0.5 % of the path, at least 2 loop-edge
    records in the map. Returns the chain's launches."""
    timed = closer_timed()
    r = scenario_record(e2e_run(device, E2E_EIGHT, timed=timed, backend="host"), timed)
    r.pop("_collect")
    bound = E2E_EIGHT_ATE_PCT / 100 * r["path_m"]
    settle("eight", r, {
        "closures_at_least_2": r["loops_closed"] >= E2E_EIGHT_MIN_LOOPS,
        "ate_finite": bool(np.isfinite(r["ate_m"])),
        "ate_under_0.5_pct": bool(r["ate_m"] < bound),
        "loop_edge_records_at_least_2": r["loop_edge_records"] >= E2E_EIGHT_MIN_LOOPS})
    return r["chain_kernel_launches"]


def scenario_threaded(device) -> int:
    """tests/test_e2e_scenarios.py:157-200 (40 frames, seed 3), the
    sequential then the threaded schedule: every frame after the first OK
    (sequential); at least 40 % OK and OK in the last 5 (threaded); both
    ATEs under 2 %; the threaded median tracking ms (frames 10 on) under
    0.5x the sequential one. Returns the chain's launches."""
    runs, launches = {}, 0
    for threaded in (False, True):
        timed = closer_timed()
        r = scenario_record(e2e_run(device, E2E_THREADED, timed=timed, backend="host",
                                    threaded=threaded), timed)
        lat = r.pop("_collect")["timing"]["track_ms"][E2E_THREADED_SKIP:]
        r["track_ms_median_from_frame_10"] = pct(lat, 50)
        launches += r["chain_kernel_launches"]
        runs["threaded" if threaded else "sequential"] = r
    seq, thr = runs["sequential"], runs["threaded"]
    n = len(thr["states"]) - 1
    ratio = thr["track_ms_median_from_frame_10"] / seq["track_ms_median_from_frame_10"]
    settle("threaded", {"sequential": seq, "threaded": thr, "median_ratio": ratio,
                        "ratio_bound": E2E_THREADED_RATIO}, {
        "sequential_all_ok": all(x == "OK" for x in seq["states"][1:]),
        "threaded_ok_share": sum(x == "OK" for x in thr["states"][1:]) >= E2E_THREADED_MIN_OK * n,
        "threaded_ok_in_last_5": "OK" in thr["states"][-5:],
        "sequential_ate_under_2_pct": bool(seq["ate_m"] < E2E_THREADED_ATE_PCT / 100
                                           * seq["path_m"]),
        "threaded_ate_under_2_pct": bool(thr["ate_m"] < E2E_THREADED_ATE_PCT / 100
                                         * thr["path_m"]),
        "threaded_median_under_half": ratio < E2E_THREADED_RATIO})
    return launches


def phase_scenarios(device, smi) -> int:
    """The opt-in scenarios (`--scenarios`), each run to its end; then
    raises if any check failed. Returns the chain's launches."""
    t_phase = time.perf_counter()
    launches, failed = 0, []
    for scenario in (scenario_eight, scenario_threaded):
        try:
            launches += scenario(device)
        except AssertionError as exc:
            failed.append(str(exc))
    emit("scenarios_summary", seconds=time.perf_counter() - t_phase, card=smi,
         chain_kernel_launches=launches, failed=failed)
    if failed:
        raise AssertionError(f"opt-in scenarios: {failed}")
    return launches


def write_amv_dataset(root, n_frames=6, fps=10.0):
    """tests/test_amv_cli.py:24-70's dataset (3 cameras, 6 frames) in the
    AMV layout, written with the port's PNG writer; returns the YAML path."""
    planes = e2e.make_world(0)
    rig = e2e.make_rig()
    Tright = np.eye(4)
    Tright[:3, 3] = [0.2, 0.0, 0.0]
    ds = root / "seq"
    for d in ("cam0", "cam1", "cam2", "cam2_right"):
        (ds / d).mkdir(parents=True)
    times = [[] for _ in range(3)]
    with np.errstate(invalid="ignore"):
        for k in range(n_frames):
            cam_t = rig.cam_times(k / fps)
            for c in range(3):
                write_png_gray(str(ds / f"cam{c}" / f"{k:06d}.png"),
                               e2e.render(e2e.gt_pose(cam_t[c]) @ rig.Tbc[c], planes))
                times[c].append(cam_t[c])
            write_png_gray(str(ds / "cam2_right" / f"{k:06d}.png"),
                           e2e.render(e2e.gt_pose(k / fps) @ rig.Tbc[2] @ Tright, planes))
    for c in range(3):
        np.savetxt(ds / f"cam{c}" / "times.txt", times[c])
        K4 = rig.K[c]
        Km = [[K4[0], 0.0, K4[2]], [0.0, K4[1], K4[3]], [0.0, 0.0, 1.0]]
        (root / f"cam{c}.json").write_text(json.dumps(
            {"sensor_to_vehicle": rig.Tbc[c].tolist(), "intrinsics": Km}))
    yaml_path = root / "run.yaml"
    yaml_path.write_text("Camera.number: 3\n"
                         "Camera.calibfiles: [cam0.json, cam1.json, cam2.json]\n"
                         f"Camera.bf: {rig.bf}\n"
                         f"dataset: {ds}\n"
                         "Gaussian.Qc: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]\n"
                         "ORBextractor.nFeatures: 800\n"
                         "loopClosing: 1\n")
    return yaml_path


def frontend_cli(device) -> None:
    """12d: the AMV replay CLI in a subprocess on the card, on the dataset of
    tests/test_amv_cli.py; the TUM checks of :84-96."""
    t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    yaml_path = write_amv_dataset(CLI_DIR)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "amcslam_tpu_torch.examples.multicam_amv", str(yaml_path),
         "--no-realtime", "--device", str(device), "--out", str(CLI_DIR)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if "tracking time" in ln or "ticks" in ln]
    if proc.returncode != 0:
        raise AssertionError(f"12d: the CLI exited {proc.returncode}:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
    traj = np.loadtxt(CLI_DIR / "f_0.txt").reshape(-1, 8)
    kf_traj = np.loadtxt(CLI_DIR / "kf_0.txt").reshape(-1, 8)
    path = float(np.linalg.norm(np.diff(traj[:, 1:4], axis=0), axis=1).sum())
    checks = {"rows": len(traj) >= 4 and len(kf_traj) >= 1,
              "finite": bool(np.isfinite(traj).all() and np.isfinite(kf_traj).all()),
              "unit_quaternions": bool(np.allclose(np.linalg.norm(traj[:, 4:], axis=1), 1.0,
                                                   atol=1e-6)),
              "monotone_times": bool((np.diff(traj[:, 0]) > 0).all()),
              "path_0.05_to_2_m": 0.05 < path < 2.0}
    emit("frontend_cli", returncode=proc.returncode, stdout=lines, frames=len(traj),
         keyframes=len(kf_traj), path_m=path, checks=checks,
         seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise AssertionError(f"12d: TUM checks failed: {checks}")


def phase_frontend(device, smi) -> int:
    """Phase 12. Returns the chain's launches of 12b and 12c."""
    t_phase = time.perf_counter()
    orb_rec = frontend_orb(device)
    launches = frontend_rendered(device)
    launches += frontend_loop(device)
    frontend_cli(device)
    emit("frontend_summary", seconds=time.perf_counter() - t_phase, card=smi,
         chain_kernel_launches=launches,
         orb_ms_per_rig_frame={"host": orb_rec["host_ms_per_rig_frame"],
                               "device": orb_rec["device_ms_per_rig_frame"]})
    return launches


# ---------------------------------------------------------------------------
# phase 13: the per-edge fallback, the PCG global BA, VI BA and two-view
# ---------------------------------------------------------------------------

NO_TABLES = dict(mg_it=None, mg_it_sid=None, mg_it_t=None, sg_it=None, sg_it_sid=None,
                 sg_it_t=None, lm_blk=None, lm_blk_g=None, lm_blk_valid=None, lm_edge=None,
                 lm_edge_valid=None)
F32_FLOOR = 5e-5      # phase 3's float32 envelope: max(5e-5, 10x the float32 distance
F32_FACTOR = 10.0     # of the reference path from float64)
# CG to convergence: at the headline window 1e-16 stops ~280 steps in, its
# step 3.5e-7 from the dense one; 1e-20 takes ~300 steps and meets 1e-7
PCG_EXACT = dict(pcg_iters=400, pcg_tol=1e-20)
PCG_LAM = 1e-3
GBA_ITERS = 10
# config 5d (bench.py:265-294): 2,000 KF, 10k landmarks, float32, inexact CG
PCG_5D = dict(n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4, gpobs_per_lm=0,
              noise_px=0.5, seed=0)
PCG_5D_SOLVER = dict(pcg_iters=40, pcg_tol=1e-3)
PCG_5D_WARM = 3
PCG_5D_ITERS = 5
PCG_5D_F64_ITERS = 2
PCG_5D_F64_RTOL = 1e-4
VI_4 = dict(n_kf=20, n_lm=500, seed=0)   # config 4 (bench.py:196-202)
VI_ITERS = 10
# TwoViewReconstruction at ORB-SLAM's size: mMaxIterations = 200 hypotheses
TWO_VIEW = dict(n=1000, hypotheses=200, outlier_frac=0.1, noise=0.5)
TWO_VIEW_K = (420.0, 420.0, 480.0, 300.0)
TWO_VIEW_R_TOL = 0.05
TWO_VIEW_SEEDS = tuple(range(8))


def rel_gap(a, b) -> float:
    """max |a - b| over the scale max |b| (arrays on any device)."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def ba_outputs(data, state, lam):
    """(Hpp, bp, Wt, Hll, bl, dxp, dxl, chi2) of make_ba_problem."""
    p = ba.make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    lin = p.linearize(state)
    (dxp, dxl), _, _ = p.solve(lin, torch.tensor(lam, dtype=state.T.dtype, device=state.T.device))
    return (*lin, dxp, dxl, p.chi2(state)[None]), p


def solver_fallback(device) -> dict:
    """13a: make_ba_problem at the headline window with the interp-combo and
    landmark tables and without them (the per-edge GP factors and the
    segment-sum Wt), both on the card: float64 to phase 4's tolerances,
    float32 within F32_FLOOR / F32_FACTOR of the table path's own distance
    from float64; ms of one linearize on each path."""
    t0 = time.perf_counter()
    np_data, np_state, _ = make_local_ba_problem_numpy(**HEADLINE)
    names = ("Hpp", "bp", "Wt", "Hll", "bl", "dxp", "dxl", "chi2")
    outs, ms, launches = {}, {}, 0
    for dtype in (torch.float64, torch.float32):
        data, state = convert.ba_from_numpy(np_data, np_state, device=device, dtype=dtype)
        bare = data._replace(**NO_TABLES)
        for path, d in (("tables", data), ("fallback", bare)):
            interp_chain.LAUNCHES = 0
            outs[path, dtype], p = ba_outputs(d, state, 1.0)
            launches += interp_chain.LAUNCHES
            ms[f"{path}_{str(dtype)[6:]}"] = time_calls(lambda: p.linearize(state),
                                                        n_iter=1, n_rep=5)[0]
    errs = {}
    for i, name in enumerate(names):
        rtol, atol = (1e-9, 1e-10) if i < 5 else ((1e-7, 1e-9) if i < 7 else (1e-9, 0.0))
        errs[name + "_f64"] = assert_close(f"13a {name} f64 fallback vs tables",
                                           outs["fallback", torch.float64][i],
                                           outs["tables", torch.float64][i], rtol, atol)
        ref_err = rel_gap(outs["tables", torch.float32][i], outs["tables", torch.float64][i])
        tol = max(F32_FLOOR, F32_FACTOR * ref_err)
        err = rel_gap(outs["fallback", torch.float32][i], outs["tables", torch.float32][i])
        errs[name + "_f32"] = {"rel": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"13a {name} f32 fallback vs tables {err:.3e} > {tol:.3e}")
    rec = {"shape": {"K": int(np_data["times"].shape[0]), "L": int(np_state["X"].shape[0]),
                     "Em": int(np_data["mg_obs"].shape[0]), "Es": int(np_data["st_obs"].shape[0])},
           "linearize_ms": ms, "errors": errs, "chain_kernel_launches": launches,
           "tolerances": {"f64_lin": [1e-9, 1e-10], "f64_dx": [1e-7, 1e-9], "f64_chi2": 1e-9,
                          "f32": f"max({F32_FLOOR}, {F32_FACTOR} x the table path's f32-f64 gap)"},
           "seconds": time.perf_counter() - t0}
    emit("solver_fallback", **rec)
    return rec


def pcg_dense(device) -> dict:
    """13b: at the headline window in float64, make_ba_problem_pcg solved to
    400 CG steps / 1e-16 gives the dense solve's step to 1e-7 with both
    preconditioners; then global_ba_pcg for 10 iterations beside global_ba
    (final chi2 relative 1e-6), and on the card beside the CPU (the same
    iterations, final chi2 relative 1e-6). The problem has interp tables:
    every linearization launches the chain kernel."""
    t0 = time.perf_counter()
    np_data, np_state, _ = make_local_ba_problem_numpy(**HEADLINE)
    data, state = convert.ba_from_numpy(np_data, np_state, device=device, dtype=torch.float64)
    lam = torch.tensor(PCG_LAM, dtype=torch.float64, device=device)
    K, Cx = data.n_poses, data.n_ext
    dense = ba.make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    (dxp, dxl), _, _ = dense.solve(dense.linearize(state), lam)
    steps = {}
    for precond in ("jacobi", "schur_jacobi"):
        p = ba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                   precond=precond, **PCG_EXACT)
        lin = p.linearize(state)
        dx, _, _ = p.solve(lin, lam)
        err = max(float((dx.dxp - dxp[:12 * K].reshape(K, 12)).abs().max()),
                  float((dx.dxe - dxp[12 * K:].reshape(Cx, 12)[:, :6]).abs().max()),
                  float((dx.dxl - dxl).abs().max()))
        steps[precond] = {"cg_steps": dx.cg_steps, "rel_res": dx.rel_res, "max_abs_vs_dense": err,
                          "solve_ms": time_calls(lambda: p.solve(lin, lam), n_warm=0, n_iter=1)[0]}
        if not err <= 1e-7:
            raise AssertionError(f"13b {precond}: PCG step vs dense {err:.3e} > 1e-7")

    def run_pcg(dev, out):
        d, s = convert.ba_from_numpy(np_data, np_state, device=dev, dtype=torch.float64)
        out[dev] = ba.global_ba_pcg(d, s, GBA_ITERS)[1]

    stats = {}
    cpu = threading.Thread(target=run_pcg, args=("cpu", stats))
    cpu.start()
    try:
        interp_chain.LAUNCHES = 0
        sync()
        t1 = time.perf_counter()
        run_pcg(device, stats)
        sync()
        pcg_ms = (time.perf_counter() - t1) * 1e3
        launches = interp_chain.LAUNCHES
        _, dense_stats = ba.global_ba(data, state, GBA_ITERS)
    finally:
        cpu.join()
    card, host = stats[device], stats["cpu"]
    chi = {"global_ba_pcg": float(card.chi2), "global_ba": float(dense_stats.chi2),
           "global_ba_pcg_cpu": float(host.chi2), "initial": float(card.initial_chi2)}
    vs_dense = abs(chi["global_ba_pcg"] - chi["global_ba"]) / abs(chi["global_ba"])
    vs_cpu = abs(chi["global_ba_pcg"] - chi["global_ba_pcg_cpu"]) / abs(chi["global_ba_pcg_cpu"])
    iterations = {"card": card.iterations, "cpu": host.iterations,
                  "dense": dense_stats.iterations}
    rec = {"P": 12 * (K + Cx), "lambda": PCG_LAM, "exact_solves": steps, "final_chi2": chi,
           "iterations": iterations, "final_vs_dense_rel": vs_dense, "card_vs_cpu_rel": vs_cpu,
           "global_ba_pcg_ms": pcg_ms, "chain_kernel_launches": launches,
           "tolerances": {"step": 1e-7, "final_vs_dense": 1e-6, "card_vs_cpu": 1e-6},
           "seconds": time.perf_counter() - t0}
    emit("pcg_vs_dense", **rec)
    if not (vs_dense <= 1e-6 and vs_cpu <= 1e-6 and card.iterations == host.iterations):
        raise AssertionError(f"13b: global_ba_pcg vs global_ba {vs_dense:.3e}, card vs CPU "
                             f"{vs_cpu:.3e}, iterations {iterations}")
    if launches < card.iterations:
        raise AssertionError(f"13b: the chain kernel launched {launches}x")
    return rec


def pcg_5d(device) -> dict:
    """13c: config 5d at full size (2,000 KF, 10k landmarks, ~50k stereo
    edges), float32, 40 CG steps / 1e-3, lambda 1e-3: 3 warm-up and 5 timed
    chained iterations (linearize -> solve -> retract -> chi2, as
    bench.py's time_lm_iteration). Each timed iteration's solve is also run
    with no CG step, which is its fixed part (preconditioner, right-hand
    side, back-substitution); the rest over the CG steps is the ms per step.
    Then the chi2 of 2 chained iterations in float64 on the card against the
    float32 run's (relative 1e-4), and the warm-start study
    (`profile_pcg.profile_warm_start`) on the float32 problem."""
    t0 = time.perf_counter()
    np_data, np_state, _ = make_local_ba_problem_numpy(**PCG_5D)
    np_data = {**np_data, "gp_huber": np.asarray(True)}
    build_s = time.perf_counter() - t0

    def setup(dtype, **kw):
        data, state = convert.ba_from_numpy(np_data, np_state, device=device, dtype=dtype)
        p = ba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                   **{**PCG_5D_SOLVER, **kw})
        return data, state, p, torch.tensor(PCG_LAM, dtype=dtype, device=device)

    torch.cuda.reset_peak_memory_stats()
    data, state0, problem, lam = setup(torch.float32)
    fixed = ba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                   pcg_iters=0, pcg_tol=PCG_5D_SOLVER["pcg_tol"])
    k_steps = ba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                     pcg_iters=4, pcg_tol=0.0)

    def step(p, s):
        lin = p.linearize(s)
        dx, _, _ = p.solve(lin, lam)
        s = p.retract(s, dx)
        return s, p.chi2(s), dx, lin

    s = state0
    for _ in range(PCG_5D_WARM):
        s, *_ = step(problem, s)
    s, iters = state0, []
    for _ in range(PCG_5D_ITERS):
        sync()
        ta = time.perf_counter()
        lin = problem.linearize(s)
        sync()
        tb = time.perf_counter()
        dx, _, _ = problem.solve(lin, lam)
        sync()
        tc = time.perf_counter()
        s = problem.retract(s, dx)
        chi = float(problem.chi2(s))
        td = time.perf_counter()
        solve0 = time_calls(lambda: fixed.solve(lin, lam), n_warm=0, n_iter=1)[0]
        solve_ms = (tc - tb) * 1e3
        iters.append({"ms": (td - ta) * 1e3, "linearize_ms": (tb - ta) * 1e3,
                      "solve_ms": solve_ms, "retract_chi2_ms": (td - tc) * 1e3,
                      "solve_without_cg_ms": solve0,
                      "fixed_ms": (tb - ta) * 1e3 + solve0,
                      "cg_steps": dx.cg_steps, "rel_res": dx.rel_res,
                      "ms_per_cg_step": (solve_ms - solve0) / max(dx.cg_steps, 1),
                      "chi2": chi})
    peak = torch.cuda.max_memory_allocated()
    bound = cg_step_bound(data, lin)
    launches_fixed = kernel_launches(lambda: fixed.solve(lin, lam))
    launches_4 = kernel_launches(lambda: k_steps.solve(lin, lam))
    launches_lin = kernel_launches(lambda: problem.linearize(s))
    chi0 = float(problem.chi2(state0))
    warm = profile_warm_start(device, data=data, state0=state0)

    _, s64, p64, lam64 = setup(torch.float64)
    for _ in range(PCG_5D_F64_ITERS):
        s64, chi64, _, _ = step(p64, s64)
    chi64 = float(chi64)
    f32_vs_f64 = abs(iters[PCG_5D_F64_ITERS - 1]["chi2"] - chi64) / abs(chi64)
    med = {k: statistics.median(it[k] for it in iters)
           for k in ("ms", "fixed_ms", "ms_per_cg_step", "cg_steps")}
    rec = {"config": PCG_5D, "solver": PCG_5D_SOLVER, "lambda": PCG_LAM, "dtype": "float32",
           "K": data.n_poses, "L": int(state0.X.shape[0]), "Es": int(data.st_obs.shape[0]),
           "Ng": int(data.gp_pairs.shape[0]), "P": 12 * (data.n_poses + data.n_ext),
           "host_build_s": build_s, "chi2_initial": chi0, "iterations": iters, "median": med,
           "launches": {"linearize": launches_lin, "solve_without_cg": launches_fixed,
                        "per_cg_step": (launches_4 - launches_fixed) / 4},
           "cg_step_bound": bound, "peak_mem_bytes": peak, "chi2_f64_after_2": chi64,
           "chi2_f32_vs_f64_after_2_rel": f32_vs_f64, "tolerance_f32_vs_f64": PCG_5D_F64_RTOL,
           "warm_start": warm, "seconds": time.perf_counter() - t0}
    emit("pcg_5d", **rec)
    if not all(np.isfinite(it["chi2"]) for it in iters) or not iters[-1]["chi2"] < chi0:
        raise AssertionError(f"13c: chi2 {chi0} -> {[it['chi2'] for it in iters]}")
    for name in ("cold", "warm"):
        chain = warm[name]["chi2"]
        if not (all(np.isfinite(chain)) and chain[-1] < chi0):
            raise AssertionError(f"13c: the {name} chain's chi2 {chi0} -> {chain}")
    if not f32_vs_f64 <= PCG_5D_F64_RTOL:
        raise AssertionError(f"13c: f32 vs f64 chi2 after 2 iterations {f32_vs_f64:.3e}")
    return rec


def vi_config4(device) -> dict:
    """13d: config 4 (20 KF, 500 landmarks), vi_ba for 10 iterations in
    float32 and float64 on the card; float64 card vs CPU (deterministic
    algorithms on): chi2 after every LM iteration relative 1e-9, the final
    states 1e-8; ms per LM iteration; the final chi2 beside the ground
    truth's."""
    t0 = time.perf_counter()
    np_data, np_state, np_gt = make_vi_ba_synthetic_numpy(**VI_4)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for key, dev, dtype in (("card_f32", device, torch.float32),
                                ("card_f64", device, torch.float64),
                                ("cpu_f64", "cpu", torch.float64)):
            d = convert.vi_ba_from_numpy(np_data, device=dev, dtype=dtype)
            s = convert.vi_ba_state_from_numpy(np_state, device=dev, dtype=dtype)
            gt = convert.vi_ba_state_from_numpy(np_gt, device=dev, dtype=dtype)
            p = vi_ba.make_vi_ba_problem(d)
            out, chis = lm_trace(p, s, n_iter=VI_ITERS, lambda_init=1e-2)
            rec = {"chi2": chis, "chi2_gt": float(p.chi2(gt)), "state": out}
            if dev != "cpu":
                sync()
                ta = time.perf_counter()
                _, st = vi_ba.vi_ba(d, s, VI_ITERS)
                sync()
                rec["ms_per_lm_iteration"] = (time.perf_counter() - ta) * 1e3 / st.iterations
            runs[key] = rec
    finally:
        torch.use_deterministic_algorithms(False)
    card, host = runs["card_f64"], runs["cpu_f64"]
    chi_err = max(abs(a - b) / abs(b) for a, b in zip(card["chi2"], host["chi2"]))
    state_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card["state"], host["state"]))
    rec = {"config": VI_4, "E": int(np_data["obs"].shape[0]), "K": VI_4["n_kf"],
           "chi2": {k: r["chi2"] for k, r in runs.items()},
           "chi2_ground_truth": {k: r["chi2_gt"] for k, r in runs.items()},
           "ms_per_lm_iteration": {k: r["ms_per_lm_iteration"] for k, r in runs.items()
                                   if "ms_per_lm_iteration" in r},
           "card_vs_cpu_chi2_max_rel": chi_err, "card_vs_cpu_state_max_abs": state_err,
           "tolerances": {"chi2": 1e-9, "state": 1e-8}, "seconds": time.perf_counter() - t0}
    emit("vi_ba", **rec)
    if len(card["chi2"]) != len(host["chi2"]) or not chi_err <= 1e-9 or not state_err <= 1e-8:
        raise AssertionError(f"13d card vs CPU: chi2 {chi_err:.3e}, state {state_err:.3e}")
    for k, r in runs.items():
        if not r["chi2"][-1] < 1e-2 * r["chi2"][0]:
            raise AssertionError(f"13d {k}: chi2 {r['chi2'][0]} -> {r['chi2'][-1]}")
    return rec


def two_view_scene(planar: bool, seed: int):
    """tests/test_two_view_and_pnp.py:19-46 at TWO_VIEW's size, in numpy:
    a general scene (depths 5-20 m) or a plane z = 8 + 0.2x - 0.1y, 0.5 px
    noise, a share of gross outliers in the second view."""
    n = TWO_VIEW["n"]
    rng = np.random.RandomState(seed)
    R_gt = lie.exp_so3(torch.tensor([0.02, -0.25, 0.03], dtype=torch.float64)).numpy()
    t_gt = np.array([1.0, 0.05, 0.1])
    t_gt = t_gt / np.linalg.norm(t_gt)
    if planar:
        xy = rng.uniform(-4, 4, (n, 2))
        X = np.concatenate([xy, 8 + 0.2 * xy[:, :1] - 0.1 * xy[:, 1:2]], axis=1)
    else:
        X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 20, n)], 1)
    K = np.array(TWO_VIEW_K)

    def project(P):
        return np.stack([K[0] * P[:, 0] / P[:, 2] + K[2], K[1] * P[:, 1] / P[:, 2] + K[3]], 1)

    kp1 = project(X) + rng.randn(n, 2) * TWO_VIEW["noise"]
    kp2 = project(X @ R_gt.T + t_gt) + rng.randn(n, 2) * TWO_VIEW["noise"]
    bad = rng.rand(n) < TWO_VIEW["outlier_frac"]
    kp2[bad] += rng.randn(int(bad.sum()), 2) * 60 + 30
    fields = {"kp1": kp1, "kp2": kp2, "valid": np.ones(n, bool), "K": K,
              "sigma": np.asarray(1.0)}
    samples = np.stack([np.random.RandomState(h).choice(n, 8, replace=False)
                        for h in range(TWO_VIEW["hypotheses"])])
    return fields, samples, R_gt


def two_view_orb(device) -> dict:
    """13e: two_view.reconstruct at TwoViewReconstruction's 200 hypotheses
    over 1,000 matches (10 % outliers), general and planar scenes of seeds
    TWO_VIEW_SEEDS, float64. Checks: the card equals the CPU on every scene
    (ok, used_homography, n_good and the triangulated mask exactly; R and t
    to 1e-8 where the reconstruction is ok, the chosen motion then being the
    unique best candidate); every general scene takes F, at least one is ok
    and every ok one recovers R within TWO_VIEW_R_TOL; on every planar scene
    the best homography's 8 Faugeras motions hold R within TWO_VIEW_R_TOL.
    The reference's algorithm is kept as it is: it does not refit on the
    inliers, so at 1,000 matches the best minimal sample often leaves too
    few points within CheckRT's 2 px to be ok, and its scoring selects F
    on planar scenes too (F fits a plane's points as well as H, and its
    1-D transfer error scores higher: RH < 0.5). Both shares are
    recorded. ms per reconstruct on the card."""
    t0 = time.perf_counter()
    scenes = {}
    for planar in (False, True):
        for seed in TWO_VIEW_SEEDS:
            fields, S, R_gt = two_view_scene(planar, seed)
            res = {}
            for dev in (device, "cpu"):
                data = convert.two_view_from_reference(fields, device=dev, dtype=torch.float64)
                S_d = torch.tensor(S, device=dev)
                res[dev] = (data, S_d, two_view.reconstruct(data, S_d))
            data, S_d, got = res[device]
            ref = res["cpu"][2]
            same = {"ok": bool(got.ok) == bool(ref.ok),
                    "used_homography": bool(got.used_homography) == bool(ref.used_homography),
                    "n_good": int(got.n_good) == int(ref.n_good),
                    "triangulated": bool(torch.equal(got.triangulated.cpu(), ref.triangulated))}
            motion_gap = max(float((got.R.cpu() - ref.R).abs().max()),
                             float((got.t.cpu() - ref.t).abs().max()))
            kpn1, T1 = two_view._normalize(data.kp1, data.valid)
            kpn2, T2 = two_view._normalize(data.kp2, data.valid)
            p1, p2 = kpn1[S_d], kpn2[S_d]
            sF = two_view._score_F(T2.T @ two_view._fundamental_8pt(p1, p2) @ T1, data)[0]
            H_h = torch.linalg.inv(T2) @ two_view._homography_4pt(p1, p2) @ T1
            H_h = H_h / H_h[:, 2:3, 2:3]
            sH = two_view._score_H(H_h, data)[0]
            Rs, _, _ = two_view._faugeras_motions(H_h[torch.argmax(sH)], data.K)
            name = f"{'planar' if planar else 'general'}_{seed}"
            scenes[name] = {
                "ok": bool(got.ok), "used_homography": bool(got.used_homography),
                "n_good": int(got.n_good), "RH": float(sH.max() / (sH.max() + sF.max())),
                "R_err": float(np.abs(got.R.cpu().numpy() - R_gt).max()),
                "homography_motions_best_R_err": min(float(np.abs(R.cpu().numpy() - R_gt).max())
                                                     for R in Rs),
                "card_equals_cpu": same, "card_vs_cpu_motion_max_abs": motion_gap,
                "ms_median": time_calls(lambda: two_view.reconstruct(data, S_d), n_warm=0,
                                        n_iter=1)[0]}
            if not all(same.values()) or (bool(ref.ok) and not motion_gap <= 1e-8):
                raise AssertionError(f"13e {name}: card vs CPU {same}, motion {motion_gap:.3e}")
    general = [v for k, v in scenes.items() if k.startswith("general")]
    planar = [v for k, v in scenes.items() if k.startswith("planar")]
    rec = {"config": TWO_VIEW, "seeds": list(TWO_VIEW_SEEDS), "scenes": scenes,
           "general_ok": sum(v["ok"] for v in general),
           "planar_used_homography": sum(v["used_homography"] for v in planar),
           "ms_median": statistics.median(v["ms_median"] for v in scenes.values()),
           "seconds": time.perf_counter() - t0}
    emit("two_view", **rec)
    if any(v["used_homography"] for v in general) or not rec["general_ok"] >= 1:
        raise AssertionError(f"13e: general scenes ok {rec['general_ok']}, F everywhere "
                             f"{not any(v['used_homography'] for v in general)}")
    bad = [k for k, v in scenes.items() if (v["ok"] and v["R_err"] > TWO_VIEW_R_TOL)
           or (k.startswith("planar") and v["homography_motions_best_R_err"] > TWO_VIEW_R_TOL)]
    if bad:
        raise AssertionError(f"13e: motion beyond {TWO_VIEW_R_TOL} in {bad}")
    return rec


def phase_solvers(device, smi) -> int:
    """Phase 13. Returns the chain's launches of 13a and 13b."""
    t_phase = time.perf_counter()
    fb = solver_fallback(device)
    dense = pcg_dense(device)
    big = pcg_5d(device)
    vi = vi_config4(device)
    tv = two_view_orb(device)
    launches = fb["chain_kernel_launches"] + dense["chain_kernel_launches"]
    emit("solvers_summary", seconds=time.perf_counter() - t_phase, card=smi,
         chain_kernel_launches=launches,
         linearize_ms=fb["linearize_ms"], pcg_5d_median=big["median"],
         pcg_5d_launches=big["launches"], pcg_5d_cg_step_bound=big["cg_step_bound"],
         pcg_5d_peak_mem_bytes=big["peak_mem_bytes"],
         vi_ms_per_lm_iteration=vi["ms_per_lm_iteration"],
         two_view_ms=tv["ms_median"], two_view_general_ok=tv["general_ok"])
    return launches


# ---------------------------------------------------------------------------
# phase 14: the multi-device solvers; phase 15: the device ORB's stages
# ---------------------------------------------------------------------------

RANKS = 4
RANKS_DEADLINE_S = 400.0
DRYRUN_RTOL = 1e-5             # float32: the floor of 14a's bound (see dryrun_witness)
DRYRUN_WITNESS_FACTOR = 10.0   # as PAD_TOL_FACTOR: the bound over the run's own float32 noise
SHARDED_BA_ITERS = 10
SHARDED_BA_TOL = {"chi2_rtol": 1e-10, "T_v_atol": 1e-8, "X_atol": 1e-7}  # test_sharded_ba.py:98-123
NCCL_RTOL = 1e-12
ONE_RANK_BACKEND = "nccl"      # a CPU rehearsal sets "gloo"
# LM iterations of 14c from lambda_0 = 1e-16 (optimize_essential_graph runs
# 20): 5a as tests/test_sharded_ba.py:126-163; each CG step of a sharded
# run costs ~9.6 ms on 4 ranks sharing the card (PERF.md), so 5e runs 3
EG_5A_ITERS = 5
EG_5E_ITERS = 3
EG_5A_TOL = {"chi2_rtol": 1e-9, "t_atol": 1e-7}
NOT_SCALING = "4 ranks sharing one card, gloo through the host, not a scaling figure"


def ranks_identical(results, key, fields) -> bool:
    """Whether every rank returned the same bits in `fields` of
    results[r][key] (the replicated state)."""
    first = results[0][key]
    return all(np.array_equal(getattr(r[key], f), getattr(first, f))
               for r in results[1:] for f in fields)


def dryrun_witness(device) -> list:
    """14a's float32 noise: the single-device dry run again, its two start
    states moved by PAD_PERTURB_ULPS float32 ulps (random signs, seed 0).
    After 3 LM iterations in float32 the dry run's chi2 moves by ~1e-5 of
    itself when its rounding changes (the single-device run alone gave
    14.854154-14.854318 in four calls on the H100, through the atomics of
    `index_add_`), and sharding changes the order of its sums. So 14a is
    held to max(DRYRUN_RTOL, DRYRUN_WITNESS_FACTOR x this run's relative
    move), as check_padded holds the padded combos."""
    make = entry._dryrun_problems

    def moved(n_devices):
        (data, state0), (eg_data, eg_state0) = make(n_devices)
        return (data, ulp_perturbed(state0)), (eg_data, ulp_perturbed(eg_state0))

    with mock.patch.object(entry, "_dryrun_problems", moved):
        return list(entry.dryrun_single_device(RANKS, device))


def timed_lm(problem, state, iters, lambda_init):
    """lm_optimize with its host seconds behind syncs."""
    sync()
    t0 = time.perf_counter()
    out, stats = tlm.lm_optimize(problem, state, iters, lambda_init=lambda_init)
    sync()
    return out, stats, time.perf_counter() - t0


def nccl_one_rank(np_data, np_state, device, want_chi2) -> dict:
    """14b's NCCL check: the headline problem sharded over a world of one
    rank (this process) under NCCL equals make_ba_problem's run."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(ONE_RANK_BACKEND, init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            sb1 = sharded_ba.shard_ba_data(np_data, np_state, 1)
            p1 = sharded_ba.make_sharded_ba_problem(sb1, 0, dist.group.WORLD, device)
            _, st, _ = timed_lm(p1, sb1.local_state(0, device), SHARDED_BA_ITERS, 1.0)
        finally:
            dist.destroy_process_group()
    rel = abs(float(st.chi2) - want_chi2) / abs(want_chi2)
    if not rel <= NCCL_RTOL:
        raise AssertionError(f"14b NCCL: one-rank chi2 {float(st.chi2)} vs {want_chi2}: {rel:.3e}")
    return {"backend": ONE_RANK_BACKEND, "world_size": 1, "chi2": float(st.chi2), "iterations":
            st.iterations, "chi2_rel_vs_single": rel, "rtol": NCCL_RTOL}


def phase_multidevice(device, smi) -> int:
    """Phase 14: one `run_ranks` spawn of 4 gloo ranks on the card runs
    14a (the dry run), 14b (the landmark-sharded local BA at the headline
    window, float64, 10 LM iterations) and 14c (the edge-sharded essential
    graph: config 5a float64, config 5e float32); the main process holds
    each against its single-device run on the card, then repeats 14b on a
    world of one rank under NCCL. Returns the chain's launches of the phase
    (every rank's and the main process's)."""
    t_phase = time.perf_counter()
    np_data, np_state, _ = make_local_ba_problem_numpy(**HEADLINE)
    sb = sharded_ba.shard_ba_data(np_data, np_state, RANKS)
    eg5a, st5a, _ = make_essential_graph_numpy(**EG_5A)
    eg5e, st5e, Ts5e = make_essential_graph_numpy(**EG_5E)
    f32 = convert.essential_graph_from(eg5e, dtype=torch.float32)
    jobs = [(entry.dryrun_rank, (RANKS,)),
            (sharded_ba.run_lm, (sb, SHARDED_BA_ITERS, 1.0)),
            (sharded_eg.run_lm, (sharded_eg.shard_eg_data(eg5a, RANKS), st5a, EG_5A_ITERS,
                                 1e-16)),
            (sharded_eg.run_lm, (sharded_eg.shard_eg_data(f32, RANKS),
                                 {k: np.asarray(v, np.float32) for k, v in st5e.items()},
                                 EG_5E_ITERS, 1e-16)),
            (sharded_ba.chain_launches, ())]
    # the single-device runs that are timed go before the spawn, alone on the card
    data, state = convert.ba_from_numpy(np_data, np_state, device=device, dtype=torch.float64)
    problem = ba.make_ba_problem(data, data.mg_valid, data.sg_valid, data.st_valid)
    s1, st1, single_s = timed_lm(problem, state, SHARDED_BA_ITERS, 1.0)
    d5a = convert.essential_graph_from(eg5a, device=device, dtype=torch.float64)
    s5a = convert.sim3_field_from(st5a, device=device, dtype=torch.float64)
    out5a, stats5a, single5a_s = timed_lm(sim3_opt.make_essential_graph_problem_pcg(d5a), s5a,
                                          EG_5A_ITERS, 1e-16)
    interp_chain.LAUNCHES = 0

    def spawn():
        t0, wall0 = time.perf_counter(), time.time()
        res = pgroup.run_ranks(pgroup.sequence, RANKS, device=str(device), backend="gloo",
                               args=(jobs,), deadline_s=RANKS_DEADLINE_S)
        return res, time.perf_counter() - t0, wall0

    # while the ranks run: the untimed single-device checks (the dry run's
    # problems, the deterministic headline run and its NCCL one-rank twin)
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(spawn)
        want = entry.dryrun_single_device(RANKS, device)
        witness = [abs(a - b) / abs(b) for a, b in zip(dryrun_witness(device), want)]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, st_det, _ = timed_lm(problem, state, SHARDED_BA_ITERS, 1.0)
            nccl = nccl_one_rank(np_data, np_state, device, float(st_det.chi2))
        finally:
            torch.use_deterministic_algorithms(False)
        ranks, ranks_s, wall0 = pending.result()
    dry, lba, e5a, e5e, rank_launches = (list(x) for x in zip(*(r["results"] for r in ranks)))
    timing = {"ranks_s": ranks_s, "start_up_s": max(r["started"] for r in ranks) - wall0,
              "jobs_s": dict(zip(("14a", "14b", "14c_5a", "14c_5e", "count"),
                                 np.max([r["seconds"] for r in ranks], axis=0).tolist()))}

    # 14a
    rel = [abs(a - b) / abs(b) for a, b in zip(dry[0], want)]
    tol = [max(DRYRUN_RTOL, DRYRUN_WITNESS_FACTOR * w) for w in witness]
    rec_a = {"chi2": dry[0][0], "eg_chi2": dry[0][1], "single_device": list(want),
             "rel": rel, "rtol": tol, "single_device_ulp_witness": witness,
             "ranks_agree": all(d == dry[0] for d in dry)}
    emit("multidevice_dryrun", **rec_a)
    if not (all(np.isfinite(dry[0])) and all(r <= t for r, t in zip(rel, tol))
            and rec_a["ranks_agree"]):
        raise AssertionError(f"14a: {rec_a}")

    # 14b
    r0 = lba[0]
    X = sharded_ba.unshard_X(sb, [r["state"].X for r in lba])
    gaps = {"chi2_rel": abs(float(r0["chi2"]) - float(st1.chi2)) / abs(float(st1.chi2)),
            "T_max_abs": float(np.abs(r0["state"].T - s1.T.cpu().numpy()).max()),
            "v_max_abs": float(np.abs(r0["state"].v - s1.v.cpu().numpy()).max()),
            "X_max_abs": float(np.abs(X - s1.X.cpu().numpy()).max())}
    rec_b = {"config": HEADLINE, "dtype": "float64", "ranks": RANKS, "L_per_rank": sb.lm_per_shard,
             "iterations": {"sharded": int(r0["iterations"]), "single": st1.iterations},
             "chi2": {"sharded": float(r0["chi2"]), "single": float(st1.chi2),
                      "initial": float(r0["initial_chi2"])},
             "gaps": gaps, "tolerances": SHARDED_BA_TOL,
             "ranks_agree": ranks_identical(lba, "state", ("T", "v", "Text")),
             "chain_launches_per_rank": [int(r["chain_launches"]) for r in lba],
             "ms_per_lm_iteration": {
                 "sharded": 1e3 * r0["seconds"] / max(int(r0["iterations"]), 1),
                 "single": 1e3 * single_s / max(st1.iterations, 1), "note": NOT_SCALING},
             "nccl_one_rank": nccl}
    emit("multidevice_ba", **rec_b)
    tol = SHARDED_BA_TOL
    if not (rec_b["iterations"]["sharded"] == st1.iterations and rec_b["ranks_agree"]
            and gaps["chi2_rel"] <= tol["chi2_rtol"] and gaps["T_max_abs"] <= tol["T_v_atol"]
            and gaps["v_max_abs"] <= tol["T_v_atol"] and gaps["X_max_abs"] <= tol["X_atol"]):
        raise AssertionError(f"14b: {rec_b}")
    if min(rec_b["chain_launches_per_rank"]) < st1.iterations:
        raise AssertionError(f"14b: chain launches per rank {rec_b['chain_launches_per_rank']}")

    # 14c
    a0, e0 = e5a[0], e5e[0]
    gap5a = {"chi2_rel": abs(float(a0["chi2"]) - float(stats5a.chi2)) / abs(float(stats5a.chi2)),
             "t_max_abs": float(np.abs(a0["state"].t - out5a.t.cpu().numpy()).max())}
    path_m = float(np.linalg.norm(np.diff(Ts5e[:, :3, 3], axis=0), axis=1).sum())
    ate = eg_ate(sim3_opt.Sim3Field(*(torch.as_tensor(x) for x in e0["state"])), Ts5e)

    def eg_rec(r, n_edges):
        return {"iterations": int(r["iterations"]), "chi2": float(r["chi2"]),
                "cg_steps": int(r["cg_steps"]),
                "all_reduces_per_cg_step": r["cg_all_reduces"] / max(r["cg_steps"], 1),
                "ms_per_lm_iteration": 1e3 * r["seconds"] / max(int(r["iterations"]), 1),
                "edges_per_rank": n_edges}

    rec_c = {"5a": {**eg_rec(a0, -(-int(eg5a["pairs"].shape[0]) // RANKS)), "dtype": "float64",
                    "single": {"iterations": stats5a.iterations, "chi2": float(stats5a.chi2),
                               "ms_per_lm_iteration":
                                   1e3 * single5a_s / max(stats5a.iterations, 1)},
                    "gaps": gap5a, "tolerances": EG_5A_TOL,
                    "ranks_agree": ranks_identical(e5a, "state", ("s", "R", "t"))},
             "5e": {**eg_rec(e0, -(-int(eg5e["pairs"].shape[0]) // RANKS)), "dtype": "float32",
                    "path_m": path_m, "ate_after_m": ate, "ate_after_pct": 100 * ate / path_m,
                    "ate_bound_pct": EG_ATE_PCT,
                    "ranks_agree": ranks_identical(e5e, "state", ("s", "R", "t"))},
             "note": NOT_SCALING}
    emit("multidevice_eg", **rec_c)
    if not (gap5a["chi2_rel"] <= EG_5A_TOL["chi2_rtol"]
            and gap5a["t_max_abs"] <= EG_5A_TOL["t_atol"]
            and rec_c["5a"]["ranks_agree"] and rec_c["5e"]["ranks_agree"]):
        raise AssertionError(f"14c 5a: {rec_c['5a']}")
    if not ate <= EG_ATE_PCT / 100 * path_m:
        raise AssertionError(f"14c 5e: ATE {ate:.3f} m > {EG_ATE_PCT} % of {path_m:.0f} m")

    launches = sum(rank_launches) + interp_chain.LAUNCHES
    emit("multidevice_summary", seconds=time.perf_counter() - t_phase, ranks_timing=timing,
         card=smi, ranks=RANKS, backend="gloo", chain_kernel_launches=launches,
         chain_kernel_launches_by_rank=rank_launches,
         chain_kernel_launches_main=interp_chain.LAUNCHES, note=NOT_SCALING)
    return launches


def phase_orb_profile(device, smi) -> dict:
    """Phase 15: examples/profile_orb_device.py on 12a's tick (7 images,
    1,200 features): device ms, launches and share of the tick per stage."""
    t0 = time.perf_counter()
    _, _, imgs = orb_frame()
    out = profile_orb_device.profile(imgs, ORB_FEATURES, device)
    emit("orb_profile", **out, card=smi, seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# phase 10: the chain at the sizes the System launches it
# ---------------------------------------------------------------------------

# FLOP per combo, counted from csrc/interp_chain.cu: 40 3x3 products (45 FLOP
# each), 12 matrix-vector products (15 each), 6 series matrices I + aW + bW^2
# (36 each) and ~400 FLOP of scalings, sums and scalars; the log's and the two
# coefficient sets' sqrt, sin, cos, atan2 and divisions (~100) count one each
FLOP_PER_COMBO = 2700
ROW_VALUES = 12 + 6 + 1     # a state row the kernel needs: (R|t), v, time
OUT_VALUES = 16 + 16 + 144  # Twb, Tbw, Q


def chain_bound(form: str, args: tuple) -> dict:
    """The least time the card could take for one call: every input value the
    combos need read once (distinct state rows, the query times, the int64
    indices), every output written once, over HBM bandwidth; the FLOP over the
    peak rate of the dtype; the larger of the two."""
    t = args[-1]
    S, esize = t.shape[0], t.element_size()
    if form == "pair":
        rows, index_bytes = 2, 0
    elif form == "indexed":
        rows, index_bytes = int(torch.unique(torch.cat([args[3], args[4]])).numel()), 16 * S
    else:
        rows, index_bytes = 2 * S, 0
    nbytes = esize * (ROW_VALUES * rows + S + OUT_VALUES * S) + index_bytes
    flop = FLOP_PER_COMBO * S
    ms_bytes, ms_flop = nbytes / HBM_BYTES_PER_S * 1e3, flop / PEAK_FLOPS[t.dtype] * 1e3
    return {"bound_ms": max(ms_bytes, ms_flop),
            "bound_by": "bytes" if ms_bytes >= ms_flop else "operations",
            "bytes": nbytes, "flop": flop}


def checked(fn, args):
    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
    return launch


def indexed_inputs(data, state, sid_cols, it_sid, it_t) -> tuple:
    """The indexed entry's inputs as `ba._interp_packs` builds them."""
    i_u, j_u = ba._combo_ends(data, sid_cols, it_sid)
    return state.T, state.v, data.times, i_u, j_u, it_t


ENTRIES = {
    "pair": (interp_chain.gp_interp_packs_pair, interp_chain.gp_interp_packs_pair_ref, expanded),
    "indexed": (interp_chain.gp_interp_packs_indexed, interp_chain.gp_interp_packs_indexed_ref,
                gathered),
}


def ends(form, args):
    """The kernel's endpoints (`interp_chain._bind`) of an entry's inputs."""
    if form == "pair":
        T, v, t1, t2, _ = args
        return (T, v, t1, None, 0, 0), (T, v, t2, None, 0, 1)
    if form == "indexed":
        T, v, times, i, j, _ = args
        return (T, v, times, i, 0, 0), (T, v, times, j, 0, 0)
    T1, v1, T2, v2, t1, t2, _ = args
    return (T1, v1, t1, None, 1, 0), (T2, v2, t2, None, 1, 0)


PAD_PERTURB_ULPS = 4   # relative input perturbation of check_padded, in float64 eps
PAD_TOL_FACTOR = 10.0  # the float32 envelope's factor over the plain version's own error


def check_padded(name, got64, ref64, args64, live, ref) -> dict:
    """The padded combos' float64 check. The local BA pads its combo table
    to the bucket with the dump combo (structure 0 at query time 0, so far
    outside its interval [times[i], times[j]]: s = (t - t_i)/(t_j - t_i) is
    large and negative), whose edges are masked. The extrapolated Hermite
    chain is ill-conditioned there, so float64 evaluations of it that round
    in a different order differ by more than 1e-12: the port's plain version
    and the reference's own JAX and Pallas paths do
    (tests/test_torch_interp_indexed.py).
    The tolerance is derived from the plain version's own sensitivity: its
    change when every float input moves by 4 ulps (random signs, seed 0),
    times 10, as the float32 envelope takes 10x the plain version's error;
    never below 1e-12."""
    moved = ref(*ulp_perturbed(args64))
    pad = ~live
    sens = max(max_rel(moved[k][pad], ref64[k][pad]) for k in KEYS)
    tol = max(1e-12, PAD_TOL_FACTOR * sens)
    err = max(max_rel(got64[k][pad], ref64[k][pad]) for k in KEYS)
    if not err <= tol:
        raise AssertionError(f"f64 {name} padded combos: kernel vs plain {err:.3e} > {tol:.3e}")
    return {"f64_max_rel_padded": err, "f64_padded_tol": tol, "f64_padded_plain_sensitivity": sens}


def extrapolation(form, args, live) -> float:
    """The largest |s| = |t - t_i| / (t_j - t_i) of the padded combos."""
    if form != "indexed" or bool(live.all()):
        return 0.0
    _, _, times, i, j, t = args
    s = (t - times[i]) / (times[j] - times[i])
    return float(s[~live].abs().max())


def phase_sizes(size_inputs: dict) -> dict:
    """Phase 10 on {name: (form, inputs, live)}; returns the record of each
    size. `live` masks the combos the caller uses; the padded ones are held
    to `check_padded`'s tolerance."""
    empty = checked(interp_chain._library().interp_chain_empty,
                    [torch.cuda.current_stream().cuda_stream])
    out = {}
    for name, (form, args, live) in size_inputs.items():
        entry, ref, as_rows = ENTRIES[form]
        rows = as_rows(*args)
        got = entry(*args)
        assert_equal_packs(f"{name}: {form} entry vs gp_interp_packs", got,
                           interp_chain.gp_interp_packs(*rows))
        S = int(args[-1].shape[0])
        live = torch.ones(S, dtype=torch.bool, device=args[-1].device) if live is None else live
        rec = {"S": S, "live_combos": int(live.sum()), "dtype": str(args[-1].dtype).split(".")[-1],
               "form": form}
        args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
        got64, ref64 = entry(*args64), ref(*args64)
        rec["f64_max_rel"] = check_f64(name, {k: got64[k][live] for k in KEYS},
                                       {k: ref64[k][live] for k in KEYS})
        if not bool(live.all()):
            rec.update(check_padded(name, got64, ref64, args64, live, ref),
                       padded_max_abs_s=extrapolation(form, args64, live))
        if args[-1].dtype == torch.float32:
            rec.update(f32_summary(check_f32(tuple(a[live].double() for a in rows))))
        fn, kargs, _ = interp_chain._bind(*ends(form, args), args[-1])
        fn_r, kargs_r, _ = interp_chain._bind(*ends("rows", rows), rows[-1])
        launches = {"kernel": checked(fn, kargs), "kernel_rows": checked(fn_r, kargs_r),
                    "empty": empty}
        order = ["kernel", "kernel_rows", "empty", "empty", "kernel_rows", "kernel"]
        ms = {k: [] for k in launches}
        for variant in order:
            ms[variant].append(time_device(launches[variant]))
        med = {k: statistics.median(v) for k, v in ms.items()}
        rec.update({"device_ms": med["kernel"], "device_ms_on_gathered_rows": med["kernel_rows"],
                    "launch_floor_ms": med["empty"],
                    "ms_turns": ms, "order": order,
                    "entry_ms": time_chain(entry, args),
                    "plain_ms": time_chain(ref, args, n=20),
                    **chain_bound(form, args)})
        emit("sizes", name=name, **rec)
        out[name] = rec
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", action="store_true",
                    help="after the default phases, run the opt-in scenarios: the "
                         "figure-eight (160 frames) and the threaded pin (2 x 40 frames)")
    args = ap.parse_args(argv)
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
    s_launches, probe = phase_system(device, smi)
    # 11. loop closing
    l_launches, gba_combos = phase_loop(device, smi)
    # 12. the image frontend and the entry points
    f_launches = phase_frontend(device, smi)
    # 13. the per-edge fallback, the PCG global BA, VI BA and two-view
    v_launches = phase_solvers(device, smi)
    # 14. the multi-device solvers
    m_launches = phase_multidevice(device, smi)
    # 15. the device ORB's stage profile
    phase_orb_profile(device, smi)

    # 10. the chain at the System's sizes
    _, d9, s9, sid9, it_sid9, it_t9 = probe.lba_combos
    _, d11, s11, sid11, it_sid11, it_t11 = gba_combos
    headline = indexed_inputs(data, state0, data.mg_sid_cols, data.mg_it_sid, data.mg_it_t)
    sizes = phase_sizes({
        "pose_pair": ("pair", probe.chain_args["pair"][1], None),
        "local_ba_live_U": ("indexed", indexed_inputs(d9, s9, sid9, it_sid9, it_t9),
                            it_sid9 != 0),
        "global_ba_live_U": ("indexed", indexed_inputs(d11, s11, sid11, it_sid11, it_t11),
                             it_sid11 != 0),
        "headline_1024": ("indexed", headline, data.mg_it_sid != 0),
        "headline_1024_f64": ("indexed", tuple(a.double() if a.is_floating_point() else a
                                               for a in headline), data.mg_it_sid != 0),
    })
    head = sizes["headline_1024"]
    emit("sizes_summary", card=smi, device_ms={k: v["device_ms"] for k, v in sizes.items()},
         launch_floor_ms={k: v["launch_floor_ms"] for k, v in sizes.items()},
         bound_ms={k: v["bound_ms"] for k, v in sizes.items()})
    # the opt-in scenarios
    x_launches = phase_scenarios(device, smi) if args.scenarios else 0

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gp_interp_chain",
        "route": "cuda",
        "source": "amcslam_tpu_torch/csrc/interp_chain.cu",
        "replaces": "amcslam_tpu/ops/pallas_chain.py:296",
        "launches": (launches + t_launches + s_launches + l_launches + f_launches + v_launches
                     + m_launches + x_launches),
        "max_abs_err": max_abs_err,
        "ms": chain_ms["kernel"],
        "plain_ms": chain_ms["plain"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "device_ms": head["device_ms"],
        "launch_floor_ms": head["launch_floor_ms"],
        "sizes": [{k: v[k] for k in ("S", "dtype", "form", "device_ms", "launch_floor_ms",
                                     "bound_ms", "bound_by", "entry_ms", "plain_ms")}
                  for v in sizes.values()],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
