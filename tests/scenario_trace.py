"""Trace of one rendered end-to-end scenario (tests/test_e2e_scenarios.py) in
the JAX reference or in the port, on the CPU: per frame the tracking state
and the keyframe and map-point counts; the frames at
which the closer corrected a loop; and per keyframe the closer saw, the
candidates the keyframe database returned, each candidate's descriptor
matches and Sim3 inliers, and the pending hypothesis it carried.

`trace(pkg, name)` runs scenario `name` of SCENARIOS in package `pkg`
("ref" or "port"). With `parity=True` both run in the setup of
tests/test_torch_e2e_rendered.py, so that their runs can be held to each
other: one id counter start, the extraction buckets reset, the System's
bucket preset off (AMCSLAM_NO_BUCKET_PRESET), and the reference extracting
with the port's native ORB build (the reference's own build fuses
multiply-adds; ROADMAP §3). With `parity=False` the package runs as its
own test runs it.

    python tests/scenario_trace.py eight --pkg ref --pkg port --from-frame 100

prints, for each package, the closures, the per-frame states and the
closer's candidates keyframe by keyframe from `--from-frame` on, each with
why it was dropped (too few matches for the Sim3 solve, too few inliers, or
a pending hypothesis verified or missed).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ID_START = 10_000_000

# tests/test_e2e_scenarios.py's parameters, unchanged
SCENARIOS = {
    "eight": dict(n_frames=160, fps=5.0, seed=0, eight=True, circle_period=14.0,
                  circle_radius=4.5, n_features=500),
    "blackout": dict(n_frames=90, fps=5.0, seed=0, circle=True, circle_period=12.0,
                     circle_radius=4.0, n_features=500, blackout=(66, 6)),
    "threaded_sequential": dict(n_frames=40, fps=5.0, seed=3, n_features=400, threaded=False),
    "threaded": dict(n_frames=40, fps=5.0, seed=3, n_features=400, threaded=True),
}


def _package(pkg: str):
    """(e2e module, map_store, extraction, loop_closing, keyframe_database,
    run kwargs) of the reference or the port."""
    if pkg == "ref":
        sys.path.insert(0, str(REPO / "examples"))
        import e2e_rendered as mod  # noqa: E402

        import amcslam_tpu.pipeline.map_store as map_store
        from amcslam_tpu.pipeline import extraction, keyframe_database, loop_closing
        return mod, map_store, extraction, loop_closing, keyframe_database, {}
    from amcslam_tpu_torch.examples import e2e_rendered as mod
    import amcslam_tpu_torch.pipeline.map_store as map_store
    from amcslam_tpu_torch.pipeline import extraction, keyframe_database, loop_closing
    return mod, map_store, extraction, loop_closing, keyframe_database, dict(device="cpu")


def trace(pkg: str, name: str, parity: bool = True, threads: int | None = None) -> dict:
    """Run scenario `name` of SCENARIOS in `pkg`; returns
    the run's results, the per-frame log and the closer's log. `threads`
    sets torch's intra-op thread count for the run (the order of the port's
    CPU reductions)."""
    mod, map_store, extraction, lc, kdb, kw = _package(pkg)
    L = lc.LoopClosing
    frame = [-1]
    log = {"closures": [], "closer": [], "per_frame": []}
    cur: dict = {}
    real = {a: getattr(L, a) for a in ("run_once", "_match_keyframes", "_solve_sim3",
                                       "correct_loop")}
    real_nbest = kdb.KeyFrameDatabase.detect_n_best_candidates

    def run_once(self):
        if not self.queue:
            return real["run_once"](self)
        kf = self.queue[0]
        cur.clear()
        cur.update(frame=frame[0], kf=int(kf.id), t=float(kf.timestamp),
                   n_kf=self.map.n_keyframes(),
                   pending=None if self.candidate is None else int(self.candidate.id),
                   coincidences=self.n_coincidences, misses=self.n_not_found, tries=[])
        out = real["run_once"](self)
        log["closer"].append(dict(cur))
        return out

    def nbest(self, kf, n=3, exclude=None):
        out = real_nbest(self, kf, n, exclude)
        ex = [self.kfs[i] for i in exclude or () if i in self.kfs and i != kf.id]
        cur.update(candidates=[int(c.id) for c in out],
                   excluded_t=sorted(float(k.timestamp) for k in ex))
        return out

    def match(self, kf1, kf2):
        out = real["_match_keyframes"](self, kf1, kf2)
        cur.setdefault("tries", []).append(
            {"cand": int(kf2.id), "cand_t": float(kf2.timestamp), "matches": len(out[0][0])})
        return out

    def solve(self, kf1, kf2, rec1, rec2):
        out = real["_solve_sim3"](self, kf1, kf2, rec1, rec2)
        cur["tries"][-1].update(inliers=int(out[1]), solved=out[0] is not None)
        return out

    def correct(self, kf, loop_kf, S12):
        log["closures"].append({"frame": frame[0], "kf": int(kf.id), "t": float(kf.timestamp),
                                "loop_kf": int(loop_kf.id), "loop_t": float(loop_kf.timestamp)})
        return real["correct_loop"](self, kf, loop_kf, S12)

    class Traced(mod.System):
        def track_multicamera(self, fr):
            frame[0] += 1
            st = super().track_multicamera(fr)
            m = self.atlas.active
            log["per_frame"].append({"state": st.name, "n_kf": m.n_keyframes(),
                                     "n_mp": m.n_map_points()})
            return st

    with ExitStack() as stack:
        for attr, fn in (("run_once", run_once), ("_match_keyframes", match),
                         ("_solve_sim3", solve), ("correct_loop", correct)):
            stack.enter_context(mock.patch.object(L, attr, fn))
        stack.enter_context(mock.patch.object(kdb.KeyFrameDatabase,
                                              "detect_n_best_candidates", nbest))
        stack.enter_context(mock.patch.object(mod, "System", Traced))
        if parity:
            from amcslam_tpu_torch import native

            stack.enter_context(mock.patch.dict(os.environ, {"AMCSLAM_NO_BUCKET_PRESET": "1"}))
            stack.enter_context(mock.patch.object(map_store, "_ids",
                                                  itertools.count(ID_START)))
            extraction.reset_bucket_high_water()
            if pkg == "ref":
                from amcslam_tpu import native as ref_native

                assert ref_native.available("orb_fast")
                stack.enter_context(mock.patch.object(ref_native, "orb_extract",
                                                      native.orb_extract))
        if threads is not None:
            import torch

            stack.callback(torch.set_num_threads, torch.get_num_threads())
            torch.set_num_threads(threads)
        collect: dict = {}
        t0 = time.perf_counter()
        ate, dist, n_loops = mod.run(collect=collect, **SCENARIOS[name], **kw)
        seconds = time.perf_counter() - t0
    m = collect["system"].atlas.active
    return {"ate": float(ate), "dist": float(dist), "n_loops": int(n_loops),
            "seconds": seconds, "states": [s.name for s in collect["states"]],
            "n_kf": m.n_keyframes(),
            "loop_edge_records": sum(len(k.loop_edges) for k in m.keyframes.values()) // 2,
            "kf_times": sorted(float(k.timestamp) for k in m.keyframes.values()),
            "est": collect["est"], "gt": collect["gt"], "timing": collect["timing"],
            "system": collect["system"], **log}


def why_dropped(rec: dict, try_: dict, min_matches: int) -> str:
    """Why a tried candidate did not close (or what it did)."""
    if try_["matches"] < min_matches:
        return f"{try_['matches']} matches < {min_matches}: no Sim3 solve"
    if not try_.get("solved") or try_.get("inliers", 0) < min_matches:
        return f"Sim3: {try_.get('inliers', 0)} inliers < {min_matches}"
    if rec["pending"] is None:
        return "verified: pending hypothesis (1 coincidence)"
    return f"verified the pending hypothesis ({rec['coincidences'] + 1} coincidences)"


def spans(ts: list, step: float = 0.2) -> str:
    """Sorted keyframe times as runs of consecutive frames: '0.0-1.2, 14.0'."""
    out, start = [], None
    for i, t in enumerate(ts):
        if start is None:
            start = t
        if i + 1 == len(ts) or ts[i + 1] - t > step + 1e-6:
            out.append(f"{start:.1f}" if t == start else f"{start:.1f}-{t:.1f}")
            start = None
    return ", ".join(out) or "none"


def candidate_lines(run: dict, from_frame: int, min_matches: int = 20) -> list[str]:
    lines = []
    for rec in run["closer"]:
        if rec["frame"] < from_frame:
            continue
        head = (f"frame {rec['frame']} kf {rec['kf']} t={rec['t']:.1f} "
                f"({rec['n_kf']} KF)")
        if rec["n_kf"] < 12:
            lines.append(head + ": under the 12-keyframe guard")
            continue
        if rec["pending"] is not None:
            head += (f" pending {rec['pending']} ({rec['coincidences']} coincidences, "
                     f"{rec['misses']} misses)")
        else:
            head += (f" database: {rec.get('candidates', [])}, covisible excluded at t = "
                     f"{spans(rec.get('excluded_t', []))}")
        lines.append(head)
        if rec["pending"] is not None and not rec["tries"]:
            lines.append("    (no try)")
        for t in rec["tries"]:
            lines.append(f"    cand {t['cand']} t={t['cand_t']:.1f}: "
                         + why_dropped(rec, t, min_matches))
    return lines


def summary(pkg: str, name: str, run: dict) -> str:
    return json.dumps({"pkg": pkg, "scenario": name, "ate_m": run["ate"], "path_m": run["dist"],
                       "closures": run["closures"], "loop_edge_records": run["loop_edge_records"],
                       "n_kf": run["n_kf"], "seconds": run["seconds"],
                       # the threaded pin's statistic (tests/test_e2e_scenarios.py:196)
                       "track_ms_median_from_frame_10":
                           float(np.median(run["timing"]["track_ms"][10:])),
                       "states": run["states"]})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--pkg", action="append", choices=("ref", "port"))
    ap.add_argument("--own", action="store_true", help="each package as its own test runs it")
    ap.add_argument("--from-frame", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if "ref" in (args.pkg or ["ref"]):
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)   # as tests/conftest.py
    for pkg in args.pkg or ["ref", "port"]:
        run = trace(pkg, args.scenario, parity=not args.own)
        print(summary(pkg, args.scenario, run))
        print("\n".join(candidate_lines(run, args.from_frame)), flush=True)


if __name__ == "__main__":
    main()
