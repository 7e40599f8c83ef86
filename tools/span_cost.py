#!/usr/bin/env python3
"""Host cost of one span of a checkout's stage timer, on this machine's CPU.

    python3 tools/span_cost.py [--root DIR] [--n N] [--repeats R]

loads `amcslam_tpu_torch/utils/timing.py` from DIR (default: this checkout)
as a module of its own, and times N spans (enter and exit) of a fresh
`StageTimer`, nested three deep as the pipeline's are (a frame, a stage, a
read), less the same loop around a null context. Reports the median over R
repeats of ns per span, enabled and disabled, and prints one JSON line.
Two timers are compared by running this for each checkout in turns within
one command (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


def load_timing(root: Path):
    path = root / "amcslam_tpu_torch" / "utils" / "timing.py"
    spec = importlib.util.spec_from_file_location(f"timing_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_ns(span, n: int) -> float:
    """ns for n // 3 rounds of three nested spans."""
    t0 = time.perf_counter_ns()
    for _ in range(n // 3):
        with span("frame"):
            with span("stage"):
                with span("read"):
                    pass
    return float(time.perf_counter_ns() - t0)


def per_span(make_span, n: int, repeats: int) -> float:
    null = contextlib.nullcontext()
    base, timed = [], []
    for _ in range(repeats):
        base.append(loop_ns(lambda name: null, n))
        timed.append(loop_ns(make_span(), n))
    spans = 3 * (n // 3)
    return (statistics.median(timed) - statistics.median(base)) / spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, default=300_000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    timing = load_timing(Path(args.root))

    def fresh(enabled):
        def make():
            return timing.StageTimer(enabled=enabled).span
        return make

    out = {"root": args.root, "python": sys.version.split()[0], "spans": 3 * (args.n // 3),
           "ns_per_span": per_span(fresh(True), args.n, args.repeats),
           "ns_per_span_disabled": per_span(fresh(False), args.n, args.repeats)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
