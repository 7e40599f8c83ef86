"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (`benchmark/configs/`) and its traffic mix
(`benchmark/mixes/<traffic>.json`); the mix's `kind` names the module under
`benchmark/traffic/` that drives the program; each metric's name names its
reader under `benchmark/metrics/`; the limits of the comparison that decides
`correct` are in `benchmark/limits/<cell>.json`. Nothing here names a cell,
a configuration or a metric.

A run: set-up (the traffic generated from the seed, the program built and
warmed on the cell's own shapes), then a window of `--seconds` that closes
at the end of the first frame or solve that ends after it, then the
comparison of what the window produced with the plain reference. With
`--trace 1` the card is profiled over the mix's `trace_seconds` at the
window's start and the per-layer metrics are reported; with `--trace 0`
the end-to-end ones. The last line of standard output is the result; the
last lines of standard error are the numbers compared, each beside its
limit.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "amcslam_tpu"})
TOP = 10  # entries of each breakdown list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(spec: dict, cell: dict) -> dict:
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return load_json(ROOT / entry["file"])


def mix_of(cell: dict) -> dict:
    return load_json(BENCH_DIR / "mixes" / f"{cell['traffic']}.json")


def limits_of(cell: dict) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{cell['name']}.json")


def metrics_of(spec: dict, cell: dict, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones: those
    without a `workloads` key and those whose key lists the cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    """The reader of metric `name`: `read` of benchmark/metrics/<family>.py,
    the family being the name up to its first dot."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}").read


def kind_module(mix: dict):
    return importlib.import_module(f"benchmark.traffic.{mix['kind']}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (up to the first dot) is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(session, seconds: float, device, trace_seconds: float | None) -> dict:
    """Drive `session` for `seconds`, closing at the end of the first unit
    that ends after them (or where the traffic runs out). With
    `trace_seconds`, the card is profiled from the window's start to the end
    of the first unit that ends after that; the profiler starts (its first
    start takes seconds) before the window does."""
    from benchmark import probe
    from benchmark.trace import DeviceTrace

    sync(device)
    tracer = DeviceTrace(probe.timer()) if trace_seconds else None
    trace = None
    if tracer is not None:
        tracer.start()
    snap = probe.snapshot()
    units = []
    exhausted = False
    t0 = time.perf_counter()
    end = t0
    while True:
        a = time.perf_counter()
        unit = session.step()
        b = time.perf_counter()
        if unit is None:
            exhausted = True
            break
        unit.update(start_s=a - t0, ms=(b - a) * 1e3)
        units.append(unit)
        end = b
        if tracer is not None and trace is None and b - t0 >= trace_seconds:
            trace = tracer.stop()
            trace.update(units=len(units), **probe.since(snap))
        if b - t0 >= seconds:
            break
    if tracer is not None and trace is None:
        trace = tracer.stop()
        trace.update(units=len(units), **probe.since(snap))
    return {"unit": session.unit, "dtype": session.dtype_name, "setup_s": t0 - T_PROCESS,
            "window_s": end - t0,
            "units": units, "exhausted": exhausted, "trace": trace, **probe.since(snap)}


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or below it); a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name)
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= spec["limit"]
        # the result line is strict JSON: a number that is not finite reads null
        checks[name] = {"value": value if finite else None, "limit": spec["limit"]}
    return ok, checks


def breakdown(trace: dict) -> dict:
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"device_ops": top(trace["kernel_s"]), "idle_gaps": top(trace["idle_by_span"])}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", control: bool = False, config: dict | None = None,
             mix: dict | None = None, limits: dict | None = None, log=None) -> dict:
    """One run of `cell`; returns the result object. `config`, `mix` and
    `limits` replace the cell's files (the tests' smaller sizes); `control`
    runs the program with its float32 products in TF32 (`benchmark.control`)."""
    import torch

    from benchmark import host
    from benchmark.control import tf32_products

    log = log or (lambda **kw: print(json.dumps(kw), flush=True))
    config = config or config_of(spec, cell)
    mix = mix or mix_of(cell)
    limits = limits or limits_of(cell)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    host0 = host.sample()
    session = kind_module(mix).Session(config, mix, seed, device)
    with tf32_products() if control else contextlib.nullcontext():
        session.warm()
        rec = run_window(session, seconds, device, mix.get("trace_seconds") if trace else None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(event="host", threads=torch.get_num_threads(), **host.between(host0, host.sample()))
    if rec["trace"] is not None:
        log(event="trace", **{k: v for k, v in rec["trace"].items()
                              if k not in ("kernel_s", "idle_by_span", "spans")})
    if rec["exhausted"]:
        log(event="traffic_exhausted", units=len(rec["units"]), window_s=rec["window_s"])
    log(event="run", cell=cell["name"], seed=seed, seconds=seconds, trace=bool(trace),
        control=control, setup_s=rec["setup_s"], window_s=rec["window_s"],
        units=len(rec["units"]), graphs=rec["graphs"], memory_peak_bytes=peak,
        span_ms={k: 1e3 * sum(v) for k, v in sorted(rec["spans"].items())},
        **session.summary(rec))

    metrics = {}
    for m in metrics_of(spec, cell, trace):
        value = reader(m["name"])(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = session.check()  # frees the program's state, then runs the reference
    ok, checks = compare(numbers, limits)
    log(event="check", seconds=time.perf_counter() - t_check,
        numbers={k: v for k, v in numbers.items() if k not in checks})

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": len(rec["units"]),
              "failed": sum(bool(u["failed"]) for u in rec["units"]),
              "metrics": metrics, "device": device_info}
    if trace and rec["trace"] is not None:
        device_info.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        result["breakdown"] = breakdown(rec["trace"])
    result["checks"] = checks
    return result


def main(argv=None, control: bool = False) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of kernels built at run time: fixed directories inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    spec = load_spec()
    cell = cell_of(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell['chips']} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), control=control)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
