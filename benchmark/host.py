"""What the host was doing around a run, for the earlier lines of its output:
a fixed piece of pure-Python work and one of small numpy operations (the
kind the program's host code runs) timed, the machine's steal and busy
shares from `/proc/stat`, and the process's context switches. A run whose
frames are slow on a host that is slow reads slow here too. No metric reads
this."""

from __future__ import annotations

import os
import resource
import time

import numpy as np


def _cpu_ticks() -> list[int]:
    """user nice system idle iowait irq softirq steal, summed over the cpus."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except OSError:
        return [0] * 8


def _python_ms() -> float:
    t = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += (i * 7) % 13
    return (time.perf_counter() - t) * 1e3


def _numpy_ms() -> float:
    a = np.linspace(0.0, 1.0, 36).reshape(6, 6)
    b = np.linspace(1.0, 2.0, 600)
    t = time.perf_counter()
    for _ in range(4000):
        c = a @ a
        b = np.sqrt(b * b + c[0, 0] * 1e-9)
    return (time.perf_counter() - t) * 1e3


def sample() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "ticks": _cpu_ticks(),
            "python_ms": _python_ms(), "numpy_ms": _numpy_ms(),
            "cpu_s": ru.ru_utime + ru.ru_stime,
            "voluntary_switches": ru.ru_nvcsw, "involuntary_switches": ru.ru_nivcsw}


def between(a: dict, b: dict) -> dict:
    """The host over the interval from sample `a` to sample `b`."""
    d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
    total = max(sum(d), 1)
    return {"python_ms": [a["python_ms"], b["python_ms"]],
            "numpy_ms": [a["numpy_ms"], b["numpy_ms"]],
            "steal_pct": 100.0 * d[7] / total,
            "machine_busy_pct": 100.0 * (total - d[3] - d[4]) / total,
            "process_cpu_pct": 100.0 * (b["cpu_s"] - a["cpu_s"]) / max(b["t"] - a["t"], 1e-9),
            "voluntary_switches": b["voluntary_switches"] - a["voluntary_switches"],
            "involuntary_switches": b["involuntary_switches"] - a["involuntary_switches"],
            "cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
