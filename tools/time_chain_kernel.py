#!/usr/bin/env python3
"""Device time per launch of one checkout's GP-chain kernel, on one GPU.

    python3 tools/time_chain_kernel.py [--root DIR]

imports `amcslam_tpu_torch` from DIR (default: this checkout), builds its
`csrc/interp_chain.cu` and times its public per-row entry `gp_interp_packs`
at the sizes `System.track_multicamera` launches the chain: a tracked frame's
pose pair (S = 6), a local-BA window's combo bucket (S = 256) and the
headline window of `chip_smoke.py` (S = 1024, float32 and float64). The
inputs are the headline window's combos (`make_local_ba_problem_numpy`, the
same arrays in every checkout since the port's first slice). Each time is
CUDA events around 200 launches queued behind a spin kernel, so the host's
cost per call is hidden. Prints one JSON line.

Two kernels are compared on one card by running this for each checkout in
turns within one command, e.g. for the parent commit unpacked into a
git-ignored directory:

    for r in build/ab/parent . . build/ab/parent; do
        python3 tools/time_chain_kernel.py --root $r; done
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HEADLINE = dict(n_kf=50, n_fixed=1, n_lm=5000, n_cams=6, obs_per_lm=4,
                gpobs_per_lm=2, noise_px=0.5, seed=0)   # chip_smoke.py phase 4
KEYS = ("Twb", "Tbw", "Q")


def time_device(launch, n=200) -> float:
    """Device ms per launch (chip_smoke.py's `time_device`)."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * enqueue_s * 2e9))
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def sizes(convert, ba, make_problem, device) -> dict:
    """{name: per-row chain inputs} at the System's sizes."""
    dn, sn, _ = make_problem(**HEADLINE)
    data, state = convert.ba_from_numpy(dn, sn, device=device, dtype=torch.float32)
    i, j = ba._combo_ends(data, data.mg_sid_cols, data.mg_it_sid)
    rows = (state.T[i], state.v[i], state.T[j], state.v[j], data.times[i], data.times[j],
            data.mg_it_t)
    t1, t2 = rows[4][0], rows[5][0]
    pair = tuple(a[:1].expand(6, *a.shape[1:]) for a in rows[:6])
    pair += (t1 + torch.linspace(0.0, 1.0, 6, device=device) * (t2 - t1),)
    out = {"pair_6": pair, "rows_256": tuple(a[:256] for a in rows), "rows_1024": rows,
           "rows_1024_f64": tuple(a.double() for a in rows)}
    return {k: tuple(a.contiguous() for a in v) for k, v in out.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    root = parser.parse_args().root.resolve()
    if not torch.cuda.is_available():
        raise RuntimeError("time_chain_kernel: no CUDA device")
    sys.path.insert(0, str(root))
    from amcslam_tpu_torch import _build, convert
    from amcslam_tpu_torch.ops import interp_chain
    from amcslam_tpu_torch.solver import ba
    from amcslam_tpu_torch.utils.synthetic import make_local_ba_problem_numpy
    if not Path(interp_chain.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {interp_chain.__file__}, not from {root}")
    res = _build.build("interp_chain")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    rec = {"root": str(root), "card": smi,
           "source_sha256": hashlib.sha256((_build.CSRC_DIR / "interp_chain.cu").read_bytes()
                                           ).hexdigest()[:16],
           "ptxas": [ln.strip() for ln in res.log.splitlines() if "registers" in ln or "spill" in ln],
           "sizes": {}}
    for name, args in sizes(convert, ba, make_local_ba_problem_numpy, device).items():
        got = interp_chain.gp_interp_packs(*args)
        args64 = tuple(a.double() for a in args)
        got64 = interp_chain.gp_interp_packs(*args64)
        ref64 = interp_chain.gp_interp_packs_ref(*args64)
        f64 = max(float(((got64[k] - ref64[k]).abs() / (1.0 + ref64[k].abs())).max())
                  for k in KEYS)
        rec["sizes"][name] = {
            "S": int(args[-1].shape[0]), "dtype": str(args[-1].dtype).split(".")[-1],
            "device_ms": time_device(lambda: interp_chain.gp_interp_packs(*args)),
            "f64_max_rel_vs_plain": f64,
            "output_sha256": hashlib.sha256(b"".join(got[k].cpu().numpy().tobytes()
                                                     for k in KEYS)).hexdigest()[:16],
        }
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
