"""Profile of the matrix-free PCG solvers at scale, beside a byte bound.

Port of `examples/profile_pcg.py` for bench configs 5c (the 5,000-KF Sim3
essential graph, `sim3_opt.make_essential_graph_problem_pcg`) and 5d (the
2,000-KF / 10k-landmark global BA, `solver/ba.make_ba_problem_pcg`), float32.
For each it reports:

  * CG steps per LM iteration (the `_pcg` / `PCGStep` counts);
  * ms per LM iteration (linearize -> solve -> retract -> chi2, from the
    same state, host clock behind a sync) against the forcing tolerance and
    the CG cap, and for 5d against the preconditioner;
  * ms per CG step from a forced-cap pair (tolerance 0, caps 20 and 80: the
    slope is the step, the intercept the fixed part), beside the least
    time a step could take on the card: its bytes at HBM_BYTES_PER_S or its
    FLOP at the dtype's peak, the larger (`cg_step_bound`,
    `eg_cg_step_bound`).

    python -m amcslam_tpu_torch.examples.profile_pcg [--device cuda|cpu]

Prints one JSON line. The bounds use the H100 SXM's data-sheet rates.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..pipeline.tracking import resolve_device
from ..solver import ba, sim3_opt
from ..utils.synthetic import make_essential_graph, make_local_ba_problem

HBM_BYTES_PER_S = 3.35e12                                # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside the tensor cores

CONFIG_5C = dict(n_kf=5000, n_loop=40, seed=0)             # bench.py's config 5c
CONFIG_5D = dict(n_kf=2000, n_fixed=1, n_lm=10000, n_cams=6, obs_per_lm=4, gpobs_per_lm=0,
                 noise_px=0.5, seed=0)                      # bench.py's config 5d
TOLS = (1e-2, 1e-3, 1e-4)
CAPS_5D = (40, 100, 400)
CAP_5C = 100
LAM_5C = 1e-8
LAM_5D = 1e-3
SPLIT_CAPS = (20, 80)


def _bound(nbytes: int, flop: int, dtype) -> dict:
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_flop = flop / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(ms_bytes, ms_flop),
            "bound_by": "bytes" if ms_bytes >= ms_flop else "operations",
            "bytes": nbytes, "flop": flop}


def cg_step_bound(data, lin) -> dict:
    """The least time one CG step of make_ba_problem_pcg could take on this
    problem: the Schur product S p and the preconditioner read every edge
    Jacobian, weight and index once (the three landmark edge families, the
    GP chain's J1, J2 and Omega), the landmark blocks (Hll^-1) and the
    per-pose 12x12 preconditioner blocks once, and read and write the CG
    vectors (x, r, p, z, S p: five (K,12) reads and writes), over HBM
    bandwidth; its FLOP (two products with each pose Jacobian, two with
    each landmark Jacobian, four 12x12 products per GP edge, the 3x3 and
    12x12 block products) over the dtype's peak; the larger of the two."""
    edges, Hll, _, bp12, bext, D12, Dext, _, _ = lin
    flat = [t for fam in edges for t in fam]
    index = [data.mg_pair, data.mg_cam, data.mg_lm, data.sg_pair, data.sg_lm, data.st_pose,
             data.st_lm, data.gp_pairs]
    nbytes = (sum(t.numel() * t.element_size() for t in flat + index + [Hll, D12, Dext])
              + 10 * (bp12.numel() + bext.numel()) * bp12.element_size())
    (J1m, J2m, Jem, Jlm, _), (J1g, J2g, Jlg, _), (J3, Jls, _), (J1p, J2p, Om) = edges
    pose_jac = sum(t.numel() for t in (J1m, J2m, Jem, J1g, J2g, J3))
    flop = (4 * pose_jac + 4 * sum(t.numel() for t in (Jlm, Jlg, Jls))
            + 4 * 2 * J1p.numel() + 2 * 2 * Om.numel() + 2 * 9 * Hll.shape[0]
            + 2 * D12.numel())
    return _bound(nbytes, flop, bp12.dtype)


def eg_cg_step_bound(data, lin) -> dict:
    """The least time one CG step of make_essential_graph_problem_pcg could
    take: H p reads each edge's two (7,7) Jacobian blocks and its pair once,
    the preconditioner reads the (N,7,7) inverted blocks once, and the CG
    vectors (x, r, p, z, H p) are read and written once each; its FLOP are
    four products with each Jacobian block and two with each preconditioner
    block."""
    Ji, Jj, D, b, _ = lin
    nbytes = (sum(t.numel() * t.element_size() for t in (Ji, Jj, D, data.pairs))
              + 10 * b.numel() * b.element_size())
    flop = 4 * (Ji.numel() + Jj.numel()) + 2 * D.numel()
    return _bound(nbytes, flop, b.dtype)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, n: int) -> float:
    """ms per call over n calls after one warm-up (host clock behind a sync)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / n


def _eg_step(data, lam, cap, tol):
    """One LM iteration of the PCG essential graph from a state: its CG step
    count comes back from `_pcg` with the step."""
    p = sim3_opt.make_essential_graph_problem_pcg(data, cap, tol)
    i_, j_ = data.pairs[:, 0], data.pairs[:, 1]

    def step(state):
        Ji, Jj, D, b, act = lin = p.linearize(state)
        x, steps, rel = sim3_opt._pcg(Ji, Jj, i_, j_, D, b, act, lam, cap, tol)
        s2 = p.retract(state, x.reshape(-1))
        return p.chi2(s2), steps, rel, lin

    return step


def profile_eg(device, config=CONFIG_5C, tols=TOLS, cap=CAP_5C, split_caps=SPLIT_CAPS,
               n_timed=5, dtype=torch.float32) -> dict:
    """Config 5c: ms and CG steps per LM iteration against the tolerance;
    ms per CG step from the forced-cap pair, beside its bound."""
    data, state0, _ = make_essential_graph(**config, dtype=dtype, device=device)
    lam = torch.tensor(LAM_5C, dtype=dtype, device=device)
    rows = []
    for tol in tols:
        step = _eg_step(data, lam, cap, tol)
        chi, steps, rel, lin = step(state0)
        rows.append({"tol": tol, "cap": cap, "cg_steps": steps, "rel_res": rel,
                     "chi2_after": float(chi), "ms_per_lm_iteration":
                     _ms(lambda: step(state0), device, n_timed)})
    split = {c: _ms(lambda: _eg_step(data, lam, c, 0.0)(state0), device, n_timed)
             for c in split_caps}
    a, b = split_caps
    per_step = (split[b] - split[a]) / (b - a)
    return {"config": config, "N": config["n_kf"], "E": int(data.pairs.shape[0]),
            "lambda": LAM_5C, "by_tolerance": rows,
            "forced_caps_ms": {str(c): v for c, v in split.items()},
            "ms_per_cg_step": per_step, "fixed_ms": split[a] - a * per_step,
            "cg_step_bound": eg_cg_step_bound(data, lin)}


def profile_global_ba(device, config=CONFIG_5D, tols=TOLS, caps=CAPS_5D,
                      split_caps=SPLIT_CAPS, n_timed=3, dtype=torch.float32) -> dict:
    """Config 5d: ms and CG steps per LM iteration against the tolerance and
    the cap, both preconditioners at the bench's setting (the first cap and
    the middle tolerance); ms per CG step from the forced-cap pair, beside
    its bound."""
    data, state0, _ = make_local_ba_problem(**config, dtype=dtype, device=device)
    data = data._replace(gp_huber=torch.tensor(True, device=device))
    lam = torch.tensor(LAM_5D, dtype=dtype, device=device)

    def make(cap, tol, precond="jacobi"):
        p = ba.make_ba_problem_pcg(data, data.mg_valid, data.sg_valid, data.st_valid,
                                   pcg_iters=cap, pcg_tol=tol, precond=precond)

        def step(state):
            lin = p.linearize(state)
            dx, _, _ = p.solve(lin, lam)
            return p.chi2(p.retract(state, dx)), dx, lin

        return step

    rows = []
    settings = [(t, c, "jacobi") for t in tols for c in caps]
    settings.append((tols[len(tols) // 2], caps[0], "schur_jacobi"))
    for tol, cap, precond in settings:
        step = make(cap, tol, precond)
        chi, dx, lin = step(state0)
        rows.append({"tol": tol, "cap": cap, "precond": precond, "cg_steps": dx.cg_steps,
                     "rel_res": dx.rel_res, "chi2_after": float(chi),
                     "ms_per_lm_iteration": _ms(lambda: step(state0), device, n_timed)})
    split = {c: _ms(lambda: make(c, 0.0)(state0), device, n_timed) for c in split_caps}
    a, b = split_caps
    per_step = (split[b] - split[a]) / (b - a)
    return {"config": config, "K": data.n_poses, "L": int(state0.X.shape[0]),
            "Es": int(data.st_obs.shape[0]), "lambda": LAM_5D, "runs": rows,
            "forced_caps_ms": {str(c): v for c, v in split.items()},
            "ms_per_cg_step": per_step, "fixed_ms": split[a] - a * per_step,
            "cg_step_bound": cg_step_bound(data, lin)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"profile": "pcg", "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu", "dtype": "float32",
           "config_5c": profile_eg(dev), "config_5d": profile_global_ba(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
