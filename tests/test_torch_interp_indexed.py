"""The GP chain's indexed and pair entries (`ops/interp_chain.py`) and the two
callers that take them (`_interp_packs` of solver/ba.py and of
solver/pose_solver.py).

`gp_interp_packs_indexed` reads each combo's endpoint states from one state
table by row index (the local BA's combos); `gp_interp_packs_pair` reads one
pose pair for every combo (the pose solver's table branch). Their plain
versions (what CPU tensors run, and what `chip_smoke.py` holds the CUDA
kernel against on the card) are compared with the reference's fused Pallas
kernel in interpret mode (`amcslam_tpu/ops/pallas_chain.py`) and with its
pure-JAX path vmap(gp_pair_pack) + vmap(gp_interp_pack), on tables whose
gathered rows are tests/test_pallas_chain.py `_random_case` (generic,
near-pi, tiny): float64 to max |a-b|/(1+|b|) <= 1e-12. The callers must give
the same bits as the gathered / expanded path they replace, and hand the
kernel the state tables themselves. The CUDA kernel runs only on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.ops import pallas_chain
from amcslam_tpu_torch import _build, convert
from amcslam_tpu_torch.ops import interp_chain
from amcslam_tpu_torch.solver import ba, pose_solver
from amcslam_tpu_torch.utils.synthetic import (make_local_ba_problem_numpy,
                                               make_pose_problem_numpy)
from test_torch_interp_chain import KEYS, jax_packs, max_rel, random_case

F64 = torch.float64


def table_form(args, seed=0):
    """(T, v, times, i, j, t) whose gathered rows T[i], T[j], ... are the
    per-row inputs `args`: both endpoints' rows in one shuffled table, plus
    three rows that no combo reads."""
    T1, v1, T2, v2, t1, t2, t = (torch.tensor(a) for a in args)
    S = t.shape[0]
    extra = torch.tensor(random_case(seed + 1, 3)[0])
    T = torch.cat([T1, T2, extra])
    v = torch.cat([v1, v2, torch.zeros(3, 6, dtype=F64)])
    times = torch.cat([t1, t2, torch.zeros(3, dtype=F64)])
    perm = torch.randperm(2 * S + 3, generator=torch.Generator().manual_seed(seed))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(2 * S + 3)
    return T[perm], v[perm], times[perm], inv[:S], inv[S:2 * S], t


def pair_form(args):
    """The first combo's pose pair at 6 times inside its interval, as the
    pair entry takes it (T (2,4,4), v (2,6), t1, t2, t), and as per-row
    arrays for the references."""
    T1, v1, T2, v2, t1, t2, _ = args
    t = t1[0] + np.linspace(0.0, 1.0, 6) * (t2[0] - t1[0])
    pair = tuple(torch.tensor(a) for a in (np.stack([T1[0], T2[0]]), np.stack([v1[0], v2[0]]),
                                           t1[0], t2[0], t))
    rows = tuple(np.broadcast_to(a, (6, *np.shape(a))).copy()
                 for a in (T1[0], v1[0], T2[0], v2[0], t1[0], t2[0])) + (t,)
    return pair, rows


@pytest.mark.parametrize("case", ["generic", "near_pi", "tiny"])
@pytest.mark.parametrize("form", ["indexed", "pair"])
def test_entry_plain_matches_reference_f64(form, case):
    args = random_case(5, 37, near_pi=case == "near_pi", tiny=case == "tiny")
    if form == "indexed":
        got = interp_chain.gp_interp_packs_indexed(*table_form(args))
        rows = args
    else:
        pair, rows = pair_form(args)
        got = interp_chain.gp_interp_packs_pair(*pair)
    ref_jax = jax_packs(rows, jnp.float64)
    ref_pallas = pallas_chain.gp_interp_packs(*(jnp.asarray(a) for a in rows), interpret=True)
    for k in KEYS:
        assert got[k].dtype == F64
        assert max_rel(got[k], ref_jax[k]) <= 1e-12, (form, case, k)
        assert max_rel(got[k], ref_pallas[k]) <= 1e-12, (form, case, k)


def ba_case():
    dn, sn, _ = make_local_ba_problem_numpy(n_kf=6, n_fixed=1, n_lm=48, n_cams=3, obs_per_lm=3,
                                            gpobs_per_lm=2, seed=0)
    data, state = convert.ba_from_numpy(dn, sn)
    sid_cols, it_sid, it_t = data.mg_sid_cols, data.mg_it_sid, data.mg_it_t

    def new():
        return ba._interp_packs(data, state, sid_cols, it_sid, it_t)

    def old():
        i_u, j_u = ba._combo_ends(data, sid_cols, it_sid)
        return interp_chain.gp_interp_packs(
            state.T[i_u], state.v[i_u], state.T[j_u], state.v[j_u],
            data.times[i_u], data.times[j_u], it_t)

    return new, old, (state.T, state.v, data.times)


def pose_case():
    dn, sn, _ = make_pose_problem_numpy(n_mono=48, n_stereo=24, n_cams=4, seed=0)
    mg_it, it_t = pose_solver.interp_table(dn["mg_t"])
    data, state = convert.pose_from_numpy({**dn, "mg_it": mg_it, "it_t": it_t}, sn)

    def new():
        return pose_solver._interp_packs(data, state)

    def old():
        U = data.it_t.shape[0]
        T1, v1, T2, v2, t1, t2 = (a.expand(U, *a.shape).contiguous() for a in (
            state.T[0], state.v[0], state.T[1], state.v[1], data.t_prev, data.t_cur))
        return interp_chain.gp_interp_packs(T1, v1, T2, v2, t1, t2, data.it_t)

    return new, old, (state.T, state.v, data.t_prev)


@pytest.mark.parametrize("caller", ["ba", "pose"])
def test_callers_match_the_path_they_replace(caller, monkeypatch):
    """Bit for bit on the CPU, and the entry is handed the state tables
    themselves, not gathered or expanded copies."""
    new, old, (T, v, t) = (ba_case if caller == "ba" else pose_case)()
    got, want = new(), old()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), (caller, k)
    seen = {}
    name = "gp_interp_packs_indexed" if caller == "ba" else "gp_interp_packs_pair"
    entry = getattr(interp_chain, name)

    def spy(*args):
        seen["args"] = args
        return entry(*args)

    monkeypatch.setattr(interp_chain, name, spy)
    new()
    a = seen["args"]
    assert a[0] is T and a[1] is v and a[2] is t


@pytest.mark.parametrize("bad", ["int32", "float", "negative", "past_end"])
def test_indexed_entry_rejects_bad_indices(bad):
    T, v, times, i, j, t = table_form(random_case(7, 5))
    if bad == "int32":
        i = i.to(torch.int32)
    elif bad == "float":
        j = j.to(F64)
    elif bad == "negative":
        i = i.clone()
        i[2] = -1
    else:
        j = j.clone()
        j[4] = T.shape[0]
    with pytest.raises(ValueError):
        interp_chain.gp_interp_packs_indexed(T, v, times, i, j, t)


@pytest.mark.parametrize("bad", ["one_pose", "times_2d", "index_length"])
def test_entries_reject_bad_shapes(bad):
    args = random_case(9, 4)
    if bad == "index_length":
        T, v, times, i, j, t = table_form(args)
        with pytest.raises(ValueError):
            interp_chain.gp_interp_packs_indexed(T, v, times, i[:3], j, t)
        return
    pair, _ = pair_form(args)
    pair = list(pair)
    if bad == "one_pose":
        pair[0] = pair[0][:1]
    else:
        pair[4] = pair[4][None]
    with pytest.raises(ValueError):
        interp_chain.gp_interp_packs_pair(*pair)


def test_kernel_path_refuses_cpu_tensors():
    """The kernel launch path takes CUDA tensors only; it never runs the
    plain version in their place."""
    T1, v1, T2, v2, t1, t2, t = (torch.tensor(a) for a in random_case(11, 3))
    with pytest.raises(ValueError, match="runs on cuda"):
        interp_chain._launch((T1, v1, t1, None, 1, 0), (T2, v2, t2, None, 1, 0), t)


def test_library_is_bound_once(monkeypatch):
    """The kernel library is loaded and its argument types set on first use
    only, not on every call."""
    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(**{fn: types.SimpleNamespace() for fn in (
            *interp_chain._FN.values(), "interp_chain_empty")})

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(interp_chain, "_LIB", None)
    lib = interp_chain._library()
    assert interp_chain._library() is lib and loads == ["interp_chain"]
    for fn in interp_chain._FN.values():
        assert getattr(lib, fn).argtypes == interp_chain._SIGNATURE
    assert lib.interp_chain_empty.argtypes is not None


@pytest.mark.parametrize("s", [-2.5, -15.0, -60.0])
def test_padded_combo_tolerance_holds_the_reference(s):
    """`chip_smoke.check_padded` holds the kernel's padded combos (the local
    BA's dump combo: query time 0, far before its interval) to 10x the plain
    version's change under a 4-ulp perturbation of its inputs. The reference's
    own float64 paths, pure JAX and the Pallas kernel in interpret mode, stay
    inside that tolerance; away from the interval they differ from the plain
    version by more than the live combos' 1e-12."""
    import chip_smoke

    T1, v1, T2, v2, _, _, _ = random_case(13, 16)
    t1 = np.full(16, -s * 0.2)
    rows = (T1, v1, T2, v2, t1, t1 + 0.2, np.zeros(16))
    args64 = tuple(torch.tensor(np.asarray(a, np.float64)) for a in rows)
    plain = interp_chain.gp_interp_packs_ref(*args64)
    live = torch.zeros(16, dtype=torch.bool)
    refs = {"jax": jax_packs(rows, jnp.float64),
            "pallas": pallas_chain.gp_interp_packs(*(jnp.asarray(a) for a in rows),
                                                   interpret=True)}
    for name, ref in refs.items():
        got = {k: torch.tensor(np.asarray(ref[k])) for k in KEYS}
        rec = chip_smoke.check_padded(name, got, plain, args64, live,
                                      interp_chain.gp_interp_packs_ref)
        assert rec["f64_max_rel_padded"] <= rec["f64_padded_tol"]
    assert s > -15.0 or rec["f64_max_rel_padded"] > 1e-12
    times = torch.cat([args64[4], args64[5]])
    table = (None, None, times, torch.arange(16), torch.arange(16, 32), args64[6])
    assert chip_smoke.extrapolation("indexed", table, live) == pytest.approx(-s, rel=1e-12)


def test_kernel_timing_inputs_are_the_system_sizes(monkeypatch):
    """tools/time_chain_kernel.py times one checkout's kernel on the headline
    window's combos at the System's sizes: a pose pair queried inside its
    interval (S = 6), a combo bucket (S = 256), and 1024 combos in float32 and
    float64. It refuses to run without a card."""
    from tools import time_chain_kernel as tck

    got = tck.sizes(convert, ba, make_local_ba_problem_numpy, "cpu")
    assert {k: (int(v[-1].shape[0]), v[-1].dtype) for k, v in got.items()} == {
        "pair_6": (6, torch.float32), "rows_256": (256, torch.float32),
        "rows_1024": (1024, torch.float32), "rows_1024_f64": (1024, F64)}
    T1, _, T2, _, t1, t2, t = got["pair_6"]
    assert torch.equal(T1, T1[:1].expand_as(T1)) and torch.equal(T2, T2[:1].expand_as(T2))
    assert bool(((t >= t1) & (t <= t2)).all())
    for k in range(7):
        assert torch.equal(got["rows_256"][k], got["rows_1024"][k][:256])
        assert torch.equal(got["rows_1024_f64"][k], got["rows_1024"][k].double())
    if not torch.cuda.is_available():
        monkeypatch.setattr("sys.argv", ["time_chain_kernel.py"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.main()
