"""Parity of the port's per-edge GP fallback of the local BA with the JAX
reference: the packed GP factors (`factors/reprojection.py:267-330`) and
`make_ba_problem` on data without the interp-combo tables (`mg_it`/`sg_it`),
without the landmark gather tables (`lm_blk`), or without both
(`solver/ba.py:252-264`, `:286-296`, `:368-379`, `:397-411`, `:798-811`).

The problem comes from the reference's generator at the reference bench's
SMOKE size (8 KF / 64 landmarks), with hand-built stereo-GP edges
(tests/test_torch_ba.py), in float64 on the CPU. Tolerances: packed factors against the interp-pack
factors and against the reference 1e-10; linearize rtol 1e-9 / atol 1e-10;
dx rtol 1e-7 / atol 1e-9; chi2 relative 1e-12. An LM run without the
tables is held in tests/test_torch_pcg_ba.py (global_ba_pcg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.factors import reprojection as jrep
from amcslam_tpu.solver import ba as jba
from amcslam_tpu.utils.synthetic import make_local_ba_problem as jmake
from amcslam_tpu_torch import convert
from amcslam_tpu_torch.factors import reprojection as trep
from amcslam_tpu_torch.solver import ba as tba
from test_torch_ba import with_stereo_gp_edges

F64 = torch.float64
LIN_NAMES = ("Hpp", "bp", "Wt", "Hll", "bl")
NO_TABLES = dict(mg_it=None, mg_it_sid=None, mg_it_t=None, sg_it=None, sg_it_sid=None,
                 sg_it_t=None, lm_blk=None, lm_blk_g=None, lm_blk_valid=None, lm_edge=None,
                 lm_edge_valid=None)


@pytest.fixture(scope="module")
def smoke():
    """The reference bench's SMOKE local-BA size, with stereo-GP edges."""
    jd, js, _ = jmake(n_kf=8, n_fixed=1, n_lm=64, n_cams=6, obs_per_lm=4, gpobs_per_lm=2,
                      noise_px=0.5, seed=0)
    return with_stereo_gp_edges(jd, n_sg=32, seed=1), js


def close(a, b, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


def rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def edge_inputs(jd, js):
    """Per-edge inputs of the mono-GP edges (valid ones) as numpy."""
    v = np.asarray(jd.mg_valid)
    pair = np.asarray(jd.mg_pair)[v]
    i, j = pair[:, 0], pair[:, 1]
    T, vel, times = np.asarray(js.T), np.asarray(js.v), np.asarray(jd.times)
    Text = np.concatenate([np.asarray(js.Text), np.asarray(jd.Tbc_stereo)[None]])
    Kall = np.concatenate([np.asarray(jd.K_async), np.asarray(jd.K_stereo)[None]])
    cam = np.asarray(jd.mg_cam)[v]
    return dict(T1=T[i], v1=vel[i], T2=T[j], v2=vel[j], t1=times[i], t2=times[j],
                t=np.asarray(jd.mg_t)[v], Tbc=Text[cam], K=Kall[cam],
                Xw=np.asarray(js.X)[np.asarray(jd.mg_lm)[v]], obs=np.asarray(jd.mg_obs)[v])


def test_packed_factors_match_interp_factors_and_reference(smoke):
    jd, js = smoke
    e = edge_inputs(jd, js)
    t = {k: torch.tensor(a) for k, a in e.items()}
    pack = trep.gp_pair_pack(t["T1"], t["v1"], t["T2"], t["v2"])
    ip = trep.gp_interp_pack(pack, t["T1"], t["v1"], t["t1"], t["t2"], t["t"])
    jpack = jax.vmap(jrep.gp_pair_pack)(e["T1"], e["v1"], e["T2"], e["v2"])

    got = trep.mono_gp_residual_jac_packed(pack, t["T1"], t["v1"], t["t1"], t["t2"], t["t"],
                                           t["Tbc"], t["K"], t["Xw"], t["obs"])
    via_interp = trep.mono_gp_residual_jac_interp(ip, t["Tbc"], t["K"], t["Xw"], t["obs"])
    ref = jax.jit(jax.vmap(jrep.mono_gp_residual_jac_packed))(
        jpack, e["T1"], e["v1"], e["t1"], e["t2"], e["t"], e["Tbc"], e["K"], e["Xw"], e["obs"])
    assert len(got) == 6
    for a, b, r, name in zip(got, via_interp, ref, ("r", "J1", "J2", "Jl", "Jext", "Xc")):
        close(a, b, 1e-10, 1e-10, "interp " + name)
        close(a, r, 1e-10, 1e-10, "reference " + name)

    # the stereo factor on the same edges, with the stereo camera's rig
    obs3 = np.concatenate([e["obs"], e["obs"][:, :1] - 4.0], 1)
    Tbc, K, bf = (np.asarray(jd.Tbc_stereo), np.asarray(jd.K_stereo), float(jd.bf))
    got = trep.stereo_gp_residual_jac_packed(pack, t["T1"], t["v1"], t["t1"], t["t2"], t["t"],
                                             torch.tensor(Tbc), torch.tensor(K), bf, t["Xw"],
                                             torch.tensor(obs3))
    via_interp = trep.stereo_gp_residual_jac_interp(ip, torch.tensor(Tbc), torch.tensor(K), bf,
                                                    t["Xw"], torch.tensor(obs3))
    ref = jax.jit(jax.vmap(jrep.stereo_gp_residual_jac_packed,
                           in_axes=(0, 0, 0, 0, 0, 0, None, None, None, 0, 0)))(
        jpack, e["T1"], e["v1"], e["t1"], e["t2"], e["t"], Tbc, K, bf, e["Xw"], obs3)
    for a, b, r, name in zip(got, via_interp, ref, ("r", "J1", "J2", "Jl", "Xc")):
        close(a, b, 1e-10, 1e-10, "stereo interp " + name)
        close(a, r, 1e-10, 1e-10, "stereo reference " + name)


def test_fallback_linearize_solve_chi2_match_reference(smoke):
    """Without the interp-combo and the landmark tables (either one alone:
    tests/test_torch_ba.py::test_missing_tables_raise)."""
    jd, js = smoke
    jd = jd._replace(**NO_TABLES)
    lvl = (jd.mg_valid, jd.sg_valid, jd.st_valid)
    jp = jba.make_ba_problem(jd, *lvl)
    td, ts = convert.from_reference(jd, js)
    tp = tba.make_ba_problem(td, td.mg_valid, td.sg_valid, td.st_valid)
    jlin = jax.jit(jp.linearize)(js)
    tlin = tp.linearize(ts)
    for a, b, name in zip(tlin, jlin, LIN_NAMES):
        close(a, b, 1e-9, 1e-10, name)
    lam = 0.37
    (jdxp, jdxl), jxx, jxb = jax.jit(jp.solve)(jlin, jnp.asarray(lam))
    (dxp, dxl), xx, xb = tp.solve(tlin, torch.tensor(lam, dtype=F64))
    close(dxp, jdxp, 1e-7, 1e-9, "dxp")
    close(dxl, jdxl, 1e-7, 1e-9, "dxl")
    assert rel(xx, jxx) <= 1e-8 and rel(xb, jxb) <= 1e-8
    assert rel(tp.chi2(ts), jax.jit(jp.chi2)(js)) <= 1e-12


def test_fallback_equals_table_path_in_the_port(smoke):
    """Without any table the port's linearization is its table-driven one
    (the reference's test_gather_tables_match_segment_sum_fallback and
    test_interp_tables, on the port alone)."""
    jd, js = smoke
    td, ts = convert.from_reference(jd, js)
    fb = td._replace(**NO_TABLES)
    a = tba.make_ba_problem(td, td.mg_valid, td.sg_valid, td.st_valid).linearize(ts)
    b = tba.make_ba_problem(fb, fb.mg_valid, fb.sg_valid, fb.st_valid).linearize(ts)
    for x, y, name in zip(a, b, LIN_NAMES):
        close(x, y, 1e-9, 1e-10, name)
