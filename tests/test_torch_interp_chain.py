"""The GP-interpolation chain of the port: plain version vs the reference,
the wrapper's dispatch and checks, and the kernel build step.

`gp_interp_packs_ref` (the port's plain PyTorch chain, which CPU tensors
take and which `chip_smoke.py` holds the CUDA kernel against on the card) is
compared with the reference's fused Pallas kernel in interpret mode
(`amcslam_tpu/ops/pallas_chain.py`) and with its pure-JAX path
vmap(gp_pair_pack) + vmap(gp_interp_pack). Inputs: tests/test_pallas_chain.py
`_random_case` (generic, near-pi, tiny; interval endpoints s = 0 and 1).
float64 agrees to max |a-b|/(1+|b|) <= 1e-12; in float32 the port must sit
within max(5e-5, 10x the JAX float32 path's distance) of the float64 oracle.
The CUDA kernel itself compiles and runs only on the card (`chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcslam_tpu.factors import reprojection as jrep
from amcslam_tpu.ops import lie as jlie
from amcslam_tpu.ops import pallas_chain
from amcslam_tpu_torch import _build
from amcslam_tpu_torch.ops import interp_chain

KEYS = ("Twb", "Tbw", "Q")


def max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def random_case(seed, n, near_pi=False, tiny=False):
    """tests/test_pallas_chain.py::_random_case, as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    xi1 = rng.normal(scale=0.8, size=(n, 6))
    if near_pi:
        ax = rng.normal(size=(n, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        xi1[:, 3:] = ax * (np.pi - 1e-3)
    if tiny:
        xi1 *= 1e-6
    dxi = rng.normal(scale=(1e-7 if tiny else 0.3), size=(n, 6))
    T1 = jax.vmap(jlie.exp_se3)(jnp.asarray(xi1, jnp.float64))
    T2 = jax.vmap(lambda a, b: a @ jlie.exp_se3(b))(T1, jnp.asarray(dxi, jnp.float64))
    v1 = rng.normal(scale=0.5, size=(n, 6))
    v2 = rng.normal(scale=0.5, size=(n, 6))
    t1 = rng.uniform(0.0, 1.0, n)
    t2 = t1 + rng.uniform(0.05, 0.5, n)
    s = rng.uniform(0.0, 1.0, n)
    s[: n // 4] = 0.0  # interval endpoints
    s[n // 4: n // 2] = 1.0
    t = t1 + s * (t2 - t1)
    return tuple(np.asarray(a) for a in (T1, v1, T2, v2, t1, t2, t))


def jax_packs(args, dtype):
    a = [jnp.asarray(x, dtype) for x in args]
    packs = jax.vmap(jrep.gp_pair_pack)(a[0], a[1], a[2], a[3])
    return jax.vmap(jrep.gp_interp_pack)(packs, a[0], a[1], a[4], a[5], a[6])


def port_packs(args, dtype):
    return interp_chain.gp_interp_packs(*(torch.tensor(x, dtype=dtype) for x in args))


@pytest.mark.parametrize("case", ["generic", "near_pi", "tiny"])
def test_plain_chain_matches_reference_f64(case):
    args = random_case(3, 37, near_pi=case == "near_pi", tiny=case == "tiny")
    got = port_packs(args, torch.float64)
    ref_jax = jax_packs(args, jnp.float64)
    ref_pallas = pallas_chain.gp_interp_packs(
        *(jnp.asarray(a) for a in args), interpret=True)
    for k in KEYS:
        assert got[k].dtype == torch.float64
        assert max_rel(got[k], ref_jax[k]) <= 1e-12, (case, k)
        assert max_rel(got[k], ref_pallas[k]) <= 1e-12, (case, k)


def test_plain_chain_f32_within_envelope():
    args = random_case(7, 64)
    oracle = jax_packs(args, jnp.float64)
    got = port_packs(args, torch.float32)
    jax32 = jax_packs(args, jnp.float32)
    for k in KEYS:
        assert got[k].dtype == torch.float32
        d_port = max_rel(got[k], oracle[k])
        d_jax32 = max_rel(jax32[k], oracle[k])
        assert d_port < max(5e-5, 10.0 * d_jax32), (k, d_port, d_jax32)


def test_plain_chain_is_prefix_independent():
    """Each combo depends on its own inputs only: a prefix of the batch gives
    bit-identical results (the kernel's S in {1, 130, 1024} check on the
    card mirrors this)."""
    args = random_case(11, 130)
    full = port_packs(args, torch.float64)
    for n in (1, 5):
        head = port_packs(tuple(a[:n] for a in args), torch.float64)
        for k in KEYS:
            assert torch.equal(head[k], full[k][:n]), (n, k)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns the plain version's result and
    launches nothing."""
    args = tuple(torch.tensor(a) for a in random_case(13, 9))
    before = interp_chain.LAUNCHES
    got = interp_chain.gp_interp_packs(*args)
    ref = interp_chain.gp_interp_packs_ref(*args)
    assert interp_chain.LAUNCHES == before
    for k in KEYS:
        assert torch.equal(got[k], ref[k])
    assert got["Q"].shape == (9, 6, 24)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mixed_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.tensor(a) for a in random_case(17, 4)]
    if bad == "dtype":
        args = [a.to(torch.float16) for a in args]
    elif bad == "shape":
        args[1] = args[1][:, :5]
    else:
        args[6] = args[6].to(torch.float32)
    with pytest.raises(ValueError):
        interp_chain.gp_interp_packs(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without nvcc the build step raises a clear error and
    returns no library."""
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("interp_chain")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("interp_chain")
    assert not (tmp_path / "kernels").exists()


def test_build_names_the_kernel_source():
    srcs = _build._sources("interp_chain")
    assert srcs[0].name == "interp_chain.cu" and srcs[0].is_file()
    text = srcs[0].read_text()
    for fn in interp_chain._FN.values():
        assert f'int {fn}(' in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(FileNotFoundError):
        _build._sources("no_such_kernel")
