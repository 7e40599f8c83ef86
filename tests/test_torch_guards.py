"""Guards of the PyTorch port: it never imports JAX or the JAX package, so
it runs where JAX is not installed."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import amcslam_tpu_torch

PKG_DIR = Path(amcslam_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], "amcslam_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = all_modules()
    assert {"amcslam_tpu_torch.solver.ba", "amcslam_tpu_torch.ops.interp_chain",
            "amcslam_tpu_torch.convert", "amcslam_tpu_torch._build",
            "amcslam_tpu_torch.solver.pose_solver",
            "amcslam_tpu_torch.ransac.vel_ransac", "amcslam_tpu_torch.ransac.mlpnp",
            "amcslam_tpu_torch.native", "amcslam_tpu_torch.pipeline.system",
            "amcslam_tpu_torch.pipeline.tracking", "amcslam_tpu_torch.pipeline.extraction",
            "amcslam_tpu_torch.pipeline.matcher"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'amcslam_tpu.')) or k == 'amcslam_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+amcslam_tpu\b|from\s+amcslam_tpu\b)",
                         re.M)
    for path in list(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_precision_settings_keep_float32_matmuls_exact():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_system_on_a_missing_cuda_device_raises():
    """An explicit CUDA device that is not present raises instead of
    running on the CPU."""
    from amcslam_tpu_torch.pipeline.system import System
    from amcslam_tpu_torch.utils.synthetic import make_sequence

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, rig, _, _ = make_sequence(n_frames=1, n_cams=2, n_lm=10, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(rig, enable_loop_closing=False, device="cuda")
