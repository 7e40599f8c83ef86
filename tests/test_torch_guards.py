"""Guards of the PyTorch port: it never imports JAX or the JAX package, and
builds nothing from the JAX package's tree, so it runs where neither is
installed."""

import ast
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


def port_sources():
    """The port's Python files: the package, chip_smoke.py and tools/."""
    return [*PKG_DIR.rglob("*.py"), REPO / "chip_smoke.py", *(REPO / "tools").glob("*.py")]


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
            "amcslam_tpu_torch.pipeline.matcher", "amcslam_tpu_torch.pipeline.config",
            "amcslam_tpu_torch.frontend.orb", "amcslam_tpu_torch.frontend.orb_device",
            "amcslam_tpu_torch.frontend.features", "amcslam_tpu_torch.frontend.cameras",
            "amcslam_tpu_torch.examples", "amcslam_tpu_torch.examples.e2e_rendered",
            "amcslam_tpu_torch.examples.multicam_amv", "amcslam_tpu_torch.ops.imu",
            "amcslam_tpu_torch.factors.imu", "amcslam_tpu_torch.solver.vi_ba",
            "amcslam_tpu_torch.solver.debug", "amcslam_tpu_torch.ransac.two_view",
            "amcslam_tpu_torch.pipeline.viewer", "amcslam_tpu_torch.parallel",
            "amcslam_tpu_torch.parallel.group", "amcslam_tpu_torch.parallel.sharded_ba",
            "amcslam_tpu_torch.parallel.sharded_eg", "amcslam_tpu_torch.entry",
            "amcslam_tpu_torch.examples.profile_orb_device",
            "amcslam_tpu_torch.examples.profile_pcg"} <= set(mods)
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
    for path in port_sources():
        assert not pattern.search(path.read_text()), path


def test_viewer_imports_matplotlib_only_when_it_draws():
    """Importing the whole port (the viewer and the entry points included)
    leaves matplotlib out of sys.modules; a draw function brings it in."""
    code = (
        "import importlib, sys\n"
        f"for m in {all_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "from amcslam_tpu_torch.pipeline import map_store, viewer\n"
        "viewer.draw_map(map_store.Map())\n"
        "assert 'matplotlib' in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


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


def test_native_source_lies_inside_the_port():
    from amcslam_tpu_torch import native

    assert PKG_DIR in native.SOURCE.resolve().parents
    assert native.SOURCE.is_file()


def test_native_source_is_a_copy_of_the_reference():
    from amcslam_tpu_torch import native

    ref = REPO / "amcslam_tpu" / "native" / "graph_builder.cpp"
    assert native.SOURCE.read_bytes() == ref.read_bytes()


def test_native_orb_source_is_a_copy_of_the_reference():
    from amcslam_tpu_torch import native

    src = native.SOURCES["orb_fast"]
    assert src == PKG_DIR / "csrc" / "orb_fast.cpp"
    ref = REPO / "amcslam_tpu" / "native" / "orb_fast.cpp"
    assert src.read_bytes() == ref.read_bytes()


def test_device_orb_and_the_cli_default_raise_without_a_card(tmp_path):
    """The device ORB backend on "cuda" and the CLI's default device raise
    on a machine without a card instead of running on the CPU."""
    from amcslam_tpu_torch.examples import multicam_amv
    from amcslam_tpu_torch.frontend.features import make_extractors

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extractors(2, 300, backend="device", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extractors(2, 300, backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multicam_amv.main([str(tmp_path / "run.yaml")])


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_port_file_builds_a_path_into_the_reference():
    """No string in the port's code, chip_smoke.py or tools/ names the JAX package's
    directory as a path component. Docstrings, messages and `file.py:line`
    citations of the reference may name its files."""
    component = re.compile(r"^amcslam_tpu$|^amcslam_tpu[/\\]|[/\\]amcslam_tpu([/\\]|$)")
    citation = re.compile(r"\.py:\d+(-\d+)?$")
    for path in port_sources():
        tree = ast.parse(path.read_text())
        bad = [s for s in _code_strings(tree)
               if component.search(s) and " " not in s and not citation.search(s)]
        assert not bad, (path, bad)
