"""Guards of the PyTorch port: it never imports JAX or the JAX package, and
builds nothing from the JAX package's tree, so it runs where neither is
installed; and it covers the JAX package: every public top-level name of
every reference module has a counterpart in the port module at the same
path, and every program of the reference has its port."""

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


# The port's coverage of the JAX package, read from the sources with `ast`
# (nothing of either package is imported). A reference module maps to the
# port module at the same path unless MODULE_ALIASES names another (None: no
# port module, every public name exempt); a renamed name maps through
# NAME_ALIASES.
MODULE_ALIASES = {
    "ops/pallas_chain.py": "ops/interp_chain.py",      # the Pallas kernel's CUDA port
    "frontend/orb_tpu.py": "frontend/orb_device.py",   # the batched ORB on the device
    "native/__init__.py": "native.py",                  # the native loader, one module
    "ops/precision.py": None,
}
NAME_ALIASES = {
    ("frontend/orb_tpu.py", "ORBExtractorTPU"): "ORBExtractorDevice",
    ("frontend/orb_tpu.py", "build_orb_tpu"): "build_orb_device",
}
EXEMPT = {
    ("ops/precision.py", "exact"): "a TPU workaround: f32 matmuls at HIGHEST precision; the "
                                   "port sets torch's matmul precision once for the package",
    ("ops/precision.py", "fdtype"): "a TPU workaround: the float dtype of the x64 setting; the "
                                    "port passes its dtype explicitly",
    ("ops/precision.py", "smm"): "a TPU workaround: small matmuls as broadcast sums to avoid "
                                 "bf16 passes; the package-level setting makes them exact",
    ("ops/pallas_chain.py", "available"): "whether Pallas lowers on this backend; the CUDA "
                                          "kernel builds or raises, the CPU takes the plain "
                                          "version by the tensor's device",
}
# The reference's programs (repo root and examples/) and their ports;
# None: not ported in this round.
PROGRAMS = {
    "__graft_entry__.py": "amcslam_tpu_torch/entry.py",
    "examples/e2e_rendered.py": "amcslam_tpu_torch/examples/e2e_rendered.py",
    "examples/multicam_amv.py": "amcslam_tpu_torch/examples/multicam_amv.py",
    "examples/profile_orb_tpu.py": "amcslam_tpu_torch/examples/profile_orb_device.py",
    "examples/profile_pcg.py": "amcslam_tpu_torch/examples/profile_pcg.py",
    # the earlier round's TPU benchmark, taken up by the port's benchmark
    "bench.py": None,
    "bench_all.py": None,
}
REF_DIR = REPO / "amcslam_tpu"


def public_defs(path) -> set:
    """Public top-level functions, classes and constants (assigned names)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return {n for n in out if not n.startswith("_")}


def top_level_bindings(path) -> set:
    """Every name a module binds at its top level, imports included."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.add(n.id)
    return out


def reference_modules():
    return sorted(p.relative_to(REF_DIR).as_posix() for p in REF_DIR.rglob("*.py"))


def test_port_covers_every_public_name_of_the_reference():
    assert len(reference_modules()) >= 50
    missing = []
    for rel in reference_modules():
        names = public_defs(REF_DIR / rel)
        target = MODULE_ALIASES.get(rel, rel)
        have = set() if target is None else top_level_bindings(PKG_DIR / target)
        assert target is None or (PKG_DIR / target).is_file(), rel
        for name in sorted(names):
            if (rel, name) in EXEMPT:
                continue
            if NAME_ALIASES.get((rel, name), name) not in have:
                missing.append(f"{rel}::{name} -> {target}")
    assert not missing, missing


def test_coverage_exemptions_and_aliases_are_current():
    """Every exemption names a public name of the reference that the port
    lacks, and every alias a reference name and an existing port name."""
    for (rel, name), reason in EXEMPT.items():
        assert reason and name in public_defs(REF_DIR / rel), (rel, name)
        target = MODULE_ALIASES.get(rel, rel)
        assert target is None or name not in top_level_bindings(PKG_DIR / target), (rel, name)
    for (rel, name), new in NAME_ALIASES.items():
        assert name in public_defs(REF_DIR / rel)
        assert new in top_level_bindings(PKG_DIR / MODULE_ALIASES[rel])
    for rel, target in MODULE_ALIASES.items():
        assert (REF_DIR / rel).is_file(), rel
        if target is None:
            assert all((rel, n) in EXEMPT for n in public_defs(REF_DIR / rel)), rel


def test_every_program_of_the_reference_has_its_port():
    programs = sorted([p.name for p in REPO.glob("*.py")
                       if p.name not in ("chip_smoke.py", "setup.py")]
                      + [f"examples/{p.name}" for p in (REPO / "examples").glob("*.py")])
    assert programs == sorted(PROGRAMS)
    for ref, port in PROGRAMS.items():
        if port is None:
            continue
        # a program the reference runs as a script is a script in the port too
        assert has_main_guard(REPO / port) == has_main_guard(REPO / ref), port
        assert public_defs(REPO / port), port


def has_main_guard(path) -> bool:
    return any(isinstance(n, ast.If) and "__main__" in ast.unparse(n.test)
               for n in ast.parse(path.read_text()).body)
