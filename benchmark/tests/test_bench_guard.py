"""What a run may load and read: never JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), never
the old TPU benchmark's files; the references nothing of the program."""

import ast
import re
import subprocess
import sys
import types
from pathlib import Path

from benchmark import run

BENCH = Path(run.__file__).resolve().parent
OLD_BENCHMARK = re.compile(r"\bbench(_all)?\.py\b|\bBENCH_(r\d+|CONFIGS)|\bMULTICHIP_")


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = "") -> list[Path]:
    return sorted(p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts)


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = types.SimpleNamespace(modules={
        "amcslam_tpu_torch": 1, "amcslam_tpu_torch.solver": 1, "jax_like": 1, "numpy": 1})
    monkeypatch.setattr(run, "sys", fake)
    assert run.forbidden_modules() == []
    fake.modules.update({"amcslam_tpu.ops": 1, "jaxlib.xla": 1})
    assert run.forbidden_modules() == ["amcslam_tpu", "jaxlib"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & run.FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    for path in sources("reference"):
        assert "amcslam_tpu_torch" not in imported(path), path
        assert "amcslam_tpu_torch" not in path.read_text(), path


def test_nothing_reads_the_old_tpu_benchmark():
    for path in sources():
        text = path.read_text()
        assert not OLD_BENCHMARK.search(text), path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "from benchmark import run\n"
        "from benchmark.tests import map_fixture\n"
        "map_fixture.run_map(5, 0.01, n_kf=8, n_lm=64)\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
