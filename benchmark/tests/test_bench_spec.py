"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness."""

import json
import re

import pytest

from benchmark import run

ROOT = run.ROOT
SPEC = run.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_limits():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check with 24 cells fits the check's time
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        assert (run.BENCH_DIR / "mixes" / f"{w['traffic']}.json").is_file()
        assert (run.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    assert len(pairs) == len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == configs


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        run.reader(m["name"])  # every metric has its reader
    for cell in cells:
        spec_cell = run.cell_of(SPEC, cell)
        e = [m["name"] for m in run.metrics_of(SPEC, spec_cell, False)]
        assert "setup_s" in e and len(e) >= 2
        assert run.metrics_of(SPEC, spec_cell, True)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = run.cell_of(SPEC, cell)
    mix = run.mix_of(c)
    run.kind_module(mix).Session  # noqa: B018
    assert run.config_of(SPEC, c)
    assert run.limits_of(c)["numbers"]


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert all(part == "" or NAME.match(part) for part in rel.split("/")), rel
