"""A cell, a configuration, a traffic kind and a per-layer metric added by
new files and new entries alone are found: nothing existing is edited."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run

KIND = '''
class Session:
    unit = "solve"
    dtype_name = "float32"

    def __init__(self, config, mix, seed, device):
        self.left = mix["solves"]
        self.value = config["value"]

    def warm(self):
        pass

    def step(self):
        if not self.left:
            return None
        self.left -= 1
        return {"failed": False}

    def summary(self, rec):
        return {}

    def check(self):
        return {"answer_gap": abs(self.value - 42.0)}
'''
READER = '''
def read(rec, name):
    return float(len(rec["units"]))
'''


def test_a_cell_added_from_files_alone(tmp_path):
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = run.load_spec()
    b = tmp_path / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "value": 42.0}))
    (b / "mixes" / "few.json").write_text(json.dumps({"kind": "toy_kind", "solves": 3}))
    (b / "traffic" / "toy_kind.py").write_text(KIND)
    (b / "metrics" / "toy_count.py").write_text(READER)
    (b / "limits" / "toy.few.json").write_text(json.dumps({"numbers": {"answer_gap": {"limit": 0}}}))
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy.few", "config": "toy", "traffic": "few", "chips": 1,
                              "why": "three solves"})
    # an end-to-end metric whose reader is already there, added by its entry alone
    spec["end_to_end"].append({"name": "gba_s", "unit": "s", "better": "lower", "bound": 0.25,
                               "source": "host_clock", "workloads": ["toy.few"]})
    spec["per_layer"].append({"name": "toy_count", "unit": "solves", "better": "higher",
                              "source": "program_counter", "layer": "toy", "moves": "gba_s",
                              "workloads": ["toy.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json\nfrom benchmark import run\n"
            "spec = run.load_spec(); cell = run.cell_of(spec, 'toy.few')\n"
            "for trace in (False, True):\n"
            "    print(json.dumps(run.run_cell(spec, cell, 1, 60.0, trace, device='cpu',"
            " log=lambda **k: None)))\n")
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    e2e, layer = (json.loads(s) for s in out.stdout.strip().splitlines()[-2:])
    assert e2e["correct"] and e2e["attempted"] == 3
    assert set(e2e["metrics"]) == {"gba_s", "setup_s"}
    assert layer["metrics"] == {"toy_count": {"value": 3.0, "unit": "solves"}}
    assert list(e2e) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert e2e["checks"] == {"answer_gap": {"value": 0.0, "limit": 0}}
