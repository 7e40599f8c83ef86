"""The control on the card, at a size a test run can hold: each cell's
program with its float32 products in TF32 comes out not correct, and the
same run without it correct. Run on the card:

    python3 -m pytest benchmark/tests -m card
"""

import copy

import pytest

from benchmark import run
from benchmark.tests.test_bench_faults import small_limits

SPEC = run.load_spec()


def small(cell_name):
    cell = run.cell_of(SPEC, cell_name)
    config, mix = copy.deepcopy(run.config_of(SPEC, cell)), dict(run.mix_of(cell))
    mix.update(n_frames=40, warm_frames=10)
    return cell, config, mix


@pytest.mark.card
@pytest.mark.parametrize("cell_name", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("control", [False, True])
def test_the_control_fails_and_the_program_passes(card, cell_name, control):
    cell, config, mix = small(cell_name)
    res = run.run_cell(SPEC, cell, 1234567, 8.0, False, device=card, control=control,
                       config=config, mix=mix, limits=small_limits(cell),
                       log=lambda **k: None)
    assert res["correct"] != control, res["checks"]
