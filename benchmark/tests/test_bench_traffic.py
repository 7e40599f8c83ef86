"""The generators: determined by the seed, the same work for every seed."""

import numpy as np
import pytest

from benchmark import run
from benchmark.tests import map_fixture
from benchmark.traffic import synthetic

SPEC = run.load_spec()
RIG = run.config_of(SPEC, run.cell_of(SPEC, "amv6_rig.kp_drive"))["rig"]
SEEDS = (0, 2**31 + 12345, 2**40 + 7)


def small_drive():
    mix = dict(run.mix_of(run.cell_of(SPEC, "amv6_rig.kp_drive")))
    mix.update(n_frames=12)
    return mix


def small_map():
    return dict(map_fixture.MAP, n_kf=20, n_lm=200)


def flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in flat(e)]
    return [np.asarray(x)]


@pytest.mark.parametrize("make", ["drive", "map"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(make, seed):
    gen = (lambda s: synthetic.keypoint_drive(RIG, small_drive(), s)) if make == "drive" \
        else (lambda s: synthetic.map_problem(RIG, small_map(), s))
    a, b = flat(gen(seed)), flat(gen(seed))
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    c = flat(gen(seed + 1))
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a, c))


def test_drive_sizes_do_not_depend_on_the_seed():
    drives = [synthetic.keypoint_drive(RIG, small_drive(), s) for s in SEEDS]
    for d in drives[1:]:
        np.testing.assert_array_equal(d["poses"], drives[0]["poses"])
        assert len(d["landmarks"]) == len(drives[0]["landmarks"])
    kp = [np.mean([len(k) for f in d["frames"] for k in f["keypoints"]]) for d in drives]
    assert max(kp) / min(kp) < 1.1


def test_map_sizes_do_not_depend_on_the_seed():
    maps = [synthetic.map_problem(RIG, small_map(), s) for s in SEEDS]
    for m in maps[1:]:
        assert len(m["st_lm"]) == pytest.approx(len(maps[0]["st_lm"]), rel=0.05)
        assert len(m["gt_X"]) == len(maps[0]["gt_X"])


def test_drive_keypoints_are_the_landmarks_projections():
    from benchmark.reference import lie

    mix = dict(small_drive(), noise_px=0.0)
    d = synthetic.keypoint_drive(RIG, mix, 3)
    Tbc, K, _, off = synthetic.rig_arrays(RIG)
    k, c = 5, 1
    f = d["frames"][k]
    vk = np.asarray(mix["twist"]) + np.sin(mix["wiggle_rate"] * k) * np.asarray(mix["wiggle"])
    Twc = d["poses"][k] @ lie.exp_se3(vk * off[c]) @ Tbc[c]
    ids = f["landmark_ids"][c]
    Tcw = lie.rigid_inv(Twc)
    Xc = d["landmarks"][ids] @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = K[c, :2] * Xc[:, :2] / Xc[:, 2:] + K[c, 2:]
    np.testing.assert_allclose(f["keypoints"][c], uv, atol=1e-9)
    np.testing.assert_array_equal(f["descriptors"][c], d["descriptors"][ids])
    assert np.all(np.diff(ids) > 0) and np.all(Xc[:, 2] >= mix["min_depth"])
    assert f["cam_times"][c] == pytest.approx(k / mix["fps"] + off[c])
