"""Each traffic mix's generator is deterministic by seed, differs between
seeds only in its noise, and makes frames at the sensor's shape."""
import json
import os

import numpy as np
import pytest
import scenes

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def small(mix):
    t = load("traffic", mix)
    t.update({"orbit": {"laps": 1, "orbit": 2}, "loop": {"circle_r": 0.05}}[mix])
    return t


@pytest.mark.parametrize("mix,config", [
    ("orbit", "replica_rgbd_mr"), ("loop", "newer_college_lidar_mr")])
def test_deterministic_by_seed_at_the_sensor_shape(mix, config):
    sensor = load("configs", config)["sensor"]
    a, b, c = (scenes.make(small(mix), sensor, s, "cpu")
               for s in (2**31 + 7, 2**31 + 7, 12))
    assert a.n == b.n == c.n >= 2
    for i in range(a.n + 1):
        for x, y in zip(a.pose(i), c.pose(i)):
            np.testing.assert_array_equal(x, y)      # poses: no seed
    if a.kind == "rgbd":
        for i in range(a.n):
            (d1, c1), (d2, c2), (d3, _) = (f.inputs(i) for f in (a, b, c))
            assert d1.shape == (sensor["rows"], sensor["cols"])
            assert d1.dtype == np.float32 and c1.dtype == np.uint8
            assert c1.shape == (sensor["rows"], sensor["cols"], 3)
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(c1, c2)
            assert not np.array_equal(d1, d3)
            assert np.abs(d1 - d3).max() < 0.05        # noise only
            assert (d1 > 0.5).all()                    # inside the room
    else:
        for i in range(a.n):
            p1, p2, p3 = (f.inputs(i) for f in (a, b, c))
            assert p1.shape == (sensor["rows"] * sensor["cols"], 3)
            assert p1.dtype == np.float32
            np.testing.assert_array_equal(p1, p2)
            hit = (p1 != 0).any(axis=1)
            assert 0.3 < hit.mean() <= 1.0
            np.testing.assert_array_equal(hit, (p3 != 0).any(axis=1))
            assert not np.array_equal(p1, p3)
            r = np.linalg.norm(p1[hit], axis=1)
            assert r.max() <= sensor["max_depth"]
        assert a.intrinsics == c.intrinsics


def test_loop_scans_hit_the_ground_and_the_wall():
    t = small("loop")
    sensor = load("configs", "newer_college_lidar_mr")["sensor"]
    f = scenes.make(t, sensor, 5, "cpu")
    for i in range(f.n):
        trans, _ = f.pose(i)
        p = f.inputs(i)
        p = p[(p != 0).any(axis=1)] + trans            # the world frame
        on_ground = np.abs(p[:, 2] - t["ground_z"]) < 0.05
        on_wall = np.abs(np.linalg.norm(p[:, :2], axis=1) - t["wall_r"]) \
            < 0.05
        assert (on_ground | on_wall).mean() > 0.99
        assert on_ground.any() and on_wall.any()
    el = np.degrees(np.arctan2(p[:, 2] - trans[2], np.linalg.norm(
        p[:, :2] - trans[:2], axis=1)))
    lo, hi = sensor["elevation_deg"]
    assert lo - 0.5 <= el.min() and el.max() <= hi + 0.5
