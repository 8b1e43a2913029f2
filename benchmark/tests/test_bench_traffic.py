"""Each traffic mix's generator is deterministic by seed, makes frames at
the sensor's shape, and differs between seeds only in its noise (and, in
the street, in the order of its buildings); a scene kind not in
scenes.SCENES is found as a file of its own."""
import json
import os

import numpy as np
import pytest
import scenes
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a street drive at an OS1-64's shape: a vehicle's pace (KITTI odometry's
# sequence 00 covers ~3.7 km in 4,541 scans, ~0.8 m a scan), 8 m lots
STREET = dict(scene="lidar_street", ground_z=-1.73, half_width_m=8.0,
              lot_m=8.0, period_m=32.0, step_m=0.8, setback_m=[0.0, 4.0],
              height_m=[6.0, 24.0], depth_m=12.0, gaps=1, noise_m=0.01)


def load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def small(mix):
    if mix == "street":
        return dict(STREET, period_m=1.6, lot_m=0.8)
    t = load("traffic", mix)
    t.update({"orbit": {"laps": 1, "orbit": 2}, "loop": {"circle_r": 0.05}}[mix])
    return t


@pytest.mark.parametrize("mix,config", [
    ("orbit", "replica_rgbd_mr"), ("loop", "newer_college_lidar_mr"),
    ("street", "newer_college_lidar_mr")])
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
            if mix == "loop":
                np.testing.assert_array_equal(hit, (p3 != 0).any(axis=1))
            assert not np.array_equal(p1, p3)
            r = np.linalg.norm(p1[hit], axis=1)
            assert r.max() <= sensor["max_depth"]
            assert r.min() >= sensor["min_depth"]
        if mix == "loop":
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


def street_sides(seed):
    """The street module's boxes() and the lots the seed draws."""
    street = scenes.kind_module("lidar_street")
    gen = torch.Generator()
    gen.manual_seed(seed)
    return street.boxes, street.lots(STREET, gen, "cpu")


@pytest.mark.parametrize("elevation_deg,rows", [
    ([-16.6, 16.6], 64),          # Ouster OS1-64
    ([-24.8, 2.0], 64)])          # Velodyne HDL-64E
def test_street_drives_into_new_ground_without_wrapping(elevation_deg, rows):
    """Scan i, cycled from scan i % n, is what the sensor sees at pose(i) =
    (i * step_m, 0, 0) over 3 n scans: every return lies on the ground or
    on a face of a building of the street as it stands there; every scan
    hits the ground and a facade; the poses never wrap."""
    sensor = dict(load("configs", "newer_college_lidar_mr")["sensor"],
                  elevation_deg=elevation_deg, rows=rows, cols=128)
    seed = 2**32 + 3
    f = scenes.make(STREET, sensor, seed, "cpu")
    n = f.n
    assert n == round(STREET["period_m"] / STREET["step_m"])
    boxes, sides = street_sides(seed)
    for i in range(3 * n):
        trans, quat = f.pose(i)
        np.testing.assert_allclose(trans, [i * STREET["step_m"], 0, 0],
                                   rtol=1e-6)
        np.testing.assert_array_equal(quat, [0, 0, 0, 1])
        p = f.inputs(i)
        np.testing.assert_array_equal(p, f.inputs(i % n))
        p = p[(p != 0).any(axis=1)].astype(np.float64) + trans
        lo, hi = (b.numpy() for b in boxes(STREET, sides, float(trans[0]),
                                            sensor["max_depth"], "cpu"))
        on_ground = np.abs(p[:, 2] - STREET["ground_z"]) < 0.05
        inside = ((p[:, None] > lo - 0.05) & (p[:, None] < hi + 0.05)).all(-1)
        near_face = (np.minimum(np.abs(p[:, None] - lo),
                                np.abs(p[:, None] - hi)) < 0.05).any(-1)
        on_facade = (inside & near_face).any(-1) & ~on_ground
        assert (on_ground | on_facade).mean() > 0.99, i
        assert on_ground.any() and on_facade.any(), i
    assert f.pose(3 * n)[0][0] > f.pose(n)[0][0] > 0       # no wrap


def test_street_seeds_reorder_one_set_of_buildings():
    _, a = street_sides(1)
    _, b = street_sides(2)
    assert any(not torch.equal(x[0], y[0]) for x, y in zip(a, b))
    for (sa, ha, ba), (sb, hb, bb) in zip(a, b):
        assert torch.equal(sa.sort().values, sb.sort().values)
        assert torch.equal(ha.sort().values, hb.sort().values)
        assert int(ba.sum()) == int(bb.sum()) == sa.numel() - STREET["gaps"]


def test_unknown_scene_kind_is_refused():
    for kind in ("no_such_scene", "../scenes"):
        with pytest.raises(ValueError, match="unknown scene"):
            scenes.make(dict(scene=kind), {}, 0, "cpu")
