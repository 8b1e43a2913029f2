"""The reference's replay at the CPU size: its reach-bounded LiDAR window
gives the map a window of every block gives, bit for bit; its growing pool
gives the content a pool large enough from the start gives; and a replay
that would truncate its window or cannot grow its pool ends the run not
correct."""
import numpy as np
import pytest

import compare
import harness
import scenes
from reference import replay
from reference.state import ReplayLimit

SEED = 2**31 + 23
DRIVE = "newer_college_drive.street"


def cell(bench, base, name, **map_config):
    _, _, conf, traffic, _ = harness.load_cell(bench, name, base)
    conf["map_config"] = dict(conf["map_config"], **map_config)
    frames = scenes.make(traffic, conf["sensor"], SEED, "cpu", base)
    return conf, frames, traffic["warmup_frames"] + 1


def assert_same(a, b):
    for r in (0, 1):
        np.testing.assert_array_equal(a[r][0], b[r][0])
        for name in a[r][1]:
            np.testing.assert_array_equal(a[r][1][name], b[r][1][name])


@pytest.mark.parametrize("name,map_config", [
    ("newer_college_lidar_mr.loop", {}),
    (DRIVE, {"max_active_blocks": 1 << 13}),
    # coarsening served 4 blocks a scan: decisions queue while their
    # blocks leave the sensor's reach
    (DRIVE, {"max_active_blocks": 1 << 13, "max_coarsen_per_frame": 4})])
def test_reach_window_equals_a_window_of_every_block(drive, name,
                                                      map_config):
    bench, base = drive
    conf, frames, n = cell(bench, base, name, **map_config)
    bounded, every = {}, {}
    a = replay.replay(conf, frames, n, "cpu", compare.map_content,
                      info=bounded)
    b = replay.replay(conf, frames, n, "cpu", compare.map_content,
                      reach_window=False, info=every)
    assert_same(a, b)
    assert a[1][0].size > 0                    # some blocks coarsened
    if name == DRIVE:
        assert bounded["widest_window"] < every["widest_window"]


def test_growing_pool_equals_a_pool_large_enough(drive):
    bench, base = drive
    conf, frames, n = cell(bench, base, DRIVE)
    grows, large = {}, {}
    a = replay.replay(conf, frames, n, "cpu", compare.map_content,
                      info=grows)
    conf["map"]["num_blocks"] = 1 << 13
    b = replay.replay(conf, frames, n, "cpu", compare.map_content,
                      info=large)
    assert grows["grown"] >= 1 and large["grown"] == 0
    assert_same(a, b)


def cannot_grow(state):
    import torch
    raise torch.OutOfMemoryError("no room on the device")


@pytest.mark.parametrize("limit,why", [
    ("window", "over the cap"), ("pool", "cannot grow")])
def test_a_replay_at_its_limit_ends_the_run_not_correct(drive, monkeypatch,
                                                        capsys, limit, why):
    """A replay whose window would pass max_active_blocks, or whose pool
    cannot grow, raises ReplayLimit, and the run reads not correct with no
    numbers and a log line that says why."""
    bench, base = drive
    change = {"max_active_blocks": 64} if limit == "window" else {}
    if limit == "pool":
        monkeypatch.setattr(replay, "grow", cannot_grow)
    conf, frames, n = cell(bench, base, DRIVE, **change)
    with pytest.raises(ReplayLimit, match=why):
        replay.replay(conf, frames, n, "cpu", compare.map_content)
    real = harness.load_cell
    monkeypatch.setattr(harness, "load_cell", lambda *a: (
        lambda b, w, c, t, lim: (b, w, dict(c, map_config=dict(
            c["map_config"], **change)), t, lim))(*real(*a)))
    r = harness.run_cell(bench, DRIVE, SEED, 0.0, 0, "cpu", base=base)
    assert r["correct"] is False
    assert all(c["value"] is None for c in r["checks"].values())
    assert why in capsys.readouterr().err
