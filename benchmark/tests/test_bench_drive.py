"""The cell kitti_lidar_mr.drive on the CPU at a tiny size, through
harness.run_cell from a shrunk copy (an 8x64 sensor, a pool of 2^12
blocks, a window cap of 2^9, a 10 m range, 60 warm-up scans of the
drive's street): a sound run is correct with every number 0, and a frame
step whose LiDAR window is again every block, capped in slot order, comes
out not correct once the map outgrows the cap.  Then the cell's two
readers, points.reach_ms and window_blocks_per_frame, on a recorded
trace, and on one of a program without the span."""
import json
import os

import harness
import pytest
import tracing

CELL = "kitti_lidar_mr.drive"
SEED = 2**31 + 29


def shrink_drive(base):
    path = os.path.join(base, "configs", "kitti_lidar_mr.json")
    with open(path) as f:
        conf = json.load(f)
    conf["sensor"].update(rows=8, cols=64, max_depth=10.0)
    conf["map"].update(max_depth=10.0, num_blocks=1 << 12,
                       num_buckets=1 << 10, max_active_blocks=1 << 9,
                       max_alloc_per_frame=1024)
    with open(path, "w") as f:
        json.dump(conf, f)
    path = os.path.join(base, "traffic", "drive.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(warmup_frames=60, trace_frames=3)
    with open(path, "w") as f:
        json.dump(mix, f)


@pytest.fixture
def drive(tiny):
    shrink_drive(tiny[1])
    return tiny


def last_map_line(err):
    """(entries in the map, entries in the window) at the window's end."""
    line = next(x for x in err.splitlines()
                if x.startswith("map at the window's end: "))
    w = line.split()
    return int(w[5]), int(w[8])


def test_a_sound_drive_is_correct(drive, capsys):
    bench, base = drive
    r = harness.run_cell(bench, CELL, SEED, 0.0, 0, "cpu", base=base)
    total, window = last_map_line(capsys.readouterr().err)
    assert total > 1 << 9 > window          # the map outgrew the cap
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"frame_ms_p95", "peak_mem_gib", "setup_s"}
    for c in r["checks"].values():
        assert c["value"] == 0.0


def test_a_window_of_every_block_capped_is_not_correct(drive, monkeypatch):
    """The parent's window: every block, cut at max_active_blocks in slot
    order, so blocks within the sensor's reach miss their scans."""
    from mrhash_tpu_torch.core import pipeline
    bench, base = drive
    monkeypatch.setattr(pipeline, "_window_reach", lambda cfg, cam: None)
    r = harness.run_cell(bench, CELL, SEED, 0.0, 0, "cpu", base=base)
    assert r["correct"] is False, r["checks"]


def ev(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def read(base, name, trace):
    return harness.load_reader(base, name)(trace)


@pytest.mark.parametrize("with_span", [True, False])
def test_the_cells_readers_on_a_recorded_trace(with_span):
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(base, "configs", "kitti_lidar_mr.json")) as f:
        conf = json.load(f)
    events = [ev(tracing.WINDOW, 0, 300)]
    for f in range(3):
        t = 100 * f
        events += [ev(tracing.FRAME, t, 100), ev("compute", t + 1, 98),
                   ev("points.compact_active", t + 30, 10)]
        if with_span:
            events.append(ev("points.reach", t + 31, 4 + f))
    stats = [dict(occupied_blocks=n) for n in (8000, 8300, 8900)]
    tr = tracing.Trace(events, 3, stats, conf)
    if with_span:
        assert read(base, "points.reach_ms", tr) == pytest.approx(
            (4 + 5 + 6) / 3 / 1e3)
    else:
        assert read(base, "points.reach_ms", tr) is None
    assert read(base, "window_blocks_per_frame", tr) == pytest.approx(8400)
    bare = tracing.Trace(events, 3, [{}] * 3, conf)
    assert read(base, "window_blocks_per_frame", bare) is None
