"""The LiDAR window bounded to the sensor's reach (core/pipeline.py::
integrate_points, ops/integrate.py::compact_window), against the plain
reference's replay (benchmark/reference/replay.py, plain torch, which
imports neither JAX nor the port), compared through the benchmark's
compare.map_content and compare.compare with every number 0.

Scene: benchmark/configs/kitti_lidar_mr.json at a CPU size (an 8x64
scan, a 10 m range, 2^12 blocks), driving benchmark/scene_kinds/
lidar_street.py's street at 1.6 m a scan for 60 scans, so the map
(~1,750 entries) outgrows a window cap of 2^9 while the sensor's reach
holds ~270; and the loop's court (benchmark/traffic/loop.json), whose
whole map lies within reach of every scan.

- the drive past the cap equals the reference, with no entry cut from a
  window; with coarsening held to 4 blocks a scan, decisions queue while
  their blocks leave reach and are served from beyond it;
- on the loop's scans the bounded window is the window of every block,
  slot for slot;
- a cap below the reach set counts the entries it leaves out
  (last_stats' window_cut) and warns once;
- the point-centric walk and a path with GC on keep every block;
- a drive whose pool of 2^8 blocks streams evicts nothing within reach
  (a spherical sensor's protect radius is its reach plus a block's
  diagonal), matches the reference, and each stream-out brings its pool
  back over the watermark, where the pinhole radius (~34 m at these
  intrinsics, the spherical sensor's before) kept more on the card and
  streamed out on nearly every scan; a block streamed back in takes its
  coarsening decision again on the next scan.
"""
import functools
import json
import math
import os
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import compare  # noqa: E402
import program  # noqa: E402
import scenes  # noqa: E402
from reference import replay  # noqa: E402

from mrhash_tpu_torch import params as P  # noqa: E402
from mrhash_tpu_torch.core import pipeline, streaming  # noqa: E402
from mrhash_tpu_torch.ops import integrate as I  # noqa: E402

SEED = 2**31 + 17
RANGE = 10.0
REACH = RANGE + 0.4                       # max_depth + truncation
STREET = dict(scene="lidar_street", ground_z=-1.73, half_width_m=6.0,
              lot_m=4.8, period_m=9.6, step_m=1.6, setback_m=[0.0, 2.0],
              height_m=[3.0, 9.0], depth_m=6.0, gaps=0, noise_m=0.01)
N_DRIVE = 60


def load(name):
    with open(os.path.join(BENCH, name)) as f:
        return json.load(f)


def drive_conf(**map_config):
    """The drive's configuration at the CPU size; `map_config` overrides
    MapConfig fields (or GeoWrapper capacities by their names)."""
    conf = load("configs/kitti_lidar_mr.json")
    conf["sensor"].update(rows=8, cols=64, max_depth=RANGE)
    conf["map"].update(max_depth=RANGE, num_blocks=1 << 12,
                       num_buckets=1 << 10, max_active_blocks=1 << 9,
                       max_alloc_per_frame=1024)
    caps = {k: map_config.pop(k) for k in list(map_config)
            if k in conf["map"]}
    conf["map"].update(caps)
    conf["map_config"] = map_config
    return conf


def run(conf, frames, n):
    """The program through GeoWrapper on the CPU: (its map, the union of
    the device map and the host grid; the stream counts; each scan's
    last_stats; the warnings it raised)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gw = program.build(conf, frames, "cpu")
        stats = [dict(program.feed(gw, frames, i)) for i in range(n)]
        program.close(gw)
    got, streams = program.read_map(gw)
    return got, streams, stats, [w for w in caught
                                 if issubclass(w.category, RuntimeWarning)]


def reference(conf, frames, n):
    return replay.replay(conf, frames, n, "cpu", compare.map_content)


def assert_equal_maps(got, want):
    numbers = compare.compare(got, want)
    assert numbers["ref_blocks"] > 0
    for k in ("blocks_apart", "weight_apart", "sdf_gap", "rgb_apart"):
        assert numbers[k] == 0.0, numbers
    return numbers


@functools.lru_cache(maxsize=None)
def street_frames():
    return scenes.make(STREET, drive_conf()["sensor"], SEED, "cpu")


@pytest.fixture
def street():
    return street_frames()


@pytest.mark.parametrize("map_config", [
    {},
    # coarsening served 4 blocks a scan: decisions queue while their
    # blocks leave the sensor's reach
    {"max_coarsen_per_frame": 4}])
def test_drive_past_the_cap_equals_the_reference(street, tmp_path,
                                                 monkeypatch, map_config):
    monkeypatch.chdir(tmp_path)          # the wrapper's memory report
    conf = drive_conf(**map_config)
    got, _, stats, warned = run(conf, street, N_DRIVE)
    numbers = assert_equal_maps(got, reference(conf, street, N_DRIVE))
    cap = conf["map"]["max_active_blocks"]
    assert stats[-1]["occupied_total"] > 3 * cap
    assert max(s["occupied_blocks"] for s in stats) < cap
    assert all(s["window_cut"] == 0 for s in stats) and not warned
    assert sum(s["coarsened"] for s in stats) > 0
    if map_config:
        assert sum(s["coarsen_carried"] for s in stats) > 0, stats
    print(f"{map_config}: {numbers['ref_blocks']} blocks, windows "
          f"{min(s['occupied_blocks'] for s in stats[10:])}-"
          f"{max(s['occupied_blocks'] for s in stats)}, carried "
          f"{sum(s['coarsen_carried'] for s in stats)}")


def windows_of(monkeypatch, conf, frames, n, reach_window):
    """The slots of every scan's window, with the reach bound on or off."""
    seen = []
    real = I.compact_window

    def record(*a, **k):
        out = real(*a, **k)
        seen.append(out[0][0].tolist())
        return out
    monkeypatch.setattr(I, "compact_window", record)
    reach = pipeline._window_reach
    if not reach_window:
        monkeypatch.setattr(pipeline, "_window_reach", lambda cfg, cam: None)
    got, _, stats, _ = run(conf, frames, n)
    monkeypatch.setattr(I, "compact_window", real)
    monkeypatch.setattr(pipeline, "_window_reach", reach)
    return seen, got, stats


def test_loop_window_is_the_window_of_every_block(tmp_path, monkeypatch):
    conf = load("configs/newer_college_lidar_mr.json")
    conf["sensor"].update(rows=8, cols=64)
    conf["map"].update(num_blocks=1 << 12, num_buckets=1 << 10,
                       max_active_blocks=1 << 11, max_alloc_per_frame=1024)
    mix = load("traffic/loop.json")
    frames = scenes.make(mix, conf["sensor"], SEED, "cpu")
    n = 40
    monkeypatch.chdir(tmp_path)
    bounded, a, stats = windows_of(monkeypatch, conf, frames, n, True)
    every, b, _ = windows_of(monkeypatch, conf, frames, n, False)
    assert len(bounded) == n and bounded == every
    assert_equal_maps(a, b)
    assert_equal_maps(a, reference(conf, frames, n))
    assert stats[-1]["occupied_blocks"] == len(bounded[-1]) > 100


def test_a_cap_below_reach_counts_and_warns_once(street, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    cap = 128
    conf = drive_conf(max_active_blocks=cap)
    _, _, stats, warned = run(conf, street, 12)
    cut = [s["window_cut"] for s in stats]
    assert sum(c > 0 for c in cut) >= 2, cut
    assert all(s["occupied_blocks"] == cap for s, c in zip(stats, cut) if c)
    assert len(warned) == 1 and "max_active_blocks" in str(warned[0].message)


@pytest.mark.parametrize("map_config", [
    {"projective_sdf": False},           # the point-centric walk
    {"n_frames_invalidate_voxels": 2}])  # GC and starvation on
def test_other_paths_keep_every_block(street, tmp_path, monkeypatch,
                                      map_config):
    monkeypatch.chdir(tmp_path)
    conf = drive_conf(max_active_blocks=1 << 11)
    conf["map"].update(map_config)
    calls = []
    real = I.compact_window

    def record(cfg, table, *a, **k):
        occupied = table.ptr != P.FREE_ENTRY
        out = real(cfg, table, *a, **k)
        sensor = (STREET["step_m"] * len(calls), 0.0, 0.0)
        far = int((occupied & (nearest(table.pos, sensor) > REACH)).sum())
        calls.append((a, k.get("reach"), out[0][0].numel(),
                      int(occupied.sum()), far))
        return out
    monkeypatch.setattr(I, "compact_window", record)
    run(conf, street, 16)
    assert len(calls) == 16
    for args, reach, size, occupied, _ in calls:
        assert args == () and reach is None
        assert size == occupied
    # the map reaches beyond the sensor: a bounded window would be smaller
    assert calls[-1][-1] > 0


def nearest(pos, sensor):
    """Metres from `sensor` to each block's nearest point (0.2 m voxels)."""
    side = P.SDF_BLOCK_SIZE * 0.2
    lo = pos.to(torch.float64) * side
    o = torch.as_tensor(sensor, dtype=torch.float64)
    return (torch.maximum(torch.minimum(o, lo + side), lo) - o).norm(dim=-1)


def streaming_drive(monkeypatch, pinhole=False):
    """The drive with a pool of 2^8 blocks, which reaches its watermark
    near scan 8, and a split of 64 high blocks when the low heap runs
    short; with `pinhole` the stream trigger gets the radius a pinhole
    camera's would (~34 m at these intrinsics).  Returns the map, the
    stream counts and each stream-out's (radius, metres to the nearest
    block it evicted, free high blocks after it, resident entries after
    it)."""
    conf = drive_conf(num_blocks=1 << 8, max_active_blocks=1 << 11,
                      low_split_chunk=64)
    events, nearest_out = [], []
    plan, stream = streaming.plan_evictions, streaming.Streamer.stream

    def planned(cfg, table, cam_pos, radius, *a, **k):
        pos, ptr, res = plan(cfg, table, cam_pos, radius, *a, **k)
        nearest_out.append(float(nearest(pos, cam_pos).min())
                           if pos.shape[0] else math.inf)
        return pos, ptr, res

    def streamed(self, state, cam_pos, radius, *a, **k):
        if pinhole:
            fx, fy, _, _ = street_frames().intrinsics
            tanx = conf["sensor"]["cols"] / (2 * fx)
            tany = conf["sensor"]["rows"] / (2 * fy)
            radius = RANGE * math.sqrt(1 + tanx ** 2 + tany ** 2) + 0.5
        state = stream(self, state, cam_pos, radius, *a, **k)
        events.append((radius, nearest_out[-1], state.table.high_count,
                       int((state.table.ptr != P.FREE_ENTRY).sum())))
        return state
    monkeypatch.setattr(streaming, "plan_evictions", planned)
    monkeypatch.setattr(streaming.Streamer, "stream", streamed)
    got, streams, _, _ = run(conf, street_frames(), N_DRIVE)
    monkeypatch.setattr(streaming, "plan_evictions", plan)
    monkeypatch.setattr(streaming.Streamer, "stream", stream)
    return conf, got, streams, events


def test_spherical_stream_radius_is_reach_plus_a_block_diagonal(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    conf, got, streams, events = streaming_drive(monkeypatch)
    assert streams["events"] == len(events) >= 5
    assert streams["blocks_out"] > 0
    assert_equal_maps(got, reference(conf, street_frames(), N_DRIVE))
    diag = math.sqrt(3.0) * P.SDF_BLOCK_SIZE * 0.2
    watermark = P.STREAM_THRESHOLD * conf["map"]["num_blocks"]
    for radius, near, free, _ in events:
        assert radius == pytest.approx(REACH + diag)
        assert near > REACH                     # nothing within reach
        assert free > watermark                 # each event recovers


def test_the_pinhole_radius_kept_more_on_the_card(tmp_path, monkeypatch):
    """With ~34 m, the street kept on the card does not fit under the
    watermark: stream-outs find little or nothing beyond the radius and
    fire on nearly every scan, and more entries stay resident."""
    monkeypatch.chdir(tmp_path)
    conf, _, _, reach = streaming_drive(monkeypatch)
    _, _, _, wide = streaming_drive(monkeypatch, pinhole=True)
    watermark = P.STREAM_THRESHOLD * conf["map"]["num_blocks"]
    assert wide[0][0] > 30.0
    assert len(wide) > 2 * len(reach)
    assert sum(free <= watermark for _, _, free, _ in wide) > len(wide) // 2
    assert (max(n for *_, n in wide[:len(reach)])
            > max(n for *_, n in reach))


def test_a_block_streamed_back_in_decides_again(tmp_path, monkeypatch):
    """A block streamed out and back in is marked to take its coarsening
    decision again on the next scan, wherever it lies, as a window of
    every block would take it."""
    monkeypatch.chdir(tmp_path)
    conf = drive_conf(num_blocks=1 << 8, max_active_blocks=1 << 11,
                      low_split_chunk=64)
    frames = street_frames()
    gw = program.build(conf, frames, "cpu")
    for i in range(30):
        program.feed(gw, frames, i)
    gw.streamer.join()
    assert gw.streamer.grid.num_blocks() > 0
    resident = gw.state.table.ptr != P.FREE_ENTRY
    gw.state.coarsen_pending.zero_()
    # the stream trigger back at the start of the street, with no
    # stream-out: the blocks near it come back in
    monkeypatch.setattr(gw.streamer, "stream_out",
                        lambda state, *a, **k: state)
    gw.curr_trans = np.zeros(3, np.float32)
    gw._stream()
    back = (gw.state.table.ptr != P.FREE_ENTRY) & ~resident
    assert int(back.sum()) > 0
    assert torch.equal(gw.state.coarsen_pending, back)
    program.close(gw)
