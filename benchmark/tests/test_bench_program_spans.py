"""The readers of the frame step's inner spans and counters on small
recorded traces: two frames, the program's compute, compute.upload,
rgbd.* / points.* and alloc.* ranges nested as the program opens them,
and last_stats with the counters; and on a trace of a program without
them, where each reader finds nothing."""
import json
import os

import harness
import pytest
import tracing
import work

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("upload_ms", "rgbd.alloc_candidates_ms", "rgbd.alloc_insert_ms",
       "rgbd.compact_ms", "rgbd.K1.roofline_pct", "host_syncs_per_frame",
       "alloc_new_pct", "map_changes_per_frame")
# (name, start, end) in us from the frame's start; a launch at 1 us into
# rgbd.K1 runs a 4 us kernel, one at 2 us a 1 us copy (the launch operands)
RANGES = {
    "rgbd": [("compute", 1, 99), ("compute.upload", 2, 6),
             ("rgbd.alloc", 10, 30), ("rgbd.alloc.cloud", 11, 13),
             ("rgbd.alloc.candidates", 13, 20), ("alloc.dedup", 20, 24),
             ("alloc.insert", 24, 29), ("rgbd.integrate", 30, 50),
             ("rgbd.compact", 31, 39), ("rgbd.K1", 40, 49),
             ("rgbd.coarsen", 50, 60), ("rgbd.starve_gc", 60, 70),
             ("rgbd.stats", 70, 75)],
    "points": [("compute", 1, 99), ("compute.upload", 2, 5),
               ("points.alloc_candidates", 10, 20),
               ("points.alloc_blocks", 20, 30), ("alloc.dedup", 21, 24),
               ("alloc.insert", 24, 29), ("points.compact_active", 30, 35),
               ("points.raster", 35, 40), ("points.projection", 40, 45),
               ("points.K3", 45, 50), ("points.coarsen", 50, 55),
               ("points.stats", 55, 60)]}
STATS = [dict(occupied_blocks=1000, res0_blocks=100, alloc_keys=400,
              alloc_new=3, coarsened=2, gc_freed=5, host_syncs=17),
         dict(occupied_blocks=1000, res0_blocks=100, alloc_keys=200,
              alloc_new=1, coarsened=0, gc_freed=4, host_syncs=19)]


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded(prefix, ranges=None):
    events = [ev("user_annotation", tracing.WINDOW, 0, 200)]
    for f in range(2):
        t = 100 * f
        events.append(ev("user_annotation", tracing.FRAME, t, 100))
        for name, a, b in RANGES[prefix] if ranges is None else ranges:
            events.append(ev("user_annotation", name, t + a, b - a))
            if name == "rgbd.K1":
                events += [
                    ev("cuda_runtime", "cudaLaunchKernel", t + a + 1, 1,
                       10 * f + 1),
                    ev("kernel", "mrhash_fused_integrate", t + a + 4, 4,
                       10 * f + 1),
                    ev("cuda_runtime", "cudaMemcpyAsync", t + a + 2, 1,
                       10 * f + 2),
                    ev("gpu_memcpy", "Memcpy HtoD", t + a + 3, 1,
                       10 * f + 2)]
    return events


def conf_of(prefix):
    name = {"rgbd": "replica_rgbd_mr",
            "points": "newer_college_lidar_mr"}[prefix]
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def read(name, trace):
    return harness.load_reader(BENCH_DIR, name)(trace)


@pytest.mark.parametrize("prefix", ["rgbd", "points"])
def test_new_readers_on_a_recorded_trace(prefix):
    conf = conf_of(prefix)
    tr = tracing.Trace(recorded(prefix), 2, STATS, conf)
    got = {name: read(name, tr) for name in NEW}
    assert got["upload_ms"] == pytest.approx(
        {"rgbd": 4, "points": 3}[prefix] / 1e3)
    assert got["host_syncs_per_frame"] == pytest.approx(18.0)
    assert got["alloc_new_pct"] == pytest.approx(100 * 4 / 600)
    assert got["map_changes_per_frame"] == pytest.approx(15 / 2)
    if prefix == "points":          # alloc.* outside rgbd.alloc
        assert [got[n] for n in NEW if n.startswith("rgbd.")] == [None] * 4
        return
    assert got["rgbd.alloc_candidates_ms"] == pytest.approx(7 / 1e3)
    assert got["rgbd.alloc_insert_ms"] == pytest.approx(9 / 1e3)
    assert got["rgbd.compact_ms"] == pytest.approx(8 / 1e3)
    assert tr.device_us_in("rgbd.K1") == 10
    sensor = conf["sensor"]
    vox = 100 * 512 + 900 * 64
    nbytes = (sensor["rows"] * sensor["cols"] * 7 + vox * work.VOXEL_STATE
              + 1000 * work.FLAGS)
    least = work.least_s(nbytes, vox * work.PROJECT_FLOPS)
    assert got["rgbd.K1.roofline_pct"] == pytest.approx(
        100 * 2 * least / 10e-6)


def test_new_readers_find_nothing_without_the_spans_and_counters():
    """A program without the spans and counters: old ranges, old stats
    keys; and a trace whose frames submitted no key."""
    old = [r for r in RANGES["rgbd"]
           if r[0] in ("rgbd.alloc", "rgbd.integrate", "rgbd.coarsen",
                       "rgbd.starve_gc", "rgbd.stats")]
    stats = [dict(occupied_blocks=1000, res0_blocks=100)] * 2
    tr = tracing.Trace(recorded("rgbd", old), 2, stats, conf_of("rgbd"))
    assert {name: read(name, tr) for name in NEW} == dict.fromkeys(NEW)
    none_in = [dict(s, alloc_keys=0, alloc_new=0) for s in STATS]
    tr = tracing.Trace(recorded("rgbd"), 2, none_in, conf_of("rgbd"))
    assert read("alloc_new_pct", tr) is None
    assert read("map_changes_per_frame", tr) == pytest.approx(11 / 2)
