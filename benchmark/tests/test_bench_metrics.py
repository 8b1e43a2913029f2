"""Each per-layer reader on a small recorded trace: two frames, the
program's stage ranges on the host, kernels launched inside them."""
import json
import os

import harness
import pytest
import tracing
import work

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def recorded(prefix):
    """Frames at [0, 100) and [100, 200) us; in each, the stage ranges
    of the cell's pipeline over 10 us each, a launch at 2 us into each
    range and its 4 us kernel at 5 us into it; a memcpy outside any range,
    and a kernel after the window (left out)."""
    stages = {"rgbd": ["rgbd.alloc", "rgbd.integrate", "rgbd.coarsen",
                       "rgbd.starve_gc"],
              "points": ["points.alloc_candidates", "points.alloc_blocks",
                         "points.raster", "points.projection", "points.K3",
                         "points.coarsen"]}[prefix]
    events = [ev("user_annotation", tracing.WINDOW, 0, 200)]
    corr = 0
    for f in range(2):
        t = 100 * f
        events.append(ev("user_annotation", tracing.FRAME, t, 100))
        for k, s in enumerate(stages):
            a = t + 10 * k
            corr += 1
            events += [ev("user_annotation", s, a, 10),
                       ev("cuda_runtime", "cudaLaunchKernel", a + 2, 1, corr),
                       ev("kernel", f"k_{s}", a + 5, 4, corr)]
        events.append(ev("gpu_memcpy", "Memcpy DtoH", t + 90, 5, 999 + f))
    events.append(ev("kernel", "late", 300, 10, 5000))
    return events, len(stages)


def read(name, trace):
    return harness.load_reader(BENCH_DIR, name)(trace)


@pytest.mark.parametrize("prefix,config", [
    ("rgbd", "replica_rgbd_mr"), ("points", "newer_college_lidar_mr")])
def test_readers_on_a_recorded_trace(prefix, config):
    with open(os.path.join(BENCH_DIR, "configs", f"{config}.json")) as f:
        conf = json.load(f)
    stats = [dict(occupied_blocks=1000, res0_blocks=100)] * 2
    events, n_stages = recorded(prefix)
    tr = tracing.Trace(events, 2, stats, conf)
    busy = 2 * (n_stages * 4 + 5)
    assert tr.busy_us() == busy
    assert read("device_idle_pct", tr) == pytest.approx(
        100 * (1 - busy / 200))
    assert read("launches_per_frame", tr) == n_stages
    host = {"rgbd": {"rgbd.alloc_ms": 1, "rgbd.coarsen_ms": 1,
                     "rgbd.starve_gc_ms": 1},
            "points": {"points.alloc_ms": 2, "points.coarsen_ms": 1,
                       "points.project_ms": 2}}[prefix]
    for name, n_ranges in host.items():
        assert read(name, tr) == pytest.approx(n_ranges * 10 / 1e3)
    other = "points" if prefix == "rgbd" else "rgbd"
    for name in {"rgbd": ["rgbd.alloc_ms"], "points": ["points.alloc_ms"]}[
            other]:
        assert read(name, tr) is None               # nothing to read
    roof, rng, wk = {
        "rgbd": ("rgbd.integrate.roofline_pct", "rgbd.integrate",
                 lambda s: work.rgbd_integrate(s, conf["sensor"],
                                               conf["map"]["num_buckets"])),
        "points": ("points.K3.roofline_pct", "points.K3",
                   lambda s: work.points_k3(s, conf["sensor"]))}[prefix]
    assert tr.device_us_in(rng) == 8
    least = 2 * work.least_s(*wk(stats[0]))
    assert read(roof, tr) == pytest.approx(100 * least / 8e-6)
    assert read({"rgbd": "points.K3.roofline_pct",
                 "points": "rgbd.integrate.roofline_pct"}[prefix],
                tr) is None
    b = tr.breakdown()
    assert [n for n, _ in b["device_ops"]][0] == "Memcpy DtoH"
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        (200 - busy) / 1e6)
    assert dict(b["idle_gaps"])[tracing.FRAME] > 0


def test_work_counts_each_byte_once():
    s = dict(occupied_blocks=10, res0_blocks=4)
    sensor = dict(rows=2, cols=3)
    vox = 4 * 512 + 6 * 64
    assert work.window_voxels(s) == vox
    assert work.points_k3(s, sensor) == (6 * 4 + vox * 12 + 10 * 16,
                                         vox * work.PROJECT_FLOPS)
    assert work.rgbd_integrate(s, sensor, 7)[0] == (
        7 * 10 * 16 + 10 * 28 + 6 * 7 + vox * 12 + 10 * 16)
    assert work.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 67e12) == pytest.approx(1.0)
