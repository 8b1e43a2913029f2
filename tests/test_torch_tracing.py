"""The frame step's spans and counters (utils/profiler.py: stage(),
COUNTS) through GeoWrapper.compute.

Four paths: tests/test_torch_multires.py's 64x256 multi-res RGB-D frames
(GC every frame, a starve on frame 3), tests/test_torch_lidar.py's 16x128
single-resolution LiDAR scans through K3 (GC off), the same scans
through the point-centric walk with MADtree normals, starving and
collecting every 2 scans, and the same scans at multi-resolution with
coarsening held to 4 blocks a scan and the sensor moved 60 m on from
scan 2, so the window bounded to the sensor's reach serves decisions
carried from beyond it.  The CPU cases run 3 frames under
torch.profiler (CPU activity) and hold:

- every span opens once a frame (alloc.* once an allocation round; a
  starve once in the 3 frames) inside its parent's interval, and every
  range the frame step had before still opens;
- the counters of last_stats: alloc_keys >= alloc_new; the occupied
  blocks change by alloc_new - gc_freed (coarsening frees and inserts one
  block for each it serves), so at one resolution with GC off by alloc_new
  alone, the empty map's first frame included; coarsened > 0 on a frame
  where res0_blocks falls; on the moved scan a window smaller than the
  map and coarsen_carried > 0; window_cut 0; host_syncs a positive int,
  equal on a second run of the same frames without the profiler, as are
  the other keys; the stream counters 0.

The `gpu` cases (`python -m pytest --noconftest -m gpu
tests/test_torch_tracing.py` on the card) hold host_syncs, frame by
frame, equal to the profiler's count of the runtime's synchronizations
(its events named *Synchronize*) inside the `compute` range, with
allocation on its kernels K7-K9 (one counted host read a round, their
launches counted every frame); and coarsen_syncs equal to the count
inside the coarsening range (rgbd.coarsen, points.coarsen), on the
multi-res RGB-D path and on the reach path, a drive-like map whose
fresh blocks coarsen through kernels K10-K12: there a scan that
coarsens passes 3 sync sites (the decision, K10's and K9's reads), any
other multi-res scan 1.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import test_torch_lidar as LI
import test_torch_multires as MR
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.utils.profiler import COUNTS

OLD_KEYS = {"occupied_blocks", "occupied_total", "high_free", "low_free",
            "frame", "unserved_blocks", "res0_blocks"}
NEW_KEYS = {"alloc_keys", "alloc_new", "coarsened", "gc_freed",
            "window_cut", "coarsen_carried", "coarsen_syncs", "host_syncs",
            "coarsen_unserved", "gc_unserved"}
# the streaming of the frame (GeoWrapper._stream_counts): none on these
# maps, which never reach the stream watermark
STREAM_KEYS = {"streamed_out", "streamed_out_voxels", "streamed_in",
               "stream_clashed", "stream_joined", "stream_ingest_ms",
               "stream_refills"}
# span: its parent
SPANS = {
    "rgbd": {"compute": None, "compute.upload": "compute",
             "rgbd.alloc": "compute", "rgbd.alloc.cloud": "rgbd.alloc",
             "rgbd.alloc.candidates": "rgbd.alloc",
             "alloc.dedup": "rgbd.alloc", "alloc.insert": "rgbd.alloc",
             "rgbd.integrate": "compute", "rgbd.compact": "rgbd.integrate",
             "rgbd.K1": "rgbd.integrate", "rgbd.coarsen": "compute",
             "rgbd.starve_gc": "compute", "rgbd.stats": "compute"},
    "lidar": {"compute": None, "compute.upload": "compute",
              "points.alloc_candidates": "compute",
              "points.alloc_blocks": "compute",
              "alloc.dedup": "points.alloc_blocks",
              "alloc.insert": "points.alloc_blocks",
              "points.compact_active": "compute",
              "points.reach": "points.compact_active",
              "points.raster": "compute", "points.projection": "compute",
              "points.K3": "compute", "points.coarsen": "compute",
              "points.stats": "compute"},
    "points": {"compute": None, "compute.upload": "compute",
               "points.alloc_candidates": "compute",
               "points.alloc_blocks": "compute",
               "alloc.dedup": "points.alloc_blocks",
               "alloc.insert": "points.alloc_blocks",
               "points.compact_active": "compute", "points.walk": "compute",
               "points.coarsen": "compute", "points.starve": "compute",
               "points.gc": "compute", "points.stats": "compute"}}
SPANS["reach"] = SPANS["lidar"]
ONCE = {"points.starve"}       # frame 2 of 3
MOVED = 2                      # the reach path's sensor moves on here
ALLOC = ("alloc_walk", "alloc_compact", "alloc_insert")   # K7, K8, K9


def _wrapper(path, device):
    """A GeoWrapper for the path's scene and feed(i), which runs frame i
    (the scene's frames in turn, the pose moving on)."""
    if path == "rgbd":
        kw = MR.KW
        gw = GeoWrapper(kw["sdf_truncation"], 0.0, 1,
                        kw["virtual_voxel_size"],
                        kw["n_frames_invalidate_voxels"], 1,
                        sdf_var_threshold=kw["sdf_var_threshold"],
                        num_blocks=kw["num_blocks"],
                        max_active_blocks=kw["max_active_blocks"],
                        max_alloc_per_frame=kw["max_alloc_per_frame"],
                        profiling=False, device=device)
        gw.setCamera(*MR.CAM)
        frames, rgb = MR._rgbd_frames(translate=True)

        def feed(i):
            d, _, _ = frames[i % len(frames)]
            gw.setCurrPose([0.01 * i, 0.005 * i, 0.0], [0.0, 0.0, 0.0, 1.0])
            gw.setDepthImage(d)
            gw.setRGBImage(rgb)
            gw.compute()
    else:
        cfg, walk = LI.CFG, path == "points"
        gw = GeoWrapper(cfg["sdf_truncation"], 0.0, 1,
                        cfg["virtual_voxel_size"], 2 if walk else 0, 1,
                        min_depth=0.2, max_depth=LI.MAX_D,
                        sdf_var_threshold=1.0 if path == "reach" else 0.0,
                        num_blocks=cfg["num_blocks"],
                        num_buckets=cfg["num_buckets"],
                        max_active_blocks=cfg["max_active_blocks"],
                        max_alloc_per_frame=cfg["max_alloc_per_frame"],
                        projective_sdf=not walk, profiling=False,
                        device=device)
        gw.setCamera(*LI.CAM, camera_model=C.SPHERICAL)
        scans = LI._frames()
        if path == "reach":
            gw.cfg = dataclasses.replace(gw.cfg, max_coarsen_per_frame=4)

        def feed(i):
            t, pts = scans[i % len(scans)]
            if path == "reach" and i >= MOVED:
                t = t + np.float32([60.0, 0.0, 0.0])
            gw.setCurrPose(t, [0.0, 0.0, 0.0, 1.0])
            gw.setPointCloud(pts, LI._normals(i % len(scans)) if walk
                             else False)
            gw.compute()
    return gw, feed


def _run(path, n, traced):
    """last_stats of frames 0..n-1 on the CPU, and with `traced` the
    profiler's {range name: [(start, end)]} (us).  Each run starts as a
    fresh process would: the constants the frame step uploads once
    (coords.on_device) upload again on its first frame."""
    X.on_device.cache_clear()
    gw, feed = _wrapper(path, "cpu")
    stats, ranges = [], {}
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(n):
                feed(i)
                stats.append(dict(gw.last_stats))
        for e in prof.events():
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    else:
        for i in range(n):
            feed(i)
            stats.append(dict(gw.last_stats))
    occupied = int((gw.state.table.ptr != P.FREE_ENTRY).sum())
    gw.close()
    return stats, ranges, occupied


@pytest.mark.parametrize("path", ["rgbd", "lidar", "points", "reach"])
def test_spans_and_counters_of_the_frame_step(path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the wrapper writes its memory report
    n = 3
    stats, ranges, occupied = _run(path, n, traced=True)

    for name, parent in SPANS[path].items():
        spans = ranges.get(name, [])
        assert len(spans) == (1 if name in ONCE else n), (name, len(spans))
        for a, b in spans:
            if parent is not None:
                assert any(pa <= a and b <= pb for pa, pb in ranges[parent]), (
                    name, parent)

    prev = 0
    for i, st in enumerate(stats):
        keys = OLD_KEYS | NEW_KEYS | STREAM_KEYS | (
            {"visited_keys", "distinct_keys"} if path == "points" else set())
        assert set(st) == keys, set(st) ^ keys
        assert all(type(st[k]) is int for k in NEW_KEYS), st
        assert not any(st[k] for k in STREAM_KEYS), st
        assert st["alloc_keys"] >= st["alloc_new"] >= 0
        assert st["host_syncs"] > 0
        assert st["occupied_total"] - prev == st["alloc_new"] - st["gc_freed"]
        prev = st["occupied_total"]
    assert stats[0]["occupied_total"] > 0
    assert stats[-1]["occupied_total"] == occupied
    assert all(st["window_cut"] == 0 for st in stats)
    if path == "lidar":          # one resolution, GC off
        assert all(st["gc_freed"] == st["coarsened"] == 0 for st in stats)
    elif path == "reach":        # GC off
        moved = stats[MOVED]
        assert all(st["gc_freed"] == 0 for st in stats)
        assert moved["occupied_blocks"] < moved["occupied_total"], stats
        assert moved["coarsen_carried"] > 0, stats
    elif path == "points":
        assert all(st["coarsened"] == 0 for st in stats)
    else:
        assert any(b["coarsened"] > 0 and b["res0_blocks"] < a["res0_blocks"]
                   for a, b in zip(stats, stats[1:])), stats
        assert sum(st["gc_freed"] for st in stats) > 0, stats

    again, _, _ = _run(path, n, traced=False)
    assert again == stats


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host syncs are the card's")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rgbd", "lidar", "points", "reach"])
def test_host_syncs_match_the_profiler_on_card(path, cuda, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    gw, feed = _wrapper(path, cuda)
    feed(0)                 # builds the kernels' library
    torch.cuda.synchronize()
    alloc0 = {k: COUNTS[k] for k in ALLOC}
    counted = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, 6):
            feed(i)
            counted.append(gw.last_stats["host_syncs"])
        torch.cuda.synchronize()
    # host events only: a range also has a device-side twin of its name
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    frames = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "compute")
    syncs = [e.time_range.start for e in events if "Synchronize" in e.name]
    seen = [sum(a <= t <= b for t in syncs) for a, b in frames]
    gw.close()
    assert len(frames) == 5
    assert seen == counted
    assert min(counted) > 0
    # allocation ran on its kernels, one round a frame (coarsening's
    # inserts launch K9 too)
    alloc = {k: COUNTS[k] - alloc0[k] for k in ALLOC}
    assert alloc["alloc_walk"] == alloc["alloc_compact"] == 5, alloc
    assert alloc["alloc_insert"] >= 5, alloc


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rgbd", "reach"])
def test_coarsen_syncs_match_the_profiler_on_card(path, cuda, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    gw, feed = _wrapper(path, cuda)
    feed(0)                 # builds the kernels' library
    torch.cuda.synchronize()
    name = "rgbd.coarsen" if path == "rgbd" else "points.coarsen"
    k10 = COUNTS["coarsen_select"]
    counted, served = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, 6):
            feed(i)
            counted.append(gw.last_stats["coarsen_syncs"])
            served.append(gw.last_stats["coarsened"])
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name)
    syncs = [e.time_range.start for e in events if "Synchronize" in e.name]
    seen = [sum(a <= t <= b for t in syncs) for a, b in spans]
    gw.close()
    assert len(spans) == 5
    assert seen == counted, (seen, served)
    assert any(served), served
    assert COUNTS["coarsen_select"] - k10 == sum(n > 0 for n in served)
    if path == "reach":
        assert counted == [3 if n else 1 for n in served], (counted, served)
