"""Starvation on the port's sharded RGB-D step and the remainder split.

1. Starvation every 2 frames (tests/test_multichip.py::
   test_sharded_starve_executes_and_matches_single_chip's wall, 3
   frames): on frame 2 each of 4 spawned CPU ranks merges its z-buffer
   with all_reduce(MIN) before the readback; each rank's map equals the JAX
   shard of the same rank by key (weight exact, sdf within 2e-5, sumsq
   within 5e-4), the stats are equal, and the port's single-process map
   with starvation off has heavier voxels (the starve decremented some).
2. The remainder split (PORT_NOTES.md P65; the JAX module drops the last
   rows % n rows and N % n points, ROADMAP C19): 3 ranks on 32 rows, the
   last 2 rows seeing a wall 1 m farther than the rest, and on 511 LiDAR
   points, the last one 10 m farther than the ring; starvation off, every
   pixel allocating (alloc_pixel_stride 1).  The union of the ranks' keys
   equals the port's single-process map's, and holds the blocks that only
   the last rows and the last point reach.
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core.state import MapConfig


def test_sharded_starve_matches_reference():
    n = 4
    cfg_kw = dict(SH.CFG, n_frames_invalidate_voxels=2)
    depth = np.full((SH.ROWS, SH.COLS), 2.0, np.float32)
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    frames = [(SH.EYE, SH.ZERO, depth, rgb)] * 3
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, "rgbd", n, frames)
    results = SH.run_port(MapConfig(**cfg_kw), "rgbd", n, frames)
    for r in range(n):
        assert results[r]["stats"] == ref_stats, (r, results[r]["stats"])
    SH.assert_shards_match(results, ref, n)
    SH.assert_owned(results, n)
    got = SH.union([res["state"] for res in results])
    unstarved = SH.blocks(SH.run_single(
        MapConfig(**dict(cfg_kw, n_frames_invalidate_voxels=0)), "rgbd",
        frames))
    _, (g, w) = SH.stacked(got, unstarved)
    assert (g["weight"] < w["weight"]).any(), "the starve decremented nothing"
    assert (g["weight"] <= w["weight"]).all()


def test_remainder_rows_and_points_allocate():
    n = 3
    cfg = MapConfig(**dict(SH.CFG, n_frames_invalidate_voxels=0,
                           alloc_pixel_stride=1))
    depth = np.full((SH.ROWS, SH.COLS), 2.0, np.float32)
    depth[-(SH.ROWS % n):] = 3.0
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    frames = [(SH.EYE, SH.ZERO, depth, rgb)] * 2
    results = SH.run_port(cfg, "rgbd", n, frames)
    SH.assert_owned(results, n)
    got = SH.union([res["state"] for res in results])
    single = SH.blocks(SH.run_single(cfg, "rgbd", frames))
    SH.assert_same_map(got, single)
    # blocks past z = 2.15 m + a block: only the last rows' band reaches them
    assert max(k[2] for k in got) >= 7, "the last rows allocated nothing"

    lcfg = MapConfig(**dict(SH.CFG, virtual_voxel_size=0.2,
                            sdf_truncation=0.4, max_integration_distance=50.0,
                            n_frames_invalidate_voxels=0))
    pts, _ = SH.ring(511)
    pts[-1] *= 2.0                       # 20 m out, alone
    frames = [(SH.EYE, SH.ZERO, pts, None)] * 2
    cam = SH.lidar_cam(128)
    results = SH.run_port(lcfg, "points", n, frames, camera=cam)
    SH.assert_owned(results, n)
    got = SH.union([res["state"] for res in results])
    single = SH.blocks(SH.run_single(lcfg, "points", frames, camera=cam))
    assert set(got) == set(single)
    far = [k for k in got if max(abs(k[0]), abs(k[1])) >= 12]
    assert far, "the last point allocated nothing"
