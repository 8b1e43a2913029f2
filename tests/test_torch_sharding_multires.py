"""Multi-resolution with starvation and GC on the port's sharded steps, on
4 spawned CPU ranks (gloo) against the JAX package's sharded steps over 4
virtual CPU devices: the frames where coarsening, the merged starve and
GC meet.

1. RGB-D at threshold 0.5 on test_multichip.py's noisy wall, starving
   every 2 frames, 4 frames: starve and GC run on the pre-coarsen window
   minus the entries coarsening freed, and GC on a starve frame decides
   from the pool after the starve (the JAX sharded step's order); each
   rank's map equals the JAX shard by key (resolutions equal, weight and
   rgbp exact, sdf within 2e-5, sumsq within 5e-4), the stats equal.
2. LiDAR, the point-centric walk (the ring's radial normals) at
   threshold 10 with GC on every scan, 2 scans: coarsening decided from
   the pool, then the window compacted again, so GC reads the fresh
   coarse blocks (unlike the single-process step, which collects them
   from the next scan on).  The recompacted window's count, high_free
   and every block both packages keep are equal (the bounds above); the
   reference keeps, and the port frees, only coarse blocks whose
   weighted voxels all sit within 1e-6 of the truncation (the
   downsample's mean of children clamped at +t is t in the port and an
   ulp under it in the reference, PORT_NOTES.md P69), each returning its
   low id (low_free larger by their count).
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core.state import MapConfig

N = 4


def _check(cfg_kw, kind, frames, camera=SH.CAM, **jax_kw):
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, kind, N, frames,
                                          camera=camera, **jax_kw)
    results = SH.run_port(MapConfig(**cfg_kw), kind, N, frames,
                          camera=camera)
    for r in range(N):
        assert results[r]["stats"] == ref_stats, (r, results[r]["stats"])
    SH.assert_shards_match(results, ref, N)
    SH.assert_owned(results, N)
    got = SH.union([r["state"] for r in results])
    n = SH.assert_same_map(got, SH.union(SH.reference_shards(ref, N)))
    n1 = sum(b[0] for b in got.values())
    assert n1 > 0, "no block coarsened"
    print(f"{kind}: {len(got)} blocks ({n1} at res 1), {n} weighted "
          f"voxels, stats {ref_stats}")


def test_sharded_rgbd_multires_starve_matches_reference():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (SH.ROWS, SH.COLS, 3)).astype(np.uint8)
    frames = [(SH.EYE, SH.ZERO, (2.0 + rng.normal(0, 0.004, (
        SH.ROWS, SH.COLS))).astype(np.float32), rgb) for _ in range(4)]
    _check(dict(SH.CFG, sdf_var_threshold=0.5, n_frames_invalidate_voxels=2),
           "rgbd", frames)


def test_sharded_point_centric_multires_gc_matches_reference():
    pts, nrm = SH.ring()
    rng = np.random.default_rng(4)
    frames = []
    for _ in range(2):
        r = 1.0 + rng.normal(0, 0.002, (pts.shape[0], 1)).astype(np.float32)
        frames.append((SH.EYE, SH.ZERO, pts * r, nrm))
    trunc = 0.4
    cfg_kw = dict(SH.CFG, virtual_voxel_size=0.2, sdf_truncation=trunc,
                  max_integration_distance=50.0, projective_sdf=False,
                  sdf_var_threshold=10.0, n_frames_invalidate_voxels=2)
    camera = SH.lidar_cam(SH.COLS)
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, "points", N, frames,
                                          camera=camera,
                                          lookup_dedup_scratch=1 << 22)
    results = SH.run_port(MapConfig(**cfg_kw), "points", N, frames,
                          camera=camera)
    SH.assert_owned(results, N)
    got = SH.union([r["state"] for r in results])
    want = SH.union(SH.reference_shards(ref, N))
    assert not set(got) - set(want)
    kept = {k: want.pop(k) for k in set(want) - set(got)}
    for res, f in kept.values():
        w = f["weight"] > 0
        assert res == 1 and w.any(), "a freed block that is not coarse"
        assert np.abs(np.abs(f["sdf"][w]) - trunc).max() <= 1e-6
    n = SH.assert_same_map(got, want, min_weighted=300)   # 64-voxel blocks
    for r in range(N):
        for g, w in zip(results[r]["stats"], ref_stats):
            assert {k: g[k] for k in ("frame", "occupied_blocks",
                                      "high_free")} == \
                {k: w[k] for k in ("frame", "occupied_blocks", "high_free")}
        assert results[r]["stats"][-1]["low_free"] == \
            ref_stats[-1]["low_free"] + len(kept)
    n1 = sum(b[0] for b in got.values())
    assert n1 > 0, "no block coarsened"
    print(f"points: {len(got)} blocks ({n1} at res 1), {n} weighted voxels, "
          f"{len(kept)} coarse blocks of truncated free space the reference "
          f"keeps, stats {ref_stats}")
