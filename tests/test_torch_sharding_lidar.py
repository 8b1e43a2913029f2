"""The port's sharded LiDAR step on 4 spawned CPU ranks (gloo) against the
JAX package's sharded step over 4 virtual CPU devices, on
tests/test_multichip.py's 512-point ring (10 m, 0.2 m voxels) at the
identity pose; each rank's map against the JAX shard of the same rank,
the summed stats equal, every key on its owner.

1. The point-centric walk (projective_sdf=False, the ring's radial
   normals; the JAX lookup's scratch made large enough that it drops no
   visit, as tests/test_torch_lidar_points.py does), 3 scans with
   starvation on scan 2 (the merged spherical z-buffer, K2's twin against
   the JAX gather readback) and GC on every scan: keys equal, weight
   exact, sdf within 2e-5, sumsq within 5e-4; the walk on each rank
   resolves its own blocks only.
2. The projective update (K3's twin on each rank's window over the whole
   ring) against the JAX fused kernel in interpret mode, multi-resolution
   at threshold 10 (coarsening without reintegration, then the window
   compacted again), 3 scans of a 128-column raster: same keys and
   resolutions, tests/test_torch_lidar.py's bounds (weight flips <=
   max(16, 1e-4 lanes), sdf within 2e-3 where the weights agree).
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core.state import MapConfig

N = 4
LIDAR = dict(SH.CFG, virtual_voxel_size=0.2, sdf_truncation=0.4,
             max_integration_distance=50.0)


def test_sharded_point_centric_matches_reference():
    cfg_kw = dict(LIDAR, projective_sdf=False, n_frames_invalidate_voxels=2)
    pts, nrm = SH.ring()
    frames = [(SH.EYE, SH.ZERO, pts, nrm)] * 3
    cam = SH.lidar_cam(SH.COLS)
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, "points", N, frames,
                                          camera=cam,
                                          lookup_dedup_scratch=1 << 22)
    results = SH.run_port(MapConfig(**cfg_kw), "points", N, frames,
                          camera=cam)
    for r in range(N):
        assert results[r]["stats"] == ref_stats, (r, results[r]["stats"])
    SH.assert_shards_match(results, ref, N)
    SH.assert_owned(results, N)
    n = SH.assert_same_map(SH.union([r["state"] for r in results]),
                           SH.union(SH.reference_shards(ref, N)))
    print(f"point-centric: {n} weighted voxels, stats {ref_stats}")


def test_sharded_projective_matches_reference():
    cfg_kw = dict(LIDAR, max_integration_distance=40.0,
                  n_frames_invalidate_voxels=0, sdf_var_threshold=10.0)
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(3):
        pts, cam = SH.scan(rng)
        frames.append((SH.EYE, SH.ZERO, pts, None))
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, "points", N, frames,
                                          camera=cam, sample_mode="fused",
                                          pallas_interpret=True)
    results = SH.run_port(MapConfig(**cfg_kw), "points", N, frames,
                          camera=cam)
    for r in range(N):
        assert results[r]["stats"] == ref_stats, (r, results[r]["stats"])
    SH.assert_shards_match(results, ref, N, lidar=True)
    SH.assert_owned(results, N)
    got = SH.union([r["state"] for r in results])
    flips = SH.assert_close_lidar(got, SH.union(SH.reference_shards(ref, N)))
    n1 = sum(b[0] for b in got.values())
    assert n1 > 0, "no block coarsened"
    print(f"projective: {len(got)} blocks, {n1} at res 1, {flips} weight "
          f"flips, stats {ref_stats}")
