"""The port's sharded RGB-D step under heap pressure, and a map carried
over from the JAX package's sharded state.

1. tests/test_multichip.py::test_sharded_soak_heap_pressure's invariants on
   the port at 4 spawned CPU ranks: 2^10 blocks (256 per rank), 12 frames
   of a camera orbiting a wavy wall (rotation only), starving every 4
   frames; on every rank and frame occupied + free = the local capacity;
   some rank's heap runs dry; every key on its owner and on one rank only;
   every rank holding blocks still integrates (a weight of at least 2).
2. State carry: 2 frames of the JAX sharded step at 4 devices, the state
   sliced into the 4 ranks' maps (core/convert.py::from_reference_sharded),
   then 2 more frames on both sides (starving on frame 2, the first of the
   carried frames): each rank's map equal to the JAX shard by key (weight
   and rgbp exact, sdf within 2e-5, sumsq within 5e-4), the stats equal.
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core import convert
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.parallel import sharding as S

N = 4


def test_sharded_soak_heap_pressure():
    cfg = MapConfig(virtual_voxel_size=0.05, sdf_truncation=0.15,
                    max_integration_distance=8.0, num_blocks=1024,
                    max_active_blocks=1024, max_alloc_per_frame=1024,
                    n_frames_invalidate_voxels=4)
    cap = S.local_config(cfg, N).num_blocks
    camera = SH.CAM[:7] + (8.0, 0)
    r = np.arange(SH.ROWS, dtype=np.float32)[:, None]
    c = np.arange(SH.COLS, dtype=np.float32)[None, :]
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    frames = []
    n_frames = 12
    for f in range(n_frames):
        th = 2.0 * np.pi * f / n_frames
        rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]], np.float32)
        depth = (3.0 + 0.8 * np.sin(c / 5 + f) + 0.5 * np.cos(r / 3)).astype(
            np.float32)
        frames.append((rot, SH.ZERO, depth, rgb))
    results = SH.run_port(cfg, "rgbd", N, frames, camera=camera)
    min_free = cap
    for rank, res in enumerate(results):
        for f, (occ, high_free, _) in enumerate(res["local"]):
            assert occ + high_free == cap, (rank, f, occ, high_free)
            min_free = min(min_free, high_free)
    assert min_free == 0, f"no rank ever exhausted its heap (min {min_free})"
    assert SH.assert_owned(results, N) > 0
    occ = []
    for rank, res in enumerate(results):
        b = SH.blocks(res["state"])
        occ.append(len(b))
        if b:
            assert max(int(v[1]["weight"].max()) for v in b.values()) >= 2
    print(f"soak: occupied per rank {occ} of {cap}, stats "
          f"{results[0]['stats'][-1]}")


def test_state_carried_from_reference_continues_equal():
    cfg_kw = dict(SH.CFG, n_frames_invalidate_voxels=2)
    rng = np.random.default_rng(5)
    r = np.arange(SH.ROWS, dtype=np.float32)[:, None]
    c = np.arange(SH.COLS, dtype=np.float32)[None, :]
    rgb = rng.integers(0, 255, (SH.ROWS, SH.COLS, 3)).astype(np.uint8)
    frames = [(SH.EYE, SH.ZERO, (2.0 + 0.2 * np.sin(c / 9 + i)
                                 + 0.1 * np.cos(r / 5)
                                 + rng.normal(0, 0.004, (SH.ROWS, SH.COLS))
                                 ).astype(np.float32), rgb)
              for i in range(4)]
    ref2, _, _, _, jstate = SH.run_reference(cfg_kw, "rgbd", N, frames[:2])
    carried = [convert.to_reference_arrays(s)
               for s in convert.from_reference_sharded(ref2, N)]
    ref4, ref_stats, *_ = SH.run_reference(cfg_kw, "rgbd", N, frames[2:],
                                           ref_state=jstate)
    results = SH.run_port(MapConfig(**cfg_kw), "rgbd", N, frames[2:],
                          states=carried)
    for rank in range(N):
        assert results[rank]["stats"] == ref_stats, rank
    SH.assert_shards_match(results, ref4, N)
    n = SH.assert_same_map(SH.union([res["state"] for res in results]),
                           SH.union(SH.reference_shards(ref4, N)))
    assert ref_stats[0]["frame"] == 2
    print(f"carry: {n} weighted voxels, stats {ref_stats}")
