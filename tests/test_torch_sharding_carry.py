"""A multi-resolution sharded map carried between the packages
(core/convert.py): the low heap and its counts per shard.

1. A 4-device JAX sharded state after 2 frames of the noisy wall at
   threshold 0.5 (res-1 blocks, a split high block's low ids on every
   shard), sliced by from_reference_sharded into 4 port states and joined
   back by to_reference_sharded_arrays array for array, low heap and
   low_count included.
2. The same state carried into 4 spawned ranks, then 2 more frames on
   both sides, starving on frame 2: each rank's map equal to the JAX
   shard by key (resolutions equal, weight and rgbp exact, sdf within
   2e-5, sumsq within 5e-4), the stats equal.
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core import convert
from mrhash_tpu_torch.core.state import MapConfig

N = 4
CFG = dict(SH.CFG, sdf_var_threshold=0.5, n_frames_invalidate_voxels=2)


def _frames():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 255, (SH.ROWS, SH.COLS, 3)).astype(np.uint8)
    return [(SH.EYE, SH.ZERO, (2.0 + rng.normal(0, 0.004, (
        SH.ROWS, SH.COLS))).astype(np.float32), rgb) for _ in range(4)]


def test_multires_sharded_state_round_trips():
    ref, *_ = SH.run_reference(CFG, "rgbd", N, _frames()[:2])
    states = convert.from_reference_sharded(ref, N)
    low = np.asarray(ref.table.low_count)
    assert low.shape == (N,) and (low > 0).all()
    for r, st in enumerate(states):
        assert st.table.low_count == low[r]
        assert int((st.table.res == 1).sum()) > 0
    back = convert.to_reference_sharded_arrays(states)
    for k in convert.TABLE_ARRAYS + ("high_count", "low_count"):
        np.testing.assert_array_equal(back["table"][k],
                                      np.asarray(getattr(ref.table, k)))
    for f in ("sdf", "sumsq", "weight", "rgbp"):
        np.testing.assert_array_equal(back["pool"][f],
                                      np.asarray(getattr(ref.pool, f)))


def test_multires_state_carried_from_reference_continues_equal():
    frames = _frames()
    ref2, _, _, _, jstate = SH.run_reference(CFG, "rgbd", N, frames[:2])
    carried = [convert.to_reference_arrays(s)
               for s in convert.from_reference_sharded(ref2, N)]
    ref4, ref_stats, *_ = SH.run_reference(CFG, "rgbd", N, frames[2:],
                                           ref_state=jstate)
    results = SH.run_port(MapConfig(**CFG), "rgbd", N, frames[2:],
                          states=carried)
    for r in range(N):
        assert results[r]["stats"] == ref_stats, r
    SH.assert_shards_match(results, ref4, N)
    got = SH.union([res["state"] for res in results])
    n = SH.assert_same_map(got, SH.union(SH.reference_shards(ref4, N)))
    n1 = sum(b[0] for b in got.values())
    assert n1 > 0
    print(f"carry: {len(got)} blocks ({n1} at res 1), {n} weighted voxels, "
          f"stats {ref_stats}")
