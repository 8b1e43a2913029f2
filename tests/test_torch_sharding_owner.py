"""The port's key ownership, per-rank capacities and sharded state layout
(mrhash_tpu_torch/parallel/sharding.py, core/convert.py) against the JAX
package's; no process is started.

1. owner_of bit for bit at n in {1, 2, 3, 4, 8} on seeded keys (negative
   coordinates and the int32 extremes among them), and local_config field
   for field on every field the two MapConfigs share, at the same n and on
   a config whose capacities fall below the minimums (64, and 8 for
   low_split_chunk).
2. The counterpart of test_multichip.py::
   test_sharded_state_is_actually_sharded: a 4-device JAX sharded state
   after one frame of the wall, sliced by from_reference_sharded into 4
   port states whose capacities are 1/4 of the map and whose heap ids are
   local (each rank's empty state equal to the port's make_sharded_state),
   then joined back by to_reference_sharded_arrays array for array.
"""
import dataclasses

import numpy as np
import torch

import sharding_helpers as SH
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.parallel import sharding as S


def test_owner_and_local_config_match_reference():
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.parallel import sharding as JS

    rng = np.random.default_rng(0)
    keys = rng.integers(-(1 << 31), 1 << 31, (4096, 3), dtype=np.int64)
    keys[:2048] //= 1 << 20                      # small, signed coordinates
    keys[-4:] = [[-(1 << 31), 0, (1 << 31) - 1], [(1 << 31) - 1] * 3,
                 [-(1 << 31)] * 3, [-1, -1, -1]]
    keys = keys.astype(np.int32)
    for n in (1, 2, 3, 4, 8):
        want = np.asarray(JS.owner_of(jnp.asarray(keys), n))
        got = S.owner_of(torch.from_numpy(keys), n).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert set(got.tolist()) == set(range(n))

    shared = [f.name for f in dataclasses.fields(MapConfig)]
    for kw in (SH.CFG, dict(num_blocks=256, max_active_blocks=128,
                            max_alloc_per_frame=96, low_split_chunk=24)):
        for n in (1, 3, 4, 8):
            got = S.local_config(MapConfig(**kw), n)
            want = JS.local_config(JMapConfig(**kw), n)
            assert {f: getattr(got, f) for f in shared} == \
                {f: getattr(want, f) for f in shared}, n


def test_sharded_state_round_trips_reference():
    n = 4
    cfg = MapConfig(**SH.CFG)
    depth = np.full((SH.ROWS, SH.COLS), 2.0, np.float32)
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    ref, stats, *_ = SH.run_reference(SH.CFG, "rgbd", n,
                                      [(SH.EYE, SH.ZERO, depth, rgb)])
    states = convert.from_reference_sharded(ref, n)
    lcfg = S.local_config(cfg, n)
    assert lcfg.num_blocks == cfg.num_blocks // n
    empty = S.make_sharded_state(cfg, 0, n)
    occupied = 0
    for st in states:
        t = st.table
        assert t.num_blocks == lcfg.num_blocks == st.pool.sdf.shape[0]
        assert t.num_buckets == lcfg.num_blocks == empty.table.num_buckets
        assert t.ptr.shape == empty.table.ptr.shape
        assert t.heap_low.shape == empty.table.heap_low.shape
        used = t.ptr[t.ptr != P.FREE_ENTRY]
        assert int(used.max()) < lcfg.num_blocks * P.TOTAL_SDF_BLOCK_SIZE
        # the free ids plus the used ones: every local id once
        ids = torch.cat([t.heap_high[:t.high_count],
                         used // P.TOTAL_SDF_BLOCK_SIZE])
        assert torch.equal(torch.sort(ids).values,
                           torch.arange(lcfg.num_blocks, dtype=torch.int32))
        assert st.frame == 1
        occupied += used.numel()
    assert occupied == stats[0]["occupied_blocks"] > 0

    back = convert.to_reference_sharded_arrays(states)
    for k in convert.TABLE_ARRAYS:
        np.testing.assert_array_equal(back["table"][k],
                                      np.asarray(getattr(ref.table, k)))
    for k in ("high_count", "low_count"):
        np.testing.assert_array_equal(back["table"][k],
                                      np.asarray(getattr(ref.table, k)))
    for k in ("num_buckets", "num_blocks"):
        assert back["table"][k] == getattr(ref.table, k) == cfg.num_blocks
    for f in ("sdf", "sumsq", "weight", "rgbp"):
        np.testing.assert_array_equal(back["pool"][f],
                                      np.asarray(getattr(ref.pool, f)))
    assert back["frame"] == int(ref.frame) == 1
