"""The port's sharded RGB-D step (mrhash_tpu_torch/parallel/sharding.py)
on 4 spawned CPU ranks (gloo) against the JAX package's sharded step over
a mesh of 4 of the conftest's virtual CPU devices, on
tests/test_multichip.py's 32x64 wall, 2 frames at the identity pose (the
JAX step is jitted: a zero translation keeps XLA's FMA contraction from
moving voxels, PORT_NOTES.md P4).

Per rank, by block key: each rank's map equal to the JAX shard of the same
rank (so the keys route to the same owner), keys and resolutions equal,
weight and rgbp exact, sdf within 2e-5, sumsq within 5e-4; the summed
stats equal; every key on its owner; and the union of the ranks' maps
equal to the port's single-process map.

1. one resolution, the flat wall (test_sharded_integrate_matches_single_chip);
2. multi-resolution at threshold 0.5 on the noisy wall of
   test_sharded_multires_matches_single_chip, 3 frames: res-1 blocks
   present (coarsening and K1's res-1 reintegration on each rank).
"""
import numpy as np

import sharding_helpers as SH
from mrhash_tpu_torch.core.state import MapConfig

N = 4


def _check(cfg_kw, frames, multires):
    cfg = MapConfig(**cfg_kw)
    ref, ref_stats, *_ = SH.run_reference(cfg_kw, "rgbd", N, frames)
    results = SH.run_port(cfg, "rgbd", N, frames)
    for r in range(N):
        assert results[r]["stats"] == ref_stats, (r, results[r]["stats"])
    SH.assert_shards_match(results, ref, N)
    SH.assert_owned(results, N)
    single = SH.blocks(SH.run_single(cfg, "rgbd", frames))
    got = SH.union([res["state"] for res in results])
    n = SH.assert_same_map(got, single)
    n1 = sum(b[0] for b in got.values())
    assert (n1 > 0) == multires, n1
    print(f"{len(got)} blocks ({n1} at res 1), {n} weighted voxels, "
          f"stats {ref_stats[-1]}")


def test_sharded_rgbd_matches_reference():
    depth = np.full((SH.ROWS, SH.COLS), 2.0, np.float32)
    rgb = np.random.default_rng(0).integers(
        0, 255, (SH.ROWS, SH.COLS, 3)).astype(np.uint8)
    _check(SH.CFG, [(SH.EYE, SH.ZERO, depth, rgb)] * 2, multires=False)


def test_sharded_multires_matches_reference():
    rng = np.random.default_rng(3)
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    frames = [(SH.EYE, SH.ZERO, (2.0 + rng.normal(0, 0.004, (
        SH.ROWS, SH.COLS))).astype(np.float32), rgb) for _ in range(3)]
    _check(dict(SH.CFG, sdf_var_threshold=0.5), frames, multires=True)
