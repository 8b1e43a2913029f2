"""The sharded map's snapshot and mesh, and the launcher's failure path.

1. tests/test_multichip.py::test_sharded_extract_mesh_matches_single_chip
   at 4 ranks: 2 frames of a relief on each side, then the port's
   snapshot_to_grid (in passes of 16 blocks per rank, gathered to rank 0)
   against the JAX package's sharded snapshot: the same chunks, and per
   block (by key) the same resolution, weight and colour, sdf within 2e-5
   and sumsq within 5e-4; then extract_mesh_sharded (rank 0's CPU
   GeoWrapper, its host sweep) against the JAX GeoWrapper's sweep of the
   JAX grid: vertex counts equal, the sorted vertices within 1e-4.  The
   ranks' maps are unchanged by the snapshot (read-only).
2. A rank that raises (the last rank is given no starting map, so it
   fails before its first collective while the others wait in it) makes
   run_ranks raise well within its timeout, naming that rank and its
   error; the other ranks are stopped.
"""
import time

import numpy as np
import pytest

import sharding_helpers as SH
from mrhash_tpu_torch.core import convert
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.parallel import launch
from mrhash_tpu_torch.parallel import sharding as S

N = 4
GEO = dict(sdf_truncation=0.15, sdf_truncation_scale=0.0,
           integration_weight_sample=1, virtual_voxel_size=0.05,
           n_frames_invalidate_voxels=0, voxel_extents_scale=1,
           gs_optimization_param_path="", num_blocks=SH.CFG["num_blocks"],
           max_active_blocks=SH.CFG["max_active_blocks"],
           max_alloc_per_frame=SH.CFG["max_alloc_per_frame"],
           profiling=False)


def _frames():
    r = np.arange(SH.ROWS, dtype=np.float32)[:, None]
    c = np.arange(SH.COLS, dtype=np.float32)[None, :]
    depth = (2.0 + 0.2 * np.sin(c / 9) + 0.1 * np.cos(r / 5)).astype(
        np.float32)
    rgb = np.random.default_rng(1).integers(
        0, 255, (SH.ROWS, SH.COLS, 3)).astype(np.uint8)
    return [(SH.EYE, SH.ZERO, depth, rgb)] * 2


def _flat(grid):
    """A grid's blocks by key: {key: (res, {field: [512]})}."""
    order = np.lexsort(grid["pos"].T[::-1])
    return {tuple(grid["pos"][i].tolist()): (
        int(grid["res"][i]), dict(sdf=grid["sdf"][i], sumsq=grid["ssq"][i],
                                  weight=grid["w"][i], rgbp=grid["rgb"][i]))
        for i in order}


def test_sharded_snapshot_and_mesh_match_reference(tmp_path, monkeypatch):
    import jax
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper
    from mrhash_tpu.parallel import sharding as JS

    monkeypatch.chdir(tmp_path)          # the wrappers write reports here
    frames = _frames()
    ref, ref_stats, mesh, jcfg, jstate = SH.run_reference(SH.CFG, "rgbd", N,
                                                          frames)
    jgrid = JS.snapshot_to_grid(jcfg, mesh, jstate, staging=1024)
    assert np.array_equal(np.asarray(jax.device_get(jstate.table.ptr)),
                          ref.table.ptr)
    jgeo = JGeoWrapper(**GEO, sample_mode="gather")
    jgeo.streamer.grid = jgrid
    jgeo.extractMesh(str(tmp_path / "ref.ply"))

    results = SH.run_port(MapConfig(**SH.CFG), "rgbd", N, frames, mesh=dict(
        geo=GEO, filename=str(tmp_path / "port.ply"), staging=16))
    SH.assert_shards_match(results, ref, N)       # the map stays as it was
    got = results[0]
    assert got["chunks"] == sorted(jgrid.chunks)
    want = {k: np.concatenate([jgrid.chunks[c][k] for c in got["chunks"]])
            for k in got["grid"]}
    n = SH.assert_same_map(_flat(got["grid"]), _flat(want))
    assert all("vertices" not in r for r in results[1:])
    gv = np.asarray(got["vertices"], np.float64)
    jv = np.asarray(jgeo.mesh.vertices, np.float64)
    assert gv.shape == jv.shape and jv.shape[0] > 1000, (gv.shape, jv.shape)
    gs, js = gv[np.lexsort(gv.T)], jv[np.lexsort(jv.T)]
    assert float(np.abs(gs - js).max()) < 1e-4
    print(f"{len(got['chunks'])} chunks, {n} weighted voxels, "
          f"{gv.shape[0]} vertices")


def test_failed_rank_raises_naming_it():
    cfg = MapConfig(**SH.CFG)
    frames = _frames()
    states = [convert.to_reference_arrays(S.make_sharded_state(cfg, r, N))
              for r in range(N - 1)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=rf"rank {N - 1} of {N} failed"
                       r"(.|\n)*IndexError"):
        launch.run_ranks(S.run_frames, N, backend="gloo", device="cpu",
                         timeout_s=SH.TIMEOUT_S,
                         args=(cfg, "rgbd", SH.CAM, frames, states, None))
    assert time.monotonic() - t0 < SH.TIMEOUT_S / 4
