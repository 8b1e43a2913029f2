"""The readers of the device mesh sweep in the port against the JAX
reference: the read-only insert that the chunk-batch sweep stages host
blocks with, the host sweep as extractMesh's default, the raycast, and the
viewer.  The scenes and helpers are tests/test_torch_meshing.py's (48x64
frames, 5 cm voxels, 4,096 blocks).  Bounds, each with its reason:

- the read-only insert: the same owned keys and dropped counts as the
  reference's wherever the reference drops nothing it could place; where
  it does (ROADMAP C12), the port drops none;
- the raycast: hit masks equal, depth within 1e-4;
- the viewer: its mesh equal, array for array, to the mesh of
  `_extract_resident` of the map as its tick's frame left it.

The `gpu` cases hold the sweep and the viewer on the card against the
same calls on the CPU (`python -m pytest --noconftest -m gpu
tests/test_torch_meshing_readers.py`).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from mrhash_tpu_torch.core import mesh_post, pipeline
from mrhash_tpu_torch.core.state import MapConfig, make_state
from mrhash_tpu_torch.core.streaming import Streamer
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import raycast as R
# walked_map is the sweep tests' fixture, used here by name
from test_torch_meshing import (COLS, ROWS, WRAPPER_KW, _copy_state,
                                _jcfg, _port_wall, _reference_state, _sorted,
                                walked_map)

torch.set_num_threads(1)


def _feed(gw, rng_seed=3, frames=4):
    rng = np.random.default_rng(rng_seed)
    gw.setCamera(40.0, 40.0, COLS / 2 - 0.5, ROWS / 2 - 0.5, ROWS, COLS,
                 0.01, 5.0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    relief = 0.3 * np.sin(np.arange(COLS) / 9.0)[None, :]
    for _ in range(frames):
        gw.setCurrPose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
        gw.setDepthImage((2.0 + relief + rng.normal(0, 0.004, (ROWS, COLS))
                          ).astype(np.float32))
        gw.setRGBImage(rgb)
        gw.compute()


# ---------------------------------------------------------------------------
# the read-only insert
# ---------------------------------------------------------------------------

def _grid_blocks(cfg, state):
    """A map's blocks streamed out (from a copy) to a host grid: the
    Streamer, its chunk keys and the blocks in key order."""
    src = Streamer(cfg, 64)
    src.stream_all_out(_copy_state(state))
    keys = sorted(src.grid.chunks)
    return src, keys, {k: np.concatenate([src.grid.chunks[c][k]
                                          for c in keys])
                       for k in src.grid.chunks[keys[0]]}


@pytest.mark.parametrize("scene", ["wall", "walked"])
def test_insert_readonly_matches_reference(scene, walked_map):
    """A map's blocks, streamed out to a host grid, inserted read-only into
    a fresh map in both packages, in staging batches of 64: the wall
    (single-res) into 64 blocks, so the heap runs dry and both drop the
    same blocks; the walked multi-res map into 4,096 blocks.  The same
    owned keys, the same dropped count, and the grid left as it was."""
    import jax
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.core.streaming import Streamer as JStreamer

    if scene == "wall":
        cfg, st = _port_wall()
        cfg = dataclasses.replace(cfg, num_blocks=64)
    else:
        cfg, st = walked_map
    src, keys, blocks = _grid_blocks(cfg, st)
    before = {k: v.copy() for k, v in blocks.items()}
    n = blocks["pos"].shape[0]
    owned = np.random.default_rng(5).random(n) < 0.6

    port, mask, dropped = src.insert_readonly(make_state(cfg.num_blocks),
                                              blocks, owned)
    jst, jmask, jdropped = JStreamer(_jcfg(cfg), 64).insert_readonly(
        jmake_state(cfg.num_blocks), blocks, owned)
    assert dropped == jdropped
    assert (dropped > 0) == (scene == "wall") and n > 64
    got = {tuple(k) for k in port.table.pos[mask].tolist()}
    jpos = np.asarray(jax.device_get(jst.table.pos))
    want = {tuple(k) for k in jpos[jmask].tolist()}
    assert got == want and len(got) > 20
    occupied = port.table.ptr != H.FREE
    assert int(occupied.sum()) == n - dropped
    assert not bool((mask & ~occupied).any())
    for k in blocks:
        np.testing.assert_array_equal(blocks[k], before[k])
    assert sorted(src.grid.chunks) == keys


@pytest.mark.parametrize("case", ["low_heap", "slot_race"])
def test_insert_readonly_keeps_what_the_reference_drops(case, walked_map):
    """Two ways the reference's insert_readonly drops blocks that the
    port's places (ROADMAP C12, PORT_NOTES.md P54), the walked multi-res
    map (198 blocks, 44 at res 1) into a fresh map: low_heap, the low heap
    refilled by cfg.low_split_chunk = 1 high block (8 res-1 blocks) per
    insert, where the reference drops every res-1 block past 8 and the
    port splits what the batch needs; slot_race, a table of 32 buckets
    (320 slots), where keys of overlapping probe windows race for slots,
    the reference drops the losers and the port inserts them again."""
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.core.streaming import Streamer as JStreamer

    cfg, state = walked_map
    buckets = None
    if case == "low_heap":
        cfg = dataclasses.replace(cfg, low_split_chunk=1)
    else:
        buckets = 32
    src, _, blocks = _grid_blocks(cfg, state)
    n, n1 = blocks["pos"].shape[0], int((blocks["res"] == 1).sum())
    owned = np.ones(n, bool)
    port, mask, dropped = Streamer(cfg, 4096).insert_readonly(
        make_state(cfg.num_blocks, buckets), blocks, owned)
    _, _, jdropped = JStreamer(_jcfg(cfg), 4096).insert_readonly(
        jmake_state(cfg.num_blocks, buckets), blocks, owned)
    assert jdropped > 0 and (case == "slot_race" or jdropped == n1 - 8)
    assert dropped == 0 and int(mask.sum()) == n


# ---------------------------------------------------------------------------
# extractMesh's default
# ---------------------------------------------------------------------------

def test_host_sweep_stays_the_default(tmp_path, monkeypatch):
    """Without MRHASH_HOST_MESH, and with any value but 0, extractMesh
    runs the host sweep: the device map stays live and no device-sweep
    figure is recorded."""
    monkeypatch.delenv("MRHASH_HOST_MESH", raising=False)
    for value in (None, "1", "yes"):
        if value is not None:
            monkeypatch.setenv("MRHASH_HOST_MESH", value)
        gw = GeoWrapper(device="cpu", num_blocks=1 << 12,
                        max_active_blocks=1 << 12, **WRAPPER_KW)
        _feed(gw, frames=1)
        occupied = int((gw.state.table.ptr != H.FREE).sum())
        gw.extractMesh(str(tmp_path / "m.ply"))
        assert gw.getVertices().shape[0] > 100
        assert gw.mesh_stats.get("cells", 0) == 0
        assert int((gw.state.table.ptr != H.FREE).sum()) == occupied


# ---------------------------------------------------------------------------
# the raycast
# ---------------------------------------------------------------------------

def test_raycast_matches_reference():
    """tests/test_raycast.py's wall scene (24x32, 2 frames at 2 m),
    integrated by the port and carried into the reference: the port's
    depth map has the same hits as the reference's raycast_depth (its
    scan compiled, as its own test runs it) and depths within 1e-4, and
    hits the wall at 2 m as the reference test asks."""
    import jax
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import raycast as JR

    rows, cols = 24, 32
    cfg = MapConfig(virtual_voxel_size=0.05, sdf_truncation=0.15,
                    max_integration_distance=5.0, num_blocks=4096,
                    max_active_blocks=4096, max_alloc_per_frame=2048)
    cam_args = (30.0, 30.0, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols, 0.1,
                5.0)
    cam = C.make_camera(*cam_args)
    st = make_state(cfg.num_blocks)
    for _ in range(2):
        st, _ = pipeline.integrate_rgbd(
            cfg, st, cam, torch.full((rows, cols), 2.0),
            torch.full((rows, cols, 3), 128, dtype=torch.uint8))
    d, hit = R.raycast_depth(cfg, st.table, st.pool, cam, step_scale=0.4,
                             max_steps=64)
    jst = _reference_state(st)
    jd, jhit = JR.raycast_depth(_jcfg(cfg), jst.table, jst.pool,
                                JC.make_camera(*cam_args), step_scale=0.4,
                                max_steps=64)
    jhit = np.asarray(jhit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4, rtol=0)
    centre = (slice(rows // 4, -rows // 4), slice(cols // 4, -cols // 4))
    hc = hit.numpy()[centre]
    assert hc.mean() > 0.9
    assert np.median(np.abs(d.numpy()[centre][hc] - 2.0)) < 0.05


# ---------------------------------------------------------------------------
# the viewer
# ---------------------------------------------------------------------------

def _viewer_wrapper(device="cpu"):
    return GeoWrapper(device=device, num_blocks=1 << 12,
                      max_active_blocks=1 << 11, max_alloc_per_frame=1 << 11,
                      viewer_active=True, **WRAPPER_KW)


def _mesh_of(tri_pos, tri_col):
    m = mesh_post.MeshAccumulator()
    m.add_triangles(tri_pos, tri_col)
    return m


def test_viewer_active_background_mesh():
    """The counterpart of tests/test_geowrapper.py's viewer test: each
    frame starts a background mesh of the resident map, and getViewerMesh
    returns it (the sweep of the map as that frame left it) without
    running extractMesh."""
    gw = _viewer_wrapper()
    try:
        gw.setCamera(40.0, 40.0, 31.5, 23.5, 48, 64, 0.01, 8.0)
        gw.setCurrPose([0, 0, 0], [0, 0, 0, 1])
        gw.setDepthImage(np.full((48, 64), 2.0, np.float32))
        gw.setRGBImage(np.full((48, 64, 3), 100, np.uint8))
        gw.compute()
        mesh = gw.getViewerMesh()
        assert mesh.vertices.shape[0] > 0
        assert gw.viewer_mesh_frame == gw.state.frame
        want = _mesh_of(*gw._extract_resident())
        np.testing.assert_array_equal(mesh.vertices, want.vertices)
        np.testing.assert_array_equal(mesh.faces, want.faces)
        np.testing.assert_array_equal(mesh.colors, want.colors)
    finally:
        gw.close()
    assert gw._viewer_pool is None


def test_viewer_mesh_not_torn_by_later_frames():
    """A tick held back until three more frames have updated the map in
    place still gives the mesh of the map as its own frame left it, and
    a finished tick's mesh does not change with later frames."""
    gw = _viewer_wrapper()
    try:
        gate = threading.Event()
        gw._viewer_pool.submit(gate.wait, 30)   # holds the worker
        _feed(gw, frames=1)
        first = gw.state.frame
        want = _mesh_of(*gw._extract_resident())
        _feed(gw, rng_seed=4, frames=3)         # ticks skipped: one pending
        later = _mesh_of(*gw._extract_resident())
        assert (later.vertices.shape != want.vertices.shape
                or not np.array_equal(later.vertices, want.vertices))
        gate.set()
        mesh = gw.getViewerMesh()
        assert gw.viewer_mesh_frame == first
        np.testing.assert_array_equal(mesh.vertices, want.vertices)
        np.testing.assert_array_equal(mesh.faces, want.faces)
        held = mesh.vertices.copy()
        _feed(gw, rng_seed=5, frames=2)
        np.testing.assert_array_equal(mesh.vertices, held)
        assert gw.getViewerMesh().vertices.shape[0] > 0
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# on the card: the device sweep and the viewer against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_sweep_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The direct and the chunk-batch device sweep of the same frames on
    the card and on the CPU: equal vertex and face counts, vertices within
    1e-5."""
    monkeypatch.setenv("MRHASH_HOST_MESH", "0")
    out = {}
    for dev in ("cpu", "cuda"):
        gw = GeoWrapper(device=dev, sdf_var_threshold=0.5,
                        num_blocks=1 << 12, max_active_blocks=64,
                        max_alloc_per_frame=1 << 11, **WRAPPER_KW)
        _feed(gw)
        for path in ("direct", "batches"):
            if path == "batches":
                gw.streamAllOut()
            gw.extractMesh(str(tmp_path / f"{dev}_{path}.ply"))
            out[dev, path] = (_sorted(gw.getVertices()),
                              gw.getFaces().shape[0])
    for path in ("direct", "batches"):
        (c, cf), (g, gf) = out["cpu", path], out["cuda", path]
        assert c.shape == g.shape and cf == gf and c.shape[0] > 500, path
        assert float(np.abs(c - g).max()) < 1e-5, path


@pytest.mark.gpu
def test_viewer_on_card(cuda):
    gw = _viewer_wrapper("cuda")
    try:
        _feed(gw, frames=1)
        mesh = gw.getViewerMesh()
        want = _mesh_of(*gw._extract_resident())
        assert mesh.vertices.shape[0] > 100
        np.testing.assert_array_equal(mesh.vertices, want.vertices)
    finally:
        gw.close()
