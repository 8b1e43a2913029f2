"""The device mesh sweep of the port against the JAX reference:
ops/meshing.py and GeoWrapper.extractMesh under MRHASH_HOST_MESH=0.  The
read-only insert, extractMesh's default, the raycast and the viewer are
in tests/test_torch_meshing_readers.py, which shares this file's scenes
(two files of at most 11 tests each: pytest-xdist's loadfile order puts
a larger file before tests/test_integrate.py, whose last test crashes
its worker (ROADMAP C1), and a crash after every other worker is done
leaves xdist waiting on the replacement worker for good).

Small scenes of tests/test_meshing.py (48x64 frames, 5 cm voxels, 4,096
blocks).  A map built by the reference is carried into the port through
core/convert.py::from_reference (a map the port builds goes the other way,
through core/convert.py::to_reference_arrays), so both packages sweep the
same map.  The reference's meshing functions run op by op (not under
jit), where XLA:CPU contracts no product into an FMA (PORT_NOTES.md P4).
Bounds, each with its reason:

- ring against per-point lookup, within the port: bit-equal (the same
  arithmetic, only the block resolution differs);
- voxel queries, gate and triangles against the reference: counts equal,
  a bijection, positions within 1e-5 and colours within 1e-3 (the
  reference's op-by-op f32 arithmetic is the port's; measured: equal);
- the device sweep against the native host sweep: the reference's own
  bound (test_native_host_extract_matches_device): a 9-D bijection within
  1e-3, colours within 0.5;
- GeoWrapper.extractMesh under MRHASH_HOST_MESH=0 in both packages:
  equal face counts, vertex sets one to one within 1e-5 (the reference
  jits its sweep; measured: equal);
- no silent loss: a batch whose cells emit more than 4 triangles each
  keeps them all, where the reference's buffer of 4 per cell is full.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import native
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert, pipeline
from mrhash_tpu_torch.core.state import (MapConfig, MapState, make_state,
                                         pack_rgb)
from mrhash_tpu_torch.core.streaming import ChunkGrid, Streamer
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import meshing as M

torch.set_num_threads(1)

ROWS, COLS = 48, 64
KW = dict(virtual_voxel_size=0.05, sdf_truncation=0.15,
          max_integration_distance=5.0, num_blocks=4096,
          max_active_blocks=4096, max_alloc_per_frame=2048,
          min_weight_threshold=1, marching_cubes_threshold=1.5)
CAM = (40.0, 40.0, COLS / 2 - 0.5, ROWS / 2 - 0.5, ROWS, COLS, 0.01, 5.0)
WRAPPER_KW = dict(sdf_truncation=0.15, sdf_truncation_scale=0.0,
                  integration_weight_sample=1, virtual_voxel_size=0.05,
                  n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                  gs_optimization_param_path="", profiling=False)


def _port_wall(frames=3):
    """tests/test_meshing.py's wall at 2 m, integrated by the port."""
    cfg = MapConfig(**KW)
    cam = C.make_camera(*CAM)
    state = make_state(cfg.num_blocks)
    depth = torch.full((ROWS, COLS), 2.0)
    rgb = torch.full((ROWS, COLS, 3), 128, dtype=torch.uint8)
    for _ in range(frames):
        state, _ = pipeline.integrate_rgbd(cfg, state, cam, depth, rgb)
    return cfg, state


def _window(cfg, state):
    _, bpos, bptr, bres = I.compact_active(cfg, state.table)
    return bpos, bptr, bres


def _tri_match(got_pos, got_col, want_pos, want_col, pos_tol, col_tol):
    """Counts equal, then each triangle of `got` to its nearest of `want`
    in 9-D: a bijection, positions within pos_tol, colours within
    col_tol.  Returns the largest position distance."""
    from scipy.spatial import cKDTree
    assert got_pos.shape == want_pos.shape, (got_pos.shape, want_pos.shape)
    assert got_pos.shape[0] > 0
    tree = cKDTree(want_pos.reshape(-1, 9).astype(np.float64))
    dist, idx = tree.query(got_pos.reshape(-1, 9).astype(np.float64))
    assert float(dist.max()) < pos_tol, float(dist.max())
    assert np.unique(idx).size == idx.size     # a bijection, no collapse
    col_err = np.abs(got_col.reshape(-1, 9)
                     - want_col.reshape(-1, 9)[idx]).max()
    assert col_err < col_tol, col_err
    return float(dist.max())


def test_transvoxel_tables_are_the_reference_copy():
    from mrhash_tpu.ops import transvoxel as JTV
    from mrhash_tpu_torch.ops import transvoxel as TV
    names = [n for n in dir(JTV) if n.isupper()]
    assert names == [n for n in dir(TV) if n.isupper()] and len(names) == 4
    for n in names:
        assert getattr(TV, n) == getattr(JTV, n), n


# ---------------------------------------------------------------------------
# counterparts of tests/test_meshing.py, within the port
# ---------------------------------------------------------------------------

def test_wall_mesh_plane():
    cfg, state = _port_wall()
    bpos, bptr, bres = _window(cfg, state)
    tri_pos, tri_col = M.extract_iso_surface(cfg, state.table, state.pool,
                                             bpos, bptr, bres, 1 << 15)
    assert tri_pos.shape[0] > 50
    verts = tri_pos.reshape(-1, 3).numpy()
    # every vertex on the z = 2 wall (within ~half a voxel; the projective
    # SDF's ray obliquity adds a little at the image borders)
    z = verts[:, 2]
    assert abs(np.median(z) - 2.0) < 0.5 * cfg.virtual_voxel_size
    assert np.sqrt(np.mean((z - 2.0) ** 2)) < cfg.virtual_voxel_size
    cols = tri_col.reshape(-1, 3).numpy()
    assert np.all(cols >= 0) and np.all(cols <= 255)
    assert abs(np.median(cols) - 128) < 16
    assert np.ptp(verts[:, 0]) > 1.0 and np.ptp(verts[:, 1]) > 0.8


def test_trilinear_on_wall():
    cfg, state = _port_wall(frames=1)
    pts = torch.tensor([[0.0, 0.0, 1.93], [0.0, 0.0, 2.0]])
    dist, ok = M.trilinear_interpolation(cfg, state.table, state.pool, pts)
    assert bool(ok.all())
    assert float(dist[0]) > 0.0
    assert abs(float(dist[1])) < 0.55 * cfg.virtual_voxel_size


# ---------------------------------------------------------------------------
# a multi-res map, built by the reference and carried into the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multires():
    """4 noisy frames of a wall with a sine relief (sdf_var_threshold 0.01,
    about half the blocks coarsen):
    the reference's state and the port's copy, both windows, the
    reference's gate and its triangles in two batches (op by op)."""
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import integrate as JI
    from mrhash_tpu.ops import meshing as JM

    kw = dict(KW, sdf_var_threshold=0.01)
    jcfg = JMapConfig(sample_mode="gather", **kw)
    jcam = JC.make_camera(*CAM)
    rng = np.random.default_rng(7)
    rgb = jnp.asarray(np.clip(128 + rng.normal(0, 30, (ROWS, COLS, 3)), 0,
                              255), jnp.uint8)
    relief = 0.3 * np.sin(np.arange(COLS) / 9.0)[None, :]
    jstate = jmake_state(jcfg.num_blocks)
    for _ in range(4):
        d = 2.0 + relief + rng.normal(0, 0.004, (ROWS, COLS))
        jstate, _ = JP.integrate_rgbd(jcfg, jstate, jcam,
                                      jnp.asarray(d, jnp.float32), rgb)
    cfg = MapConfig(**kw)
    state = convert.from_reference(jax.device_get(jstate))
    bpos, bptr, bres = _window(cfg, state)
    n1 = int((bres == 1).sum())
    assert 0 < n1 < bres.shape[0], "not a mixed-resolution map"

    _, count, jbpos, jbptr, jbres, jbvalid = JI.compact_active(jcfg,
                                                               jstate.table)
    assert int(count) == bpos.shape[0]
    assert np.array_equal(np.asarray(jbpos)[:int(count)], bpos.numpy())
    jpf, jgate, jtotal, jring = JM.gate_cells(jcfg, jstate.table,
                                              jstate.pool, jbpos, jbptr,
                                              jbres, jbvalid)
    max_cells = -(-int(jtotal) // 2)       # two batches
    jtris = []
    for off in (0, max_cells):
        p, c, n = JM.extract_cell_batch(
            jcfg, jstate.table, jstate.pool, jpf, jgate, jnp.int32(off),
            max_cells, 5 * max_cells, ring=jring, bpos=jbpos)
        jtris.append((np.asarray(p)[:int(n)], np.asarray(c)[:int(n)]))
    return dict(cfg=cfg, state=state, window=(bpos, bptr, bres),
                jcfg=jcfg, jstate=jstate, n=int(count),
                jgate=np.asarray(jgate)[:int(count)],
                jpf=np.asarray(jpf)[:int(count)], jtris=jtris,
                max_cells=max_cells)


def test_ring_extraction_matches_legacy_on_multires(multires):
    """The 27-ring cache reproduces the per-point lookup bit for bit on a
    mixed-resolution map: coarse neighbours, cross-resolution trilinear
    blends and checkVertexVoxels shrinks all resolve through the ring."""
    cfg, st = multires["cfg"], multires["state"]
    bpos, bptr, bres = multires["window"]
    pf, gate, cells, ring = M.gate_cells(cfg, st.table, st.pool, bpos, bptr,
                                         bres)
    pf0, gate0 = M.cell_gate(cfg, st.table, st.pool, bpos, bptr, bres)
    assert torch.equal(gate, gate0) and torch.equal(pf, pf0)
    args = (cfg, st.table, st.pool, pf, cells, 0, 1 << 14)
    p1, c1 = M.extract_cell_batch(*args, ring=ring, bpos=bpos)
    p0, c0 = M.extract_cell_batch(*args)
    assert p1.shape[0] > 0
    assert torch.equal(p1, p0) and torch.equal(c1, c0)


def test_voxel_queries_match_reference(multires):
    """get_voxel_size and trilinear_interpolation on seeded points around
    the surface (fine blocks, coarse blocks, their borders and empty
    space), per-point lookup and ring alike, against the reference."""
    import jax.numpy as jnp
    from mrhash_tpu.ops import meshing as JM

    cfg, st = multires["cfg"], multires["state"]
    jcfg, jst = multires["jcfg"], multires["jstate"]
    bpos, bptr, bres = multires["window"]
    rng = np.random.default_rng(11)
    # per window block, 16 points within +-5 voxels of its centre
    base = (bpos.numpy().astype(np.float32) * P.SDF_BLOCK_SIZE + 3.5
            ) * cfg.virtual_voxel_size
    off = rng.uniform(-0.25, 0.25, (base.shape[0], 16, 3))
    pts = (base[:, None, :] + off).astype(np.float32)
    tp = torch.from_numpy(pts)
    ring = M.build_ring(cfg, st.table, bpos)
    ctx = (ring, bpos, torch.arange(bpos.shape[0])[:, None])
    vs, res = M.get_voxel_size(cfg, st.table, tp)
    vs_r, res_r = M.get_voxel_size(cfg, st.table, tp, ctx)
    d, ok = M.trilinear_interpolation(cfg, st.table, st.pool, tp)
    d_r, ok_r = M.trilinear_interpolation(cfg, st.table, st.pool, tp, ctx)
    jvs, jres = JM.get_voxel_size(jcfg, jst.table, jnp.asarray(pts))
    jd, jok = JM.trilinear_interpolation(jcfg, jst.table, jst.pool,
                                         jnp.asarray(pts))
    assert len(set(res.flatten().tolist())) == 2
    for got in ((vs, res), (vs_r, res_r)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jvs))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jres))
    jok = np.asarray(jok)
    assert 0.2 < jok.mean() < 1.0
    for got in ((d, ok), (d_r, ok_r)):
        np.testing.assert_array_equal(got[1].numpy(), jok)
        np.testing.assert_allclose(got[0].numpy()[jok], np.asarray(jd)[jok],
                                   atol=1e-5, rtol=0)


def test_cell_gate_matches_reference(multires):
    cfg, st = multires["cfg"], multires["state"]
    pf, gate, cells, _ = M.gate_cells(cfg, st.table, st.pool,
                                      *multires["window"])
    np.testing.assert_array_equal(gate.numpy(), multires["jgate"])
    np.testing.assert_array_equal(pf.numpy(), multires["jpf"])
    assert cells.shape[0] == int(multires["jgate"].sum()) > 1000


def test_extract_cell_batch_matches_reference(multires):
    """Both batches of the gated cells: the same triangles, batch by batch
    (the cells are ranked in the same window order)."""
    cfg, st = multires["cfg"], multires["state"]
    bpos, bptr, bres = multires["window"]
    pf, _, cells, ring = M.gate_cells(cfg, st.table, st.pool, bpos, bptr,
                                      bres)
    mc = multires["max_cells"]
    for off, (jp, jc) in zip((0, mc), multires["jtris"]):
        p, c = M.extract_cell_batch(cfg, st.table, st.pool, pf, cells, off,
                                    mc, ring=ring, bpos=bpos)
        _tri_match(p.numpy(), c.numpy(), jp, jc, 1e-5, 1e-3)


def test_device_sweep_matches_native_host_sweep(multires):
    """The counterpart of test_native_host_extract_matches_device: the
    port's device sweep and the host sweep (native/mrhash_mesh.cpp through
    the port's loader) give the same triangle set on the multi-res map."""
    cfg, st = multires["cfg"], multires["state"]
    bpos, bptr, bres = multires["window"]
    dev_pos, dev_col = M.extract_iso_surface(cfg, st.table, st.pool, bpos,
                                             bptr, bres, 1 << 12)
    streamer = Streamer(cfg, 1024)
    grid = ChunkGrid(np.asarray(cfg.voxel_extents, np.float32))
    streamer.snapshot_into(st, grid)
    g = list(grid.chunks.values())
    b = {k: np.concatenate([x[k] for x in g])
         for k in ("pos", "res", "sdf", "w", "rgb")}
    host_pos, host_col = native.extract_mesh_host(
        b["pos"], b["res"], b["sdf"], b["w"], b["rgb"],
        cfg.virtual_voxel_size, cfg.voxel_extents,
        cfg.marching_cubes_threshold, cfg.min_weight_threshold)
    _tri_match(dev_pos.numpy(), dev_col.numpy(), host_pos, host_col, 1e-3,
               0.5)


# ---------------------------------------------------------------------------
# no silent loss: a batch denser than the reference's triangle buffer
# ---------------------------------------------------------------------------

# a period-3 sign pattern of the cube-corner lattice (1: inside) whose
# cells emit 4.44 triangles each (120 over the pattern's 27 cells), the
# best of 60,000 random period-3 patterns (numpy seed 0); the reference's
# _extract_resident buffers 2^18 triangles for 2^16 cells, 4 per cell
_PATTERN = np.array([1, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 0,
                     1, 0, 1, 1, 1, 0, 0, 0, 1]).reshape(3, 3, 3)


def _pattern_triangles():
    """Mean triangles per cell of _PATTERN, from the Transvoxel tables."""
    from mrhash_tpu_torch.ops import transvoxel as TV
    tri = (np.asarray(TV.REGULAR_CELL_GEOMETRY)[
        np.asarray(TV.REGULAR_CELL_CLASS)] & 0x0F)
    k = np.arange(8)
    x, y, z = np.meshgrid(*(np.arange(3),) * 3, indexing="ij")
    ci = (_PATTERN[(x[..., None] + (k & 1)) % 3,
                   (y[..., None] + ((k >> 1) & 1)) % 3,
                   (z[..., None] + ((k >> 2) & 1)) % 3] << k).sum(-1)
    return float(tri[ci].mean())


def _dense_map():
    """A 3x3x3-block map whose voxels are set so that every cell corner
    (the mean of its 8 voxels, which the trilinear reads at a cell's
    corners) takes the pattern's sign: the voxel field solves the 8-mean
    on the period-3 lattice, where that operator is invertible."""
    assert _pattern_triangles() > 4.0
    c = np.where(_PATTERN == 1, -0.01, 0.01)
    # v at voxel x with sum over d in {0,1}^3 of v(x + d) / 8 = c(x)
    k = np.fft.fftfreq(3) * 2 * np.pi
    h = (1 + np.exp(1j * k)) / 2
    v = np.real(np.fft.ifftn(np.fft.fftn(c) / (h[:, None, None]
                                               * h[None, :, None]
                                               * h[None, None, :])))
    cfg = MapConfig(**dict(KW, num_blocks=64, max_active_blocks=64))
    state = make_state(cfg.num_blocks)
    keys = torch.tensor([[x, y, z] for z in range(3) for y in range(3)
                         for x in range(3)], dtype=torch.int32)
    info = H.insert(state.table, keys, torch.zeros(27, dtype=torch.int32))
    assert bool(info["present"].all())
    lanes = np.arange(P.TOTAL_SDF_BLOCK_SIZE)
    lx, ly, lz = lanes % 8, (lanes // 8) % 8, lanes // 64
    rows = info["ptr"].to(torch.int64) // P.TOTAL_SDF_BLOCK_SIZE
    for key, row in zip(keys.numpy(), rows.tolist()):
        gx, gy, gz = key[0] * 8 + lx, key[1] * 8 + ly, key[2] * 8 + lz
        state.pool.sdf[row] = torch.from_numpy(
            v[gx % 3, gy % 3, gz % 3].astype(np.float32))
        state.pool.weight[row] = 10
        state.pool.rgbp[row] = pack_rgb(torch.tensor([30, 60, 90]))
    return cfg, state, keys


def test_no_triangle_is_dropped():
    """The centre block of the dense map: its 512 gated cells emit more
    than 4 triangles each.  The reference with its _extract_resident ratio
    (max_triangles = 4 x max_cells) returns a full buffer, the first of
    them; the port keeps every triangle."""
    import jax.numpy as jnp
    from mrhash_tpu.ops import meshing as JM

    cfg, state, keys = _dense_map()
    centre = torch.nonzero((keys == 1).all(dim=1)).flatten()
    slots = H.compact(state.table, None, 64)
    bpos, bptr, bres = (getattr(state.table, f)[slots]
                        for f in ("pos", "ptr", "res"))
    sel = torch.nonzero((bpos == 1).all(dim=1)).flatten()
    assert sel.numel() == 1 and centre.numel() == 1
    bpos, bptr, bres = bpos[sel], bptr[sel], bres[sel]
    pf, gate, cells, ring = M.gate_cells(cfg, state.table, state.pool, bpos,
                                         bptr, bres)
    assert cells.shape[0] == P.TOTAL_SDF_BLOCK_SIZE
    n_cells = cells.shape[0]
    p, c = M.extract_cell_batch(cfg, state.table, state.pool, pf, cells, 0,
                                n_cells, ring=ring, bpos=bpos)
    assert p.shape[0] > 4 * n_cells, p.shape

    jst = _reference_state(state)
    jcfg = _jcfg(cfg)
    jbpos, jbptr, jbres = (jnp.asarray(t.numpy()) for t in (bpos, bptr,
                                                             bres))
    jring = JM.build_ring(jcfg, jst.table, jbpos, jnp.ones((1,), bool))
    jpf, jgate = jnp.asarray(pf.numpy()), jnp.asarray(gate.numpy())
    jp, jc, jn = JM.extract_cell_batch(
        jcfg, jst.table, jst.pool, jpf, jgate, jnp.int32(0), n_cells,
        4 * n_cells, ring=jring, bpos=jbpos)
    assert int(jn) == 4 * n_cells                  # a full buffer: truncated
    # the same cells in the same order: the port's first 4 x n_cells
    # triangles are the reference's buffer
    np.testing.assert_allclose(p[:4 * n_cells].numpy(), np.asarray(jp),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(c[:4 * n_cells].numpy(), np.asarray(jc),
                               atol=1e-3, rtol=0)


def _jcfg(cfg):
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    return JMapConfig(sample_mode="gather", **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name in {g.name for g in dataclasses.fields(JMapConfig)}})


def _reference_state(port_state):
    """The JAX MapState of a port map (core.convert's arrays; the reference
    rebuilds its presence cache)."""
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapState as JMapState
    from mrhash_tpu.core.state import VoxelPool as JVoxelPool
    from mrhash_tpu.ops import hashtable as JH

    a = convert.to_reference_arrays(port_state)
    t = a["table"]
    table = JH.make_table(t["num_blocks"], t["num_buckets"]).replace(
        **{k: jnp.asarray(t[k]) for k in convert.TABLE_ARRAYS},
        high_count=jnp.int32(t["high_count"]),
        low_count=jnp.int32(t["low_count"]))
    return JMapState(table=JH.rebuild_pcache(table),
                     pool=JVoxelPool(**{k: jnp.asarray(v)
                                        for k, v in a["pool"].items()}),
                     frame=jnp.int32(a["frame"]))


# ---------------------------------------------------------------------------
# the entry point: GeoWrapper.extractMesh under MRHASH_HOST_MESH=0
# ---------------------------------------------------------------------------

def _sorted(v):
    v = np.asarray(v, np.float64)
    return v[np.lexsort(v.T)]


@pytest.fixture(scope="module")
def walked_map():
    """A multi-res port map of 8 frames panning 1.4 m along a wall with a
    sine relief: more blocks than one frame's window holds, so a small
    device budget splits the chunk-batch sweep into several batches."""
    cfg = MapConfig(**dict(KW, sdf_var_threshold=0.01))
    rng = np.random.default_rng(3)
    rgb = torch.from_numpy(rng.integers(0, 255, (ROWS, COLS, 3))
                           .astype(np.uint8))
    state = make_state(cfg.num_blocks)
    for i in range(8):
        x = 0.2 * i
        u = (np.arange(COLS) - (COLS / 2 - 0.5)) / 40.0 * 2.0 + x
        d = (2.0 + 0.3 * np.sin(u / 0.45)[None, :]
             + rng.normal(0, 0.004, (ROWS, COLS))).astype(np.float32)
        cam = C.with_pose(C.make_camera(*CAM), np.eye(3, dtype=np.float32),
                          np.array([x, 0.0, 0.0], np.float32))
        state, _ = pipeline.integrate_rgbd(cfg, state, cam,
                                           torch.from_numpy(d), rgb)
    return cfg, state


def _copy_state(st):
    return MapState(table=dataclasses.replace(
        st.table, **{k: getattr(st.table, k).clone()
                     for k in convert.TABLE_ARRAYS}),
        pool=type(st.pool)(**{f: getattr(st.pool, f).clone()
                              for f in st.pool.FIELDS}), frame=st.frame)


@pytest.mark.parametrize("path", ["direct", "batches"])
def test_geowrapper_device_mesh_matches_reference(walked_map, path,
                                                  tmp_path, monkeypatch):
    """GeoWrapper.extractMesh under MRHASH_HOST_MESH=0 in both packages on
    the same multi-res map: the whole map resident (the direct path), or
    after streamAllOut (the chunk-batch path, with a device budget of 130
    blocks: 5 batches through insert_readonly, each chunk's ring within
    the budget, as the reference's window cap needs).  The port's vertices
    and faces match the reference's one to one and equal the port's host
    sweep's; the chunk-batch path leaves the map empty."""
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper

    cfg, state = walked_map
    n_blocks = int((state.table.ptr != H.FREE).sum())
    budget = n_blocks if path == "direct" else 130
    monkeypatch.chdir(tmp_path)          # the reference writes reports here
    monkeypatch.setenv("MRHASH_HOST_MESH", "0")
    kw = dict(WRAPPER_KW, sdf_var_threshold=0.01, num_blocks=cfg.num_blocks,
              max_active_blocks=budget)
    out, port = {}, GeoWrapper(device="cpu", **kw)
    for name, gw in (("port", port), ("ref", JGeoWrapper(**kw))):
        gw.state = (_copy_state(state) if name == "port"
                    else _reference_state(state))
        if path == "batches":
            gw.streamAllOut()
        gw.extractMesh(str(tmp_path / f"{name}.ply"))
        out[name] = (_sorted(gw.getVertices()), gw.getFaces().shape[0])
    stats = port.mesh_stats
    if path == "batches":
        assert stats["batches"] >= 3 and stats["dropped"] == 0, stats
        assert stats["over_budget"] == 0, stats
        assert port._high_free == cfg.num_blocks
        assert int((port.state.table.ptr != H.FREE).sum()) == 0
    monkeypatch.setenv("MRHASH_HOST_MESH", "1")
    port.extractMesh(str(tmp_path / "host.ply"))
    host = (_sorted(port.getVertices()), port.getFaces().shape[0])
    (got, nf), (want, jnf) = out["port"], out["ref"]
    assert got.shape == want.shape and want.shape[0] > 1000, (got.shape,
                                                              want.shape)
    assert nf == jnf
    assert float(np.abs(got - want).max()) < 1e-5
    assert got.shape == host[0].shape and nf == host[1]
    assert float(np.abs(got - host[0]).max()) < 1e-3
