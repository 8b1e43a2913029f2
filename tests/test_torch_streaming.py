"""Host streaming and grid checkpoints in the port against the JAX reference.

Both packages get the same inputs, made with numpy from a seed.  Where a
test carries a map from the port into the reference (core.convert), the two
run the same streaming step on the same table and pool, and the results are
compared by content: the map from block key to (res, sdf, sumsq, weight,
rgb) over the block's own window (512 voxels at res 0, 64 at res 1), since
slots may differ after an insert (PORT_NOTES.md P10).  Tolerances, each
with its reason:

- eviction plan, eviction gather, insert, checkpoints: exact (bit-equal
  floats).  These steps only move data; the one computed value, the
  block's distance from the camera, is compared with a threshold, and the
  tests assert that no distance lies within 1e-4 m of the radius or the
  budget threshold, so an ulp cannot move a block across.
- the tube walk through GeoWrapper against the reference's pipeline run op
  by op (jax.disable_jit, PORT_NOTES.md P4) with the reference Streamer
  driven by the same trigger: weight and rgb exact, sdf within 2e-5,
  sumsq within 5e-4 (the frame step's bounds, test_torch_pipeline.py).

The device twin of every step runs here on CPU tensors; `chip_smoke.py`
phases 3 and 9 run the same steps on the card.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert, pipeline
from mrhash_tpu_torch.core import streaming as S
from mrhash_tpu_torch.core.state import MapConfig, clear_blocks, make_state
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H

torch.set_num_threads(1)

FIELDS = ("sdf", "ssq", "w", "rgb")
POOL = dict(sdf="sdf", ssq="sumsq", w="weight", rgb="rgbp")

# the 64x256 scene of test_torch_multires.py (3 frames, 4 mm noise)
ROWS, COLS = 64, 256
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)
KW = dict(virtual_voxel_size=0.02, sdf_truncation=0.06,
          max_integration_distance=5.0, num_blocks=1 << 11,
          max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
          alloc_tile=4)
CAM_POS = np.array([0.37, -0.11, 0.29], np.float32)
RADIUS = 1.7

# tests/test_streaming.py's setup
S_ROWS, S_COLS = 32, 48
S_KW = dict(virtual_voxel_size=0.05, sdf_truncation=0.15,
            max_integration_distance=6.0, num_blocks=8192,
            max_active_blocks=8192, max_alloc_per_frame=2048,
            voxel_extents=(1.0, 1.0, 1.0))
S_CAM = (30.0, 30.0, S_COLS / 2 - 0.5, S_ROWS / 2 - 0.5, S_ROWS, S_COLS,
         0.01, 4.0)


def _jcfg(**kw):
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    return JMapConfig(sample_mode="gather", **kw)


def _port_map(multires, frames=3):
    """A port map of the 64x256 scene; multires coarsens from frame 1 on."""
    cfg = MapConfig(**KW, sdf_var_threshold=10.0 if multires else 0.0)
    rng = np.random.default_rng(7)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = torch.from_numpy(rng.integers(0, 255, (ROWS, COLS, 3))
                           .astype(np.uint8))
    state = make_state(cfg.num_blocks)
    for i in range(frames):
        d = np.round((base + rng.normal(0, 0.004, base.shape)) * 2048) / 2048
        cam = C.with_pose(C.make_camera(*CAM), np.eye(3, dtype=np.float32),
                          np.array([0.03 * i, 0.01 * i, 0.0], np.float32))
        state, _ = pipeline.integrate_rgbd(
            cfg, state, cam, torch.from_numpy(d.astype(np.float32)), rgb)
    n1 = int(((state.table.res == 1) & (state.table.ptr != H.FREE)).sum())
    assert (n1 > 100) == multires, n1
    return cfg, state


def _reference_state(port_state):
    """The JAX MapState of a port map (core.convert's arrays; the
    reference rebuilds its presence cache)."""
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapState, VoxelPool as JVoxelPool
    from mrhash_tpu.ops import hashtable as JH

    a = convert.to_reference_arrays(port_state)
    t = a["table"]
    table = JH.make_table(t["num_blocks"], t["num_buckets"]).replace(
        **{k: jnp.asarray(t[k]) for k in convert.TABLE_ARRAYS},
        high_count=jnp.int32(t["high_count"]),
        low_count=jnp.int32(t["low_count"]))
    return MapState(table=JH.rebuild_pcache(table),
                    pool=JVoxelPool(**{k: jnp.asarray(v)
                                       for k, v in a["pool"].items()}),
                    frame=jnp.int32(a["frame"]))


def _content(table_pos, table_ptr, table_res, pool):
    """key -> (res, {field: window values}) of every occupied entry; numpy
    arrays of either package (pool: dict of [N,512] arrays by pool name)."""
    out = {}
    occ = np.nonzero(np.asarray(table_ptr) != P.FREE_ENTRY)[0]
    for s in occ:
        p, r = int(table_ptr[s]), int(table_res[s])
        n = P.TOTAL_LOW_BLOCK_SIZE if r == 1 else P.TOTAL_SDF_BLOCK_SIZE
        out[tuple(int(v) for v in table_pos[s])] = (r, {
            f: np.asarray(pool[POOL[f]]).reshape(-1)[p:p + n].copy()
            for f in FIELDS})
    return out


def _port_content(state):
    t = state.table
    return _content(t.pos.numpy(), t.ptr.numpy(), t.res.numpy(),
                    {f: getattr(state.pool, f).numpy() for f in
                     ("sdf", "sumsq", "weight", "rgbp")})


def _ref_content(state):
    t = state.table
    return _content(np.asarray(t.pos), np.asarray(t.ptr), np.asarray(t.res),
                    {f: np.asarray(getattr(state.pool, f)) for f in
                     ("sdf", "sumsq", "weight", "rgbp")})


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same_content(got, want):
    assert set(got) == set(want)
    for k, (r, f) in want.items():
        assert got[k][0] == r, k
        for name in FIELDS:
            np.testing.assert_array_equal(_bits(got[k][1][name]),
                                          _bits(f[name]), err_msg=str(k))


def _grid_by_key(grid_chunks):
    """key -> (res, {field: [512] row}) of every block in a chunk grid."""
    out = {}
    for g in grid_chunks.values():
        for i in range(g["pos"].shape[0]):
            out[tuple(int(v) for v in g["pos"][i])] = (
                int(g["res"][i]), {f: g[f][i] for f in FIELDS})
    return out


def _distances(cfg, state, cam_pos):
    """float64 distance of every occupied block's corner from cam_pos."""
    occ = (state.table.ptr != H.FREE).numpy()
    pw = (state.table.pos.numpy().astype(np.float64) * P.SDF_BLOCK_SIZE
          * cfg.virtual_voxel_size)
    return occ, np.linalg.norm(pw - cam_pos.astype(np.float64), axis=-1)


# ---------------------------------------------------------------------------
# the eviction plan, the gather, the insert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [False, True], ids=["radius", "budget"])
@pytest.mark.parametrize("multires", [False, True],
                         ids=["single", "multires"])
def test_plan_evictions_matches_reference(multires, budget):
    """The same map in both packages: the same entries evicted, in slot
    order, and the same table and heaps afterwards."""
    import jax.numpy as jnp
    from mrhash_tpu.core import streaming as JS

    cfg, state = _port_map(multires)
    ref = _reference_state(state)
    occ, d = _distances(cfg, state, CAM_POS)
    assert not (occ & (np.abs(d - RADIUS) < 1e-4)).any()
    cand = occ & (d >= RADIUS)
    assert 100 < cand.sum() < occ.sum() - 100
    b = int(cand.sum()) // 3 if budget else 0
    if budget:
        thr = np.sort(d[cand])[::-1][b - 1]
        assert not ((d[cand] > thr - 1e-4) & (d[cand] < thr)).any()
    pos, ptr, res = S.plan_evictions(cfg, state.table, CAM_POS, RADIUS,
                                     budget=b)
    jt, n, jpos, jres, jptr = JS.plan_evictions(
        _jcfg(**KW, sdf_var_threshold=cfg.sdf_var_threshold), ref.table,
        jnp.asarray(CAM_POS), jnp.float32(RADIUS), jnp.asarray(False),
        jnp.int32(b))
    n = int(n)
    assert pos.shape[0] == n
    assert (b <= n <= b + 32) if budget else n == int(cand.sum())
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:n])
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jptr)[:n])
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres)[:n])
    t = state.table
    assert (t.high_count, t.low_count) == (int(jt.high_count),
                                           int(jt.low_count))
    for k in ("pos", "ptr", "res", "fp"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    np.testing.assert_array_equal(t.heap_high[:t.high_count].numpy(),
                                  np.asarray(jt.heap_high)[:t.high_count])
    np.testing.assert_array_equal(t.heap_low[:t.low_count].numpy(),
                                  np.asarray(jt.heap_low)[:t.low_count])


@pytest.mark.parametrize("multires", [False, True],
                         ids=["single", "multires"])
def test_eviction_gather_matches_transfer_pack(multires):
    """The port's gather in the host layout against the reference's
    unpack_transfer(pack_evicted_pass(...)) in staging passes of 256: the
    same fields per key to the bit, and the same pool after the clear."""
    import jax.numpy as jnp
    from mrhash_tpu.core import streaming as JS

    cfg, state = _port_map(multires)
    ref = _reference_state(state)
    pos, ptr, res = S.plan_evictions(cfg, state.table, CAM_POS, RADIUS)
    fields = S.gather_blocks(state.pool, ptr, res)
    clear_blocks(state.pool, ptr, res)
    got = {tuple(int(v) for v in pos[i]): (int(res[i]), {
        f: fields[j][i].numpy() for j, f in enumerate(FIELDS)})
        for i in range(pos.shape[0])}

    jcfg = _jcfg(**KW, sdf_var_threshold=cfg.sdf_var_threshold)
    _, n, pa, ra, pt = JS.plan_evictions(
        jcfg, ref.table, jnp.asarray(CAM_POS), jnp.float32(RADIUS),
        jnp.asarray(False))
    n, staging, pool, want = int(n), 256, ref.pool, {}
    assert n == len(got) and n > 300
    for off in range(0, n, staging):
        pool, buf = JS.pack_evicted_pass(jcfg, staging, pool, pa, ra, pt,
                                         jnp.int32(n), jnp.int32(off))
        k = min(staging, n - off)
        ph, rh, *fh = JS.unpack_transfer(np.asarray(buf[:k]))
        for i in range(k):
            want[tuple(int(v) for v in ph[i])] = (int(rh[i]), {
                f: fh[j][i] for j, f in enumerate(FIELDS)})
    if multires:
        assert sum(r for r, _ in want.values()) > 100
    _assert_same_content(got, want)
    for f in ("sdf", "sumsq", "weight", "rgbp"):
        np.testing.assert_array_equal(_bits(getattr(state.pool, f).numpy()),
                                      _bits(np.asarray(getattr(pool, f))))


def test_insert_blocks_matches_reference():
    """Res-0 and res-1 host blocks into a fresh map (empty low heap, so the
    high heap splits first) where a few keys are already resident: the
    same `present`, and the same content per key."""
    import jax.numpy as jnp
    from mrhash_tpu.core import streaming as JS

    cfg, src = _port_map(multires=True)
    slots = torch.nonzero(src.table.ptr != H.FREE).flatten()
    pos, ptr, res = (getattr(src.table, k)[slots] for k in
                     ("pos", "ptr", "res"))
    fields = S.gather_blocks(src.pool, ptr, res)
    assert int((res == 1).sum()) > 100 and int((res == 0).sum()) > 10
    state = make_state(cfg.num_blocks)
    pre = torch.nonzero(res == 0).flatten()[:5]
    H.insert(state.table, pos[pre], torch.zeros(5, dtype=torch.int32))
    ref = _reference_state(state)
    assert state.table.low_count == 0

    present, slot, new = S.insert_blocks(cfg, state.table, state.pool, pos,
                                         res, *fields)
    n, staging = pos.shape[0], 1 << 11
    pad = [np.zeros((staging,) + tuple(t.shape[1:]), t.numpy().dtype)
           for t in (pos, res, *fields)]
    for a, t in zip(pad, (pos, res, *fields)):
        a[:n] = t.numpy()
    valid = np.arange(staging) < n
    jt, jp, n_new, jpresent, _ = JS.insert_blocks(
        _jcfg(**KW, sdf_var_threshold=10.0), staging, ref.table, ref.pool,
        jnp.asarray(pad[0]), jnp.asarray(pad[1]), jnp.asarray(valid),
        *(jnp.asarray(a) for a in pad[2:]))
    np.testing.assert_array_equal(present.numpy(), np.asarray(jpresent)[:n])
    assert bool(present.all()) and int(new.sum()) == int(n_new) == n - 5
    assert (state.table.high_count, state.table.low_count) == (
        int(jt.high_count), int(jt.low_count))
    _assert_same_content(_port_content(state),
                         _ref_content(SimpleNamespace(table=jt, pool=jp)))


def test_chunk_grid_selection_matches_reference():
    """ChunkGrid's stream-in selection, peek and bounds against the
    reference's ChunkGrid holding the same blocks (added in two batches,
    so a chunk merges and the newest copy of a key wins)."""
    from mrhash_tpu.core.streaming import ChunkGrid as JChunkGrid

    cfg, state = _port_map(multires=True)
    src = S.ChunkGrid(cfg.voxel_extents)
    S.Streamer(cfg, 512).snapshot_into(state, src)
    blocks = {k: np.concatenate([g[k] for g in src.chunks.values()])
              for k in ("pos", "res", *FIELDS)}
    grids = (S.ChunkGrid(cfg.voxel_extents),
             JChunkGrid(np.asarray(cfg.voxel_extents, np.float32)))
    n = blocks["pos"].shape[0]
    for grid in grids:
        for sl in (slice(0, n), slice(0, n // 2)):
            b = {k: v[sl] for k, v in blocks.items()}
            grid.add_blocks(S.block_world(cfg, b["pos"]), b["pos"],
                            *(b[k] for k in ("res", *FIELDS)))
    port, ref = grids
    assert port.chunk_radius == ref.chunk_radius
    assert port.num_blocks() == ref.num_blocks() == n
    assert list(port.chunks) == list(ref.chunks) and len(port.chunks) > 2
    for a, b in zip(port.compute_bounds(), ref.compute_bounds()):
        np.testing.assert_array_equal(a, b)
    keys = list(port.chunks)[::2] + [(99, 99, 99)]
    for a, b in ((port.peek_chunks(keys), ref.peek_chunks(keys)),
                 (port.pop_chunks_in_sphere(CAM_POS, 1.9),
                  ref.pop_chunks_in_sphere(CAM_POS, 1.9))):
        assert set(a) == set(b) and 0 < a["pos"].shape[0] < n
        for k in a:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
    assert list(port.chunks) == list(ref.chunks)
    assert port.peek_chunks([(99, 99, 99)]) is None
    assert port.pop_chunks_in_sphere(np.full(3, 1e3), 1.0) is None


# ---------------------------------------------------------------------------
# counterparts of tests/test_streaming.py
# ---------------------------------------------------------------------------

def _setup():
    return MapConfig(**S_KW), C.make_camera(*S_CAM)


def _circular_pose(step, n_steps, r=2.0):
    """test_utils.cuh:20-32: a camera on a circle, looking outward."""
    th = 2 * np.pi * step / n_steps
    fwd = np.array([np.cos(th), np.sin(th), 0.0])
    x = np.array([-np.sin(th), np.cos(th), 0.0])
    rot = np.stack([x, np.cross(fwd, x), fwd], axis=1)
    return rot.astype(np.float32), (r * fwd).astype(np.float32)


def _run_trajectory(cfg, cam, state, streamer, n_steps=12, radius=3.0):
    depth = torch.full((S_ROWS, S_COLS), 2.5)
    rgb = torch.full((S_ROWS, S_COLS, 3), 100, dtype=torch.uint8)
    for i in range(n_steps):
        rot, t = _circular_pose(i, n_steps)
        state = streamer.stream(state, t, radius)
        state, _ = pipeline.integrate_rgbd(cfg, state,
                                           C.with_pose(cam, rot, t), depth,
                                           rgb)
    return state


def test_stream_cycle_duplicate_audit():
    """test_streaming.py::test_stream_cycle_duplicate_audit: the duplicate
    ratio under 0.15 along a circular trajectory; after streamAllOut an
    empty device, a full heap, no duplicates."""
    cfg, cam = _setup()
    state = make_state(cfg.num_blocks)
    streamer = S.Streamer(cfg, 4096)
    state = _run_trajectory(cfg, cam, state, streamer)
    assert sum(e["blocks"] for e in streamer.out_events) > 0
    assert streamer.duplicate_ratio(state) < 0.15
    state = streamer.stream_all_out(state)
    assert int((state.table.ptr != P.FREE_ENTRY).sum()) == 0
    assert state.table.high_count == cfg.num_blocks
    assert streamer.duplicate_ratio(state) == 0.0
    for g in streamer.grid.chunks.values():
        assert np.unique(g["pos"], axis=0).shape[0] == g["pos"].shape[0]


def test_budgeted_eviction_takes_farthest():
    """test_streaming.py::test_budgeted_eviction_takes_farthest, and the
    evicted set equal to the reference's plan on the same map."""
    import jax.numpy as jnp
    from mrhash_tpu.core import streaming as JS

    cfg, cam = _setup()
    state = make_state(cfg.num_blocks)
    depth = torch.full((S_ROWS, S_COLS), 2.0)
    rgb = torch.full((S_ROWS, S_COLS, 3), 128, dtype=torch.uint8)
    for k in range(4):
        state, _ = pipeline.integrate_rgbd(
            cfg, state, C.with_pose(cam, np.eye(3, dtype=np.float32),
                                    np.array([0.0, 0.0, 1.5 * k],
                                             np.float32)), depth, rgb)
    cam_pos, protect = np.array([0.0, 0.0, 6.0], np.float32), 1.0
    occ, dist = _distances(cfg, state, cam_pos)
    cand = occ & (dist >= protect)
    budget = int(cand.sum()) // 3
    assert budget > 10
    ref = _reference_state(state)
    _, n_ref, jpos, _, _ = JS.plan_evictions(
        _jcfg(**S_KW), ref.table, jnp.asarray(cam_pos), jnp.float32(protect),
        jnp.asarray(False), jnp.int32(budget))
    want = {tuple(int(v) for v in p) for p in np.asarray(jpos)[:int(n_ref)]}

    st = S.Streamer(cfg, 1024)
    occ0 = int(occ.sum())
    state = st.stream_out(state, cam_pos, protect, budget=budget)
    occ_after = (state.table.ptr != P.FREE_ENTRY).numpy()
    evicted = occ & ~occ_after
    n_ev = int(evicted.sum())
    assert budget <= n_ev <= budget + 32, (budget, n_ev)
    if (cand & ~evicted).any():
        assert dist[evicted].min() >= dist[cand & ~evicted].max() - 1e-5
    assert not (evicted & (dist < protect)).any()
    assert st.grid.num_blocks() == n_ev
    assert set(_grid_by_key(st.grid.chunks)) == want
    assert state.table.high_count + int(occ_after.sum()) == cfg.num_blocks
    assert occ0 - n_ev == int(occ_after.sum())


def test_stream_out_in_roundtrip_preserves_voxels():
    """test_streaming.py::test_stream_out_in_roundtrip_preserves_voxels
    (staging 64, so several passes each way), and the host grid after
    streamAllOut equal to the reference's on the same map."""
    from mrhash_tpu.core.streaming import Streamer as JStreamer

    cfg, cam = _setup()
    state = make_state(cfg.num_blocks)
    state, _ = pipeline.integrate_rgbd(
        cfg, state, cam, torch.full((S_ROWS, S_COLS), 2.0),
        torch.full((S_ROWS, S_COLS, 3), 50, dtype=torch.uint8))
    before = _port_content(state)
    jst = JStreamer(_jcfg(**S_KW), 512)
    jst.stream_all_out(_reference_state(state))
    streamer = S.Streamer(cfg, 64)
    state = streamer.stream_all_out(state)
    assert streamer.out_events[-1]["passes"] > 1
    _assert_same_content(_grid_by_key(streamer.grid.chunks),
                         _grid_by_key(jst.grid.chunks))
    state = streamer.stream_in(state, np.zeros(3), 1e6)
    assert streamer.grid.num_blocks() == 0
    _assert_same_content(_port_content(state), before)


def test_grid_serializer_roundtrip(tmp_path):
    """test_streaming.py::test_grid_serializer_roundtrip: exact per-voxel
    equality of the whole grid after serialize -> deserialize, under the
    file name given."""
    cfg, cam = _setup()
    state = make_state(cfg.num_blocks)
    streamer = S.Streamer(cfg, 4096)
    state = _run_trajectory(cfg, cam, state, streamer, n_steps=6)
    streamer.stream_all_out(state)
    # the reference GeoWrapper's default name, which has no .npz suffix
    path = os.path.join(tmp_path, "serialized_grid.bin")
    streamer.serialize_grid(path)
    assert os.listdir(tmp_path) == ["serialized_grid.bin"]
    streamer2 = S.Streamer(cfg, 4096)
    streamer2.deserialize_grid(path)
    assert set(streamer2.grid.chunks) == set(streamer.grid.chunks)
    for key, a in streamer.grid.chunks.items():
        b = streamer2.grid.chunks[key]
        oa, ob = np.lexsort(tuple(a["pos"].T)), np.lexsort(tuple(b["pos"].T))
        for k in a:
            assert np.array_equal(a[k][oa], b[k][ob]), (key, k)


def test_serialize_data_ply(tmp_path):
    """test_streaming.py::test_serialize_data_ply."""
    from mrhash_tpu_torch.utils.plyio import read_points_ply

    cfg, cam = _setup()
    state = make_state(cfg.num_blocks)
    streamer = S.Streamer(cfg, 4096)
    state, _ = pipeline.integrate_rgbd(
        cfg, state, cam, torch.full((S_ROWS, S_COLS), 2.0),
        torch.full((S_ROWS, S_COLS, 3), 50, dtype=torch.uint8))
    streamer.stream_all_out(state)
    fh = os.path.join(tmp_path, "hash.ply")
    fv = os.path.join(tmp_path, "voxel.ply")
    streamer.serialize_data(fh, fv)
    hp, _ = read_points_ply(fh)
    vp, props = read_points_ply(fv)
    assert hp.shape[0] == streamer.grid.num_blocks()
    assert vp.shape[0] > 0
    assert "weight" in props and "sdf" in props
    assert abs(np.median(vp[:, 2]) - 2.0) < 0.5


def test_multires_deserialize_into_fresh_map(tmp_path):
    """test_streaming.py::test_multires_deserialize_into_fresh_map: every
    res-1 block survives checkpoint -> fresh map (low heap empty) ->
    stream-in; and the reference, loading the port's checkpoint into its
    own fresh map, ends with the same content."""
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.core.streaming import Streamer as JStreamer

    cfg, cam = _setup()
    cfg = dataclasses.replace(cfg, sdf_var_threshold=10.0)
    state = make_state(cfg.num_blocks)
    rng = np.random.default_rng(3)
    rgb = torch.full((S_ROWS, S_COLS, 3), 100, dtype=torch.uint8)
    rot, t = _circular_pose(0, 12)
    cam0 = C.with_pose(cam, rot, t)
    for _ in range(4):
        depth = torch.from_numpy(
            (2.5 + rng.normal(0, 0.002, (S_ROWS, S_COLS))).astype(np.float32))
        state, _ = pipeline.integrate_rgbd(cfg, state, cam0, depth, rgb)
    occ = state.table.ptr != P.FREE_ENTRY
    res_before = int(((state.table.res == 1) & occ).sum())
    assert res_before > 0
    streamer = S.Streamer(cfg, 4096)
    streamer.stream_all_out(state)
    path = str(tmp_path / "grid.npz")
    streamer.serialize_grid(path)

    state2 = make_state(cfg.num_blocks)
    streamer2 = S.Streamer(cfg, 4096)
    streamer2.deserialize_grid(path)
    n_ram = streamer2.grid.num_blocks()
    state2 = streamer2.stream_in(state2, t, 100.0)
    occ2 = state2.table.ptr != P.FREE_ENTRY
    assert int(((state2.table.res == 1) & occ2).sum()) == res_before
    assert int(occ2.sum()) + streamer2.grid.num_blocks() == n_ram

    jst = JStreamer(_jcfg(**dict(S_KW, sdf_var_threshold=10.0)), 4096)
    jst.deserialize_grid(path)
    jstate = jst.stream_in(jmake_state(cfg.num_blocks), np.asarray(t), 100.0)
    _assert_same_content(_port_content(state2), _ref_content(jstate))


def test_extreme_values_stream_roundtrip():
    """test_streaming.py::test_packed_transfer_extreme_values_roundtrip,
    through the port's stream-out (staging 8: several passes and a
    partial last one) and stream-in: weight 255, rgb 0xFFFFFF, a denormal,
    negative zero and the largest finite float survive to the bit, and the
    evicted rows are cleared."""
    cfg, _ = _setup()
    state = make_state(cfg.num_blocks)
    n = 17
    pos = torch.from_numpy(np.stack([np.arange(n), np.zeros(n),
                                     -np.arange(n)], 1).astype(np.int32))
    info = H.insert(state.table, pos, torch.zeros(n, dtype=torch.int32))
    rows = (info["ptr"] // P.TOTAL_SDF_BLOCK_SIZE).numpy()
    pool = state.pool
    pool.sdf[:] = -1e-38
    pool.sdf[:, 0] = -0.07
    pool.sdf[:, 1] = -0.0
    pool.sdf[:, 2] = float(np.float32(1.4e-45))
    pool.sumsq[:] = float(np.finfo(np.float32).max)
    pool.weight[:] = 255
    pool.rgbp[:] = 0xFFFFFF
    want = {f: getattr(pool, f).numpy()[rows].copy() for f in
            ("sdf", "sumsq", "weight", "rgbp")}
    st = S.Streamer(cfg, 8)
    state = st.stream_all_out(state)
    assert st.out_events[-1]["passes"] == 3
    for f in ("sdf", "sumsq", "weight", "rgbp"):
        assert not getattr(pool, f)[torch.from_numpy(rows)].any(), f
    got = _grid_by_key(st.grid.chunks)
    assert len(got) == n
    for i in range(n):
        _, g = got[tuple(int(v) for v in pos[i])]
        for f in FIELDS:
            np.testing.assert_array_equal(_bits(g[f]), _bits(want[POOL[f]][i]))
    state = st.stream_in(state, np.zeros(3), 1e6)
    content = _port_content(state)
    for i in range(n):
        _, g = content[tuple(int(v) for v in pos[i])]
        for f in FIELDS:
            np.testing.assert_array_equal(_bits(g[f]), _bits(want[POOL[f]][i]))


# ---------------------------------------------------------------------------
# checkpoints across packages, the snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """A grid checkpoint written by either package loads in the other with
    equal content (the same npz layout and dtypes)."""
    from mrhash_tpu.core.streaming import Streamer as JStreamer

    cfg, state = _port_map(multires=True)
    jcfg = _jcfg(**KW, sdf_var_threshold=10.0)
    port, ref = S.Streamer(cfg, 512), JStreamer(jcfg, 512)
    src = {"port": port, "reference": ref}[writer]
    dst = {"port": ref, "reference": port}[writer]
    if writer == "port":
        port.stream_all_out(state)
    else:
        ref.stream_all_out(_reference_state(state))
    path = str(tmp_path / "grid.npz")
    src.serialize_grid(path)
    dst.deserialize_grid(path)
    assert set(dst.grid.chunks) == set(src.grid.chunks)
    for key, a in src.grid.chunks.items():
        b = dst.grid.chunks[key]
        for k in a:
            assert a[k].dtype == b[k].dtype, (key, k)
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]))
    assert sum(g["res"].sum() for g in dst.grid.chunks.values()) > 100


def test_snapshot_mesh_only_then_full_keeps_sumsq():
    """ROADMAP C2: a mesh-only snapshot (sumsq left out) followed by a full
    one: the full snapshot carries sumsq, equal to the map's."""
    cfg, state = _port_map(multires=True)
    st = S.Streamer(cfg, 512)
    mesh_grid = S.ChunkGrid(cfg.voxel_extents)
    st.snapshot_into(state, mesh_grid, mesh_only=True)
    full = S.ChunkGrid(cfg.voxel_extents)
    st.snapshot_into(state, full)
    m, f = _grid_by_key(mesh_grid.chunks), _grid_by_key(full.chunks)
    assert not any(v["ssq"].any() for _, v in m.values())
    want = _port_content(state)
    assert set(f) == set(want)
    n_ssq = 0
    for k, (r, v) in want.items():
        n = len(v["ssq"])
        np.testing.assert_array_equal(_bits(f[k][1]["ssq"][:n]),
                                      _bits(v["ssq"]))
        n_ssq += int((v["ssq"] != 0).sum())
    assert n_ssq > 1000
    # the map is untouched
    _assert_same_content(_port_content(state), want)


# ---------------------------------------------------------------------------
# GeoWrapper: the stream trigger
# ---------------------------------------------------------------------------

# a 32x128 walk down a square tube of half side 0.6 m at 0.5 m/frame, then
# back turned around, with a 384-block pool: the watermark fires
T_ROWS, T_COLS, T_F, T_HALF, T_MAXD = 32, 128, 80.0, 0.6, 1.5
T_FWD, T_BACK, T_STEP = 14, 8, 0.5
T_KW = dict(sdf_truncation=0.06, sdf_truncation_scale=0.0,
            integration_weight_sample=1, virtual_voxel_size=0.02,
            n_frames_invalidate_voxels=0, voxel_extents_scale=1,
            gs_optimization_param_path="", num_blocks=384,
            max_active_blocks=384, max_alloc_per_frame=384)


def _tube_depth(off_x, off_y):
    """z-depth of the tube |x|, |y| = T_HALF seen from (off_x, off_y, z)
    looking along z, 0 beyond T_MAXD (tools/bench_walk.py's scene)."""
    u = (np.arange(T_COLS, dtype=np.float32)[None] - (T_COLS / 2 - 0.5)) / T_F
    v = (np.arange(T_ROWS, dtype=np.float32)[:, None]
         - (T_ROWS / 2 - 0.5)) / T_F

    def t_plane(d, o):
        d = np.broadcast_to(d, (T_ROWS, T_COLS))
        tp = np.where(d > 1e-6, (T_HALF - o) / np.maximum(d, 1e-6), 1e9)
        tm = np.where(d < -1e-6, (-T_HALF - o) / np.minimum(d, -1e-6), 1e9)
        return np.minimum(tp, tm)

    z = np.minimum(t_plane(u, off_x), t_plane(v, off_y))
    return np.where(z < T_MAXD, z, 0.0).astype(np.float32)


def _tube_frames():
    """(translation, rotation, depth) per frame: forward, then turned
    around (a half turn about y mirrors the image's x) walking back."""
    frames = []
    half_turn = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    for i in range(T_FWD + T_BACK):
        k = i % 8
        ox, oy = 0.1 * np.sin(k * np.pi / 4), 0.05 * np.cos(k * np.pi / 4)
        if i < T_FWD:
            z, rot, d = T_STEP * i, np.eye(3, dtype=np.float32), \
                _tube_depth(ox, oy)
        else:
            z = T_STEP * (2 * T_FWD - 2 - i)
            rot, d = half_turn, np.ascontiguousarray(_tube_depth(-ox,
                                                                 oy))
        frames.append((np.array([ox, oy, z], np.float32), rot, d))
    return frames


def _quat(rot):
    return [0.0, 1.0, 0.0, 0.0] if rot[0, 0] < 0 else [0.0, 0.0, 0.0, 1.0]


def test_tube_walk_matches_reference():
    """GeoWrapper(device="cpu") down the tube and back against the
    reference's pipeline run op by op, with its Streamer driven by the
    port's rule on fresh counts (GeoWrapper._bring_back and ._stream): on
    entering a chunk, the host chunks near its centre come back ahead of
    the frame, after a stream-out where they would bring the heap to the
    watermark; at the watermark, the farthest blocks beyond the keep
    radius of the chunk's centre go out.  The same stream-out events, and
    after streamAllOut the same host grid per key.  The port's stream-out
    within a frame whose allocation runs the heap dry (MapState.refill)
    has no counterpart in the reference's frame step, so it is off here
    (tests/test_torch_stream_ring.py holds it)."""
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.core.streaming import Streamer as JStreamer
    from mrhash_tpu.ops import camera as JC

    frames = _tube_frames()
    rgb = np.random.default_rng(2).integers(0, 255, (T_ROWS, T_COLS, 3)
                                            ).astype(np.uint8)
    gw = GeoWrapper(**T_KW, profiling=False, device="cpu")
    gw.state.refill = None
    gw.setCamera(T_F, T_F, T_COLS / 2 - 0.5, T_ROWS / 2 - 0.5, T_ROWS,
                 T_COLS, 0.01, T_MAXD)
    for t, rot, d in frames:
        gw.setCurrPose(t, _quat(rot))
        gw.setDepthImage(d)
        gw.setRGBImage(rgb)
        gw.compute()
    port_events = [e["blocks"] for e in gw.streamer.out_events]
    port_in = sum(e["inserted"] for e in gw.streamer.in_events)
    assert len(port_events) >= 3 and port_in > 0, (port_events, port_in)
    gw.streamAllOut()

    nb = T_KW["num_blocks"]
    jcfg = dataclasses.replace(
        _jcfg(virtual_voxel_size=0.02, sdf_truncation=0.06,
              max_integration_distance=T_MAXD, num_blocks=nb,
              max_active_blocks=nb, max_alloc_per_frame=nb),
        alloc_tile=gw.cfg.alloc_tile)
    cam0 = JC.make_camera(T_F, T_F, T_COLS / 2 - 0.5, T_ROWS / 2 - 0.5,
                          T_ROWS, T_COLS, 0.01, T_MAXD)
    # the port's keep radius about the centre of the camera's chunk
    jst = JStreamer(jcfg, gw.streamer.staging)
    grid = jst.grid
    keep = gw._protect_radius() + grid.chunk_radius
    state, high_free, events, near = jmake_state(nb), nb, [], None
    thr = P.STREAM_THRESHOLD * nb

    def stream_out(state, high_free, centre, incoming=0):
        need = min(int(P.STREAM_TARGET * nb) - high_free + incoming, 4096,
                   jst.staging)
        state = jst.stream_out(state, centre, keep, budget=max(need, 0))
        events.append(jst.out_stats["blocks"])
        return state, int(state.table.high_count)

    for t, rot, d in frames:
        key = tuple(int(k) for k in grid.world_to_chunk(t))
        centre = grid.chunk_to_world(key)
        if grid.chunks and key != near:
            near = key
            near_keys = [k for k in grid.chunks
                         if np.linalg.norm(grid.chunk_to_world(k) - centre)
                         <= keep + grid.chunk_radius]
            if near_keys:
                rows = sum(grid.chunks[k]["pos"].shape[0]
                           for k in near_keys)
                if high_free - rows <= thr:
                    state, high_free = stream_out(state, high_free, centre,
                                                  rows)
                state = jst.stream_in(state, centre,
                                      keep + 2 * grid.chunk_radius)
                high_free = int(state.table.high_count)
        if high_free <= thr:
            state, high_free = stream_out(state, high_free, centre)
            near = key
        with jax.disable_jit():
            state, stats = JP.integrate_rgbd(
                jcfg, state, JC.with_pose(cam0, jnp.asarray(rot),
                                          jnp.asarray(t)),
                jnp.asarray(d), jnp.asarray(rgb))
        high_free = int(stats["high_free"])
    jst.stream_all_out(state)
    assert events == port_events

    got, want = (_grid_by_key(s.grid.chunks) for s in (gw.streamer, jst))
    assert set(got) == set(want)
    n_w = 0
    for k, (r, w) in want.items():
        g = got[k][1]
        assert got[k][0] == r
        np.testing.assert_array_equal(g["w"], w["w"])
        upd = w["w"] > 0
        n_w += int(upd.sum())
        np.testing.assert_array_equal(g["rgb"][upd], w["rgb"][upd])
        np.testing.assert_allclose(g["sdf"][upd], w["sdf"][upd], atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(g["ssq"][upd], w["ssq"][upd], atol=5e-4,
                                   rtol=0)
    assert n_w > 20000


def _corridor_scan():
    """A 16x128 LiDAR scan in a corridor along x with walls at y = +-3 m
    and the ground at z = -1.5 m, the same from every x; returns beyond
    6 m are the zero point (no return).  f32[2048, 3] in the sensor
    frame."""
    el = np.linspace(-0.35, 0.25, 16)[:, None]
    az = (np.linspace(-np.pi, np.pi, 128, endpoint=False)
          + np.pi / 128)[None, :]
    d = np.stack(np.broadcast_arrays(np.cos(el) * np.cos(az),
                                     np.cos(el) * np.sin(az), np.sin(el)),
                 axis=-1)
    ty = np.where(np.abs(d[..., 1]) > 1e-6,
                  3.0 / np.maximum(np.abs(d[..., 1]), 1e-6), np.inf)
    tz = np.where(d[..., 2] < -1e-4, -1.5 / np.minimum(d[..., 2], -1e-4),
                  np.inf)
    t = np.minimum(ty, tz)
    t = np.where(t <= 6.0, t, 0.0)
    return (d * t[..., None]).reshape(-1, 3).astype(np.float32)


def test_lidar_past_the_watermark_streams():
    """A LiDAR walk down a corridor (5 m per scan) through
    GeoWrapper(device="cpu") with a 512-block pool: past the watermark the
    trigger streams the farthest blocks out instead of raising, and the
    scans keep integrating; streamAllOut then holds every block once."""
    gw = GeoWrapper(sdf_truncation=0.40, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.20,
                    n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                    gs_optimization_param_path="", num_blocks=512,
                    max_active_blocks=512, max_alloc_per_frame=512,
                    profiling=False, device="cpu")
    gw.setCamera(128 / (2 * np.pi), 16 / 0.65, 64.0, 8.0, 16, 128, 0.2, 6.0,
                 C.SPHERICAL)
    occupied, scan = [], _corridor_scan()
    for i in range(20):
        gw.setCurrPose([5.0 * i, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
        gw.setPointCloud(scan, False)
        gw.compute()
        occupied.append(gw.last_stats["occupied_total"])
    ev = [e["blocks"] for e in gw.streamer.out_events]
    assert len(ev) >= 2 and sum(ev) > 100, ev
    assert gw.last_stats["occupied_blocks"] > 50
    assert max(occupied) <= 512
    assert gw.streamer.duplicate_ratio(gw.state) < 0.15
    on_device = occupied[-1]
    in_ram = gw.streamer.grid.num_blocks()
    gw.streamAllOut()
    assert gw.streamer.grid.num_blocks() == in_ram + on_device
    w = np.concatenate([g["w"] for g in gw.streamer.grid.chunks.values()])
    assert (w > 0).sum() > 10000


def test_streamer_example_app(tmp_path, monkeypatch):
    """The port's apps/streamer_example on configurations/streamer_example.cfg
    (device="cpu"), with the app's own check: duplicate ratio < 0.15 after
    the checkpoint round trip."""
    from mrhash_tpu_torch.apps.streamer_example import main

    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configurations", "streamer_example.cfg")
    monkeypatch.chdir(tmp_path)
    gw = main(cfg, device="cpu")
    assert gw.streamer.grid.num_blocks() > 0
    assert (tmp_path / "streamer_example_grid.npz").exists()
    assert int((gw.state.table.ptr != P.FREE_ENTRY).sum()) == 0
