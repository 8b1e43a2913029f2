"""Variance-adaptive multi-resolution in the port against the JAX reference.

Both packages get the same inputs, made with numpy from a seed, and are
compared by content, not layout: the map from block key to (res, sdf,
weight, rgbp, sumsq) over the block's own window (512 voxels at res 0, 64
at res 1), since slots and heap rows may differ (PORT_NOTES.md P10).
Depth and LiDAR ranges are snapped to 1/2048 m, so the reference kernels'
quantisation is the identity (P1, P13).  Tolerances, each with its reason:

- RGB-D: weight and rgbp exact, sdf within 2e-5, sumsq within 5e-4 (the
  reference's own bounds for its fused kernel against its gather path:
  another f32 contraction or summation order moves an ulp), per-entry GC
  and coarsen decisions equal, and stats equal.  The reference runs jitted
  on poses without translation (jit contracts `voxel * vvs - t` into an
  FMA, P4) or op by op (jax.disable_jit) on translating poses.
- RGB-D slices with starvation are held against the reference's fused
  path: its GC reads the kernel's flags from before the starve (D12), as
  the port's does, while its gather path reads the starved rows.
- LiDAR: weight flips at most max(16, 1e-4 x lanes) and sdf within 2e-3
  where the weights agree (the reference's own bounds for its spherical
  kernel, P13, P15: atan2/asin may put a voxel on another pixel).
- The coarsen merge: weight and rgbp exact, sdf within 2e-5, sumsq within
  5e-4 (reductions over the 8 children in another order).

The `gpu` cases hold K1's and K3's res-1 paths against their twins on the
card (`python -m pytest --noconftest -m gpu tests/test_torch_multires.py`).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert, pipeline
from mrhash_tpu_torch.core.state import (VoxelPool, MapConfig, make_state,
                                         pack_rgb)
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import fused_integrate as FI
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import COUNTS

torch.set_num_threads(1)

FIELDS = ("sdf", "sumsq", "weight", "rgbp")

# RGB-D: tests/test_fused_integrate.py's 64x256 scene, multi-res
ROWS, COLS = 64, 256
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)
KW = dict(virtual_voxel_size=0.02, sdf_truncation=0.06,
          max_integration_distance=5.0, n_frames_invalidate_voxels=3,
          num_blocks=1 << 11, max_active_blocks=1 << 10,
          max_alloc_per_frame=1 << 10, alloc_tile=4, sdf_var_threshold=10.0)
N_FRAMES = 4                   # starvation fires on frame 3

# LiDAR: tests/test_torch_lidar.py's 16x128 scan, multi-res
L_ROWS, L_COLS, L_MAX = 16, 128, 40.0
L_CAM = (L_COLS / (2 * np.pi), L_ROWS / 0.65, L_COLS / 2.0, L_ROWS / 2.0,
         L_ROWS, L_COLS, 0.2, L_MAX)
L_KW = dict(virtual_voxel_size=0.20, sdf_truncation=0.40,
            max_integration_distance=L_MAX, num_blocks=1 << 12,
            max_active_blocks=1 << 11, num_buckets=1 << 11,
            max_alloc_per_frame=1 << 11, sdf_var_threshold=10.0)
L_FRAMES = 3


def _rgbd_frames(translate):
    """N_FRAMES depth images (1/2048 m grid, 4 mm noise so the Welford
    variance is positive and small) with their poses, and one colour
    image."""
    rng = np.random.default_rng(7)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    frames = []
    for i in range(N_FRAMES):
        d = np.round((base + rng.normal(0, 0.004, base.shape)) * 2048) / 2048
        t = np.array([0.01 * i, 0.005 * i, 0.0] if translate else [0.0] * 3,
                     np.float32)
        frames.append((d.astype(np.float32), np.eye(3, dtype=np.float32), t))
    return frames, rgb


def _content(state):
    """key -> (res, {field: the block's window}) of a port MapState or a
    reference state fetched to the host."""
    t = state.table
    pos, ptr, res = (np.asarray(getattr(t, k)) for k in ("pos", "ptr", "res"))
    pool = {f: np.asarray(getattr(state.pool, f)).reshape(-1) for f in FIELDS}
    out = {}
    for k, p, r in zip(pos, ptr, res):
        if p == P.FREE_ENTRY:
            continue
        n = P.TOTAL_LOW_BLOCK_SIZE if r == 1 else P.TOTAL_SDF_BLOCK_SIZE
        out[tuple(int(v) for v in k)] = (int(r), {f: pool[f][p:p + n]
                                                  for f in FIELDS})
    return out


def _stack(content, keys):
    """Concatenate the windows of `keys` per field."""
    return {f: np.concatenate([content[k][1][f] for k in keys])
            for f in FIELDS}


def _assert_same_map(got, want, min_res1=1):
    """Same keys, same resolutions, then weight and rgbp exact, sdf within
    2e-5 and sumsq within 5e-4 over the weighted voxels."""
    assert set(got) == set(want)
    keys = sorted(want)
    assert [got[k][0] for k in keys] == [want[k][0] for k in keys]
    n1 = sum(want[k][0] for k in keys)
    assert n1 >= min_res1, "no res-1 block: the case would be vacuous"
    g, r = _stack(got, keys), _stack(want, keys)
    np.testing.assert_array_equal(g["weight"], r["weight"])
    upd = r["weight"] > 0
    assert int(upd.sum()) > 5000, "the map holds almost nothing"
    np.testing.assert_array_equal(g["rgbp"][upd], r["rgbp"][upd])
    np.testing.assert_allclose(g["sdf"][upd], r["sdf"][upd], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(g["sumsq"][upd], r["sumsq"][upd], atol=5e-4,
                               rtol=0)
    print(f"{len(keys)} blocks, {n1} at res 1; max |diff| sdf "
          f"{np.abs(g['sdf'] - r['sdf'])[upd].max():.3g}, sumsq "
          f"{np.abs(g['sumsq'] - r['sumsq'])[upd].max():.3g}")
    return n1


def _jcfg(**kw):
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    return JMapConfig(**kw)


def _jcam(rot, t, cam=CAM, **kw):
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    return JC.with_pose(JC.make_camera(*cam, **kw), jnp.asarray(rot),
                        jnp.asarray(t))


def _jpc_depth(jcam, d):
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    return JC.get_depth(jcam, JC.compute_cloud(jcam, jnp.asarray(d)))


def _pad_window(bpos, bptr, bres, extra=32):
    """A port window as the reference's padded, masked window (room for
    its kind-segregated row slots)."""
    import jax.numpy as jnp
    A = bpos.shape[0]
    Ap = -(-(A + extra) // 16) * 16
    pos = np.zeros((Ap, 3), np.int32)
    ptr = np.zeros(Ap, np.int32)
    res = np.zeros(Ap, np.int32)
    pos[:A], ptr[:A], res[:A] = bpos.numpy(), bptr.numpy(), bres.numpy()
    return (jnp.asarray(pos), jnp.asarray(ptr), jnp.asarray(res),
            jnp.arange(Ap) < A)


# ---------------------------------------------------------------------------
# hash table and lattice
# ---------------------------------------------------------------------------

def test_split_high_blocks_matches_reference():
    from mrhash_tpu.ops import hashtable as JH
    jt = JH.make_table(16)
    t = H.make_table(16)
    for n in (3, 5, 100):          # the last asks for more than is left
        jt = JH.split_high_blocks(jt, n)
        H.split_high_blocks(t, n)
        assert (t.high_count, t.low_count) == (int(jt.high_count),
                                               int(jt.low_count))
        np.testing.assert_array_equal(t.heap_low[:t.low_count].numpy(),
                                      np.asarray(jt.heap_low)[:t.low_count])
        np.testing.assert_array_equal(t.heap_high[:t.high_count].numpy(),
                                      np.asarray(jt.heap_high)[:t.high_count])
    assert (t.high_count, t.low_count) == (0, 128)


@pytest.mark.parametrize("layout", ["window", "row"])
def test_block_voxel_grid_matches_reference(layout):
    import jax.numpy as jnp
    from mrhash_tpu.ops import integrate as JI
    rng = np.random.default_rng(0)
    A = 40
    bpos = rng.integers(-50, 50, (A, 3)).astype(np.int32)
    bres = (np.arange(A) % 3 == 0).astype(np.int32)
    lane0 = (rng.integers(0, 8, A) * 64 * bres).astype(np.int32)
    args = (bpos, bres) if layout == "window" else (bpos, bres, lane0)
    pi, lv = X.block_voxel_grid(*(torch.from_numpy(a) for a in args))
    jpi, jlv = JI._block_voxel_grid(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    m = lv.numpy()
    np.testing.assert_array_equal(pi.numpy()[m], np.asarray(jpi)[m])
    assert m.sum() == (A - bres.sum()) * 512 + bres.sum() * 64
    # a res-1 block's 64 voxels span its 8^3 region at twice the spacing
    k = int(np.nonzero(bres)[0][0])
    span = pi.numpy()[k][m[k]] - bpos[k] * 8
    assert set(np.unique(span)) == {0, 2, 4, 6}


# ---------------------------------------------------------------------------
# the RGB-D slice
# ---------------------------------------------------------------------------

def _rgbd_reference(mode):
    """Reference states and stats after each multi-res frame.  "fused": the
    Pallas kernels in interpret mode, jitted, poses without translation,
    starvation + GC on frame 3.  "gather": the gather path op by op on
    translating poses, GC off (its GC would read post-starve rows, D12)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import make_state as jmake_state

    kw = dict(KW) if mode == "fused" else dict(KW, n_frames_invalidate_voxels=0)
    jcfg = _jcfg(sample_mode=mode, pallas_interpret=True, **kw)
    frames, rgb = _rgbd_frames(translate=mode == "gather")
    state = jmake_state(jcfg.num_blocks)
    states, stats = [], []

    def run(step):
        nonlocal state
        for d, rot, t in frames:
            state, st = step(state, _jcam(rot, t), jnp.asarray(d))
            states.append(jax.device_get(state))
            stats.append({k: int(v) for k, v in st.items()})

    step = (lambda s, cam, d: JP.integrate_rgbd(jcfg, s, cam, d,
                                                jnp.asarray(rgb)))
    if mode == "fused":
        run(jax.jit(step))
    else:
        with jax.disable_jit():
            run(step)
    return mode, MapConfig(**kw), frames, rgb, states, stats


@pytest.fixture(scope="module")
def rgbd_fused():
    return _rgbd_reference("fused")


@pytest.fixture(scope="module", params=["fused", "gather"])
def rgbd_ref(request):
    if request.param == "fused":
        return request.getfixturevalue("rgbd_fused")
    return _rgbd_reference("gather")


def _port_rgbd_step(cfg, state, frame, rgb):
    d, rot, t = frame
    cam = C.with_pose(C.make_camera(*CAM), rot, t)
    return pipeline.integrate_rgbd(cfg, state, cam, torch.from_numpy(d),
                                   torch.from_numpy(rgb))


STAT_KEYS = ("occupied_blocks", "occupied_total", "high_free", "low_free",
             "frame", "unserved_blocks", "res0_blocks")


def test_rgbd_slice_matches_reference(rgbd_ref):
    mode, cfg, frames, rgb, ref_states, ref_stats = rgbd_ref
    state = make_state(cfg.num_blocks)
    for i, frame in enumerate(frames):
        state, stats = _port_rgbd_step(cfg, state, frame, rgb)
        for k in STAT_KEYS:
            assert stats[k] == ref_stats[i][k], (i, k)
    print(f"({mode})", end=" ")
    _assert_same_map(_content(state), _content(ref_states[-1]), min_res1=100)
    # coarsening ran on frame 1 and the map is mostly coarse
    assert ref_stats[0]["res0_blocks"] == ref_stats[0]["occupied_blocks"]
    assert ref_stats[1]["res0_blocks"] < ref_stats[1]["occupied_blocks"]
    assert ref_stats[0]["low_free"] == 0 < ref_stats[1]["low_free"]
    if mode == "fused":      # GC freed blocks on the starve frame
        assert ref_stats[3]["occupied_total"] < ref_stats[3][
            "occupied_blocks"]


def test_state_carry_from_multires_reference(rgbd_ref):
    """Both packages from the same multi-res reference state (heap_low and
    low_count carried by core.convert), the last two frames in the port."""
    mode, cfg, frames, rgb, ref_states, ref_stats = rgbd_ref
    state = convert.from_reference(ref_states[1])
    assert state.table.low_count > 0
    for i in (2, 3):
        state, stats = _port_rgbd_step(cfg, state, frames[i], rgb)
        for k in STAT_KEYS:
            assert stats[k] == ref_stats[i][k], (i, k)
    _assert_same_map(_content(state), _content(ref_states[3]), min_res1=100)


def _mixed_window(ref_state, frame, cfg):
    """The port's window of `frame` over a multi-res reference state,
    thinned so that it holds res-0 entries, res-1 siblings sharing a row
    and lone res-1 carves (two rows keep one entry each)."""
    state = convert.from_reference(ref_state)
    d, rot, t = frame
    cam = C.with_pose(C.make_camera(*CAM), rot, t)
    pc_depth = C.get_depth(cam, C.compute_cloud(cam, torch.from_numpy(d)))
    keys, valid = AB.alloc_candidates_depth(
        cfg, cam, pc_depth, cfg.dda_steps(5.0), frame=state.frame)
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    slots, bpos, bptr, bres = I.compact_active(cfg, state.table, cam)
    row = (bptr // 512).numpy()
    low = bres.numpy() == 1
    rows1, counts = np.unique(row[low], return_counts=True)
    lone = rows1[counts >= 2][:2]
    keep = np.ones(len(row), bool)
    for r in lone:                 # keep the first carve of each such row
        idx = np.nonzero(low & (row == r))[0]
        keep[idx[1:]] = False
    keep = torch.from_numpy(keep)
    slots, bpos, bptr, bres = (x[keep] for x in (slots, bpos, bptr, bres))
    row, low = row[keep.numpy()], low[keep.numpy()]
    _, counts = np.unique(row[low], return_counts=True)
    assert (counts >= 2).sum() > 10 and (counts == 1).sum() >= 2
    assert (~low).sum() > 10
    return state, cam, pc_depth, slots, bpos, bptr, bres


@pytest.mark.parametrize("oracle", ["kernel", "gather"])
def test_k1_twin_on_mixed_window_matches_reference(rgbd_fused, oracle):
    """K1's twin over a window mixing res-0 entries, res-1 siblings of
    shared rows and lone carves, against the reference's fused kernel
    (fused_integrate_pallas(multires=True), interpret mode) behind
    fused_integrate_depth, or its gather integrate_depth."""
    _, cfg, frames, rgb, ref_states, _ = rgbd_fused
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import integrate as JI

    state, cam, pc_depth, slots, bpos, bptr, bres = _mixed_window(
        ref_states[1], frames[2], cfg)
    ref_pool = jax.tree.map(jnp.asarray, ref_states[1].pool)
    gather_pool = _clone_pool(state.pool)
    aux = I.fused_integrate_depth(cfg, state.pool, cam, pc_depth,
                                  torch.from_numpy(rgb), bpos, bptr, bres)
    # the port's own gather integrate (the plain reference form) agrees
    # with its fused path bit for bit at both resolutions
    I.integrate_depth(cfg, gather_pool, cam, pc_depth, torch.from_numpy(rgb),
                      bpos, bptr, bres)
    for f in FIELDS:
        assert torch.equal(getattr(gather_pool, f), getattr(state.pool, f))

    jcfg = _jcfg(sample_mode="fused", pallas_interpret=True, **KW)
    jcam = _jcam(*frames[2][1:])
    args = _pad_window(bpos, bptr, bres)
    A = bpos.shape[0]
    jpc = _jpc_depth(jcam, frames[2][0])
    if oracle == "kernel":
        pool_r, raux = jax.jit(lambda p: JI.fused_integrate_depth(
            jcfg, p, jcam, jpc, jnp.asarray(rgb), *args))(ref_pool)
        np.testing.assert_array_equal(aux["gc_decision"].numpy(),
                                      np.asarray(raux["gc_decision"])[:A])
        np.testing.assert_array_equal(aux["coarsen_decide"].numpy(),
                                      np.asarray(raux["coarsen_decide"])[:A])
        assert int(raux["unserved_blocks"]) == 0
    else:
        pool_r = jax.jit(lambda p: JI.integrate_depth(
            jcfg, p, jcam, jpc, jnp.asarray(rgb), *args))(ref_pool)
        want = JI.coarsen_decide(jcfg, pool_r, *args[1:])
        np.testing.assert_array_equal(aux["coarsen_decide"].numpy(),
                                      np.asarray(want)[:A])
    assert aux["coarsen_decide"].any() and aux["gc_decision"].any()
    # the port's pool-read decision agrees with the one from K1's flags
    np.testing.assert_array_equal(
        I.coarsen_decide(cfg, state.pool, bptr, bres).numpy(),
        aux["coarsen_decide"].numpy())

    ref = SimpleNamespace(table=state.table, pool=pool_r)
    keys = {tuple(k) for k in bpos.numpy().tolist()}
    got = {k: v for k, v in _content(state).items() if k in keys}
    want = {k: v for k, v in _content(ref).items() if k in keys}
    print(f"(K1 window, {oracle})", end=" ")
    n1 = _assert_same_map(got, want, min_res1=100)
    assert n1 < len(keys)


# ---------------------------------------------------------------------------
# coarsening and the downsample merge
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("downsample", [True, False])
def test_coarsen_by_variance_matches_reference(downsample):
    """From a single-res map of two frames (empty low heap, so the high heap
    is split), serve at most 100 of the window's decisions in both
    packages: content map, heap counts and the freed mask equal."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import integrate as JI

    cfg = MapConfig(**dict(KW, sdf_var_threshold=0.0))
    frames, rgb = _rgbd_frames(translate=False)
    state = make_state(cfg.num_blocks)
    for frame in frames[:2]:
        state, _ = _port_rgbd_step(cfg, state, frame, rgb)
    ref_st = _reference_state(state)
    cfg = dataclasses.replace(cfg, sdf_var_threshold=KW["sdf_var_threshold"],
                              max_coarsen_per_frame=100,
                              coarsen_downsample=downsample)
    cam = C.with_pose(C.make_camera(*CAM), *frames[2][1:])
    slots, bpos, bptr, bres = I.compact_active(cfg, state.table, cam)
    decide = I.coarsen_decide(cfg, state.pool, bptr, bres)
    assert 100 < int(decide.sum()) and state.table.low_count == 0

    jcfg = _jcfg(sample_mode="gather", max_coarsen_per_frame=100,
                 coarsen_downsample=downsample, **KW)
    args = _pad_window(bpos, bptr, bres)
    A = bpos.shape[0]
    jslots = np.zeros(args[0].shape[0], np.int32)
    jslots[:A] = slots.numpy()
    jdecide = JI.coarsen_decide(jcfg, ref_st.pool, *args[1:])
    np.testing.assert_array_equal(np.asarray(jdecide)[:A], decide.numpy())
    table_r, pool_r, _, _, freed_r = jax.jit(
        lambda t, p: JI.coarsen_by_variance(
            jcfg, t, p, jnp.asarray(jslots), *args, decide=jdecide))(
        ref_st.table, ref_st.pool)

    _, new_mask, freed = CB.coarsen(cfg, state.table, state.pool,
                                               slots, bpos, decide)
    np.testing.assert_array_equal(freed.numpy(), np.asarray(freed_r)[:A])
    assert int(freed.sum()) == 100 and bool(new_mask.all())
    assert (state.table.high_count, state.table.low_count) == (
        int(table_r.high_count), int(table_r.low_count))

    ref = SimpleNamespace(table=table_r, pool=pool_r)
    got, want = _content(state), _content(ref)
    n1 = _assert_same_map(got, want, min_res1=100)
    w1 = _stack(want, [k for k in want if want[k][0] == 1])["weight"]
    # the merge carries the fine observations; without it the coarse
    # blocks start empty
    assert (int(w1.sum()) > 0) == downsample, n1


def test_coarsen_downsample_preserves_observations():
    """tests/test_integrate.py's downsample fixture through the port: 6
    single-res frames of a noisy wall, then one multi-res frame; the
    coarse voxel over the wall point merges its 8 children's weights (plus
    the reintegrated sample), and the de-biased merge estimates the SDF at
    the coarse voxel's centre, the (0,0,0) child's, better than the raw
    mean.  Without the merge the coarse voxel restarts at weight <= 2."""
    import copy
    import dataclasses

    rows, cols = 48, 64
    cam = C.make_camera(40.0, 40.0, cols / 2 - 0.5, rows / 2 - 0.5, rows,
                        cols, 0.01, 5.0)
    rgb = torch.full((rows, cols, 3), 90, dtype=torch.uint8)

    def noisy_depth(seed):
        n = np.random.default_rng(seed).normal(0, 0.004, (rows, cols))
        return torch.from_numpy((2.0 + n).astype(np.float32))

    cfg0 = MapConfig(virtual_voxel_size=0.05, sdf_truncation=0.1,
                     max_integration_distance=5.0, num_blocks=4096,
                     max_active_blocks=4096, max_alloc_per_frame=2048)
    state = make_state(cfg0.num_blocks)
    for f in range(6):
        state, _ = pipeline.integrate_rgbd(cfg0, state, cam, noisy_depth(f),
                                           rgb)
    vvs = cfg0.virtual_voxel_size
    pi = X.world_point_to_virtual_voxel_pos(
        vvs, torch.tensor([[0.025, 0.025, 2.025]]))
    blk = X.virtual_voxel_pos_to_sdf_block(pi, vvs, cfg0.voxel_extents)
    found, _, ptr0, res0 = H.lookup(state.table, blk)
    assert bool(found[0]) and int(res0[0]) == 0
    cx, cy, cz = (int(v) // 2 for v in (pi[0] % 8))
    child = np.asarray([(2 * cz + dz) * 64 + (2 * cy + dy) * 8 + 2 * cx + dx
                        for dz in range(2) for dy in range(2)
                        for dx in range(2)])
    cw = state.pool.weight.view(-1).numpy()[int(ptr0[0]) + child]
    csdf = state.pool.sdf.view(-1).numpy()[int(ptr0[0]) + child]
    assert (cw >= 6).all(), "children under-observed; fixture broken"
    mean_down = float((cw * csdf).sum() / cw.sum())

    results = {}
    for ds in (True, False):
        st = copy.deepcopy(state)     # the port updates states in place
        cfg1 = dataclasses.replace(cfg0, sdf_var_threshold=0.5,
                                   coarsen_downsample=ds)
        st, _ = pipeline.integrate_rgbd(cfg1, st, cam, noisy_depth(99), rgb)
        found1, _, ptr1, res1 = H.lookup(st.table, blk)
        assert bool(found1[0]) and int(res1[0]) == 1, \
            "wall block did not coarsen; fixture broken"
        v = int(ptr1[0]) + cz * 16 + cy * 4 + cx
        results[ds] = (int(st.pool.weight.view(-1)[v]),
                       float(st.pool.sdf.view(-1)[v]))
    (w_ds, sdf_ds), (w_plain, _) = results[True], results[False]
    assert w_ds >= int(cw.sum()), (w_ds, int(cw.sum()))
    assert w_plain <= 2, w_plain
    sdf_even = float(csdf[0])
    assert abs(sdf_ds - sdf_even) < 0.02, (sdf_ds, sdf_even, mean_down)
    assert abs(sdf_ds - sdf_even) <= abs(mean_down - sdf_even) + 1e-3


# ---------------------------------------------------------------------------
# LiDAR
# ---------------------------------------------------------------------------

def _lidar_cloud(org, rng):
    """Ground plane at z = -1.5 m + cylinder wall of radius 12 m seen from
    `org`, beams half a column off the raster edges, 1 cm noise, ranges
    snapped to 1/2048 m (tests/test_torch_lidar.py's scan)."""
    el = np.linspace(-0.35, 0.25, L_ROWS)[:, None]
    az = (np.linspace(-np.pi, np.pi, L_COLS, endpoint=False)
          + np.pi / L_COLS)[None, :]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az) + 0 * el,
                  np.sin(el) + 0 * az], axis=-1)
    org = np.asarray(org, np.float64)
    tz = np.where(d[..., 2] < -1e-4, (-1.5 - org[2]) / d[..., 2], np.inf)
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2 * (org[0] * dx + org[1] * dy)
    c = org[0] ** 2 + org[1] ** 2 - 12.0 ** 2
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    tc = np.where(a > 1e-9, (-b + np.sqrt(disc)) / (2 * np.maximum(a, 1e-9)),
                  np.inf)
    t = np.minimum(tz, np.where(tc > 0, tc, np.inf))
    t = np.where(np.isfinite(t), t, 0.0)
    t = np.round((t + rng.normal(0, 0.01, t.shape) * (t > 0)) * 2048) / 2048
    return (d * t[..., None]).reshape(-1, 3).astype(np.float32)


def _lidar_frames():
    rng = np.random.default_rng(1)
    out = []
    for i in range(L_FRAMES):
        t = np.array([0.4 * i, 0.1 * i, 0.0], np.float32)
        out.append((t, _lidar_cloud(t, rng)))
    return out


def _lidar_cam(t, device="cpu"):
    return C.with_pose(C.make_camera(*L_CAM, model=C.SPHERICAL,
                                     device=device),
                       np.eye(3, dtype=np.float32), t)


@pytest.fixture(scope="module")
def lidar_ref():
    """Reference states + stats after each multi-res scan: the fused
    spherical kernel in interpret mode, op by op."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.ops import camera as JC

    jcfg = _jcfg(sample_mode="fused", pallas_interpret=True, **L_KW)
    n = L_ROWS * L_COLS
    state = jmake_state(jcfg.num_blocks, jcfg.num_buckets)
    states, stats = [], []
    with jax.disable_jit():
        for t, pts in _lidar_frames():
            cam = _jcam(np.eye(3, dtype=np.float32), t, L_CAM,
                        model=JC.SPHERICAL)
            state, st = JP.integrate_points(
                jcfg, state, cam, jnp.asarray(pts), jnp.zeros((n, 3)),
                jnp.ones((n,)), jnp.ones((n,), bool))
            states.append(jax.device_get(state))
            stats.append({k: int(v) for k, v in st.items()})
    return jcfg, states, stats


def _assert_close_lidar_maps(got, want):
    """Same keys and resolutions; weight flips at most max(16, 1e-4 x
    lanes), sdf within 2e-3 where the weights agree and are non-zero
    (P13, P15).  Returns (res-1 blocks, flips)."""
    assert set(got) == set(want)
    keys = sorted(want)
    assert [got[k][0] for k in keys] == [want[k][0] for k in keys]
    g, r = _stack(got, keys), _stack(want, keys)
    assert int((r["weight"] > 0).sum()) > 5000, "scene integrated nothing"
    flips = int((g["weight"] != r["weight"]).sum())
    assert flips <= max(16, int(g["weight"].size * 1e-4)), flips
    agree = (g["weight"] == r["weight"]) & (r["weight"] > 0)
    assert float(np.abs(g["sdf"] - r["sdf"])[agree].max()) < 2e-3
    n1 = sum(want[k][0] for k in keys)
    assert n1 > 20, "no coarsening: the case would be vacuous"
    return n1, flips


def test_k3_twin_on_mixed_window_matches_reference(lidar_ref):
    """K3's twin over the multi-res window of scan 3, from the reference's
    state after scan 2, against the reference's fused_integrate_points
    (the packed res-1 branch of _kernel_sph, interpret mode)."""
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import integrate as JI

    jcfg, states, _ = lidar_ref
    cfg = MapConfig(**L_KW)
    t, pts = _lidar_frames()[2]
    state = convert.from_reference(states[1])
    cam = _lidar_cam(t)
    points = torch.from_numpy(pts)
    keys, valid = AB.alloc_candidates_points(cfg, cam, points,
                                            cfg.dda_steps(L_MAX))
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    slots, bpos, bptr, bres = I.compact_active(cfg, state.table)
    assert int(bres.sum()) > 20 and int((bres == 0).sum()) > 20
    aux = I.fused_integrate_points(cfg, state.pool, cam, points, bpos, bptr,
                                   bres)

    n = pts.shape[0]
    args = _pad_window(bpos, bptr, bres)
    jslots = jnp.zeros(args[0].shape[0], jnp.int32)
    with jax.disable_jit():
        pool_r, raux = JI.fused_integrate_points(
            jcfg, None, jax.tree.map(jnp.asarray, states[1].pool),
            _jcam(np.eye(3, dtype=np.float32), t, L_CAM,
                  model=JC.SPHERICAL),
            jnp.asarray(pts), jnp.zeros((n, 3)), jnp.ones((n,)),
            jnp.ones((n,), bool), jnp.int32(states[1].frame),
            window=(jslots, *args))
    assert int(raux["unserved_blocks"]) == 0

    ref = SimpleNamespace(table=state.table, pool=pool_r)
    wkeys = {tuple(k) for k in bpos.numpy().tolist()}
    got = {k: v for k, v in _content(state).items() if k in wkeys}
    want = {k: v for k, v in _content(ref).items() if k in wkeys}
    _, flips = _assert_close_lidar_maps(got, want)
    A = bpos.shape[0]
    for k in ("gc_decision", "coarsen_decide"):
        assert int((aux[k].numpy() != np.asarray(raux[k])[:A]).sum()) <= (
            flips)


def test_lidar_slice_matches_reference(lidar_ref):
    """Three multi-res scans through GeoWrapper(device="cpu") against the
    reference's pipeline.integrate_points; the coarsened blocks are not
    reintegrated on their scan, in both (the reference's quirk)."""
    _, states, stats = lidar_ref
    gw = GeoWrapper(0.40, 0.0, 1, 0.20, 0, 1, min_depth=0.2, max_depth=L_MAX,
                    sdf_var_threshold=L_KW["sdf_var_threshold"],
                    num_blocks=L_KW["num_blocks"],
                    num_buckets=L_KW["num_buckets"],
                    max_active_blocks=L_KW["max_active_blocks"],
                    max_alloc_per_frame=L_KW["max_alloc_per_frame"],
                    profiling=False, device="cpu")
    gw.setCamera(*L_CAM, camera_model=C.SPHERICAL)
    for i, (t, pts) in enumerate(_lidar_frames()):
        gw.setCurrPose(t, [0.0, 0.0, 0.0, 1.0])
        gw.setPointCloud(pts, False)
        gw.compute()
        for k in ("occupied_blocks", "occupied_total", "high_free",
                  "low_free", "frame", "unserved_blocks"):
            assert gw.last_stats[k] == stats[i][k], (i, k)
    n1, flips = _assert_close_lidar_maps(_content(gw.state),
                                         _content(states[-1]))
    print(f"LiDAR slice: {n1} res-1 blocks, {flips} weight flips")


# ---------------------------------------------------------------------------
# entry point: GeoWrapper -> streamAllOut -> extractMesh
# ---------------------------------------------------------------------------

def test_geowrapper_multires_mesh_matches_reference(tmp_path, monkeypatch):
    """GeoWrapper(sdf_var_threshold=0.5) in both packages over 4 frames of
    a noisy wall (poses without translation, P4), then streamAllOut and
    extractMesh: the port's vertices match the reference's one to one."""
    pytest.importorskip("jax")
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper

    monkeypatch.chdir(tmp_path)     # the reference writes reports here
    rows, cols = 48, 64
    rng = np.random.default_rng(3)
    depths = [(2.0 + 0.3 * np.sin(np.arange(cols) / 9.0)[None, :]
               + rng.normal(0, 0.004, (rows, cols))).astype(np.float32)
              for _ in range(4)]
    rgb = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
    kw = dict(sdf_truncation=0.15, sdf_truncation_scale=0.0,
              integration_weight_sample=1, virtual_voxel_size=0.05,
              n_frames_invalidate_voxels=0, voxel_extents_scale=1,
              gs_optimization_param_path="", sdf_var_threshold=0.5,
              num_blocks=1 << 12, max_active_blocks=1 << 12,
              max_alloc_per_frame=1 << 11, profiling=False)
    verts = {}
    for name, gw in (("port", GeoWrapper(device="cpu", **kw)),
                     ("ref", JGeoWrapper(**kw))):
        gw.setCamera(40.0, 40.0, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols,
                     0.01, 5.0)
        for d in depths:
            gw.setCurrPose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
            gw.setDepthImage(d)
            gw.setRGBImage(rgb)
            gw.compute()
        if name == "port":
            res = gw.state.table.res[gw.state.table.ptr != P.FREE_ENTRY]
            assert int(res.sum()) > 10, "nothing coarsened"
        gw.streamAllOut()
        gw.extractMesh(str(tmp_path / f"{name}.ply"))
        verts[name] = np.asarray(gw.getVertices(), np.float64)
    got, want = verts["port"], verts["ref"]
    assert got.shape == want.shape and want.shape[0] > 500, (got.shape,
                                                             want.shape)
    # one to one: the meshes hold vertices 1e-7 apart, which a nearest
    # neighbour match can collapse; lexicographic order pairs them
    gs, ws = got[np.lexsort(got.T)], want[np.lexsort(want.T)]
    assert float(np.abs(gs - ws).max()) < 1e-5, float(np.abs(gs - ws).max())


# ---------------------------------------------------------------------------
# on the card: the res-1 kernels against their twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _clone_pool(pool):
    return VoxelPool(**{f: getattr(pool, f).clone() for f in FIELDS})


@pytest.mark.gpu
def test_k1_res1_matches_twin_on_card(cuda):
    cfg = MapConfig(**KW)
    frames, rgb = _rgbd_frames(translate=True)
    st = make_state(cfg.num_blocks, device=cuda)
    rgb_d = torch.from_numpy(rgb).to(cuda)
    for d, rot, t in frames[:2]:
        cam = C.with_pose(C.make_camera(*CAM, device=cuda), rot, t)
        st, _ = pipeline.integrate_rgbd(cfg, st, cam,
                                        torch.from_numpy(d).to(cuda), rgb_d)
    d, rot, t = frames[2]
    cam = C.with_pose(C.make_camera(*CAM, device=cuda), rot, t)
    pc_depth = C.get_depth(cam, C.compute_cloud(
        cam, torch.from_numpy(d).to(cuda))).contiguous()
    _, bpos, bptr, bres = I.compact_active(cfg, st.table, cam)
    assert int(bres.sum()) > 100 and int((bres == 0).sum()) > 10
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale, 5.0, 1, 255)
    rgbp = pack_rgb(rgb_d).contiguous()
    pk, pt = _clone_pool(st.pool), _clone_pool(st.pool)
    n0, n1 = (COUNTS["fused_integrate_rows"],
              COUNTS["fused_integrate_rows_res1"])
    fk = FI.fused_integrate_rows(pk, pc_depth, rgbp, cam_vec, bpos, bptr,
                                 bres)
    ft = FI.fused_integrate_rows_ref(pt, pc_depth, rgbp, cam_vec, bpos, bptr,
                                     bres)
    torch.cuda.synchronize()
    assert (COUNTS["fused_integrate_rows"],
            COUNTS["fused_integrate_rows_res1"]) == (n0 + 1, n1 + 1)
    for f in ("weight", "rgbp"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight != st.pool.weight).sum()) > 1000
    assert float((pk.sdf - pt.sdf).abs().max()) <= 2e-5
    assert float((pk.sumsq - pt.sumsq).abs().max()) <= 5e-4
    assert torch.equal(fk[:, :3], ft[:, :3])
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_k1_res0_entries_of_mixed_window_on_card(cuda):
    """K1's res-0 kernel over the res-0 entries of a mixed multi-res
    window alone: a non-contiguous subset of the window's indices, whose
    res-1 siblings stay untouched."""
    cfg = MapConfig(**KW)
    frames, rgb = _rgbd_frames(translate=True)
    st = make_state(cfg.num_blocks, device=cuda)
    rgb_d = torch.from_numpy(rgb).to(cuda)
    for d, rot, t in frames[:2]:
        cam = C.with_pose(C.make_camera(*CAM, device=cuda), rot, t)
        st, _ = pipeline.integrate_rgbd(cfg, st, cam,
                                        torch.from_numpy(d).to(cuda), rgb_d)
    d, rot, t = frames[2]
    cam = C.with_pose(C.make_camera(*CAM, device=cuda), rot, t)
    pc_depth = C.get_depth(cam, C.compute_cloud(
        cam, torch.from_numpy(d).to(cuda))).contiguous()
    _, bpos, bptr, bres = I.compact_active(cfg, st.table, cam)
    entries = torch.nonzero(bres == 0)[:, 0].contiguous()
    gaps = entries[1:] - entries[:-1]
    assert entries.numel() > 10 and int(gaps.max()) > 1
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale, 5.0, 1, 255)
    rgbp = pack_rgb(rgb_d).contiguous()
    pk, pt = _clone_pool(st.pool), _clone_pool(st.pool)
    fk = torch.full((bpos.shape[0], 4), float("nan"), device=cuda)
    n0 = COUNTS["fused_integrate_rows"]
    FI._launch(pk, pc_depth, rgbp, cam_vec, bpos, bptr, entries, 0, fk)
    ft = FI.fused_integrate_rows_ref(pt, pc_depth, rgbp, cam_vec,
                                     bpos[entries], bptr[entries],
                                     bres[entries])
    torch.cuda.synchronize()
    assert COUNTS["fused_integrate_rows"] == n0 + 1
    for f in ("weight", "rgbp"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight != st.pool.weight).sum()) > 1000
    assert float((pk.sdf - pt.sdf).abs().max()) <= 2e-5
    assert float((pk.sumsq - pt.sumsq).abs().max()) <= 5e-4
    assert torch.equal(fk[entries, :3], ft[:, :3])
    torch.testing.assert_close(fk[entries, 3], ft[:, 3], rtol=1e-4,
                               atol=1e-6)
    assert torch.isnan(fk[bres == 1]).all()


@pytest.mark.gpu
def test_k3_res1_matches_twin_on_card(cuda):
    cfg = MapConfig(**L_KW)
    st = make_state(cfg.num_blocks, cfg.num_buckets, cuda)
    frames = _lidar_frames()
    for t, pts in frames[:2]:
        st, _ = pipeline.integrate_points(cfg, st, _lidar_cam(t, cuda),
                                          torch.from_numpy(pts).to(cuda))
    t, pts = frames[2]
    cam = _lidar_cam(t, cuda)
    points = torch.from_numpy(pts).to(cuda)
    _, bpos, bptr, bres = I.compact_active(cfg, st.table)
    assert int(bres.sum()) > 20
    operands = I.points_window(cfg, cam, points, bpos, bptr, bres)
    pk, pt = _clone_pool(st.pool), _clone_pool(st.pool)
    n1 = COUNTS["fused_integrate_points_rows_res1"]
    fk = FIP.fused_integrate_points_rows(pk, *operands)
    ft = FIP.fused_integrate_points_rows_ref(pt, *operands)
    torch.cuda.synchronize()
    assert COUNTS["fused_integrate_points_rows_res1"] == n1 + 1
    for f in ("sdf", "sumsq", "weight"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight != st.pool.weight).sum()) > 1000
    assert torch.equal(fk[:, :3], ft[:, :3])
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)


def _k3_window(n0, n1, seed, device):
    """A K3 window of n0 res-0 entries (whole rows) and n1 res-1 entries
    (64-lane windows, up to 8 per row), in random order, over a pool with
    random content; pix on a 8x64 range image (some -1, some empty
    pixels), r_vox within the truncation band of about half the lanes."""
    rng = np.random.default_rng(seed)
    N = n0 + (n1 + 7) // 8 + 2
    pool = make_state(N, device=device).pool
    pool.weight.copy_(torch.from_numpy(
        rng.integers(0, 3, (N, 512)).astype(np.int32)))
    pool.sdf.copy_(torch.from_numpy(
        rng.uniform(-0.4, 0.4, (N, 512)).astype(np.float32)))
    pool.sumsq.copy_(torch.from_numpy(
        rng.uniform(0, 1, (N, 512)).astype(np.float32)))
    rows = rng.permutation(N)
    ptr = [int(r) * 512 for r in rows[:n0]]
    ptr += [int(rows[n0 + i // 8]) * 512 + 64 * (i % 8) for i in range(n1)]
    res = np.array([0] * n0 + [1] * n1)
    perm = rng.permutation(n0 + n1)
    img = rng.uniform(0, 10, (8, 64)).astype(np.float32)
    img[0, :5] = 0.0
    pix = rng.integers(-1, 8 * 64, (n0 + n1, 512)).astype(np.int32)
    r_vox = (img.reshape(-1)[np.maximum(pix, 0)]
             + rng.uniform(-0.6, 0.6, pix.shape)).astype(np.float32)
    t = (lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dt))
    return (pool, t(img, torch.float32), t(pix, torch.int32),
            t(r_vox, torch.float32),
            t(np.array(ptr)[perm], torch.int32), t(res[perm], torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n0,n1", [(0, 13), (21, 0), (5, 13), (3, 1),
                                   (0, 8)])
def test_k3_mixed_window_one_launch_on_card(cuda, n0, n1):
    """K3 serves a window of both resolutions in one launch, res-0
    entries first: pools and flags equal to the twin's (the sumsq flag
    within rounding), one launch counted per resolution it served, for
    windows with no res-0 or no res-1 entry and counts that are not a
    multiple of the entries a CTA takes."""
    pool, img, pix, r_vox, ptr, res = _k3_window(n0, n1, 7 * n0 + n1, cuda)
    consts = (0.4, 0.0, 40.0, 1.0, 255.0, 0.2)
    pk, pt = _clone_pool(pool), _clone_pool(pool)
    c0, c1 = (COUNTS["fused_integrate_points_rows"],
              COUNTS["fused_integrate_points_rows_res1"])
    fk = FIP.fused_integrate_points_rows(pk, img, pix, r_vox, ptr, res,
                                         consts)
    ft = FIP.fused_integrate_points_rows_ref(pt, img, pix, r_vox, ptr, res,
                                             consts)
    torch.cuda.synchronize()
    assert (COUNTS["fused_integrate_points_rows"],
            COUNTS["fused_integrate_points_rows_res1"]) == (
        c0 + (n0 > 0), c1 + (n1 > 0))
    for f in ("sdf", "sumsq", "weight"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight != pool.weight).sum()) > 100
    assert torch.equal(fk[:, :3], ft[:, :3])
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
