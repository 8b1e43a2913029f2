"""The port's LiDAR path (single resolution, projective) against the JAX
reference.

Scene: tests/test_fused_integrate.py's 16x128 scan of a ground plane and a
12 m cylinder wall (0.2 m voxels, 2^12 blocks), made with numpy from a
seed.  Ranges are snapped to 1/2048 m, so the reference kernel's range
quantisation is the identity up to the f32 norm's last ulp
(PORT_NOTES.md P13).  Beam azimuths sit half a column off the column
edges, so no return lies on a raster boundary.  The reference runs with
sample_mode="fused" and pallas_interpret=True, op by op (jax.disable_jit:
jit contracts `voxel * vvs - t` into an FMA, PORT_NOTES.md P4).

- (a) alloc_candidates_points: the candidate key set equals the
  reference's exactly.
- (b) kernel K3's plain twin against the reference's pure-XLA
  voxel-centric oracle `_points_fallback`, both fed the same (row, col,
  r_vox) and the same unpadded range image: sdf, sumsq and weight equal.
- (c) the port's fused_integrate_points against the reference's (Pallas
  kernel + element fallback), from the reference state carried across
  with core.convert.from_reference; (d) three frames of the whole slice
  through GeoWrapper(device="cpu") against the reference's
  pipeline.integrate_points.  Per block key: weight flips at most
  max(16, 1e-4 x lanes) and sdf within 2e-3 where the weights agree and
  are non-zero (the reference's own bounds,
  test_fused_points_matches_voxel_centric_xla);
  the count of lanes that XLA's and torch's atan2/asin put on another
  pixel is reported and bounded the same way (PORT_NOTES.md P15).
- (e) on the card: K3 against its twin: the map exactly, the flags'
  sumsq sum within rounding (another summation order).
"""
import functools

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import native
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert
from mrhash_tpu_torch.core.state import MapConfig, make_state
from mrhash_tpu_torch.geowrapper import GeoWrapper
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import scan_raster as SR
from mrhash_tpu_torch.utils.profiler import COUNTS

torch.set_num_threads(1)

ROWS, COLS = 16, 128
N_FRAMES = 3
MAX_D = 40.0
CFG = dict(virtual_voxel_size=0.20, sdf_truncation=0.40,
           sdf_truncation_scale=0.0, integration_weight_sample=1,
           max_integration_distance=MAX_D, n_frames_invalidate_voxels=0,
           num_blocks=1 << 12, max_active_blocks=1 << 11,
           num_buckets=1 << 11, max_alloc_per_frame=1 << 11)
CAM = (COLS / (2 * np.pi), ROWS / 0.65, COLS / 2.0, ROWS / 2.0, ROWS, COLS,
       0.2, MAX_D)
CONSTS = (0.40, 0.0, MAX_D, 1, P.INTEGRATION_WEIGHT_MAX, 0.20)


def _cloud(org, rng):
    """Ground plane at z = -1.5 m + cylinder wall of radius 12 m, seen from
    `org` (z-up spherical model), 1 cm range noise, ranges snapped to
    1/2048 m.  Returns f32[ROWS*COLS, 3] in the sensor frame."""
    el = np.linspace(-0.35, 0.25, ROWS)[:, None]
    az = (np.linspace(-np.pi, np.pi, COLS, endpoint=False)
          + np.pi / COLS)[None, :]
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


def _frames():
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_FRAMES):
        t = np.array([0.4 * i, 0.1 * i, 0.0], np.float32)
        out.append((t, _cloud(t, rng)))
    return out


@functools.lru_cache(maxsize=None)
def _normals(i):
    """MADtree normals of scan i (the port's host library), f32[N,3]; the
    normal of point 7 is zero (it walks a degenerate segment)."""
    _, pts = _frames()[i]
    n = np.array(native.estimate_normals(pts)[0], np.float32)
    n[7] = 0.0
    return n


def _port_cam(t, device="cpu"):
    return C.with_pose(C.make_camera(*CAM, model=C.SPHERICAL, device=device),
                       np.eye(3, dtype=np.float32), t)


@pytest.fixture(scope="module")
def ref():
    """Reference states after each frame, op by op."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.ops import camera as JC

    jcfg = JMapConfig(sample_mode="fused", pallas_interpret=True, **CFG)
    n = ROWS * COLS
    state = jmake_state(jcfg.num_blocks, jcfg.num_buckets)
    states, stats = [], []
    with jax.disable_jit():
        for t, pts in _frames():
            cam = JC.with_pose(JC.make_camera(*CAM, model=JC.SPHERICAL),
                               jnp.eye(3, dtype=jnp.float32), jnp.asarray(t))
            state, st = JP.integrate_points(
                jcfg, state, cam, jnp.asarray(pts), jnp.zeros((n, 3)),
                jnp.ones((n,)), jnp.ones((n,), bool))
            states.append(jax.device_get(state))
            stats.append({k: int(v) for k, v in st.items()})
    return jcfg, states, stats


def _jcam(t):
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    return JC.with_pose(JC.make_camera(*CAM, model=JC.SPHERICAL),
                        jnp.eye(3, dtype=jnp.float32), jnp.asarray(t))


def _by_key(pos, ptr):
    occ = ptr != P.FREE_ENTRY
    return {tuple(int(v) for v in k): int(p) // 512
            for k, p in zip(pos[occ], ptr[occ])}


def _rows_by_key(port_state, ref_state):
    """Same key set, then the port's and the reference's rows of each key
    (sorted key order)."""
    got = _by_key(port_state.table.pos.numpy(), port_state.table.ptr.numpy())
    want = _by_key(np.asarray(ref_state.table.pos),
                   np.asarray(ref_state.table.ptr))
    assert set(got) == set(want)
    keys = sorted(want)
    gr = np.asarray([got[k] for k in keys])
    rr = np.asarray([want[k] for k in keys])
    g = {f: getattr(port_state.pool, f).numpy()[gr]
         for f in ("sdf", "sumsq", "weight")}
    r = {f: np.asarray(getattr(ref_state.pool, f))[rr] for f in g}
    return g, r


def _assert_close_maps(g, r):
    """The reference's bounds (test_fused_points_matches_voxel_centric_xla):
    weight flips <= max(16, 1e-4 lanes); sdf within 2e-3 where the weights
    agree and are non-zero.  Returns (flips, max sdf difference)."""
    bound = max(16, int(g["weight"].size * 1e-4))
    assert int((r["weight"] > 0).sum()) > 20000, "scene integrated nothing"
    flips = int((g["weight"] != r["weight"]).sum())
    assert flips <= bound, (flips, bound)
    agree = (g["weight"] == r["weight"]) & (r["weight"] > 0)
    d = float(np.abs(g["sdf"] - r["sdf"])[agree].max())
    assert d < 2e-3, d
    return flips, d


def _pixel_mismatches(ref_window_pos, pts, t):
    """Lanes of a window that XLA's and torch's atan2/asin put on another
    pixel (or across the in-image gate)."""
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import coords as JX
    from mrhash_tpu.ops import integrate as JI

    jcam = _jcam(t)
    bpos = jnp.asarray(ref_window_pos)
    el_lo, s_el = JI._scan_raster_mapping(jcam, jnp.asarray(pts),
                                          jnp.ones((pts.shape[0],), bool))
    pi, _ = JI._block_voxel_grid(bpos, jnp.zeros(bpos.shape[0], jnp.int32))
    pw = JX.virtual_voxel_pos_to_world(0.20, pi)
    row, col, rv, inr = JI._sph_rowcol(jcam, JC.world_to_cam(jcam, pw),
                                       el_lo, s_el)
    ok = np.asarray(inr & (rv >= 0.2) & (rv <= MAX_D))
    want = np.where(ok, np.asarray(row) * COLS + np.asarray(col), -1)
    cam = _port_cam(t)
    el_lo_p, s_el_p = SR.scan_raster_mapping(cam, torch.from_numpy(pts))
    n = ref_window_pos.shape[0]
    pix, _ = SR.project_window_sph(MapConfig(**CFG), cam,
                                   torch.from_numpy(ref_window_pos),
                                   torch.zeros(n, dtype=torch.int32),
                                   el_lo_p, s_el_p)
    return int((pix.numpy() != want).sum())


# ---------------------------------------------------------------------------
# (a) allocation
# ---------------------------------------------------------------------------

def test_alloc_candidates_points_matches_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.ops import integrate as JI

    cfg = MapConfig(**CFG)
    steps = cfg.dda_steps(MAX_D)
    t, pts = _frames()[2]
    pts[5] = 0.0                      # a point with no return walks nothing
    keys, valid = AB.alloc_candidates_points(cfg, _port_cam(t),
                                            torch.from_numpy(pts), steps)
    with jax.disable_jit():
        jk, jv = JI.alloc_candidates_points(
            JMapConfig(**CFG), _jcam(t), jnp.asarray(pts),
            jnp.zeros_like(jnp.asarray(pts)),
            jnp.ones((pts.shape[0],), bool), steps)
    got = {tuple(k) for k in keys.numpy()[valid.numpy()]}
    want = {tuple(k) for k in np.asarray(jk)[np.asarray(jv)]}
    assert len(want) > 300
    assert got == want
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# (b) the kernel's twin against the reference's voxel-centric oracle
# ---------------------------------------------------------------------------

def test_twin_matches_reference_points_fallback(ref):
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import coords as JX
    from mrhash_tpu.ops import integrate as JI

    jcfg, states, _ = ref
    t, pts = _frames()[2]
    jcam = _jcam(t)
    # frame 3's window (the frame-3 table) over the frame-2 pool; rows
    # allocated on frame 3 are still zero there
    table = states[2].table
    occ = np.asarray(table.ptr) != P.FREE_ENTRY
    bpos = np.asarray(table.pos)[occ]
    bptr = np.asarray(table.ptr)[occ]
    A = bpos.shape[0]
    jpts = jnp.asarray(pts)
    jvalid = jnp.ones((pts.shape[0],), bool)
    el_lo, s_el = JI._scan_raster_mapping(jcam, jpts, jvalid)
    img = JI.rasterize_scan(jcfg, jcam, jpts, jvalid, el_lo, s_el)
    img = img[:ROWS, JI.SPH_PAD:JI.SPH_PAD + COLS]
    pi, _ = JI._block_voxel_grid(jnp.asarray(bpos), jnp.zeros(A, jnp.int32))
    pw = JX.virtual_voxel_pos_to_world(jcfg.virtual_voxel_size, pi)
    row, col, rv, inr = JI._sph_rowcol(jcam, JC.world_to_cam(jcam, pw),
                                       el_lo, s_el)
    ok = inr & (rv >= jcam.min_depth) & (rv <= jcam.max_depth)
    pool_r = JI._points_fallback(
        jcfg, jax.tree.map(jnp.asarray, states[1].pool), jcam, img, row, col,
        rv, ok, jnp.asarray(bptr))

    pool = convert.from_reference(states[1]).pool
    ok_n = np.asarray(ok)
    pix = np.where(ok_n, np.asarray(row) * COLS + np.asarray(col), -1)
    flags = FIP.fused_integrate_points_rows(
        pool, torch.from_numpy(np.array(img)),
        torch.from_numpy(pix.astype(np.int32)),
        torch.from_numpy(np.array(rv)), torch.from_numpy(bptr),
        torch.zeros(A, dtype=torch.int32), CONSTS)
    rows = bptr // 512
    for f in ("sdf", "sumsq", "weight"):
        np.testing.assert_array_equal(getattr(pool, f).numpy()[rows],
                                      np.asarray(getattr(pool_r, f))[rows])
    w = pool.weight.numpy()[rows]
    assert int((w > np.asarray(states[1].pool.weight)[rows]).sum()) > 10000
    assert int((w > 1).sum()) > 5000, "Welford merge never exercised"
    s = pool.sdf.numpy()[rows]
    np.testing.assert_array_equal(
        flags[:, 0].numpy(),
        np.where(w > 0, np.abs(s), np.float32(FIP.FAR_F32)).min(axis=1))
    np.testing.assert_array_equal(flags[:, 1].numpy(), w.max(axis=1))


def test_wrapper_rejects_bad_operands():
    pool = make_state(4).pool
    img = torch.ones((ROWS, COLS))
    pix = torch.zeros((2, 512), dtype=torch.int32)
    r_vox = torch.ones((2, 512))
    ptr = torch.tensor([0, 512], dtype=torch.int32)
    res = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ptr"):
        FIP.fused_integrate_points_rows(pool, img, pix, r_vox, ptr.long(),
                                        res, CONSTS)
    with pytest.raises(ValueError, match="pix"):
        FIP.fused_integrate_points_rows(pool, img, pix.t().contiguous(),
                                        r_vox, ptr, res, CONSTS)
    with pytest.raises(ValueError, match="consts"):
        FIP.fused_integrate_points_rows(pool, img, pix, r_vox, ptr, res,
                                        CONSTS[:5])
    # a negative window would wrap; past the pool, misaligned (a res-1
    # window on 64 lanes) or another resolution
    for bad_ptr, bad_res in ((-512, 0), (4 * 512, 0), (100, 0),
                             (4 * 512 - 32, 1), (0, 2)):
        p, r = ptr.clone(), res.clone()
        p[1], r[1] = bad_ptr, bad_res
        with pytest.raises(ValueError, match="outside"):
            FIP.fused_integrate_points_rows(pool, img, pix, r_vox, p, r,
                                            CONSTS)
    for bad_pix in (-2, ROWS * COLS):
        x = pix.clone()
        x[1, 7] = bad_pix
        with pytest.raises(ValueError, match="outside"):
            FIP.fused_integrate_points_rows(pool, img, x, r_vox, ptr, res,
                                            CONSTS)


def test_wrapper_rejects_misaligned_operands():
    """K3 moves 2 voxels per 8-byte access of pix, r_vox and the pool
    fields: an operand that does not start on 8 bytes is refused before
    any launch."""
    from mrhash_tpu_torch.core.state import VoxelPool
    pool = make_state(4).pool
    img = torch.ones((ROWS, COLS))
    pix = torch.zeros((2, 512), dtype=torch.int32)
    r_vox = torch.ones((2, 512))
    ptr = torch.tensor([0, 512], dtype=torch.int32)
    res = torch.zeros(2, dtype=torch.int32)

    def shifted(t):
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out
    with pytest.raises(ValueError, match="pix: not 8-byte aligned"):
        FIP.fused_integrate_points_rows(pool, img, shifted(pix), r_vox, ptr,
                                        res, CONSTS)
    with pytest.raises(ValueError, match="r_vox: not 8-byte aligned"):
        FIP.fused_integrate_points_rows(pool, img, pix, shifted(r_vox), ptr,
                                        res, CONSTS)
    for f in ("sdf", "sumsq", "weight"):
        bad = VoxelPool(**{g: shifted(getattr(pool, g)) if g == f
                           else getattr(pool, g) for g in VoxelPool.FIELDS})
        with pytest.raises(ValueError, match=f"pool.{f}: not 8-byte"):
            FIP.fused_integrate_points_rows(bad, img, pix, r_vox, ptr, res,
                                            CONSTS)
    flags = FIP.fused_integrate_points_rows(pool, img, pix, r_vox, ptr, res,
                                            CONSTS)
    assert flags.shape == (2, 4)


# ---------------------------------------------------------------------------
# (c) + (d) the fused step and the whole slice
# ---------------------------------------------------------------------------

def test_fused_points_matches_reference_from_carried_state(ref):
    _, states, _ = ref
    t, pts = _frames()[2]
    cfg = MapConfig(**CFG)
    state = convert.from_reference(states[1])
    cam = _port_cam(t)
    points = torch.from_numpy(pts)
    keys, valid = AB.alloc_candidates_points(cfg, cam, points,
                                            cfg.dda_steps(MAX_D))
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    _, bpos, bptr, bres = I.compact_active(cfg, state.table)
    aux = I.fused_integrate_points(cfg, state.pool, cam, points, bpos, bptr,
                                   bres)
    assert aux["unserved_blocks"] == 0
    g, r = _rows_by_key(state, states[2])
    flips, d = _assert_close_maps(g, r)
    n_pix = _pixel_mismatches(bpos.numpy(), pts, t)
    print(f"(c) {g['weight'].size} lanes: {flips} weight flips, max sdf "
          f"difference {d:.3g}, {n_pix} lanes on another pixel")
    assert n_pix <= max(16, int(g["weight"].size * 1e-4))


def test_slice_matches_reference(ref):
    _, states, stats = ref
    gw = GeoWrapper(0.40, 0.0, 1, 0.20, 0, 1, min_depth=0.2, max_depth=MAX_D,
                    num_blocks=CFG["num_blocks"],
                    num_buckets=CFG["num_buckets"],
                    max_active_blocks=CFG["max_active_blocks"],
                    max_alloc_per_frame=CFG["max_alloc_per_frame"],
                    profiling=False, device="cpu")
    gw.setCamera(*CAM, camera_model=C.SPHERICAL)
    n_pix = 0
    for i, (t, pts) in enumerate(_frames()):
        gw.setCurrPose(t, [0.0, 0.0, 0.0, 1.0])
        gw.setPointCloud(pts, i == 0)   # frame 1 also runs the MADtree
        gw.compute()
        for k in ("occupied_blocks", "occupied_total", "high_free", "frame",
                  "unserved_blocks"):
            assert gw.last_stats[k] == stats[i][k], (i, k)
        occ = gw.state.table.ptr.numpy() != P.FREE_ENTRY
        n_pix += _pixel_mismatches(gw.state.table.pos.numpy()[occ], pts, t)
    assert gw._normals is not None and gw._normals.shape == (ROWS * COLS, 3)
    g, r = _rows_by_key(gw.state, states[-1])
    flips, d = _assert_close_maps(g, r)
    print(f"(d) {g['weight'].size} lanes: {flips} weight flips, max sdf "
          f"difference {d:.3g}; {n_pix} lanes on another pixel over "
          f"{N_FRAMES} frames")
    assert n_pix <= max(16, int(g["weight"].size * 1e-4))


def _ref_starved(projective):
    """Reference states and stats after each scan with starvation and GC
    every 2 scans, op by op: the fused spherical kernel in interpret mode,
    or (projective=False) the point-centric update over _normals with a
    lookup scratch of 2^22 cells, where it drops nothing (P56)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import make_state as jmake_state

    kw = (dict(sample_mode="fused", pallas_interpret=True) if projective
          else dict(projective_sdf=False, lookup_dedup_scratch=1 << 22))
    jcfg = JMapConfig(**dict(CFG, n_frames_invalidate_voxels=2, **kw))
    n = ROWS * COLS
    state = jmake_state(jcfg.num_blocks, jcfg.num_buckets)
    states, stats = [], []
    with jax.disable_jit():
        for i, (t, pts) in enumerate(_frames()):
            state, st = JP.integrate_points(
                jcfg, state, _jcam(t), jnp.asarray(pts),
                jnp.asarray(_normals(i)), jnp.ones((n,)),
                jnp.ones((n,), bool))
            states.append(jax.device_get(state))
            stats.append({k: int(v) for k, v in st.items()})
    return states, stats


def test_unported_lidar_options_raise():
    """The LiDAR options that raised until the point-centric update was
    ported (projective_sdf=False, and n_frames_invalidate_voxels > 0
    under the spherical model) now run: three scans through
    GeoWrapper(device="cpu") with starvation and GC every 2 scans (scan 2
    starves), on the point-centric and on the projective update, against
    the reference's pipeline.integrate_points.  The stats are the
    reference's after every scan; the maps by block key: weights equal,
    sdf within 2e-5 and sumsq within 5e-4 (point-centric: index_add_'s
    summation order), or the fused bounds of _assert_close_maps
    (projective, P15)."""
    for projective in (False, True):
        states, stats = _ref_starved(projective)
        gw = GeoWrapper(0.40, 0.0, 1, 0.20, 2, 1, min_depth=0.2,
                        max_depth=MAX_D, num_blocks=CFG["num_blocks"],
                        num_buckets=CFG["num_buckets"],
                        max_active_blocks=CFG["max_active_blocks"],
                        max_alloc_per_frame=CFG["max_alloc_per_frame"],
                        projective_sdf=projective, profiling=False,
                        device="cpu")
        gw.setCamera(*CAM, camera_model=C.SPHERICAL)
        freed = 0
        for i, (t, pts) in enumerate(_frames()):
            gw.setCurrPose(t, [0.0, 0.0, 0.0, 1.0])
            gw.setPointCloud(pts, _normals(i))
            np.testing.assert_array_equal(gw.getNormals(), _normals(i))
            gw.compute()
            for k in ("occupied_blocks", "occupied_total", "high_free",
                      "frame", "unserved_blocks"):
                assert gw.last_stats[k] == stats[i][k], (projective, i, k)
            freed += gw.last_stats["gc_freed"]
        assert freed > 0, "GC freed nothing"
        g, r = _rows_by_key(gw.state, states[-1])
        if projective:
            flips, d = _assert_close_maps(g, r)
            print(f"projective: {flips} weight flips, max sdf difference "
                  f"{d:.3g}; GC freed {freed}")
            continue
        np.testing.assert_array_equal(g["weight"], r["weight"])
        w = r["weight"] > 0
        assert int(w.sum()) > 5000
        assert float(np.abs(g["sdf"] - r["sdf"])[w].max()) <= 2e-5
        assert float(np.abs(g["sumsq"] - r["sumsq"])[w].max()) <= 5e-4
        print(f"point-centric: {int(w.sum())} weighted lanes, equal "
              f"weights; GC freed {freed}")


# ---------------------------------------------------------------------------
# (e) on the card: kernel vs twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_twin_on_card(cuda):
    cfg = MapConfig(**CFG)
    pools = [make_state(cfg.num_blocks, cfg.num_buckets, cuda).pool
             for _ in range(2)]
    st = make_state(cfg.num_blocks, cfg.num_buckets, cuda)
    n0 = COUNTS["fused_integrate_points_rows"]
    for t, pts in _frames():
        cam = _port_cam(t, cuda)
        points = torch.from_numpy(pts).to(cuda)
        keys, valid = AB.alloc_candidates_points(cfg, cam, points,
                                                cfg.dda_steps(MAX_D))
        I.alloc_blocks(cfg, st.table, keys, valid, st.frame)
        st.frame += 1
        _, bpos, bptr, bres = I.compact_active(cfg, st.table)
        operands = I.points_window(cfg, cam, points, bpos, bptr, bres)
        assert operands[-1] == CONSTS
        fk = FIP.fused_integrate_points_rows(pools[0], *operands)
        ft = FIP.fused_integrate_points_rows_ref(pools[1], *operands)
    torch.cuda.synchronize()
    assert COUNTS["fused_integrate_points_rows"] == n0 + N_FRAMES
    for f in ("sdf", "sumsq", "weight"):
        assert torch.equal(getattr(pools[0], f), getattr(pools[1], f)), f
    assert int((pools[0].weight > 0).sum()) > 20000
    assert torch.equal(fk[:, :3], ft[:, :3])
    # the sumsq flag is a 512-term sum taken in another order
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
