"""The rest of the port's LiDAR path against the JAX reference, op by op:
the point-centric update (projective_sdf=False), starvation and GC under
the spherical model.

Scene: tests/test_torch_lidar.py's 16x128 scan of a ground plane and a
12 m cylinder wall (0.2 m voxels, 2^12 blocks), made with numpy from a
seed, with the MADtree normals of tests/test_torch_lidar.py::_normals (one
of them zero: that point walks a degenerate segment, as in the
reference).  The maps the cases start from are the port's, after scans 0
and 1 (or 0-2), carried to the reference with core/convert.py, so both
packages run each step from the same state.  The reference runs op by op
(jax.disable_jit: jit contracts `voxel * vvs - t` into an FMA,
PORT_NOTES.md P4), with a lookup scratch of 2^22 cells where it must drop
nothing (its default 2^15 drops the keys that share a salted cell, D15;
the port drops none, P56).

(a)-(e) run in order as one test (see its docstring):

- (a) the voxel-level walk (dda_visit, block_level=False) and the
  normal-direction allocation keys equal the reference's exactly;
- (b) lookup_dedup: every distinct walk key in a window block is found;
  at 2^22 cells the reference drops nothing and the results are equal; at
  its default 2^15 cells its misses are the keys that share a cell with
  another distinct key (all but one per cell);
- (c) integrate_points_sdf from a carried state, projective, point-to-
  plane and multi-res point-to-plane: weights equal, sdf within 2e-5 and
  sumsq within 5e-4 (index_add_'s summation order);
- (d) the spherical starve mask against the reference's starve_mask: its
  fused mode (the z-buffer read back through B5 in interpret mode, whose
  patches leave some lanes of near blocks unserved, P57) starves a subset
  of the port's lanes, at most max(16, 1e-4 x lanes) fewer, and its gather
  mode differs only on lanes that XLA's and torch's atan2/asin put on
  another pixel, as many as P15 allows;
- (e) the GC decision read from the pool equals the reference's flagless
  garbage_collect_sweep: the same blocks freed;
- (f) three scans through GeoWrapper against the reference's
  pipeline.integrate_points, both updates with starvation: in
  tests/test_torch_lidar.py::test_unported_lidar_options_raise;
- (g) on the card: the point-centric slice against the CPU's, and K2
  against its twin on the spherical z-buffer.
"""
import copy
import functools

import numpy as np
import pytest
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import pipeline
from mrhash_tpu_torch.core.state import MapConfig, make_state
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.utils.profiler import COUNTS
from test_torch_lidar import (CFG, COLS, MAX_D, ROWS, _frames, _jcam,
                              _normals, _port_cam, _rows_by_key)
from test_torch_streaming import _reference_state

torch.set_num_threads(1)

BIG_SCRATCH = 1 << 22
MR = dict(sdf_var_threshold=10.0)   # tests/test_torch_multires.py's LiDAR


def _cfg(**kw):
    return MapConfig(**dict(CFG, **kw))


def _jcfg(**kw):
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    return JMapConfig(**dict(CFG, **kw))


@functools.lru_cache(maxsize=None)
def _port_states(multires=False):
    """The port's maps after scans 0, 1 and 2 of the point-centric slice
    (point-to-plane; starvation and GC every 2 scans, or multi-res at
    sdf_var_threshold 10 without GC), as copies."""
    cfg = (_cfg(projective_sdf=False, **MR) if multires else
           _cfg(projective_sdf=False, n_frames_invalidate_voxels=2))
    st = make_state(cfg.num_blocks, cfg.num_buckets)
    out = []
    for i, (t, pts) in enumerate(_frames()):
        st, _ = pipeline.integrate_points(cfg, st, _port_cam(t),
                                          torch.from_numpy(pts),
                                          torch.from_numpy(_normals(i)))
        out.append(copy.deepcopy(st))
    return out


def _band(cfg, pts, nrm, t):
    """The world endpoints of the point-to-plane walk (integrate3D's
    band along the normal) and the ray validity, in the port."""
    points = torch.from_numpy(pts)
    cam = _port_cam(t)
    n_dir, rng = X.unit(torch.from_numpy(nrm))[0], X.unit(points)[1]
    trunc = X.get_truncation(rng, cfg.sdf_truncation, 0.0)
    d_min = torch.clamp(rng - trunc, max=MAX_D)
    d_max = torch.clamp(rng + trunc, max=MAX_D)
    ok = (rng >= 1e-6) & (rng <= MAX_D) & (d_min < d_max)
    return (C.cam_to_world(cam, points + n_dir * (d_min - rng)[:, None]),
            C.cam_to_world(cam, points + n_dir * (d_max - rng)[:, None]), ok)


def _walk_keys(cfg, i):
    """Scan i's voxel walk (point-to-plane) as block keys + visit mask."""
    t, pts = _frames()[i]
    pw_min, pw_max, ok = _band(cfg, pts, _normals(i), t)
    vox, visit = AB.dda_visit(cfg, pw_min, pw_max, ok,
                              cfg.dda_voxel_steps(MAX_D), block_level=False)
    blk = X.virtual_voxel_pos_to_sdf_block(vox, cfg.virtual_voxel_size,
                                           cfg.voxel_extents)
    return blk.reshape(-1, 3), visit.reshape(-1)


# ---------------------------------------------------------------------------
# (a) the walks
# ---------------------------------------------------------------------------

def _check_walks():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import integrate as JI

    cfg, jcfg = _cfg(projective_sdf=False), _jcfg(projective_sdf=False)
    steps = cfg.dda_voxel_steps(MAX_D)
    assert steps == 10       # newer_college.cfg's band at 0.2 m voxels
    t, pts = _frames()[2]
    nrm = _normals(2)
    pw_min, pw_max, ok = _band(cfg, pts, nrm, t)
    vox, visit = AB.dda_visit(cfg, pw_min, pw_max, ok, steps,
                              block_level=False)
    pts0 = pts.copy()
    pts0[5] = 0.0             # no return: allocates nothing
    keys, valid = AB.alloc_candidates_points(
        cfg, _port_cam(t), torch.from_numpy(pts0), cfg.dda_steps(MAX_D),
        torch.from_numpy(nrm))
    with jax.disable_jit():
        jvox, jvisit = JI._dda_visit(
            jcfg, _jcam(t), jnp.asarray(pw_min.numpy()),
            jnp.asarray(pw_max.numpy()), jnp.asarray(ok.numpy()), steps,
            block_level=False)
        jk, jv = JI.alloc_candidates_points(
            jcfg, _jcam(t), jnp.asarray(pts0), jnp.asarray(nrm),
            jnp.ones((pts.shape[0],), bool), cfg.dda_steps(MAX_D))
    np.testing.assert_array_equal(visit.numpy(), np.asarray(jvisit))
    m = visit.numpy()
    assert int(m.sum()) > 10000
    np.testing.assert_array_equal(vox.numpy()[m], np.asarray(jvox)[m])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    v = valid.numpy()
    np.testing.assert_array_equal(keys.numpy()[v], np.asarray(jk)[v])
    assert len({tuple(k) for k in keys.numpy()[v]}) > 300


# ---------------------------------------------------------------------------
# (b) the lookup of the walk's keys
# ---------------------------------------------------------------------------

def _check_lookup():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import hashtable as JH

    cfg = _cfg(projective_sdf=False)
    state = _port_states()[2]
    slots, _, _, _ = I.compact_active(cfg, state.table)
    A, cap = slots.shape[0], state.table.capacity
    slot_map = torch.full((cap,), -1, dtype=torch.int64)
    slot_map[slots] = torch.arange(A)
    keys, visit = _walk_keys(cfg, 2)
    found, wslot, lane0, res, n_distinct = H.lookup_dedup(
        state.table, keys, visit, slot_map)
    found, wslot = found.numpy(), wslot.numpy()

    # exact: a visited key is found iff a window block holds it
    k, m = keys.numpy(), visit.numpy()
    win = {tuple(p): a for a, p in enumerate(state.table.pos[slots].numpy())}
    want = np.array([bool(v) and tuple(q) in win for q, v in zip(k, m)])
    np.testing.assert_array_equal(found, want)
    assert all(wslot[j] == win[tuple(k[j])] for j in np.flatnonzero(found))
    assert n_distinct == len({tuple(q) for q in k[m]})
    assert int(found.sum()) > 5000

    jslot_map = jnp.full((cap + 1,), -1, jnp.int32).at[
        jnp.asarray(slots.numpy())].set(jnp.arange(A, dtype=jnp.int32))
    jtable = _reference_state(state).table
    out = {}
    with jax.disable_jit():
        for size in (BIG_SCRATCH, _jcfg().lookup_dedup_scratch):
            out[size] = [np.asarray(x) for x in JH.lookup_dedup(
                jtable, jnp.asarray(k), jnp.asarray(m), size,
                frame_salt=jnp.int32(2), slot_map=jslot_map)]
    # 2^22 cells: the reference drops nothing, and the results are equal
    jf, jw, jl, jr = out[BIG_SCRATCH]
    np.testing.assert_array_equal(jf, found)
    np.testing.assert_array_equal(jw[found], wslot[found])
    np.testing.assert_array_equal(jl[found], lane0.numpy()[found])
    np.testing.assert_array_equal(jr[found], res.numpy()[found])

    # 2^15 cells (the default): the reference misses exactly the keys of
    # cells shared by distinct keys, all but at most one per cell (P56)
    size = _jcfg().lookup_dedup_scratch
    jf = out[size][0]
    assert not (jf & ~found).any()
    fp = JH.fingerprint(jnp.asarray(k)).astype(jnp.uint32)
    cell = np.asarray((JH._avalanche(fp + jnp.uint32(2) * jnp.uint32(
        2654435761)) % jnp.uint32(size)).astype(jnp.int32))
    cell_keys = {}
    for q, c, v in zip(map(tuple, k), cell, m):
        if v:
            cell_keys.setdefault(int(c), set()).add(q)
    shared = {c for c, ks in cell_keys.items() if len(ks) > 1}
    missed = found & ~jf
    assert all(cell[j] in shared for j in np.flatnonzero(missed))
    for c in shared:
        got = {tuple(k[j]) for j in np.flatnonzero(jf & (cell == c))}
        held = {q for q in cell_keys[c] if q in win}
        assert len(got) <= 1 and got <= held
        assert {tuple(k[j]) for j in np.flatnonzero(missed & (cell == c))} \
            == held - got
    print(f"(b) {n_distinct} distinct keys, {len(shared)} shared cells at "
          f"2^15, {int(missed.sum())} visits the reference misses there")
    assert shared and missed.any(), "no collision exercised"


# ---------------------------------------------------------------------------
# (c) the point-centric update from a carried state
# ---------------------------------------------------------------------------

def _maps_close(g, r):
    """Weights equal; sdf within 2e-5 and sumsq within 5e-4 (summation
    order).  Returns the weighted lanes."""
    np.testing.assert_array_equal(g["weight"], r["weight"])
    w = r["weight"] > 0
    assert float(np.abs(g["sdf"] - r["sdf"])[w].max()) <= 2e-5
    assert float(np.abs(g["sumsq"] - r["sumsq"])[w].max()) <= 5e-4
    return int(w.sum())


def _check_integrate(variant):
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import integrate as JI

    proj = variant == "projective"
    mr = MR if variant == "multires" else {}
    carried = _port_states(bool(mr))[1]      # the map after scan 1
    cfg = _cfg(projective_sdf=proj, **mr)
    jcfg = _jcfg(projective_sdf=proj, lookup_dedup_scratch=BIG_SCRATCH, **mr)
    t, pts = _frames()[2]
    nrm = _normals(2)
    n = pts.shape[0]

    state = copy.deepcopy(carried)
    cam, points = _port_cam(t), torch.from_numpy(pts)
    keys, valid = AB.alloc_candidates_points(
        cfg, cam, points, cfg.dda_steps(MAX_D), torch.from_numpy(nrm))
    I.alloc_blocks(cfg, state.table, keys, valid, state.frame)
    window = I.compact_active(cfg, state.table)
    n1 = int(window[3].sum())
    if mr:
        assert n1 > 10, "no res-1 block in the window"
    w = I.integrate_points_sdf(cfg, state.table, state.pool, cam, points,
                               torch.from_numpy(nrm), None,
                               cfg.dda_voxel_steps(MAX_D), window)

    jcam = _jcam(t)
    args = (jnp.asarray(pts), jnp.asarray(nrm), jnp.ones((n,)),
            jnp.ones((n,), bool))
    with jax.disable_jit():
        jstate = _reference_state(carried)
        jk, jv = JI.alloc_candidates_points(jcfg, jcam, args[0], args[1],
                                            args[3], cfg.dda_steps(MAX_D))
        table = JI.alloc_blocks(jcfg, jstate.table, jk, jv, jnp.int32(2))
        slots, _, bpos, bptr, bres, bvalid = JI.compact_active(jcfg, table)
        pool = JI.integrate_points_sdf(
            jcfg, table, jstate.pool, jcam, *args,
            cfg.dda_voxel_steps(MAX_D), frame=jnp.int32(2),
            window=(slots, bpos, bptr, bres, bvalid))
    ref = jax.device_get(jstate.replace(table=table, pool=pool))
    g, r = _rows_by_key(state, ref)
    lanes = _maps_close(g, r)
    print(f"(c) {variant}: {w['visited']} visits, {w['distinct']} distinct "
          f"blocks, window {window[0].shape[0]} ({n1} at res 1), {lanes} "
          f"weighted lanes")
    assert lanes > 5000


# ---------------------------------------------------------------------------
# (d) starvation under the spherical model
# ---------------------------------------------------------------------------

def _check_spherical_starve():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import coords as JX
    from mrhash_tpu.ops import integrate as JI

    t, _ = _frames()[2]
    cfg = _cfg()
    st = _port_states()[2]
    _, bpos, bptr, bres = I.compact_active(cfg, st.table)
    A = bpos.shape[0]
    starved = I.starve_mask(cfg, _port_cam(t), bpos, bres).numpy()

    jcam = _jcam(t)
    jb = [jnp.asarray(x.numpy()) for x in (bpos, bptr, bres)]
    want = {}
    with jax.disable_jit():
        for mode in ("fused", "gather"):
            want[mode] = np.asarray(JI.starve_mask(
                _jcfg(sample_mode=mode, pallas_interpret=True), jcam, *jb,
                jnp.ones((A,), bool)))
        pi, valid = JI._block_voxel_grid(jb[0], jb[2])
        pc = JC.world_to_cam(jcam, JX.virtual_voxel_pos_to_world(0.20, pi))
        jrow, jcol, jok = JC.project_point(jcam, pc)
    pi_p, _ = X.block_voxel_grid(bpos, bres)
    row, col, ok = C.project_point(_port_cam(t), C.world_to_cam(
        _port_cam(t), X.virtual_voxel_pos_to_world(0.20, pi_p)))
    v = np.asarray(valid)
    moved = int((((row.numpy() != np.asarray(jrow))
                  | (col.numpy() != np.asarray(jcol))
                  | (ok.numpy() != np.asarray(jok))) & v).sum())
    # the reference's fused sampler (B5's patches and element fallback)
    # leaves some lanes of near blocks unserved, and those never starve;
    # the port reads every lane, as the reference's gather mode (P57)
    unserved = int((want["fused"] & ~starved).sum())
    extra = int((starved & ~want["fused"]).sum())
    bound = max(16, int(A * 512 * 1e-4))
    print(f"(d) window {A} blocks: {int(want['fused'].sum())} lanes starve "
          f"in the reference, {extra} more in the port (unserved there), "
          f"{int((starved != want['gather']).sum())} differ from its gather "
          f"mode, {moved} lanes on another pixel")
    assert int(want["fused"].sum()) > 1000
    assert unserved == 0 and extra <= bound, (unserved, extra, bound)
    assert moved <= bound, (moved, bound)
    assert int((starved != want["gather"]).sum()) <= moved


# ---------------------------------------------------------------------------
# (e) the GC decision read from the pool
# ---------------------------------------------------------------------------

def _check_gc_decide():
    import jax
    from mrhash_tpu.ops import integrate as JI

    t, _ = _frames()[2]
    cfg = _cfg(n_frames_invalidate_voxels=2)
    st = copy.deepcopy(_port_states()[2])
    slots, bpos, bptr, bres = I.compact_active(cfg, st.table)
    # blocks 0-4 lose every weight, blocks 5-9 lie beyond the band; the
    # reference starts from this map
    rows = (bptr[:10].long() // 512).tolist()
    st.pool.weight[rows[:5]] = 0
    st.pool.sdf[rows[5:]] = 0.5
    jstate = _reference_state(st)
    decision = I.gc_decide(cfg, _port_cam(t), st.pool, bptr, bres)
    assert bool(decision[:10].all())
    I.garbage_collect_sweep(cfg, st.table, st.pool, slots, decision)

    jcfg = _jcfg(n_frames_invalidate_voxels=2)
    with jax.disable_jit():
        js_, _, jp, jpt, jr, jv = JI.compact_active(jcfg, jstate.table)
        table, pool = JI.garbage_collect_sweep(
            jcfg, jstate.table, jstate.pool, _jcam(t), js_, jp, jpt, jr, jv)
    ref = jax.device_get(jstate.replace(table=table, pool=pool))
    g, r = _rows_by_key(st, ref)
    np.testing.assert_array_equal(g["weight"], r["weight"])
    np.testing.assert_array_equal(g["sdf"], r["sdf"])
    print(f"(e) {int(decision.sum())} of {slots.shape[0]} blocks freed")


# ---------------------------------------------------------------------------
# (a)-(e) as one test
# ---------------------------------------------------------------------------

def test_point_centric_path_matches_reference():
    """(a)-(e), in order.  They run as one test: a file of two tests sorts
    at the tail of pytest-xdist's loadfile queue (files go out by test
    count), so this file's minute of reference compiles runs after every
    file has been handed out.  A longer queue lets the worker of
    tests/test_integrate.py take one more file before its last test
    crashes (ROADMAP C1), and xdist 3.8 then waits for that file for
    good."""
    pytest.importorskip("jax")
    _check_walks()
    _check_lookup()
    for variant in ("projective", "plane", "multires"):
        _check_integrate(variant)
    _check_spherical_starve()
    _check_gc_decide()


# ---------------------------------------------------------------------------
# (g) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_point_centric_slice_and_k2_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cuda = torch.device("cuda")
    cfg = _cfg(projective_sdf=False, n_frames_invalidate_voxels=2)
    maps = {}
    for dev in ("cpu", cuda):
        st = make_state(cfg.num_blocks, cfg.num_buckets, dev)
        for i, (t, pts) in enumerate(_frames()):
            st, stats = pipeline.integrate_points(
                cfg, st, _port_cam(t, dev), torch.from_numpy(pts).to(dev),
                torch.from_numpy(_normals(i)).to(dev))
        occ = (st.table.ptr != P.FREE_ENTRY).cpu().numpy()
        pos = st.table.pos.cpu().numpy()[occ]
        order = np.lexsort(pos.T)
        rows = st.table.ptr.cpu().numpy()[occ][order] // 512
        maps[str(dev)] = (pos[order], {f: getattr(st.pool, f).cpu().numpy()[
            rows] for f in ("sdf", "sumsq", "weight")}, stats, st)
    (pc, mc, sc, _), (pg, mg, sg, st) = maps["cpu"], maps["cuda"]
    np.testing.assert_array_equal(pc, pg)
    # host_syncs and coarsen_syncs count the sync sites of each device's
    # own path: the card's allocation runs kernels K7-K9 with one host read
    # a round, its coarsening K10-K12 with two
    syncs = ("host_syncs", "coarsen_syncs")
    assert {k: v for k, v in sc.items() if k not in syncs} == {
        k: v for k, v in sg.items() if k not in syncs}
    # the starve scan's atan2/asin may move a voxel to another pixel
    flips = int((mc["weight"] != mg["weight"]).sum())
    assert flips <= max(16, int(mc["weight"].size * 1e-4)), flips
    agree = (mc["weight"] == mg["weight"]) & (mc["weight"] > 0)
    assert float(np.abs(mc["sdf"] - mg["sdf"])[agree].max()) <= 2e-5

    # K2 on the spherical z-buffer of the card's last window
    t, _ = _frames()[2]
    cam = _port_cam(t, cuda)
    _, bpos, bptr, bres = I.compact_active(cfg, st.table)
    pi, valid = X.block_voxel_grid(bpos, bres)
    pcam = C.world_to_cam(cam, X.virtual_voxel_pos_to_world(0.20, pi))
    row, col, ok = C.project_point(cam, pcam)
    z = C.get_depth(cam, pcam)
    ok = (ok & valid & (z >= cam.min_depth)).contiguous()
    HW = ROWS * COLS
    zbuf = torch.full((HW + 1,), I.FAR, device=cuda)
    zbuf.scatter_reduce_(0, torch.where(ok, row.long() * COLS + col,
                                        HW).reshape(-1),
                         torch.where(ok, z, I.FAR).reshape(-1), "amin")
    zimg = torch.zeros((2, ROWS, COLS), device=cuda)
    zimg[0] = zbuf[:HW].reshape(ROWS, COLS)
    n0 = COUNTS["sample_image"]
    sk = SI.sample_image(zimg, row.contiguous(), col.contiguous(), ok)
    st_ = SI.sample_image_ref(zimg, row.contiguous(), col.contiguous(), ok)
    assert COUNTS["sample_image"] == n0 + 1
    assert torch.equal(sk, st_)
    assert int((ok & (z == sk[:, 0, :])).sum()) > 1000
