"""TSDF allocation, integration, variance-adaptive coarsening decisions,
starvation and garbage collection for the RGB-D and LiDAR paths.

Port of mrhash_tpu/ops/integrate.py (non-resident).  Torch is eager, so
the compacted block window is exactly as long as the number of in-frustum
blocks: window tensors carry no validity mask and no padding, and the pool
is updated in place.  A window is (slots i64[A], bpos i32[A,3], bptr
i32[A], bres i32[A]).  A res-0 block owns the pool row bptr // 512; a
res-1 block owns the 64-lane window [bptr, bptr + 64) of a row that up to
8 siblings share.  Per-voxel tensors are in WINDOW layout: lane v of an
entry is its voxel v at flat pool index bptr + v (core/state.window_voxels;
a res-1 entry uses lanes 0..63).  Every write goes to the entry's own
window, never to a whole row that siblings share.

The kernels sit below this module, each kernel module holding its
kernels, their plain twins and the choice between them: allocation's
walk, dedup and insert in ops/alloc_blocks.py, coarsening in
ops/coarsen_blocks.py, K1, K2 and K3 in ops/fused_integrate.py,
ops/sample_image.py and ops/fused_integrate_points.py, the LiDAR scan's
raster and projection (K13, K14) in ops/scan_raster.py.  Nothing here asks
which device it runs on.
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import (LANES, MapConfig, VoxelPool,
                                         clear_blocks, pack_rgb, put_windows,
                                         unpack_rgb, window_voxels)
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import fused_integrate as FI
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.ops import scan_raster as SR
from mrhash_tpu_torch.utils.profiler import host_int, nonzero, pick, stage

INF = float("inf")


# ---------------------------------------------------------------------------
# frustum culling
# ---------------------------------------------------------------------------

def blocks_in_frustum_approx(cam: C.Camera, block_pos, vvs):
    """isSDFBlockInCameraFrustumApprox (voxel_data_structures.cu:66-78),
    as the reference's default: the block centre against the +-50%-padded
    frustum with the depth range widened by the block diagonal."""
    base = X.sdf_block_to_virtual_voxel_pos(block_pos)
    center = X.virtual_voxel_pos_to_world(vvs, base) + 3.5 * vvs
    diag = P.SDF_BLOCK_SIZE * vvs * 1.8
    pc = C.world_to_cam(cam, center)
    row, col, _ = C.project_point_approx(cam, pc)
    depth = C.get_depth(cam, pc)
    depth_ok = ((depth > cam.min_depth - diag)
                & (depth <= cam.max_depth + diag))
    rt = int(cam.rows * 0.5)
    ct = int(cam.cols * 0.5)
    inside = ((row >= -rt) & (col >= -ct)
              & (row < cam.rows + rt) & (col < cam.cols + ct))
    return depth_ok & inside


def sensor_reach(cfg: MapConfig) -> float:
    """max_integration_distance plus the truncation there (metres): on a
    projective LiDAR scan no voxel farther from the sensor changes
    (blocks_within)."""
    m = float(cfg.max_integration_distance)
    return m + X.get_truncation(m, cfg.sdf_truncation,
                                cfg.sdf_truncation_scale)


def blocks_within(cfg: MapConfig, cam: C.Camera, block_pos, reach: float):
    """bool[...]: the blocks whose nearest point lies within `reach`
    metres of the sensor (cam's position), a block being the cube
    [corner, corner + 8 voxels).

    On K3's projective update a voxel changes only where its pixel is
    valid, which needs its range within [min_depth, max_depth], and only
    where the return there lies in (0, max_integration_distance] with
    return - range > -truncation; so no voxel beyond
    max_integration_distance + truncation (sensor_reach) changes, and the
    truncation's margin holds the float32 rounding of the range.  K3's
    flags read an entry's own voxels alone, so a block beyond reach
    decides as it did when last inside.

    In block units, per axis: the block's offset from the sensor's block
    is exact in float32 and the sensor's place in its block is taken off
    once, so the test errs by under 1e-4 block near reach; the bound is
    widened by 1e-3 block, which admits no block whose voxels can
    change.  A few launches over the table's slots: the host issues every
    one on each scan."""
    side = P.SDF_BLOCK_SIZE * cfg.virtual_voxel_size
    o = cam.trans.to(torch.float64) / side
    base = torch.floor(o)
    off = (o - base - 0.5).to(torch.float32)    # sensor - its block's centre
    centre = torch.sub(block_pos, base.to(torch.float32)).sub_(off)
    # per axis |centre - sensor| less half a block, at least 0 (its sign
    # kept)
    d = torch.nn.functional.softshrink(centre, 0.5)
    return torch.linalg.vector_norm(d, dim=-1) <= reach / side + 1e-3


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def alloc_blocks(cfg: MapConfig, table: H.HashTable, keys, valid,
                 frame: int, scratch: AB.DedupScratch | None = None):
    """allocBlocks (voxel_data_structures.cu:873-922): the salted dedup of
    the candidates, then the insert of the served keys, updating `table`
    in place.  `scratch`, given, is the frame's scratch that the
    candidates' walk already filled (alloc_blocks.alloc_candidates_*(...,
    scratch=)).  Returns host ints (submitted, inserted): the deduped keys
    handed to insert, and the blocks drawn from the heaps for them.
    ops/alloc_blocks.py picks the kernels (K7's scatter where the walk did
    not do it, K8 and K9 with one host read) or their twins."""
    free0 = table.high_count + table.low_count
    with stage("alloc.dedup"):
        ukeys, stats = AB.dedup(cfg, keys, valid, frame, scratch)
    with stage("alloc.insert"):
        submitted = AB.insert(table, ukeys, 0, stats)["count"]
    return submitted, free0 - table.high_count - table.low_count


# ---------------------------------------------------------------------------
# compacted block window
# ---------------------------------------------------------------------------

def compact_active(cfg: MapConfig, table: H.HashTable, cam: C.Camera = None):
    """flatAndReduceHashTable (voxel_data_structures.cu:405-499): occupied
    slots (inside the padded frustum when `cam` is given), in slot order,
    capped at cfg.max_active_blocks.  Returns (slots i64[A], bpos, bptr,
    bres)."""
    return compact_window(cfg, table, cam)[0]


def compact_window(cfg: MapConfig, table: H.HashTable, cam: C.Camera = None,
                   reach: float = None, carried=None):
    """compact_active's window, and the occupied entries its cap left out
    (a host int from the compaction's one sync).  With `reach` (metres)
    the window holds, in place of the frustum, the blocks within it of
    cam's sensor (blocks_within) and those `carried` marks (bool[capacity]
    or None)."""
    inside = None
    if reach is not None:
        inside = blocks_within(cfg, cam, table.pos, reach)
        if carried is not None:
            inside |= carried
    elif cam is not None:
        inside = blocks_in_frustum_approx(cam, table.pos,
                                          cfg.virtual_voxel_size)
    every = H.compact(table, inside, table.capacity)
    k = int(cfg.max_active_blocks)
    slots = every[:k]
    window = (slots, table.pos[slots], table.ptr[slots], table.res[slots])
    return window, max(every.numel() - k, 0)


def _block_rows(bptr):
    """Pool row + intra-row window start of each block (ptr = row * 512 +
    lane0; lane0 is 0 for res 0 and a multiple of 64 for a res-1 carve)."""
    p = bptr.to(torch.int64)
    return p // LANES, p % LANES


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def integrate_depth(cfg: MapConfig, pool: VoxelPool, cam: C.Camera,
                    pc_depth, rgb_img, bpos, bptr, bres):
    """integrateDepthMapKernel (voxel_data_structures.cu:1094-1181), gather
    form, at both resolutions: project every voxel of every window block,
    sample depth and colour at its pixel with element gathers, fuse SDF +
    colour and accumulate the Welford sum_squared; each block's window
    updated in place.  The plain reference for the fused kernel
    (ops/fused_integrate.py)."""
    vvs = cfg.virtual_voxel_size
    pi, valid = X.block_voxel_grid(bpos, bres)
    pf = X.virtual_voxel_pos_to_world(vvs, pi)
    pcam = C.world_to_cam(cam, pf)
    row, col, ok = C.project_point(cam, pcam)

    W_ = pc_depth.shape[1]
    flat = torch.where(ok, row.to(torch.int64) * W_ + col, 0)
    depth = pc_depth.reshape(-1)[flat]
    rgb_new = unpack_rgb(pack_rgb(rgb_img).reshape(-1)[flat])

    depth_ok = ok & (depth != 0.0) & (depth <= cfg.max_integration_distance)
    sdf = depth - C.get_depth(cam, pcam)
    trunc = X.get_truncation(depth, cfg.sdf_truncation,
                             cfg.sdf_truncation_scale)
    inside = sdf > -trunc
    sdf = torch.clamp(sdf, min=-trunc, max=trunc)
    update = valid & depth_ok & inside

    vidx, _ = window_voxels(bptr, bres)
    sdf0, w0 = pool.sdf.view(-1)[vidx], pool.weight.view(-1)[vidx]
    ssq0, rgbp0 = pool.sumsq.view(-1)[vidx], pool.rgbp.view(-1)[vidx]
    rgb0 = unpack_rgb(rgbp0)

    # Welford accumulation (voxel_data_structures.cu:1162-1180); deltas are
    # normalized by half a voxel
    half_voxel = vvs / 2.0
    curr_mean = torch.where(w0 > 0, sdf0, sdf)
    delta = (sdf - curr_mean) / half_voxel
    rgb0_eff = torch.where((w0 == 0)[..., None], rgb_new, rgb0)
    w_new = torch.full_like(w0, cfg.integration_weight_sample)
    m_sdf, m_w, m_rgb = X.combine_voxel(
        sdf0, w0, rgb0_eff, sdf, w_new, rgb_new, cfg.integration_weight_max)
    delta2 = (sdf - m_sdf) / half_voxel
    m_ssq = ssq0 + delta * delta2
    for field, new, old in ((pool.sdf, m_sdf, sdf0), (pool.weight, m_w, w0),
                            (pool.sumsq, m_ssq, ssq0),
                            (pool.rgbp, pack_rgb(m_rgb), rgbp0)):
        put_windows(field, vidx, valid, torch.where(update, new, old))


def window_decisions(cfg: MapConfig, cam: C.Camera, flags, bres):
    """Per-entry decisions from a kernel's flags f32[A,4] (min |sdf| over
    weighted lanes, max weight, weight sum, sumsq sum, each over the
    entry's own window; the semantics of the reference's
    _window_flag_decisions).  Returns (gc_decision, coarsen_decide):
    garbageCollectIdentify frees an entry whose min |sdf| reaches the
    max-depth truncation or whose max weight is 0; checkVarSDFKernel
    (voxel_data_structures.cu:1856-1905) coarsens a res-0 entry whose
    average SDF variance is positive and below sdf_var_threshold."""
    trunc_max = X.get_truncation(cam.max_depth, cfg.sdf_truncation,
                                 cfg.sdf_truncation_scale)
    min_s, max_w, w_tot, ssq_tot = flags.unbind(1)
    gc = (min_s >= trunc_max) | (max_w == 0)
    avg_var = ssq_tot / torch.clamp(w_tot - 1.0, min=1e-12)
    co = ((bres == 0) & (w_tot >= 2) & (avg_var > 0.0)
          & (avg_var < cfg.sdf_var_threshold))
    return gc, co


def _aux(cfg, cam, flags, bres):
    gc, co = window_decisions(cfg, cam, flags, bres)
    return dict(gc_min_s=flags[:, 0], gc_max_w=flags[:, 1], gc_decision=gc,
                coarsen_decide=co, unserved_blocks=0)


def fused_integrate_depth(cfg: MapConfig, pool: VoxelPool, cam: C.Camera,
                          pc_depth, rgb_img, bpos, bptr, bres):
    """One-kernel depth integration over the window (non-resident, both
    resolutions): kernel K1 (ops/fused_integrate.py) projects, samples the
    frame at each voxel's own pixel, fuses and writes each entry's window
    in place.  Every in-image voxel is served, so there is no element
    fallback and unserved_blocks is 0 (PORT_NOTES.md P2).

    Returns aux dict(gc_min_s f32[A], gc_max_w f32[A], gc_decision bool[A],
    coarsen_decide bool[A], unserved_blocks=0): the flags of the windows
    after the update and the per-entry decisions (window_decisions)."""
    cam_vec = FI.make_cam_vec(
        cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
        cfg.sdf_truncation_scale, cfg.max_integration_distance,
        cfg.integration_weight_sample, cfg.integration_weight_max)
    flags = FI.fused_integrate_rows(
        pool, pc_depth.contiguous(), pack_rgb(rgb_img).contiguous(), cam_vec,
        bpos.contiguous(), bptr.contiguous(), bres.contiguous())
    return _aux(cfg, cam, flags, bres)


# ---------------------------------------------------------------------------
# LiDAR: scan raster, spherical projection, kernel K3
# ---------------------------------------------------------------------------

def points_window(cfg: MapConfig, cam: C.Camera, points, bpos, bptr, bres):
    """Kernel K3's operands for one scan over the window: rasterize the
    scan to a min-range image (K13) and project every window voxel to its
    pixel (K14), ops/scan_raster.py.  Returns (img f32[rows, cols], pix
    i32[A,512], r_vox f32[A,512], ptr i32[A], res i32[A], consts) as
    ops/fused_integrate_points.py takes them."""
    with stage("points.raster"):
        img, mapping = SR.raster_scan(cam, points.contiguous())
    with stage("points.projection"):
        pix, r_vox = SR.project_window(cfg, cam, bpos.contiguous(),
                                       bres.contiguous(), mapping)
    consts = (cfg.sdf_truncation, cfg.sdf_truncation_scale,
              cfg.max_integration_distance, cfg.integration_weight_sample,
              cfg.integration_weight_max, cfg.virtual_voxel_size)
    return (img, pix, r_vox, bptr.contiguous(), bres.contiguous(), consts)


def fused_integrate_points(cfg: MapConfig, pool: VoxelPool, cam: C.Camera,
                           points, bpos, bptr, bres):
    """One-kernel LiDAR integration over the window (projective, both
    resolutions): the operands of points_window, then kernel K3
    (ops/fused_integrate_points.py) applies the band-gated update in
    place (the reference's voxel-centric inversion, deviation D19).  Every
    in-image voxel reads its own pixel, so there is no element fallback and
    unserved_blocks is 0 (PORT_NOTES.md P14).

    Returns aux as fused_integrate_depth's: the flags of the windows after
    the update and the per-entry decisions."""
    operands = points_window(cfg, cam, points, bpos, bptr, bres)
    with stage("points.K3"):
        flags = FIP.fused_integrate_points_rows(pool, *operands)
    return _aux(cfg, cam, flags, bres)


# ---------------------------------------------------------------------------
# LiDAR: the point-centric update (integrate3DKernel)
# ---------------------------------------------------------------------------

def integrate_points_sdf(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                         cam: C.Camera, points, normals, weights,
                         num_steps: int, window):
    """integrate3DKernel (voxel_data_structures.cu:1214-1401), the
    reference's window path (mrhash_tpu/ops/integrate.py:1056-1188): each
    point walks the virtual-voxel grid through its truncation band, along
    the camera ray [r - t, r + t] (cfg.projective_sdf) or along the
    normal [d_min, d_max] (unit or zero normals f32[N,3]); every visited
    voxel of a window block gets the projective SDF r - |voxel| or the
    point-to-plane SDF (voxel - p) . n, taken at the voxel's corner at its
    block's resolution.  A walk stops at its first voxel of a window block
    with sdf <= -t (the reference's break); a voxel outside the window
    gets nothing.  The contributions of a voxel are summed (index_add_)
    and merged once, with the 3D kernel's quirk: a voxel never touched
    before has a running mean of 0 in the Welford term.  The pool is
    updated in place through each entry's own window.  points f32[N,3] in
    the camera frame; window = (slots, bpos, bptr, bres) from
    compact_active.  `weights` (setPointCloud's per-point weights) is
    accepted and unused, as in the reference (its adaptive weighting is
    commented out, voxel_data_structures.cu:1330-1338).

    Returns dict(visited=int, distinct=int): the walk's visited voxels
    and their distinct blocks."""
    dev = points.device
    vvs = cfg.virtual_voxel_size
    mdist = cfg.max_integration_distance
    cam_dir, rng = X.unit(points)
    norm_dir = X.unit(normals)[0]
    trunc = X.get_truncation(rng, cfg.sdf_truncation,
                             cfg.sdf_truncation_scale)
    d_min = torch.clamp(rng - trunc, max=mdist)
    d_max = torch.clamp(rng + trunc, max=mdist)
    ray_valid = (rng >= 1e-6) & (rng <= mdist) & (d_min < d_max)
    if cfg.projective_sdf:
        pc_min = points - cam_dir * trunc[..., None]
        pc_max = points + cam_dir * trunc[..., None]
    else:
        pc_min = points + norm_dir * (d_min - rng)[..., None]
        pc_max = points + norm_dir * (d_max - rng)[..., None]
    vox, visit = AB.dda_visit(cfg, C.cam_to_world(cam, pc_min),
                            C.cam_to_world(cam, pc_max), ray_valid,
                            num_steps, block_level=False)     # [K,N,3],[K,N]

    slots, _, bptr, bres = window
    A = slots.shape[0]
    blk = X.virtual_voxel_pos_to_sdf_block(
        vox, vvs, X.on_device(tuple(cfg.voxel_extents), dev))
    slot_map = torch.full((table.capacity,), -1, dtype=torch.int64,
                          device=dev)
    slot_map[slots] = torch.arange(A, dtype=torch.int64, device=dev)
    found, wslot, _, eres, n_distinct = H.lookup_dedup(
        table, blk.reshape(-1, 3), visit.reshape(-1), slot_map)
    found = found.reshape(visit.shape)
    wslot = wslot.reshape(visit.shape)
    scale = (torch.ones_like(eres) << eres).reshape(visit.shape)[..., None]

    # the voxel at its resolution's lattice (voxel_data_structures.cu:
    # 1309-1321): floor(vox / scale) * (vvs * scale)
    vox_s = torch.div(vox, scale, rounding_mode="floor")
    voxel_cam = C.world_to_cam(cam, vox_s.to(torch.float32)
                               * (vvs * scale.to(torch.float32)))
    if cfg.projective_sdf:
        sdf = rng[None, :] - X.norm3(voxel_cam)[..., 0]
    else:
        d = voxel_cam - points[None]
        n = norm_dir[None]
        sdf = (d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1]
               + d[..., 2] * n[..., 2])
    lo, hi = -trunc[None, :], trunc[None, :]
    inside = sdf > lo
    sdf = torch.clamp(sdf, min=lo, max=hi)
    alive = torch.cumprod(torch.where(found, inside, True).to(torch.int32),
                          dim=0).to(torch.bool)
    contrib = visit & found & inside & alive

    # dense lane of the voxel in its block (side 8 >> res)
    local = torch.div(torch.remainder(vox, P.SDF_BLOCK_SIZE), scale,
                      rounding_mode="floor")
    side = P.SDF_BLOCK_SIZE // scale[..., 0]
    lane = (local[..., 2] * side * side + local[..., 1] * side
            + local[..., 0])
    # (weight, weight * sdf) summed per window voxel over the contributions
    # alone, in walk order (k-major): an index per non-contribution would
    # put them all on one address, whose atomics serialize on a card
    cidx = nonzero(contrib.reshape(-1))
    w_up = float(cfg.integration_weight_sample)
    vals = torch.stack([torch.full_like(sdf, w_up), sdf * w_up], dim=-1)
    acc = torch.zeros((A * LANES, 2), dtype=torch.float32, device=dev)
    acc.index_add_(0, (wslot * LANES + lane).reshape(-1)[cidx],
                   vals.reshape(-1, 2)[cidx])
    acc_w, acc_sw = acc.reshape(A, LANES, 2).unbind(-1)

    # merge, in window layout (lane v = voxel v of the entry)
    vidx, valid = window_voxels(bptr, bres)
    sdf0, w0 = pool.sdf.view(-1)[vidx], pool.weight.view(-1)[vidx]
    ssq0 = pool.sumsq.view(-1)[vidx]
    hit = acc_w > 0
    half_voxel = X.on_device(vvs / 2.0, dev)
    batch_sdf = acc_sw / torch.where(hit, acc_w, 1.0)
    curr_mean = torch.where(w0 > 0, sdf0, 0.0)
    delta = (batch_sdf - curr_mean) / half_voxel
    w0f = w0.to(torch.float32)
    m_sdf = (sdf0 * w0f + acc_sw) / torch.clamp(w0f + acc_w, min=1e-20)
    m_w = torch.clamp(w0 + acc_w.to(torch.int32),
                      max=cfg.integration_weight_max)
    delta2 = (batch_sdf - m_sdf) / half_voxel
    m_ssq = ssq0 + delta * delta2
    for field, new, old in ((pool.sdf, m_sdf, sdf0), (pool.weight, m_w, w0),
                            (pool.sumsq, m_ssq, ssq0)):
        put_windows(field, vidx, valid, torch.where(hit, new, old))
    return dict(visited=host_int(visit.sum()), distinct=n_distinct)


# ---------------------------------------------------------------------------
# starvation + garbage collection
# ---------------------------------------------------------------------------

FAR = 1e30   # z-buffer sentinel


def starve_mask(cfg: MapConfig, cam: C.Camera, bpos, bres, group=None,
                skip=None):
    """Geometry half of starveVoxelsKernel (voxel_data_structures.cu:
    1596-1671): the window-layout [A,512] mask of the front-most window voxel
    per pixel, over both resolutions.  One-shot over the whole window
    (PORT_NOTES.md P3); the entries `skip` (bool[A], or None) marks take no
    part, as if the window left them out.  The z-buffer is a scatter-min; its
    readback at each voxel's own pixel goes through kernel K2
    (ops/sample_image.py), as the reference's fused path reads it back through
    its image sampler.  Voxels tied at the exact front depth all starve
    (deviation D11 of the reference).  With `group` (a parallel/launch.py
    RankGroup, the sharded steps) the z-buffer is all_reduce(MIN)-merged across
    its ranks before the readback, so each rank's winners are the front-most
    voxels of the whole map."""
    vvs = cfg.virtual_voxel_size
    pi, valid = X.block_voxel_grid(bpos, bres)
    pf = X.virtual_voxel_pos_to_world(vvs, pi)
    pcam = C.world_to_cam(cam, pf)
    row, col, ok = C.project_point(cam, pcam)
    depth = C.get_depth(cam, pcam)
    ok = ok & valid & (depth >= cam.min_depth)
    if skip is not None:
        ok &= ~skip[:, None]

    HW = cam.rows * cam.cols
    pix = torch.where(ok, row.to(torch.int64) * cam.cols + col, HW)
    d = torch.where(ok, depth, FAR)
    zbuf = torch.full((HW + 1,), FAR, dtype=torch.float32, device=d.device)
    zbuf.scatter_reduce_(0, pix.reshape(-1), d.reshape(-1), "amin")
    if group is not None:
        group.all_reduce(zbuf, "min")
    zimg = torch.zeros((2, cam.rows, cam.cols), dtype=torch.float32,
                       device=d.device)
    zimg[0] = zbuf[:HW].reshape(cam.rows, cam.cols)
    zsamp = SI.sample_image(zimg, row.contiguous(), col.contiguous(),
                            ok.contiguous())[:, 0, :]
    return ok & (depth == zsamp)


def apply_starve(pool: VoxelPool, bptr, bres, starved):
    """Decrement the weights of the starved voxels (window-layout mask), in
    place."""
    vidx, _ = window_voxels(bptr, bres)
    dst = pick(vidx, starved)
    w = pool.weight.view(-1)
    w[dst] = torch.clamp(w[dst] - 1, min=0)


def starve_voxels(cfg: MapConfig, pool: VoxelPool, cam: C.Camera, bpos,
                  bptr, bres, group=None, skip=None):
    """starveVoxelsKernel: the front-most voxel per pixel (of the whole
    sharded map with `group`, starve_mask) loses one unit of weight; the
    entries `skip` marks (the ones coarsening freed) neither take part
    nor lose weight."""
    apply_starve(pool, bptr, bres,
                 starve_mask(cfg, cam, bpos, bres, group, skip))


def gc_decide(cfg: MapConfig, cam: C.Camera, pool: VoxelPool, bptr, bres):
    """garbageCollectIdentify read from the pool (the flagless branch of
    the reference's garbage_collect_sweep, mrhash_tpu/ops/integrate.py:
    1706-1717): an entry is freed when the min |sdf| over the weighted
    voxels of its window reaches the max-depth truncation or its max
    weight is 0.  The LiDAR step takes it on every point-centric scan,
    which has no kernel flags, and on starve scans, where the reference
    collects on the post-starve weights."""
    trunc_max = X.get_truncation(cam.max_depth, cfg.sdf_truncation,
                                 cfg.sdf_truncation_scale)
    vidx, valid = window_voxels(bptr, bres)
    w = torch.where(valid, pool.weight.view(-1)[vidx], 0)
    s = torch.where(w > 0, pool.sdf.view(-1)[vidx].abs(), INF)
    return (s.amin(dim=1) >= trunc_max) | (w.amax(dim=1) == 0)


def garbage_collect_sweep(cfg: MapConfig, table: H.HashTable,
                          pool: VoxelPool, slots, decision):
    """garbageCollectIdentify + Free (voxel_data_structures.cu:1673-1854):
    free the window blocks whose per-entry `decision` is set, at most
    cfg.max_gc_free_per_frame per frame in window order (the rest
    stagger), and clear their windows.  The decision comes from the
    kernel's flags of each entry's own window (window_decisions) or from
    the pool (gc_decide).

    On RGB-D starve frames the flags predate the starvation, so a block
    starved to weight 0 is freed one frame later (the reference's
    deviation D12); the LiDAR step reads the pool after its starve, as the
    reference's does.  Returns the number of blocks freed (a host int)."""
    didx = H.compact_indices(decision, int(cfg.max_gc_free_per_frame))
    if didx.numel():
        ptrs, res = H.free_slots(table, slots[didx])
        clear_blocks(pool, ptrs, res)
    return int(didx.numel())


# ---------------------------------------------------------------------------
# variance-adaptive coarsening (multi-resolution)
# ---------------------------------------------------------------------------

def coarsen_decide(cfg: MapConfig, pool: VoxelPool, bptr, bres):
    """checkVarSDFKernel decision mask (voxel_data_structures.cu:1856-1905)
    read from the pool: res-0 blocks whose average SDF variance over their
    weighted voxels is positive and below threshold.  The frame step takes
    the same decision from K1's or K3's flags (window_decisions)."""
    vidx, valid = window_voxels(bptr, bres)
    w = pool.weight.view(-1)[vidx]
    m = (w > 0) & valid
    w_tot = torch.where(m, w, 0).to(torch.float32).sum(dim=1)
    ssq_tot = torch.where(m, pool.sumsq.view(-1)[vidx], 0.0).sum(dim=1)
    avg_var = ssq_tot / torch.clamp(w_tot - 1.0, min=1e-12)
    return ((bres == 0) & (w_tot >= 2) & (avg_var > 0.0)
            & (avg_var < cfg.sdf_var_threshold))


def reintegrate_blocks(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                       cam: C.Camera, pc_depth, rgb_img, new_slots,
                       new_mask):
    """reintegrateDepthMapKernel (voxel_data_structures.cu:1941-2018): fuse
    the current frame into the freshly coarsened blocks, through K1's res-1
    path (the reference samples through its image sampler, B5; both sample
    each voxel's own pixel, PORT_NOTES.md P30)."""
    s = pick(new_slots, new_mask)
    fused_integrate_depth(cfg, pool, cam, pc_depth, rgb_img, table.pos[s],
                          table.ptr[s], table.res[s])
