"""TSDF allocation, integration, variance-adaptive coarsening, starvation
and garbage collection for the RGB-D and LiDAR paths.

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
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import (LANES, MapConfig, VoxelPool,
                                         pack_rgb, put_windows, unpack_rgb,
                                         window_voxels)
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import fused_integrate as FI
from mrhash_tpu_torch.ops import fused_integrate_points as FIP
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.utils.profiler import (host_int, nonzero, pick, put,
                                             stage)

INF = float("inf")


def _norm3(v):
    """Euclidean norm over the last axis, summed x, y, z in order."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return torch.sqrt(x * x + y * y + z * z)


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
# DDA candidate generation
# ---------------------------------------------------------------------------

def _dda_visit(cfg: MapConfig, pw_min, pw_max, ray_valid, num_steps: int,
               block_level: bool = True):
    """The DDA of allocBlocks{,3D}Kernel and integrate3DKernel
    (voxel_data_structures.cu:790-857, 963-1033, 1259-1303): walk the block
    grid (block_level) or the virtual-voxel grid from pw_min to pw_max for
    num_steps steps.  The voxel size and voxel_extents reach the quotients
    as f32 tensors on the points' device (coords.on_device), so the card
    walks the CPU's cells.  Returns (cells i32[K,R,3], visit_mask
    bool[K,R])."""
    vvs = cfg.virtual_voxel_size
    dev = pw_min.device
    vvs_t = X.on_device(float(vvs), dev)
    seg = pw_max - pw_min
    seg_len = _norm3(seg)
    direction = seg / torch.where(seg_len == 0, torch.ones_like(seg_len),
                                  seg_len)
    step = torch.sign(direction)
    step_i = torch.clamp(step, 0.0, 1.0).to(torch.int32)
    if block_level:
        ext = X.on_device(tuple(cfg.voxel_extents), dev)
        id_cur = X.world_point_to_sdf_block(vvs_t, ext, pw_min)
        id_end = X.world_point_to_sdf_block(vvs_t, ext, pw_max)
        boundary = (X.sdf_block_to_world_point(vvs, id_cur + step_i)
                    - 0.5 * vvs)
        cell_metric = P.SDF_BLOCK_SIZE * vvs
    else:
        id_cur = X.world_point_to_virtual_voxel_pos(vvs_t, pw_min)
        id_end = X.world_point_to_virtual_voxel_pos(vvs_t, pw_max)
        boundary = (X.virtual_voxel_pos_to_world(vvs, id_cur + step_i)
                    - 0.5 * vvs)
        cell_metric = vvs
    safe_dir = torch.where(direction == 0, torch.ones_like(direction),
                           direction)
    t_max = (boundary - pw_min) / safe_dir
    t_delta = (step * cell_metric) / safe_dir
    degenerate = ((torch.abs(direction) < P.FLOAT_EPSILON)
                  | (torch.abs(boundary - direction) < P.FLOAT_EPSILON))
    t_max = torch.where(degenerate, INF, t_max)
    t_delta = torch.where(degenerate, INF, t_delta)
    id_bound = (id_end.to(torch.float32) + step).to(torch.int32)
    step_int = step.to(torch.int32)

    alive = ray_valid
    blocks, masks = [], []
    for _ in range(num_steps):
        blocks.append(id_cur)
        masks.append(alive)
        tx, ty, tz = t_max[..., 0], t_max[..., 1], t_max[..., 2]
        ax_x = (tx < ty) & (tx < tz)
        ax_z = ~ax_x & (tz < ty)
        ax_y = ~ax_x & ~ax_z
        axis = torch.stack([ax_x, ax_y, ax_z], dim=-1)
        id_cur = torch.where(axis, id_cur + step_int, id_cur)
        hit_bound = (axis & (id_cur == id_bound)).any(dim=-1)
        t_max = torch.where(axis, t_max + t_delta, t_max)
        alive = alive & ~hit_bound
    return torch.stack(blocks), torch.stack(masks)


def _tile_segments(cfg: MapConfig, cam: C.Camera, pc_depth, row0,
                   frame: int):
    """Tile-granular allocation's rays (mrhash_tpu:
    _alloc_candidates_tiles): per s x s pixel tile one representative ray,
    phase-rotated over the tile's pixels, through the near band
    [dmin-t, dmin+t] on even frames and the far band
    [max(dmax-t, dmin+t), dmax+t] on odd frames.  Returns the world
    segments (pw_min, pw_max f32[T,3]) and their validity bool[T]."""
    H_, W_ = pc_depth.shape
    s = int(cfg.alloc_tile)
    Hp, Wp = -(-H_ // s) * s, -(-W_ // s) * s
    d = pc_depth
    if (Hp, Wp) != (H_, W_):
        d = torch.zeros((Hp, Wp), dtype=pc_depth.dtype,
                        device=pc_depth.device)
        d[:H_, :W_] = pc_depth
    tiles = d.reshape(Hp // s, s, Wp // s, s)
    tvalid = tiles > 0.0
    dmin = torch.where(tvalid, tiles, INF).amin(dim=(1, 3)).reshape(-1)
    dmax = torch.where(tvalid, tiles, -INF).amax(dim=(1, 3)).reshape(-1)
    any_valid = tvalid.sum(dim=(1, 3)).reshape(-1) > 0

    Wt = Wp // s
    n_tiles = (Hp // s) * Wt
    use_far = frame % 2 == 1
    phase = (frame // 2) % (s * s)
    py, px = phase // s, phase % s
    ar = torch.arange(n_tiles, dtype=torch.int32, device=d.device)
    rows = (py + s * (ar // Wt) + row0).to(torch.float32)
    cols = (px + s * (ar % Wt)).to(torch.float32)

    t_lo = X.get_truncation(dmin, cfg.sdf_truncation,
                            cfg.sdf_truncation_scale)
    t_hi = X.get_truncation(dmax, cfg.sdf_truncation,
                            cfg.sdf_truncation_scale)
    mdist = cfg.max_integration_distance
    a_max = torch.clamp(dmin + t_lo, max=mdist)
    if use_far:
        lo = torch.clamp(torch.maximum(dmax - t_hi, a_max), max=mdist)
        hi = torch.clamp(dmax + t_hi, max=mdist)
    else:
        lo = torch.clamp(dmin - t_lo, max=mdist)
        hi = a_max
    ok = any_valid & (lo < hi)
    pw_min = C.cam_to_world(cam, C.inverse_projection(cam, rows, cols, lo))
    pw_max = C.cam_to_world(cam, C.inverse_projection(cam, rows, cols, hi))
    return pw_min, pw_max, ok


def _pixel_grid(cfg: MapConfig, shape, frame):
    """The depth path's ray grid (s, py, px, Hs, Ws): pixels (py + s*a,
    px + s*b) for a < Hs, b < Ws, as alloc_candidates_depth_ref slices
    them."""
    H_, W_ = shape
    s = int(cfg.alloc_pixel_stride)
    if s > 1 and frame is not None:
        phase = int(frame) % (s * s)
        return s, phase // s, phase % s, H_ // s, W_ // s
    return 1, 0, 0, H_, W_


def alloc_candidates_depth(cfg: MapConfig, cam: C.Camera, pc_depth,
                           num_steps: int, row0=0, frame=None, scratch=None):
    """allocBlocksKernel (voxel_data_structures.cu:757-857): per-pixel ray
    through the truncation band [d-t, d+t].  cfg.alloc_tile > 1 takes the
    tile path; otherwise cfg.alloc_pixel_stride = s > 1 (with a frame
    counter) walks every s-th pixel, phase-rotated per frame.  Returns flat
    candidate keys i32[M,3] + valid mask bool[M].  With `scratch`
    (dedup_scratch) each valid candidate also scatters into it, as
    dedup_scatter does.  CPU tensors take the plain twin
    (alloc_candidates_depth_ref, then dedup_scatter); CUDA tensors kernel
    K7 (ops/alloc_blocks.py), which fuses the ray setup of either path,
    the walk and the scatter (a pinhole camera)."""
    if not AB.on_card(pc_depth.device):
        keys, valid = alloc_candidates_depth_ref(cfg, cam, pc_depth,
                                                 num_steps, row0, frame)
        if scratch is not None:
            dedup_scatter(keys, valid, scratch)
        return keys, valid
    cells, salt = ((None, 0) if scratch is None
                   else (scratch.cells, AB.salt32(scratch.salt)))
    if cam.model != C.PINHOLE:
        raise ValueError("alloc_candidates_depth: kernel K7 walks pinhole "
                         "depth images only")
    if int(cfg.alloc_tile) > 1:
        return AB.walk_tiles(cfg, cam, pc_depth, num_steps,
                             0 if frame is None else int(frame), int(row0),
                             cells, salt)
    return AB.walk_depth(cfg, cam, pc_depth, num_steps,
                         _pixel_grid(cfg, pc_depth.shape, frame), int(row0),
                         cells, salt)


def alloc_candidates_depth_ref(cfg: MapConfig, cam: C.Camera, pc_depth,
                               num_steps: int, row0=0, frame=None):
    """The plain twin of kernel K7's depth walk: alloc_candidates_depth's
    keys and valid mask, in torch ops on any device."""
    if int(cfg.alloc_tile) > 1:
        keys, mask = _dda_visit(
            cfg, *_tile_segments(cfg, cam, pc_depth, row0,
                                 0 if frame is None else int(frame)),
            num_steps)
        return keys.reshape(-1, 3), mask.reshape(-1)
    H_, W_ = pc_depth.shape
    dev = pc_depth.device
    s = int(cfg.alloc_pixel_stride)
    if s > 1 and frame is not None:
        phase = int(frame) % (s * s)
        py, px = phase // s, phase % s
        sub = pc_depth[py:py + H_ - s + 1:s, px:px + W_ - s + 1:s]
        Hs, Ws = sub.shape
        depth = sub.reshape(-1)
        ar = torch.arange(Hs * Ws, dtype=torch.int32, device=dev)
        rows = (py + s * (ar // Ws) + row0).to(torch.float32)
        cols = (px + s * (ar % Ws)).to(torch.float32)
    else:
        depth = pc_depth.reshape(-1)
        ar = torch.arange(H_ * W_, dtype=torch.int32, device=dev)
        rows = (ar // W_ + row0).to(torch.float32)
        cols = (ar % W_).to(torch.float32)

    t = X.get_truncation(depth, cfg.sdf_truncation, cfg.sdf_truncation_scale)
    d_min = torch.clamp(depth - t, max=cfg.max_integration_distance)
    d_max = torch.clamp(depth + t, max=cfg.max_integration_distance)
    ray_valid = (depth != 0.0) & (d_min < d_max)
    pw_min = C.cam_to_world(cam, C.inverse_projection(cam, rows, cols, d_min))
    pw_max = C.cam_to_world(cam, C.inverse_projection(cam, rows, cols, d_max))
    blocks, mask = _dda_visit(cfg, pw_min, pw_max, ray_valid, num_steps)
    return blocks.reshape(-1, 3), mask.reshape(-1)


# ---------------------------------------------------------------------------
# candidate dedup + allocation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DedupScratch:
    """One allocation round's salted dedup scratch: cells holds each
    cell's highest candidate index, -1 where empty (i64 for the twins,
    i32 for the kernels); salt is the round's frame salt."""
    cells: torch.Tensor
    salt: int


def dedup_scratch(cfg: MapConfig, frame: int, device, rnd: int = 0):
    """The empty scratch of round `rnd` of frame `frame`: U x
    dedup_scratch_factor cells, salt frame * alloc_rounds + rnd."""
    n = int(cfg.max_alloc_per_frame) * int(cfg.dedup_scratch_factor)
    salt = int(frame) * int(cfg.alloc_rounds) + rnd
    if AB.on_card(device):
        return DedupScratch(AB.new_scratch(n, device), salt)
    return DedupScratch(torch.full((n,), -1, dtype=torch.int64,
                                   device=device), salt)


def dedup_scatter(keys, valid, scratch: DedupScratch):
    """The salted scratch scatter of each valid candidate's index, in
    torch ops on any device (the twin of kernel K7's scatter).  Distinct
    keys colliding in a cell lose one candidate this frame; the per-frame
    salt rotates the losers (the reference's staggered lock-miss
    semantics, voxel_data_structures.cu:876).  Each cell keeps its highest
    candidate index (scatter "amax"; the reference's duplicate .set lets
    any writer win)."""
    x, y, z = (H.u32(keys[..., i]) for i in range(3))
    salt = AB.salt32(scratch.salt)
    h = H._avalanche((H.mul32(x, P.P1) + salt) & H.MASK32)
    h = H._avalanche(h ^ H.mul32(y, P.P2))
    h = H._avalanche(h ^ H.mul32(z, P.P0))
    cell = h % int(scratch.cells.shape[0])
    vidx = nonzero(valid)
    scratch.cells.scatter_reduce_(0, cell[vidx], vidx.to(scratch.cells.dtype),
                                  "amax")


def dedup_compact(keys, cells, u_max: int):
    """The winners' keys i32[<=u_max,3] in scratch-cell order, in torch
    ops on any device (the twin of kernel K8)."""
    sel = H.compact_indices(cells >= 0, u_max)
    return keys[cells[sel]]


def dedup_candidates(keys, valid, frame_salt: int, scratch_size: int,
                     u_max: int):
    """One representative per distinct block key via a salted scratch
    scatter (dedup_scatter, then dedup_compact), in torch ops on any
    device.  Returns the winners' keys i32[<=u_max,3] in scratch-cell
    order."""
    scratch = DedupScratch(torch.full((scratch_size,), -1, dtype=torch.int64,
                                      device=keys.device), frame_salt)
    dedup_scatter(keys, valid, scratch)
    return dedup_compact(keys, scratch.cells, u_max)


def alloc_blocks(cfg: MapConfig, table: H.HashTable, keys, valid,
                 frame: int, scratch: DedupScratch | None = None):
    """allocBlocks (voxel_data_structures.cu:873-922): alloc_rounds salted
    dedup + insert passes, updating `table` in place.  `scratch`, given,
    is round 0's scratch that the candidates' walk already filled
    (alloc_candidates_*(..., scratch=)).  Returns host ints (submitted,
    inserted): the deduped keys handed to insert over the rounds, and the
    blocks drawn from the heaps for them.  On a card each round is kernels
    K7 (the scatter, when the walk did not do it), K8 and K9 with one host
    read (ops/alloc_blocks.py); on the CPU the twins."""
    U = cfg.max_alloc_per_frame
    card = AB.on_card(keys.device)
    free0 = table.high_count + table.low_count
    submitted = 0
    for i in range(cfg.alloc_rounds):
        with stage("alloc.dedup"):
            if i or scratch is None:
                scratch = dedup_scratch(cfg, frame, keys.device, i)
                if card:
                    AB.scatter(keys, valid, scratch.cells,
                               AB.salt32(scratch.salt))
                else:
                    dedup_scatter(keys, valid, scratch)
            if card:
                ukeys, stats = AB.compact(scratch.cells, keys, U)
            else:
                ukeys, stats = dedup_compact(keys, scratch.cells, U), None
        with stage("alloc.insert"):
            submitted += H.insert(table, ukeys, 0, stats)["count"]
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


def _block_voxel_grid(bpos, bres, lane0=None):
    """Virtual-voxel coords i32[A,512,3] and lane validity bool[A,512] of
    each block's lattice: 8^3 for res 0, 4^3 at twice the spacing for res 1
    (integrateDepthMapKernel's scaled delinearization,
    voxel_data_structures.cu:1114-1118, with the dense res-1 indexing).
    Without lane0 the lanes are in window layout (lane v = voxel v); with
    lane0 they address the block's row (a res-1 block's voxels at lanes
    [lane0, lane0 + 64)), as the reference's row layout."""
    lanes = torch.arange(LANES, dtype=torch.int32, device=bpos.device)
    local = (lanes[None, :] if lane0 is None
             else lanes[None, :] - lane0.to(torch.int32)[:, None])
    is_low = (bres == 1)[:, None]
    nvox = torch.where(is_low, P.TOTAL_LOW_BLOCK_SIZE, LANES)
    lane_valid = (local >= 0) & (local < nvox)
    off8 = X.delinearize_voxel_pos(torch.clamp(local, 0, LANES - 1),
                                   P.SDF_BLOCK_SIZE)
    off4 = X.delinearize_voxel_pos(
        torch.clamp(local, 0, P.TOTAL_LOW_BLOCK_SIZE - 1),
        P.LOW_BLOCK_SIZE) * 2
    offs = torch.where(is_low[..., None], off4, off8)
    return X.sdf_block_to_virtual_voxel_pos(bpos)[:, None, :] + offs, \
        lane_valid


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
    pi, valid = _block_voxel_grid(bpos, bres)
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
# LiDAR: per-point allocation, scan raster, spherical projection, kernel K3
# ---------------------------------------------------------------------------

def _unit(v):
    """(v / |v| with a zero vector kept zero, |v| f32[...])."""
    n = _norm3(v)
    return v / torch.where(n == 0, 1.0, n), n[..., 0]


def alloc_candidates_points(cfg: MapConfig, cam: C.Camera, points,
                            num_steps: int, normals=None, scratch=None):
    """allocBlocks3DKernel (voxel_data_structures.cu:924-1033): per-LiDAR-
    point DDA through the band [r-t, r+t] of the range, along the camera
    ray (cfg.projective_sdf) or along the normal (normals f32[N,3], unit
    or zero: a zero normal walks the degenerate segment at the point, as
    the reference).  points f32[N,3] in the camera frame; a zero point (no
    return) walks nothing.  No frustum filter (matches the 3D kernel).
    Returns flat candidate keys i32[M,3] + valid mask bool[M].  `scratch`
    and the dispatch as alloc_candidates_depth's: the plain twin
    (alloc_candidates_points_ref) for CPU tensors, kernel K7 for CUDA
    tensors."""
    if not AB.on_card(points.device):
        keys, valid = alloc_candidates_points_ref(cfg, cam, points,
                                                  num_steps, normals)
        if scratch is not None:
            dedup_scatter(keys, valid, scratch)
        return keys, valid
    cells, salt = ((None, 0) if scratch is None
                   else (scratch.cells, AB.salt32(scratch.salt)))
    return AB.walk_points(cfg, cam, points,
                          None if cfg.projective_sdf else normals,
                          num_steps, cells, salt)


def alloc_candidates_points_ref(cfg: MapConfig, cam: C.Camera, points,
                                num_steps: int, normals=None):
    """The plain twin of kernel K7's point walk: alloc_candidates_points'
    keys and valid mask, in torch ops on any device."""
    cam_dir, rng = _unit(points)
    t = X.get_truncation(rng, cfg.sdf_truncation, cfg.sdf_truncation_scale)
    d_min = torch.clamp(rng - t, max=cfg.max_integration_distance)
    d_max = torch.clamp(rng + t, max=cfg.max_integration_distance)
    ray_valid = (rng != 0.0) & (d_min < d_max)
    walk_dir = cam_dir if cfg.projective_sdf else _unit(normals)[0]
    pc_min = points + walk_dir * (d_min - rng)[..., None]
    pc_max = points + walk_dir * (d_max - rng)[..., None]
    blocks, mask = _dda_visit(cfg, C.cam_to_world(cam, pc_min),
                              C.cam_to_world(cam, pc_max), ray_valid,
                              num_steps)
    return blocks.reshape(-1, 3), mask.reshape(-1)


def scan_raster_mapping(cam: C.Camera, points):
    """The scan's own elevation mapping (mrhash_tpu: _scan_raster_mapping):
    the full azimuth circle maps to cam.cols columns, and the elevation
    span of the scan's returns to cam.rows rows.  Returns 0-d tensors
    (el_lo, s_el), row = floor((el - el_lo) * s_el + 0.5)."""
    if points.shape[0] == 0:      # maps like one point with no return
        points = torch.zeros((1, 3), dtype=torch.float32,
                             device=points.device)
    rng = _norm3(points)[..., 0]
    ok = rng > 1e-6
    el = torch.asin(torch.clamp(points[..., 2] / torch.where(ok, rng, 1.0),
                                -1.0, 1.0))
    el_lo = torch.where(ok, el, INF).amin()
    el_hi = torch.where(ok, el, -INF).amax()
    el_lo = torch.where(torch.isfinite(el_lo), el_lo, -1.0)
    el_hi = torch.where(torch.isfinite(el_hi), el_hi, 1.0)
    return el_lo, (cam.rows - 1) / torch.clamp(el_hi - el_lo, min=1e-6)


def _sph_rowcol(cam: C.Camera, pc, el_lo, s_el):
    """Raster (row, col) of camera-frame points under the scan mapping.
    Returns (row i32, col i32, range f32, in_rows bool)."""
    rng = _norm3(pc)[..., 0]
    safe = torch.where(rng == 0, 1.0, rng)
    az = torch.atan2(pc[..., 1], pc[..., 0])
    el = torch.asin(torch.clamp(pc[..., 2] / safe, -1.0, 1.0))
    colf = (az + math.pi) * (cam.cols / (2.0 * math.pi))
    col = torch.clamp(colf.to(torch.int32), 0, cam.cols - 1)
    row = torch.floor((el - el_lo) * s_el + 0.5).to(torch.int32)
    return row, col, rng, (row >= 0) & (row < cam.rows)


def _sph_ok(cam: C.Camera, rng, in_rows):
    return in_rows & (rng >= cam.min_depth) & (rng <= cam.max_depth)


def rasterize_scan(cam: C.Camera, points, el_lo, s_el):
    """Min-range rasterization of the scan onto an unpadded f32[rows, cols]
    image; empty cells hold 0.  The reference's azimuth-wrap pad columns
    and 8-aligned rows fed its VMEM patch windows (PORT_NOTES.md P14)."""
    row, col, rng, in_rows = _sph_rowcol(cam, points, el_lo, s_el)
    ok = _sph_ok(cam, rng, in_rows)
    HW = cam.rows * cam.cols
    flat = torch.where(ok, row.to(torch.int64) * cam.cols + col, HW)
    img = torch.full((HW + 1,), INF, dtype=torch.float32,
                     device=points.device)
    img.scatter_reduce_(0, flat, torch.where(ok, rng, INF), "amin")
    img = img[:HW].reshape(cam.rows, cam.cols)
    return torch.where(torch.isfinite(img), img, 0.0)


def project_window_sph(cfg: MapConfig, cam: C.Camera, bpos, bres, el_lo,
                       s_el):
    """Per-lane spherical projection of the window's voxels, in window
    layout (the geometry of mrhash_tpu's _sph_proj_pack without its patch
    bookkeeping; computed in torch outside kernel K3, PORT_NOTES.md P15).
    Returns pix i32[A,512] = row * cols + col, or -1 where the lane is not
    a voxel of its block (lanes past 64 of a res-1 entry) or falls outside
    the image rows or the depth range, and r_vox f32[A,512], the voxel's
    camera range."""
    pi, valid = _block_voxel_grid(bpos, bres)
    pw = X.virtual_voxel_pos_to_world(cfg.virtual_voxel_size, pi)
    row, col, rng, in_rows = _sph_rowcol(cam, C.world_to_cam(cam, pw),
                                         el_lo, s_el)
    ok = valid & _sph_ok(cam, rng, in_rows)
    pix = torch.where(ok, row.clamp(0, cam.rows - 1) * cam.cols + col, -1)
    return pix, rng


def points_window(cfg: MapConfig, cam: C.Camera, points, bpos, bptr, bres):
    """Kernel K3's operands for one scan over the window: rasterize the
    scan to a min-range image and project every window voxel to its pixel.
    Returns (img f32[rows, cols], pix i32[A,512], r_vox f32[A,512],
    ptr i32[A], res i32[A], consts) as ops/fused_integrate_points.py takes
    them."""
    with stage("points.raster"):
        el_lo, s_el = scan_raster_mapping(cam, points)
        img = rasterize_scan(cam, points, el_lo, s_el)
    with stage("points.projection"):
        pix, r_vox = project_window_sph(cfg, cam, bpos, bres, el_lo, s_el)
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
    cam_dir, rng = _unit(points)
    norm_dir = _unit(normals)[0]
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
    vox, visit = _dda_visit(cfg, C.cam_to_world(cam, pc_min),
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
        sdf = rng[None, :] - _norm3(voxel_cam)[..., 0]
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
    pi, valid = _block_voxel_grid(bpos, bres)
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


def _clear_blocks(pool: VoxelPool, bptr, bres):
    """deleteVoxel over whole blocks (voxel_data_structures.cu:1838-1842):
    zero the freed blocks' windows, a res-0 block's row and a res-1
    block's 64 lanes (their siblings' windows in the same row stay)."""
    vidx, _ = window_voxels(bptr, bres)
    for f in VoxelPool.FIELDS:
        put(getattr(pool, f).view(-1), vidx, 0)


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
        _clear_blocks(pool, ptrs, res)
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


def coarsen_by_variance(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                        slots, bpos, decide):
    """checkVarSDFKernel + reallocBlocks (voxel_data_structures.cu:
    1856-2069), in place: coarsen_by_variance_ref's semantics.  CPU
    tensors take the twin coarsen_by_variance_ref; CUDA tensors kernels
    K10-K12 with the insert through K9 (ops/coarsen_blocks.py), in five
    launches and two counted host reads.  Returns coarsen_by_variance_ref's
    (new_slots, new_mask, freed)."""
    if AB.on_card(decide.device):
        return CB.coarsen(cfg, table, pool, slots, bpos, decide)
    return coarsen_by_variance_ref(cfg, table, pool, slots, bpos, decide)


def coarsen_by_variance_ref(cfg: MapConfig, table: H.HashTable,
                            pool: VoxelPool, slots, bpos, decide):
    """checkVarSDFKernel + reallocBlocks (voxel_data_structures.cu:
    1856-2069), in place, in torch ops on any device: the plain twin of
    kernels K10-K12 (ops/coarsen_blocks.py), and what the CPU runs.
    Serve at most cfg.max_coarsen_per_frame decided res-0 window entries
    (window order; the rest stay fine and decide again next frame), free
    them and snapshot their rows, clear the rows, split high blocks when
    the low heap is short (allocateMemoryLow), insert the keys at res 1
    and, with cfg.coarsen_downsample, merge the fine observations into the
    coarse blocks (_downsample_into_coarse).

    Returns (new_slots i64[u], new_mask bool[u], freed bool[A]): the table
    slots of the coarse blocks, which of them were inserted, and the window
    entries freed (later passes over this frame's window skip them: their
    slots are free and their rows cleared, or already a coarse block's)."""
    sel = H.compact_indices(decide, int(cfg.max_coarsen_per_frame))
    ptrs, fres = H.free_slots(table, slots[sel])   # window slots: occupied
    rows = ptrs.to(torch.int64) // LANES             # res-0 rows
    fine = ({f: getattr(pool, f)[rows] for f in VoxelPool.FIELDS}
            if cfg.coarsen_downsample else None)
    _clear_blocks(pool, ptrs, fres)
    freed = torch.zeros(decide.shape[0], dtype=torch.bool,
                        device=decide.device)
    put(freed, sel, True)
    if table.low_count < sel.numel():
        H.split_high_blocks(table, int(cfg.low_split_chunk))
    info = H.insert(table, bpos[sel], torch.ones(
        sel.numel(), dtype=torch.int32, device=bpos.device))
    new = info["was_new"]
    if fine is not None:
        _downsample_into_coarse(cfg, table, pool,
                                {f: pick(v, new) for f, v in fine.items()},
                                pick(info["slot"], new))
    return info["slot"], new, freed


def _downsample_into_coarse(cfg: MapConfig, table: H.HashTable,
                            pool: VoxelPool, fine, new_slots):
    """Merge freed fine blocks' accumulated observations (rows `fine`,
    [u,512] per field) into their coarse replacements at table slots
    `new_slots`: each coarse voxel takes the weight sum, the de-biased
    weighted-mean SDF and the weighted-mean colour of its 8 children, with
    sumsq combined by the parallel-variance formula (Chan) under the
    integration's half-voxel normalization.  The reference's improvement
    over the CUDA original, which deletes the data and reintegrates only
    the current frame (voxel_data_structures.cu:1929-2018).  Each coarse
    block's 64-lane window is written in place (it was cleared when its
    id was freed)."""
    u = new_slots.shape[0]
    half_voxel = cfg.virtual_voxel_size / 2.0
    # fine lane = z*64 + y*8 + x  ->  [u, cz,dz, cy,dy, cx,dx]
    shape6 = (u, 4, 2, 4, 2, 4, 2)
    ax = (2, 4, 6)
    wf = fine["weight"].to(torch.float32).reshape(shape6)
    sd = fine["sdf"].reshape(shape6)
    ssq = torch.where(wf > 0, fine["sumsq"].reshape(shape6), 0.0)
    rgb = unpack_rgb(fine["rgbp"]).to(torch.float32).reshape(shape6 + (3,))
    wsd = wf * sd

    w_c = wf.sum(dim=ax)                                      # [u,4,4,4]
    w_safe = torch.clamp(w_c, min=1.0)
    m_c = wsd.sum(dim=ax) / w_safe
    # de-bias: the coarse voxel's centre is its (0,0,0) child, not the
    # children's weighted centroid (+0.5 fine voxel per axis); correct the
    # mean by the per-axis SDF step times the centroid offset, on axes
    # with data on both sides
    corr = torch.zeros_like(m_c)
    for a in ax:                                # dz, dy, dx child axes
        other = tuple(b - (b > a) for b in ax if b != a)
        w_lo = wf.select(a, 0).sum(dim=other)
        w_hi = wf.select(a, 1).sum(dim=other)
        m_lo = wsd.select(a, 0).sum(dim=other) / torch.clamp(w_lo, min=1.0)
        m_hi = wsd.select(a, 1).sum(dim=other) / torch.clamp(w_hi, min=1.0)
        corr = corr + torch.where((w_lo > 0) & (w_hi > 0),
                                  (w_hi / w_safe) * (m_hi - m_lo), 0.0)
    m_c = m_c - corr

    dev = (sd - m_c[:, :, None, :, None, :, None]) / half_voxel
    ssq_c = (ssq + wf * dev * dev).sum(dim=ax)
    rgb_c = (wf[..., None] * rgb).sum(dim=ax) / w_safe[..., None]
    occ = w_c > 0

    # coarse lane = cz*16 + cy*4 + cx (the reshape order)
    new = dict(
        sdf=torch.where(occ, m_c, 0.0),
        sumsq=torch.where(occ, ssq_c, 0.0),
        weight=torch.clamp(w_c, max=cfg.integration_weight_max).to(
            torch.int32),
        rgbp=pack_rgb(torch.floor(rgb_c + 0.5).to(torch.int32)
                      * occ[..., None].to(torch.int32)))
    vidx = (table.ptr[new_slots].to(torch.int64)[:, None]
            + torch.arange(P.TOTAL_LOW_BLOCK_SIZE, device=new_slots.device))
    for name, vals in new.items():
        getattr(pool, name).view(-1)[vidx.reshape(-1)] = vals.reshape(-1)


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
