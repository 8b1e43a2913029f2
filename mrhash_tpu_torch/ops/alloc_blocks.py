"""Block allocation: kernels K7-K9, their plain PyTorch twins, and the
choice between them.

K7 walks the allocation rays' block DDA and scatters each live candidate
into the salted dedup scratch, K8 compacts the scratch, K9 inserts the
served keys into the hash table (a lookup kernel and a one-CTA claim
kernel).  The CUDA source is csrc/alloc_blocks.cu; its header comment
gives the design.  They replace no TPU kernel: the JAX package allocates
with jnp ops.  Their twins are alloc_candidates_depth_ref and
alloc_candidates_points_ref (the ray setup and dda_visit), dedup_scatter,
dedup_compact and ops/hashtable.py's insert; every kernel equals its twin
bit for bit.

The module has one entry for each step, and each entry alone picks the
kernel or the twin (cuda_lib.on_card: CUDA tensors the kernel, CPU
tensors the twin, any other device raises): the walk
(alloc_candidates_depth, alloc_candidates_points), the dedup (dedup: the
scatter, where the walk did not fill the scratch, and the compaction)
and the insert (insert).  Both sides take and give the same formats: the
scratch holds i32 cells under a uint32 salt hashed once (dedup_scratch),
and the compaction returns the served keys with K8's stats, whose
stats[0] is their count, which the insert takes.

An allocation on the card is five launches (the scratch fill, K7, K8,
K9's two kernels) and one counted host read (insert's host_list of the
counts: the keys submitted, the heaps' new free counts).  The heap
counts go in as scalars and stay Python ints on the table.
utils/profiler.COUNTS counts the launches under "alloc_walk" (K7),
"alloc_scatter" (K7's scatter alone), "alloc_compact" (K8),
"alloc_lookup" and "alloc_insert" (K9).
"""
from __future__ import annotations

import dataclasses

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.utils.profiler import COUNTS, host_int, host_list, \
    nonzero

INF = float("inf")
MASK32 = 0xFFFFFFFF
SALT0 = 2654435761  # Knuth multiplicative constant
I32_MAX = (1 << 31) - 1
STATS = 4           # stats i32[4]: keys, high_count, low_count, unused


_p = cuda_lib.ptr


# ---------------------------------------------------------------------------
# the walk's twin: ray setup and the block DDA
# ---------------------------------------------------------------------------

def dda_visit(cfg: MapConfig, pw_min, pw_max, ray_valid, num_steps: int,
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
    seg_len = X.norm3(seg)
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


def alloc_candidates_depth_ref(cfg: MapConfig, cam: C.Camera, pc_depth,
                               num_steps: int, row0=0, frame=None):
    """The plain twin of kernel K7's depth walk: alloc_candidates_depth's
    keys and valid mask, in torch ops on any device."""
    if int(cfg.alloc_tile) > 1:
        keys, mask = dda_visit(
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
    blocks, mask = dda_visit(cfg, pw_min, pw_max, ray_valid, num_steps)
    return blocks.reshape(-1, 3), mask.reshape(-1)


def alloc_candidates_points_ref(cfg: MapConfig, cam: C.Camera, points,
                                num_steps: int, normals=None):
    """The plain twin of kernel K7's point walk: alloc_candidates_points'
    keys and valid mask, in torch ops on any device."""
    cam_dir, rng = X.unit(points)
    t = X.get_truncation(rng, cfg.sdf_truncation, cfg.sdf_truncation_scale)
    d_min = torch.clamp(rng - t, max=cfg.max_integration_distance)
    d_max = torch.clamp(rng + t, max=cfg.max_integration_distance)
    ray_valid = (rng != 0.0) & (d_min < d_max)
    walk_dir = cam_dir if cfg.projective_sdf else X.unit(normals)[0]
    pc_min = points + walk_dir * (d_min - rng)[..., None]
    pc_max = points + walk_dir * (d_max - rng)[..., None]
    blocks, mask = dda_visit(cfg, C.cam_to_world(cam, pc_min),
                             C.cam_to_world(cam, pc_max), ray_valid,
                             num_steps)
    return blocks.reshape(-1, 3), mask.reshape(-1)


# ---------------------------------------------------------------------------
# the dedup scratch and the dedup's twins
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DedupScratch:
    """A frame's salted dedup scratch: cells i32[S] holds each cell's
    highest candidate index, -1 where empty; salt is the dedup hash's
    uint32 salt."""
    cells: torch.Tensor
    salt: int


def dedup_scratch(cfg: MapConfig, frame: int, device):
    """The empty scratch of frame `frame`: max_alloc_per_frame x
    dedup_scratch_factor cells, the salt hashed from the frame."""
    n = int(cfg.max_alloc_per_frame) * int(cfg.dedup_scratch_factor)
    return DedupScratch(torch.full((n,), -1, dtype=torch.int32,
                                   device=device),
                        (int(frame) * SALT0) & MASK32)


def dedup_scatter(keys, valid, scratch: DedupScratch):
    """The salted scratch scatter of each valid candidate's index, in
    torch ops on any device (the twin of kernel K7's scatter).  Distinct
    keys colliding in a cell lose one candidate this frame; the per-frame
    salt rotates the losers (the reference's staggered lock-miss
    semantics, voxel_data_structures.cu:876).  Each cell keeps its highest
    candidate index (scatter "amax"; the reference's duplicate .set lets
    any writer win)."""
    x, y, z = (H.u32(keys[..., i]) for i in range(3))
    h = H._avalanche((H.mul32(x, P.P1) + scratch.salt) & MASK32)
    h = H._avalanche(h ^ H.mul32(y, P.P2))
    h = H._avalanche(h ^ H.mul32(z, P.P0))
    cell = h % int(scratch.cells.shape[0])
    vidx = nonzero(valid)
    scratch.cells.scatter_reduce_(0, cell[vidx], vidx.to(torch.int32),
                                  "amax")


def dedup_compact(keys, scratch: DedupScratch, u_max: int):
    """The twin of kernel K8, in torch ops on any device: (ukeys
    i32[n,3], stats i32[4]), the keys of the occupied scratch cells in
    cell order, at most u_max, and their count n in stats[0] (the rest
    0)."""
    sel = H.compact_indices(scratch.cells >= 0, u_max)
    stats = torch.zeros((STATS,), dtype=torch.int32, device=keys.device)
    stats[:1].fill_(sel.numel())
    return keys[scratch.cells[sel].long()], stats


# ---------------------------------------------------------------------------
# the kernels: validation and launch (CUDA operands only)
# ---------------------------------------------------------------------------

def _camera(cam, dev):
    e = cuda_lib.expect
    for name in ("fx", "fy", "cx", "cy"):
        e(getattr(cam, name), f"cam.{name}", torch.float32, (), dev)
    e(cam.rot, "cam.rot", torch.float32, (3, 3), dev)
    e(cam.trans, "cam.trans", torch.float32, (3,), dev)
    return [_p(cam.fx), _p(cam.fy), _p(cam.cx), _p(cam.cy), _p(cam.rot),
            _p(cam.trans)]


def _walk(cfg, mode, grid, rays, cam_ptrs, n_rays, num_steps, scratch,
          dev):
    """Launch K7 over n_rays rays; returns (keys i32[K*R,3], valid
    bool[K*R]) in the twin's step-major order."""
    m = int(num_steps) * int(n_rays)
    if m > I32_MAX:
        raise ValueError(f"allocation: {m} candidates overflow an int32 "
                         "candidate index")
    keys = torch.empty((m, 3), dtype=torch.int32, device=dev)
    valid = torch.empty((m,), dtype=torch.bool, device=dev)
    cells, n_cells, salt = None, 0, 0
    if scratch is not None:
        cuda_lib.expect(scratch.cells, "scratch", torch.int32, (None,), dev)
        cells, n_cells, salt = (_p(scratch.cells), scratch.cells.shape[0],
                                scratch.salt)
    ext = tuple(float(v) for v in cfg.voxel_extents)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_walk(
            mode, *grid, *rays, *cam_ptrs, float(cfg.sdf_truncation),
            float(cfg.sdf_truncation_scale),
            float(cfg.max_integration_distance),
            float(cfg.virtual_voxel_size), *ext, int(n_rays),
            int(num_steps), _p(keys), _p(valid), cells, n_cells, salt,
            cuda_lib.stream_of(keys))
    cuda_lib.check(rc, "alloc_walk")
    COUNTS["alloc_walk"] += 1
    return keys, valid


def _depth(pc_depth):
    if pc_depth.dtype != torch.float32 or pc_depth.dim() != 2:
        raise ValueError(f"pc_depth: {pc_depth.dtype}[{pc_depth.dim()}-d], "
                         "expected a 2-d torch.float32 image")
    return (_p(pc_depth), *pc_depth.stride())


def walk_depth(cfg, cam, pc_depth, num_steps: int, grid, row0: int = 0,
               scratch=None):
    """K7 over the pixel grid (s, py, px, Hs, Ws) of pc_depth f32[H,W]
    (any strides): the pixels (py + s*a, px + s*b), a < Hs, b < Ws, in
    row-major order, at image rows offset by row0; a pinhole camera.
    With `scratch` (dedup_scratch) each live candidate scatters its index
    under the scratch's salt."""
    s, py, px, hs, ws = grid
    h, w = pc_depth.shape
    if min(py, px) < 0 or py + s * (hs - 1) >= h or px + s * (ws - 1) >= w:
        raise ValueError(f"walk_depth: grid {grid} outside a {h}x{w} image")
    return _walk(cfg, 0, (*_depth(pc_depth), s, py, px, ws, int(row0), h, w,
                          0), (None, None), _camera(cam, pc_depth.device),
                 hs * ws, num_steps, scratch, pc_depth.device)


def walk_tiles(cfg, cam, pc_depth, num_steps: int, frame: int,
               row0: int = 0, scratch=None):
    """K7 over the cfg.alloc_tile = s tiles of pc_depth f32[H,W] (any
    strides; zero-padded to whole tiles), one ray a tile through its
    pixel ((frame // 2) % s^2 in row-major order) and the near band on
    even frames, the far band on odd ones (_tile_segments); a pinhole
    camera.  `scratch` as walk_depth's."""
    s = int(cfg.alloc_tile)
    h, w = pc_depth.shape
    ht, wt = -(-h // s), -(-w // s)
    phase = (int(frame) // 2) % (s * s)
    return _walk(cfg, 2, (*_depth(pc_depth), s, phase // s, phase % s, wt,
                          int(row0), h, w, int(frame) % 2),
                 (None, None), _camera(cam, pc_depth.device), ht * wt,
                 num_steps, scratch, pc_depth.device)


def walk_points(cfg, cam, points, normals, num_steps: int, scratch=None):
    """K7 over LiDAR points f32[N,3] (camera frame), along the camera rays
    or, given normals f32[N,3], along the normals."""
    dev = points.device
    n = points.shape[0]
    e = cuda_lib.expect
    e(points, "points", torch.float32, (n, 3), dev)
    if normals is not None:
        e(normals, "normals", torch.float32, (n, 3), dev)
    return _walk(cfg, 1, (None, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0),
                 (_p(points), None if normals is None else _p(normals)),
                 _camera(cam, dev), n, num_steps, scratch, dev)


def scatter(keys, valid, scratch: DedupScratch):
    """K7's scatter alone: each valid candidate of keys i32[M,3] scatters
    its index into its salted cell of the scratch."""
    dev = keys.device
    m = keys.shape[0]
    e = cuda_lib.expect
    e(keys, "keys", torch.int32, (m, 3), dev)
    e(valid, "valid", torch.bool, (m,), dev)
    e(scratch.cells, "scratch", torch.int32, (None,), dev)
    if m > I32_MAX:
        raise ValueError("allocation: too many candidates")
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_scatter(
            _p(keys), _p(valid), m, _p(scratch.cells),
            scratch.cells.shape[0], scratch.salt, cuda_lib.stream_of(keys))
    cuda_lib.check(rc, "alloc_scatter")
    COUNTS["alloc_scatter"] += 1


def compact(keys, scratch: DedupScratch, u_max: int):
    """K8: the keys of the occupied scratch cells in cell order, at most
    u_max.  Returns (ukeys i32[u_max,3], stats i32[4]) with the count in
    stats[0], both on the card (rows past the count are not written)."""
    dev = keys.device
    e = cuda_lib.expect
    e(scratch.cells, "scratch", torch.int32, (None,), dev)
    e(keys, "keys", torch.int32, (None, 3), dev)
    ukeys = torch.empty((int(u_max), 3), dtype=torch.int32, device=dev)
    stats = torch.empty((STATS,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_compact(
            _p(scratch.cells), scratch.cells.shape[0], _p(keys), int(u_max),
            _p(ukeys), _p(stats), cuda_lib.stream_of(keys))
    cuda_lib.check(rc, "alloc_compact")
    COUNTS["alloc_compact"] += 1
    return ukeys, stats


def insert_launch(table, keys, res, stats=None):
    """K9's two launches without the host read (CUDA-graph safe): the
    checks, the outputs, the launches.  Arguments as insert's.  Returns
    (info, stats): stats i32[4] gets the key count and the heaps' new
    free counts on the card."""
    dev = keys.device
    n_max = keys.shape[0]
    e = cuda_lib.expect
    e(keys, "keys", torch.int32, (n_max, 3), dev)
    res_const = 0
    if torch.is_tensor(res):
        e(res, "res", torch.int32, (n_max,), dev)
    else:
        res_const, res = int(res), None
    cap = table.capacity
    e(table.pos, "table.pos", torch.int32, (cap, 3), dev)
    for name in ("ptr", "res", "fp"):
        e(getattr(table, name), f"table.{name}", torch.int32, (cap,), dev)
    e(table.heap_high, "table.heap_high", torch.int32, (None,), dev)
    e(table.heap_low, "table.heap_low", torch.int32, (None,), dev)
    if stats is None:
        stats = torch.empty((STATS,), dtype=torch.int32, device=dev)
        n_dev = None
    else:
        e(stats, "stats", torch.int32, (STATS,), dev)
        n_dev = _p(stats)
    p2 = 1
    while p2 < n_max:
        p2 <<= 1
    info = dict(slot=torch.empty((n_max,), dtype=torch.int64, device=dev),
                ptr=torch.empty((n_max,), dtype=torch.int32, device=dev),
                res=torch.empty((n_max,), dtype=torch.int32, device=dev),
                was_new=torch.empty((n_max,), dtype=torch.bool, device=dev),
                present=torch.empty((n_max,), dtype=torch.bool, device=dev))
    sorted_ws = torch.empty((p2,), dtype=torch.int64, device=dev)
    ws32 = torch.empty((3 * n_max,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_insert(
            _p(keys), n_dev, n_max, n_max,
            None if res is None else _p(res), res_const,
            table.num_buckets, cap, _p(table.pos), _p(table.ptr),
            _p(table.res), _p(table.fp), _p(table.heap_high),
            table.heap_high.shape[0], table.high_count,
            _p(table.heap_low), table.heap_low.shape[0], table.low_count,
            _p(info["slot"]), _p(info["ptr"]), _p(info["res"]),
            _p(info["was_new"]), _p(info["present"]), _p(sorted_ws),
            _p(ws32), _p(stats), cuda_lib.stream_of(keys))
    cuda_lib.check(rc, "alloc_insert")
    COUNTS["alloc_lookup"] += n_max > 0
    COUNTS["alloc_insert"] += 1
    return info, stats


# ---------------------------------------------------------------------------
# the entries: kernel or twin
# ---------------------------------------------------------------------------

def alloc_candidates_depth(cfg: MapConfig, cam: C.Camera, pc_depth,
                           num_steps: int, row0=0, frame=None, scratch=None):
    """allocBlocksKernel (voxel_data_structures.cu:757-857): per-pixel ray
    through the truncation band [d-t, d+t].  cfg.alloc_tile > 1 takes the
    tile path; otherwise cfg.alloc_pixel_stride = s > 1 (with a frame
    counter) walks every s-th pixel, phase-rotated per frame.  Returns flat
    candidate keys i32[M,3] + valid mask bool[M].  With `scratch`
    (dedup_scratch) each valid candidate also scatters into it.  CPU
    tensors take the twin (alloc_candidates_depth_ref, then
    dedup_scatter); CUDA tensors kernel K7, which fuses the ray setup of
    either path, the walk and the scatter (a pinhole camera)."""
    if not cuda_lib.on_card(pc_depth.device):
        keys, valid = alloc_candidates_depth_ref(cfg, cam, pc_depth,
                                                 num_steps, row0, frame)
        if scratch is not None:
            dedup_scatter(keys, valid, scratch)
        return keys, valid
    if cam.model != C.PINHOLE:
        raise ValueError("alloc_candidates_depth: kernel K7 walks pinhole "
                         "depth images only")
    if int(cfg.alloc_tile) > 1:
        return walk_tiles(cfg, cam, pc_depth, num_steps,
                          0 if frame is None else int(frame), int(row0),
                          scratch)
    return walk_depth(cfg, cam, pc_depth, num_steps,
                      _pixel_grid(cfg, pc_depth.shape, frame), int(row0),
                      scratch)


def alloc_candidates_points(cfg: MapConfig, cam: C.Camera, points,
                            num_steps: int, normals=None, scratch=None):
    """allocBlocks3DKernel (voxel_data_structures.cu:924-1033): per-LiDAR-
    point DDA through the band [r-t, r+t] of the range, along the camera
    ray (cfg.projective_sdf) or along the normal (normals f32[N,3], unit
    or zero: a zero normal walks the degenerate segment at the point, as
    the reference).  points f32[N,3] in the camera frame; a zero point (no
    return) walks nothing.  No frustum filter (matches the 3D kernel).
    Returns flat candidate keys i32[M,3] + valid mask bool[M].  `scratch`
    and the choice as alloc_candidates_depth's: the twin
    (alloc_candidates_points_ref) for CPU tensors, kernel K7 for CUDA
    tensors."""
    if not cuda_lib.on_card(points.device):
        keys, valid = alloc_candidates_points_ref(cfg, cam, points,
                                                  num_steps, normals)
        if scratch is not None:
            dedup_scatter(keys, valid, scratch)
        return keys, valid
    return walk_points(cfg, cam, points,
                       None if cfg.projective_sdf else normals, num_steps,
                       scratch)


def dedup(cfg: MapConfig, keys, valid, frame: int, scratch=None):
    """One representative per distinct valid key of keys i32[M,3]: the
    salted scratch scatter, then the compaction.  `scratch`, given, is the
    frame's scratch that the walk already filled (alloc_candidates_*(...,
    scratch=)); else frame `frame`'s is made and filled here.  Returns
    (ukeys i32[u,3], stats i32[4]): the winners in scratch-cell order, at
    most cfg.max_alloc_per_frame, in the first stats[0] rows of ukeys
    (the rest are not written; on the CPU there is no rest).  CUDA
    tensors take kernel K7's scatter and K8, CPU tensors dedup_scatter and
    dedup_compact."""
    card = cuda_lib.on_card(keys.device)
    if scratch is None:
        scratch = dedup_scratch(cfg, frame, keys.device)
        (scatter if card else dedup_scatter)(keys, valid, scratch)
    return (compact if card else dedup_compact)(
        keys, scratch, int(cfg.max_alloc_per_frame))


def insert(table: H.HashTable, keys, res, stats=None):
    """Batched allocBlock (voxel_data_structures.cu:501-755), updating
    `table` in place with the semantics of hashtable.insert, the twin.
    keys i32[U,3]; res i32[U] or one int for every key; stats, given, is
    dedup's i32[4], whose stats[0] holds how many rows of keys are real
    (the rest are not read).  CUDA tensors take kernel K9 and one counted
    host read: the key count and the heaps' new free counts, which set
    table.high_count and table.low_count.  CPU tensors take the twin.

    Returns info dict(slot i64, ptr i32, res i32, was_new bool, present
    bool) per row of keys (on a card rows past the count not written) and
    info["count"], the real rows (a host int)."""
    if cuda_lib.on_card(keys.device):
        if torch.is_tensor(res):
            res = res.to(torch.int32).contiguous()
        info, stats = insert_launch(table, keys.to(torch.int32).contiguous(),
                                    res, stats)
        info["count"], table.high_count, table.low_count, _ = \
            host_list(stats)
        return info
    n = keys.shape[0] if stats is None else host_int(stats[0])
    if not torch.is_tensor(res):
        res = torch.full((n,), int(res), dtype=torch.int32,
                         device=keys.device)
    info = H.insert(table, keys[:n], res[:n])
    info["count"] = n
    return info
