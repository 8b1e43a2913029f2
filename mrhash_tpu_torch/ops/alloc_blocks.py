"""Kernels K7-K9: block allocation on the card.

K7 walks the allocation rays' block DDA and scatters each live candidate
into the salted dedup scratch, K8 compacts the scratch, K9 inserts the
served keys into the hash table (a lookup kernel and a one-CTA claim
kernel).  The CUDA source is csrc/alloc_blocks.cu; its header comment
gives the design.  They replace no TPU kernel: the JAX package allocates
with jnp ops.  Their plain PyTorch twins are ops/integrate.py's
alloc_candidates_depth_ref, alloc_candidates_points_ref, dedup_scatter
and dedup_compact, and ops/hashtable.py's insert_ref; every kernel equals
its twin bit for bit.

An allocation round on the card is five launches (the scratch fill, K7,
K8, K9's two kernels) and one counted host read (`insert`'s host_list of
the round's counts: the keys submitted, the heaps' new free counts).  The
heap counts go in as scalars and stay Python ints on the table.

ops/integrate.py and ops/hashtable.py dispatch on the device (on_card):
the twins for CPU tensors, these wrappers for CUDA tensors, and neither
for another device.  utils/profiler.COUNTS counts the launches under
"alloc_walk" (K7), "alloc_scatter" (K7's scatter alone, for the rounds
after the first), "alloc_compact" (K8), "alloc_lookup" and
"alloc_insert" (K9).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS, host_list

MASK32 = 0xFFFFFFFF
SALT0 = 2654435761  # Knuth multiplicative constant
I32_MAX = (1 << 31) - 1
STATS = 4           # stats i32[4]: keys, high_count, low_count, unused


_p = cuda_lib.ptr


def on_card(device) -> bool:
    """True for a CUDA device (the kernels), False for the CPU (the
    twins); raises for any other."""
    dev = torch.device(device)
    if dev.type in ("cuda", "cpu"):
        return dev.type == "cuda"
    raise ValueError(f"allocation: no kernel or twin for {dev}")


def salt32(frame_salt: int) -> int:
    """The dedup hash's uint32 salt of a round's frame salt."""
    return (int(frame_salt) * SALT0) & MASK32


def new_scratch(n_cells: int, device):
    """The dedup scratch of one round on the card: i32[n_cells], -1
    (empty)."""
    return torch.full((n_cells,), -1, dtype=torch.int32, device=device)


def _camera(cam, dev):
    e = cuda_lib.expect
    for name in ("fx", "fy", "cx", "cy"):
        e(getattr(cam, name), f"cam.{name}", torch.float32, (), dev)
    e(cam.rot, "cam.rot", torch.float32, (3, 3), dev)
    e(cam.trans, "cam.trans", torch.float32, (3,), dev)
    return [_p(cam.fx), _p(cam.fy), _p(cam.cx), _p(cam.cy), _p(cam.rot),
            _p(cam.trans)]


def _walk(cfg, mode, grid, rays, cam_ptrs, n_rays, num_steps, scratch,
          salt, dev):
    """Launch K7 over n_rays rays; returns (keys i32[K*R,3], valid
    bool[K*R]) in the twin's step-major order."""
    m = int(num_steps) * int(n_rays)
    if m > I32_MAX:
        raise ValueError(f"allocation: {m} candidates overflow an int32 "
                         "candidate index")
    keys = torch.empty((m, 3), dtype=torch.int32, device=dev)
    valid = torch.empty((m,), dtype=torch.bool, device=dev)
    n_cells = 0
    if scratch is not None:
        cuda_lib.expect(scratch, "scratch", torch.int32, (None,), dev)
        n_cells = scratch.shape[0]
    ext = tuple(float(v) for v in cfg.voxel_extents)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_walk(
            mode, *grid, *rays, *cam_ptrs, float(cfg.sdf_truncation),
            float(cfg.sdf_truncation_scale),
            float(cfg.max_integration_distance),
            float(cfg.virtual_voxel_size), *ext, int(n_rays),
            int(num_steps), _p(keys), _p(valid),
            None if scratch is None else _p(scratch), n_cells, salt,
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
               scratch=None, salt: int = 0):
    """K7 over the pixel grid (s, py, px, Hs, Ws) of pc_depth f32[H,W]
    (any strides): the pixels (py + s*a, px + s*b), a < Hs, b < Ws, in
    row-major order, at image rows offset by row0; a pinhole camera.
    With `scratch` (new_scratch) each live candidate scatters its index
    under the uint32 `salt`."""
    s, py, px, hs, ws = grid
    h, w = pc_depth.shape
    if min(py, px) < 0 or py + s * (hs - 1) >= h or px + s * (ws - 1) >= w:
        raise ValueError(f"walk_depth: grid {grid} outside a {h}x{w} image")
    return _walk(cfg, 0, (*_depth(pc_depth), s, py, px, ws, int(row0), h, w,
                          0), (None, None), _camera(cam, pc_depth.device),
                 hs * ws, num_steps, scratch, salt, pc_depth.device)


def walk_tiles(cfg, cam, pc_depth, num_steps: int, frame: int,
               row0: int = 0, scratch=None, salt: int = 0):
    """K7 over the cfg.alloc_tile = s tiles of pc_depth f32[H,W] (any
    strides; zero-padded to whole tiles), one ray a tile through its
    pixel ((frame // 2) % s^2 in row-major order) and the near band on
    even frames, the far band on odd ones (integrate._tile_segments); a
    pinhole camera.  `scratch` and `salt` as walk_depth's."""
    s = int(cfg.alloc_tile)
    h, w = pc_depth.shape
    ht, wt = -(-h // s), -(-w // s)
    phase = (int(frame) // 2) % (s * s)
    return _walk(cfg, 2, (*_depth(pc_depth), s, phase // s, phase % s, wt,
                          int(row0), h, w, int(frame) % 2),
                 (None, None), _camera(cam, pc_depth.device), ht * wt,
                 num_steps, scratch, salt, pc_depth.device)


def walk_points(cfg, cam, points, normals, num_steps: int, scratch=None,
                salt: int = 0):
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
                 _camera(cam, dev), n, num_steps, scratch, salt, dev)


def scatter(keys, valid, scratch, salt: int):
    """K7's scatter alone: each valid candidate of keys i32[M,3] scatters
    its index into its salted cell of scratch i32[S]."""
    dev = keys.device
    m = keys.shape[0]
    e = cuda_lib.expect
    e(keys, "keys", torch.int32, (m, 3), dev)
    e(valid, "valid", torch.bool, (m,), dev)
    e(scratch, "scratch", torch.int32, (None,), dev)
    if m > I32_MAX:
        raise ValueError("allocation: too many candidates")
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_scatter(
            _p(keys), _p(valid), m, _p(scratch), scratch.shape[0], salt,
            cuda_lib.stream_of(keys))
    cuda_lib.check(rc, "alloc_scatter")
    COUNTS["alloc_scatter"] += 1


def compact(scratch, keys, u_max: int):
    """K8: the keys of the occupied scratch cells in cell order, at most
    u_max.  Returns (ukeys i32[u_max,3], stats i32[4]) with the count in
    stats[0], both on the card (rows past the count are not written)."""
    dev = keys.device
    e = cuda_lib.expect
    e(scratch, "scratch", torch.int32, (None,), dev)
    e(keys, "keys", torch.int32, (None, 3), dev)
    ukeys = torch.empty((int(u_max), 3), dtype=torch.int32, device=dev)
    stats = torch.empty((STATS,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_alloc_compact(
            _p(scratch), scratch.shape[0], _p(keys), int(u_max), _p(ukeys),
            _p(stats), cuda_lib.stream_of(keys))
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


def insert(table, keys, res, stats=None):
    """K9: hashtable.insert_ref's semantics on the card, updating `table`
    in place.  keys i32[n,3]; res i32[n] or one int for every key; stats,
    given, is compact's i32[4], whose stats[0] holds how many rows of keys
    are real (the rest are not read).  One counted host read: the key
    count and the heaps' new free counts, which set table.high_count and
    table.low_count.  Returns (info, count): info dict(slot i64, ptr i32,
    res i32, was_new bool, present bool) per row of keys (rows past the
    count not written), count the real rows."""
    info, stats = insert_launch(table, keys, res, stats)
    count, table.high_count, table.low_count, _ = host_list(stats)
    return info, count
