"""Marching-cubes iso-surface extraction (Transvoxel tables) on the device.

Port of mrhash_tpu/ops/meshing.py: MarchingCubesExtractor
(mrhash/src/sdf/marching_cubes.{cuh,cu}) and the mixed-resolution trilinear
interpolation it samples (voxel_data_structures.cu:260-338), as plain torch
ops (the reference is XLA outside any Pallas kernel).

Two phases, as the reference: a cheap corner-weight gate over every (block,
voxel) cell of a block window, then the full trilinear + table lookup on
the gated cells, in batches of at most `max_cells`.  Every point lookup of
the sweep goes through the window's 27-ring cache (`build_ring`), which
resolves the 1-ring of each window block once: one hash lookup (and its
one device sync) per window instead of one per query.

Unlike the reference, batches hold exactly the gated cells (one `nonzero`
per window, no padded rank buffer) and the triangles compact with a
boolean mask, so no triangle is ever dropped: the reference's fixed
`max_triangles` buffer truncates a batch whose cells emit more than
max_triangles / max_cells triangles each (PORT_NOTES.md P46).
"""
from __future__ import annotations

import functools

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, VoxelPool, unpack_rgb
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import transvoxel as TV
from mrhash_tpu_torch.ops.integrate import _block_rows

TRIS_PER_CELL = 5     # the most triangles a regular Transvoxel cell emits


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The Transvoxel tables, cube corners and 27-ring offsets as tensors
    on `device`, built once per device."""
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        cell_class=torch.tensor(TV.REGULAR_CELL_CLASS, **i32),
        cell_geom=torch.tensor(TV.REGULAR_CELL_GEOMETRY, **i32),
        cell_vidx=torch.tensor(TV.REGULAR_CELL_VERTEX_INDEX,
                               **i32).to(torch.int64),         # [16,15]
        vertex_data=torch.tensor(TV.REGULAR_VERTEX_DATA, **i32),  # [256,12]
        # cube corner k: bit0 -> +x, bit1 -> +y, bit2 -> +z
        # (marching_cubes.cu:85-157, cube_index += 1 << k)
        corner=torch.tensor([[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1]
                             for k in range(8)], dtype=torch.float32,
                            device=device),
        # 27-neighbourhood offsets, index = (dz+1)*9 + (dy+1)*3 + (dx+1)
        off27=torch.tensor([[dx, dy, dz] for dz in (-1, 0, 1)
                            for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                           **i32))


def build_ring(cfg: MapConfig, table: H.HashTable, bpos):
    """27-neighbour lookup cache of a block window: (found, ptr, res) of
    every window block's 1-ring, resolved once, so the sweep answers its
    point -> block lookups with index arithmetic and one gather.  Every
    point the sweep probes lies within +-6 fine voxels of its cell's block
    (less than the 8-voxel block side), so the 1-ring bounds every lookup.

    Returns dict(found bool[A*27], ptr i32[A*27], res i32[A*27])."""
    off27 = _tables(bpos.device)["off27"]
    keys = (bpos[:, None, :] + off27[None, :, :]).reshape(-1, 3)
    found, _, ptr, res = H.lookup(table, keys)
    return dict(found=found, ptr=ptr, res=res)


def _ring_resolve(ctx, blk):
    """(found, ptr, res) of block keys `blk` [...,3] through the ring.
    ctx = (ring, bpos_window[A,3], cell_blk) where cell_blk (int64,
    broadcastable to blk.shape[:-1]) is the window row that owns each query
    point.  Keys beyond the 1-ring resolve to found=False."""
    ring, bposw, cell_blk = ctx
    rel = blk - bposw[cell_blk]
    inb = (rel.abs() <= 1).all(dim=-1)
    nidx = ((rel[..., 2] + 1) * 9 + (rel[..., 1] + 1) * 3
            + (rel[..., 0] + 1))
    ridx = torch.where(inb, cell_blk * 27 + nidx, 0)
    found = ring["found"][ridx] & inb
    safe = torch.where(found, ridx, 0)
    return found, ring["ptr"][safe], ring["res"][safe]


def _resolve(cfg: MapConfig, table: H.HashTable, pos, ctx):
    """The owning block of each world point: (virtual voxel i32[...,3],
    found, ptr, res), through the ring when `ctx` is given, else through
    one hash lookup."""
    vvs = cfg.virtual_voxel_size
    pi = X.world_point_to_virtual_voxel_pos(
        X.on_device(float(vvs), pos.device), pos)
    blk = X.virtual_voxel_pos_to_sdf_block(
        pi, vvs, X.on_device(tuple(cfg.voxel_extents), pos.device))
    if ctx is not None:
        found, ptr, res = _ring_resolve(ctx, blk)
        return pi, found, ptr, res
    shape = pi.shape[:-1]
    found, _, ptr, res = H.lookup(table, blk.reshape(-1, 3))
    return pi, found.reshape(shape), ptr.reshape(shape), res.reshape(shape)


def get_voxel(cfg: MapConfig, table: H.HashTable, pool: VoxelPool, pos,
              ctx=None):
    """getVoxel(world) (voxel_data_structures.cu:162-205): the nearest
    virtual voxel's stored value at the owning block's resolution.

    pos f32[...,3]; ctx: optional ring context (see _ring_resolve).
    Returns (sdf f32, weight i32, rgb f32[...,3] in 0-255, res i32, found
    bool), each of pos's leading shape; zeros where the block is not
    allocated."""
    pi, found, ptr, res = _resolve(cfg, table, pos, ctx)
    ptr = ptr.to(torch.int64)
    scale = torch.ones_like(res) << res
    local = torch.remainder(pi, P.SDF_BLOCK_SIZE) // scale[..., None]
    side = P.SDF_BLOCK_SIZE // scale
    lane = (local[..., 2] * side * side + local[..., 1] * side
            + local[..., 0])
    vidx = torch.where(found, ptr + lane, 0)
    sdf = torch.where(found, pool.sdf.reshape(-1)[vidx], 0.0)
    w = torch.where(found, pool.weight.reshape(-1)[vidx], 0)
    rgb = torch.where(found[..., None],
                      unpack_rgb(pool.rgbp.reshape(-1)[vidx]).to(
                          torch.float32), 0.0)
    return sdf, w, rgb, torch.where(found, res, 0), found


def get_voxel_size(cfg: MapConfig, table: H.HashTable, pos, ctx=None):
    """getVoxelSize(world) (voxel_data_structures.cu:226-240): vvs * 2^res
    of the owning block (res 0 if unallocated).  Returns (size f32, res
    i32)."""
    _, found, _, res = _resolve(cfg, table, pos, ctx)
    res = torch.where(found, res, 0)
    return (cfg.virtual_voxel_size
            * (torch.ones_like(res) << res).to(torch.float32)), res


def trilinear_interpolation(cfg: MapConfig, table: H.HashTable,
                            pool: VoxelPool, pos, ctx=None):
    """trilinearInterpolation (voxel_data_structures.cu:260-338): 8-corner
    blend at the local voxel size, with coarse-neighbour SDF blending across
    resolution boundaries.  pos f32[...,3] -> (dist, valid).

    As the reference, the base resolution is the true owning block's: the
    CUDA original re-derives it from block coordinates computed with the
    scaled voxel size (voxel_data_structures.cu:264), which for a coarse
    block addresses another key space (the reference's documented
    deviation, DESIGN.md)."""
    corner = _tables(pos.device)["corner"]
    vs, base_res = get_voxel_size(cfg, table, pos, ctx)
    vsn = vs[..., None]
    pos_dual = pos - 0.5 * vsn
    pos_sdf = get_voxel(cfg, table, pool, pos_dual, ctx)[0]

    sdf = []
    valid = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    p_max = pos_dual
    for k in range(8):
        vp = pos_dual + corner[k] * vsn
        v_sdf, v_w, _, v_res, _ = get_voxel(cfg, table, pool, vp, ctx)
        valid = valid & (v_w > 0)
        # resolution boundary: blend with the coarse sample
        nvs = vsn * 2.0
        nvp = pos - 0.5 * nvs + corner[k] * nvs
        c_sdf = get_voxel(cfg, table, pool, nvp, ctx)[0]
        blend = 0.5 * pos_sdf + 0.5 * c_sdf
        sdf.append(torch.where(v_res > base_res, blend, v_sdf))
        p_max = torch.maximum(p_max, vp)

    x0 = pos_dual
    span = p_max - x0
    big = span > 1e-6
    delta = torch.where(big, (pos - x0) / torch.where(big, span, 1.0), 0.5)
    dx, dy, dz = delta[..., 0], delta[..., 1], delta[..., 2]
    s = sdf
    dist = (s[0]
            + (s[1] - s[0]) * dx
            + (s[2] - s[0]) * dy
            + (s[4] - s[0]) * dz
            + (s[3] - s[2] - s[1] + s[0]) * dx * dy
            + (s[6] - s[4] - s[2] + s[0]) * dy * dz
            + (s[5] - s[4] - s[1] + s[0]) * dx * dz
            + (s[7] - s[6] - s[5] - s[3] + s[1] + s[4] + s[2] - s[0])
            * dx * dy * dz)
    return dist, valid


def _check_vertex_voxels(cfg, table, pf, vs, scaled_p, scaled_m, ctx=None):
    """checkVertexVoxels (marching_cubes.cu:6-69): shrink the corner offsets
    by 0.499 on the axes whose +-half-voxel neighbour lives at another
    resolution."""
    def probe(p):
        nvs, _ = get_voxel_size(cfg, table, p, ctx)
        return (nvs > 0) & (nvs < 1.0) & (nvs != vs)

    scaled_p, scaled_m = scaled_p.clone(), scaled_m.clone()
    for axis in range(3):
        pp, pm = pf.clone(), pf.clone()
        pp[..., axis] = pf[..., axis] + scaled_p[..., axis]
        pm[..., axis] = pf[..., axis] + scaled_m[..., axis]
        shrink_p, shrink_m = probe(pp), probe(pm)
        scaled_p[..., axis] *= torch.where(shrink_p, 0.499, 1.0)
        scaled_m[..., axis] *= torch.where(shrink_m, 0.499, 1.0)
    return scaled_p, scaled_m


def _vertex_interp(p1, p2, d1, d2, c1, c2):
    """vertexInterp (mesh_extractor.cu:5-37), with the colour blend done
    consistently in 0-255 (the CUDA original mixes /255 scales; the
    reference's documented deviation, DESIGN.md).  Returns (pos, color)."""
    iso = 0.0
    den = d2 - d1
    mu = (iso - d1) / torch.where(den == 0, 1.0, den)
    use_p1 = ((iso - d1).abs() < 1e-5) | ((d1 - d2).abs() < 1e-5)
    use_p2 = ((iso - d2).abs() < 1e-5) & ~use_p1
    mu = torch.where(use_p1, 0.0, torch.where(use_p2, 1.0, mu))[..., None]
    return p1 + mu * (p2 - p1), c1 + mu * (c2 - c1)


def cell_gate(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
              bpos, bptr, bres, ring=None):
    """Phase A: for each (block, voxel) cell of the window, does any of its
    8 cube corners land in a weighted voxel?  A cell whose corners all
    have weight 0 emits no geometry (extractIsoSurfaceAtPosition rejects on
    weight).  Cells are in the row layout of the reference: a res-1
    block's 64 cells at lanes [ptr % 512, ptr % 512 + 64).

    Returns (pf f32[A,512,3] cell centres, gate bool[A,512])."""
    vvs = cfg.virtual_voxel_size
    corner = _tables(bpos.device)["corner"]
    _, lane0 = _block_rows(bptr)
    pi, lane_valid = X.block_voxel_grid(bpos, bres, lane0)
    pf = X.virtual_voxel_pos_to_world(vvs, pi)
    vs = (vvs * (torch.ones_like(bres) << bres).to(torch.float32))[:, None,
                                                                     None]
    ctx = None
    if ring is not None:
        ctx = (ring, bpos, torch.arange(bpos.shape[0],
                                        device=bpos.device)[:, None])
    gate = torch.zeros(pf.shape[:-1], dtype=torch.bool, device=pf.device)
    for k in range(8):
        vp = pf + (corner[k] - 0.5) * vs    # corners at pf +- vs/2
        gate = gate | (get_voxel(cfg, table, pool, vp, ctx)[1] > 0)
    return pf, gate & lane_valid


def compact_cells(pf, cells, max_cells: int, offset: int = 0):
    """The centres of gated cells [offset, offset + max_cells), given the
    flat indices of every gated cell in window order (`gate_cells`), and
    the window row of each (which addresses the window's ring).  Returns
    (cpf f32[n,3], cblk i64[n]), n <= max_cells."""
    sel = cells[offset:offset + max_cells]
    return pf.reshape(-1, 3)[sel], sel // pf.shape[1]


def extract_cells(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                  pf, ctx=None):
    """Phase B: extractIsoSurfaceAtPosition (marching_cubes.cu:71-261) on
    the compacted cells pf f32[Cc,3].  Returns (tri_pos f32[Cc,5,3,3],
    tri_col f32[Cc,5,3,3], tri_mask bool[Cc,5]).  ctx: the ring context of
    the cells' window."""
    tab = _tables(pf.device)
    corner = tab["corner"]
    Cc = pf.shape[0]
    vs, _ = get_voxel_size(cfg, table, pf, ctx)
    half = (0.5 * vs)[:, None].repeat(1, 3)
    scaled_p, scaled_m = _check_vertex_voxels(cfg, table, pf, vs, half,
                                              -half, ctx)

    # 8 corners: positions, trilinear distances (raw voxel sdf where the
    # trilinear is invalid), colours, validity
    dists, cols, ppos = [], [], []
    ok = torch.ones(Cc, dtype=torch.bool, device=pf.device)
    for k in range(8):
        sel = corner[k]
        p_k = pf + (sel * scaled_p + (1.0 - sel) * scaled_m)
        ppos.append(p_k)
        dist, tri_ok = trilinear_interpolation(cfg, table, pool, p_k, ctx)
        v_sdf, v_w, v_rgb, _, _ = get_voxel(cfg, table, pool, p_k, ctx)
        dists.append(torch.where(tri_ok, dist, v_sdf))
        ok = ok & (tri_ok | (v_w >= cfg.min_weight_threshold))
        cols.append(v_rgb)

    d = torch.stack(dists, dim=-1)                     # [Cc,8]
    cube_index = torch.zeros(Cc, dtype=torch.int64, device=pf.device)
    for k in range(8):
        cube_index = cube_index + torch.where(d[:, k] < 0.0, 1 << k, 0)

    # SDF-consistency filters (marching_cubes.cu:181-201)
    thr = cfg.marching_cubes_threshold
    dk, dl = d[:, :, None], d[:, None, :]
    bad = torch.where(dk * dl < 0.0, dk.abs() + dl.abs() > thr,
                      (dk - dl).abs() > thr)
    ok = ok & ~bad.any(dim=2).any(dim=1) & ~(d.abs() > thr).any(dim=1)

    cls = tab["cell_class"][cube_index].to(torch.int64)       # [Cc]
    tri_count = tab["cell_geom"][cls] & 0x0F
    edge_codes = (tab["vertex_data"][cube_index] & 0xFF).to(torch.int64)
    c_lo, c_hi = edge_codes & 0x0F, edge_codes >> 4           # [Cc,12]

    pos8 = torch.stack(ppos, dim=1)                    # [Cc,8,3]
    col8 = torch.stack(cols, dim=1)

    def take(t8, idx):
        return torch.gather(t8, 1, idx[..., None].expand(-1, -1, 3))

    vpos, vcol = _vertex_interp(take(pos8, c_hi), take(pos8, c_lo),
                                torch.gather(d, 1, c_hi),
                                torch.gather(d, 1, c_lo),
                                take(col8, c_hi), take(col8, c_lo))
    vidx = tab["cell_vidx"][cls]                       # [Cc,15]
    tri_pos = take(vpos, vidx).reshape(Cc, TRIS_PER_CELL, 3, 3)
    tri_col = take(vcol, vidx).reshape(Cc, TRIS_PER_CELL, 3, 3)
    tri_mask = ((torch.arange(TRIS_PER_CELL, device=pf.device)[None, :]
                 < tri_count[:, None]) & ok[:, None])
    return tri_pos, tri_col, tri_mask


def compact_triangles(tri_pos, tri_col, tri_mask):
    """Every emitted triangle, in cell order (the append of
    appendTriangle, mesh_extractor.cu:44-55, without a capacity): one
    `nonzero` (one device sync).  Returns (pos f32[T,3,3], col
    f32[T,3,3])."""
    sel = torch.nonzero(tri_mask.reshape(-1)).flatten()
    return tri_pos.reshape(-1, 3, 3)[sel], tri_col.reshape(-1, 3, 3)[sel]


def gate_cells(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
               bpos, bptr, bres):
    """Phase A once per block window: cell centres, gate, the flat indices
    of the gated cells in window order (one device sync), and the window's
    27-ring lookup cache, which every phase-B batch reuses."""
    ring = build_ring(cfg, table, bpos)
    pf, gate = cell_gate(cfg, table, pool, bpos, bptr, bres, ring=ring)
    return pf, gate, torch.nonzero(gate.reshape(-1)).flatten(), ring


def extract_cell_batch(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                       pf, cells, offset: int, max_cells: int, ring=None,
                       bpos=None):
    """Phase B on the gated cells [offset, offset + max_cells): every
    triangle they emit.  Returns (pos f32[T,3,3], col f32[T,3,3])."""
    cpf, cblk = compact_cells(pf, cells, max_cells, offset)
    ctx = (ring, bpos, cblk) if ring is not None else None
    return compact_triangles(*extract_cells(cfg, table, pool, cpf, ctx))


def extract_iso_surface(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                        bpos, bptr, bres, max_cells: int, stats=None):
    """extractIsoSurface (marching_cubes.cu:287-305) over one block window:
    the gate, then every gated cell in batches of max_cells.  `stats`, a
    dict, counts the window and gains its gated cells and cell batches.
    Returns (pos f32[T,3,3], col f32[T,3,3]) on the window's device."""
    pf, _, cells, ring = gate_cells(cfg, table, pool, bpos, bptr, bres)
    pos, col = [], []
    for off in range(0, cells.shape[0], max_cells):
        p, c = extract_cell_batch(cfg, table, pool, pf, cells, off,
                                  max_cells, ring=ring, bpos=bpos)
        pos.append(p)
        col.append(c)
    if stats is not None:
        stats["windows"] = stats.get("windows", 0) + 1
        stats["cells"] = stats.get("cells", 0) + cells.shape[0]
        stats["cell_batches"] = stats.get("cell_batches", 0) + len(pos)
    if not pos:
        empty = pf.new_zeros((0, 3, 3))
        return empty, empty
    return torch.cat(pos), torch.cat(col)
