"""Key-owner sharded map over torch.distributed, one process per rank.

Port of mrhash_tpu/parallel/sharding.py, the JAX package's scale-out (the
reference itself is single-GPU).  The JAX module is one program whose
arrays shard_map splits over a 1-D device mesh; here each rank is a
process (parallel/launch.py) that holds its own local MapState on its own
device and calls collectives on its RankGroup (PORT_NOTES.md P63-P69):

- image rows (LiDAR points) split over the ranks for allocation, the first
  rows % n ranks taking one row more (P65);
- candidate keys route to their owner, avalanche(key) mod n, by one
  all_gather per frame of this rank's deduplicated keys padded
  to max_alloc_per_frame with a valid flag (P64); the owner deduplicates
  the gathered keys again, in rank-major order, and inserts them;
- each rank holds a full sub-map with 1/n of the capacities (local_config)
  and heap ids local to it; its hash has as many buckets as it has blocks,
  whatever the config's num_buckets (P68);
- the integrate runs over the whole frame (scan) on this rank's window:
  kernel K1 (RGB-D), K3 or the point-centric walk (LiDAR);
- the starvation z-buffer is all_reduce(MIN)-merged across the ranks
  before its readback through kernel K2; the stats are all_reduce(SUM)med;
- snapshot_to_grid collects every rank's blocks, read-only, into a host
  ChunkGrid on rank 0 (P66), and extract_mesh_sharded meshes it there.

Importing this module starts no process group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import convert, pipeline
from mrhash_tpu_torch.core import streaming as S
from mrhash_tpu_torch.core.state import MapConfig, MapState, make_state
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I


def owner_of(keys, n: int):
    """The rank that owns each block key i32[..., 3]: avalanche(x * P0 ^
    y * P1 ^ z * P2) mod n in uint32 arithmetic.  Returns i32[...]."""
    x, y, z = (H.u32(keys[..., i]) for i in range(3))
    h = H._avalanche(H.mul32(x, P.P0) ^ H.mul32(y, P.P1) ^ H.mul32(z, P.P2))
    return (h % int(n)).to(torch.int32)


def local_config(cfg: MapConfig, n: int) -> MapConfig:
    """Per-rank capacities: each rank holds a full map of 1/n size."""
    return dataclasses.replace(
        cfg,
        num_blocks=max(cfg.num_blocks // n, 64),
        max_active_blocks=max(cfg.max_active_blocks // n, 64),
        max_alloc_per_frame=max(cfg.max_alloc_per_frame // n, 64),
        max_coarsen_per_frame=max(cfg.max_coarsen_per_frame // n, 64),
        max_gc_free_per_frame=max(cfg.max_gc_free_per_frame // n, 64),
        low_split_chunk=max(cfg.low_split_chunk // n, 8),
    )


def make_sharded_state(cfg: MapConfig, rank: int, n: int,
                       device="cpu") -> MapState:
    """Rank `rank`'s empty local map: local_config(cfg, n).num_blocks
    blocks with heap ids local to the rank, as many hash buckets as blocks
    (P68).  Every rank starts from the same state."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a group of {n}")
    return make_state(local_config(cfg, n).num_blocks, device=device)


def _share(total: int, n: int, rank: int):
    """[lo, hi) of this rank's part of `total` items: the first total % n
    ranks take one more (P65)."""
    q, r = divmod(int(total), n)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def _route_keys(lcfg: MapConfig, group, table: H.HashTable, keys, valid,
                frame: int, scratch: AB.DedupScratch):
    """Allocation with key routing: dedup this rank's candidates (the walk
    filled `scratch`), all_gather them (padded to max_alloc_per_frame with
    a valid flag), keep the ones this rank owns, dedup those again in
    rank-major gathered order with the same salt, and insert them, in
    place.  Both dedups and the insert go through ops/alloc_blocks.py's
    entries (K7's scatter, K8 and K9 on a card)."""
    u = int(lcfg.max_alloc_per_frame)
    ukeys, stats = AB.dedup(lcfg, keys, valid, frame, scratch)
    n = ukeys.shape[0]     # on a card u rows, the first stats[0] real
    buf = torch.zeros((u, 4), dtype=torch.int32, device=keys.device)
    buf[:n, :3] = ukeys
    buf[:n, 3] = torch.arange(n, device=keys.device) < stats[0]
    g = group.all_gather(buf).reshape(-1, 4)
    gk = g[:, :3].contiguous()
    mine = (g[:, 3] == 1) & (owner_of(gk, group.size) == group.rank)
    okeys, ostats = AB.dedup(lcfg, gk, mine, frame)
    AB.insert(table, okeys, 0, ostats)


def _stats(group, state: MapState, count: int, frame: int):
    """The JAX step's stats, summed over the ranks, as Python ints;
    `frame` is the frame the step integrated."""
    t = state.table
    tot = torch.tensor([count, t.high_count, t.low_count], dtype=torch.int64,
                       device=t.ptr.device)
    occupied, high_free, low_free = group.all_reduce(tot, "sum").tolist()
    return dict(occupied_blocks=occupied, high_free=high_free,
                low_free=low_free, frame=frame)


def sharded_integrate_rgbd(cfg: MapConfig, group):
    """This rank's RGB-D frame step: step(state, cam, depth, rgb) ->
    (state, stats), state being the rank's local map (updated in place),
    depth f32[H,W] and rgb u8[H,W,3] the whole frame on its device.

    The JAX local_step's order: this rank's rows allocate (key routing);
    the window (capped at max_active_blocks / n) integrates the whole frame
    through K1; with sdf_var_threshold > 0 and frame > 0 coarsening and
    K1's reintegration, starve and GC then running on the pre-coarsen
    window minus the freed entries; every n_frames_invalidate_voxels-th
    frame the merged starve; GC on every frame, on K1's flags or, on a
    starve frame, on the post-starve pool (gc_decide), as the JAX sharded
    step decides from the pool after its starve."""
    n, me = group.size, group.rank
    lcfg = local_config(cfg, n)
    num_steps = cfg.dda_steps(float(cfg.max_integration_distance))

    def step(state: MapState, cam: C.Camera, depth, rgb):
        table, pool, frame = state.table, state.pool, state.frame
        pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth))
        lo, hi = _share(cam.rows, n, me)
        scratch = AB.dedup_scratch(lcfg, frame, pc_depth.device)
        keys, valid = AB.alloc_candidates_depth(
            lcfg, cam, pc_depth[lo:hi], num_steps, row0=lo, frame=frame,
            scratch=scratch)
        _route_keys(lcfg, group, table, keys, valid, frame, scratch)

        window = I.compact_active(lcfg, table, cam)
        count = int(window[0].numel())
        aux = I.fused_integrate_depth(lcfg, pool, cam, pc_depth, rgb,
                                      *window[1:])
        coarse, freed = pipeline._coarsen(lcfg, state, window,
                                          aux["coarsen_decide"])
        if coarse is not None:
            I.reintegrate_blocks(lcfg, table, pool, cam, pc_depth, rgb,
                                 *coarse)

        nf = cfg.n_frames_invalidate_voxels
        if nf > 0:
            slots, bpos, bptr, bres = window
            gc_decision = aux["gc_decision"]
            if frame > 0 and frame % nf == 0:
                I.starve_voxels(lcfg, pool, cam, bpos, bptr, bres,
                                group=group, skip=freed)
                gc_decision = I.gc_decide(lcfg, cam, pool, bptr, bres)
            I.garbage_collect_sweep(lcfg, table, pool, slots,
                                    pipeline._kept(gc_decision, freed))

        state.frame += 1
        return state, _stats(group, state, count, frame)

    return step


def sharded_integrate_points(cfg: MapConfig, group):
    """This rank's LiDAR scan step: step(state, cam, points, normals=None,
    weights=None) -> (state, stats), the scan replicated on every rank
    (points f32[N,3] in the sensor frame, a zero point being no return).

    This rank's share of the points allocates (key routing).  With
    projective_sdf the window takes K3 over the whole scan; otherwise the
    point-centric walk, whose exact lookup resolves this rank's blocks
    only.  With sdf_var_threshold > 0 and scan > 0, coarsening without
    reintegration (the reference's quirk, D8), then the window is
    compacted again, unlike the RGB-D step, so GC reads the fresh coarse
    blocks (P69).  Every n_frames_invalidate_-
    voxels-th scan the merged spherical starve; GC on every scan on the
    pool."""
    n, me = group.size, group.rank
    lcfg = local_config(cfg, n)
    mdist = float(cfg.max_integration_distance)
    num_steps = cfg.dda_steps(mdist)
    num_voxel_steps = cfg.dda_voxel_steps(mdist)

    def step(state: MapState, cam: C.Camera, points, normals=None,
             weights=None):
        table, pool, frame = state.table, state.pool, state.frame
        lo, hi = _share(points.shape[0], n, me)
        scratch = AB.dedup_scratch(lcfg, frame, points.device)
        keys, valid = AB.alloc_candidates_points(
            lcfg, cam, points[lo:hi], num_steps,
            None if normals is None else normals[lo:hi], scratch)
        _route_keys(lcfg, group, table, keys, valid, frame, scratch)

        window = I.compact_active(lcfg, table)
        if cfg.projective_sdf:
            decide = I.fused_integrate_points(lcfg, pool, cam, points,
                                              *window[1:])["coarsen_decide"]
        else:
            I.integrate_points_sdf(lcfg, table, pool, cam, points, normals,
                                   weights, num_voxel_steps, window)
            decide = None
        if cfg.sdf_var_threshold > 0.0 and frame > 0:
            if decide is None:
                decide = I.coarsen_decide(lcfg, pool, *window[2:])
            if bool(decide.any()):
                CB.coarsen(lcfg, table, pool, window[0], window[1], decide)
                window = I.compact_active(lcfg, table)
        count = int(window[0].numel())

        nf = cfg.n_frames_invalidate_voxels
        if nf > 0:
            slots, bpos, bptr, bres = window
            if frame > 0 and frame % nf == 0:
                I.starve_voxels(lcfg, pool, cam, bpos, bptr, bres,
                                group=group)
            I.garbage_collect_sweep(lcfg, table, pool, slots,
                                    I.gc_decide(lcfg, cam, pool, bptr, bres))

        state.frame += 1
        return state, _stats(group, state, count, frame)

    return step


def snapshot_to_grid(cfg: MapConfig, state: MapState, group, grid=None,
                     staging: int = 4096):
    """Every occupied block of the sharded map in a host ChunkGrid on rank
    0 (the sharded half of extractMesh / serializeGrid, the reference's
    streamAllOut protocol, streamer.cpp:249-281).  Each rank gathers its
    occupied blocks in slot order (those plan_evictions(all_out=True)
    would evict), read-only, so the map stays valid for more frames; in
    passes of `staging` blocks per rank, rank 0 collects every rank's pass
    (gather_object) and adds them to the grid in rank order.  All ranks
    call it; returns the grid on rank 0 (`grid`, or a new one), None
    elsewhere."""
    lcfg = local_config(cfg, group.size)
    staging = min(int(staging), lcfg.num_blocks)
    table = state.table
    slots = torch.nonzero(table.ptr != H.FREE).flatten()
    most = torch.tensor([slots.numel()], dtype=torch.int64,
                        device=table.ptr.device)
    most = int(group.all_reduce(most, "max")[0])
    if group.rank == 0 and grid is None:
        grid = S.ChunkGrid(cfg.voxel_extents)
    for off in range(0, most, staging):
        s = slots[off:off + staging]
        res = table.res[s]
        fields = S.gather_blocks(state.pool, table.ptr[s], res)
        part = dict(pos=table.pos[s].cpu().numpy(), res=res.cpu().numpy(),
                    **{k: f.cpu().numpy()
                       for k, f in zip(S.HOST_FIELDS, fields)})
        parts = group.gather_object(part)
        if group.rank == 0:
            for p in parts:
                grid.add_blocks(S.block_world(cfg, p["pos"]), p["pos"],
                                p["res"], *(p[k] for k in S.HOST_FIELDS))
    return grid if group.rank == 0 else None


def extract_mesh_sharded(cfg: MapConfig, state: MapState, geo,
                         filename: str, group):
    """extractMesh of the sharded map: snapshot every rank's blocks into
    rank 0's `geo.streamer.grid`, then rank 0 runs geo.extractMesh.
    `geo` is an empty port GeoWrapper with a compatible config on rank 0
    (the sweep's settings and the mesh post-processing; None on the other
    ranks).  All ranks call it; returns geo.mesh on rank 0, None
    elsewhere."""
    snapshot_to_grid(cfg, state, group,
                     grid=geo.streamer.grid if group.rank == 0 else None)
    if group.rank != 0:
        return None
    geo.extractMesh(filename)
    return geo.mesh


def run_frames(group, cfg: MapConfig, kind: str, camera, frames,
               states=None, mesh=None):
    """A rank program for parallel/launch.py::run_ranks: step this rank's
    map through `frames` and return what it holds.

    camera: make_camera's (fx, fy, cx, cy, rows, cols, min_depth,
    max_depth, model).  kind "rgbd": frames of (rot, trans, depth, rgb);
    kind "points": frames of (rot, trans, points, normals or None); numpy
    arrays.  states: every rank's starting map as
    core/convert.py::to_reference_arrays gives it (from a reference
    sharded state through from_reference_sharded), else an empty sharded
    map.  mesh: dict(geo=GeoWrapper keyword arguments, filename=...,
    staging=blocks per pass) to snapshot the map (snapshot_to_grid at that
    staging) and to extract its mesh in rank 0's GeoWrapper
    (extract_mesh_sharded) after the frames.

    Returns dict(state=the local map's arrays, stats=[stats per frame],
    local=[(occupied, high_free, low_free) of this rank per frame]) and on
    rank 0 with `mesh`: grid=the snapshot's blocks concatenated over its
    chunks, chunks=its chunk keys, vertices=the mesh's vertices."""
    dev = group.device
    state = (convert.from_arrays(states[group.rank], dev) if states
             else make_sharded_state(cfg, group.rank, group.size, dev))
    cam0 = C.make_camera(*camera, device=dev)
    step = (sharded_integrate_rgbd if kind == "rgbd"
            else sharded_integrate_points)(cfg, group)
    out = dict(stats=[], local=[])
    for rot, trans, a, b in frames:
        cam = C.with_pose(cam0, rot, trans)
        a = torch.from_numpy(a).to(dev)
        b = None if b is None else torch.from_numpy(b).to(dev)
        state, stats = step(state, cam, a, b)
        out["stats"].append(stats)
        t = state.table
        out["local"].append((int((t.ptr != H.FREE).sum()), t.high_count,
                             t.low_count))
    if mesh is not None:
        grid = snapshot_to_grid(cfg, state, group, staging=mesh["staging"])
        geo = None
        if group.rank == 0:
            from mrhash_tpu_torch.geowrapper import GeoWrapper
            geo = GeoWrapper(**mesh["geo"], device=dev)
        m = extract_mesh_sharded(cfg, state, geo, mesh["filename"], group)
        if group.rank == 0:
            out["chunks"] = sorted(grid.chunks)
            out["grid"] = {k: np.concatenate(
                [grid.chunks[c][k] for c in out["chunks"]])
                for k in ("pos", "res") + S.HOST_FIELDS}
            out["vertices"] = m.vertices
    out["state"] = convert.to_reference_arrays(state)
    return out
