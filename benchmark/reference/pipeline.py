"""Per-frame steps.  RGB-D: alloc -> compact -> fused integrate (K1) ->
[variance coarsen -> realloc -> reintegrate (K1)] -> [starve every N
frames] -> GC.  LiDAR: per-point alloc -> compact -> fused projective
integrate (K3) or the point-centric walk -> [variance coarsen -> realloc]
-> [starve every N scans] -> GC.

Port of the non-resident bodies of mrhash_tpu/core/pipeline.py::
integrate_rgbd and ::integrate_points (VoxelContainer::integrate,
voxel_data_structures.cpp:89-134), at one resolution or with
variance-adaptive multi-resolution (sdf_var_threshold > 0).  Torch runs
them eagerly: the window is exactly the block count, and the map state is
updated in place.
"""
from __future__ import annotations

import torch

from reference import params as P
from reference.state import MapConfig, MapState
from reference import camera as C
from reference import integrate as I
from reference.state import stage


def _coarsen(cfg: MapConfig, state: MapState, window, decide, gc_decision):
    """The multi-resolution step after the integrate: when the frame is
    not the first and some res-0 entry decided to coarsen (`decide`, from
    K1's or K3's flags or from the pool), coarsen_by_variance.  Returns
    (new_slots, new_mask) of the coarse blocks, or None, and the window
    and the per-entry GC decision (or None) without the entries that
    coarsening freed: the window is not recompacted (the reference's
    deviation D18), so starvation and GC run on the pre-coarsen window
    minus the freed entries, and this frame's coarse blocks starve and
    collect from the next frame on."""
    if cfg.sdf_var_threshold <= 0.0 or state.frame == 0 or not bool(
            decide.any()):
        return None, window, gc_decision
    slots, bpos = window[:2]
    new_slots, new_mask, freed = I.coarsen_by_variance(
        cfg, state.table, state.pool, slots, bpos, decide)
    keep = ~freed
    return ((new_slots, new_mask), tuple(t[keep] for t in window),
            None if gc_decision is None else gc_decision[keep])


def integrate_rgbd(cfg: MapConfig, state: MapState, cam: C.Camera,
                   depth_img, rgb_img):
    """Full RGB-D frame step, in place.  depth_img f32[H,W] metric depth,
    rgb_img u8[H,W,3], both on the state's device.  Returns (state, stats)
    with the reference's stats keys, as Python ints."""
    table, pool = state.table, state.pool
    num_steps = cfg.dda_steps(float(cfg.max_integration_distance))

    # each stage is a torch.profiler range while a profiler runs (rgbd.*;
    # chip_profile.py --multires reads their host and device times)
    # --- allocation ---------------------------------------------------------
    with stage("rgbd.alloc"):
        pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth_img))
        keys, valid = I.alloc_candidates_depth(cfg, cam, pc_depth, num_steps,
                                               frame=state.frame)
        I.alloc_blocks(cfg, table, keys, valid, state.frame)

    # --- compaction + fused integration -------------------------------------
    with stage("rgbd.integrate"):
        window = I.compact_active(cfg, table, cam)
        count = int(window[0].numel())
        aux = I.fused_integrate_depth(cfg, pool, cam, pc_depth, rgb_img,
                                      *window[1:])

    # --- variance-adaptive coarsening ---------------------------------------
    with stage("rgbd.coarsen"):
        coarse, window, gc_decision = _coarsen(
            cfg, state, window, aux["coarsen_decide"], aux["gc_decision"])
        if coarse is not None:
            I.reintegrate_blocks(cfg, table, pool, cam, pc_depth, rgb_img,
                                 *coarse)

    # --- starvation + garbage collection ------------------------------------
    slots, bpos, bptr, bres = window
    n = cfg.n_frames_invalidate_voxels
    if n > 0:
        with stage("rgbd.starve_gc"):
            if state.frame > 0 and state.frame % n == 0:
                I.starve_voxels(cfg, pool, cam, bpos, bptr, bres)
            # GC reads the kernel's flags from BEFORE the starve (reference
            # deviation D12)
            I.garbage_collect_sweep(cfg, table, pool, slots, gc_decision)

    state.frame += 1
    with stage("rgbd.stats"):
        return state, _stats(state, count, bres)


def integrate_points(cfg: MapConfig, state: MapState, cam: C.Camera,
                     points, normals=None, weights=None, reach=None):
    """Full LiDAR frame step, in place (voxel_data_structures.cpp:112-134;
    mrhash_tpu/core/pipeline.py::integrate_points).  points f32[N,3] in
    the camera (sensor) frame on the state's device, a zero point being no
    return; normals f32[N,3] (unit or zero) and weights f32[N], passed to
    the point-centric update only (which reads the normals).  With
    cfg.projective_sdf the update is kernel K3's (the reference's fused
    branch), otherwise the point-centric walk integrate_points_sdf
    (point-to-plane).  With sdf_var_threshold > 0
    the coarsening decision comes from K3's flags or from the pool, and
    the coarsened blocks are not reintegrated: they fill from the next
    scan on (the reference's quirk, mrhash_tpu/core/pipeline.py:474-481).
    With n_frames_invalidate_voxels = n > 0, every n-th scan after the
    first starves the window (its z-buffer read back through K2), and
    every scan runs GC: on K3's flags on a projective scan without a
    starve, else on the decision read from the pool (gc_decide), so a
    starve scan collects on the post-starve weights as the reference's
    does.  Returns (state, stats); a point-centric scan's stats also hold
    the walk's visited voxels and their distinct blocks (visited_keys,
    distinct_keys), and with GC on, gc_freed counts the blocks it freed.

    `reach` (metres; the projective update with GC and starvation off)
    bounds the window to the blocks within it of the sensor (replay.py
    says why no voxel beyond can change).  The program's window holds
    every block, so a block outside this one still has its coarsening
    decision taken each scan, from content unchanged since it was last in
    the window: the decisions left unserved there (by
    max_coarsen_per_frame, or on scan 0, which does not coarsen) stand in
    state.coarsen_pending and join the window's own, in slot order, as
    the program's would."""
    table, pool = state.table, state.pool
    mdist = float(cfg.max_integration_distance)

    # each stage is a torch.profiler range while a profiler runs (points.*;
    # chip_profile.py reads their host and device times)
    with stage("points.alloc_candidates"):
        keys, valid = I.alloc_candidates_points(
            cfg, cam, points, cfg.dda_steps(mdist), normals)
    with stage("points.alloc_blocks"):
        I.alloc_blocks(cfg, table, keys, valid, state.frame)

    # no frustum filter: the scan sees all around (the reference's
    # compact_active without a camera)
    with stage("points.compact_active"):
        window = (I.compact_active(cfg, table) if reach is None else
                  I.compact_active(cfg, table, cam, reach))
    count = int(window[0].numel())
    walk = {}
    if cfg.projective_sdf:
        aux = I.fused_integrate_points(cfg, pool, cam, points, *window[1:])
        decide, gc_flags = aux["coarsen_decide"], aux["gc_decision"]
    else:
        with stage("points.walk"):
            w = I.integrate_points_sdf(cfg, table, pool, cam, points,
                                       normals, weights,
                                       cfg.dda_voxel_steps(mdist), window)
        walk = dict(visited_keys=w["visited"], distinct_keys=w["distinct"])
        decide = (I.coarsen_decide(cfg, pool, *window[2:])
                  if cfg.sdf_var_threshold > 0.0 else None)
        gc_flags = None
    if reach is not None:       # GC is off: no GC decision to carry
        window, decide, by_slot = _with_pending(state, window, decide)
        gc_flags = None
    with stage("points.coarsen"):
        _, window, gc_flags = _coarsen(cfg, state, window, decide,
                                       gc_flags)
    if reach is not None:
        state.coarsen_pending = (by_slot & (table.ptr != P.FREE_ENTRY)
                                 & (table.res == 0))
    n = cfg.n_frames_invalidate_voxels
    if n > 0:
        slots, bpos, bptr, bres = window
        starve = state.frame > 0 and state.frame % n == 0
        if starve:
            with stage("points.starve"):
                I.starve_voxels(cfg, pool, cam, bpos, bptr, bres)
        with stage("points.gc"):
            if gc_flags is None or starve:
                gc_flags = I.gc_decide(cfg, cam, pool, bptr, bres)
            walk["gc_freed"] = I.garbage_collect_sweep(cfg, table, pool,
                                                       slots, gc_flags)

    state.frame += 1
    with stage("points.stats"):
        stats = _stats(state, count, window[3])
    stats.update(walk)
    return state, stats


def _with_pending(state: MapState, window, decide):
    """The window joined, in slot order, with the entries outside it whose
    coarsening decision stands (state.coarsen_pending); returns that
    window, its decisions, and the decisions by table slot
    (bool[capacity])."""
    table = state.table
    inside = torch.zeros(table.capacity, dtype=torch.bool,
                         device=decide.device)
    inside[window[0]] = True
    by_slot = torch.zeros_like(inside)
    by_slot[window[0]] = decide
    if state.coarsen_pending is not None:
        by_slot |= state.coarsen_pending & ~inside
    slots = torch.nonzero(inside | by_slot).flatten()
    return ((slots, table.pos[slots], table.ptr[slots], table.res[slots]),
            by_slot[slots], by_slot)


def _stats(state: MapState, count: int, bres):
    """The reference's stats keys, as Python ints (one device sync);
    res0_blocks counts the res-0 entries of the window that stayed after
    coarsening."""
    table = state.table
    total, res0 = torch.stack([(table.ptr != P.FREE_ENTRY).sum(),
                               (bres == 0).sum()]).tolist()
    return dict(occupied_blocks=count, occupied_total=total,
                high_free=table.high_count, low_free=table.low_count,
                frame=state.frame, unserved_blocks=0, res0_blocks=res0)
