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

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, MapState, coarsen_pending
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coarsen_blocks as CB
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import (COUNTS, SYNCS, host_bool,
                                             host_list, since, stage)


def _coarsen(cfg: MapConfig, state: MapState, window, decide, counts=None):
    """The multi-resolution step after the integrate: when the frame is
    not the first and some res-0 entry decided to coarsen (`decide`, from
    K1's or K3's flags or from the pool), coarsen_blocks.coarsen.  Returns
    (new_slots, new_mask) of the coarse blocks, or None, and the window
    entries it freed (bool[A], or None where it did not run).  The window
    is not recompacted (the reference's deviation D18) and keeps the freed
    entries: their slots are free and their rows cleared, or already a
    coarse block's, so starvation (starve_voxels' skip), GC (_kept) and
    the stats' res-0 count skip them, as the reference's pre-coarsen
    window minus the freed entries; this frame's coarse blocks starve and
    collect from the next frame on.  `counts`, a dict, gets "unserved",
    the decisions max_coarsen_per_frame left for a later frame, where it
    ran (CB.coarsen)."""
    if cfg.sdf_var_threshold <= 0.0 or state.frame == 0 or not host_bool(
            decide.any()):
        return None, None
    new_slots, new_mask, freed = CB.coarsen(
        cfg, state.table, state.pool, *window[:2], decide, counts)
    return (new_slots, new_mask), freed


def _kept(decision, freed):
    """A per-entry decision of the window without the entries coarsening
    freed (`freed`, or None where it did not run)."""
    return decision if freed is None else decision & ~freed


def integrate_rgbd(cfg: MapConfig, state: MapState, cam: C.Camera,
                   depth_img, rgb_img):
    """Full RGB-D frame step, in place.  depth_img f32[H,W] metric depth,
    rgb_img u8[H,W,3], both on the state's device.  Returns (state, stats)
    with the reference's stats keys and the frame's counters (_stats), as
    Python ints."""
    table, pool = state.table, state.pool
    syncs0 = COUNTS[SYNCS]
    num_steps = cfg.dda_steps(float(cfg.max_integration_distance))

    # each stage is a torch.profiler range while a profiler runs (rgbd.*;
    # the benchmark's readers and chip_profile.py --multires read their
    # host and device times)
    # --- allocation ---------------------------------------------------------
    with stage("rgbd.alloc"):
        with stage("rgbd.alloc.cloud"):
            pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth_img))
        # the walk fills the frame's dedup scratch (fused in one kernel on
        # a card)
        with stage("rgbd.alloc.candidates"):
            scratch = AB.dedup_scratch(cfg, state.frame, pc_depth.device)
            keys, valid = AB.alloc_candidates_depth(
                cfg, cam, pc_depth, num_steps, frame=state.frame,
                scratch=scratch)
        alloc = I.alloc_blocks(cfg, table, keys, valid, state.frame, scratch,
                               state.refill)

    # --- compaction + fused integration -------------------------------------
    with stage("rgbd.integrate"):
        with stage("rgbd.compact"):
            window, cut = I.compact_window(cfg, table, cam)
        count = int(window[0].numel())
        with stage("rgbd.K1"):
            aux = I.fused_integrate_depth(cfg, pool, cam, pc_depth, rgb_img,
                                          *window[1:])

    # --- variance-adaptive coarsening ---------------------------------------
    with stage("rgbd.coarsen"):
        c0 = COUNTS[SYNCS]
        unserved = dict(unserved=0)
        coarse, freed = _coarsen(cfg, state, window, aux["coarsen_decide"],
                                 unserved)
        if coarse is not None:
            I.reintegrate_blocks(cfg, table, pool, cam, pc_depth, rgb_img,
                                 *coarse)
        coarsen_syncs = since(c0)

    # --- starvation + garbage collection ------------------------------------
    slots, bpos, bptr, bres = window
    n = cfg.n_frames_invalidate_voxels
    gc_freed = gc_unserved = 0
    if n > 0:
        with stage("rgbd.starve_gc"):
            if state.frame > 0 and state.frame % n == 0:
                I.starve_voxels(cfg, pool, cam, bpos, bptr, bres,
                                skip=freed)
            # GC reads the kernel's flags from BEFORE the starve (reference
            # deviation D12)
            gc_freed, gc_unserved = I.garbage_collect_sweep(
                cfg, table, pool, slots, _kept(aux["gc_decision"], freed))

    state.frame += 1
    with stage("rgbd.stats"):
        return state, _stats(state, count, bres, alloc, coarse, gc_freed,
                             syncs0, window_cut=cut, freed=freed,
                             coarsen_syncs=coarsen_syncs,
                             unserved=(unserved["unserved"], gc_unserved))


def integrate_points(cfg: MapConfig, state: MapState, cam: C.Camera,
                     points, normals=None, weights=None):
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
    does.  Returns (state, stats) as integrate_rgbd's; a point-centric
    scan's stats also hold the walk's visited voxels and their distinct
    blocks (visited_keys, distinct_keys).

    The window holds every block, except on K3's update of a spherical
    sensor with starvation and GC off (_window_reach): there it holds the
    blocks within the sensor's reach, beyond which no voxel changes
    (ops/integrate.py::blocks_within), so the map is the one a window of
    every block gives.  A block beyond reach decides as it did when last
    inside, so only the decisions that stand need carrying: those
    max_coarsen_per_frame left unserved, and scan 0's (which does not
    coarsen), are kept by slot in state.coarsen_pending (_carry), with
    the blocks streamed back in (mark_streamed_in), and join the next
    window, which takes them in slot order as a window of every block
    would."""
    table, pool = state.table, state.pool
    syncs0 = COUNTS[SYNCS]
    mdist = float(cfg.max_integration_distance)

    # each stage is a torch.profiler range while a profiler runs (points.*;
    # chip_profile.py reads their host and device times)
    with stage("points.alloc_candidates"):
        scratch = AB.dedup_scratch(cfg, state.frame, points.device)
        keys, valid = AB.alloc_candidates_points(
            cfg, cam, points, cfg.dda_steps(mdist), normals, scratch)
    with stage("points.alloc_blocks"):
        alloc = I.alloc_blocks(cfg, table, keys, valid, state.frame, scratch,
                               state.refill)

    # no frustum filter: the scan sees all around (the reference's
    # compact_active without a camera), as far as the sensor's reach
    bound = _window_reach(cfg, cam)
    with stage("points.compact_active"):
        if bound is None:
            window, cut = I.compact_window(cfg, table)
        else:
            with stage("points.reach"):
                window, cut = I.compact_window(cfg, table, cam, bound,
                                               state.coarsen_pending)
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
    carried = None
    with stage("points.coarsen"):
        c0 = COUNTS[SYNCS]
        unserved = dict(unserved=0)
        coarse, freed = _coarsen(cfg, state, window, decide, unserved)
        if bound is not None and cfg.sdf_var_threshold > 0.0:
            carried = _carry(cfg, state, cam, bound, window, decide, freed)
        coarsen_syncs = since(c0)
    n = cfg.n_frames_invalidate_voxels
    gc_freed = gc_unserved = 0
    if n > 0:
        slots, bpos, bptr, bres = window
        starve = state.frame > 0 and state.frame % n == 0
        if starve:
            with stage("points.starve"):
                I.starve_voxels(cfg, pool, cam, bpos, bptr, bres,
                                skip=freed)
        with stage("points.gc"):
            if gc_flags is None or starve:
                gc_flags = I.gc_decide(cfg, cam, pool, bptr, bres)
            gc_freed, gc_unserved = I.garbage_collect_sweep(
                cfg, table, pool, slots, _kept(gc_flags, freed))

    state.frame += 1
    with stage("points.stats"):
        stats = _stats(state, count, window[3], alloc, coarse, gc_freed,
                       syncs0, window_cut=cut, carried=carried, freed=freed,
                       coarsen_syncs=coarsen_syncs,
                       unserved=(unserved["unserved"], gc_unserved))
    stats.update(walk)
    return state, stats


def _window_reach(cfg: MapConfig, cam: C.Camera):
    """The LiDAR window's bound in metres (I.sensor_reach) on K3's update
    of a spherical sensor with starvation and GC off, else None: the
    window holds every block, as the reference's, for the point-centric
    walk and where the starve z-buffer takes the front-most voxel at any
    range."""
    if (cam.model != C.SPHERICAL or not cfg.projective_sdf
            or cfg.n_frames_invalidate_voxels > 0):
        return None
    return I.sensor_reach(cfg)


def mark_streamed_in(cfg: MapConfig, state: MapState, cam: C.Camera,
                     slots):
    """Where the window is bounded to the sensor's reach (_window_reach),
    mark `slots`, the entries a stream-in filled, in
    state.coarsen_pending: back on the card, a block takes its coarsening
    decision again on the next scan, wherever it lies, as a window of
    every block would take it."""
    if _window_reach(cfg, cam) is not None and cfg.sdf_var_threshold > 0.0:
        coarsen_pending(state).index_fill_(0, slots, True)


def _carry(cfg: MapConfig, state: MapState, cam: C.Camera, bound, window,
           decide, served):
    """Record the window's coarsening decisions that stand for the next
    scan, by slot in state.coarsen_pending: each entry's decision less
    the ones coarsening served (`served`, None where it did not run);
    the marks of slots outside the window are kept.  Returns the decisions
    served from beyond reach (a device count), or None."""
    slots = window[0]
    left = decide if served is None else decide & ~served
    coarsen_pending(state).index_put_((slots,), left)
    if served is None:
        return None
    return (served & ~I.blocks_within(cfg, cam, window[1], bound)).sum()


def _stats(state: MapState, count: int, bres, alloc=(0, 0), coarse=None,
           gc_freed: int = 0, syncs0: int | None = None,
           window_cut: int = 0, carried=None, freed=None,
           coarsen_syncs: int = 0, unserved=(0, 0)):
    """The reference's stats keys, as Python ints (one device sync);
    res0_blocks counts the res-0 entries of the window that stayed after
    coarsening (those `freed` does not mark).  Then the frame's counters, host
    ints the step already has: alloc_keys and alloc_new, the deduped keys
    submitted to insert and the blocks it drew (I.alloc_blocks' `alloc`);
    coarsened, the res-0 entries coarsening served (`coarse`, None when it did
    not run); gc_freed, the blocks GC freed (0 with GC off); window_cut, the
    occupied entries the window's cap (max_active_blocks) left out;
    coarsen_carried, the decisions coarsening served from beyond the sensor's
    reach (`carried`, a device count read in this sync, or None);
    coarsen_unserved and gc_unserved, the decisions the caps
    (max_coarsen_per_frame, max_gc_free_per_frame) left for a later frame
    (`unserved`, host ints from the host reads coarsening and GC take);
    coarsen_syncs, the sync sites passed inside the coarsening step (its stage,
    the RGB-D reintegration included); host_syncs, the sync sites passed since
    the reading syncs0 of COUNTS (utils/profiler.py), this one's included (this
    one alone without syncs0)."""
    table = state.table
    if syncs0 is None:
        syncs0 = COUNTS[SYNCS]
    counts = [(table.ptr != P.FREE_ENTRY).sum(),
              _kept(bres == 0, freed).sum()]
    if carried is not None:
        counts.append(carried)
    total, res0, *far = host_list(torch.stack(counts))
    return dict(occupied_blocks=count, occupied_total=total,
                high_free=table.high_count, low_free=table.low_count,
                frame=state.frame, unserved_blocks=0, res0_blocks=res0,
                alloc_keys=alloc[0], alloc_new=alloc[1],
                coarsened=0 if coarse is None else int(coarse[0].shape[0]),
                gc_freed=gc_freed, window_cut=window_cut,
                coarsen_carried=far[0] if far else 0,
                coarsen_unserved=unserved[0], gc_unserved=unserved[1],
                coarsen_syncs=coarsen_syncs, host_syncs=since(syncs0))
