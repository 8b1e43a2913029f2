"""Per-frame steps.  RGB-D: alloc -> compact -> fused integrate (K1) ->
[starve every N frames] -> GC.  LiDAR: per-point alloc -> compact ->
fused projective integrate (K3) -> GC.

Port of the single-resolution, non-resident bodies of
mrhash_tpu/core/pipeline.py::integrate_rgbd and ::integrate_points
(VoxelContainer::integrate, voxel_data_structures.cpp:89-134).  Torch runs
them eagerly: the window is exactly the block count, and the map state is
updated in place.
"""
from __future__ import annotations

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, MapState
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import stage


def integrate_rgbd(cfg: MapConfig, state: MapState, cam: C.Camera,
                   depth_img, rgb_img):
    """Full RGB-D frame step, in place.  depth_img f32[H,W] metric depth,
    rgb_img u8[H,W,3], both on the state's device.  Returns (state, stats)
    with the reference's stats keys, as Python ints."""
    if cfg.sdf_var_threshold > 0.0:
        raise NotImplementedError(
            "mrhash_tpu_torch ports the single-resolution path only "
            "(sdf_var_threshold must be 0)")
    table, pool = state.table, state.pool
    pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth_img))
    num_steps = cfg.dda_steps(float(cfg.max_integration_distance))

    # --- allocation ---------------------------------------------------------
    keys, valid = I.alloc_candidates_depth(cfg, cam, pc_depth, num_steps,
                                           frame=state.frame)
    I.alloc_blocks(cfg, table, keys, valid, state.frame)

    # --- compaction + fused integration -------------------------------------
    slots, bpos, bptr, _ = I.compact_active(cfg, table, cam)
    aux = I.fused_integrate_depth(cfg, pool, cam, pc_depth, rgb_img, bpos,
                                  bptr)

    # --- starvation + garbage collection ------------------------------------
    n = cfg.n_frames_invalidate_voxels
    if n > 0:
        if state.frame > 0 and state.frame % n == 0:
            I.starve_voxels(cfg, pool, cam, bpos, bptr)
        # GC reads the kernel's flags from BEFORE the starve (reference
        # deviation D12)
        I.garbage_collect_sweep(cfg, table, pool, cam, slots,
                                (aux["gc_min_s"], aux["gc_max_w"]))

    state.frame += 1
    return state, _stats(state, slots, aux)


def integrate_points(cfg: MapConfig, state: MapState, cam: C.Camera,
                     points):
    """Full LiDAR frame step, in place, projective and single-resolution
    (voxel_data_structures.cpp:112-134; the reference's fused branch,
    sample_mode="fused" with projective_sdf).  points f32[N,3] in the
    camera (sensor) frame on the state's device; a zero point is no return.
    Garbage collection reads kernel K3's flags when
    n_frames_invalidate_voxels > 0; starvation under the spherical model is
    not ported and raises on a starve frame.  Returns (state, stats)."""
    if cfg.sdf_var_threshold > 0.0:
        raise NotImplementedError(
            "mrhash_tpu_torch ports the single-resolution path only "
            "(sdf_var_threshold must be 0)")
    n = cfg.n_frames_invalidate_voxels
    if n > 0 and state.frame > 0 and state.frame % n == 0:
        raise NotImplementedError(
            "starvation under the spherical camera model: not ported yet "
            "(ROADMAP A10)")
    table, pool = state.table, state.pool
    num_steps = cfg.dda_steps(float(cfg.max_integration_distance))

    # each stage is a torch.profiler range while a profiler runs (points.*;
    # chip_profile.py reads their host and device times)
    with stage("points.alloc_candidates"):
        keys, valid = I.alloc_candidates_points(cfg, cam, points, num_steps)
    with stage("points.alloc_blocks"):
        I.alloc_blocks(cfg, table, keys, valid, state.frame)

    # no frustum filter: the scan sees all around (the reference's
    # compact_active without a camera)
    with stage("points.compact_active"):
        slots, bpos, bptr, _ = I.compact_active(cfg, table)
    aux = I.fused_integrate_points(cfg, pool, cam, points, bpos, bptr)
    if n > 0:
        with stage("points.gc"):
            I.garbage_collect_sweep(cfg, table, pool, cam, slots,
                                    (aux["gc_min_s"], aux["gc_max_w"]))

    state.frame += 1
    with stage("points.stats"):
        return state, _stats(state, slots, aux)


def _stats(state: MapState, slots, aux):
    """The reference's stats keys, as Python ints."""
    table = state.table
    count = int(slots.numel())
    return dict(occupied_blocks=count,
                occupied_total=int((table.ptr != P.FREE_ENTRY).sum()),
                high_free=table.high_count,
                low_free=table.low_count,
                frame=state.frame,
                unserved_blocks=aux["unserved_blocks"],
                res0_blocks=count)
