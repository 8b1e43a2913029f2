"""Per-frame RGB-D step: alloc -> compact -> fused integrate -> [starve
every N frames] -> GC.

Port of the single-resolution, non-resident body of
mrhash_tpu/core/pipeline.py::integrate_rgbd (VoxelContainer::integrate,
voxel_data_structures.cpp:89-134).  Torch runs it eagerly: the window is
exactly the in-frustum block count, and the map state is updated in place.
"""
from __future__ import annotations

from mrhash_tpu import params as P
from mrhash_tpu_torch.core.state import MapConfig, MapState
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import integrate as I


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
    count = int(slots.numel())
    stats = dict(occupied_blocks=count,
                 occupied_total=int((table.ptr != P.FREE_ENTRY).sum()),
                 high_free=table.high_count,
                 low_free=table.low_count,
                 frame=state.frame,
                 unserved_blocks=aux["unserved_blocks"],
                 res0_blocks=count)
    return state, stats
