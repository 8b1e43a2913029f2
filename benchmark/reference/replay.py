"""Work the map out again from the frames and poses the harness handed to
the program, with the frozen plain pipeline, and return its content.

The replay never streams: it computes what the program would on a card
large enough to hold the whole run, which is what streaming promises a
user (the harness compares it with the union of the program's device map
and host grid).  It keeps every per-frame cap of the configuration
(allocations, coarsenings, the window) and grows only its pool: before a
frame whose allocations and one low-heap split could drain the free high
heap, it rebuilds into twice the blocks (`grow`), which changes pool rows
and not content.  The hash table keeps the configuration's buckets, so
keys hash and collide as in the program: a key whose probe window is
full, or that loses its slot to another key of its batch, waits for a
later frame in both.  A replay that would truncate its window, or leave
a key out for a dry heap, raises state.ReplayLimit: the run is then not
correct, never silently short.

The LiDAR window (a spherical sensor, the projective update, GC and
starvation off) holds the blocks whose nearest point lies within
max_depth + sdf truncation of the sensor, where the program's holds every
block.  No voxel beyond can change, by K3's twin
(reference/fused_integrate_points.py) and project_window_sph
(reference/integrate.py):
- a voxel is updated only where its pixel `pix` is >= 0, which
  project_window_sph gives only to a voxel whose range r_vox lies within
  [min_depth, max_depth] (_sph_ok);
- and only where the return r_px at that pixel lies in (0,
  max_integration_distance] and r_px - r_vox > -trunc, so r_vox < r_px +
  trunc <= max_depth + trunc.
So every updated voxel lies within max_depth of the sensor, and the bound
leaves one truncation (0.4 m in the configurations) for the float32
rounding of r_vox.  K3's flags, from which the coarsening decision comes,
read a block's own voxels alone, so a block outside the window has the
flags it had when last in it.  A coarsening decision can fall on a block
that was not updated: one left unserved by max_coarsen_per_frame is taken
again on the next scan, and scan 0's (which does not coarsen) on scan 1,
updated or not; pipeline.integrate_points carries them
(state.coarsen_pending).  Allocation needs no window, and a block it
places beyond reach is unweighted, so it decides nothing.  With
starvation or GC on the window holds every block: the starve z-buffer
takes any voxel in front of it, at any range.

`precision="bfloat16"` is the control: the same replay with the voxel
pool's sdf and sumsq stored in bfloat16 (rounded after every frame), the
step below the configuration's float32 that would tempt a change to the
program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import camera as C
from reference import coords as X
from reference import pipeline
from reference.state import MapConfig, ReplayLimit, make_pool, make_state

# GeoWrapper's fixed choice beside the configuration (geowrapper.py): the
# per-tile band allocation over 4x4 pixel tiles
ALLOC_TILE = 4


def quat_to_rot(q):
    """Quaternion (x, y, z, w) -> rotation f32[3,3], in float64 first, as
    the API's setCurrPose."""
    qx, qy, qz, qw = np.asarray(q, np.float64).reshape(4)
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]], np.float32)


def map_config(conf: dict) -> MapConfig:
    m = conf["map"]
    cfg = MapConfig(
        alloc_tile=ALLOC_TILE,
        virtual_voxel_size=float(m["virtual_voxel_size"]),
        voxel_extents=(float(m["voxel_extents_scale"]),) * 3,
        sdf_truncation=float(m["sdf_truncation"]),
        sdf_truncation_scale=float(m["sdf_truncation_scale"]),
        integration_weight_sample=int(m["integration_weight_sample"]),
        max_integration_distance=float(conf["sensor"]["max_depth"]),
        n_frames_invalidate_voxels=int(m["n_frames_invalidate_voxels"]),
        sdf_var_threshold=float(m["sdf_var_threshold"]),
        min_weight_threshold=int(m["min_weight_threshold"]),
        marching_cubes_threshold=float(m["marching_cubes_threshold"]),
        vertices_merging_threshold=float(m["vertices_merging_threshold"]),
        projective_sdf=bool(m.get("projective_sdf", True)),
        num_blocks=int(m["num_blocks"]),
        num_buckets=int(m["num_buckets"]),
        max_active_blocks=int(m["max_active_blocks"]),
        max_alloc_per_frame=int(m["max_alloc_per_frame"]))
    return dataclasses.replace(cfg, **conf["map_config"])


def camera(conf: dict, frames, device):
    s = conf["sensor"]
    if s["model"] == "spherical":
        fx, fy, cx, cy = frames.intrinsics
        return C.make_camera(fx, fy, cx, cy, s["rows"], s["cols"],
                             s["min_depth"], s["max_depth"], C.SPHERICAL,
                             device=device)
    return C.make_camera(s["fx"], s["fy"], s["cx"], s["cy"], s["rows"],
                         s["cols"], s["min_depth"], s["max_depth"],
                         device=device)


def reach(conf: dict, cfg: MapConfig):
    """The LiDAR window's bound in metres (module docstring), or None
    where the window holds every block."""
    if (conf["sensor"]["model"] != "spherical" or not cfg.projective_sdf
            or cfg.n_frames_invalidate_voxels > 0):
        return None
    m = cfg.max_integration_distance
    return m + X.get_truncation(m, cfg.sdf_truncation,
                                cfg.sdf_truncation_scale)


def grow(state):
    """Rebuild the state into twice the pool's blocks, in place: the rows
    keep their place, the free ids gain the new rows."""
    t, n = state.table, state.table.num_blocks
    dev = t.heap_high.device
    pool = make_pool(2 * n, dev)
    for f in pool.FIELDS:
        getattr(pool, f)[:n] = getattr(state.pool, f)
    state.pool = pool
    i32 = dict(dtype=torch.int32, device=dev)
    heap_high = torch.full((2 * n,), -1, **i32)
    heap_high[:n] = torch.arange(2 * n - 1, n - 1, -1, **i32)
    heap_high[n:n + t.high_count] = t.heap_high[:t.high_count]
    t.heap_high = heap_high
    heap_low = torch.full((t.heap_low.shape[0] * 2,), t.heap_low.shape[0] * 2,
                          **i32)
    heap_low[:t.low_count] = t.heap_low[:t.low_count]
    t.heap_low = heap_low
    t.high_count += n
    t.num_blocks = 2 * n


def replay(conf: dict, frames, n_frames: int, device, content,
           precision="float32", reach_window=True, info=None):
    """Frames 0..n_frames-1 through the plain pipeline on `device`; returns
    content(table, pool) (compare.map_content's arguments).  Raises
    ReplayLimit where it cannot follow the run (module docstring).
    reach_window=False gives a LiDAR window of every block (the bounded
    window's test).  `info`, a dict, gains the blocks the pool ended with,
    the times it grew, the most blocks a window held, and the keys that
    found their probe window full or lost their slot to another key of
    their batch."""
    cfg = map_config(conf)
    state = make_state(cfg.num_blocks, cfg.num_buckets or None, device)
    cam0 = camera(conf, frames, device)
    bound = reach(conf, cfg) if reach_window else None
    # one frame's draws from the high heap: its allocations and a split
    # for coarsening's res-1 blocks
    frame_need = (cfg.max_alloc_per_frame * cfg.alloc_rounds
                  + cfg.low_split_chunk)
    grown = widest = 0
    for i in range(n_frames):
        while state.table.high_count < frame_need:
            try:
                grow(state)
            except torch.OutOfMemoryError as e:
                raise ReplayLimit(
                    f"the pool cannot grow past {state.table.num_blocks} "
                    f"blocks on {device}: {e}") from None
            grown += 1
        trans, quat = frames.pose(i)
        cam = C.with_pose(cam0, quat_to_rot(quat),
                          np.asarray(trans, np.float32))
        if frames.kind == "rgbd":
            depth, rgb = frames.inputs(i)
            _, stats = pipeline.integrate_rgbd(
                cfg, state, cam, torch.as_tensor(depth).to(device),
                torch.as_tensor(rgb).to(device))
        else:
            _, stats = pipeline.integrate_points(
                cfg, state, cam, torch.as_tensor(frames.inputs(i)).to(device),
                reach=bound)
        widest = max(widest, stats["occupied_blocks"])
        if state.table.heap_dry:
            raise ReplayLimit(f"frame {i}: {state.table.heap_dry} keys "
                              "found their heap dry")
        if precision == "bfloat16":
            for f in (state.pool.sdf, state.pool.sumsq):
                f.copy_(f.to(torch.bfloat16).to(torch.float32))
        elif precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
    t, p = state.table, state.pool
    if info is not None:
        info.update(pool_blocks=t.num_blocks, grown=grown,
                    widest_window=widest, full_window=t.full_window,
                    lost_slot=t.lost_slot,
                    window_bound_m=bound)
    return content(t.pos, t.ptr, t.res, p.sdf, p.sumsq, p.weight, p.rgbp)
