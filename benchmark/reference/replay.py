"""Work the map out again from the frames and poses the harness handed to
the program, with the frozen plain pipeline, and return its content.

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
from reference import pipeline
from reference.state import MapConfig, make_state

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


def replay(conf: dict, frames, n_frames: int, device, content,
           precision="float32"):
    """Frames 0..n_frames-1 through the plain pipeline on `device`; returns
    content(table, pool) (compare.map_content's arguments)."""
    cfg = map_config(conf)
    state = make_state(cfg.num_blocks, cfg.num_buckets or None, device)
    cam0 = camera(conf, frames, device)
    for i in range(n_frames):
        trans, quat = frames.pose(i)
        cam = C.with_pose(cam0, quat_to_rot(quat),
                          np.asarray(trans, np.float32))
        if frames.kind == "rgbd":
            depth, rgb = frames.inputs(i)
            pipeline.integrate_rgbd(
                cfg, state, cam, torch.as_tensor(depth).to(device),
                torch.as_tensor(rgb).to(device))
        else:
            pipeline.integrate_points(
                cfg, state, cam, torch.as_tensor(frames.inputs(i)).to(device))
        if precision == "bfloat16":
            for f in (state.pool.sdf, state.pool.sumsq):
                f.copy_(f.to(torch.bfloat16).to(torch.float32))
        elif precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
    t, p = state.table, state.pool
    return content(t.pos, t.ptr, t.res, p.sdf, p.sumsq, p.weight, p.rgbp)
