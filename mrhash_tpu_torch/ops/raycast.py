"""SDF ray casting: sampling along each pixel's ray + bisection refinement.

Port of mrhash_tpu/ops/raycast.py, the reference's rendering helpers
(voxel_data_structures.cu:340-383 findIntersectionLinear /
findIntersectionBisection, and the RayCastSample machinery of
voxel_hash_utils.cuh:40-44), which its runner paths do not call.  The
reference's `lax.scan` over the steps is a plain loop here
(PORT_NOTES.md P50).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, VoxelPool
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import meshing as M


def find_intersection_linear(t_near, t_far, d_near, d_far):
    """voxel_data_structures.cu:341-346."""
    return t_near + (d_near / (d_near - d_far)) * (t_far - t_near)


def find_intersection_bisection(cfg: MapConfig, table: H.HashTable,
                                pool: VoxelPool, origin, direction,
                                d0, r0, d1, r1):
    """voxel_data_structures.cu:348-383: n_iteration_bisection rounds of
    linear interpolation and trilinear re-sampling between the bracketing
    samples (r0, d0) and (r1, d1), per ray.  Returns (alpha, valid)."""
    a, a_dist = r0, d0
    b, b_dist = r1, d1
    c = torch.zeros_like(a)
    valid = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    for _ in range(P.N_ITERATION_BISECTION):
        c = find_intersection_linear(a, b, a_dist, b_dist)
        pos = origin + c[..., None] * direction
        c_dist, ok = M.trilinear_interpolation(cfg, table, pool, pos)
        valid = valid & ok
        take_a = a_dist * c_dist > 0
        a = torch.where(take_a, c, a)
        a_dist = torch.where(take_a, c_dist, a_dist)
        b = torch.where(take_a, b, c)
        b_dist = torch.where(take_a, b_dist, c_dist)
    return c, valid


def raycast_depth(cfg: MapConfig, table: H.HashTable, pool: VoxelPool,
                  cam: C.Camera, step_scale: float = 0.5,
                  max_steps: int = 256):
    """Render a depth map: march each pixel's ray through the TSDF in steps
    of step_scale * truncation, bracket the first sign change, refine it by
    bisection.  Returns (depth f32[H,W], hit bool[H,W])."""
    dev = cam.rot.device
    rows = torch.arange(cam.rows, dtype=torch.float32, device=dev)
    cols = torch.arange(cam.cols, dtype=torch.float32, device=dev)
    r = rows[:, None].expand(cam.rows, cam.cols).reshape(-1)
    c = cols[None, :].expand(cam.rows, cam.cols).reshape(-1)
    ray_cam = C.inverse_projection(cam, r, c, torch.ones_like(r))
    x, y, z = ray_cam[:, 0:1], ray_cam[:, 1:2], ray_cam[:, 2:3]
    ray_cam = ray_cam / torch.sqrt(x * x + y * y + z * z)
    rot = cam.rot
    # ray_cam @ rot.T, each product and sum rounded on its own
    direction = torch.stack(
        [ray_cam[:, 0] * rot[i, 0] + ray_cam[:, 1] * rot[i, 1]
         + ray_cam[:, 2] * rot[i, 2] for i in range(3)], dim=-1)
    origin = cam.trans
    step = step_scale * cfg.sdf_truncation

    n = r.shape[0]
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    tcur = torch.full((n,), float(cam.min_depth), dtype=torch.float32,
                      device=dev)
    prev_t, prev_d, hit_a, hit_b, hit_da, hit_db = (zero,) * 6
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        pos = origin + tcur[..., None] * direction
        sdf, w, _, _, _ = M.get_voxel(cfg, table, pool, pos)
        valid = w > 0
        # sdf == 0 is on the surface: it brackets too (synthetic data,
        # axis-aligned walls)
        crossed = valid & (prev_d > 0) & (sdf <= 0) & ~found
        hit_a = torch.where(crossed, prev_t, hit_a)
        hit_b = torch.where(crossed, tcur, hit_b)
        hit_da = torch.where(crossed, prev_d, hit_da)
        hit_db = torch.where(crossed, sdf, hit_db)
        found = found | crossed
        prev_t = torch.where(valid, tcur, prev_t)
        prev_d = torch.where(valid, sdf, prev_d)
        tcur = tcur + step

    alpha, ok = find_intersection_bisection(cfg, table, pool, origin,
                                            direction, hit_da, hit_a,
                                            hit_db, hit_b)
    depth = torch.where(found, torch.where(ok, alpha, 0.5 * (hit_a + hit_b)),
                        0.0)
    # ray length -> the camera's depth convention
    if cam.model == C.PINHOLE:
        depth = depth * ray_cam[:, 2]
    return (depth.reshape(cam.rows, cam.cols),
            found.reshape(cam.rows, cam.cols))
