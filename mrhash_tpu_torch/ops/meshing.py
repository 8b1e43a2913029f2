"""Voxel queries of the meshing module (port of mrhash_tpu/ops/meshing.py).

Only `get_voxel` so far: the Gaussian seeding's weight == 1 gate reads it
(gs/container.py::check_nodes).  The device mesh sweep is still to port
(ROADMAP A7); `GeoWrapper.extractMesh` runs the host-native sweep.
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, VoxelPool, unpack_rgb
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H


def get_voxel(cfg: MapConfig, table: H.HashTable, pool: VoxelPool, pos):
    """getVoxel(world) (voxel_data_structures.cu:162-205): the nearest
    virtual voxel's stored value at the owning block's resolution.

    pos f32[...,3].  Returns (sdf f32, weight i32, rgb f32[...,3] in 0-255,
    res i32, found bool), each of pos's leading shape; zeros where the
    block is not allocated."""
    vvs = cfg.virtual_voxel_size
    pi = X.world_point_to_virtual_voxel_pos(vvs, pos)
    blk = X.virtual_voxel_pos_to_sdf_block(pi, vvs, cfg.voxel_extents)
    shape = pi.shape[:-1]
    found, _, ptr, res = H.lookup(table, blk.reshape(-1, 3))
    found = found.reshape(shape)
    ptr = ptr.reshape(shape).to(torch.int64)
    res = res.reshape(shape)

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
