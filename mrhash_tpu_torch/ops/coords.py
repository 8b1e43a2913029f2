"""Coordinate transforms: world <-> virtual-voxel <-> SDF-block <-> linear index.

Port of mrhash_tpu/ops/coords.py (same functions, same f32 arithmetic, same
dense res-1 linearization fix).  All functions broadcast over leading
dimensions; coordinates ride in a trailing axis of size 3.
"""
from __future__ import annotations

import functools

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.utils.profiler import upload


@functools.lru_cache(maxsize=None)
def on_device(values, device: torch.device):
    """A number or a tuple as an f32 tensor on `device`, built once.  The
    frame step and the mesh sweep pass the voxel size and
    cfg.voxel_extents to the transforms below so: a tuple would be
    uploaded on every call (an upload from host memory is a host sync),
    and on a card a quotient by a Python number is a product with its
    reciprocal, an ulp off the CPU's and the reference's at exact voxel
    boundaries (PORT_NOTES.md P55)."""
    return upload(values, device, torch.float32)


def _factor(v):
    """A voxel size as a multiplier: an f32 tensor as it is, else a
    float."""
    return v if torch.is_tensor(v) else float(v)


def virtual_voxel_pos_to_world(virtual_voxel_size, voxel_pos):
    """voxel_hash_utils.cuh:66-72 — integer/float voxel coords -> metres."""
    return voxel_pos.to(torch.float32) * _factor(virtual_voxel_size)


def _sign_aware_floor(x, eps=P.COORD_EPSILON):
    """floor for x>=0, ceil for x<0, each nudged by eps toward zero bias."""
    x = x.to(torch.float32)
    return torch.where(x >= 0, torch.floor(x + eps), torch.ceil(x - eps))


def virtual_voxel_pos_to_sdf_block(virtual_voxel_pos, virtual_voxel_size,
                                   voxel_extents, block_size=P.SDF_BLOCK_SIZE):
    """voxel_hash_utils.cuh:75-103 — virtual voxel coords -> owning block."""
    vp = virtual_voxel_pos
    vp = torch.where(vp < 0, vp - (block_size - 1), vp)
    pw = virtual_voxel_pos_to_world(virtual_voxel_size, vp)
    metric_block = (torch.as_tensor(voxel_extents, dtype=torch.float32,
                                    device=pw.device)
                    * float(P.SDF_BLOCK_SIZE) * _factor(virtual_voxel_size))
    return _sign_aware_floor(pw / metric_block).to(torch.int32)


def linearize_voxel_pos(local_pos, block_size=P.SDF_BLOCK_SIZE):
    """voxel_hash_utils.cuh:106-108 — local (x,y,z) -> flat index, z-major."""
    return (local_pos[..., 2] * block_size * block_size
            + local_pos[..., 1] * block_size + local_pos[..., 0])


def delinearize_voxel_pos(index, block_size=P.SDF_BLOCK_SIZE):
    """voxel_hash_utils.cuh:130-136 — flat index -> local (x,y,z)."""
    size2 = block_size * block_size
    x = index % block_size
    y = (index % size2) // block_size
    z = index // size2
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def block_voxel_grid(bpos, bres, lane0=None):
    """Virtual-voxel coords i32[A,512,3] and lane validity bool[A,512] of
    each block's lattice: 8^3 for res 0, 4^3 at twice the spacing for res 1
    (integrateDepthMapKernel's scaled delinearization,
    voxel_data_structures.cu:1114-1118, with the dense res-1 indexing).
    Without lane0 the lanes are in window layout (lane v = voxel v); with
    lane0 they address the block's row (a res-1 block's voxels at lanes
    [lane0, lane0 + 64)), as the reference's row layout."""
    n = P.TOTAL_SDF_BLOCK_SIZE
    lanes = torch.arange(n, dtype=torch.int32, device=bpos.device)
    local = (lanes[None, :] if lane0 is None
             else lanes[None, :] - lane0.to(torch.int32)[:, None])
    is_low = (bres == 1)[:, None]
    nvox = torch.where(is_low, P.TOTAL_LOW_BLOCK_SIZE, n)
    lane_valid = (local >= 0) & (local < nvox)
    off8 = delinearize_voxel_pos(torch.clamp(local, 0, n - 1),
                                 P.SDF_BLOCK_SIZE)
    off4 = delinearize_voxel_pos(
        torch.clamp(local, 0, P.TOTAL_LOW_BLOCK_SIZE - 1),
        P.LOW_BLOCK_SIZE) * 2
    offs = torch.where(is_low[..., None], off4, off8)
    return sdf_block_to_virtual_voxel_pos(bpos)[:, None, :] + offs, \
        lane_valid


def virtual_voxel_pos_to_block_index(virtual_voxel_pos,
                                     block_size=P.SDF_BLOCK_SIZE):
    """Local index of a virtual voxel inside its block, dense per
    resolution (voxel_hash_utils.cuh:110-128 with the dense-stride fix)."""
    scaling = P.SDF_BLOCK_SIZE // block_size
    local = torch.remainder(virtual_voxel_pos, P.SDF_BLOCK_SIZE)
    local = local // scaling
    return linearize_voxel_pos(local, block_size)


def sdf_block_to_virtual_voxel_pos(sdf_block):
    """voxel_hash_utils.cuh:138-140."""
    return sdf_block * P.SDF_BLOCK_SIZE


def world_point_to_virtual_voxel_pos(virtual_voxel_size, point):
    """voxel_hash_utils.cuh:143-151 — nearest virtual voxel (round half
    away from zero).  virtual_voxel_size: an f32 tensor on the point's
    device (on_device), or on the CPU also a number: on a card only the
    tensor gives the correctly rounded quotient (CUDA divides by a Python
    number as a product with its reciprocal, which can be an ulp off), so
    a number there raises."""
    if not torch.is_tensor(virtual_voxel_size):
        if point.device.type != "cpu":
            raise ValueError("world_point_to_virtual_voxel_pos: pass the "
                             "voxel size as a tensor on the point's device "
                             "(coords.on_device)")
        virtual_voxel_size = float(virtual_voxel_size)
    p = point.to(torch.float32) / virtual_voxel_size
    approx = p + torch.sign(p) * 0.5
    return _sign_aware_floor(approx).to(torch.int32)


def world_point_to_sdf_block(virtual_voxel_size, voxel_extents, point):
    """voxel_hash_utils.cuh:157-161."""
    return virtual_voxel_pos_to_sdf_block(
        world_point_to_virtual_voxel_pos(virtual_voxel_size, point),
        virtual_voxel_size, voxel_extents)


def sdf_block_to_world_point(virtual_voxel_size, sdf_block):
    """voxel_hash_utils.cuh:163-165."""
    return virtual_voxel_pos_to_world(virtual_voxel_size,
                                      sdf_block_to_virtual_voxel_pos(sdf_block))


def get_truncation(z, sdf_truncation, sdf_truncation_scale):
    """voxel_hash_utils.cuh:184-187 — linear-in-depth truncation band."""
    return sdf_truncation + sdf_truncation_scale * z


def world_to_chunks(pw, voxel_extents):
    """voxel_hash_utils.cuh:211-223 — world point -> chunk coords
    (truncation of p + sign(p)/2 = round half away from zero)."""
    p = pw.to(torch.float32) / torch.as_tensor(voxel_extents,
                                               dtype=torch.float32,
                                               device=pw.device)
    return torch.trunc(p + torch.sign(p) * 0.5).to(torch.int32)


def combine_voxel(sdf0, w0, rgb0, sdf1, w1, rgb1,
                  integration_weight_max=P.INTEGRATION_WEIGHT_MAX):
    """voxel_hash_utils.cuh:167-181 — weighted SDF merge + the reference's
    deliberate 50/50 colour blend.  Weights are int32 with u8 semantics."""
    w0f = w0.to(torch.float32)
    w1f = w1.to(torch.float32)
    rgb = torch.floor(0.5 * rgb0.to(torch.float32)
                      + 0.5 * rgb1.to(torch.float32) + 0.5).to(torch.uint8)
    sdf = (sdf0 * w0f + sdf1 * w1f) / (w0f + w1f)
    w = torch.clamp(w0 + w1, max=integration_weight_max)
    return sdf, w, rgb


def norm3(v):
    """Euclidean norm over the last axis, summed x, y, z in order (keeps
    the axis)."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return torch.sqrt(x * x + y * y + z * z)


def unit(v):
    """(v / |v| with a zero vector kept zero, |v| f32[...])."""
    n = norm3(v)
    return v / torch.where(n == 0, 1.0, n), n[..., 0]
