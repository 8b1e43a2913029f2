"""Container state: hash table + row-structured voxel pool + frame counter.

Port of mrhash_tpu/core/state.py.  The pool keeps the reference layout —
one 512-lane row per res-0 block, SoA fields sdf f32, sumsq f32, weight i32
(u8 semantics, cap 255) and rgbp i32 (r | g<<8 | b<<16) — so a block's ptr
is row*512 exactly as in the JAX package and states convert 1:1
(core/convert.py).  Unlike the JAX pytrees these containers are mutable:
the frame step updates pool rows and table slots in place.
"""
from __future__ import annotations

import dataclasses

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.ops import hashtable as H

LANES = P.TOTAL_SDF_BLOCK_SIZE


@dataclasses.dataclass
class VoxelPool:
    sdf: torch.Tensor     # f32[N,512]
    sumsq: torch.Tensor   # f32[N,512]
    weight: torch.Tensor  # i32[N,512] (u8 semantics)
    rgbp: torch.Tensor    # i32[N,512] packed r | g<<8 | b<<16

    FIELDS = ("sdf", "sumsq", "weight", "rgbp")


def pack_rgb(rgb):
    """u8/int [...,3] -> packed int32 lane."""
    rgb = rgb.to(torch.int32)
    return rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16)


def unpack_rgb(rgbp):
    """packed int32 lane -> int32 [...,3] channels."""
    return torch.stack([rgbp & 255, (rgbp >> 8) & 255, (rgbp >> 16) & 255],
                       dim=-1)


def make_pool(num_blocks: int, device) -> VoxelPool:
    shape = (num_blocks, LANES)
    return VoxelPool(
        sdf=torch.zeros(shape, dtype=torch.float32, device=device),
        sumsq=torch.zeros(shape, dtype=torch.float32, device=device),
        weight=torch.zeros(shape, dtype=torch.int32, device=device),
        rgbp=torch.zeros(shape, dtype=torch.int32, device=device))


@dataclasses.dataclass
class MapState:
    table: H.HashTable
    pool: VoxelPool
    frame: int = 0   # num_integrated_frames_


def make_state(num_blocks: int, num_buckets: int | None = None,
               device="cpu") -> MapState:
    return MapState(table=H.make_table(num_blocks, num_buckets, device),
                    pool=make_pool(num_blocks, device), frame=0)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Configuration of the port.  Every field has the name and default of
    its mrhash_tpu.core.state.MapConfig counterpart; the TPU-only knobs
    (sample_mode, pallas_interpret, resident_*, occupied_bucket,
    alloc_miss_tier, starve_bands, starve_band_cap, gc_free_tier, the
    patch/fallback budgets and the multi-resolution queue sizes) are left
    out — eager torch has no static shapes to tier and the kernels sample
    the frame directly."""
    virtual_voxel_size: float = 0.05
    voxel_extents: tuple = (1.0, 1.0, 1.0)   # metric chunk scale (streamer)
    sdf_truncation: float = 0.1
    sdf_truncation_scale: float = 0.0
    integration_weight_sample: int = 1
    integration_weight_max: int = P.INTEGRATION_WEIGHT_MAX
    max_integration_distance: float = 30.0
    n_frames_invalidate_voxels: int = 0      # 0 = garbage collection off
    sdf_var_threshold: float = 0.0           # must stay 0: single-res only
    min_weight_threshold: int = 1
    marching_cubes_threshold: float = 1.5
    vertices_merging_threshold: float = 0.0

    # --- capacities ---------------------------------------------------------
    num_blocks: int = 1 << 17
    num_buckets: int = 0                     # 0 -> num_blocks
    max_active_blocks: int = 1 << 16         # cap of the in-frustum window
    max_alloc_per_frame: int = 1 << 14       # unique new blocks per frame
    dedup_scratch_factor: int = 16           # scratch cells per alloc slot
    alloc_rounds: int = 1                    # salted dedup+insert passes
    alloc_pixel_stride: int = 2              # stagger candidates over s^2 frames
    alloc_tile: int = 0                      # >1: per-tile min/max band alloc
    dda_extra_steps: int = 3
    max_gc_free_per_frame: int = 1 << 10     # GC free+clear set per frame

    @property
    def metric_block_size(self) -> float:
        return P.SDF_BLOCK_SIZE * self.virtual_voxel_size

    def dda_steps(self, max_depth: float) -> int:
        """DDA trip count covering the truncation band (same formula as the
        reference MapConfig.dda_steps)."""
        t = self.sdf_truncation + self.sdf_truncation_scale * max_depth
        band = 2.0 * t * (3.0 ** 0.5)
        return int(band / self.metric_block_size + 0.999) + self.dda_extra_steps
