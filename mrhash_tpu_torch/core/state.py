"""Container state: hash table + row-structured voxel pool + frame counter.

Port of mrhash_tpu/core/state.py.  The pool keeps the reference layout —
one 512-lane row per res-0 block, and for a res-1 block the 64-lane window
[ptr, ptr + 64) of a row that up to 8 siblings share (low id l at lanes
[(l%8)*64, (l%8)*64 + 64) of row l//8); SoA fields sdf f32, sumsq f32,
weight i32 (u8 semantics, cap 255) and rgbp i32 (r | g<<8 | b<<16) — so a
block's voxel v lies at flat index ptr + v exactly as in the JAX package
and states convert 1:1 (core/convert.py).  Unlike the JAX pytrees these
containers are mutable: the frame step updates the pool's block windows
and the table slots in place.
"""
from __future__ import annotations

import dataclasses

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.utils.profiler import host_list, put

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


def window_voxels(ptr, res):
    """Flat pool index i64[A,512] of each lane of each block's window
    (lane v of a block is its voxel v at ptr + v) and the lanes' validity
    bool[A,512]: all 512 for res 0, the first 64 for res 1, whose other
    lanes repeat its last voxel's index."""
    lanes = torch.arange(LANES, dtype=torch.int64, device=ptr.device)
    nvox = torch.where(res == 1, P.TOTAL_LOW_BLOCK_SIZE, LANES)[:, None]
    vidx = ptr.to(torch.int64)[:, None] + torch.minimum(lanes, nvox - 1)
    return vidx, lanes < nvox


def put_windows(field, vidx, valid, vals):
    """Write window-layout values [A,512] to their voxels: every lane, the
    lanes past a res-1 window carrying its last voxel's value to its last
    voxel's index, so that repeated indices write equal values.  No
    boolean indexing, so no device sync (CUDA graphs can capture it)."""
    last = vals[:, P.TOTAL_LOW_BLOCK_SIZE - 1:P.TOTAL_LOW_BLOCK_SIZE]
    field.view(-1).index_put_((vidx,), torch.where(valid, vals, last))


def clear_blocks(pool: VoxelPool, bptr, bres):
    """deleteVoxel over whole blocks (voxel_data_structures.cu:1838-1842):
    zero the blocks' windows, a res-0 block's row and a res-1 block's 64
    lanes (their siblings' windows in the same row stay)."""
    vidx, _ = window_voxels(bptr, bres)
    for f in VoxelPool.FIELDS:
        put(getattr(pool, f).view(-1), vidx, 0)


def check_windows(ptr, res, n_rows: int, other_bad=None) -> int:
    """Raise ValueError unless every (ptr, res) names a window inside a pool
    of n_rows rows, aligned to its size (512 for res 0, 64 for res 1), and
    `other_bad` (a caller's own bool check, (message, tensor)) holds no
    True.  Returns the number of res-1 entries (one device sync)."""
    nvox = torch.where(res == 1, P.TOTAL_LOW_BLOCK_SIZE, LANES)
    p = ptr.to(torch.int64)
    bad = (((res != 0) & (res != 1)) | (p < 0) | (p + nvox > n_rows * LANES)
           | (p % nvox != 0)).any()
    other = other_bad[1].any() if other_bad else torch.zeros_like(bad)
    n_bad, n_other, n1 = host_list(torch.stack([bad.to(torch.int64),
                                                other.to(torch.int64),
                                                (res == 1).sum()]))
    if n_bad:
        raise ValueError(f"ptr/res: a window outside a pool of {n_rows} "
                         "rows, misaligned, or a resolution other than 0/1")
    if n_other:
        raise ValueError(other_bad[0])
    return n1


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
    # bool[capacity] or None: the slots whose coarsening decision is taken
    # again on the next LiDAR scan even beyond the sensor's reach
    # (core/pipeline.py::integrate_points)
    coarsen_pending: torch.Tensor = None
    # () -> bool, or None: frees high blocks when a frame's allocation has
    # run the high heap dry, and tells whether it freed any
    # (ops/integrate.py::alloc_blocks; GeoWrapper streams far blocks out)
    refill: object = None


def coarsen_pending(state: MapState):
    """state.coarsen_pending, made (no slot marked) on first use."""
    if state.coarsen_pending is None:
        state.coarsen_pending = torch.zeros(
            state.table.capacity, dtype=torch.bool,
            device=state.table.ptr.device)
    return state.coarsen_pending


def make_state(num_blocks: int, num_buckets: int | None = None,
               device="cpu") -> MapState:
    return MapState(table=H.make_table(num_blocks, num_buckets, device),
                    pool=make_pool(num_blocks, device), frame=0)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Configuration of the port.  Every field has the name and default of
    its mrhash_tpu.core.state.MapConfig counterpart; the TPU-only knobs
    (sample_mode, pallas_interpret, resident_*, occupied_bucket,
    alloc_miss_tier, starve_bands, starve_band_cap, gc_free_tier,
    coarsen_tier and the patch/fallback budgets) are left out — eager torch
    has no static shapes to tier and the kernels sample the frame
    directly."""
    virtual_voxel_size: float = 0.05
    voxel_extents: tuple = (1.0, 1.0, 1.0)   # metric chunk scale (streamer)
    sdf_truncation: float = 0.1
    sdf_truncation_scale: float = 0.0
    integration_weight_sample: int = 1
    integration_weight_max: int = P.INTEGRATION_WEIGHT_MAX
    max_integration_distance: float = 30.0
    n_frames_invalidate_voxels: int = 0      # 0 = garbage collection off
    sdf_var_threshold: float = 0.0           # 0 = single-resolution
    # coarsening merges the fine block's observations into the coarse one
    # (_downsample_into_coarse); False deletes them, as the CUDA original
    coarsen_downsample: bool = True
    min_weight_threshold: int = 1
    marching_cubes_threshold: float = 1.5
    vertices_merging_threshold: float = 0.0
    # LiDAR SDF: True = projective (range difference; the frame step runs
    # kernel K3's voxel-centric update), False = point-to-plane through
    # the point-centric walk (ops/integrate.py::integrate_points_sdf)
    projective_sdf: bool = True

    # --- capacities ---------------------------------------------------------
    num_blocks: int = 1 << 17
    num_buckets: int = 0                     # 0 -> num_blocks
    max_active_blocks: int = 1 << 16         # cap of the in-frustum window
    max_alloc_per_frame: int = 1 << 14       # unique new blocks per frame
    dedup_scratch_factor: int = 16           # scratch cells per alloc slot
    alloc_pixel_stride: int = 2              # stagger candidates over s^2 frames
    alloc_tile: int = 0                      # >1: per-tile min/max band alloc
    dda_extra_steps: int = 3
    max_gc_free_per_frame: int = 1 << 10     # GC free+clear set per frame
    max_coarsen_per_frame: int = 1 << 10     # coarsen decisions served per
    #                                          frame, window order; the rest
    #                                          decide again next frame
    low_split_chunk: int = 1 << 10           # high blocks split per refill

    def __post_init__(self):
        # weights are u8 in the host layout and the checkpoint: the
        # reference clips them to 255 in every stream-out pack and clamps
        # this cap at its setter; the port rejects a larger cap once, here
        # (PORT_NOTES.md P35)
        if not 0 < self.integration_weight_max <= 255:
            raise ValueError("integration_weight_max must lie in [1, 255], "
                             f"got {self.integration_weight_max}")

    @property
    def metric_block_size(self) -> float:
        return P.SDF_BLOCK_SIZE * self.virtual_voxel_size

    def dda_steps(self, max_depth: float) -> int:
        """DDA trip count covering the truncation band (same formula as the
        reference MapConfig.dda_steps)."""
        t = self.sdf_truncation + self.sdf_truncation_scale * max_depth
        band = 2.0 * t * (3.0 ** 0.5)
        return int(band / self.metric_block_size + 0.999) + self.dda_extra_steps

    def dda_voxel_steps(self, max_depth: float) -> int:
        """Voxel-level trip count of the point-centric walk (same formula
        as the reference MapConfig.dda_voxel_steps)."""
        t = self.sdf_truncation + self.sdf_truncation_scale * max_depth
        band = 2.0 * t * (3.0 ** 0.5)
        return (int(band / self.virtual_voxel_size + 0.999)
                + self.dda_extra_steps)
