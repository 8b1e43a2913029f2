"""Variance-adaptive coarsening: kernels K10-K12, their plain PyTorch
twin, and the choice between them.

K10 takes the decided window entries in window order (at most
max_coarsen_per_frame), frees their table slots, pushes their block ids
on the heaps and splits high blocks where the low heap is short; K11
merges each served fine block into a staging buffer of 64 coarse voxels
and clears its window; K9 (ops/alloc_blocks.py) inserts the keys at
res 1; K12 copies the staged voxels into the blocks K9 drew.  The CUDA
source is csrc/coarsen_blocks.cu; its header comment gives the design.
They replace no TPU kernel: the JAX package coarsens with jnp ops.  The
twin is coarsen_by_variance_ref (with _downsample_into_coarse): the
table, the heaps, the served entries, weight and colour equal it bit for
bit, sdf and sumsq to rounding (PORT_NOTES.md P71).

`coarsen` is the entry: CUDA tensors take the kernels, CPU tensors the
twin (cuda_lib.on_card).  A coarsening step on the card is five launches
(K10, K11, K9's two kernels, K12) and two counted host reads: K10's
counts (the served entries, the heaps' new free counts, which set
table.high_count and table.low_count before K9 takes them as scalars)
and K9's own.  utils/profiler.COUNTS counts the launches under
"coarsen_select" (K10), "coarsen_merge" (K11) and "coarsen_scatter"
(K12).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import (LANES, MapConfig, VoxelPool,
                                         clear_blocks, pack_rgb, unpack_rgb)
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.utils.profiler import COUNTS, host_list, pick, put

_p = cuda_lib.ptr
FIELDS = VoxelPool.FIELDS
DTYPES = dict(sdf=torch.float32, sumsq=torch.float32, weight=torch.int32,
              rgbp=torch.int32)


def _pool_ptrs(pool, dev):
    for f in FIELDS:
        cuda_lib.expect(getattr(pool, f), f"pool.{f}", DTYPES[f],
                        (None, P.TOTAL_SDF_BLOCK_SIZE), dev)
    return [_p(getattr(pool, f)) for f in FIELDS]


def select(cfg, table, slots, bpos, decide):
    """K10 without the host read (CUDA-graph safe).  slots i64[A], bpos
    i32[A,3] and decide bool[A] of the window.  Returns (freed bool[A],
    keys i32[k,3], fptr i32[k], fres i32[k], stats i32[4]), k =
    min(max_coarsen_per_frame, A): the served entries' key rows, ptrs and
    res in window order (rows past the count not written), and in stats
    the served count and the heaps' new free counts, all on the card;
    the table is updated in place but for its Python counts."""
    dev = decide.device
    a = decide.shape[0]
    e = cuda_lib.expect
    e(decide, "decide", torch.bool, (a,), dev)
    e(slots, "slots", torch.int64, (a,), dev)
    e(bpos, "bpos", torch.int32, (a, 3), dev)
    cap = table.capacity
    e(table.pos, "table.pos", torch.int32, (cap, 3), dev)
    for name in ("ptr", "res", "fp"):
        e(getattr(table, name), f"table.{name}", torch.int32, (cap,), dev)
    e(table.heap_high, "table.heap_high", torch.int32, (None,), dev)
    e(table.heap_low, "table.heap_low", torch.int32, (None,), dev)
    k = min(int(cfg.max_coarsen_per_frame), a)
    freed = torch.empty((a,), dtype=torch.bool, device=dev)
    keys = torch.empty((k, 3), dtype=torch.int32, device=dev)
    fptr = torch.empty((k,), dtype=torch.int32, device=dev)
    fres = torch.empty((k,), dtype=torch.int32, device=dev)
    stats = torch.empty((AB.STATS,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_coarsen_select(
            _p(decide), _p(slots), _p(bpos), a, k, _p(table.pos),
            _p(table.ptr), _p(table.res), _p(table.fp), _p(table.heap_high),
            table.heap_high.shape[0], table.high_count, _p(table.heap_low),
            table.heap_low.shape[0], table.low_count,
            int(cfg.low_split_chunk), _p(freed), _p(keys), _p(fptr),
            _p(fres), _p(stats), cuda_lib.stream_of(decide))
    cuda_lib.check(rc, "coarsen_select")
    COUNTS["coarsen_select"] += 1
    return freed, keys, fptr, fres, stats


def merge(cfg, pool, fptr, fres, n: int):
    """K11 over the first n served blocks: with cfg.coarsen_downsample
    their fine rows merged into a staging buffer {field: [n,64]} (returned;
    None without the merge), and their windows cleared."""
    dev = fptr.device
    ptrs = _pool_ptrs(pool, dev)
    stage = ({f: torch.empty((n, P.TOTAL_LOW_BLOCK_SIZE), dtype=DTYPES[f],
                             device=dev) for f in FIELDS}
             if cfg.coarsen_downsample else None)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_coarsen_merge(
            _p(fptr), _p(fres), n, *ptrs, int(stage is not None),
            float(cfg.virtual_voxel_size) / 2.0,
            float(cfg.integration_weight_max),
            *([_p(stage[f]) for f in FIELDS] if stage else [None] * 4),
            cuda_lib.stream_of(fptr))
    cuda_lib.check(rc, "coarsen_merge")
    COUNTS["coarsen_merge"] += 1
    return stage


def scatter(pool, stage, was_new, nptr):
    """K12: the staged voxels of each row with was_new (bool[n]) to the 64
    lanes at nptr (i32[n])."""
    dev = was_new.device
    n = was_new.shape[0]
    cuda_lib.expect(nptr, "nptr", torch.int32, (n,), dev)
    ptrs = _pool_ptrs(pool, dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_coarsen_scatter(
            _p(was_new), _p(nptr), n, *[_p(stage[f]) for f in FIELDS],
            *ptrs, cuda_lib.stream_of(was_new))
    cuda_lib.check(rc, "coarsen_scatter")
    COUNTS["coarsen_scatter"] += 1


def coarsen(cfg: MapConfig, table: H.HashTable, pool: VoxelPool, slots,
            bpos, decide):
    """checkVarSDFKernel + reallocBlocks (voxel_data_structures.cu:
    1856-2069), in place: coarsen_by_variance_ref's semantics.  CPU
    tensors take the twin coarsen_by_variance_ref; CUDA tensors kernels
    K10-K12 with the insert through K9: K10, its host read, K11, K9 (with
    its host read), K12.  Returns (new_slots i64[n], new_mask bool[n],
    freed bool[A]) as the twin's."""
    if not cuda_lib.on_card(decide.device):
        return coarsen_by_variance_ref(cfg, table, pool, slots, bpos, decide)
    freed, keys, fptr, fres, stats = select(
        cfg, table, slots.contiguous(), bpos.contiguous(),
        decide.contiguous())
    n, table.high_count, table.low_count, _ = host_list(stats)
    if n == 0:
        none = torch.empty((0,), dtype=torch.int64, device=decide.device)
        return none, none.bool(), freed
    stage = merge(cfg, pool, fptr, fres, n)
    info = AB.insert(table, keys[:n], 1)
    if stage is not None:
        scatter(pool, stage, info["was_new"], info["ptr"])
    return info["slot"], info["was_new"], freed


def coarsen_by_variance_ref(cfg: MapConfig, table: H.HashTable,
                            pool: VoxelPool, slots, bpos, decide):
    """checkVarSDFKernel + reallocBlocks (voxel_data_structures.cu:
    1856-2069), in place, in torch ops on any device: the plain twin of
    kernels K10-K12, and what the CPU runs.
    Serve at most cfg.max_coarsen_per_frame decided res-0 window entries
    (window order; the rest stay fine and decide again next frame), free
    them and snapshot their rows, clear the rows, split high blocks when
    the low heap is short (allocateMemoryLow), insert the keys at res 1
    and, with cfg.coarsen_downsample, merge the fine observations into the
    coarse blocks (_downsample_into_coarse).

    Returns (new_slots i64[u], new_mask bool[u], freed bool[A]): the table
    slots of the coarse blocks, which of them were inserted, and the window
    entries freed (later passes over this frame's window skip them: their
    slots are free and their rows cleared, or already a coarse block's)."""
    sel = H.compact_indices(decide, int(cfg.max_coarsen_per_frame))
    ptrs, fres = H.free_slots(table, slots[sel])   # window slots: occupied
    rows = ptrs.to(torch.int64) // LANES             # res-0 rows
    fine = ({f: getattr(pool, f)[rows] for f in VoxelPool.FIELDS}
            if cfg.coarsen_downsample else None)
    clear_blocks(pool, ptrs, fres)
    freed = torch.zeros(decide.shape[0], dtype=torch.bool,
                        device=decide.device)
    put(freed, sel, True)
    if table.low_count < sel.numel():
        H.split_high_blocks(table, int(cfg.low_split_chunk))
    info = AB.insert(table, bpos[sel], torch.ones(
        sel.numel(), dtype=torch.int32, device=bpos.device))
    new = info["was_new"]
    if fine is not None:
        _downsample_into_coarse(cfg, table, pool,
                                {f: pick(v, new) for f, v in fine.items()},
                                pick(info["slot"], new))
    return info["slot"], new, freed


def _downsample_into_coarse(cfg: MapConfig, table: H.HashTable,
                            pool: VoxelPool, fine, new_slots):
    """Merge freed fine blocks' accumulated observations (rows `fine`,
    [u,512] per field) into their coarse replacements at table slots
    `new_slots`: each coarse voxel takes the weight sum, the de-biased
    weighted-mean SDF and the weighted-mean colour of its 8 children, with
    sumsq combined by the parallel-variance formula (Chan) under the
    integration's half-voxel normalization.  The reference's improvement
    over the CUDA original, which deletes the data and reintegrates only
    the current frame (voxel_data_structures.cu:1929-2018).  Each coarse
    block's 64-lane window is written in place (it was cleared when its
    id was freed)."""
    u = new_slots.shape[0]
    half_voxel = cfg.virtual_voxel_size / 2.0
    # fine lane = z*64 + y*8 + x  ->  [u, cz,dz, cy,dy, cx,dx]
    shape6 = (u, 4, 2, 4, 2, 4, 2)
    ax = (2, 4, 6)
    wf = fine["weight"].to(torch.float32).reshape(shape6)
    sd = fine["sdf"].reshape(shape6)
    ssq = torch.where(wf > 0, fine["sumsq"].reshape(shape6), 0.0)
    rgb = unpack_rgb(fine["rgbp"]).to(torch.float32).reshape(shape6 + (3,))
    wsd = wf * sd

    w_c = wf.sum(dim=ax)                                      # [u,4,4,4]
    w_safe = torch.clamp(w_c, min=1.0)
    m_c = wsd.sum(dim=ax) / w_safe
    # de-bias: the coarse voxel's centre is its (0,0,0) child, not the
    # children's weighted centroid (+0.5 fine voxel per axis); correct the
    # mean by the per-axis SDF step times the centroid offset, on axes
    # with data on both sides
    corr = torch.zeros_like(m_c)
    for a in ax:                                # dz, dy, dx child axes
        other = tuple(b - (b > a) for b in ax if b != a)
        w_lo = wf.select(a, 0).sum(dim=other)
        w_hi = wf.select(a, 1).sum(dim=other)
        m_lo = wsd.select(a, 0).sum(dim=other) / torch.clamp(w_lo, min=1.0)
        m_hi = wsd.select(a, 1).sum(dim=other) / torch.clamp(w_hi, min=1.0)
        corr = corr + torch.where((w_lo > 0) & (w_hi > 0),
                                  (w_hi / w_safe) * (m_hi - m_lo), 0.0)
    m_c = m_c - corr

    dev = (sd - m_c[:, :, None, :, None, :, None]) / half_voxel
    ssq_c = (ssq + wf * dev * dev).sum(dim=ax)
    rgb_c = (wf[..., None] * rgb).sum(dim=ax) / w_safe[..., None]
    occ = w_c > 0

    # coarse lane = cz*16 + cy*4 + cx (the reshape order)
    new = dict(
        sdf=torch.where(occ, m_c, 0.0),
        sumsq=torch.where(occ, ssq_c, 0.0),
        weight=torch.clamp(w_c, max=cfg.integration_weight_max).to(
            torch.int32),
        rgbp=pack_rgb(torch.floor(rgb_c + 0.5).to(torch.int32)
                      * occ[..., None].to(torch.int32)))
    vidx = (table.ptr[new_slots].to(torch.int64)[:, None]
            + torch.arange(P.TOTAL_LOW_BLOCK_SIZE, device=new_slots.device))
    for name, vals in new.items():
        getattr(pool, name).view(-1)[vidx.reshape(-1)] = vals.reshape(-1)
