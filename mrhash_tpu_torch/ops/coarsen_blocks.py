"""Kernels K10-K12: variance-adaptive coarsening on the card.

K10 takes the decided window entries in window order (at most
max_coarsen_per_frame), frees their table slots, pushes their block ids
on the heaps and splits high blocks where the low heap is short; K11
merges each served fine block into a staging buffer of 64 coarse voxels
and clears its window; K9 (ops/alloc_blocks.py) inserts the keys at
res 1; K12 copies the staged voxels into the blocks K9 drew.  The CUDA
source is csrc/coarsen_blocks.cu; its header comment gives the design.
They replace no TPU kernel: the JAX package coarsens with jnp ops.  The
plain PyTorch twin is ops/integrate.py's coarsen_by_variance_ref: the
table, the heaps, the served entries, weight and colour equal it bit for
bit, sdf and sumsq to rounding (PORT_NOTES.md P71).

A coarsening step on the card is five launches (K10, K11, K9's two
kernels, K12) and two counted host reads: K10's counts (the served
entries, the heaps' new free counts, which set table.high_count and
table.low_count before K9 takes them as scalars) and K9's own.
ops/integrate.py::coarsen_by_variance dispatches on the device
(alloc_blocks.on_card).  utils/profiler.COUNTS counts the launches under
"coarsen_select" (K10), "coarsen_merge" (K11) and "coarsen_scatter"
(K12).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import VoxelPool
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS, host_list

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


def coarsen(cfg, table, pool, slots, bpos, decide):
    """integrate.coarsen_by_variance_ref's semantics on the card, updating
    `table` and `pool` in place: K10, its host read, K11, K9 (with its
    host read), K12.  Returns (new_slots i64[n], new_mask bool[n], freed
    bool[A])."""
    freed, keys, fptr, fres, stats = select(
        cfg, table, slots.contiguous(), bpos.contiguous(),
        decide.contiguous())
    n, table.high_count, table.low_count, _ = host_list(stats)
    if n == 0:
        none = torch.empty((0,), dtype=torch.int64, device=decide.device)
        return none, none.bool(), freed
    stage = merge(cfg, pool, fptr, fres, n)
    info, _ = AB.insert(table, keys[:n], 1)
    if stage is not None:
        scatter(pool, stage, info["was_new"], info["ptr"])
    return info["slot"], info["was_new"], freed
