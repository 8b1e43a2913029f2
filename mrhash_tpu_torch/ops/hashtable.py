"""Spatial hash table with batched, atomic-free insert/lookup/free.

Port of mrhash_tpu/ops/hashtable.py: HASH_BUCKET_SIZE primary slots per
bucket plus LINKED_LIST_SIZE linear-overflow probes, a 32-bit fingerprint
filter with an exact compare of the suspects, bucket-rank slot claims with
one scatter-max election, and prefix-sum heap draws — so the same key
stream gives the same slots, ptrs and heap counts as the reference.

The plain table operations, in torch ops on any device.  `insert` is
the plain twin of kernel K9: the port inserts through
ops/alloc_blocks.py::insert, which takes K9 on a card and this twin on
the CPU.  This module imports no kernel module.

Differences from the reference (PORT_NOTES.md):
- the tensors are updated in place, and the heap counts are Python ints;
- the fingerprint-suspect exact compare has no 64-key cap (eager torch
  sizes it to the suspects), so `lookup` never reports an unresolved key;
- the presence cache (pck) is left out: alloc_blocks is bit-identical
  without it (mrhash_tpu/ops/integrate.py:337-339).

uint32 hash arithmetic runs in int64 with `& 0xFFFFFFFF` after each step
(`torch.uint32` lacks most arithmetic); products are split into 16-bit
halves so no int64 intermediate overflows.
"""
from __future__ import annotations

import dataclasses

import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.utils.profiler import (host_int, nonzero, pick, put,
                                             unique_rows)

FREE = P.FREE_ENTRY
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class HashTable:
    pos: torch.Tensor        # i32[C,3]
    ptr: torch.Tensor        # i32[C]   FREE_ENTRY if the slot is free
    res: torch.Tensor        # i32[C]   0 = 8^3 block, 1 = 4^3 block
    fp: torch.Tensor         # i32[C]   key fingerprint, 0 = free slot
    heap_high: torch.Tensor  # i32[N]   free res-0 block ids
    heap_low: torch.Tensor   # i32[8N]  free res-1 block ids
    high_count: int          # free res-0 blocks
    low_count: int           # free res-1 blocks
    num_buckets: int
    num_blocks: int

    @property
    def capacity(self) -> int:
        return self.num_buckets * P.HASH_BUCKET_SIZE


def make_table(num_blocks: int, num_buckets: int | None = None,
               device="cpu") -> HashTable:
    """VoxelContainer buffer init (voxel_data_structures.cpp:57-87):
    heap_high holds ids N-1..0 (descending), heap_low starts empty."""
    if not num_buckets:
        num_buckets = num_blocks
    C = num_buckets * P.HASH_BUCKET_SIZE
    n_low = num_blocks * P.OCTREE_BRANCHING_FACTOR
    i32 = dict(dtype=torch.int32, device=device)
    return HashTable(
        pos=torch.zeros((C, 3), **i32),
        ptr=torch.full((C,), FREE, **i32),
        res=torch.zeros((C,), **i32),
        fp=torch.zeros((C,), **i32),
        heap_high=torch.arange(num_blocks - 1, -1, -1, **i32),
        heap_low=torch.full((n_low,), n_low, **i32),
        high_count=int(num_blocks), low_count=0,
        num_buckets=int(num_buckets), num_blocks=int(num_blocks))


# ---------------------------------------------------------------------------
# uint32 hashing in int64
# ---------------------------------------------------------------------------

def u32(x):
    """int tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & MASK32


def mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) and a constant c."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def to_i32(h):
    """uint32 pattern in int64 -> int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def _avalanche(h):
    """murmur3 finalizer over uint32 values carried in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def fingerprint(block_pos):
    """32-bit key fingerprint for probe filtering (int32, never 0)."""
    x, y, z = (u32(block_pos[..., i]) for i in range(3))
    h = _avalanche(mul32(x, 0x9E3779B1))
    h = _avalanche(h ^ mul32(y, 0x7FEB352D))
    h = _avalanche(h ^ mul32(z, 0x846CA68B))
    return to_i32(torch.where(h == 0, torch.ones_like(h), h))


def calculate_hash(block_pos, num_buckets):
    """voxel_data_structures.cu:150-160 — xor of prime-multiplied coords,
    uint32 wrap-around, mod bucket count.  Returns int64 bucket ids."""
    x, y, z = (u32(block_pos[..., i]) for i in range(3))
    h = mul32(x, P.P0) ^ mul32(y, P.P1) ^ mul32(z, P.P2)
    return h % int(num_buckets)


def probe_slots(bucket, capacity):
    """The NUM_PROBES-slot probe window of a bucket (int64 slot ids)."""
    base = bucket.to(torch.int64) * P.HASH_BUCKET_SIZE
    offs = torch.arange(P.NUM_PROBES, dtype=torch.int64, device=base.device)
    return (base[..., None] + offs) % capacity


def _first_true(mask):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def lookup(table: HashTable, keys):
    """Vectorized getHashEntry (voxel_data_structures.cu:79-127).

    keys i32[M,3].  Returns (found bool[M], slot i64[M] (-1 if absent),
    ptr i32[M] (FREE if absent), res i32[M])."""
    C = table.capacity
    slots = probe_slots(calculate_hash(keys, table.num_buckets), C)
    fpk = fingerprint(keys)
    match = table.fp[slots] == fpk[:, None]                  # [M, NP]
    found = match.any(dim=-1)
    slot = slots.gather(1, _first_true(match)[:, None])[:, 0]
    exact = found & (table.pos[slot] == keys).all(dim=-1)

    # fingerprint-collision suspects: exact compare over the whole window
    sidx = nonzero(found & ~exact)
    if sidx.numel():
        s_slots = slots[sidx]
        s_match = ((table.ptr[s_slots] != FREE)
                   & (table.pos[s_slots] == keys[sidx][:, None, :]).all(-1))
        exact[sidx] = s_match.any(dim=-1)
        slot[sidx] = s_slots.gather(1, _first_true(s_match)[:, None])[:, 0]

    found = exact
    ptr = torch.where(found, table.ptr[slot],
                      torch.full_like(table.ptr[slot], FREE))
    res = torch.where(found, table.res[slot],
                      torch.zeros_like(table.res[slot]))
    slot = torch.where(found, slot, torch.full_like(slot, -1))
    return found, slot, ptr, res


def lookup_dedup(table: HashTable, keys, valid, slot_map):
    """lookup() of a highly duplicated key batch (the point-centric LiDAR
    walk visits ~N*K keys, only ~occupied-blocks distinct ones), exact:
    the distinct valid keys (torch.unique), one exact lookup each, and a
    gather back.  slot_map i64[capacity] maps a table slot to the caller's
    window entry, -1 outside the window.

    Returns (found bool[M], wslot i64[M], lane0 i32[M], res i32[M],
    n_distinct), the reference's slot_map return plus the distinct key
    count: a key is found when the table holds it in a slot of the window;
    wslot is that entry, lane0 a res-1 block's window start in its row (0
    for res 0).  The reference elects one representative per salted
    scratch cell, so distinct keys that share a cell miss this frame (its
    D15); here every distinct key resolves (PORT_NOTES.md P56)."""
    M = keys.shape[0]
    dev = keys.device
    found = torch.zeros(M, dtype=torch.bool, device=dev)
    wslot = torch.zeros(M, dtype=torch.int64, device=dev)
    lane0 = torch.zeros(M, dtype=torch.int32, device=dev)
    res = torch.zeros(M, dtype=torch.int32, device=dev)
    vidx = nonzero(valid)
    if vidx.numel() == 0:
        return found, wslot, lane0, res, 0
    uniq, inv = unique_rows(keys[vidx])
    f, s, p, r = lookup(table, uniq)
    w = torch.where(f, slot_map[s.clamp(min=0)], -1)
    f = f & (w >= 0)
    found[vidx] = f[inv]
    wslot[vidx] = torch.where(f, w, 0)[inv]
    lane0[vidx] = torch.where(f, p % P.TOTAL_SDF_BLOCK_SIZE, 0)[inv]
    res[vidx] = torch.where(f, r, 0)[inv]
    return found, wslot, lane0, res, uniq.shape[0]


def _heap_draw(heap, count: int, want):
    """Draw one free id per True in `want` (prefix-sum ranked).  Returns
    (ids i32[M] (-1 where not drawn), got bool[M], count')."""
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    got = want & (rank < count)
    idx = torch.clamp(count - 1 - rank, 0, heap.shape[0] - 1)
    ids = torch.where(got, heap[idx], torch.full_like(heap[idx], -1))
    return ids, got, count - host_int(got.sum())


def _heap_push(heap, count: int, ids):
    """Return freed ids to a heap (in order, on top).  Returns count'."""
    n = ids.shape[0]
    heap[count:count + n] = ids.to(heap.dtype)
    return count + n


def insert(table: HashTable, keys, res):
    """Batched allocBlock (voxel_data_structures.cu:501-755), atomic-free,
    updating `table` in place: the plain twin of kernel K9, in torch ops
    on any device (alloc_blocks.insert is the entry that picks).

    keys i32[U,3] (distinct, see alloc_blocks.dedup), res i32[U].
    Each key not yet in the table claims the (rank+1)-th free slot of its
    probe window, rank counted among same-bucket pending keys in key order;
    where windows of adjacent buckets overlap, the highest key index wins
    the slot and the losers stagger to a later frame.  Winners draw a block
    from the heap of their resolution; keys whose window is full or whose
    heap is dry are dropped, like the reference's staggered allocator.

    Returns info dict(slot, ptr, res, was_new, present) per key."""
    U = keys.shape[0]
    dev = keys.device
    C = table.capacity
    found, slot_f, ptr_f, res_f = lookup(table, keys)
    new = torch.zeros(U, dtype=torch.bool, device=dev)
    new_slot = torch.full((U,), -1, dtype=torch.int64, device=dev)
    new_ptr = torch.full((U,), FREE, dtype=torch.int32, device=dev)

    pidx = nonzero(~found)
    n = pidx.numel()
    if n:
        pkeys, pres = keys[pidx], res[pidx]
        bucket = calculate_hash(pkeys, table.num_buckets)
        slots_all = probe_slots(bucket, C)                       # [n, NP]
        ar = torch.arange(n, dtype=torch.int64, device=dev)
        order = torch.argsort(bucket, stable=True)
        sb = bucket[order]
        newseg = torch.ones(n, dtype=torch.bool, device=dev)
        newseg[1:] = sb[1:] != sb[:-1]
        seg_start = torch.cummax(torch.where(newseg, ar, 0), 0).values
        rank = torch.empty_like(ar)
        rank[order] = ar - seg_start

        free = table.fp[slots_all] == 0
        cumfree = torch.cumsum(free.to(torch.int64), dim=-1)
        want_pos = rank + 1
        has = cumfree[:, -1] >= want_pos
        sel = _first_true(cumfree == want_pos[:, None])
        slot_p = slots_all.gather(1, sel[:, None])[:, 0]
        prop = torch.full((C,), -1, dtype=torch.int64, device=dev)
        prop.scatter_reduce_(0, pick(slot_p, has), pick(ar, has), "amax")
        winner = has & (prop[slot_p] == ar)

        ids_h, got_h, table.high_count = _heap_draw(
            table.heap_high, table.high_count, winner & (pres == 0))
        ids_l, got_l, table.low_count = _heap_draw(
            table.heap_low, table.low_count, winner & (pres == 1))
        pnew = got_h | got_l
        pptr = torch.where(got_h, ids_h * P.TOTAL_SDF_BLOCK_SIZE,
                           ids_l * P.TOTAL_LOW_BLOCK_SIZE)
        d = pick(slot_p, pnew)
        table.pos[d] = pick(pkeys, pnew)
        table.ptr[d] = pick(pptr, pnew)
        table.res[d] = pick(pres, pnew).to(torch.int32)
        table.fp[d] = fingerprint(pick(pkeys, pnew))
        new[pidx] = pnew
        new_slot[pidx] = torch.where(pnew, slot_p, torch.full_like(slot_p, -1))
        new_ptr[pidx] = torch.where(pnew, pptr, torch.full_like(pptr, FREE))

    return dict(slot=torch.where(found, slot_f, new_slot),
                ptr=torch.where(found, ptr_f, new_ptr),
                res=torch.where(found, res_f, res.to(torch.int32)),
                was_new=new, present=found | new)


def free_slots(table: HashTable, slots):
    """Batched deleteHashEntryElement + heap return
    (voxel_data_structures.cu:1726-1824), in place: clear the occupied
    entries among `slots` and push their block ids back on their heaps.
    Returns (ptrs, res) of the freed entries."""
    slots = slots.to(torch.int64)
    ptrs = table.ptr[slots]
    occ = ptrs != FREE
    slots, ptrs, res = (pick(slots, occ), pick(ptrs, occ),
                        pick(table.res[slots], occ))
    hi = res == 0
    table.high_count = _heap_push(table.heap_high, table.high_count,
                                  pick(ptrs, hi) // P.TOTAL_SDF_BLOCK_SIZE)
    table.low_count = _heap_push(table.heap_low, table.low_count,
                                 pick(ptrs, ~hi) // P.TOTAL_LOW_BLOCK_SIZE)
    put(table.ptr, slots, FREE)
    for field in (table.pos, table.res, table.fp):
        put(field, slots, 0)
    return ptrs, res


def split_high_blocks(table: HashTable, n_split: int):
    """allocateMemoryLow (voxel_data_structures.cu:859-871), in place: pop
    up to n_split res-0 blocks from the high heap and push their 8 sub-block
    ids each, in order, onto the low heap."""
    want = torch.ones(min(n_split, table.high_count), dtype=torch.bool,
                      device=table.heap_high.device)
    ids, _, table.high_count = _heap_draw(table.heap_high, table.high_count,
                                          want)
    sub = (ids[:, None] * P.OCTREE_BRANCHING_FACTOR
           + torch.arange(P.OCTREE_BRANCHING_FACTOR, dtype=ids.dtype,
                          device=ids.device)).reshape(-1)
    table.low_count = _heap_push(table.heap_low, table.low_count, sub)


def compact_indices(mask, k: int):
    """Positions (int64) of the first k set entries of `mask` (one
    counted sync)."""
    return nonzero(mask)[:k]


def compact(table: HashTable, extra_mask=None, max_active: int = 0):
    """flatAndReduceHashTable (voxel_data_structures.cu:405-499): the table
    slots of occupied (optionally filtered) entries, capped at
    `max_active`, in slot order."""
    mask = table.ptr != FREE
    if extra_mask is not None:
        mask = mask & extra_mask
    return compact_indices(mask, max_active)
