"""Carry a map between the JAX reference and the port.

`from_reference` turns a mrhash_tpu MapState — fetched to host arrays with
jax.device_get, or any object with the same attribute layout — into the
port's MapState; `to_reference_arrays` returns the port's state as numpy
arrays under the reference's field names, from which the reference
rebuilds its MapState (its presence cache, which the port does not keep,
is rebuilt with mrhash_tpu.ops.hashtable.rebuild_pcache).  Both packages
can then continue from the same map, bit for bit.  `from_arrays` is
`to_reference_arrays`'s inverse.  A sharded map (parallel/sharding.py)
goes the same ways: `from_reference_sharded` slices the reference's
sharded state into the n ranks' states, `to_reference_sharded_arrays`
joins them back.  No jax import here.
"""
from __future__ import annotations

import numpy as np
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapState, VoxelPool
from mrhash_tpu_torch.ops.hashtable import HashTable

TABLE_ARRAYS = ("pos", "ptr", "res", "fp", "heap_high", "heap_low")
_COUNTS = ("high_count", "low_count", "num_buckets", "num_blocks")


def _state(table: dict, pool: dict, frame, device) -> MapState:
    """A port MapState on `device` from host arrays under the reference's
    names."""
    def dev(a):
        # a writable copy (device_get may hand out read-only buffers); the
        # reference's int32 / float32 dtypes carry over unchanged
        return torch.from_numpy(np.array(a)).to(device)

    t = HashTable(**{k: dev(table[k]) for k in TABLE_ARRAYS},
                  **{k: int(table[k]) for k in _COUNTS})
    return MapState(table=t, pool=VoxelPool(**{f: dev(pool[f])
                                               for f in VoxelPool.FIELDS}),
                    frame=int(frame))


def from_reference(ref_state, device="cpu") -> MapState:
    """Reference MapState (host arrays) -> port MapState on `device`."""
    t, pool = ref_state.table, ref_state.pool
    return _state({k: getattr(t, k) for k in TABLE_ARRAYS + _COUNTS},
                  {f: getattr(pool, f) for f in VoxelPool.FIELDS},
                  ref_state.frame, device)


def from_arrays(arrays: dict, device="cpu") -> MapState:
    """to_reference_arrays's dict -> port MapState on `device`."""
    return _state(arrays["table"], arrays["pool"], arrays["frame"], device)


def to_reference_arrays(state: MapState) -> dict:
    """Port MapState -> dict(table=..., pool=..., frame=...) of numpy arrays
    and ints under the reference's HashTable / VoxelPool field names.  The
    arrays are copies: the port updates its state in place, and `.cpu()` of
    a CPU tensor would share its memory."""
    t = state.table
    table = {k: getattr(t, k).cpu().numpy().copy() for k in TABLE_ARRAYS}
    table.update(high_count=t.high_count, low_count=t.low_count,
                 num_buckets=t.num_buckets, num_blocks=t.num_blocks)
    pool = {f: getattr(state.pool, f).cpu().numpy().copy()
            for f in VoxelPool.FIELDS}
    return dict(table=table, pool=pool, frame=state.frame)


def from_reference_sharded(ref_state, n: int, device="cpu") -> list:
    """Reference sharded MapState (host arrays in mrhash_tpu.parallel.
    sharding.make_sharded_state's layout: every table, heap and pool array
    the n shards' local arrays one after another, high_count and low_count
    i32[n], heap ids local to each shard) -> the n ranks' port MapStates
    on `device`.  A shard's bucket count is its slot count over
    HASH_BUCKET_SIZE: the reference's shards hash over their own block
    count (PORT_NOTES.md P68)."""
    t, pool = ref_state.table, ref_state.pool
    counts = {k: np.asarray(getattr(t, k)).reshape(-1)
              for k in ("high_count", "low_count")}
    states = []
    for r in range(n):
        def part(a):
            m = a.shape[0] // n
            return a[r * m:(r + 1) * m]
        table = {k: part(getattr(t, k)) for k in TABLE_ARRAYS}
        table.update(high_count=counts["high_count"][r],
                     low_count=counts["low_count"][r],
                     num_buckets=table["ptr"].shape[0] // P.HASH_BUCKET_SIZE,
                     num_blocks=table["heap_high"].shape[0])
        states.append(_state(table, {f: part(getattr(pool, f))
                                     for f in VoxelPool.FIELDS},
                             ref_state.frame, device))
    return states


def to_reference_sharded_arrays(states) -> dict:
    """The n ranks' port MapStates -> the reference's sharded layout, as
    to_reference_arrays's dict: every array the ranks' arrays one after
    another, high_count and low_count i32[n], num_buckets and num_blocks
    the totals (the reference's global sizes)."""
    parts = [to_reference_arrays(s) for s in states]
    table = {k: np.concatenate([p["table"][k] for p in parts])
             for k in TABLE_ARRAYS}
    for k in ("high_count", "low_count"):
        table[k] = np.asarray([p["table"][k] for p in parts], np.int32)
    for k in ("num_buckets", "num_blocks"):
        table[k] = sum(p["table"][k] for p in parts)
    pool = {f: np.concatenate([p["pool"][f] for p in parts])
            for f in VoxelPool.FIELDS}
    return dict(table=table, pool=pool, frame=parts[0]["frame"])
