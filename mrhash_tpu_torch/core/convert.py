"""Carry a map between the JAX reference and the port.

`from_reference` turns a mrhash_tpu MapState — fetched to host arrays with
jax.device_get, or any object with the same attribute layout — into the
port's MapState; `to_reference_arrays` returns the port's state as numpy
arrays under the reference's field names, from which the reference
rebuilds its MapState (its presence cache, which the port does not keep,
is rebuilt with mrhash_tpu.ops.hashtable.rebuild_pcache).  Both packages
can then continue from the same map, bit for bit.  No jax import here.
"""
from __future__ import annotations

import numpy as np
import torch

from mrhash_tpu_torch.core.state import MapState, VoxelPool
from mrhash_tpu_torch.ops.hashtable import HashTable

TABLE_ARRAYS = ("pos", "ptr", "res", "fp", "heap_high", "heap_low")


def from_reference(ref_state, device="cpu") -> MapState:
    """Reference MapState (host arrays) -> port MapState on `device`."""
    t = ref_state.table

    def dev(a):
        # a writable copy (device_get may hand out read-only buffers); the
        # reference's int32 / float32 dtypes carry over unchanged
        return torch.from_numpy(np.array(a)).to(device)

    table = HashTable(**{k: dev(getattr(t, k)) for k in TABLE_ARRAYS},
                      high_count=int(t.high_count), low_count=int(t.low_count),
                      num_buckets=int(t.num_buckets),
                      num_blocks=int(t.num_blocks))
    pool = VoxelPool(**{f: dev(getattr(ref_state.pool, f))
                        for f in VoxelPool.FIELDS})
    return MapState(table=table, pool=pool, frame=int(ref_state.frame))


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
