"""Host streaming: device <-> host block migration, the host chunk grid and
grid checkpoints.

Port of mrhash_tpu/core/streaming.py (Streamer<T> and Serializer<T> of the
CUDA original, streamer.{cuh,cu,cpp} and serializer.h):

- stream-out evicts the blocks whose corner lies at or beyond `radius` from
  the camera (streamer.cu:24-28), or with a budget only the `budget`
  farthest of them (`plan_evictions`), frees their entries and heap blocks
  at once, gathers their voxels in the host layout and clears their
  windows; the device-to-host copy and the chunk-grid ingest can run on a
  worker thread while later frames integrate;
- stream-in reloads every host chunk whose centre lies within
  |radius - chunk_radius| of the camera (streamer.cuh:346-352) in
  staging-sized batches (streamer.cpp:357-378), uploading a res-1
  block's 64 voxels and not its host row of 512 (`stream_in_blocks`, which
  also takes the chunks a caller popped); blocks that find no slot, and
  blocks whose key is already resident (an error, counted), go back into
  the grid;
- streamAllOut evicts everything (streamer.cpp:249-281);
- `serialize_grid` / `deserialize_grid` write and read the reference's npz
  checkpoint, so a grid written by either package loads in the other.

The reference's transfer pack (an i32 buffer with weight in rgb's spare
byte), its fetch slicing and power-of-two fetch tiers were workarounds for
a slow remote link: here the four voxel fields go to pinned host buffers on
a side CUDA stream (PORT_NOTES.md P34-P36).  Its `collect_evicted` has no
caller and is not ported.  `insert_readonly` stages host blocks into the
device map for the device mesh sweep without taking them from the grid.
`close` joins the worker's job and stops the worker.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import (LANES, MapConfig, MapState,
                                         VoxelPool, clear_blocks, put_windows,
                                         window_voxels)
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.utils.profiler import nonzero, pick, stage

# the chunk grid's names of the pool fields (VoxelPool.FIELDS order)
HOST_FIELDS = ("sdf", "ssq", "w", "rgb")


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def plan_evictions(cfg: MapConfig, table: H.HashTable, cam_pos, radius,
                   all_out=False, budget=0):
    """Select the entries to evict and free them all at once, in place:
    occupied entries whose block corner lies at or beyond `radius` from
    `cam_pos`, or every entry with `all_out`.  budget > 0 caps the set to
    the `budget` farthest candidates: the threshold is the budget-th largest
    distance, and ties may admit a few extra (mrhash_tpu's plan_evictions).
    The entries' heap blocks go back in ascending slot order, as the
    reference pushes them.  Returns (pos i32[n,3], ptr i32[n], res i32[n])
    of the evicted entries, in slot order."""
    occupied = table.ptr != H.FREE
    pw = X.sdf_block_to_world_point(cfg.virtual_voxel_size, table.pos)
    d = pw - torch.as_tensor(np.asarray(cam_pos, np.float32),
                             device=pw.device)
    dist = torch.sqrt((d * d).sum(dim=-1))
    evict = occupied & (bool(all_out) | (dist >= float(radius)))
    if budget > 0:
        k = min(int(budget), dist.shape[0])
        d_thr = torch.topk(torch.where(evict, dist, -1.0), k).values[k - 1]
        evict = evict & (dist >= torch.clamp(d_thr, min=0.0))
    slots = torch.nonzero(evict).flatten()
    pos = table.pos[slots]
    ptr, res = H.free_slots(table, slots)
    return pos, ptr, res


def gather_blocks(pool: VoxelPool, ptr, res, with_ssq=True):
    """Each block's voxels in the host layout, read-only: [n,512] per pool
    field, a res-0 block's row, a res-1 block's 64-voxel window at lanes
    [0, 64) with zeros beyond (the layout native/mrhash_mesh.cpp and the
    checkpoint hold).  with_ssq=False gives zeros for sumsq."""
    vidx, valid = window_voxels(ptr, res)
    out = []
    for f in VoxelPool.FIELDS:
        v = getattr(pool, f).view(-1)
        if f == "sumsq" and not with_ssq:
            out.append(torch.zeros(vidx.shape, dtype=v.dtype,
                                   device=v.device))
        else:
            out.append(torch.where(valid, v[vidx],
                                   torch.zeros((), dtype=v.dtype,
                                               device=v.device)))
    return out


def insert_blocks(cfg: MapConfig, table: H.HashTable, pool: VoxelPool, pos,
                  res, sdf, ssq, w, rgb):
    """chunkToGlobalHashPass1+2 (streamer.cu:249-350), in place: insert a
    batch of distinct host blocks and write each new block's payload (host
    layout, [S,512] per field) into its own window only, so res-1 siblings
    that share a pool row keep theirs (PORT_NOTES.md P33).  When the batch
    needs more res-1 blocks than are free, the low heap is refilled first by
    splitting high blocks (allocateMemoryLow): a multi-res checkpoint loaded
    into a fresh map would otherwise lose every coarse block.  Keys already
    resident are skipped.  Returns (present bool[S], slot i64[S], new
    bool[S]): blocks that found no slot or no heap block are not present,
    and `new` marks the blocks this call inserted."""
    if table.low_count < int((res == 1).sum()):
        H.split_high_blocks(table, int(cfg.low_split_chunk))
    info = AB.insert(table, pos, res)
    new = info["was_new"]
    vidx, valid = window_voxels(info["ptr"][new], res[new])
    for f, vals in zip(VoxelPool.FIELDS, (sdf, ssq, w, rgb)):
        put_windows(getattr(pool, f), vidx, valid, vals[new])
    return info["present"], info["slot"], new


def repack_low(state: MapState):
    """Pack the res-1 blocks into as few pool rows as hold them, in place,
    and hand every row this empties back to the high heap.  An evicted or
    collected res-1 block frees a low id, not a row, so a multi-res map
    that streams fragments its low rows until the high heap runs dry
    while the low heap holds room (PORT_NOTES.md P72).  The rows kept are
    the low rows with the most live blocks; each live block of another
    row moves into a free id of a kept row (its 64 voxels copied, its old
    window cleared, its entry's ptr updated).  Returns (rows freed,
    blocks moved)."""
    table, pool = state.table, state.pool
    if table.low_count == 0:
        return 0, 0
    b8, lanes = P.OCTREE_BRANCHING_FACTOR, P.TOTAL_LOW_BLOCK_SIZE
    live_slots = nonzero((table.ptr != H.FREE) & (table.res == 1))
    live = table.ptr[live_slots].to(torch.int64) // lanes
    free = table.heap_low[:table.low_count].to(torch.int64)
    per_row = torch.bincount(live // b8, minlength=table.num_blocks)
    low_row = (per_row > 0).index_fill_(0, free // b8, True)
    k = -(-live.shape[0] // b8)
    order = torch.sort(torch.where(low_row, per_row, -1), descending=True,
                       stable=True).indices
    kept = torch.zeros_like(low_row).index_fill_(0, order[:k], True)
    kept &= low_row
    move = ~kept[live // b8]
    src_slots, src = pick(live_slots, move), pick(live, move)
    room = pick(free, kept[free // b8])
    m = src.shape[0]
    dst = room[:m]
    if m:
        off = torch.arange(lanes, device=src.device)
        s_idx = (src[:, None] * lanes + off).reshape(-1)
        d_idx = (dst[:, None] * lanes + off).reshape(-1)
        for f in VoxelPool.FIELDS:
            v = getattr(pool, f).view(-1)
            v[d_idx] = v[s_idx]
            v.index_fill_(0, s_idx, 0)
        table.ptr[src_slots] = (dst * lanes).to(table.ptr.dtype)
    rest = room[m:]
    table.heap_low[:rest.shape[0]] = rest.to(table.heap_low.dtype)
    table.low_count = int(rest.shape[0])
    back = nonzero(low_row & ~kept)
    table.high_count = H._heap_push(table.heap_high, table.high_count, back)
    return int(back.shape[0]), m


def block_world(cfg: MapConfig, pos):
    """World position (float64) of each block's corner, for the chunk
    assignment."""
    return pos.astype(np.float64) * P.SDF_BLOCK_SIZE * cfg.virtual_voxel_size


# ---------------------------------------------------------------------------
# host chunk grid
# ---------------------------------------------------------------------------

def _concat(groups):
    """Chunks' arrays concatenated field by field (None for no chunk)."""
    if not groups:
        return None
    return {k: np.concatenate([g[k] for g in groups]) for k in groups[0]}


class _Popped:
    """Blocks popped from the grid for stream-in, held compact: every
    block's first 64 lanes, and lanes 64-511 of the res-0 blocks alone (a
    res-1 block's lanes past its 64 voxels are zeros in the host layout),
    so a multi-res map's stream-in copies and uploads about an eighth of
    the host layout's bytes."""

    def __init__(self, groups):
        low = P.TOTAL_LOW_BLOCK_SIZE
        self.pos = np.concatenate([g["pos"] for g in groups])
        self.res = np.concatenate([g["res"] for g in groups])
        self.fine = self.res == 0
        self.fine_row = np.cumsum(self.fine) - 1   # a res-0 block's tail row
        self.head = {f: np.concatenate([g[f][:, :low] for g in groups])
                     for f in HOST_FIELDS}
        self.tail = {f: np.concatenate([g[f][g["res"] == 0, low:]
                                        for g in groups])
                     for f in HOST_FIELDS}

    def __len__(self):
        return self.pos.shape[0]

    def host(self, rows):
        """The rows' (pos, res, sdf, ssq, w, rgb) in the host layout."""
        return (self.pos[rows], self.res[rows]) + tuple(
            self._full(f, rows, np.zeros, lambda a: a) for f in HOST_FIELDS)

    def device(self, rows, dev):
        """The rows' (pos, res, sdf, ssq, w, rgb) as tensors on `dev`, the
        host layout's, uploaded compact."""
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        zeros = lambda shape, dtype: torch.zeros(
            shape, dtype=getattr(torch, np.dtype(dtype).name), device=dev)
        return (up(self.pos[rows]), up(self.res[rows])) + tuple(
            self._full(f, rows, zeros, up) for f in HOST_FIELDS)

    def _full(self, f, rows, zeros, up):
        low = P.TOTAL_LOW_BLOCK_SIZE
        head = self.head[f]
        out = zeros((rows.shape[0], LANES), head.dtype)
        out[:, :low] = up(head[rows])
        k = np.nonzero(self.fine[rows])[0]
        if k.size:
            out[up(k), low:] = up(self.tail[f][self.fine_row[rows[k]]])
        return out


class ChunkGrid:
    """Host-RAM chunk map (streamer.cuh:369-384): chunk coords -> SoA numpy
    arrays of the blocks stored there (pos i32[n,3], res i32[n], and
    [n,512] sdf f32, ssq f32, w i32, rgb i32).  A copy of mrhash_tpu's
    ChunkGrid.  The lock guards the chunk dict: the stream-out worker
    ingests while the frame loop may pop chunks."""

    def __init__(self, voxel_extents):
        self.extents = np.asarray(voxel_extents, np.float32)
        self.chunk_radius = float(np.linalg.norm(self.extents) / 2.0)
        self.chunks: dict[tuple, dict] = {}
        self._lock = threading.Lock()

    def world_to_chunk(self, pw):
        p = np.asarray(pw, np.float64) / self.extents
        return np.trunc(p + np.sign(p) * 0.5).astype(np.int64)

    def chunk_to_world(self, chunk):
        return np.asarray(chunk, np.float64) * self.extents

    def num_blocks(self):
        with self._lock:
            return sum(c["pos"].shape[0] for c in self.chunks.values())

    def add_blocks(self, block_world, pos, res, sdf, ssq, w, rgb):
        """integrateInChunkGrid (streamer.cpp:209-247)."""
        with self._lock:
            self._add_blocks_locked(block_world, pos, res, sdf, ssq, w, rgb)

    def _add_blocks_locked(self, block_world, pos, res, sdf, ssq, w, rgb):
        if pos.shape[0] == 0:
            return
        ck = self.world_to_chunk(block_world)
        order = np.lexsort((ck[:, 2], ck[:, 1], ck[:, 0]))
        ck = ck[order]
        arrays = dict(pos=pos[order], res=res[order], sdf=sdf[order],
                      ssq=ssq[order], w=w[order], rgb=rgb[order])
        boundaries = np.nonzero(np.any(np.diff(ck, axis=0) != 0, axis=1))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [ck.shape[0]]])
        for s, e in zip(starts, ends):
            key = tuple(int(v) for v in ck[s])
            group = {k: v[s:e] for k, v in arrays.items()}
            if key in self.chunks:
                old = self.chunks[key]
                group = {k: np.concatenate([old[k], group[k]]) for k in group}
                # a freshly evicted block supersedes a stale RAM copy of
                # the same key (keep the newest); the keys compared as 1-d
                # codes (|coordinate| < 2^20), and the arrays taken again
                # only where a key repeats
                p = group["pos"].astype(np.int64) + (1 << 20)
                codes = (p[:, 0] << 42) | (p[:, 1] << 21) | p[:, 2]
                _, last = np.unique(codes[::-1], return_index=True)
                if last.size < codes.size:
                    keep = np.sort(codes.size - 1 - last)
                    group = {k: v[keep] for k, v in group.items()}
            self.chunks[key] = group

    def pop_groups_in_sphere(self, center, radius):
        """isChunkInSphere selection (streamer.cuh:346-352): remove and
        return the blocks of every chunk whose centre lies within
        |radius - chunk_radius| of `center`, as the chunks' own arrays (a
        list, empty if there is none); a host test over the grid's keys."""
        with self._lock:
            if not self.chunks:
                return []
            keys = list(self.chunks)
            d = self.chunk_to_world(keys) - np.asarray(center)
            near = np.linalg.norm(d, axis=1) <= abs(radius - self.chunk_radius)
            return [self.chunks.pop(k) for k, n in zip(keys, near) if n]

    def pop_chunks_in_sphere(self, center, radius):
        """pop_groups_in_sphere's blocks, concatenated (None if there is
        none)."""
        return _concat(self.pop_groups_in_sphere(center, radius))

    def peek_chunks(self, keys):
        """Read-only view of the given chunks' blocks, concatenated (None if
        no key is present); the grid keeps them."""
        with self._lock:
            return _concat([self.chunks[k] for k in keys
                            if k in self.chunks])

    def compute_bounds(self):
        """streamer.cuh:358-384: the smallest and largest chunk coords."""
        with self._lock:
            if not self.chunks:
                return np.zeros(3, np.int64), np.zeros(3, np.int64)
            arr = np.asarray(list(self.chunks.keys()), np.int64)
            return arr.min(axis=0), arr.max(axis=0)


# ---------------------------------------------------------------------------
# streamer (host orchestration)
# ---------------------------------------------------------------------------

class _Pass:
    """One staging-sized stream-out pass in flight: its descriptors and
    payload on the host (pinned buffers on a card, filled by a copy on a
    side stream), the device tensors that copy reads (kept alive until the
    worker has waited for it) and the CUDA events that time it."""

    def __init__(self, pos, res, fields, timing=None):
        src = [pos, res, *fields]
        self.events = timing
        if pos.device.type != "cuda":
            self.src, self.host, self.done = None, src, None
            return
        cur = torch.cuda.current_stream(pos.device)
        side = _side_stream(pos.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            start = torch.cuda.Event(enable_timing=True)
            start.record(side)
            self.host = []
            for t in src:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                self.host.append(h)
            self.done = torch.cuda.Event(enable_timing=True)
            self.done.record(side)
        self.src = src
        self.d2h = (start, self.done)

    def fetch(self):
        """Wait for the copy; returns (pos, res, sdf, ssq, w, rgb) as numpy
        and the copy's device milliseconds."""
        ms = 0.0
        if self.done is not None:
            self.done.synchronize()
            ms = self.d2h[0].elapsed_time(self.d2h[1])
            self.src = None
        return [h.numpy() for h in self.host], ms


_SIDE = {}


def _side_stream(device):
    """One side stream per card for the stream-out copies."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


class Streamer:
    """Host driver of the block migration and the chunk grid (Streamer<T>,
    streamer.cuh:173-415).  `staging` caps the blocks one pass gathers or
    inserts (getMaxNumSdfBlockIntegrateFromGlobalHash)."""

    def __init__(self, cfg: MapConfig, staging_size: int):
        self.cfg = cfg
        self.staging = int(staging_size)
        self.grid = ChunkGrid(np.asarray(cfg.voxel_extents, np.float32))
        self._worker = None
        self._job = None
        self._job_stats = None
        # stream-out events, oldest first: blocks, their voxels, passes and
        # ms per phase (plan and ingest on the host clock; gather + clear
        # and the copy on the card's, CUDA events); an asynchronous event's
        # d2h and ingest figures land when its job completes
        self.out_events: list[dict] = []
        self.in_events: list[dict] = []
        # the asynchronous events whose job a join completed, oldest first
        self.joined: list[dict] = []
        self.filled_slots = None      # the last stream_in's slots

    # -- the stream-out worker ----------------------------------------------
    def join(self):
        """Wait for a pending asynchronous stream-out job (no-op when none
        is in flight); re-raises its error."""
        job, self._job = self._job, None
        if job is not None:
            job.result()
            self.joined.append(self._job_stats)

    def busy(self) -> bool:
        """True while an asynchronous stream-out job is in flight."""
        return self._job is not None and not self._job.done()

    def holds(self) -> bool:
        """True while the host grid holds a chunk or a stream-out job has
        not been joined: a host read, no device one."""
        return bool(self.grid.chunks) or self._job is not None

    def close(self):
        """Join the job in flight (re-raising its error) and shut the
        worker thread down (mrhash_tpu's Streamer.close).  The Streamer
        stays usable: a later asynchronous stream-out starts a new
        worker."""
        try:
            self.join()
        finally:
            if self._worker is not None:
                self._worker.shutdown(wait=True)
                self._worker = None

    # -- out ----------------------------------------------------------------
    def _ingest(self, passes, stats, grid):
        """The off-critical-path half of a stream-out: wait for each pass's
        copy, decode, and add every pass's blocks to `grid` in one shot."""
        fields, d2h_ms = [], 0.0
        for p in passes:
            f, ms = p.fetch()
            fields.append(f)
            d2h_ms += ms
            if p.events is not None:
                stats["gather_ms"] += p.events[0].elapsed_time(p.events[1])
        t0 = time.perf_counter()
        pos, res, sdf, ssq, w, rgb = (
            fields[0] if len(fields) == 1 else
            [np.concatenate(cols) for cols in zip(*fields)])
        grid.add_blocks(block_world(self.cfg, pos), pos, res, sdf, ssq, w,
                        rgb)
        stats.update(d2h_ms=d2h_ms,
                     ingest_ms=(time.perf_counter() - t0) * 1e3)

    def _stream_out(self, state: MapState, cam_pos, radius, all_out,
                    budget=0, asynchronous=False) -> MapState:
        """Plan once (free every evicted entry), then per staging-sized
        pass gather + clear the blocks' windows and start their copy to
        the host.  asynchronous=True returns once the passes are issued:
        the copy's completion, the decode and the ingest run on the worker
        thread, and the next stream, snapshot, checkpoint or mesh joins it.
        stream_in needs no join: this event's evictions lie beyond `radius`
        and stream_in pops within it.  The whole of it, the join
        included, is the range stream.out."""
        with stage("stream.out"):
            return self._stream_out_ranged(state, cam_pos, radius, all_out,
                                           budget, asynchronous)

    def _stream_out_ranged(self, state: MapState, cam_pos, radius, all_out,
                           budget, asynchronous) -> MapState:
        self.join()
        t0 = time.perf_counter()
        table = state.table
        free0 = table.high_count, table.low_count
        # stream.* ranges: the benchmark's streaming readers and
        # chip_profile.py --walk read their host and device times
        with stage("stream.plan"):
            pos, ptr, res = plan_evictions(self.cfg, table, cam_pos,
                                           radius, all_out, budget)
        n = pos.shape[0]
        # the freed entries went back to their heaps (host counts): a res-0
        # block's 512 voxels to the high heap, a res-1 block's 64 to the low
        n0, n1 = (table.high_count - free0[0], table.low_count - free0[1])
        stats = dict(blocks=n, voxels=n0 * P.TOTAL_SDF_BLOCK_SIZE
                     + n1 * P.TOTAL_LOW_BLOCK_SIZE, passes=0,
                     plan_ms=(time.perf_counter() - t0) * 1e3, gather_ms=0.0,
                     d2h_ms=0.0, ingest_ms=0.0)
        self.out_events.append(stats)
        if n == 0:
            return state
        cuda = pos.device.type == "cuda"
        passes = []
        for off in range(0, n, self.staging):
            sl = slice(off, min(off + self.staging, n))
            t0 = time.perf_counter()
            ev = None
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with stage("stream.gather"):
                fields = gather_blocks(state.pool, ptr[sl], res[sl])
                clear_blocks(state.pool, ptr[sl], res[sl])
            if cuda:
                ev[1].record()
            else:
                stats["gather_ms"] += (time.perf_counter() - t0) * 1e3
            with stage("stream.copy"):
                passes.append(_Pass(pos[sl], res[sl], fields, ev))
            stats["passes"] += 1
        if asynchronous:
            if self._worker is None:
                self._worker = concurrent.futures.ThreadPoolExecutor(1)
            self._job = self._worker.submit(self._ingest, passes, stats,
                                            self.grid)
            self._job_stats = stats
        else:
            self._ingest(passes, stats, self.grid)
        return state

    def stream_out(self, state: MapState, cam_pos, radius, budget=0,
                   asynchronous=False) -> MapState:
        """streamOutToHostPass0 (streamer.cpp:168-247), in staging-sized
        passes instead of throwing on overflow (:181-186).  budget > 0:
        evict only the `budget` farthest blocks beyond the radius."""
        return self._stream_out(state, cam_pos, radius, False, budget,
                                asynchronous)

    def stream_all_out(self, state: MapState) -> MapState:
        """streamAllOut (streamer.cpp:249-281)."""
        return self._stream_out(state, np.zeros(3), 0.0, True)

    def snapshot_into(self, state: MapState, grid: ChunkGrid,
                      mesh_only: bool = False):
        """READ-ONLY copy of every device-resident block into `grid`; the
        map stays live.  mesh_only=True leaves sumsq out (zeros), so such a
        snapshot must not be merged back into a map.  The mode is read per
        call: there is no cached program to carry one call's mode into the
        next (ROADMAP C2)."""
        self.join()
        slots = torch.nonzero(state.table.ptr != H.FREE).flatten()
        res = state.table.res[slots]
        fields = gather_blocks(state.pool, state.table.ptr[slots], res,
                               with_ssq=not mesh_only)
        self._ingest([_Pass(state.table.pos[slots], res, fields)],
                     dict(gather_ms=0.0), grid)

    # -- in -----------------------------------------------------------------
    def stream_in(self, state: MapState, center, radius) -> MapState:
        """streamInToGPU (streamer.cpp:289-378): pop the chunks within
        |radius - chunk_radius| of `center` and insert their blocks in
        stream_in_blocks."""
        with stage("stream.in"):
            groups = self.grid.pop_groups_in_sphere(np.asarray(center),
                                                    radius)
        return self.stream_in_blocks(state, groups)

    def stream_in_blocks(self, state: MapState, groups) -> MapState:
        """Insert the chunks popped from the grid (pop_groups_in_sphere's
        list) in staging-sized batches (streamer.cpp:357-378), uploaded
        compact (_Popped).  Blocks the device cannot place (a full probe
        window or a dry heap) go back into the grid instead of being lost
        (the reference only warns, streamer.cu:276-277); one that lost its
        slot to another of its batch tries again first.  A block whose key
        is already resident is an error, counted as `clashed` in the event
        and kept in the grid, never dropped (the reference skips it,
        losing its history; PORT_NOTES.md P72).  The table slots it filled
        are left in `filled_slots` (i64)."""
        with stage("stream.in"):
            stats = dict(popped=0, inserted=0, kept=0, clashed=0)
            self.in_events.append(stats)
            table = state.table
            dev = table.pos.device
            filled = [torch.zeros(0, dtype=torch.int64, device=dev)]
            self.filled_slots = filled[0]
            if not groups:
                return state
            blocks = _Popped(groups)
            total = len(blocks)
            stats["popped"] = total
            for off in range(0, total, self.staging):
                rows = np.arange(off, min(off + self.staging, total))
                # a block that lost its slot to another of its batch tries
                # again, until a round places none (as insert_readonly's)
                while rows.size:
                    # the high blocks the round's res-1 blocks need beyond the
                    # low heap, split first (insert_blocks alone splits at most
                    # cfg.low_split_chunk)
                    short = (int((blocks.res[rows] == 1).sum())
                             - table.low_count)
                    if short > 0:
                        H.split_high_blocks(
                            table, -(-short // P.OCTREE_BRANCHING_FACTOR))
                    present, slot, new = insert_blocks(
                        self.cfg, table, state.pool, *blocks.device(rows, dev))
                    present, new_h = present.cpu().numpy(), new.cpu().numpy()
                    stats["inserted"] += int(new_h.sum())
                    filled.append(slot[new])
                    clashed, lost = rows[present & ~new_h], rows[~present]
                    done = lost.size == rows.size
                    back = np.concatenate([clashed,
                                           lost if done else lost[:0]])
                    rows = lost[:0] if done else lost
                    if not back.size:
                        continue
                    host = blocks.host(back)
                    self.grid.add_blocks(block_world(self.cfg, host[0]), *host)
                    stats["clashed"] += int(clashed.size)
                    stats["kept"] += int(back.size - clashed.size)
                    print(f"Streamer | stream_in: {back.size - clashed.size} "
                          "blocks did not fit the device hash, "
                          f"{clashed.size} found their key resident; kept in "
                          "RAM")
            self.filled_slots = torch.cat(filled)
            return state

    def insert_readonly(self, state: MapState, blocks, owned):
        """Insert host blocks into the device map in staging-sized batches
        WITHOUT taking them from the chunk grid, which keeps the payloads:
        the caller must not stream these device copies back
        (mrhash_tpu's insert_readonly).  `blocks` holds the grid's arrays
        (pos, res and the host-layout fields), `owned` a bool mask aligned
        with its rows.  Returns (state, owned_slot_mask bool[capacity] on
        the device, n_dropped): the mask marks the table slots that hold
        owned blocks, so a mesh sweep over several batches extracts each
        block exactly once; n_dropped counts the blocks that found no slot
        or no heap block.  Unlike the reference, each batch first splits
        as many high blocks as its res-1 blocks need (`insert_blocks`
        alone splits at most cfg.low_split_chunk), and the blocks that
        lost a slot to another key of the batch try again until a round
        places none (PORT_NOTES.md P54)."""
        table = state.table
        dev = table.pos.device
        owned_mask = torch.zeros(table.capacity, dtype=torch.bool,
                                 device=dev)
        total = blocks["pos"].shape[0]
        dropped = 0
        for off in range(0, total, self.staging):
            rows = np.arange(off, min(off + self.staging, total))
            short = int((blocks["res"][rows] == 1).sum()) - table.low_count
            if short > 0:
                H.split_high_blocks(
                    table, -(-short // P.OCTREE_BRANCHING_FACTOR))
            while rows.size:
                present, slot, _ = insert_blocks(
                    self.cfg, table, state.pool,
                    *(torch.from_numpy(blocks[k][rows]).to(dev)
                      for k in ("pos", "res", *HOST_FIELDS)))
                own = torch.from_numpy(owned[rows]).to(dev)
                owned_mask[slot[present & own]] = True
                failed = rows[~present.cpu().numpy()]
                if failed.size == rows.size:
                    dropped += int(failed.size)
                    break
                rows = failed
        return state, owned_mask, dropped

    def stream(self, state: MapState, cam_pos, radius, budget=0,
               asynchronous=False) -> MapState:
        """stream (streamer.cpp:336-355): evict far, reload near."""
        state = self.stream_out(state, cam_pos, radius, budget, asynchronous)
        return self.stream_in(state, cam_pos, radius)

    # -- persistence (Serializer<T>, serializer.h:12-78) ---------------------
    def serialize_grid(self, path):
        """Checkpoint the host chunk grid (serializeGrid,
        geowrapper.cpp:567-570) as mrhash_tpu's npz: chunk_keys i64[K,3],
        chunk_sizes i64[K], and the blocks of every chunk in key order
        (pos, res, sdf, ssq, w, rgb).  Call stream_all_out first, like the
        reference protocol.  The file is written under `path` as given
        (np.savez would append ".npz" to a name without it, and the
        reference's default "serialized_grid.bin" would then not load)."""
        self.join()
        arrays = dict(chunk_keys=np.zeros((0, 3), np.int64),
                      chunk_sizes=np.zeros((0,), np.int64))
        if self.grid.chunks:
            groups = list(self.grid.chunks.values())
            arrays = dict(
                chunk_keys=np.asarray(list(self.grid.chunks.keys()),
                                      np.int64),
                chunk_sizes=np.asarray([g["pos"].shape[0] for g in groups],
                                       np.int64),
                **{k: np.concatenate([g[k] for g in groups])
                   for k in groups[0]})
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def deserialize_grid(self, path):
        """deserializeGrid (geowrapper.cpp:571-573): replace the host grid
        with a checkpoint's chunks; streaming-in repopulates the device
        lazily.  Each array is read from the file once."""
        self.join()
        with np.load(path) as data:
            keys, sizes = data["chunk_keys"], data["chunk_sizes"]
            arrays = ({k: data[k] for k in ("pos", "res", *HOST_FIELDS)}
                      if keys.shape[0] else {})
        chunks, off = {}, 0
        for key, n in zip(keys, sizes):
            sl = slice(off, off + int(n))
            chunks[tuple(int(v) for v in key)] = {k: a[sl] for k, a in
                                                  arrays.items()}
            off += int(n)
        self.grid.chunks = chunks

    # -- debug / observability ------------------------------------------------
    def serialize_data(self, filename_hash, filename_voxel):
        """Debug PLY export (Streamer::serializeData, streamer.cpp:103-160):
        per-voxel points coloured red (res 0) / green (res 1) with
        weight + sdf attributes, plus per-block 'hash points'."""
        from mrhash_tpu_torch.utils import plyio
        self.join()
        vvs = self.cfg.virtual_voxel_size
        hash_pts, vox_pts, vox_cols, vox_w, vox_sdf = [], [], [], [], []
        for group in self.grid.chunks.values():
            pos = group["pos"]
            res = group["res"]
            base = pos * P.SDF_BLOCK_SIZE
            hash_pts.append(base.astype(np.float32) * vvs)
            for i in range(pos.shape[0]):
                side = P.SDF_BLOCK_SIZE >> int(res[i])
                scale = 1 << int(res[i])
                n = side ** 3
                w = group["w"][i, :n]
                used = w > 0
                if not used.any():
                    continue
                lanes = np.nonzero(used)[0]
                lx = lanes % side
                ly = (lanes // side) % side
                lz = lanes // (side * side)
                pi = base[i] + scale * np.stack([lx, ly, lz], 1)
                vox_pts.append(pi.astype(np.float32) * vvs)
                col = np.zeros((lanes.size, 3), np.uint8)
                col[:, 0 if res[i] == 0 else 1] = 255
                vox_cols.append(col)
                vox_w.append(w[lanes].astype(np.float32))
                vox_sdf.append(group["sdf"][i, lanes].astype(np.float32))
        if hash_pts:
            plyio.write_points_ply(filename_hash, np.concatenate(hash_pts))
        if vox_pts:
            plyio.write_points_ply(
                filename_voxel, np.concatenate(vox_pts),
                colors=np.concatenate(vox_cols),
                extra_props={"weight": np.concatenate(vox_w),
                             "sdf": np.concatenate(vox_sdf)})

    def duplicate_ratio(self, state: MapState):
        """debugCheckForDuplicates (streamer.cpp:400-446): the fraction of
        block keys present both on the device and in the host grid."""
        self.join()
        occ = state.table.ptr != P.FREE_ENTRY
        dev_pos = state.table.pos[occ].cpu().numpy()
        with self.grid._lock:
            host_pos = [g["pos"] for g in self.grid.chunks.values()]
        host_pos = (np.concatenate(host_pos) if host_pos
                    else np.zeros((0, 3), np.int32))
        total = dev_pos.shape[0] + host_pos.shape[0]
        if total == 0:
            return 0.0
        allpos = np.concatenate([dev_pos, host_pos])
        n_unique = np.unique(allpos, axis=0).shape[0]
        return (total - n_unique) / total

    def print_statistics(self):
        print(f"Streamer | RAM blocks: {self.grid.num_blocks()} in "
              f"{len(self.grid.chunks)} chunks")
