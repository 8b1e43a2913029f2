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
  staging-sized batches (streamer.cpp:357-378); keys already resident are
  skipped, and blocks that find no slot go back into the grid;
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
from mrhash_tpu_torch.core.state import (MapConfig, MapState, VoxelPool,
                                         clear_blocks, put_windows,
                                         window_voxels)
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.utils.profiler import stage

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


def block_world(cfg: MapConfig, pos):
    """World position (float64) of each block's corner, for the chunk
    assignment."""
    return pos.astype(np.float64) * P.SDF_BLOCK_SIZE * cfg.virtual_voxel_size


# ---------------------------------------------------------------------------
# host chunk grid
# ---------------------------------------------------------------------------

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
                # the same key (keep the newest)
                _, last = np.unique(group["pos"][::-1], axis=0,
                                    return_index=True)
                keep = group["pos"].shape[0] - 1 - np.sort(last)[::-1]
                keep = np.sort(keep)
                group = {k: v[keep] for k, v in group.items()}
            self.chunks[key] = group

    def pop_chunks_in_sphere(self, center, radius):
        """isChunkInSphere selection (streamer.cuh:346-352): remove and
        return the blocks of every chunk whose centre lies within
        |radius - chunk_radius| of `center` (None if there is none)."""
        with self._lock:
            keys = [key for key in self.chunks
                    if np.linalg.norm(self.chunk_to_world(key)
                                      - np.asarray(center))
                    <= abs(radius - self.chunk_radius)]
            if not keys:
                return None
            groups = [self.chunks.pop(k) for k in keys]
            return {k: np.concatenate([g[k] for g in groups])
                    for k in groups[0]}

    def peek_chunks(self, keys):
        """Read-only view of the given chunks' blocks, concatenated (None if
        no key is present); the grid keeps them."""
        with self._lock:
            groups = [self.chunks[k] for k in keys if k in self.chunks]
            if not groups:
                return None
            return {k: np.concatenate([g[k] for g in groups])
                    for k in groups[0]}

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
        # stream-out events, oldest first: blocks, passes and ms per phase
        # (plan and ingest on the host clock; gather + clear and the copy
        # on the card's, CUDA events); an asynchronous event's d2h and
        # ingest figures land when its job completes
        self.out_events: list[dict] = []
        self.in_events: list[dict] = []
        self.filled_slots = None      # the last stream_in's slots

    # -- the stream-out worker ----------------------------------------------
    def join(self):
        """Wait for a pending asynchronous stream-out job (no-op when none
        is in flight); re-raises its error."""
        job, self._job = self._job, None
        if job is not None:
            job.result()

    def busy(self) -> bool:
        """True while an asynchronous stream-out job is in flight."""
        return self._job is not None and not self._job.done()

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
        and stream_in pops within it."""
        self.join()
        t0 = time.perf_counter()
        # stream.* ranges: chip_profile.py --walk reads their host and
        # device times
        with stage("stream.plan"):
            pos, ptr, res = plan_evictions(self.cfg, state.table, cam_pos,
                                           radius, all_out, budget)
        n = pos.shape[0]
        stats = dict(blocks=n, passes=0, plan_ms=(time.perf_counter() - t0)
                     * 1e3, gather_ms=0.0, d2h_ms=0.0, ingest_ms=0.0)
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
        staging-sized batches.  Blocks the device cannot place (a full
        probe window or a dry heap) go back into the grid instead of being
        lost (the reference only warns, streamer.cu:276-277).  The table
        slots it filled are left in `filled_slots` (i64)."""
        with stage("stream.in"):
            return self._stream_in(state, center, radius)

    def _stream_in(self, state: MapState, center, radius) -> MapState:
        blocks = self.grid.pop_chunks_in_sphere(np.asarray(center), radius)
        stats = dict(popped=0, inserted=0, kept=0)
        self.in_events.append(stats)
        dev = state.table.pos.device
        filled = [torch.zeros(0, dtype=torch.int64, device=dev)]
        self.filled_slots = filled[0]
        if blocks is None:
            return state
        total = blocks["pos"].shape[0]
        stats["popped"] = total
        for off in range(0, total, self.staging):
            sl = slice(off, min(off + self.staging, total))
            present, slot, new = insert_blocks(
                self.cfg, state.table, state.pool,
                *(torch.from_numpy(np.ascontiguousarray(blocks[k][sl]))
                  .to(dev) for k in ("pos", "res", *HOST_FIELDS)))
            failed = ~present.cpu().numpy()
            stats["inserted"] += int(new.sum())
            filled.append(slot[new])
            if failed.any():
                idx = np.nonzero(failed)[0] + sl.start
                pos_f = blocks["pos"][idx]
                self.grid.add_blocks(block_world(self.cfg, pos_f), pos_f,
                                     *(blocks[k][idx] for k in
                                       ("res", *HOST_FIELDS)))
                stats["kept"] += int(idx.size)
                print(f"Streamer | stream_in: {idx.size} blocks did not fit "
                      "the device hash; kept in RAM")
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
