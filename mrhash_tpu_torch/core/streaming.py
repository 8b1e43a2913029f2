"""Host chunk grid, stream-all-out and the mesh snapshot.

Minimal port of mrhash_tpu/core/streaming.py for the ported slices (one
resolution or multi-resolution): the numpy `ChunkGrid` (copied, because
mrhash_tpu/core/streaming.py imports jax), `Streamer.stream_all_out` and `Streamer.snapshot_into` as
plain device -> host copies of the occupied blocks' voxels, and the debug
`serialize_data` / `print_statistics`.  Streaming triggered by the heap
watermark, stream-in and the grid checkpoints are not ported yet
(ROADMAP A8); GeoWrapper.compute raises when the watermark is reached.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core.state import MapConfig, MapState
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I


class ChunkGrid:
    """Host-RAM chunk map (streamer.cuh:369-384): chunk coords -> SoA numpy
    arrays of the blocks stored there.  A copy of mrhash_tpu's ChunkGrid,
    without the stream-in selection (pop_chunks_in_sphere, peek_chunks)
    and compute_bounds, which only ROADMAP A8's streaming calls."""

    def __init__(self, voxel_extents):
        self.extents = np.asarray(voxel_extents, np.float32)
        self.chunks: dict[tuple, dict] = {}
        self._lock = threading.Lock()

    def world_to_chunk(self, pw):
        p = np.asarray(pw, np.float64) / self.extents
        return np.trunc(p + np.sign(p) * 0.5).astype(np.int64)

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


class Streamer:
    """Host side of the map (Streamer<T>, streamer.cuh:173-415), reduced to
    what the ported slices call."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.grid = ChunkGrid(np.asarray(cfg.voxel_extents, np.float32))

    def _occupied_to_host(self, state: MapState, with_ssq=True):
        """Copy every occupied block (descriptor + voxels) to the host in
        the host layout that native/mrhash_mesh.cpp and serialize_data read
        (reference: mrhash_tpu/core/streaming.py:66-95): a res-0 block's
        row, a res-1 block's 64-voxel window at lanes [0, 64) with zeros
        beyond.  Returns (slots, pos, res, sdf, ssq, w, rgb); numpy except
        slots."""
        table, pool = state.table, state.pool
        slots = torch.nonzero(table.ptr != H.FREE).flatten()
        res = table.res[slots]
        rows, lane0 = I._block_rows(table.ptr[slots])
        low = torch.nonzero(res == 1).flatten()
        win = lane0[low, None] + torch.arange(P.TOTAL_LOW_BLOCK_SIZE,
                                              device=low.device)

        def host(field):
            r = field[rows]                       # [S,512] row gather
            if low.numel():
                w = r[low].gather(1, win)
                r[low] = 0
                r[low, :P.TOTAL_LOW_BLOCK_SIZE] = w
            return r.cpu().numpy()

        sdf = host(pool.sdf)
        ssq = host(pool.sumsq) if with_ssq else np.zeros_like(sdf)
        return (slots, table.pos[slots].cpu().numpy(), res.cpu().numpy(),
                sdf, ssq, host(pool.weight), host(pool.rgbp))

    def _add(self, grid, pos, res, sdf, ssq, w, rgb):
        block_world = (pos.astype(np.float64) * P.SDF_BLOCK_SIZE
                       * self.cfg.virtual_voxel_size)
        grid.add_blocks(block_world, pos, res, sdf, ssq, w, rgb)

    def snapshot_into(self, state: MapState, grid: ChunkGrid,
                      mesh_only: bool = False):
        """READ-ONLY copy of every device-resident block into `grid`; the
        map stays live.  mesh_only=True skips the sumsq lanes (decoded as
        zeros), so such a snapshot must not be merged back into a map."""
        _, *blocks = self._occupied_to_host(state, with_ssq=not mesh_only)
        self._add(grid, *blocks)

    def stream_all_out(self, state: MapState) -> MapState:
        """streamAllOut (streamer.cpp:249-281): move every block to the host
        grid, free its table entry and heap block, zero its window."""
        slots, *blocks = self._occupied_to_host(state)
        self._add(self.grid, *blocks)
        ptrs, res = H.free_slots(state.table, slots)
        I._clear_blocks(state.pool, ptrs, res)
        return state

    def serialize_data(self, filename_hash, filename_voxel):
        """Debug PLY export (Streamer::serializeData, streamer.cpp:103-160):
        per-voxel points coloured red (res 0) / green (res 1) with
        weight + sdf attributes, plus per-block 'hash points'."""
        from mrhash_tpu_torch.utils import plyio
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

    def print_statistics(self):
        print(f"Streamer | RAM blocks: {self.grid.num_blocks()} in "
              f"{len(self.grid.chunks)} chunks")
