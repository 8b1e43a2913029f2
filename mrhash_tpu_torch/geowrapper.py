"""GeoWrapper: the user-facing API of the port.

Same constructor arguments and method names as mrhash_tpu/geowrapper.py
(the reference's bound class, geowrapper.{h,cpp}), for the RGB-D and LiDAR
paths, at one resolution or with variance-adaptive multi-resolution
(sdf_var_threshold > 0: low-variance blocks coarsen to 4^3 blocks at twice
the voxel spacing): setCamera / setCurrPose / setDepthImage + setRGBImage
or setPointCloud / compute, then streamAllOut / extractMesh /
serializeData / serializeGrid / deserializeGrid / clearBuffers; with a
gs_optimization_param_path, online 3D Gaussian Splatting after each RGB-D
frame, then GSFinalOpt / GSSavePointCloud; with viewer_active, a mesh of
the device-resident map refreshed in the background after each frame
(getViewerMesh).  Every frame runs eagerly on `device` ("cuda" by
default).  When the free high heap falls to the stream watermark,
compute() first streams the farthest blocks to the host chunk grid
(core/streaming.py), and before every frame that enters another chunk it
brings back the host chunks near the camera, so a scene larger than the
device pool keeps integrating, and a route that returns over streamed
ground finds it on the card before the frame maps it.  extractMesh runs
the host sweep (native/), or with MRHASH_HOST_MESH=0 the device sweep
(ops/meshing.py), as the reference selects them.  A LiDAR scan takes
kernel K3's projective update, or with projective_sdf=False the
point-centric walk with the point-to-plane SDF over the cloud's normals;
n_frames_invalidate_voxels > 0 starves and garbage-collects the map on
both paths and under both camera models.  The constructor writes the
memory report (memory_allocation.txt in the working directory); the 13
setters resize or reconfigure the map as the reference's do, and close()
stops the viewer's and the Streamer's workers.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
import time
import warnings

import numpy as np
import torch

from mrhash_tpu_torch import native
from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.core import mesh_post, pipeline
from mrhash_tpu_torch.core.state import (MapConfig, MapState, VoxelPool,
                                         make_state)
from mrhash_tpu_torch.core.streaming import (ChunkGrid, Streamer,
                                             gather_blocks, repack_low)
from mrhash_tpu_torch.gs.container import GaussianContainer
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import hashtable as H
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import meshing as M
from mrhash_tpu_torch.utils import plyio
from mrhash_tpu_torch.utils.profiler import (COUNTS, SYNCS, Profiler, since,
                                             stage, upload)

# the device mesh sweep's sizes: blocks gated per window and cells per
# phase-B batch (results do not depend on them; PORT_NOTES.md P51)
MESH_CHUNK = 1 << 13
MESH_MAX_CELLS = 1 << 20


def _quat_to_rot(qx, qy, qz, qw):
    """Quaternion (x,y,z,w) -> rotation matrix (setCurrPose,
    geowrapper.cpp:86-92)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]], np.float32)


def _device_free_bytes(device: torch.device, default=8 << 30):
    """cudaMemGetInfo (geowrapper.cpp:37-42); the CPU test device has no
    such budget and takes the reference's 8 GiB default."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return default


def _round_up_pow2(x):
    return 1 << max(int(x) - 1, 1).bit_length()


class GeoWrapper:
    """PyTorch GeoWrapper (reference: geowrapper.h:18-260)."""

    def __init__(self,
                 sdf_truncation: float,
                 sdf_truncation_scale: float,
                 integration_weight_sample: int,
                 virtual_voxel_size: float,
                 n_frames_invalidate_voxels: int,
                 voxel_extents_scale: int,
                 viewer_active: bool = False,
                 marching_cubes_threshold: float = 1.5,
                 min_weight_threshold: int = 1,
                 min_depth: float = 0.01,
                 max_depth: float = 30.0,
                 gs_optimization_param_path: str =
                 P.DEFAULT_GS_OPTIMIZATION_PARAM_PATH,
                 sdf_var_threshold: float = P.DEFAULT_SDF_VAR_THRESHOLD,
                 vertices_merging_threshold: float =
                 P.DEFAULT_VERTICES_MERGING_THRESHOLD,
                 projective_sdf: bool = P.DEFAULT_PROJECTIVE_SDF,
                 num_blocks: int | None = None,
                 max_active_blocks: int | None = None,
                 max_alloc_per_frame: int = 1 << 14,
                 num_buckets: int = 0,
                 profiling: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GeoWrapper(device='cuda'): CUDA is not "
                               "available (pass device='cpu' for the plain "
                               "PyTorch path)")
        self.viewer_active = bool(viewer_active)
        self.viewer_mesh = mesh_post.MeshAccumulator()
        self.viewer_mesh_frame = None
        self._viewer_future = None
        self._viewer_pool = (concurrent.futures.ThreadPoolExecutor(1)
                             if self.viewer_active else None)
        free = self._free_bytes = _device_free_bytes(self.device)
        if gs_optimization_param_path:
            free = int(free * P.GS_SCALING_RATIO)
        to_alloc = free * P.SDF_BLOCKS_RATIO
        if num_blocks is None:
            num_blocks = int(to_alloc * P.SDF_BLOCKS_RATIO
                             / (P.VOXEL_NBYTES * P.TOTAL_SDF_BLOCK_SIZE))
            num_blocks = min(_round_up_pow2(num_blocks), 1 << 20)
        # blocks one stream pass moves (geowrapper.cpp:48-56)
        staging = int(to_alloc * P.SDF_BLOCKS_STREAM_RATIO
                      / (P.VOXEL_NBYTES * P.TOTAL_SDF_BLOCK_SIZE))
        staging = min(max(_round_up_pow2(staging), 1 << 10), num_blocks)
        if max_active_blocks is None:
            max_active_blocks = min(num_blocks, 1 << 17)
        self.cfg = MapConfig(
            alloc_tile=4,
            virtual_voxel_size=float(virtual_voxel_size),
            voxel_extents=(float(voxel_extents_scale),) * 3,
            sdf_truncation=float(sdf_truncation),
            sdf_truncation_scale=float(sdf_truncation_scale),
            integration_weight_sample=int(integration_weight_sample),
            max_integration_distance=float(max_depth),
            n_frames_invalidate_voxels=int(n_frames_invalidate_voxels),
            sdf_var_threshold=float(sdf_var_threshold),
            min_weight_threshold=int(min_weight_threshold),
            marching_cubes_threshold=float(marching_cubes_threshold),
            vertices_merging_threshold=float(vertices_merging_threshold),
            # steers the LiDAR update only; RGB-D ignores it, as in the
            # reference
            projective_sdf=bool(projective_sdf),
            num_blocks=int(num_blocks),
            num_buckets=int(num_buckets),
            max_active_blocks=int(max_active_blocks),
            max_alloc_per_frame=int(max_alloc_per_frame))
        self.state = make_state(self.cfg.num_blocks,
                                self.cfg.num_buckets or None, self.device)
        self.state.refill = self._refill
        self.streamer = Streamer(self.cfg, staging)
        self.mesh = mesh_post.MeshAccumulator(vertices_merging_threshold)
        self.gs_container = None
        if gs_optimization_param_path:
            self.gs_container = GaussianContainer(gs_optimization_param_path,
                                                  device=self.device)
        self.camera = C.make_camera(1.0, 1.0, 0.0, 0.0, 1, 1, min_depth,
                                    max_depth, device=self.device)
        self.curr_rot = np.eye(3, dtype=np.float32)
        self.curr_trans = np.zeros(3, np.float32)
        self.camera_in_lidar = np.eye(4, dtype=np.float32)
        self._depth_img = None
        self._rgb_img = None
        self._points = None
        self._normals = None
        self._weights = None
        self._high_free = self.cfg.num_blocks
        # the camera's chunk when every block within its keep radius was
        # last known resident (_bring_back), or None
        self._near_chunk = None
        # the times a frame's allocation ran the high heap dry (_refill)
        self._refills = 0
        self.last_stats = None
        self._warned_cut = False
        self.mesh_stats = {}     # the last extractMesh's figures
        self.integration_profiler = Profiler("integration_profiler",
                                             profiling)
        self.streaming_profiler = Profiler("streamer_profiler", profiling)
        self._write_memory_report()

    # ------------------------------------------------------------------ config
    def _write_memory_report(self, path="memory_allocation.txt"):
        """The memory report of mrhash_tpu's GeoWrapper (calculateMemoryUsage
        of the container, voxel_data_structures.cpp:9-55, and of the
        streamer, streamer.cpp:449-491), written to `path` (the working
        directory by default) at the end of the constructor.  The
        parameter block is the reference's line for line.  The sizes are
        the port's own buffers (PORT_NOTES.md P58): the MapState tensors'
        nbytes on the device, which holds no compact window and no heap
        counters; the budget those sizes came from (torch.cuda.mem_get_info
        on a card); the transient buffers of one stream-out pass.  The
        host grid is new and empty when the report is written, so its
        lines are 0, as in the reference."""
        cfg = self.cfg
        t, pool = self.state.table, self.state.pool
        mb = 1e-6
        sz_hash = sum(x.nbytes for x in (t.pos, t.ptr, t.res, t.fp))
        sz_heap = t.heap_high.nbytes + t.heap_low.nbytes
        sz_pool = sum(getattr(pool, f).nbytes for f in VoxelPool.FIELDS)
        tot_d = sz_hash + sz_heap + sz_pool
        s = self.streamer.staging
        # one pass: pos 3xi32 + res + 4 payload lanes * 512 per block, once
        # gathered on the device and once in pinned host memory
        sz_pass = s * (4 * 4 + P.TOTAL_SDF_BLOCK_SIZE * 4 * 4)
        try:
            with open(path, "w") as f:
                f.write("VoxelContainer | running with following parameters:"
                        f"\nnum_sdf_blocks: {cfg.num_blocks}"
                        f"\nhash_num_buckets: {t.num_buckets}"
                        f"\nhash_bucket_size: {P.HASH_BUCKET_SIZE}"
                        f"\nlinked_list_size: {P.LINKED_LIST_SIZE}"
                        f"\nmax_integration_distance: "
                        f"{cfg.max_integration_distance}"
                        f"\nsdf_truncation: {cfg.sdf_truncation}"
                        f"\nsdf_truncation_scale: {cfg.sdf_truncation_scale}"
                        f"\nintegration_weight_sample: "
                        f"{cfg.integration_weight_sample}"
                        f"\nintegration_weight_max: "
                        f"{cfg.integration_weight_max}"
                        f"\ntotal_size: {t.capacity}"
                        f"\nvoxel_block_volume: {P.TOTAL_SDF_BLOCK_SIZE}\n")
                f.write("=========================================="
                        "===============\n")
                f.write("VoxelContainer | structs - voxel lanes: 16 B "
                        "(sdf f32, sum_squared f32, weight i32, rgb packed "
                        "i32) | hash slot: 24 B (pos 3xi32, ptr, res, fp)\n")
                f.write(f"VoxelContainer | size_d_hashTable : "
                        f"{sz_hash * mb} MB\n")
                f.write(f"VoxelContainer | size_d_heap : {sz_heap * mb} MB\n")
                f.write(f"VoxelContainer | size_d_SDFBlocks : "
                        f"{sz_pool * mb} MB\n")
                f.write(f"VoxelContainer | total d_size: {tot_d} B || "
                        f"{tot_d * mb} MB\n")
                f.write(f"VoxelContainer | {self.device.type} free at "
                        f"construction: {self._free_bytes} B\n")
                f.write("=========================================="
                        "===============\n")
                f.write(f"Streamer | staging blocks: {s}\n")
                f.write(f"Streamer | size_d_pass (transient, and as much "
                        f"pinned host memory) : {sz_pass * mb} MB\n")
                f.write("Streamer | host chunks: 0, host blocks: 0\n")
                f.write("Streamer | size_h_grid : 0.0 MB\n")
                f.write(f"Streamer | total h_size: {sz_pass} B || "
                        f"{sz_pass * mb} MB\n")
                f.write("=========================================="
                        "===============\n")
        except OSError:
            pass

    # ------------------------------------------------------------------ inputs
    def setCamera(self, fx, fy, cx, cy, rows, cols, min_depth, max_depth,
                  camera_model=0):
        model = int(camera_model)
        if model not in (C.PINHOLE, C.SPHERICAL):
            raise ValueError(f"setCamera: unknown camera model {model}")
        self.camera = C.make_camera(fx, fy, cx, cy, rows, cols, min_depth,
                                    max_depth, model, device=self.device)
        # max integration distance follows the camera (geowrapper.cpp:111)
        self.cfg = dataclasses.replace(
            self.cfg, max_integration_distance=float(max_depth))

    def setCurrPose(self, pose, orientation):
        """pose: (3,) translation; orientation: (4,) quaternion x,y,z,w."""
        q = np.asarray(orientation, np.float64).reshape(4)
        self.curr_rot = _quat_to_rot(q[0], q[1], q[2], q[3])
        self.curr_trans = np.asarray(pose, np.float32).reshape(3)

    def setCameraInLidar(self, camera_in_lidar):
        """Stored, as in the reference (geowrapper.cpp:94-96)."""
        self.camera_in_lidar = np.asarray(camera_in_lidar, np.float32)

    def setDepthImage(self, depth):
        """depth: [H,W] metric depth (numpy or a torch tensor)."""
        depth = torch.as_tensor(depth, dtype=torch.float32)
        if depth.dim() != 2:
            raise ValueError("setDepthImage: expected a 2D array")
        self._depth_img = depth
        self._points = None

    def setRGBImage(self, rgb):
        """rgb: [H,W,3] uint8 (numpy or a torch tensor)."""
        if not isinstance(rgb, torch.Tensor):
            rgb = torch.from_numpy(np.asarray(rgb, np.uint8))
        rgb = rgb.to(torch.uint8)
        if rgb.dim() != 3 or rgb.shape[2] != 3:
            raise ValueError("setRGBImage: expected an HxWx3 uint8 array")
        self._rgb_img = rgb

    def setPointCloud(self, points, arg2=False):
        """setPointCloud(points, compute_normals) or setPointCloud(points,
        normals) (pygeowrapper.cpp:66-67); points [N,3] in the sensor frame.
        Normals (MADtree, from the host library, when compute_normals) and
        per-point weights are kept as the reference keeps them; the
        point-centric update (projective_sdf=False) reads the normals, the
        projective one neither.  Unlike the reference, the cloud is not
        padded to a power-of-two bucket (PORT_NOTES.md P16)."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if isinstance(arg2, (bool, np.bool_)):
            if arg2:
                normals, weights = native.estimate_normals(points)
            else:
                normals = np.zeros_like(points)
                weights = np.ones((points.shape[0],), np.float32)
        else:
            normals = np.asarray(arg2, np.float32).reshape(-1, 3)
            if normals.shape[0] == 3 * points.shape[0]:
                normals = normals.reshape(-1, 3, 3)[:, 0, :]  # eigvec col 0
            weights = np.ones((points.shape[0],), np.float32)
        self._points = torch.from_numpy(points)
        self._normals = normals
        self._weights = weights
        self._depth_img = None

    # ------------------------------------------------------------------ compute
    def compute(self):
        """Per-frame step (geowrapper.cpp:118-148).  last_stats holds the
        step's stats (core/pipeline.py::_stats), with host_syncs counted
        from the upload of the pose and the frame on.  The first frame
        whose window the cap (max_active_blocks) cut warns (a
        RuntimeWarning, once per wrapper); last_stats' window_cut counts
        the entries each frame left out; streamed_out,
        streamed_out_voxels, streamed_in, stream_clashed, stream_joined,
        stream_ingest_ms and stream_refills count the streaming the frame
        ran, before its step and within it (_stream_counts)."""
        st = self.streamer
        marks = (len(st.out_events), len(st.in_events), len(st.joined),
                 self._refills)
        self._bring_back()
        if self._high_free <= P.STREAM_THRESHOLD * self.cfg.num_blocks:
            self._stream()
        # setPointCloud and setDepthImage each clear the other's input
        lidar = self._points is not None
        if not lidar and (self._depth_img is None or self._rgb_img is None):
            return
        # torch.profiler ranges while a profiler runs (utils/profiler.py)
        with stage("compute"):
            syncs0 = COUNTS[SYNCS]
            dev = self.device
            with self.integration_profiler.event():
                with stage("compute.upload"):
                    cam = C.with_pose(self.camera, upload(self.curr_rot, dev),
                                      upload(self.curr_trans, dev))
                    if lidar:
                        # the point-centric update takes the normals and
                        # weights
                        inputs = (upload(self._points, dev),) + (
                            () if self.cfg.projective_sdf else tuple(
                                upload(a, dev)
                                for a in (self._normals, self._weights)))
                    else:
                        depth = upload(self._depth_img, dev)
                        rgb = upload(self._rgb_img, dev)
                if lidar:
                    self.state, stats = pipeline.integrate_points(
                        self.cfg, self.state, cam, *inputs)
                else:
                    self.state, stats = pipeline.integrate_rgbd(
                        self.cfg, self.state, cam, depth, rgb)
            stats["host_syncs"] = since(syncs0)
            stats.update(self._stream_counts(*marks))
            self.last_stats = stats
            if stats["window_cut"] and not self._warned_cut:
                self._warned_cut = True
                warnings.warn(
                    f"GeoWrapper: frame {stats['frame'] - 1} left "
                    f"{stats['window_cut']} blocks out of its window, "
                    f"capped at max_active_blocks = "
                    f"{self.cfg.max_active_blocks}; they miss the frame's "
                    "update (last_stats['window_cut'] counts each frame's)",
                    RuntimeWarning, stacklevel=2)
            self._high_free = stats["high_free"]
            self.integration_profiler.write(stats["occupied_blocks"])
            if self.gs_container is not None and not lidar:
                # the GS step consumes the device copies of this frame
                self.gs_container.run_gs(self.cfg, cam, self.state, rgb,
                                         depth)
            if self.viewer_active:
                self._viewer_mesh_tick()

    def _protect_radius(self) -> float:
        """The radius about the camera within which a frame can change a
        block (eviction measures from a block's corner).  A spherical
        sensor's is its reach (ops/integrate.py::sensor_reach, beyond
        which no voxel changes) plus a block's diagonal.  A pinhole
        camera's covers the whole frustum: a wall point at max_depth near
        the image corner lies max_depth * |(1, tanx, tany)| from the
        camera, beyond the reference's max_depth radius, and +0.5 m
        absorbs the truncation band and the block-corner distance; and
        it covers starvation's z-buffer, which takes any voxel seen in
        the image from a window block whose centre lies up to
        max_depth + 1.8 block sides deep (ops/integrate.py::
        blocks_in_frustum_approx), so up to 3.5 voxel diagonals deeper,
        and a block diagonal from the block's corner: at 1 cm voxels the
        first bound holds it, at 5 cm the second is wider."""
        c = self.camera
        side = P.SDF_BLOCK_SIZE * self.cfg.virtual_voxel_size
        if c.model == C.SPHERICAL:
            return I.sensor_reach(self.cfg) + math.sqrt(3.0) * side
        tanx = c.cols / (2.0 * c.fx)           # f32, as the reference
        tany = c.rows / (2.0 * c.fy)
        frustum = float(c.max_depth * torch.sqrt(1.0 + tanx * tanx
                                                 + tany * tany) + 0.5)
        # the image's widest ray, a pixel beyond its edge
        tx = (max(float(c.cx), c.cols - float(c.cx)) + 1.0) / float(c.fx)
        ty = (max(float(c.cy), c.rows - float(c.cy)) + 1.0) / float(c.fy)
        deep = (float(c.max_depth) + 1.8 * side
                + 3.5 * math.sqrt(3.0) * self.cfg.virtual_voxel_size)
        starve = deep * math.sqrt(1.0 + tx * tx + ty * ty) + math.sqrt(
            3.0) * side
        return max(frustum, starve)

    def _near(self):
        """(the camera's chunk key, that chunk's centre, the keep radius
        about the centre): R + chunk_radius, R the protect radius, so that
        every block within R of any camera position in the chunk lies
        within it."""
        grid = self.streamer.grid
        key = tuple(int(k) for k in grid.world_to_chunk(self.curr_trans))
        return (key, grid.chunk_to_world(key),
                self._protect_radius() + grid.chunk_radius)

    def _bring_back(self):
        """Stream-in ahead of the frame (PORT_NOTES.md P72): when the host
        grid holds blocks (or a stream-out job is in flight) and the camera
        has entered another chunk, join the job, then pop every host chunk
        that can hold a block within the keep radius of the chunk's centre
        (a chunk centre within keep + chunk_radius), whatever the heap;
        where those blocks would bring the free high heap to the watermark,
        the trigger streams out, after the pop, so they find room; then
        they go in.  The frame then finds resident every block it can
        touch, and no key the host holds is allocated fresh.  The test is
        the host's, over the grid's keys: with nothing near, no device work
        runs; with an empty grid, not even that."""
        st = self.streamer
        if not st.holds():
            return
        key, centre, keep = self._near()
        if key == self._near_chunk:
            return
        self._near_chunk = key
        st.join()
        # popped before the eviction, so that the blocks this event evicts
        # (beyond keep) wait in the grid for a later chunk
        with stage("stream.in"):
            groups = st.grid.pop_groups_in_sphere(
                centre, keep + 2.0 * st.grid.chunk_radius)
        if not groups:
            return
        # the high blocks they take: a row each res-0 block, and a row per
        # 8 res-1 blocks the low heap cannot hold
        n = sum(g["res"].shape[0] for g in groups)
        n1 = sum(int((g["res"] == 1).sum()) for g in groups)
        rows = n - n1 + max(0, -(-(n1 - self.state.table.low_count)
                                 // P.OCTREE_BRANCHING_FACTOR))
        if (self._high_free - rows
                <= P.STREAM_THRESHOLD * self.cfg.num_blocks):
            self._evict(rows)
        with self.streaming_profiler.event():
            self.state = st.stream_in_blocks(self.state, groups)
            pipeline.mark_streamed_in(self.cfg, self.state, self.camera,
                                      st.filled_slots)
        self._write_streaming_profile()
        # a host int, fresh after the stream-in (ROADMAP C3)
        self._high_free = self.state.table.high_count

    def _stream(self):
        """The stream trigger (geowrapper.cpp:137-138): a budgeted eviction
        of the farthest blocks recovers the free high heap towards
        STREAM_TARGET in one event (mrhash_tpu's plan_evictions).  The
        eviction spares every block within the keep radius of the centre of
        the camera's chunk (_near), so the frames up to the next chunk find
        resident every block they can touch; the host chunks come back in
        _bring_back, ahead of the frame, and not here.  Only the plan, the
        gather and the clear run here; the copy to the host and the ingest
        overlap the next frames, and the next trigger or chunk joins them
        (PORT_NOTES.md P37)."""
        self._evict(0)

    def _evict(self, incoming):
        """_stream's event, with `incoming`, the high blocks a stream-in or
        the frame's allocation is about to take, counted as taken."""
        need = (int(P.STREAM_TARGET * self.cfg.num_blocks) - self._high_free
                + incoming)
        need = min(need, 4096, self.streamer.staging)
        key, centre, keep = self._near()
        with self.streaming_profiler.event():
            self.state = self.streamer.stream_out(self.state, centre, keep,
                                                  budget=max(need, 0),
                                                  asynchronous=True)
            # an evicted res-1 block frees a low id, not a row: the res-1
            # blocks pack into fewer rows, and the rest go back to the high
            # heap, which the watermark reads
            repack_low(self.state)
        self._write_streaming_profile()
        # every block within the chunk's keep radius is resident: the grid
        # held nothing before, or _bring_back brought it back this frame
        self._near_chunk = key
        # a host int, fresh after the stream (ROADMAP C3)
        self._high_free = self.state.table.high_count

    def _write_streaming_profile(self):
        """The streaming profiler's line, with the host grid's block count,
        only when it is on: the count takes the grid's lock, which the
        worker holds while it ingests the stream-out just issued, so
        reading it would make every stream-out wait for its own ingest."""
        if self.streaming_profiler.enabled:
            self.streaming_profiler.write(self.streamer.grid.num_blocks())

    def _refill(self):
        """MapState.refill: a frame's allocation ran the high heap dry (a
        frame that turns a corner can meet more fresh ground than the
        watermark leaves free).  The trigger streams out, the frame's
        allocation cap counted as taken, since eviction spares every block
        the frame can touch; True where the heap gained blocks."""
        before = self.state.table.high_count
        self._refills += 1
        self._evict(self.cfg.max_alloc_per_frame)
        return self.state.table.high_count > before

    def _stream_counts(self, n_out, n_in, n_joined, n_refills):
        """The streaming since the marks (the lengths of the Streamer's
        out_events, in_events and joined, and the refills): streamed_out
        and streamed_out_voxels, the blocks the trigger evicted and their
        voxels (512 a res-0 block, 64 a res-1 block); streamed_in, the
        blocks inserted back; stream_clashed, the host blocks that found
        their key resident (an error: each is kept in the grid);
        stream_joined and stream_ingest_ms, the asynchronous stream-out
        events the frame joined and the worker's ingest time of them;
        stream_refills, the times the frame's allocation ran the high heap
        dry and streamed out within the step (_refill).  Host numbers, no
        device read."""
        st = self.streamer
        out, joined = st.out_events[n_out:], st.joined[n_joined:]
        ins = st.in_events[n_in:]
        return dict(streamed_out=sum(e["blocks"] for e in out),
                    streamed_out_voxels=sum(e["voxels"] for e in out),
                    streamed_in=sum(e["inserted"] for e in ins),
                    stream_clashed=sum(e["clashed"] for e in ins),
                    stream_joined=len(joined),
                    stream_ingest_ms=sum(e["ingest_ms"] for e in joined),
                    stream_refills=self._refills - n_refills)

    # ------------------------------------------------------------------ meshing
    def _extract_resident(self, state=None, owned=None, stats=None):
        """MeshExtractor::extractMesh on the device-resident blocks of
        `state` (the live map by default): every occupied slot, or with
        `owned` (bool[capacity]) only the owned ones, in slot order, swept
        in windows of MESH_CHUNK blocks (each gated once, with its 27-ring)
        and batches of MESH_MAX_CELLS gated cells.  Blocks outside the
        window still serve its cells' corner reads.  Returns host numpy
        (tri_pos f32[T,3,3], tri_col f32[T,3,3]); `stats`, a dict, gains
        the windows, gated cells and cell batches."""
        state = self.state if state is None else state
        table = state.table
        slots = H.compact(table, owned, table.capacity)
        bpos, bptr, bres = table.pos[slots], table.ptr[slots], table.res[slots]
        pos, col = [], []
        stats = {} if stats is None else stats
        for off in range(0, slots.shape[0], MESH_CHUNK):
            sl = slice(off, off + MESH_CHUNK)
            p, c = M.extract_iso_surface(self.cfg, table, state.pool,
                                         bpos[sl], bptr[sl], bres[sl],
                                         MESH_MAX_CELLS, stats)
            pos.append(p.cpu().numpy())
            col.append(c.cpu().numpy())
        if not pos:
            empty = np.zeros((0, 3, 3), np.float32)
            return empty, empty
        return np.concatenate(pos), np.concatenate(col)

    # ---- viewer mesh thread (mesh_extractor.cpp:78-92) --------------------
    def _resident_snapshot(self):
        """A private copy of the device-resident map, for the viewer's
        worker: the table's keys as they are, each occupied block's voxels
        (sdf, weight, rgb) in a compact pool of its own rows, a res-1
        block's at lanes [0, 64) of its row.  Later frames update the live
        map in place and leave the copy as it was; the sweep of the copy
        gives the live map's triangles, in the same order."""
        t = self.state.table
        occ = t.ptr != H.FREE
        slots = torch.nonzero(occ).flatten()
        rank = (torch.cumsum(occ.to(torch.int32), 0) - 1).to(torch.int32)
        sdf, _, w, rgb = gather_blocks(self.state.pool, t.ptr[slots],
                                       t.res[slots], with_ssq=False)
        empty = torch.empty(0, dtype=torch.int32, device=t.ptr.device)
        table = H.HashTable(
            pos=t.pos.clone(), res=t.res.clone(), fp=t.fp.clone(),
            ptr=torch.where(occ, rank * P.TOTAL_SDF_BLOCK_SIZE, H.FREE),
            heap_high=empty, heap_low=empty, high_count=0, low_count=0,
            num_buckets=t.num_buckets, num_blocks=int(slots.shape[0]))
        return MapState(table=table, pool=VoxelPool(
            sdf=sdf, sumsq=torch.zeros_like(sdf), weight=w, rgbp=rgb),
            frame=self.state.frame)

    def _viewer_mesh_tick(self):
        """With viewer_active, refresh the renderable mesh in the
        background after a frame (the reference's viewer thread
        re-extracts on demand).  The map is updated in place, so the worker
        sweeps a snapshot taken here, on the calling thread; a tick is
        skipped while the previous one runs."""
        if self._viewer_future is not None and not self._viewer_future.done():
            return
        snap = self._resident_snapshot()

        def work():
            tri_pos, tri_col = self._extract_resident(state=snap)
            m = mesh_post.MeshAccumulator()
            if tri_pos.shape[0]:
                m.add_triangles(tri_pos, tri_col)
            self.viewer_mesh, self.viewer_mesh_frame = m, snap.frame

        self._viewer_future = self._viewer_pool.submit(work)

    def getViewerMesh(self):
        """The latest background-extracted mesh (waits for a tick in
        flight; empty before the first)."""
        if self._viewer_future is not None:
            self._viewer_future.result()
        return self.viewer_mesh

    def close(self):
        """Wait for the viewer's tick in flight and stop its worker, then
        join an asynchronous stream-out and stop the Streamer's worker
        (re-raising their errors)."""
        if self._viewer_pool is not None:
            try:
                self.getViewerMesh()
            finally:
                self._viewer_pool.shutdown(wait=True)
                self._viewer_pool = None
        self.streamer.close()

    def extractMesh(self, filename: str):
        """extractMesh + ASCII PLY.  By default the host-native sweep
        (native/mrhash_mesh.cpp through the port's `native` loader, the
        reference's read-only path): snapshot the device blocks over a copy
        of the host chunk grid, run the Transvoxel sweep on the host; the
        device map stays live.  With MRHASH_HOST_MESH=0, the reference's
        switch, the device sweep (ops/meshing.py): directly over the map
        when the host grid is empty, else the chunk-batch sweep."""
        t_start = time.perf_counter()
        # the blocks of an asynchronous stream-out still in flight land in
        # the grid before either sweep reads it
        self.streamer.join()
        self.mesh_stats = dict(windows=0, cells=0, cell_batches=0)
        if os.environ.get("MRHASH_HOST_MESH", "1") != "0":
            self._extract_mesh_host()
        elif not self.streamer.grid.chunks:
            # the whole map is device-resident: the stream-out and
            # read-only re-insert exist for maps the host grid holds
            self.mesh.reset()
            tri_pos, tri_col = self._extract_resident(stats=self.mesh_stats)
            if tri_pos.shape[0] > 0:
                self.mesh.add_triangles(tri_pos, tri_col)
            print("GeoWrapper::extractMesh | direct (device-resident map) "
                  f"{time.perf_counter() - t_start:.1f}s")
        else:
            self._extract_mesh_batches(t_start)
        plyio.write_mesh_ply(filename, self.mesh.vertices, self.mesh.faces,
                             self.mesh.colors)
        print(f"GeoWrapper::extractMesh | written "
              f"{self.mesh.vertices.shape[0]} vertices and "
              f"{self.mesh.faces.shape[0]} faces to {filename}")

    def _extract_mesh_batches(self, t_start):
        """The chunk-batch device sweep (the reference's protocol,
        geowrapper.cpp:150-230, read-only as mrhash_tpu's): stream the
        whole map out, then for each batch of host chunks whose 1-ring
        fits the device budget, insert the batch and its ring read-only
        (the grid keeps ownership), extract the batch's own blocks (the
        ring's serve only the corner reads, so each block meshes once) and
        clear the device map.  The map is left empty, every block in the
        grid.  `mesh_stats` gains the phases' seconds, the batches, the
        blocks the device hash dropped and the batches over budget (each
        of the last two also printed as a warning)."""
        self.state = self.streamer.stream_all_out(self.state)
        self._near_chunk = None
        self.mesh.reset()
        ph = self.mesh_stats
        ph.update(out_s=time.perf_counter() - t_start, insert_s=0.0,
                  extract_s=0.0, clear_s=0.0, host_s=0.0, batches=0,
                  dropped=0, over_budget=0)
        grid = self.streamer.grid
        sizes = {k: g["pos"].shape[0] for k, g in grid.chunks.items()}
        budget = min(self.cfg.max_active_blocks,
                     int(self.cfg.num_blocks * 0.9))
        order = sorted(sizes)
        tris, i = [], 0
        while i < len(order):
            batch, loaded, total = set(), set(), 0
            while i < len(order):
                key = order[i]
                need = {(key[0] + dx, key[1] + dy, key[2] + dz)
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)}
                need = {c for c in need if c in sizes} - loaded
                nb = sum(sizes[c] for c in need)
                if batch and total + nb > budget:
                    break
                batch.add(key)
                loaded |= need
                total += nb
                i += 1
            if total > budget:
                # only a singleton batch: its own 27-neighbourhood exceeds
                # the device budget, and its blocks may not all fit
                ph["over_budget"] += 1
                print(f"GeoWrapper::extractMesh | chunk batch needs "
                      f"{total} blocks > device budget {budget}; raise "
                      "max_active_blocks / num_blocks")
            groups = [grid.chunks[c] for c in sorted(loaded)]
            blocks = {k: np.concatenate([g[k] for g in groups])
                      for k in groups[0]}
            owned = np.concatenate([np.full(g["pos"].shape[0], c in batch)
                                    for c, g in zip(sorted(loaded), groups)])
            t0 = time.perf_counter()
            _, owned_mask, dropped = self.streamer.insert_readonly(
                self.state, blocks, owned)
            ph["insert_s"] += time.perf_counter() - t0
            ph["batches"] += 1
            if dropped:
                ph["dropped"] += dropped
                print(f"GeoWrapper::extractMesh | {dropped} blocks did not "
                      "fit the device hash this batch; their cells are "
                      "missing from the mesh (raise num_blocks)")
            t0 = time.perf_counter()
            tris.append(self._extract_resident(owned=owned_mask, stats=ph))
            ph["extract_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            t = self.state.table
            self.state.table = H.make_table(t.num_blocks, t.num_buckets,
                                            t.pos.device)
            for f in VoxelPool.FIELDS:
                getattr(self.state.pool, f).zero_()
            ph["clear_s"] += time.perf_counter() - t0
        self._high_free = self.cfg.num_blocks
        t0 = time.perf_counter()
        if tris:
            tri_pos = np.concatenate([p for p, _ in tris])
            if tri_pos.shape[0] > 0:
                self.mesh.add_triangles(
                    tri_pos, np.concatenate([c for _, c in tris]))
        ph["host_s"] = time.perf_counter() - t0
        print("GeoWrapper::extractMesh | phases " + " ".join(
            f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ph.items()))

    def _extract_mesh_host(self):
        """The host-native sweep over a read-only snapshot of the device
        blocks merged over a copy of the host chunk grid."""
        snap = ChunkGrid(np.asarray(self.cfg.voxel_extents, np.float32))
        snap.chunks = dict(self.streamer.grid.chunks)
        self.streamer.snapshot_into(self.state, snap, mesh_only=True)
        self.mesh.reset()
        groups = list(snap.chunks.values())
        if groups:
            cat = {k: np.concatenate([g[k] for g in groups])
                   for k in ("pos", "res", "sdf", "w", "rgb")}
            tri_pos, tri_col = native.extract_mesh_host(
                cat["pos"], cat["res"], cat["sdf"], cat["w"], cat["rgb"],
                self.cfg.virtual_voxel_size, self.cfg.voxel_extents,
                self.cfg.marching_cubes_threshold,
                self.cfg.min_weight_threshold)
            if tri_pos.shape[0] > 0:
                self.mesh.add_triangles(tri_pos, tri_col)

    # ------------------------------------------------------------------ GS
    def GSSavePointCloud(self, folder: str):
        if self.gs_container is None:
            print("GeoWrapper::GSSavePointCloud | GS container not "
                  "initialized")
            return
        self.gs_container.save_ply(folder, int(self.state.frame))

    def GSFinalOpt(self):
        if self.gs_container is not None:
            self.gs_container.optimize_final()

    # ------------------------------------------------------------------ persistence
    def streamAllOut(self):
        self.state = self.streamer.stream_all_out(self.state)
        self._high_free = self.state.table.high_count
        self._near_chunk = None

    def clearBuffers(self):
        """geowrapper.cpp clearBuffers: evict + drop the host grid."""
        self.streamAllOut()
        self.streamer.grid.chunks = {}
        self.streamer.print_statistics()

    def serializeData(self, filename_hash="./data/hash_points.ply",
                      filename_voxel="./data/voxel_points.ply"):
        self.streamer.serialize_data(filename_hash, filename_voxel)

    def serializeGrid(self, filename="./serialized_grid.bin"):
        """Checkpoint the host chunk grid (mrhash_tpu's npz format; call
        streamAllOut first to include the device blocks)."""
        self.streamer.serialize_grid(filename)

    def deserializeGrid(self, filename="./serialized_grid.bin"):
        """Replace the host chunk grid with a checkpoint's; the blocks come
        back to the device as the camera nears them."""
        self.streamer.deserialize_grid(filename)
        self._near_chunk = None

    # ------------------------------------------------------------------ getters
    def getHashNumBuckets(self):
        return self.state.table.num_buckets

    def getNumSdfBlocks(self):
        return self.cfg.num_blocks

    def getHashBucketSize(self):
        return P.HASH_BUCKET_SIZE

    def getSdfTruncation(self):
        return self.cfg.sdf_truncation

    def getSdfTruncationScale(self):
        return self.cfg.sdf_truncation_scale

    def getIntegrationWeightSample(self):
        return self.cfg.integration_weight_sample

    def getIntegrationWeightMax(self):
        return self.cfg.integration_weight_max

    def getVirtualVoxelSize(self):
        return self.cfg.virtual_voxel_size

    def getLinkedListSize(self):
        return P.LINKED_LIST_SIZE

    def getNFramesInvalidateVoxels(self):
        return self.cfg.n_frames_invalidate_voxels

    def getMaxNumSdfBlockIntegrateFromGlobalHash(self):
        return self.streamer.staging

    def getVoxelExtentsScale(self):
        return self.cfg.voxel_extents[0]

    def getCurrPose(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.curr_rot
        m[:3, 3] = self.curr_trans
        return m

    def getPointCloud(self):
        """The cloud setPointCloud kept, f32[N,3] (the whole cloud: the
        port does not pad it, PORT_NOTES.md P16)."""
        return None if self._points is None else self._points.numpy()

    def getNormals(self):
        """The normals setPointCloud kept, f32[N,3]."""
        return self._normals

    def getVertices(self):
        return self.mesh.vertices

    def getFaces(self):
        return self.mesh.faces

    def getColors(self):
        return self.mesh.colors

    # ------------------------------------------------------------------ setters
    # The size setters rebuild the map state and the Streamer on the
    # wrapper's device (the reference mutates the same fields before first
    # use); the rebuilt map starts empty, as the reference's does.
    def _rebuild(self, **cfg_updates):
        """mrhash_tpu's _rebuild, in another order: the new config first
        (a bad value raises before anything is torn down), then the viewer's
        tick and the Streamer are joined and closed (an asynchronous
        stream-out still copies from the old pool), the old state is
        released, and only then is the new one made: at the Replica preset
        the pool is ~4.3 GB, and making the new state first would hold
        both.  The new Streamer keeps the old staging size; the old host
        grid, of another voxel size or chunk extent, is not carried."""
        cfg = dataclasses.replace(self.cfg, **cfg_updates)
        self.getViewerMesh()
        staging = self.streamer.staging
        self.streamer.close()
        self.state = None
        self.cfg = cfg
        self.state = make_state(cfg.num_blocks, cfg.num_buckets or None,
                                self.device)
        self.state.refill = self._refill
        self.streamer = Streamer(cfg, staging)
        self._high_free = cfg.num_blocks
        self._near_chunk = None
        self.last_stats = None

    def setNumSdfBlocks(self, n):
        self._rebuild(num_blocks=int(n))

    def setHashNumBuckets(self, n):
        self._rebuild(num_buckets=int(n))

    def setHashBucketSize(self, n):
        if int(n) != P.HASH_BUCKET_SIZE:
            raise ValueError("hash bucket size is compile-time (params.py)")

    def setSdfTruncation(self, v):
        self.cfg = dataclasses.replace(self.cfg, sdf_truncation=float(v))

    def setSdfTruncationScale(self, v):
        self.cfg = dataclasses.replace(self.cfg,
                                       sdf_truncation_scale=float(v))

    def setIntegrationWeightSample(self, v):
        self.cfg = dataclasses.replace(self.cfg,
                                       integration_weight_sample=int(v))

    def setIntegrationWeightMax(self, v):
        """The reference's clamp to 255, before MapConfig, which rejects a
        larger cap (PORT_NOTES.md P35)."""
        if int(v) > 255:
            print("GeoWrapper::setIntegrationWeightMax | clamping "
                  f"{int(v)} to 255 (weight is uint8 on the wire)")
        self.cfg = dataclasses.replace(
            self.cfg, integration_weight_max=min(int(v), 255))

    def setVirtualVoxelSize(self, v):
        self._rebuild(virtual_voxel_size=float(v))

    def setLinkedListSize(self, v):
        if int(v) != P.LINKED_LIST_SIZE:
            raise ValueError("linked list size is compile-time (params.py)")

    def setNFramesInvalidateVoxels(self, v):
        self.cfg = dataclasses.replace(self.cfg,
                                       n_frames_invalidate_voxels=int(v))

    def setMaxNumSdfBlockIntegrateFromGlobalHash(self, v):
        """A Streamer of staging size v.  The old one is closed and hands
        its host chunk grid to the new one, so the blocks already streamed
        out stay in the map; the reference drops both its workers and the
        grid (ROADMAP C15, PORT_NOTES.md P59)."""
        old = self.streamer
        old.close()
        self.streamer = Streamer(self.cfg, int(v))
        self.streamer.grid = old.grid

    def setVoxelExtentsScale(self, v):
        self._rebuild(voxel_extents=(float(v),) * 3)
