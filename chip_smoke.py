#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (mrhash_tpu_torch) on one NVIDIA
card.

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no result line):
  1. probe   — CUDA present; device, CUDA runtime, nvidia-smi, nvcc;
  2. build   — compile the kernels K1-K14 from mrhash_tpu_torch/csrc (one
               nvcc per source, started together);
  3. compare — each kernel against its plain PyTorch twin on the inputs its
               path gives it (K1, K2: the RGB-D path after 40 frames at
               1200x680; K6, which no path calls: the same starvation
               readback's frame and lanes as a 5-channel bf16 image with
               per-block patch origins; K1's res-1 path: the multi-res
               RGB-D path after 40 frames; K3 and its res-1 path: the LiDAR
               path, one resolution and multi-res, after 20 scans at
               64x1024, the res-1 entries alone and the whole multi-res
               window in one launch; K4, K5: the GS training render of frame 1 of phase
               6's scene, 1200x680, K = 64, and K5 again at GSFinalOpt's
               cap, K = 128; K7-K9: the multi-res orbit's frame 40 and the
               LiDAR slice's scan 20; K10-K12: a coarsening step of
               C_SERVED blocks on the LiDAR slice's map, each launch timed
               alone after the map is restored; K13, K14: the multi-res
               LiDAR slice's scan 20, its window and a drive-sized one,
               bit for bit, each timed alone behind a spin kernel beside
               the twin's eager time), then timed in turns (twin,
               kernel, library, library, kernel, twin) by CUDA-graph replay
               and CUDA events; K2 also on phase 11's spherical z-buffer
               (64x1024, after 10 point-centric scans); each whole slice
               (RGB-D at one resolution and multi-res, LiDAR projective and
               point-centric, GS, streaming) on the card against the same
               slice on the CPU on a small scene (the point-centric one
               with starvation and GC: the same blocks freed), and the
               full-size quad tree of phase 6's frame 0; and the
               allocation candidates on the card equal to the CPU's as sets
               at full width (ROADMAP C14): phase 4's tile DDA on frames 0,
               1 and 100 and the point-centric voxel walk of one 64x1024
               scan, 0 keys apart; the quality protocol's small box preset
               (apps/quality_eval.py, 120x160, 12 frames) on both, metric
               rows within 1e-4 and vertex counts equal; and a setter
               sequence on phase 3's small RGB-D scene (3 frames,
               setVirtualVoxelSize, 3 frames, setNumSdfBlocks and
               setVoxelExtentsScale, 3 frames) on both, the maps within
               the RGB-D bounds;
  4. RGB-D   — GeoWrapper(device="cuda") at replica.cfg's settings, 120
               frames of bench.py's box-room orbit (starvation fires on
               frame 100), with the kernels' launch counts taken over that
               run only (K10-K12 none: one resolution never coarsens;
               K13, K14 none: the LiDAR raster and projection); then
               streamAllOut (phase 9 meshes this path);
  5. LiDAR   — GeoWrapper(device="cuda") at newer_college.cfg's settings, 40
               scans of a 64x1024 sensor driving 0.5 m per scan past a
               ground plane and a 25 m cylinder wall, with K3's launch
               count taken over that run only (and K13's three launches and
               K14's one on every scan); then streamAllOut +
               extractMesh, whose vertices must lie on the plane or the
               wall;
  6. GS      — GeoWrapper(device="cuda", gs_optimization_param_path=
               configurations/params.json) on tools/bench_gs.py's protocol
               at 1200x680: the 6 m box room textured by texture_rgb, 5 cm
               voxels, two training frames through compute(), 60 refinement
               iterations on frame 1, PSNR on frame 1 and on a held-out pose
               before and after GSFinalOpt (before it, at least BENCH_GS's
               TPU rows less 1 dB), GSSavePointCloud to a temporary
               directory, then 10 more frames of the pan for the GS frame
               time; K4's and K5's launch counts over that run only;
  7. multi-res RGB-D — phase 4 at tools/bench_extra.py::bench_multires's
               settings (sdf_var_threshold 1.0, 2^13 allocations per
               frame): frames/s, res-0 and res-1 block counts, peak memory,
               K1's res-0 and res-1 launches, K2's and K10-K12's (at least
               one each: the map coarsens) and K13's and K14's (none) over
               that run; then the mesh on the walls;
  8. multi-res LiDAR — phase 5 at bench_lidar(multires=True)'s settings
               (sdf_var_threshold 1.0, 512 coarsenings per scan): scans/s,
               res-1 blocks, K3's res-0 and res-1 launches and K10-K12's
               (at least one each), K13's and K14's (3 and 1 a scan);
               then the mesh;
  9. streaming walk — tools/bench_walk.py's settings (1200x680, 1 cm, max
               depth 4 m, 2^16 blocks): 150 + 120 frames down the 1.5 m
               square tube at 8 cm/frame, so the watermark fires and the
               farthest blocks stream to the host grid; FPS over the last
               120 frames with the stream events, per-event milliseconds,
               K1's and K2's launches; then 40 frames back, turned around
               (stream-in), the duplicate ratio, extractMesh over grid +
               device (vertices on the tube's walls), streamAllOut and a
               serializeGrid -> deserializeGrid round trip;
 10. device mesh — the device sweep (extractMesh with MRHASH_HOST_MESH=0,
               ops/meshing.py): phase 3's small scenes meshed on the card
               and on the CPU (the direct path, then after streamAllOut the
               chunk-batch path; equal counts, vertices within 1e-5) and
               raycast on both (hits equal, depth within 1e-4); 40 frames
               of phase 4 with viewer_active (FPS, and the last tick's mesh
               equal to _extract_resident of its frame's map, whose sweep
               torch.profiler counts: launches and syncs per cell batch);
               then phases 7's and 9's maps, meshed by the device sweep
               after their host sweeps: seconds, phases, gated cells,
               batches and peak memory of each, no block dropped, no batch
               over budget, the triangles matched one to one to the host
               sweep's in 9-D (positions within 1e-3, colours within 0.5;
               on the walk as many as a minute allows, in a seeded order),
               and on the walk equal vertex, face and triangle counts and
               the vertices on the tube's walls; the figures on one
               {"mesh": ...} line;
 11. LiDAR, point-centric and starved — phase 5's 40 scans with
               starvation every 10 scans (newer_college.cfg has 0: none of
               the LiDAR configs starves) and GC on every scan: pass (a)
               the point-centric update (projective_sdf=False, MADtree
               normals from setPointCloud(points, True)), pass (b) the
               projective update (K3); scans/s over the last 30 scans
               (setPointCloud's share apart), visited voxels and distinct
               blocks per scan, K2's launches (exactly 3: scans 10, 20, 30)
               and K3's, the blocks GC freed, and the mesh on the plane or
               the wall; the figures on one {"points": ...} line.
 12. quality and the API — apps/quality_eval.py at the Replica preset
               (1200x680, 1 cm, 7 cm truncation, 2^19 blocks, then
               setHashNumBuckets(2^15)), 40 frames of the orbit, the host
               sweep's extractMesh, the PLY read back and
               eval_reconstruction's metrics against 2M GT points, each
               phase's seconds on its own line: (a) the box room (Chamfer-
               L1@5cm < 0.010 m, F@5cm > 0.99); (b) the cluttered room
               with multi-resolution (threshold 1.0, min weight 2: K1 res-1
               launches > 0, F@5cm >= 0.82, P@5cm >= 0.95) and the
               recall-miss diagnosis; (c) the setters on the card:
               setNFramesInvalidateVoxels(10) on phase 4's wrapper built
               without starvation, after its first frame, then 30 frames
               (K2 exactly 3 launches); setMaxNumSdfBlockIntegrateFrom-
               GlobalHash and a rebuild (setNumSdfBlocks) while phase 9's
               walk has a stream-out in flight, the grids equal to a run
               that joined first, no thread left; (d) the memory report of
               a GeoWrapper at the Replica preset, its device total equal
               to the state's nbytes and to memory_allocated's growth
               within 1 %, and the peak across setHashNumBuckets; the
               figures on one {"quality": ...} line.
 13. sharding — mrhash_tpu_torch/parallel's sharded steps, one process per
               rank through parallel/launch.py::run_ranks (the parent frees
               its cached device memory first): two ranks sharing the card
               over gloo, then one rank over NCCL.  (a) card = CPU: phase
               3's small multi-res RGB-D scene (starving every 2 frames)
               and its small LiDAR scene (starving every 2 scans), each
               sharded on the card and on the CPU, each rank's two maps
               equal by key (the RGB-D bounds; LiDAR: P15's flip bound);
               (b) RGB-D at phase 7's settings, 40 frames of the orbit
               starving every 20 frames: at n = 1 the map after frame 19
               equal to the single-process pipeline's; (c) LiDAR at phase
               8's settings, 40 scans starving every 10.  At each n: every
               key on its owner and on no other rank, occupied + free = the
               local capacity, K1 res-0 and res-1 (b) or K3's two paths (c)
               launched on every rank, K2 exactly once (b) or 3 times (c)
               per rank, extract_mesh_sharded's mesh on the walls (b) or
               on the ground or the wall (c) at > 95 %; frames/s over
               frames 10-39, the collectives' ms per frame, peak memory per
               rank, the launches, the key overlap of n = 2 with n = 1; the
               figures on one {"sharding": ...} line.
After the runs no jax, no mrhash_tpu, no bench and no tools/quality_eval
module may be loaded.  The last lines are the mesh, the point-centric,
the quality and the sharding figures' JSON lines, the kernels'
JSON record (K1 and K3 with res1_* figures beside their res-0 ones, K1,
K2 and K3 with phase 13's launches per run and rank, K1
with phase 12's launches, K2 with the setter check's, K3
also with the mixed window's one launch and the res-1 grid's empty-kernel
floor, K2 with sph_* figures on the spherical readback and phase 11's
launches, K4 with the warp-steps it walks and those its early exit
leaves, K5 with k128_* figures at K = 128), the card's name and power
limit, and {"ok": true, "device": {...}}.

Each kernel's bound_ms is the larger of its bytes over 3.35 TB/s and its
f32 operations over 67 TFLOP/s (an H100 SXM's published peaks), counted
from this run's inputs: every input read once, every output written once,
the pool lanes that only an update needs read and written only where
this run updated them, and the blend's operations (and K5's attribute
and mask reads) only for the valid (tile, k) slots of this render.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# kernel launch counts (utils/profiler.COUNTS, under the wrappers' names;
# mrhash_tpu_torch is imported inside the functions, so chip_profile.py can
# put another checkout's first)
K1_NAMES = ("fused_integrate_rows", "fused_integrate_rows_res1",
            "sample_image")
K3_NAMES = ("fused_integrate_points_rows",
            "fused_integrate_points_rows_res1")
ALLOC_NAMES = ("alloc_walk", "alloc_scatter", "alloc_compact", "alloc_lookup",
               "alloc_insert")
COARSEN_NAMES = ("coarsen_select", "coarsen_merge", "coarsen_scatter")
SCAN_NAMES = ("raster_scan", "project_window")   # K13 (3 launches), K14


def reset_launches(*names):
    from mrhash_tpu_torch.utils.profiler import COUNTS
    for name in names:
        COUNTS[name] = 0


def launch_counts(*names):
    from mrhash_tpu_torch.utils.profiler import COUNTS
    return {name: COUNTS[name] for name in names}


ROWS, COLS = 680, 1200
FX = FY = 600.0
CX, CY = 599.5, 339.5
ORBIT = 40
N_FRAMES = 120
HALF = 3.0                      # box room half side, metres
TURNS, REPEAT = 20, 10          # per version: 20 turns of 10 calls
TOL = dict(sdf=2e-5, sumsq=5e-4)
MR_THRESHOLD = 1.0              # multi-res: tools/bench_extra.py's threshold
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS = 67e12               # H100 SXM, float32 outside the tensor cores

# LiDAR: configurations/newer_college.cfg, Ouster OS1-64 (64 x 1024)
L_ROWS, L_COLS = 64, 1024
L_FRAMES, L_COMPARE_AT, L_STEADY = 40, 20, 10
L_WALL, L_GROUND = 25.0, -1.5   # cylinder radius, ground height (metres)
L_TOL = 0.3                     # mesh: vertices within 0.3 m of a surface
L_STARVE = 10                   # phase 11: starve every 10 scans (the cfg: 0)
L_TIMED = 30                    # phase 11: scans/s over the last 30 scans
C_SERVED = 32                   # phase 3: coarsenings a step (the drive's)
SPIN_CYCLES = 2_000_000         # ~1 ms of a spin kernel ahead of a timed launch

# GS: tools/bench_gs.py's protocol (BENCH_GS.json rows for the PSNR bar)
GS_PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configurations", "params.json")
GS_TRAIN_ITERS = 60
GS_MORE_FRAMES = 10
GS_PSNR_REF = dict(train=23.99, holdout=28.27)   # BENCH_GS.json, quality
GS_K = 64                       # train_max_per_tile
GS_FINAL_K = 128                # GSFinalOpt's blend cap (gs/container.py)

# streaming walk: tools/bench_walk.py (1200x680, 1 cm, 2^16 blocks)
W_HALF, W_STEP, W_MAXD = 1.5, 0.08, 4.0   # tube half side, m/frame, m
W_BLOCKS = 1 << 16
W_WARM, W_TIMED = 150, 120
W_BACK, W_BACK_STEP = 40, 0.25            # the walk back, turned around
W_SMALL = dict(fwd=80, back=40, step=0.3)  # phase 3's 64x256 walk


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# scene: bench.py's box-room orbit, in numpy
# ---------------------------------------------------------------------------

def orbit_pose(i):
    """Rotation about y by 2*pi*(i % ORBIT)/ORBIT plus a small wobble
    (bench.py:95-101); returns (rot, trans, quaternion x,y,z,w)."""
    import numpy as np
    th = 2.0 * np.pi * (i % ORBIT) / ORBIT
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    trans = np.array([0.05 * np.sin(th), 0.02 * np.cos(th), 0.0], np.float32)
    quat = np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)])
    return rot, trans, quat


def room_depth(rot, trans, rng, rows=ROWS, cols=COLS, fx=FX, fy=FY, cx=CX,
               cy=CY):
    """Depth of a box room seen from inside (bench.py:21-46): world-space
    ray-box intersection, camera z stored, 3 mm noise."""
    import numpy as np
    r = np.arange(rows, dtype=np.float32)[:, None]
    c = np.arange(cols, dtype=np.float32)[None, :]
    x = np.broadcast_to((c - cx - 0.5) / fx, (rows, cols))
    y = np.broadcast_to((r - cy - 0.5) / fy, (rows, cols))
    ray = np.stack([x, y, np.ones((rows, cols), np.float32)], -1)
    d_cam = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    d_w = d_cam @ rot.T
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d_w) > 1e-6, 1.0 / d_w, np.inf)
    t1 = (-HALF - trans) * inv
    t2 = (HALF - trans) * inv
    t_far = np.min(np.maximum(t1, t2), axis=-1)
    depth = t_far * d_cam[..., 2] + rng.normal(0, 0.003, (rows, cols))
    return np.clip(depth, 0.0, 29.0).astype(np.float32)


def make_wrapper(device, multires=False, viewer=False, starve=100):
    """The port's GeoWrapper at configurations/replica.cfg's settings, with
    bench.py's capacities; multires: tools/bench_extra.py::bench_multires's
    (sdf_var_threshold 1.0, 2^13 allocations per frame); viewer: with
    viewer_active; starve: n_frames_invalidate_voxels (the cfg's 100)."""
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(sdf_truncation=0.07, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.01,
                    n_frames_invalidate_voxels=starve, voxel_extents_scale=1,
                    marching_cubes_threshold=1.5, min_weight_threshold=5,
                    min_depth=0.01, max_depth=30.0,
                    sdf_var_threshold=MR_THRESHOLD if multires else 0.0,
                    num_blocks=1 << 19, num_buckets=1 << 15,
                    max_active_blocks=1 << 17,
                    max_alloc_per_frame=1 << (13 if multires else 14),
                    viewer_active=viewer, profiling=False, device=device)
    gw.setCamera(FX, FY, CX, CY, ROWS, COLS, 0.01, 30.0)
    return gw


def feed(gw, i, depths, rgb):
    _, trans, quat = orbit_pose(i)
    gw.setCurrPose(trans, quat)
    gw.setDepthImage(depths[i % ORBIT])
    gw.setRGBImage(rgb)
    gw.compute()


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def graphed(fn):
    """A callable that replays REPEAT calls of `fn` captured in one CUDA
    graph: back-to-back launches with no host launch cost between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPEAT):
            fn()
    return graph.replay


def time_in_turns(kernel, twin, library=None, **extra):
    """Median ms per call of each version, timed with CUDA events in turns
    (twin, kernel, library, extra..., then the same backwards) after one
    warm-up call of each.  A turn replays REPEAT calls captured in one CUDA
    graph, so every version is timed on the device with no host launch
    cost between its launches.  `kernel` is the wrapper's launcher, past
    the wrapper's checks: the index-range check syncs with the device.
    Returns {"kernel": ms, "twin": ms, "library": ms or None, **extra}."""
    import torch
    turns = {"twin": graphed(twin), "kernel": graphed(kernel)}
    if library is not None:
        turns["library"] = graphed(library)
    turns.update({n: graphed(f) for n, f in extra.items()})
    names = list(turns)
    order = names + names[::-1]
    ms = {n: [] for n in names}
    for k in range(TURNS * len(names)):
        name = order[k % len(order)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        turns[name]()
        b.record()
        torch.cuda.synchronize()
        ms[name].append(a.elapsed_time(b) / REPEAT)
    out = {n: statistics.median(v) for n, v in ms.items()}
    out.setdefault("library", None)
    return out


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for these bytes and f32
    operations at the H100's published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_record(t, err, nbytes, flops):
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["twin"],
                bound_ms=b_ms, bound_by=b_by, library_ms=t["library"],
                bytes=nbytes)


def window_error(pools, bptr, bres, fields=("sdf", "sumsq", "weight",
                                             "rgbp")):
    """Largest |difference| per field between two pools over the window's
    voxels (each entry's own 512 or 64)."""
    from mrhash_tpu_torch.core.state import window_voxels
    vidx, valid = window_voxels(bptr, bres)
    vidx = vidx[valid]
    return {f: float((getattr(pools[0], f).view(-1)[vidx].double()
                      - getattr(pools[1], f).view(-1)[vidx].double())
                     .abs().max()) for f in fields}


def window_count(pool, src, bptr, bres, field="weight"):
    """(updated, weighted): window voxels whose weight `pool` raised over
    `src`, and window voxels with weight in `pool`."""
    from mrhash_tpu_torch.core.state import window_voxels
    vidx, valid = window_voxels(bptr, bres)
    vidx = vidx[valid]
    w = getattr(pool, field).view(-1)[vidx]
    return (int((w > getattr(src, field).view(-1)[vidx]).sum()),
            int((w > 0).sum()))


def clone_pools(src, n=2):
    from mrhash_tpu_torch.core.state import VoxelPool
    return [VoxelPool(**{f: getattr(src, f).clone() for f in
                         VoxelPool.FIELDS}) for _ in range(n)]


def rgbd_window(gw, depths, i):
    """Allocate frame i of the orbit on the wrapper's map and return its
    camera, depth and window (slots, bpos, bptr, bres)."""
    import torch

    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import integrate as I
    cfg = gw.cfg
    rot, trans, _ = orbit_pose(i)
    cam = C.with_pose(gw.camera, rot, trans)
    depth = torch.from_numpy(depths[i % ORBIT]).to("cuda")
    pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth))
    keys, valid = AB.alloc_candidates_depth(
        cfg, cam, pc_depth, cfg.dda_steps(cfg.max_integration_distance),
        frame=gw.state.frame)
    I.alloc_blocks(cfg, gw.state.table, keys, valid, gw.state.frame)
    return cam, pc_depth.contiguous(), I.compact_active(cfg, gw.state.table,
                                                        cam)


def compare_kernels(depths, rgb):
    """Drive the slice 40 frames, then hold K1 and K2 against their twins
    on the window, frame and z-buffer of frame 41."""
    import torch

    from mrhash_tpu_torch.core.state import pack_rgb
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import coords as X
    from mrhash_tpu_torch.ops import fused_integrate as FI
    from mrhash_tpu_torch.ops import integrate as I
    from mrhash_tpu_torch.ops import sample_image as SI

    dev = torch.device("cuda")
    gw = make_wrapper("cuda")
    for i in range(ORBIT):
        feed(gw, i, depths, rgb)
    cfg = gw.cfg
    cam, pc_depth, (_, bpos, bptr, bres) = rgbd_window(gw, depths, ORBIT)
    A = bpos.shape[0]
    assert int(bres.sum()) == 0
    rgbp = pack_rgb(torch.from_numpy(rgb).to(dev)).contiguous()
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale,
                              cfg.max_integration_distance,
                              cfg.integration_weight_sample,
                              cfg.integration_weight_max)
    src = gw.state.pool
    pools = clone_pools(src)
    del gw
    fk = FI.fused_integrate_rows(pools[0], pc_depth, rgbp, cam_vec, bpos,
                                 bptr, bres)
    ft = FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp, cam_vec, bpos,
                                     bptr, bres)
    torch.cuda.synchronize()
    err = window_error(pools, bptr, bres)
    updated, _ = window_count(pools[0], src, bptr, bres)
    log(f"compare K1: window {A} blocks, {updated} voxels updated, "
        f"max |diff| {err}")
    assert err["weight"] == 0 and err["rgbp"] == 0, err
    assert err["sdf"] <= TOL["sdf"] and err["sumsq"] <= TOL["sumsq"], err
    assert torch.equal(fk[:, :3], ft[:, :3]), "K1 GC flags differ"
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
    assert updated > 100000, "K1 integrated almost nothing"
    entries = torch.arange(A, device=dev)
    flags = torch.empty((A, 4), device=dev)
    t = time_in_turns(
        lambda: FI._launch(pools[0], pc_depth, rgbp, cam_vec, bpos, bptr,
                           entries, 0, flags),
        lambda: FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp,
                                            cam_vec, bpos, bptr, bres))
    # sdf, sumsq and weight (12 B) read per voxel; rgbp (4 B) read and
    # 16 B written per updated voxel; the frame (depth + rgb), bpos, ptr,
    # the entry list and the cam vector read once; flags f32[A,4] written.
    # ~60 f32 operations per voxel (projection, fuse, colour blend, Welford)
    nbytes = (A * 512 * 12 + updated * 20 + ROWS * COLS * 8
              + A * (12 + 4 + 8) + 128 + A * 16)
    k1 = kernel_record(t, max(err.values()), nbytes, A * 512 * 60)
    k1["window_blocks"] = A
    del pools, src

    # K2 at the starvation readback's shapes: the frame-41 window's voxels
    # and their z-buffer (ops/integrate.py::starve_mask)
    pi, valid = X.block_voxel_grid(bpos, bres)
    pcam = C.world_to_cam(cam, X.virtual_voxel_pos_to_world(
        cfg.virtual_voxel_size, pi))
    row, col, ok = C.project_point(cam, pcam)
    z = C.get_depth(cam, pcam)
    ok = (ok & valid & (z >= cam.min_depth)).contiguous()
    HW = ROWS * COLS
    pix = torch.where(ok, row.long() * COLS + col, HW).reshape(-1)
    zbuf = torch.full((HW + 1,), I.FAR, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, pix, torch.where(ok, z, I.FAR).reshape(-1),
                         "amin")
    zimg = torch.zeros((2, ROWS, COLS), dtype=torch.float32, device=dev)
    zimg[0] = zbuf[:HW].reshape(ROWS, COLS)
    zimg[1] = pc_depth
    row, col = row.contiguous(), col.contiguous()
    sk = SI.sample_image(zimg, row, col, ok)
    st = SI.sample_image_ref(zimg, row, col, ok)
    torch.cuda.synchronize()
    k2_err = float((sk - st).abs().max())
    n_front = int((ok & (z == sk[:, 0, :])).sum())
    log(f"compare K2: {int(ok.sum())} in-image lanes, {n_front} front-most, "
        f"max |diff| {k2_err}")
    assert torch.equal(sk, st), "K2 differs from its twin"
    assert n_front > 100000
    # one PyTorch call that does K2's gather: torch.take over the same flat
    # index into both channels (the index is built outside the timing, and
    # the call does not apply the mask)
    flat = torch.where(ok, row.long() * COLS + col, 0)[:, None, :]
    idx = flat + torch.arange(2, device=dev)[None, :, None] * HW
    assert torch.equal(torch.where(ok[:, None, :], torch.take(zimg, idx), 0.0),
                       sk)
    t = time_in_turns(
        lambda: SI._launch(zimg, row, col, ok),
        lambda: SI.sample_image_ref(zimg, row, col, ok),
        lambda: torch.take(zimg, idx))
    # row, col (4 B each) and ok (1 B) read and 8 B written per lane; the
    # two-channel image read once; ~2 integer operations per lane
    lanes = A * 512
    k2 = kernel_record(t, k2_err, lanes * 17 + 2 * HW * 4, lanes * 2)
    k6 = compare_sample5(pc_depth, rgb, row, col, ok, sk[:, 1])
    return k1, k2, k6


def time_kernel_and_twin(kernel, twin):
    """{"kernel": ms, "twin": ms, "library": None}: the median ms per call
    of `kernel` replayed from a CUDA graph (as time_in_turns) and of
    `twin` run eagerly (host dispatch and host reads included: a twin
    that reads the host cannot be captured), in turns, REPEAT calls a
    turn timed with CUDA events, after one warm-up call of each."""
    import torch
    turns = {"kernel": graphed(kernel), "twin": twin}
    twin()
    ms = {"kernel": [], "twin": []}
    for k in range(2 * TURNS):
        name = ("kernel", "twin", "twin", "kernel")[k % 4]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if name == "kernel":
            turns[name]()
        else:
            for _ in range(REPEAT):
                twin()
        b.record()
        torch.cuda.synchronize()
        ms[name].append(a.elapsed_time(b) / REPEAT)
    return dict(kernel=statistics.median(ms["kernel"]),
                twin=statistics.median(ms["twin"]), library=None)


def clone_table(t):
    import torch

    from mrhash_tpu_torch.ops import hashtable as H
    return H.HashTable(**{k: v.clone() if torch.is_tensor(v) else v
                          for k, v in vars(t).items()})


def alloc_round_twins(cfg, tk, tr, keys, valid, rk, rv, scratch, frame):
    """One allocation, kernels against twins: K7's candidates (where
    valid) and scratch, K8's served keys, K9's table and per-key info,
    all equal.  Returns (ukeys, stats, n served, n pending)."""
    import torch

    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import hashtable as H
    dev = keys.device
    U = cfg.max_alloc_per_frame
    assert torch.equal(valid, rv) and torch.equal(keys[valid], rk[rv])
    ref = AB.dedup_scratch(cfg, frame, dev)
    AB.dedup_scatter(rk, rv, ref)
    assert torch.equal(scratch.cells, ref.cells), "K7 scratch"
    uk, stats = AB.compact(keys, scratch, U)
    ur, _ = AB.dedup_compact(rk, ref, U)
    n = ur.shape[0]
    assert int(stats[0]) == n and torch.equal(uk[:n], ur), "K8"
    info = AB.insert(tk, uk, 0, stats.clone())
    iref = H.insert(tr, ur, torch.zeros(n, dtype=torch.int32, device=dev))
    for k in ("slot", "ptr", "res", "was_new", "present"):
        assert torch.equal(info[k][:n], iref[k]), f"K9 {k}"
    for f in ("pos", "ptr", "res", "fp", "heap_high", "heap_low"):
        assert torch.equal(getattr(tk, f), getattr(tr, f)), f"K9 {f}"
    assert (tk.high_count, tk.low_count) == (tr.high_count, tr.low_count)
    return uk, stats, n, n - int(iref["present"].sum()) + int(
        iref["was_new"].sum())


def compare_alloc_kernels(depths, rgb, clouds):
    """K7, K8 and K9 (allocation, csrc/alloc_blocks.cu) against their
    twins, bit for bit, on frame 40 of the multi-res orbit (phase 7's
    settings, GeoWrapper's 4 x 4 tile path; the map after 40 frames) and
    on scan 20 of the LiDAR slice,
    then each kernel's time (CUDA-graph replays) beside its bound and its
    twin's (eager: the twins read the host).  K9 is timed on a copy of
    the map after the round, where every key is found (the claims of the
    frame's pending keys are held to the twin above, not timed).  Returns
    {name: record}."""
    import torch

    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import hashtable as H

    dev = torch.device("cuda")
    out = {}
    gw = make_wrapper("cuda", multires=True)
    for i in range(ORBIT):
        feed(gw, i, depths, rgb)
    cfg, frame = gw.cfg, gw.state.frame
    tk, tr = clone_table(gw.state.table), clone_table(gw.state.table)
    rot, trans, _ = orbit_pose(ORBIT)
    cam = C.with_pose(gw.camera, rot, trans)
    del gw
    torch.cuda.empty_cache()
    pc = C.get_depth(cam, C.compute_cloud(cam, torch.from_numpy(
        depths[ORBIT % len(depths)]).to(dev)))
    steps = cfg.dda_steps(cfg.max_integration_distance)
    U, S = cfg.max_alloc_per_frame, (cfg.max_alloc_per_frame
                                     * cfg.dedup_scratch_factor)
    scratch = AB.dedup_scratch(cfg, frame, dev)
    keys, valid = AB.alloc_candidates_depth(cfg, cam, pc, steps, frame=frame,
                                            scratch=scratch)
    rk, rv = AB.alloc_candidates_depth_ref(cfg, cam, pc, steps, frame=frame)
    uk, stats, n, pending = alloc_round_twins(cfg, tk, tr, keys, valid, rk,
                                              rv, scratch, frame)
    M, live = keys.shape[0], int(valid.sum())
    R = M // steps
    log(f"compare K7/K8/K9: orbit frame {ORBIT}: {R} rays x {steps} steps, "
        f"{live} live candidates, {n} keys served, {pending} pending; "
        f"kernels equal their twins")
    cells = AB.dedup_scratch(cfg, frame, dev)

    def twin7():
        k, v = AB.alloc_candidates_depth_ref(cfg, cam, pc, steps,
                                             frame=frame)
        AB.dedup_scatter(k, v, AB.dedup_scratch(cfg, frame, dev))

    t = time_kernel_and_twin(lambda: AB.alloc_candidates_depth(
        cfg, cam, pc, steps, frame=frame, scratch=cells), twin7)
    # the frame read (the tile path reads every pixel), key (12 B) and
    # liveness (1 B) written per candidate, each scratch cell touched; ~80
    # f32 operations a ray to set it up (and 2 a pixel for the tile's
    # band), ~25 a step
    out["alloc_walk"] = dict(kernel_record(
        t, 0, ROWS * COLS * 4 + M * 13 + S * 4,
        R * (80 + 25 * steps) + ROWS * COLS * 2),
        rays=R, candidates=M, live=live, tile=cfg.alloc_tile)
    t = time_kernel_and_twin(lambda: AB.compact(keys, scratch, U),
                             lambda: AB.dedup_compact(rk, scratch, U))
    # the scratch read, each served key gathered and written
    out["alloc_compact"] = dict(kernel_record(t, 0, S * 4 + n * 24, S),
                                cells=S, served=n)
    tg, tt = clone_table(tk), clone_table(tr)
    stats_g, ur = stats.clone(), uk[:n].clone()
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    t = time_kernel_and_twin(lambda: AB.insert_launch(tg, uk, 0, stats_g),
                             lambda: H.insert(tt, ur, zero))
    # per key: the key, 17 fingerprints and a key compare read, 18 B of
    # info written; ~60 integer operations (two hashes, the probe)
    out["alloc_insert"] = dict(kernel_record(
        t, 0, n * (12 + 17 * 4 + 12 + 18), n * 60), keys=n, pending=pending)
    del keys, valid, rk, rv, uk, tk, tr, tg, tt
    torch.cuda.empty_cache()

    # the LiDAR slice's scan L_COMPARE_AT
    gw = make_lidar_wrapper("cuda", clouds[0], multires=True)
    for i in range(L_COMPARE_AT):
        feed_lidar(gw, i, clouds)
    cfg, frame = gw.cfg, gw.state.frame
    tk, tr = clone_table(gw.state.table), clone_table(gw.state.table)
    cam = C.with_pose(gw.camera, gw.curr_rot, lidar_pose(L_COMPARE_AT))
    del gw
    torch.cuda.empty_cache()
    pts = torch.from_numpy(clouds[L_COMPARE_AT]).to(dev)
    steps = cfg.dda_steps(cfg.max_integration_distance)
    S = cfg.max_alloc_per_frame * cfg.dedup_scratch_factor
    scratch = AB.dedup_scratch(cfg, frame, dev)
    keys, valid = AB.alloc_candidates_points(cfg, cam, pts, steps, None,
                                             scratch)
    rk, rv = AB.alloc_candidates_points_ref(cfg, cam, pts, steps)
    _, _, n, pending = alloc_round_twins(cfg, tk, tr, keys, valid, rk, rv,
                                         scratch, frame)
    M, N = keys.shape[0], pts.shape[0]
    log(f"compare K7/K8/K9: LiDAR scan {L_COMPARE_AT}: {N} points x {steps} "
        f"steps, {int(valid.sum())} live candidates, {n} keys served, "
        f"{pending} pending; kernels equal their twins")
    cells = AB.dedup_scratch(cfg, frame, dev)

    def twin7p():
        k, v = AB.alloc_candidates_points_ref(cfg, cam, pts, steps)
        AB.dedup_scatter(k, v, AB.dedup_scratch(cfg, frame, dev))

    t = time_kernel_and_twin(lambda: AB.alloc_candidates_points(
        cfg, cam, pts, steps, None, cells), twin7p)
    out["alloc_walk_points"] = dict(kernel_record(
        t, 0, N * 12 + M * 13 + S * 4, N * (60 + 25 * steps)),
        rays=N, candidates=M)
    return out


def clone_state(st):
    from mrhash_tpu_torch.core.state import MapState, VoxelPool
    return MapState(table=clone_table(st.table),
                    pool=VoxelPool(**{f: getattr(st.pool, f).clone()
                                      for f in VoxelPool.FIELDS}),
                    frame=st.frame)


def restore_state(dst, src):
    """Copy src's table and pool into dst's tensors (in place)."""
    from mrhash_tpu_torch.core.state import VoxelPool
    for f in ("pos", "ptr", "res", "fp", "heap_high", "heap_low"):
        getattr(dst.table, f).copy_(getattr(src.table, f))
    dst.table.high_count = src.table.high_count
    dst.table.low_count = src.table.low_count
    for f in VoxelPool.FIELDS:
        getattr(dst.pool, f).copy_(getattr(src.pool, f))


def compare_coarsen_kernels(clouds):
    """K10, K11 and K12 (coarsening, csrc/coarsen_blocks.cu) against their
    twin (coarsen_blocks.coarsen_by_variance_ref) on a step like the drive's:
    the LiDAR slice fused at one resolution for L_COMPARE_AT scans, its
    window of every block, the decisions under MR_THRESHOLD, C_SERVED
    served a step (the drive coarsens ~25-30 fresh blocks a scan) after
    one step that filled the low heap (so no split).  The table, heaps,
    served entries, weight and colour equal, sdf and sumsq within TOL.
    Then each kernel's time, a launch timed alone with CUDA events behind
    a spin kernel (so the events time the device, not the host's enqueue)
    after the map is restored, beside its bound, and the whole step on
    the kernels (its two host reads included) beside the twin's, both
    eager.  Returns {name: record}."""
    import dataclasses

    import torch

    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import coarsen_blocks as CB
    from mrhash_tpu_torch.ops import integrate as I

    gw = make_lidar_wrapper("cuda", clouds[0])
    for i in range(L_COMPARE_AT):
        feed_lidar(gw, i, clouds)
    cfg = dataclasses.replace(gw.cfg, sdf_var_threshold=MR_THRESHOLD,
                              max_coarsen_per_frame=C_SERVED)
    base = clone_state(gw.state)
    del gw
    torch.cuda.empty_cache()
    slots, bpos, bptr, bres = I.compact_window(cfg, base.table)[0]
    decide = I.coarsen_decide(cfg, base.pool, bptr, bres)
    first = CB.coarsen(cfg, base.table, base.pool, slots, bpos, decide)[2]
    decide = decide & ~first
    n_dec, a = int(decide.sum()), slots.shape[0]
    tk, tr = clone_state(base), clone_state(base)
    got = CB.coarsen(cfg, tk.table, tk.pool, slots, bpos, decide)
    ref = CB.coarsen_by_variance_ref(cfg, tr.table, tr.pool, slots, bpos,
                                     decide)
    for g, r in zip(got, ref):
        assert torch.equal(g, r), "K10-K12 served entries"
    for f in ("pos", "ptr", "res", "fp", "heap_high", "heap_low"):
        assert torch.equal(getattr(tk.table, f), getattr(tr.table, f)), f
    assert (tk.table.high_count, tk.table.low_count) == (
        tr.table.high_count, tr.table.low_count)
    err = {}
    for f in ("weight", "rgbp", "sdf", "sumsq"):
        x, y = getattr(tk.pool, f), getattr(tr.pool, f)
        err[f] = float((x - y).abs().max())
        assert err[f] <= TOL.get(f, 0), (f, err[f])
    n = int(got[2].sum())
    log(f"compare K10/K11/K12: LiDAR scan {L_COMPARE_AT} at one "
        f"resolution, window {a} blocks, {n_dec} decided, {n} served; "
        f"kernels equal their twin (sdf {err['sdf']:.3g}, sumsq "
        f"{err['sumsq']:.3g} apart)")
    del tr
    work = tk
    ms = {k: [] for k in ("select", "merge", "scatter", "step", "twin")}

    def timed(fn, spin=True):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin:                # the device busy while the host enqueues
            torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        out = fn()
        e1.record()
        return out, (e0, e1)

    for _ in range(TURNS):
        restore_state(work, base)
        (freed, keys, fptr, fres, stats), t10 = timed(
            lambda: CB.select(cfg, work.table, slots, bpos, decide))
        m, work.table.high_count, work.table.low_count, _ = \
            stats.tolist()
        stage, t11 = timed(lambda: CB.merge(cfg, work.pool, fptr, fres, m))
        info = AB.insert(work.table, keys[:m], 1)
        _, t12 = timed(lambda: CB.scatter(work.pool, stage, info["was_new"],
                                          info["ptr"]))
        torch.cuda.synchronize()
        for k, (e0, e1) in zip(("select", "merge", "scatter"),
                               (t10, t11, t12)):
            ms[k].append(e0.elapsed_time(e1))
        for k, fn in (("step", CB.coarsen),
                      ("twin", CB.coarsen_by_variance_ref)):
            restore_state(work, base)
            torch.cuda.synchronize()
            _, (e0, e1) = timed(lambda: fn(cfg, work.table, work.pool,
                                           slots, bpos, decide), spin=False)
            torch.cuda.synchronize()
            ms[k].append(e0.elapsed_time(e1))
    med = {k: statistics.median(v) for k, v in ms.items()}
    # bytes, each read or written once: K10 the decisions and the freed
    # mask (1 B an entry), per served entry its slot (8 B), key (12 B),
    # ptr and res (8 B) read, the table's pos, ptr, res, fp (24 B), its
    # key row, ptr and res (20 B) and its heap id (4 B) written; K11 per
    # served block 512 voxels of 16 B read and cleared, 64 staged; K12 64
    # voxels of 16 B read and written, the block's flag and ptr
    nb = dict(select=2 * a + n * (8 + 12 + 8 + 24 + 20 + 4),
              merge=n * (2 * 512 * 16 + 64 * 16),
              scatter=n * (2 * 64 * 16 + 5))
    out = {}
    for k, name in (("select", "coarsen_select"), ("merge", "coarsen_merge"),
                    ("scatter", "coarsen_scatter")):
        out[name] = dict(kernel_record(
            dict(kernel=med[k], twin=med["twin"], library=None),
            err["sdf"] if k != "select" else 0, nb[k], 0),
            window=a, served=n, step_ms=med["step"])
    log(f"compare K10/K11/K12: {med['select']:.4f} / {med['merge']:.4f} / "
        f"{med['scatter']:.4f} ms alone; the step on the kernels "
        f"{med['step']:.4f} ms with its two host reads, the twin "
        f"{med['twin']:.4f} ms (eager, its host reads included)")
    return out


def compare_sample5(depth, rgb, row, col, ok, k2_depth):
    """K6 (B6's 5-channel sampler, which no path calls) on the starvation
    readback's inputs: the frame as bf16 (depth hi, depth lo, r, g, b),
    each block's 8- and 128-aligned minimum pixel as its patch origin and
    the lanes' offsets from it (-1 where K2's lane is masked).  K6 equal to
    its twin exactly; hi + lo within 2^-16 relative of K2's depth and r, g,
    b equal to the frame's on in-patch lanes."""
    import torch

    from mrhash_tpu_torch.ops import sample_image as SI

    dev = depth.device
    H, W = depth.shape
    d_hi = depth.to(torch.bfloat16)
    d_lo = (depth - d_hi.to(torch.float32)).to(torch.bfloat16)
    rgb_t = torch.from_numpy(rgb).to(dev)
    img5 = torch.cat([d_hi[None], d_lo[None],
                      rgb_t.permute(2, 0, 1).to(torch.bfloat16)]).contiguous()
    A = row.shape[0]
    A8 = -(-A // 8) * 8
    big = torch.iinfo(torch.int32).max
    r0 = torch.where(ok, row, big).amin(dim=1)
    c0 = torch.where(ok, col, big).amin(dim=1)
    r0 = torch.where(r0 == big, 0, r0) // 8 * 8
    c0 = torch.where(c0 == big, 0, c0) // 128 * 128
    lr = torch.where(ok, row - r0[:, None], -1)
    lc = torch.where(ok, col - c0[:, None], -1)

    def pad(t, fill):
        out = torch.full((A8,) + tuple(t.shape[1:]), fill, dtype=torch.int32,
                         device=dev)
        out[:A] = t
        return out

    r0, c0, lr, lc = pad(r0, 0), pad(c0, 0), pad(lr, -1), pad(lc, -1)
    k = SI.sample_image5(img5, r0, c0, lr, lc)
    t_ = SI.sample_image5_ref(img5, r0, c0, lr, lc)
    torch.cuda.synchronize()
    err = float((k - t_).abs().max())
    assert torch.equal(k, t_), "K6 differs from its twin"
    own = ((r0 <= H - 32) & (c0 <= W - 256))[:A, None]
    inp = ok & own & (lr[:A] < 32) & (lc[:A] < 256)
    inp = inp & (k2_depth > 0)
    dep = k[:A, 0] + k[:A, 1]
    rel = float(((dep - k2_depth).abs() / k2_depth)[inp].max())
    rgb_lane = rgb_t[row.clamp(0, H - 1), col.clamp(0, W - 1)]
    rgb_ok = bool((k[:A, 2:5].permute(0, 2, 1) == rgb_lane.to(torch.float32)
                   )[inp].all())
    n_in = int(inp.sum())
    log(f"compare K6: {A8} blocks, {n_in} in-patch lanes of "
        f"{int(ok.sum())}, max |diff| {err}; hi + lo vs K2's depth max rel "
        f"{rel:.3e}; rgb equal {rgb_ok}")
    assert n_in > 100000 and rel <= 2.0 ** -16 and rgb_ok, (n_in, rel)
    # one PyTorch call that does K6's gather: torch.take over the same flat
    # index into the five channels (built outside the timing; the call
    # neither masks nor widens to f32)
    in_rng = (lr >= 0) & (lr < 32) & (lc >= 0) & (lc < 256)
    flat = torch.where(in_rng, (r0.clamp(0, H - 32)[:, None] + lr) * W
                       + c0.clamp(0, W - 256)[:, None] + lc, 0).long()
    idx = flat[:, None, :] + torch.arange(5, device=dev)[None, :, None] * H * W
    t = time_in_turns(lambda: SI._launch5(img5, r0, c0, lr, lc),
                      lambda: SI.sample_image5_ref(img5, r0, c0, lr, lc),
                      lambda: torch.take(img5, idx))
    # lr, lc (8 B) read and 8 channels (32 B) written per lane; r0, c0 per
    # block; the bf16 image read once; ~10 integer operations per lane
    lanes = A8 * 512
    rec = kernel_record(t, err, lanes * 40 + A8 * 8 + 5 * H * W * 2,
                        lanes * 10)
    rec.update(blocks=A8, in_patch=n_in)
    return rec


def compare_k1_res1(depths, rgb):
    """Drive the multi-res RGB-D path 40 frames, then hold K1 against its
    twin on the mixed window of frame 41 (both kernels), and time K1's
    res-1 path over the window's res-1 entries against the twin over the
    same entries."""
    import torch

    from mrhash_tpu_torch.core.state import pack_rgb
    from mrhash_tpu_torch.ops import fused_integrate as FI

    dev = torch.device("cuda")
    gw = make_wrapper("cuda", multires=True)
    for i in range(ORBIT):
        feed(gw, i, depths, rgb)
    cfg = gw.cfg
    cam, pc_depth, (_, bpos, bptr, bres) = rgbd_window(gw, depths, ORBIT)
    A, n1 = bpos.shape[0], int(bres.sum())
    rgbp = pack_rgb(torch.from_numpy(rgb).to(dev)).contiguous()
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale,
                              cfg.max_integration_distance,
                              cfg.integration_weight_sample,
                              cfg.integration_weight_max)
    src = gw.state.pool
    pools = clone_pools(src)
    del gw
    fk = FI.fused_integrate_rows(pools[0], pc_depth, rgbp, cam_vec, bpos,
                                 bptr, bres)
    ft = FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp, cam_vec, bpos,
                                     bptr, bres)
    torch.cuda.synchronize()
    err = window_error(pools, bptr, bres)
    e1 = torch.nonzero(bres == 1).flatten()
    sub = tuple(t[e1].contiguous() for t in (bpos, bptr, bres))
    updated, _ = window_count(pools[0], src, bptr, bres)
    upd1, _ = window_count(pools[0], src, *sub[1:])
    log(f"compare K1 multi-res: window {A} blocks, {n1} at res 1; {updated} "
        f"voxels updated, {upd1} of them at res 1; max |diff| {err}")
    assert err["weight"] == 0 and err["rgbp"] == 0, err
    assert err["sdf"] <= TOL["sdf"] and err["sumsq"] <= TOL["sumsq"], err
    assert torch.equal(fk[:, :3], ft[:, :3]), "K1 flags differ"
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
    assert n1 > 1000 and upd1 > 10000, "the window barely coarsened"
    flags = torch.empty((A, 4), device=dev)
    t = time_in_turns(
        lambda: FI._launch(pools[0], pc_depth, rgbp, cam_vec, bpos, bptr, e1,
                           1, flags),
        lambda: FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp,
                                            cam_vec, *sub))
    # as K1 at res 0, over the res-1 entries' 64-voxel windows
    nbytes = (n1 * 64 * 12 + upd1 * 20 + ROWS * COLS * 8
              + n1 * (12 + 4 + 8) + 128 + n1 * 16)
    rec = kernel_record(t, max(err.values()), nbytes, n1 * 64 * 60)
    rec.update(window_blocks=A, res1_blocks=n1)
    return rec


def host_map(st, cfg):
    """The map's blocks in the host layout (a res-1 block's window at lanes
    [0, 64)), sorted by key: (pos, res, {field: [S,512]})."""
    from mrhash_tpu_torch.core.streaming import ChunkGrid, Streamer
    grid = ChunkGrid(cfg.voxel_extents)
    Streamer(cfg, cfg.num_blocks).snapshot_into(st, grid)
    g = host_grid(grid.chunks)
    return g["pos"], g["res"], dict(sdf=g["sdf"], sumsq=g["ssq"],
                                    weight=g["w"], rgbp=g["rgb"])


SMALL_CAM = (80.0, 80.0, 127.5, 31.5, 64, 256, 0.01, 5.0)


def small_inputs(multires=False):
    """Phase 3's small scene: 4 frames of a 64x256 relief with starvation
    every 2 frames + GC (multires: coarsening from frame 1 on, the
    threshold of tests/test_torch_multires.py).  Returns (cfg, [(depth,
    translation)], rgb)."""
    import numpy as np

    from mrhash_tpu_torch.core.state import MapConfig

    rows, cols = SMALL_CAM[4], SMALL_CAM[5]
    cfg = MapConfig(virtual_voxel_size=0.02, sdf_truncation=0.06,
                    max_integration_distance=5.0,
                    n_frames_invalidate_voxels=2, num_blocks=1 << 11,
                    max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
                    alloc_tile=4, sdf_var_threshold=10.0 if multires else 0.0)
    rng = np.random.default_rng(0)
    r = np.arange(rows, dtype=np.float32)[:, None]
    c = np.arange(cols, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
    frames = [((base + rng.normal(0, 0.01, base.shape)).astype(np.float32),
               np.array([0.03 * i, 0.01 * i, 0.0], np.float32))
              for i in range(4)]
    return cfg, frames, rgb


def small_scene(dev, multires=False):
    """Phase 3's small scene (small_inputs) on `dev` through
    core/pipeline.  Returns (cfg, state, the first frame's camera)."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import make_state
    from mrhash_tpu_torch.ops import camera as C

    cfg, frames, rgb = small_inputs(multires)
    st = make_state(cfg.num_blocks, device=dev)
    cam0 = C.make_camera(*SMALL_CAM, device=dev)
    for d, t in frames:
        cam = C.with_pose(cam0, np.eye(3, dtype=np.float32), t)
        st, _ = pipeline.integrate_rgbd(
            cfg, st, cam, torch.from_numpy(d).to(dev),
            torch.from_numpy(rgb).to(dev))
    return cfg, st, cam0


def compare_small_scene(multires=False):
    """The whole slice on the card against the slice on the CPU (where the
    tests hold it against the JAX reference): 4 frames of a 64x256 scene
    with starvation + GC (multires: coarsening from frame 1 on, the
    threshold of tests/test_torch_multires.py); same key set and
    resolutions, weight and rgbp exact, sdf within 2e-5, sumsq within
    5e-4."""
    import numpy as np

    maps = {}
    for dev in ("cpu", "cuda"):
        cfg, st, _ = small_scene(dev, multires)
        maps[dev] = host_map(st, cfg)
    (pc, rc, mc), (pg, rg, mg) = maps["cpu"], maps["cuda"]
    assert np.array_equal(pc, pg), "block key sets differ"
    assert np.array_equal(rc, rg), "block resolutions differ"
    assert np.array_equal(mc["weight"], mg["weight"])
    upd = mc["weight"] > 0
    assert int(upd.sum()) > 10000
    assert np.array_equal(mc["rgbp"][upd], mg["rgbp"][upd])
    err = {f: float(np.abs(mc[f][upd] - mg[f][upd]).max())
           for f in ("sdf", "sumsq")}
    assert all(err[f] <= TOL[f] for f in err), err
    n1 = int(rc.sum())
    assert (n1 > 100) == multires, n1
    log(f"compare {'multi-res ' if multires else ''}slice cuda vs cpu "
        f"(64x256, 4 frames): {len(pc)} blocks, {n1} at res 1, "
        f"max |diff| {err}")


# ---------------------------------------------------------------------------
# LiDAR scene: tools/bench_extra.py's synthetic scan, in numpy
# ---------------------------------------------------------------------------

def lidar_cloud(org, rng, rows=L_ROWS, cols=L_COLS, wall=L_WALL,
                az_offset=0.0):
    """tools/bench_extra.py::synthetic_lidar_cloud in the z-up convention
    of the spherical model: beams at elevations -0.4..0.25 rad and `cols`
    azimuths, seen from `org`, hit a ground plane at z = L_GROUND and a
    cylinder wall of radius `wall` about the world's z axis; 1 cm range
    noise.  Returns f32[rows*cols, 3] in the sensor frame (identity
    rotation); a beam with no hit is the zero point."""
    import numpy as np
    el = np.linspace(-0.4, 0.25, rows)[:, None]
    az = (np.linspace(-np.pi, np.pi, cols, endpoint=False)
          + az_offset)[None, :]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az) + 0 * el,
                  np.sin(el) + 0 * az], axis=-1)
    org = np.asarray(org, np.float64)
    tz = np.where(d[..., 2] < -1e-4, (L_GROUND - org[2]) / d[..., 2],
                  np.inf)
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2 * (org[0] * dx + org[1] * dy)
    c = org[0] ** 2 + org[1] ** 2 - wall ** 2
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    tc = np.where(a > 1e-9, (-b + np.sqrt(disc)) / (2 * np.maximum(a, 1e-9)),
                  np.inf)
    t = np.minimum(tz, np.where(tc > 0, tc, np.inf))
    t = np.where(np.isfinite(t), t, 0.0)
    t = t + rng.normal(0, 0.01, t.shape) * (t > 0)
    return (d * t[..., None]).reshape(-1, 3).astype(np.float32)


def lidar_pose(i):
    """Forward 0.5 m per scan (tools/bench_extra.py::bench_lidar)."""
    import numpy as np
    return np.array([0.5 * i, 0.0, 0.0], np.float32)


def make_lidar_wrapper(device, cloud0, multires=False, n_starve=0,
                       projective=True):
    """The port's GeoWrapper at configurations/newer_college.cfg's settings
    with tools/bench_extra.py's LiDAR capacities (2^18 blocks, 2^16
    buckets, window cap 2^17, 2^13 allocations per scan; multires:
    bench_lidar(multires=True)'s sdf_var_threshold 1.0 and 512 coarsenings
    per scan; phase 11: starvation every n_starve scans, and with
    projective=False the point-centric update); the spherical intrinsics
    are fit to the first cloud, as the ply runner does."""
    import dataclasses

    from mrhash_tpu_torch.apps.utils.camera import (
        CameraModel, calculate_spherical_intrinsics)
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(sdf_truncation=0.40, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.20,
                    n_frames_invalidate_voxels=n_starve,
                    voxel_extents_scale=1,
                    marching_cubes_threshold=1.5, min_weight_threshold=5,
                    min_depth=0.2, max_depth=100.0,
                    sdf_var_threshold=MR_THRESHOLD if multires else 0.0,
                    projective_sdf=projective,
                    num_blocks=1 << 18, num_buckets=1 << 16,
                    max_active_blocks=1 << 17, max_alloc_per_frame=1 << 13,
                    profiling=False, device=device)
    if multires:
        gw.cfg = dataclasses.replace(gw.cfg, max_coarsen_per_frame=1 << 9)
    K, _, _, _ = calculate_spherical_intrinsics(cloud0[
        (cloud0 != 0).any(axis=1)], L_ROWS, L_COLS)
    gw.setCamera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], L_ROWS, L_COLS, 0.2,
                 100.0, CameraModel.Spherical)
    return gw


def feed_lidar(gw, i, clouds, normals=False):
    """Scan i through setPointCloud + compute; normals=True runs the
    MADtree (what the point-centric update reads)."""
    gw.setCurrPose(lidar_pose(i), [0.0, 0.0, 0.0, 1.0])
    gw.setPointCloud(clouds[i], normals)
    gw.compute()


def k3_bytes(n, nvox, weighted, updated):
    """K3's bytes over n entries of nvox voxels: pix, r_vox, sdf and weight
    (16 B) read per voxel of the entries' windows; sumsq (4 B) read per
    weighted voxel and 12 B written per updated voxel; the range image,
    ptr and the entry list read once; flags f32[n,4] written."""
    return (n * nvox * 16 + weighted * 4 + updated * 12
            + L_ROWS * L_COLS * 4 + n * (4 + 8 + 16))


def compare_lidar_kernel(clouds, multires=False):
    """Drive the LiDAR slice L_COMPARE_AT scans, then hold K3 against its
    twin on the next scan's window, range image and projection: sdf,
    sumsq, weight and the flags but the sumsq sum must be equal.  Times the
    res-0 path over the window's res-0 entries (one launch, n1 = 0), or
    with multires the res-1 path over its res-1 entries (n0 = 0, held
    against the twin there too), the whole mixed window in one launch, and
    an empty kernel over the res-1 path's grid, against the twin over the
    res-0 or res-1 entries."""
    from mrhash_tpu_torch.utils.profiler import COUNTS
    import torch

    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import cuda_lib
    from mrhash_tpu_torch.ops import fused_integrate_points as FIP
    from mrhash_tpu_torch.ops import integrate as I

    dev = torch.device("cuda")
    gw = make_lidar_wrapper("cuda", clouds[0], multires)
    for i in range(L_COMPARE_AT):
        feed_lidar(gw, i, clouds)
    cfg = gw.cfg
    cam = C.with_pose(gw.camera, gw.curr_rot, lidar_pose(L_COMPARE_AT))
    points = torch.from_numpy(clouds[L_COMPARE_AT]).to(dev)
    keys, valid = AB.alloc_candidates_points(
        cfg, cam, points, cfg.dda_steps(cfg.max_integration_distance))
    I.alloc_blocks(cfg, gw.state.table, keys, valid, gw.state.frame)
    _, bpos, bptr, bres = I.compact_active(cfg, gw.state.table)
    img, pix, r_vox, ptr, res, consts = I.points_window(cfg, cam, points,
                                                        bpos, bptr, bres)
    src = gw.state.pool
    pools = clone_pools(src)
    del gw
    c0, c1 = (COUNTS["fused_integrate_points_rows"],
              COUNTS["fused_integrate_points_rows_res1"])
    fk = FIP.fused_integrate_points_rows(pools[0], img, pix, r_vox, ptr, res,
                                         consts)
    ft = FIP.fused_integrate_points_rows_ref(pools[1], img, pix, r_vox, ptr,
                                             res, consts)
    torch.cuda.synchronize()
    err = window_error(pools, ptr, res, ("sdf", "sumsq", "weight"))
    A, n1 = ptr.shape[0], int(res.sum())
    assert (COUNTS["fused_integrate_points_rows"] - c0,
            COUNTS["fused_integrate_points_rows_res1"] - c1) == (
        int(A > n1), int(n1 > 0)), "K3: one launch for the window"
    kind = 1 if multires else 0
    e = torch.nonzero(res == kind).flatten()
    sub = tuple(t[e].contiguous() for t in (pix, r_vox, ptr, res))
    updated, _ = window_count(pools[0], src, ptr, res)
    upd_k, wgt_k = window_count(pools[0], src, *sub[2:])
    log(f"compare K3{' multi-res' if multires else ''}: window {A} blocks, "
        f"{n1} at res 1, {int((pix >= 0).sum())} in-image lanes, {updated} "
        f"voxels updated, {upd_k} of them at res {kind}; max |diff| {err}")
    assert all(v == 0 for v in err.values()), err
    assert torch.equal(fk[:, :3], ft[:, :3]), "K3 flags differ"
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
    assert upd_k > (2000 if multires else 50000), "K3 integrated too little"
    upd_0, wgt_0 = window_count(pools[0], src, ptr[res == 0], res[res == 0])
    n0_e = 0 if multires else e.numel()
    flags = torch.empty((A, FIP.N_FLAGS), device=dev)
    if multires:
        # the res-1 path alone (n0 = 0) on a fresh copy, against the twin
        # over the same entries
        solo = clone_pools(src, 1)[0]
        FIP._launch(solo, img, pix, r_vox, ptr, e, 0, consts, flags)
        torch.cuda.synchronize()
        err1 = window_error([solo, pools[1]], *sub[2:],
                            ("sdf", "sumsq", "weight"))
        assert all(v == 0 for v in err1.values()), err1
        assert torch.equal(flags[e, :3], ft[e, :3]), "K3 res-1 flags"
    # the twin's constants as a device tensor, so that its graph holds no
    # host-to-device copy
    c_dev = torch.tensor(consts, dtype=torch.float32, device=dev)
    extra = {}
    if multires:
        order = torch.argsort(res, stable=True)
        lib = cuda_lib.library()
        extra = dict(
            mixed=lambda: FIP._launch(pools[0], img, pix, r_vox, ptr, order,
                                      A - n1, consts, flags),
            floor=lambda: cuda_lib.check(
                lib.mrhash_fused_integrate_points_floor(
                    0, e.numel(), cuda_lib.stream_of(img)), "floor"))
    t = time_in_turns(
        lambda: FIP._launch(pools[0], img, pix, r_vox, ptr, e, n0_e, consts,
                            flags),
        lambda: FIP.fused_integrate_points_rows_ref(pools[1], img, *sub,
                                                    c_dev), **extra)
    # ~15 f32 operations per voxel
    n, nvox = e.numel(), (64 if multires else 512)
    nbytes = k3_bytes(n, nvox, wgt_k, upd_k)
    rec = kernel_record(t, max(err.values()), nbytes, n * nvox * 15)
    rec.update(window_blocks=A, res1_blocks=n1, updated=upd_k)
    if multires:
        mixed_bytes = nbytes + k3_bytes(A - n1, 512, wgt_0, upd_0) - (
            L_ROWS * L_COLS * 4)
        rec.update(mixed_ms=t["mixed"], floor_ms=t["floor"],
                   mixed_bound_ms=bound(mixed_bytes, (
                       (A - n1) * 512 + n1 * 64) * 15)[0])
    return rec


def drive_window(cfg, cam, points, n=5000):
    """A drive-sized window around a scan: the blocks of its returns in the
    world and their 3^3 neighbours, the first n in a shuffled order, every
    other one at res 1.  Returns (bpos i32[A,3], bres i32[A]) on the
    scan's device."""
    import torch
    dev = points.device
    side = 8 * cfg.virtual_voxel_size
    pw = points.double() @ cam.rot.double().T + cam.trans.double()
    blk = torch.floor(pw / side).to(torch.int32)
    near = torch.stack(torch.meshgrid(
        *[torch.arange(-1, 2, device=dev)] * 3, indexing="ij"),
        -1).reshape(-1, 3).to(torch.int32)
    blk = torch.unique((blk[:, None] + near).reshape(-1, 3), dim=0)
    g = torch.Generator(device=dev).manual_seed(0)
    blk = blk[torch.randperm(blk.shape[0], generator=g, device=dev)][:n]
    bres = (torch.arange(blk.shape[0], device=dev) % 2).to(torch.int32)
    return blk.contiguous(), bres


def compare_scan_raster_kernels(clouds):
    """K13 and K14 (ops/scan_raster.py, csrc/scan_raster.cu) against their
    twins on the card, bit for bit: the image and the mapping of scan
    L_COMPARE_AT of the multi-res LiDAR slice (the loop's 64x1024 shape),
    and pix and r_vox over two windows, the slice's map after L_COMPARE_AT
    scans and a drive-sized one (drive_window).  Then each kernel's time,
    a call timed alone with CUDA events behind a spin kernel (so the
    events time the device, not the host's enqueue; K13's three launches
    together), beside its byte bound and the twin's eager time.  Returns
    {name: record}."""
    import torch

    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import integrate as I
    from mrhash_tpu_torch.ops import scan_raster as SR
    from mrhash_tpu_torch.utils.profiler import COUNTS

    def bits(t):
        return t.contiguous().view(torch.int32)

    dev = torch.device("cuda")
    gw = make_lidar_wrapper("cuda", clouds[0], multires=True)
    for i in range(L_COMPARE_AT):
        feed_lidar(gw, i, clouds)
    cfg = gw.cfg
    cam = C.with_pose(gw.camera, gw.curr_rot, lidar_pose(L_COMPARE_AT))
    points = torch.from_numpy(clouds[L_COMPARE_AT]).to(dev)
    _, bpos, _, bres = I.compact_active(cfg, gw.state.table)
    windows = dict(loop=(bpos, bres), drive=drive_window(cfg, cam, points))
    del gw
    n0 = {k: COUNTS[k] for k in SCAN_NAMES}
    img, mapping = SR.raster_scan(cam, points)
    t_img, t_map = SR.raster_scan_ref(cam, points)
    assert torch.equal(bits(img), bits(t_img)), "K13 image"
    assert torch.equal(bits(mapping), bits(t_map)), "K13 mapping"
    calls = {"raster": (lambda: SR.raster_scan(cam, points),
                        lambda: SR.raster_scan_ref(cam, points))}
    on_image = {}
    for name, (bpos, bres) in windows.items():
        pix, r_vox = SR.project_window(cfg, cam, bpos, bres, mapping)
        on_image[name] = int((pix >= 0).sum())
        t_pix, t_r = SR.project_window_ref(cfg, cam, bpos, bres, t_map)
        assert torch.equal(pix, t_pix), f"K14 pix ({name})"
        assert torch.equal(bits(r_vox), bits(t_r)), f"K14 r_vox ({name})"
        calls[name] = (
            lambda b=bpos, r=bres: SR.project_window(cfg, cam, b, r,
                                                     mapping),
            lambda b=bpos, r=bres: SR.project_window_ref(cfg, cam, b, r,
                                                         t_map))
    assert {k: COUNTS[k] - n0[k] for k in SCAN_NAMES} == dict(
        raster_scan=3, project_window=2), "K13: 3 launches, K14: 1"
    n, hw = points.shape[0], L_ROWS * L_COLS
    a = {k: w[0].shape[0] for k, w in windows.items()}
    log(f"compare K13/K14: scan of {n} points, {int((img > 0).sum())} of "
        f"{hw} pixels hit; windows {a['loop']} (loop, "
        f"{int(windows['loop'][1].sum())} at res 1) and {a['drive']} "
        f"(drive) entries, {on_image['loop']} and {on_image['drive']} "
        f"lanes on the image; kernels equal their twins bit for bit")

    ms = {k: [] for k in calls}
    twin_ms = {k: [] for k in calls}
    for _ in range(TURNS):
        for k, (kernel, twin) in calls.items():
            for out, fn, spin in ((ms, kernel, True), (twin_ms, twin, False)):
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                if spin:        # the device busy while the host enqueues
                    torch.cuda._sleep(SPIN_CYCLES)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                out[k].append(e0.elapsed_time(e1))
    # bytes, each input read once and each output written once: K13 the
    # points (12 B) and the image (4 B a pixel), K14 an entry's bpos and
    # bres (16 B) and a lane's pix and r_vox (8 B)
    nb = dict(raster=n * 12 + hw * 4,
              **{k: a[k] * (16 + 512 * 8) for k in windows})
    out = {}
    for k in calls:
        out[k] = kernel_record(dict(kernel=statistics.median(ms[k]),
                                    twin=statistics.median(twin_ms[k]),
                                    library=None), 0, nb[k], 0)
        out[k].update(points=n, window=a.get(k, 0))
    log(f"compare K13/K14: K13 {out['raster']['ms']:.4f} ms alone (bound "
        f"{out['raster']['bound_ms']:.4f}, twin {out['raster']['plain_ms']:.4f}"
        f" eager); K14 {out['loop']['ms']:.4f} ms over the loop's window "
        f"(bound {out['loop']['bound_ms']:.4f}, twin "
        f"{out['loop']['plain_ms']:.4f}), {out['drive']['ms']:.4f} ms over "
        f"the drive's (bound {out['drive']['bound_ms']:.4f}, twin "
        f"{out['drive']['plain_ms']:.4f})")
    return out


def small_lidar_inputs(n_starve=0):
    """Phase 3's small LiDAR scene: 3 scans of a 16x128 sensor (beams half
    a column off the raster edges, 12 m wall) moving 0.4 m per scan,
    starving every n_starve scans.  Returns (cfg, poses, scans, make_camera's
    arguments)."""
    import numpy as np

    from mrhash_tpu_torch.core.state import MapConfig
    from mrhash_tpu_torch.ops import camera as C

    rows, cols = 16, 128
    cfg = MapConfig(virtual_voxel_size=0.20, sdf_truncation=0.40,
                    max_integration_distance=40.0, num_blocks=1 << 12,
                    num_buckets=1 << 11, max_active_blocks=1 << 11,
                    max_alloc_per_frame=1 << 11,
                    n_frames_invalidate_voxels=n_starve)
    rng = np.random.default_rng(0)
    poses = [np.array([0.4 * i, 0.0, 0.0], np.float32) for i in range(3)]
    scans = [lidar_cloud(t, rng, rows, cols, 12.0, np.pi / cols)
             for t in poses]
    return cfg, poses, scans, (cols / (2 * np.pi), rows / 0.65, cols / 2,
                               rows / 2, rows, cols, 0.2, 40.0, C.SPHERICAL)


def compare_small_lidar():
    """The whole LiDAR slice on the card against the slice on the CPU
    (where the tests hold it against the JAX reference): 3 scans of a 16x128
    sensor (beams half a column off the raster edges, 12 m wall).  Same key
    set; the CPU's and the card's atan2/asin may put a voxel on another
    pixel, so weight flips plus sdf differences beyond 2e-3 may reach
    max(16, 1e-4 x lanes), the tests' bound."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import make_state
    from mrhash_tpu_torch.ops import camera as C

    cfg, poses, scans, cam_args = small_lidar_inputs()
    maps = {}
    for dev in ("cpu", "cuda"):
        st = make_state(cfg.num_blocks, cfg.num_buckets, dev)
        cam0 = C.make_camera(*cam_args, device=dev)
        for t, pts in zip(poses, scans):
            cam = C.with_pose(cam0, np.eye(3, dtype=np.float32), t)
            st, _ = pipeline.integrate_points(cfg, st, cam,
                                              torch.from_numpy(pts).to(dev))
        occ = (st.table.ptr != -2).cpu().numpy()
        pos = st.table.pos.cpu().numpy()[occ]
        rows_ = st.table.ptr.cpu().numpy()[occ] // 512
        order = np.lexsort(pos.T)
        maps[dev] = (pos[order], {f: getattr(st.pool, f).cpu().numpy()
                                  [rows_[order]] for f in
                                  ("sdf", "sumsq", "weight")})
    (pc, mc), (pg, mg) = maps["cpu"], maps["cuda"]
    assert np.array_equal(pc, pg), "block key sets differ"
    assert int((mc["weight"] > 0).sum()) > 20000
    flips = int((mc["weight"] != mg["weight"]).sum())
    both = (mc["weight"] > 0) & (mg["weight"] > 0)
    far = int((np.abs(mc["sdf"] - mg["sdf"]) > 2e-3)[both].sum())
    exact = int((mc["sdf"] == mg["sdf"])[both].sum())
    bound_n = max(16, int(mc["weight"].size * 1e-4))
    log(f"compare LiDAR slice cuda vs cpu (16x128, 3 scans): {len(pc)} "
        f"blocks, {int(both.sum())} weighted lanes in both, {flips} weight "
        f"flips, {far} sdf beyond 2e-3, {exact} sdf bit-equal")
    assert flips + far <= bound_n, (flips, far, bound_n)

def compare_c14_keys(depths, clouds):
    """ROADMAP C14: the allocation candidates computed on the card equal the
    CPU's, as sets, at full width: the RGB-D tile DDA of phase 4's frames
    0, 1 and 100 (1200x680, 1 cm; even frames walk the near band, odd ones
    the far band) and the point-centric voxel walk of one 64x1024 scan
    (scan 0 of phase 11, its MADtree normals).  Also counts the walk's
    start points whose quotient by the voxel size, taken on the card by a
    Python number (a product with its reciprocal), lands in another voxel
    than the CPU's (the fault the repair removes).  Returns the counts."""
    import numpy as np
    import torch

    from mrhash_tpu_torch import native
    from mrhash_tpu_torch.core.state import MapConfig
    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import coords as X

    def key_set(k, m):
        k = k.cpu().numpy()[m.cpu().numpy()]
        return {tuple(r) for r in k}

    out = {}
    # phase 4's settings (make_wrapper), without its pool
    cfg = MapConfig(alloc_tile=4, virtual_voxel_size=0.01,
                    sdf_truncation=0.07, max_integration_distance=30.0)
    steps = cfg.dda_steps(cfg.max_integration_distance)
    for i in (0, 1, 100):
        rot, trans, _ = orbit_pose(i)
        sets = []
        for dev in ("cpu", "cuda"):
            cam = C.with_pose(C.make_camera(FX, FY, CX, CY, ROWS, COLS, 0.01,
                                            30.0, device=dev), rot, trans)
            depth = torch.from_numpy(depths[i % ORBIT]).to(dev)
            pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth))
            sets.append(key_set(*AB.alloc_candidates_depth(
                cfg, cam, pc_depth, steps, frame=i)))
        out[f"rgbd_{i}"] = len(sets[0] ^ sets[1])
        log(f"compare C14: RGB-D frame {i}: {len(sets[0])} candidate keys "
            f"on the CPU, {len(sets[1])} on the card, {out[f'rgbd_{i}']} "
            f"differ")

    # phase 11's settings (newer_college.cfg); the walk needs only the pose
    cfg = MapConfig(virtual_voxel_size=0.20, sdf_truncation=0.40,
                    max_integration_distance=100.0, projective_sdf=False)
    pts = clouds[0]
    nrm = native.estimate_normals(pts)[0]
    walks, starts = [], []
    for dev in ("cpu", "cuda"):
        cam = C.with_pose(C.make_camera(1.0, 1.0, 0.0, 0.0, L_ROWS, L_COLS,
                                        0.2, 100.0, C.SPHERICAL, device=dev),
                          np.eye(3, dtype=np.float32), lidar_pose(0))
        points = torch.from_numpy(pts).to(dev)
        n_dir, rng = X.unit(torch.from_numpy(nrm).to(dev))[0], \
            X.unit(points)[1]
        t = X.get_truncation(rng, cfg.sdf_truncation, 0.0)
        d_min = torch.clamp(rng - t, max=cfg.max_integration_distance)
        d_max = torch.clamp(rng + t, max=cfg.max_integration_distance)
        ok = (rng >= 1e-6) & (d_min < d_max)
        pw_min = C.cam_to_world(cam, points + n_dir * (d_min - rng)[:, None])
        pw_max = C.cam_to_world(cam, points + n_dir * (d_max - rng)[:, None])
        vox, visit = AB.dda_visit(
            cfg, pw_min, pw_max, ok,
            cfg.dda_voxel_steps(cfg.max_integration_distance),
            block_level=False)
        walks.append(key_set(vox.reshape(-1, 3), visit.reshape(-1)))
        # the unrepaired quotient: by a Python number
        p = pw_min / float(cfg.virtual_voxel_size)
        starts.append(X._sign_aware_floor(p + torch.sign(p) * 0.5).cpu())
    out["walk"] = len(walks[0] ^ walks[1])
    out["walk_starts_by_python_number"] = int(
        (starts[0] != starts[1]).any(dim=1).sum())
    log(f"compare C14: point-centric walk of a {L_ROWS}x{L_COLS} scan: "
        f"{len(walks[0])} visited voxels on the CPU, {len(walks[1])} on the "
        f"card, {out['walk']} differ; start voxels by a Python-number "
        f"quotient on the card: {out['walk_starts_by_python_number']} of "
        f"{pts.shape[0]} differ from the CPU's")
    bad = {k: v for k, v in out.items() if k != "walk_starts_by_python_number"
           and v}
    assert not bad, f"C14: card and CPU candidates differ {bad}"
    return out


def compare_small_points():
    """The point-centric LiDAR slice (projective_sdf=False, starvation and
    GC every 2 scans) on the card against the same slice on the CPU (where
    the tests hold it against the JAX reference): 3 scans of phase 3's
    16x128 scene with MADtree normals.  Same key set and the same blocks
    freed by GC; the starve scan's atan2/asin may move a voxel to another
    pixel, so weight flips are bounded by max(16, 1e-4 x lanes), and sdf
    agrees within 2e-5 where the weights agree (index_add_'s order)."""
    import numpy as np
    import torch

    from mrhash_tpu_torch import native
    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import MapConfig, make_state
    from mrhash_tpu_torch.ops import camera as C

    rows, cols = 16, 128
    cfg = MapConfig(virtual_voxel_size=0.20, sdf_truncation=0.40,
                    max_integration_distance=40.0, num_blocks=1 << 12,
                    num_buckets=1 << 11, max_active_blocks=1 << 11,
                    max_alloc_per_frame=1 << 11, projective_sdf=False,
                    n_frames_invalidate_voxels=2)
    rng = np.random.default_rng(0)
    poses = [np.array([0.4 * i, 0.0, 0.0], np.float32) for i in range(3)]
    scans = [lidar_cloud(t, rng, rows, cols, 12.0, np.pi / cols)
             for t in poses]
    normals = [native.estimate_normals(p)[0] for p in scans]
    maps = {}
    for dev in ("cpu", "cuda"):
        st = make_state(cfg.num_blocks, cfg.num_buckets, dev)
        cam0 = C.make_camera(cols / (2 * np.pi), rows / 0.65, cols / 2,
                             rows / 2, rows, cols, 0.2, 40.0, C.SPHERICAL,
                             device=dev)
        freed = []
        for t, pts, nrm in zip(poses, scans, normals):
            cam = C.with_pose(cam0, np.eye(3, dtype=np.float32), t)
            st, stats = pipeline.integrate_points(
                cfg, st, cam, torch.from_numpy(pts).to(dev),
                torch.from_numpy(nrm).to(dev))
            freed.append(stats["gc_freed"])
        occ = (st.table.ptr != -2).cpu().numpy()
        pos = st.table.pos.cpu().numpy()[occ]
        rows_ = st.table.ptr.cpu().numpy()[occ] // 512
        order = np.lexsort(pos.T)
        maps[dev] = (pos[order], {f: getattr(st.pool, f).cpu().numpy()
                                  [rows_[order]] for f in
                                  ("sdf", "sumsq", "weight")}, freed)
    (pc, mc, fc), (pg, mg, fg) = maps["cpu"], maps["cuda"]
    assert np.array_equal(pc, pg), "block key sets differ"
    assert fc == fg, ("GC freed other counts", fc, fg)
    assert int((mc["weight"] > 0).sum()) > 10000
    flips = int((mc["weight"] != mg["weight"]).sum())
    agree = (mc["weight"] == mg["weight"]) & (mc["weight"] > 0)
    err = float(np.abs(mc["sdf"] - mg["sdf"])[agree].max())
    bound_n = max(16, int(mc["weight"].size * 1e-4))
    log(f"compare point-centric LiDAR slice cuda vs cpu (16x128, 3 scans, "
        f"starve on scan 2): {len(pc)} blocks, GC freed {fc} per scan on "
        f"both, {flips} weight flips, max sdf |diff| {err:.3g}")
    assert flips <= bound_n and err <= TOL["sdf"], (flips, err)
    return dict(blocks=len(pc), gc_freed=fc, flips=flips, sdf_err=err)


def starve_readback(gw, cam):
    """The starvation z-buffer of the wrapper's window under `cam` and the
    lanes that read it back (ops/integrate.py::starve_mask's inputs to K2):
    (zimg f32[2,H,W], row, col, ok, depth)."""
    import torch

    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import coords as X
    from mrhash_tpu_torch.ops import integrate as I
    cfg = gw.cfg
    _, bpos, _, bres = I.compact_active(cfg, gw.state.table)
    pi, valid = X.block_voxel_grid(bpos, bres)
    pcam = C.world_to_cam(cam, X.virtual_voxel_pos_to_world(
        cfg.virtual_voxel_size, pi))
    row, col, ok = C.project_point(cam, pcam)
    z = C.get_depth(cam, pcam)
    ok = (ok & valid & (z >= cam.min_depth)).contiguous()
    HW = cam.rows * cam.cols
    pix = torch.where(ok, row.long() * cam.cols + col, HW).reshape(-1)
    zbuf = torch.full((HW + 1,), I.FAR, dtype=torch.float32,
                      device=z.device)
    zbuf.scatter_reduce_(0, pix, torch.where(ok, z, I.FAR).reshape(-1),
                         "amin")
    zimg = torch.zeros((2, cam.rows, cam.cols), dtype=torch.float32,
                       device=z.device)
    zimg[0] = zbuf[:HW].reshape(cam.rows, cam.cols)
    return zimg, row.contiguous(), col.contiguous(), ok, z


def compare_k2_spherical(clouds):
    """K2 on the spherical z-buffer (phase 11's starvation readback): the
    point-centric wrapper after L_STARVE scans, then the readback of its
    window under the last scan's pose, 64x1024, columns wrapping at +-pi;
    K2 equal to its twin, timed against the twin and torch.take as
    compare_kernels times the RGB-D readback."""
    import torch

    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import sample_image as SI

    gw = make_lidar_wrapper("cuda", clouds[0], n_starve=L_STARVE,
                            projective=False)
    for i in range(L_STARVE):
        feed_lidar(gw, i, clouds, True)
    cam = C.with_pose(gw.camera, gw.curr_rot, lidar_pose(L_STARVE - 1))
    zimg, row, col, ok, z = starve_readback(gw, cam)
    A = row.shape[0]
    del gw
    sk = SI.sample_image(zimg, row, col, ok)
    st = SI.sample_image_ref(zimg, row, col, ok)
    torch.cuda.synchronize()
    err = float((sk - st).abs().max())
    n_front = int((ok & (z == sk[:, 0, :])).sum())
    log(f"compare K2 spherical: window {A} blocks, {int(ok.sum())} in-image "
        f"lanes of {L_ROWS}x{L_COLS}, {n_front} front-most, max |diff| "
        f"{err}")
    assert torch.equal(sk, st), "K2 differs from its twin"
    assert n_front > 10000
    HW = L_ROWS * L_COLS
    flat = torch.where(ok, row.long() * L_COLS + col, 0)[:, None, :]
    idx = flat + torch.arange(2, device=row.device)[None, :, None] * HW
    t = time_in_turns(lambda: SI._launch(zimg, row, col, ok),
                      lambda: SI.sample_image_ref(zimg, row, col, ok),
                      lambda: torch.take(zimg, idx))
    lanes = A * 512
    rec = kernel_record(t, err, lanes * 17 + 2 * HW * 4, lanes * 2)
    rec.update(window_blocks=A)
    return rec


# ---------------------------------------------------------------------------
# GS scene: tools/bench_gs.py's textured box room, in numpy
# ---------------------------------------------------------------------------

def texture_rgb(pts_w):
    """tools/bench_gs.py::texture_rgb: a multi-view-consistent RGB from the
    world position."""
    import numpy as np
    x, y, z = pts_w[..., 0], pts_w[..., 1], pts_w[..., 2]
    r = 0.5 + 0.45 * np.sin(2.1 * x) * np.cos(1.3 * y)
    g = 0.5 + 0.45 * np.sin(1.7 * y + 0.8) * np.cos(2.3 * z)
    b = 0.5 + 0.45 * np.sin(1.1 * z + 1.9) * np.cos(1.9 * x)
    return (np.stack([r, g, b], -1) * 255.0).astype(np.uint8)


def gs_frame(th, tx, rng, rows=ROWS, cols=COLS):
    """tools/bench_gs.py::scene_frame: the pose (rotation th about y,
    translation tx along x), the 6 m box room's depth with 3 mm noise, and
    texture_rgb at each pixel's world point."""
    import numpy as np
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    trans = np.array([tx, 0.0, 0.0], np.float32)
    fx = 600.0 * cols / 1200.0
    cx, cy = cols / 2 - 0.5, rows / 2 - 0.5
    depth = room_depth(rot, trans, rng, rows, cols, fx, fx, cx, cy)
    r = np.arange(rows, dtype=np.float32)[:, None]
    c = np.arange(cols, dtype=np.float32)[None, :]
    pc = np.stack([(c - cx - 0.5) / fx * depth, (r - cy - 0.5) / fx * depth,
                   depth], -1)
    return dict(rot=rot, trans=trans,
                quat=np.array([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)]),
                depth=depth, rgb=texture_rgb(pc @ rot.T + trans))


def gs_frames(rng, rows=ROWS, cols=COLS):
    """The two training frames, the held-out pose halfway between them
    (never trained), and GS_MORE_FRAMES more frames of the same pan."""
    train = [gs_frame(0.15 * i, 0.05 * i, rng, rows, cols) for i in range(2)]
    holdout = gs_frame(0.075, 0.025, rng, rows, cols)
    more = [gs_frame(0.15 * i, 0.05 * i, rng, rows, cols)
            for i in range(2, 2 + GS_MORE_FRAMES)]
    return train, holdout, more


def make_gs_wrapper(device, rows=ROWS, cols=COLS):
    """The port's GeoWrapper at tools/bench_gs.py's map settings (5 cm
    voxels, 15 cm truncation, 2^15 blocks, GC off) with the GS path on,
    configured by configurations/params.json."""
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(sdf_truncation=0.15, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.05,
                    n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                    gs_optimization_param_path=GS_PARAMS, num_blocks=1 << 15,
                    profiling=False, device=device)
    fx = 600.0 * cols / 1200.0
    gw.setCamera(fx, fx, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols, 0.01,
                 30.0)
    return gw


def feed_gs(gw, f):
    gw.setCurrPose(f["trans"], f["quat"])
    gw.setDepthImage(f["depth"])
    gw.setRGBImage(f["rgb"])
    gw.compute()


def compare_qtree(rgb):
    """The quad tree of a full-size frame on the card against the CPU: the
    integral is exact (PORT_NOTES.md P25), so the leaves are equal."""
    import torch

    from mrhash_tpu_torch.gs.quadtree import build_qtree

    got = [build_qtree(torch.from_numpy(rgb).to(dev), 0.1, 1, 1 << 15)
           for dev in ("cpu", "cuda")]
    (lc, vc, nc, oc), (lg, vg, ng, og) = got
    log(f"compare quad tree cuda vs cpu ({rgb.shape[0]}x{rgb.shape[1]}): "
        f"{nc} / {ng} leaves, overflow {oc} / {og}")
    assert (nc, oc) == (ng, og) and nc > 1000
    assert torch.equal(lc, lg.cpu()) and torch.equal(vc, vg.cpu())


def compare_small_gs(devices=("cpu", "cuda")):
    """The whole GS slice on the card against the slice on the CPU (where
    the tests hold it against the JAX reference): GeoWrapper.compute with
    the GS hook over 3 frames of tests/test_gs_e2e.py's 48x64 textured
    wall.  The same Gaussian count after every frame; after frame 1, 95 %
    of each parameter's elements within 1e-5 and all within 2e-3 (the
    tests' bound against the reference: Adam turns rounding-level
    gradient differences, here also from the card's atomic scatter-add of
    the attribute gradients, into steps of up to the learning rate)."""
    import json as js

    import numpy as np

    from mrhash_tpu_torch.geowrapper import GeoWrapper

    rows, cols = 48, 64
    depth = np.full((rows, cols), 2.0, np.float32)
    r = np.arange(rows, dtype=np.float32)[:, None] - (rows / 2 - 0.5) - 0.5
    c = np.arange(cols, dtype=np.float32)[None, :] - (cols / 2 - 0.5) - 0.5
    rgb = texture_rgb(np.stack(np.broadcast_arrays(
        c / 40.0 * 2.0, r / 40.0 * 2.0, depth), -1))
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.json")
        with open(path, "w") as fh:
            js.dump(dict(sh_degree=1, position_lr=0.002, feature_lr=0.02,
                         opacity_lr=0.05, scaling_lr=0.005,
                         rotation_lr=0.001, lambda_dssim=0.2,
                         qtree_thresh=0.002, qtree_min_pixel_size=2,
                         kf_thresh=20, kf_iters=6, non_kf_iters=3,
                         random_kf_num=1, global_iters=2,
                         train_max_per_tile=32), fh)
        for dev in devices:
            gw = GeoWrapper(sdf_truncation=0.15, sdf_truncation_scale=0.0,
                            integration_weight_sample=1,
                            virtual_voxel_size=0.05,
                            n_frames_invalidate_voxels=0,
                            voxel_extents_scale=1,
                            gs_optimization_param_path=path,
                            num_blocks=4096, max_active_blocks=4096,
                            max_alloc_per_frame=2048, max_depth=5.0,
                            profiling=False, device=dev)
            gw.setCamera(40.0, 40.0, cols / 2 - 0.5, rows / 2 - 0.5, rows,
                         cols, 0.01, 5.0)
            counts, p1 = [], None
            for i in range(3):
                gw.setCurrPose([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
                gw.setDepthImage(depth)
                gw.setRGBImage(rgb)
                gw.compute()
                m = gw.gs_container.model
                counts.append(m.count)
                if i == 0:
                    p1 = {k: v.detach().cpu().numpy().copy()
                          for k, v in m.params().items()}
            got[dev] = counts, p1
    (cc, pc), (cg, pg) = (got[d] for d in devices)
    assert cc == cg and cc[0] > 0, (cc, cg)
    d = {k: np.abs(pc[k] - pg[k]) for k in pc}
    q95 = {k: float(np.quantile(v, 0.95)) for k, v in d.items()}
    err = {k: float(v.max()) for k, v in d.items()}
    log(f"compare GS slice {devices[1]} vs {devices[0]} (48x64, 3 frames): "
        f"Gaussians per frame {cc} / {cg}, parameters after frame 1: 95th "
        f"percentile |diff| {q95}, max {err}")
    assert max(q95.values()) <= 1e-5 and max(err.values()) <= 2e-3, err


def k4_bytes(T, K):
    """K4's bytes: attr (36 B) and valid (1 B) read and the mask (32 B, 256
    bits) written per (tile, k); T and C (16 B) written per pixel."""
    return T * K * (36 + 1 + 32) + T * 256 * 16


def k5_bytes(T, K, slots):
    """K5's bytes: attr and mask rows of the valid slots read, the
    gradient of every slot written, Tfin, gT and gC read per pixel."""
    return slots * (36 + 32) + T * K * 36 + T * 256 * 20


def blend_case(attr, valid, gx, gy, bg, gt, rows, cols):
    """K4 and K5 against their twins on one binned render: the K4 outputs,
    the cotangents of the summed L1 loss against `gt`, the errors, and
    the warp-steps each kernel walks."""
    import torch

    from mrhash_tpu_torch.gs import blend as B
    from mrhash_tpu_torch.gs import rasterizer as R

    T, K = valid.shape
    Tk, Ck, mk = B.blend_forward(attr, valid, gx)
    Tt, Ct, mt = B.blend_forward_ref(attr, valid, gx)
    Tl = Tk.clone().requires_grad_()
    Cl = Ck.clone().requires_grad_()
    img = R.untile(Tl, Cl, bg, gx, gy, rows, cols)
    gT, gC = torch.autograd.grad(
        (img - gt.permute(2, 0, 1) / 255.0).abs().sum(), [Tl, Cl])
    gT, gC = gT.contiguous(), gC.contiguous()
    gk = B.blend_backward(attr, valid, gx, Tk, mk, gT, gC)
    gt_ = B.blend_backward_ref(attr, gx, Tk, mk, gT, gC)
    torch.cuda.synchronize()
    bits = B.unpack_mask(mk)
    flips = int((bits != B.unpack_mask(mt)).sum())
    e4 = max(float((Tk - Tt).abs().max()), float((Ck - Ct).abs().max()))
    e5 = float((gk - gt_).abs().max())
    slots = int(valid.sum())
    blended = int(bits.sum())
    # (tile, k, 32 pixels) steps K5 walks (each tile up to its last valid
    # slot), those with a blended pixel (the rest it skips), and those K4
    # walks: its warp of pixels 32 w + i and 128 + 32 w + i leaves at the
    # exit condition of the last of its 64 pixels to reach it
    last = torch.where(valid, torch.arange(1, K + 1, device=valid.device),
                       0).amax(1)
    walked = int(last.sum()) * 8
    busy = int((mk != 0).sum())
    exits = B.exit_steps(attr, valid, gx).view(T, 2, 4, 32).amax((1, 3))
    walked4 = 2 * int(torch.minimum(exits, last[:, None]).sum())
    log(f"compare K4 at K {K}: {T} tiles, {slots} valid slots, {blended} "
        f"blended (tile, k, pixel); mask flips {flips}, max |diff| "
        f"Tfin/Cfin {e4}; warp steps walked {walked4}, left by the early "
        f"exit {walked - walked4} of {walked}")
    log(f"compare K5 at K {K}: max |diff| {e5} (largest |grad| "
        f"{float(gt_.abs().max())}); warp steps walked {walked}, with a "
        f"blended pixel {busy}")
    assert torch.equal(mk, mt) and flips == 0 and e4 <= 1e-6, (flips, e4)
    torch.testing.assert_close(gk, gt_, atol=1e-4, rtol=1e-4)
    assert blended > 100000, "K4 blended almost nothing"
    return dict(Tk=Tk, mk=mk, gT=gT, gC=gC, e4=e4, e5=e5, slots=slots,
                walked=walked, busy=busy, walked4=walked4)


def compare_blend_kernels(train, rows=ROWS, cols=COLS):
    """Drive the GS path over the two training frames, then hold K4 and
    K5 against their twins on the training render of frame 1 at the
    online cap (K = 64) and at GSFinalOpt's (K = 128): Tfin and Cfin
    within 1e-6, the mask equal, the attribute gradients within 1e-4
    absolute and relative under the cotangents of the summed L1 loss
    against frame 1.  K4 is timed at K = 64, K5 at both."""
    import torch

    from mrhash_tpu_torch.gs import blend as B
    from mrhash_tpu_torch.gs import rasterizer as R
    from mrhash_tpu_torch.gs.container import _cam_dict
    from mrhash_tpu_torch.ops import camera as C

    gw = make_gs_wrapper("cuda", rows, cols)
    for f in train:
        feed_gs(gw, f)
    gc = gw.gs_container
    cam = C.with_pose(gw.camera, train[1]["rot"], train[1]["trans"])
    params, cd = gc.model.params(), _cam_dict(cam)
    n_gauss, bg = gc.model.count, gc.model.background
    gt = torch.from_numpy(train[1]["rgb"]).cuda().to(torch.float32)
    log(f"compare K4/K5: {n_gauss} Gaussians")
    recs = []
    for K in (GS_K, GS_FINAL_K):
        with torch.no_grad():
            b = R.bin_and_gather(params, cd, gc.p.sh_degree,
                                 max_per_tile=K)
        attr, valid, gx = b["attr"].contiguous(), b["valid"], b["grid_x"]
        T = valid.shape[0]
        assert valid.shape[1] == K and T == (
            (rows + 15) // 16) * ((cols + 15) // 16), valid.shape
        c = blend_case(attr, valid, gx, b["grid_y"], bg, gt, rows, cols)
        Tk, mk, gT, gC = c["Tk"], c["mk"], c["gT"], c["gC"]
        t4 = None
        if K == GS_K:
            t4 = time_in_turns(lambda: B._launch_forward(attr, valid, gx),
                               lambda: B.blend_forward_ref(attr, valid, gx))
        t5 = time_in_turns(
            lambda: B._launch_backward(attr, valid, gx, Tk, mk, gT, gC),
            lambda: B.blend_backward_ref(attr, gx, Tk, mk, gT, gC))
        # K4: k4_bytes, ~30 f32 operations per valid (tile, k, pixel).
        # K5: attr and the mask (68 B) read per valid (tile, k) (K4 blends
        # no invalid slot, so the others' mask rows are zeros the function
        # need not read) and the gradient (36 B) written per (tile, k);
        # Tfin, gT and gC (20 B) read per pixel; ~70 operations per valid
        # (tile, k, pixel)
        slots = c["slots"]
        k5 = kernel_record(t5, c["e5"], k5_bytes(T, K, slots),
                           slots * 256 * 70)
        k5.update(tiles=T, K=K, valid_slots=slots, warp_steps=c["walked"],
                  busy_warp_steps=c["busy"])
        if t4 is not None:
            k4 = kernel_record(t4, c["e4"], k4_bytes(T, K), slots * 256 * 30)
            k4.update(tiles=T, K=K, valid_slots=slots,
                      warp_steps=c["walked4"],
                      exit_warp_steps=c["walked"] - c["walked4"])
            recs.append(k4)
        recs.append(k5)
        del b, attr, valid, c, Tk, mk, gT, gC
    return recs


# ---------------------------------------------------------------------------
# streaming walk: tools/bench_walk.py's square tube, in numpy
# ---------------------------------------------------------------------------

def tube_depth(off_x, off_y, rows=ROWS, cols=COLS, f=FX):
    """tools/bench_walk.py::tube_depth: z-depth of the square tube |x| =
    |y| = W_HALF seen from (off_x, off_y, z) looking along z (0 beyond
    W_MAXD), principal point at the image centre."""
    import numpy as np
    u = (np.arange(cols, dtype=np.float32)[None, :] - (cols / 2 - 0.5)) / f
    v = (np.arange(rows, dtype=np.float32)[:, None] - (rows / 2 - 0.5)) / f
    big = np.float32(1e9)

    def t_plane(d, o, w):
        tp = np.where(d > 1e-6, (w - o) / np.maximum(d, 1e-6), big)
        tm = np.where(d < -1e-6, (-w - o) / np.minimum(d, -1e-6), big)
        return np.minimum(tp, tm)

    z = np.minimum(t_plane(np.broadcast_to(u, (rows, cols)), off_x, W_HALF),
                   t_plane(np.broadcast_to(v, (rows, cols)), off_y, W_HALF))
    return np.where(z < W_MAXD, z, 0.0).astype(np.float32)


def walk_offsets():
    """bench_walk's 8 lateral camera offsets, cycled over the frames."""
    import numpy as np
    return [(0.1 * np.sin(k), 0.05 * np.cos(k))
            for k in np.linspace(0, 2 * np.pi, 8, endpoint=False)]


def make_walk_wrapper(device, rows=ROWS, cols=COLS, f=FX,
                      num_blocks=W_BLOCKS, vvs=0.01, trunc=0.07):
    """The port's GeoWrapper at tools/bench_walk.py's settings: 1 cm
    voxels, 7 cm truncation, starvation every 100 frames, max depth 4 m,
    2^16 blocks, 2^14 buckets, window cap 2^15, 2^13 allocations per
    frame (its starve_bands=8 is P3's one-shot starvation)."""
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(sdf_truncation=trunc, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=vvs,
                    n_frames_invalidate_voxels=100, voxel_extents_scale=1,
                    gs_optimization_param_path="", num_blocks=num_blocks,
                    num_buckets=num_blocks >> 2,
                    max_active_blocks=num_blocks >> 1,
                    max_alloc_per_frame=1 << 13, profiling=False,
                    device=device)
    gw.setCamera(f, f, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols, 0.01,
                 W_MAXD)
    return gw


def walk_frame(gw, z, k, depths, rgb, back=False):
    """One frame of the walk at depth z along the tube with offset k of
    walk_offsets(); back=True turns the camera around (a half turn about
    y, which mirrors the image's x)."""
    import numpy as np
    ox, oy = walk_offsets()[k % 8]
    if back:
        gw.setCurrPose([ox, oy, z], [0.0, 1.0, 0.0, 0.0])
        gw.setDepthImage(np.ascontiguousarray(depths[k % 8][:, ::-1]))
    else:
        gw.setCurrPose([ox, oy, z], [0.0, 0.0, 0.0, 1.0])
        gw.setDepthImage(depths[k % 8])
    gw.setRGBImage(rgb)
    gw.compute()


def on_tube_wall(v):
    """Which vertices lie within 3 cm of the tube's walls."""
    import numpy as np
    return np.minimum(np.abs(np.abs(v[:, 0]) - W_HALF),
                      np.abs(np.abs(v[:, 1]) - W_HALF)) < 0.03


def walk_depths(rows=ROWS, cols=COLS, f=FX):
    """The 8 depth variants (bench_walk's canned frames), each rendered
    from its own offset; a turned camera uses the mirrored image."""
    return [tube_depth(ox, oy, rows, cols, f) for ox, oy in walk_offsets()]


def host_grid(chunks):
    """A host chunk grid's blocks, concatenated and sorted by key: {pos,
    res, sdf, ssq, w, rgb}."""
    import numpy as np
    groups = list(chunks.values())
    cat = {k: np.concatenate([g[k] for g in groups]) for k in groups[0]}
    order = np.lexsort(cat["pos"].T)
    return {k: v[order] for k, v in cat.items()}


def compare_small_walk():
    """The streaming slice on the card against the slice on the CPU (where
    the tests hold it against the JAX reference): a 64x256 walk 24 m down
    the tube and 12 m back, turned around, through GeoWrapper with 2^11
    blocks of 2 cm voxels, so that the watermark fires on the way out and
    stream-in reloads blocks on the way back; the same stream events, and
    after streamAllOut the host grids hold the same keys and resolutions,
    weight and rgb equal, sdf within 2e-5, sumsq within 5e-4."""
    import numpy as np
    rows, cols, f, w = 64, 256, 160.0, W_SMALL
    depths = walk_depths(rows, cols, f)
    rgb = np.random.default_rng(1).integers(0, 255, (rows, cols, 3)
                                            ).astype(np.uint8)
    grids, events = {}, {}
    for dev in ("cpu", "cuda"):
        gw = make_walk_wrapper(dev, rows, cols, f, num_blocks=1 << 11,
                               vvs=0.02, trunc=0.06)
        for i in range(w["fwd"]):
            walk_frame(gw, w["step"] * i, i, depths, rgb)
        z0 = w["step"] * (w["fwd"] - 1)
        for k in range(1, w["back"] + 1):
            walk_frame(gw, z0 - w["step"] * k, k, depths, rgb, back=True)
        st = gw.streamer
        events[dev] = ([e["blocks"] for e in st.out_events],
                       [e["inserted"] for e in st.in_events])
        gw.streamAllOut()
        grids[dev] = host_grid(gw.streamer.grid.chunks)
    c, g = grids["cpu"], grids["cuda"]
    assert events["cpu"] == events["cuda"], events
    out, ins = events["cpu"]
    assert len(out) >= 2 and sum(ins) > 0, events
    assert np.array_equal(c["pos"], g["pos"]), "host grid key sets differ"
    assert np.array_equal(c["res"], g["res"])
    for k in ("w", "rgb"):
        assert np.array_equal(c[k], g[k]), k
    upd = c["w"] > 0
    err = {k: float(np.abs(c[k][upd] - g[k][upd]).max()) for k in
           ("sdf", "ssq")}
    log(f"compare streaming slice cuda vs cpu ({rows}x{cols}, "
        f"{w['fwd']} + {w['back']} frames): {len(out)} stream-outs of "
        f"{out} blocks, {sum(ins)} blocks streamed in, {len(c['pos'])} "
        f"blocks in the grid, {int(upd.sum())} weighted voxels, max |diff| "
        f"{err}")
    assert int(upd.sum()) > 10000
    assert err["sdf"] <= TOL["sdf"] and err["ssq"] <= TOL["sumsq"], err


# ---------------------------------------------------------------------------
# phase 9: the streaming walk
# ---------------------------------------------------------------------------

def run_walk(device="cuda", rows=ROWS, cols=COLS, f=FX, warm=W_WARM,
             timed=W_TIMED, back=W_BACK):
    """Phase 9: tools/bench_walk.py's walk through GeoWrapper.compute,
    warm + timed frames down the tube at 8 cm/frame (the watermark fires
    and the farthest blocks stream to the host grid), then `back` frames
    turned around, walking back (stream-in reloads the chunks near the
    camera).  Then the duplicate ratio, extractMesh over grid + device
    (vertices on the tube's walls), streamAllOut, and a serializeGrid ->
    deserializeGrid round trip into a fresh wrapper.  Returns (launches,
    numbers, the wrapper, whose map is then all in its host grid)."""
    import numpy as np
    import torch


    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    depths = walk_depths(rows, cols, f)
    rgb = np.random.default_rng(0).integers(0, 255, (rows, cols, 3)
                                            ).astype(np.uint8)
    gw = make_walk_wrapper(device, rows, cols, f)
    st = gw.streamer
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches(*K1_NAMES)
    frame_ms, n_events = [], []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        walk_frame(gw, W_STEP * i, i, depths, rgb)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        n_events.append(len(st.out_events))
    launches = launch_counts(*K1_NAMES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    st.join()
    events = list(st.out_events)
    timed_ev = events[n_events[warm - 1]:]
    fps = timed / (sum(frame_ms[warm:]) / 1e3)
    grid_blocks = st.grid.num_blocks()
    log(f"walk: {warm + timed} frames, launches {launches}; stream-outs "
        f"{len(events)} ({len(timed_ev)} in the timed window), blocks per "
        f"event {[e['blocks'] for e in events]}")
    for name in ("plan_ms", "gather_ms", "d2h_ms", "ingest_ms"):
        v = [e[name] for e in events]
        log(f"walk: per event {name}: median {statistics.median(v):.3f}, "
            f"max {max(v):.3f}")
    # frames whose compute() streamed (the trigger runs before the frame's
    # integrate) against the others
    ev_ms = [frame_ms[i] for i in range(warm, warm + timed)
             if n_events[i] > n_events[i - 1]]
    plain_ms = [frame_ms[i] for i in range(warm, warm + timed)
                if n_events[i] == n_events[i - 1]]
    log(f"walk: frames {warm}-{warm + timed - 1}: FPS {fps:.2f} (stream "
        f"events included), median {statistics.median(frame_ms[warm:]):.3f} "
        f"ms, max {max(frame_ms[warm:]):.3f} ms; frames with a stream event "
        f"median {statistics.median(ev_ms or [0.0]):.3f} ms ({len(ev_ms)}), "
        f"without {statistics.median(plain_ms):.3f} ms; host grid "
        f"{grid_blocks} blocks; high_free {gw.state.table.high_count}; peak "
        f"device memory {peak / 2**30:.3f} GiB")
    if cuda:
        assert launches["fused_integrate_rows"] == warm + timed, launches
        assert launches["sample_image"] >= 1, launches
    assert len(timed_ev) >= 1, "no stream-out in the timed window"

    # the walk back, turned around: the camera nears the streamed-out tube
    z0 = W_STEP * (warm + timed - 1)
    n_in = len(st.in_events)
    for k in range(1, back + 1):
        walk_frame(gw, z0 - W_BACK_STEP * k, k, depths, rgb, back=True)
    sync()
    ins = st.in_events[n_in:]
    streamed_in = sum(e["inserted"] for e in ins)
    dup = st.duplicate_ratio(gw.state)
    log(f"walk back: {back} frames, {len(ins)} stream events, "
        f"{streamed_in} blocks streamed in ({sum(e['popped'] for e in ins)} "
        f"popped, {sum(e['kept'] for e in ins)} kept in RAM); duplicate "
        f"ratio {dup:.4f}")
    assert streamed_in > 0, "nothing streamed in on the walk back"
    assert dup < 0.15, dup

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gw.extractMesh(os.path.join(tmp, "mesh.ply"))
    mesh_s = time.perf_counter() - t0
    v, n_faces = gw.getVertices(), gw.getFaces().shape[0]
    on = on_tube_wall(v)
    log(f"walk mesh (grid + device): {v.shape[0]} vertices, {n_faces} "
        f"faces, {float(on.mean()):.4f} within 3 cm of the tube's walls "
        f"({mesh_s:.1f} s)")
    assert v.shape[0] > 10000 and np.isfinite(v).all(), v.shape
    assert on.mean() > 0.95, float(on.mean())

    gw.streamAllOut()
    assert int((gw.state.table.ptr != -2).sum()) == 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.npz")
        gw.serializeGrid(path)
        fresh = make_walk_wrapper(device, rows, cols, f)
        fresh.deserializeGrid(path)
    ckpt_s = time.perf_counter() - t0
    a, b = (host_grid(g.streamer.grid.chunks) for g in (gw, fresh))
    assert all(np.array_equal(a[k], b[k]) for k in a), "checkpoint differs"
    assert (set(gw.streamer.grid.chunks)
            == set(fresh.streamer.grid.chunks))
    log(f"walk checkpoint: {len(a['pos'])} blocks in "
        f"{len(gw.streamer.grid.chunks)} chunks, serializeGrid + "
        f"deserializeGrid {ckpt_s:.1f} s, equal")
    return launches, dict(fps=fps, events=len(events),
                          timed_events=len(timed_ev), streamed_in=streamed_in,
                          dup=dup, grid_blocks=grid_blocks,
                          peak_gib=peak / 2**30, mesh_s=mesh_s,
                          on_wall=float(on.mean()), vertices=v.shape[0],
                          faces=n_faces), gw


# ---------------------------------------------------------------------------
# phase 4: the RGB-D path
# ---------------------------------------------------------------------------

def check_coarsen_launches(launches, multires):
    """K10-K12 over a phase's frames: each launched on a multi-res path
    (K11 and K12 on every coarsening step, as the configs downsample), none
    on a single-res one, which never coarsens."""
    coarsen = {k: launches[k] for k in COARSEN_NAMES}
    if multires:
        assert min(coarsen.values()) >= 1, coarsen
    else:
        assert max(coarsen.values()) == 0, coarsen


def res1_blocks(gw):
    """Res-1 blocks in the wrapper's table."""
    t = gw.state.table
    return int(((t.res == 1) & (t.ptr != -2)).sum())


def run_slice(depths, rgb, multires=False, mesh=True):
    """Phase 4 (or 7 with multires): N_FRAMES frames of the box-room orbit
    through GeoWrapper.compute, then streamAllOut and, with `mesh`,
    extractMesh (the host sweep).  Returns (launches of K1's paths, K2,
    allocation's K7-K9 and coarsening's K10-K12 over the frames, numbers,
    the wrapper)."""
    import numpy as np
    import torch


    tag = "multires" if multires else "run"
    gw = make_wrapper("cuda", multires)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*K1_NAMES, *ALLOC_NAMES, *COARSEN_NAMES, *SCAN_NAMES)
    frame_ms, occupied = [], []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        feed(gw, i, depths, rgb)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        occupied.append(gw.last_stats["occupied_blocks"])
    launches = launch_counts(*K1_NAMES, *ALLOC_NAMES, *COARSEN_NAMES)
    # the LiDAR raster and projection take no part in an RGB-D frame
    scan = launch_counts(*SCAN_NAMES)
    assert max(scan.values()) == 0, scan
    # one allocation round a frame, all of it on the kernels (coarsening
    # inserts through K9 too)
    assert launches["alloc_walk"] == launches["alloc_compact"] == N_FRAMES
    assert launches["alloc_insert"] >= N_FRAMES, launches
    peak = torch.cuda.max_memory_allocated()
    stats = gw.last_stats
    n1 = res1_blocks(gw)
    steady = frame_ms[ORBIT:]
    log(f"{tag}: {N_FRAMES} frames, launches {launches}")
    log(f"{tag}: window blocks last {occupied[-1]} max {max(occupied)}, of "
        f"them res 0 last {stats['res0_blocks']}; occupied total "
        f"{stats['occupied_total']} ({n1} at res 1), high_free "
        f"{stats['high_free']}, low_free {stats['low_free']}")
    log(f"{tag}: frames {ORBIT}-{N_FRAMES - 1}: median "
        f"{statistics.median(steady):.3f} ms, "
        f"mean {statistics.fmean(steady):.3f} ms, "
        f"FPS {1e3 / statistics.fmean(steady):.2f}; starve frame 100 "
        f"{frame_ms[100]:.3f} ms; first frame {frame_ms[0]:.1f} ms")
    log(f"{tag}: peak device memory {peak / 2**30:.3f} GiB")
    assert launches["sample_image"] >= 1, launches
    if multires:
        assert launches["fused_integrate_rows"] >= 1, launches
        assert launches["fused_integrate_rows_res1"] >= ORBIT, launches
        assert n1 > 10000 and n1 > stats["res0_blocks"], "barely coarsened"
    else:
        assert launches["fused_integrate_rows"] == N_FRAMES, launches
        assert launches["fused_integrate_rows_res1"] == 0, launches
    check_coarsen_launches(launches, multires)

    numbers = dict(median_ms=statistics.median(steady),
                   fps=1e3 / statistics.fmean(steady), peak_gib=peak / 2**30,
                   res1_blocks=n1, res0_window=stats["res0_blocks"])
    t0 = time.perf_counter()
    gw.streamAllOut()
    n_grid = gw.streamer.grid.num_blocks()
    assert n_grid == stats["occupied_total"], (n_grid, stats)
    if not mesh:
        log(f"{tag}: streamAllOut {n_grid} blocks in "
            f"{time.perf_counter() - t0:.1f} s (no mesh: phase 9 meshes "
            "this single-res 1 cm path)")
        return launches, numbers, gw
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gw.extractMesh(os.path.join(tmp, "mesh.ply"))
    extract_s = time.perf_counter() - t1
    mesh_s = time.perf_counter() - t0
    v, f = gw.getVertices(), gw.getFaces()
    log(f"{tag} mesh: {v.shape[0]} vertices, {f.shape[0]} faces "
        f"(streamAllOut + extractMesh {mesh_s:.1f} s, extractMesh "
        f"{extract_s:.1f} s)")
    assert v.shape[0] > 10000, v.shape
    assert np.isfinite(v).all()
    # the reconstruction lies on the box room's walls
    wall = np.abs(np.abs(v).max(axis=1) - HALF)
    on_wall = float((wall < 0.03).mean())
    log(f"{tag} mesh: {on_wall:.4f} of vertices within 3 cm of a wall")
    assert on_wall > 0.95, on_wall
    return launches, dict(numbers, mesh_s=mesh_s, extract_s=extract_s,
                          vertices=v.shape[0], faces=f.shape[0]), gw


# ---------------------------------------------------------------------------
# phase 5: the LiDAR path
# ---------------------------------------------------------------------------

def run_lidar(clouds, multires=False):
    """Phase 5 (or 8 with multires): L_FRAMES scans through
    GeoWrapper.compute, then streamAllOut + extractMesh.  Returns
    (launches of K3's paths over the scans, numbers: K7-K9's and K10-K12's
    launches among them)."""
    import torch


    tag = "multires lidar" if multires else "lidar"
    gw = make_lidar_wrapper("cuda", clouds[0], multires)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(*K3_NAMES, *ALLOC_NAMES, *COARSEN_NAMES, *SCAN_NAMES)
    frame_ms, occupied = [], []
    for i in range(L_FRAMES):
        t0 = time.perf_counter()
        feed_lidar(gw, i, clouds)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        occupied.append(gw.last_stats["occupied_blocks"])
    launches = launch_counts(*K3_NAMES)
    alloc = launch_counts(*ALLOC_NAMES)
    coarsen = launch_counts(*COARSEN_NAMES)
    scan = launch_counts(*SCAN_NAMES)
    # the raster (K13's three launches) and the projection (K14) on every
    # scan
    assert scan == dict(raster_scan=3 * L_FRAMES,
                        project_window=L_FRAMES), scan
    assert alloc["alloc_walk"] == alloc["alloc_compact"] == L_FRAMES, alloc
    assert alloc["alloc_insert"] >= L_FRAMES, alloc
    peak = torch.cuda.max_memory_allocated()
    steady = frame_ms[L_STEADY:]
    stats = gw.last_stats
    n1 = res1_blocks(gw)
    log(f"{tag}: {L_FRAMES} scans of {L_ROWS}x{L_COLS}, K3 launches "
        f"{launches}, K13/K14 launches {scan}")
    log(f"{tag}: window blocks first {occupied[0]} last {occupied[-1]}, "
        f"of them res 0 last {stats['res0_blocks']}; {n1} res-1 blocks; "
        f"high_free {stats['high_free']}, low_free {stats['low_free']}")
    log(f"{tag}: scans {L_STEADY}-{L_FRAMES - 1}: median "
        f"{statistics.median(steady):.3f} ms, mean "
        f"{statistics.fmean(steady):.3f} ms, FPS "
        f"{1e3 / statistics.fmean(steady):.2f}; first scan "
        f"{frame_ms[0]:.1f} ms")
    log(f"{tag}: peak device memory {peak / 2**30:.3f} GiB")
    if multires:
        assert launches["fused_integrate_points_rows"] >= 1, launches
        assert launches["fused_integrate_points_rows_res1"] >= 1, launches
        assert n1 > 1000, "barely coarsened"
    else:
        assert launches["fused_integrate_points_rows"] == L_FRAMES, launches
        assert launches["fused_integrate_points_rows_res1"] == 0, launches
    check_coarsen_launches(coarsen, multires)

    lidar_mesh(gw, tag)
    return launches, dict(alloc_launches=alloc, coarsen_launches=coarsen,
                          scan_launches=scan,
                          median_ms=statistics.median(steady),
                          mean_ms=statistics.fmean(steady),
                          fps=1e3 / statistics.fmean(steady),
                          peak_gib=peak / 2**30, window=occupied[-1],
                          res1_blocks=n1)


def lidar_mesh(gw, tag):
    """streamAllOut + extractMesh of a LiDAR phase's map: more than 10,000
    vertices, all finite, more than 95 % of them within L_TOL of the
    ground or the wall.  Returns (vertices, the on-surface share)."""
    import numpy as np
    t0 = time.perf_counter()
    gw.streamAllOut()
    with tempfile.TemporaryDirectory() as tmp:
        gw.extractMesh(os.path.join(tmp, "mesh.ply"))
    mesh_s = time.perf_counter() - t0
    v, f = gw.getVertices(), gw.getFaces()
    log(f"{tag} mesh: {v.shape[0]} vertices, {f.shape[0]} faces "
        f"(streamAllOut + extractMesh {mesh_s:.1f} s)")
    assert v.shape[0] > 10000, v.shape
    assert np.isfinite(v).all()
    ground = np.abs(v[:, 2] - L_GROUND) < L_TOL
    wall = np.abs(np.hypot(v[:, 0], v[:, 1]) - L_WALL) < L_TOL
    on = float((ground | wall).mean())
    log(f"{tag} mesh: {on:.4f} of vertices within {L_TOL} m of the ground "
        f"or the wall ({float(ground.mean()):.4f} ground, "
        f"{float(wall.mean()):.4f} wall)")
    assert on > 0.95, on
    return int(v.shape[0]), on


# ---------------------------------------------------------------------------
# phase 11: LiDAR, point-centric and starved
# ---------------------------------------------------------------------------

def run_points(clouds, projective):
    """Phase 11: phase 5's L_FRAMES scans with starvation every L_STARVE
    scans (scans 10, 20 and 30 starve: the reference starves where
    frame > 0 and frame % n == 0) and GC on every scan, through
    GeoWrapper.compute: pass (a) the point-centric update (projective_sdf
    False, MADtree normals from setPointCloud(points, True)), pass (b) the
    projective update (K3).  Each starve reads its 64x1024 z-buffer back
    through K2, so K2 launches exactly 3 times; K3 launches on every scan
    of pass (b) and never in pass (a).  Then the mesh on the ground and
    the wall.  Returns (launches, numbers)."""
    import torch


    tag = "points (b) projective" if projective else "points (a) point-centric"
    gw = make_lidar_wrapper("cuda", clouds[0], n_starve=L_STARVE,
                            projective=projective)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches("sample_image", *K3_NAMES)
    frame_ms, set_ms, visited, distinct, freed = [], [], [], [], []
    for i in range(L_FRAMES):
        t0 = time.perf_counter()
        gw.setCurrPose(lidar_pose(i), [0.0, 0.0, 0.0, 1.0])
        gw.setPointCloud(clouds[i], not projective)   # (a): the MADtree
        t1 = time.perf_counter()
        gw.compute()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        set_ms.append((t1 - t0) * 1e3)
        st = gw.last_stats
        visited.append(st.get("visited_keys", 0))
        distinct.append(st.get("distinct_keys", 0))
        freed.append(st["gc_freed"])
    launches = launch_counts("sample_image", *K3_NAMES)
    peak = torch.cuda.max_memory_allocated()
    timed = frame_ms[-L_TIMED:]
    fps = 1e3 / statistics.fmean(timed)
    st = gw.last_stats
    log(f"{tag}: {L_FRAMES} scans of {L_ROWS}x{L_COLS}, starve every "
        f"{L_STARVE}, launches {launches}")
    log(f"{tag}: scans {L_FRAMES - L_TIMED}-{L_FRAMES - 1}: median "
        f"{statistics.median(timed):.3f} ms, mean "
        f"{statistics.fmean(timed):.3f} ms, {fps:.2f} scans/s, of which "
        f"setPointCloud median {statistics.median(set_ms[-L_TIMED:]):.3f} "
        f"ms; window last {st['occupied_blocks']} blocks, high_free "
        f"{st['high_free']}")
    if not projective:
        log(f"{tag}: visited voxels per scan median "
            f"{statistics.median(visited):.0f} (min {min(visited)}, max "
            f"{max(visited)}), distinct blocks per scan median "
            f"{statistics.median(distinct):.0f} (min {min(distinct)}, max "
            f"{max(distinct)})")
    log(f"{tag}: GC freed {sum(freed)} blocks over the run, "
        f"{[freed[i] for i in range(L_STARVE, L_FRAMES, L_STARVE)]} on the "
        f"starve scans; peak device memory {peak / 2**30:.3f} GiB")
    n_starves = len(range(L_STARVE, L_FRAMES, L_STARVE))
    assert launches["sample_image"] == n_starves, launches
    assert launches["fused_integrate_points_rows"] == (
        L_FRAMES if projective else 0), launches
    assert launches["fused_integrate_points_rows_res1"] == 0, launches
    if not projective:
        assert min(distinct) > 1000 and min(visited) > 100000, (
            min(distinct), min(visited))
    verts, on = lidar_mesh(gw, tag)
    return launches, dict(
        fps=fps, median_ms=statistics.median(timed),
        mean_ms=statistics.fmean(timed),
        set_point_cloud_ms=statistics.median(set_ms[-L_TIMED:]),
        peak_gib=peak / 2**30,
        window=st["occupied_blocks"], gc_freed=sum(freed),
        visited_median=statistics.median(visited),
        distinct_median=statistics.median(distinct), vertices=verts,
        on_surface=on)


# ---------------------------------------------------------------------------
# phase 6: the GS path
# ---------------------------------------------------------------------------

def run_gs_path(train, holdout, more, device="cuda", rows=ROWS, cols=COLS,
                train_iters=GS_TRAIN_ITERS):
    """tools/bench_gs.py's protocol through the port's GeoWrapper; returns
    (launches, numbers).  The GS frame time is the container's run_gs
    (seed, insert and the frame's Adam steps), synchronized."""
    from mrhash_tpu_torch.utils.profiler import COUNTS
    import numpy as np
    import torch

    from mrhash_tpu_torch.gs import losses as GL
    from mrhash_tpu_torch.gs.container import _cam_dict
    from mrhash_tpu_torch.ops import camera as C

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gw = make_gs_wrapper(device, rows, cols)
    gc = gw.gs_container
    gs_ms = []
    run_gs = gc.run_gs

    def timed_run_gs(*a, **kw):
        sync()
        t0 = time.perf_counter()
        run_gs(*a, **kw)
        sync()
        gs_ms.append((time.perf_counter() - t0) * 1e3)
    gc.run_gs = timed_run_gs

    def view(f):
        cam = C.with_pose(gw.camera, f["rot"], f["trans"])
        return cam, torch.from_numpy(f["rgb"]).to(device)

    def psnr(f):
        cam, gt_u8 = view(f)
        gt = gt_u8.to(torch.float32).permute(2, 0, 1) / 255.0
        return float(GL.psnr(gc.render_view(cam), gt.clamp(0.0, 1.0)))

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launches("blend_forward", "blend_backward",
                   "fused_integrate_rows")
    for f in train:
        feed_gs(gw, f)
    seeded = gc.model.count
    cam1, gt1 = view(train[1])
    cd1 = _cam_dict(cam1)
    gc.train_steps([(cd1, gt1)])          # warm-up, as tools/bench_gs.py
    sync()
    t0 = time.perf_counter()
    gc.train_steps([(cd1, gt1)] * train_iters)
    sync()
    iter_ms = (time.perf_counter() - t0) * 1e3 / train_iters
    psnr0 = dict(train=psnr(train[1]), holdout=psnr(holdout))
    if not gc.keyframes:
        gc.keyframes = [(_cam_dict(view(f)[0]), view(f)[1]) for f in train]
    t0 = time.perf_counter()
    gw.GSFinalOpt()
    sync()
    final_s = time.perf_counter() - t0
    psnr1 = dict(train=psnr(train[1]), holdout=psnr(holdout))
    with tempfile.TemporaryDirectory() as tmp:
        gw.GSSavePointCloud(tmp)
        gc.model.wait_ply()
        files = os.listdir(tmp)
        with open(os.path.join(tmp, files[0]), "rb") as fh:
            head = fh.read(300)
    assert len(files) == 1 and (f"element vertex {gc.model.count}".encode()
                                in head), (files, head[:60])

    n4, n5 = COUNTS["blend_forward"], COUNTS["blend_backward"]
    for f in more:
        feed_gs(gw, f)
    sync()
    per_frame = dict(
        blend_forward=(COUNTS["blend_forward"] - n4) / len(more),
        blend_backward=(COUNTS["blend_backward"] - n5) / len(more))
    launches = launch_counts("blend_forward", "blend_backward")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steady = gs_ms[-len(more):]
    log(f"gs: {len(train) + len(more)} frames; Gaussians {seeded} after "
        f"the training frames, {gc.model.count} after all; keyframes "
        f"{len(gc.keyframes)}; launches {launches}, per frame of the pan "
        f"{per_frame}; K1 launches {COUNTS['fused_integrate_rows']}")
    log(f"gs: GS frame (run_gs) over frames 2-{1 + len(more)}: median "
        f"{statistics.median(steady):.3f} ms, mean "
        f"{statistics.fmean(steady):.3f} ms; training frames "
        f"{gs_ms[0]:.1f} / {gs_ms[1]:.1f} ms")
    log(f"gs: {iter_ms:.3f} ms per Adam iteration ({train_iters} on frame "
        f"1); GSFinalOpt {final_s:.2f} s")
    log(f"gs: PSNR train {psnr0['train']:.2f} dB, holdout "
        f"{psnr0['holdout']:.2f} dB; after GSFinalOpt train "
        f"{psnr1['train']:.2f} dB, holdout {psnr1['holdout']:.2f} dB "
        f"(tools/bench_gs.py bar: {GS_PSNR_REF})")
    n_tiles = ((rows + 15) // 16) * ((cols + 15) // 16)
    log(f"gs: peak device memory {peak / 2**30:.3f} GiB; the blend mask a "
        f"render keeps for its backward: {n_tiles * GS_K * 32 / 1e6:.1f} MB "
        f"at K = {GS_K}, {n_tiles * GS_FINAL_K * 32 / 1e6:.1f} MB at K = "
        f"{GS_FINAL_K} (in an i8 layout: "
        f"{n_tiles * GS_K * 256 / 1e6:.1f} / "
        f"{n_tiles * GS_FINAL_K * 256 / 1e6:.1f} MB)")
    n_k1 = COUNTS["fused_integrate_rows"]
    assert n_k1 == len(train) + len(more), n_k1
    assert per_frame["blend_forward"] >= 1 and per_frame[
        "blend_backward"] >= 1, per_frame
    assert all(np.isfinite(v) for v in (*psnr0.values(), *psnr1.values()))
    if cuda:
        for k, ref in GS_PSNR_REF.items():
            assert psnr0[k] >= ref - 1.0, (k, psnr0[k], ref)
    return launches, dict(median_ms=statistics.median(steady),
                          mean_ms=statistics.fmean(steady), iter_ms=iter_ms,
                          psnr=psnr0, psnr_final=psnr1, per_frame=per_frame,
                          gaussians=gc.model.count, peak_gib=peak / 2**30)


# ---------------------------------------------------------------------------
# phase 10: the device mesh sweep
# ---------------------------------------------------------------------------

MESH_MATCH_S = 60.0     # the 9-D match of non-twins: seconds before it stops


@contextlib.contextmanager
def recording(obj, name):
    """Record every return value of obj.<name> while the block runs."""
    calls, orig, own = [], getattr(obj, name), name in vars(obj)

    def rec(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out)
        return out

    setattr(obj, name, rec)
    try:
        yield calls
    finally:
        if own:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)


def cat_tris(parts):
    """(tri_pos, tri_col) of a list of such pairs, concatenated."""
    import numpy as np
    return (np.concatenate([p for p, _ in parts]),
            np.concatenate([c for _, c in parts]))


def match_triangles(got, want, name, budget_s=None, k=8):
    """The triangles of `got` against those of `want`, each (9 vertex
    coordinates, 9 colour channels; vertex order within a triangle is the
    same in both sweeps): counts equal; then the exact twins, bit for bit,
    paired copy for copy (a sweep may emit one triangle more than once);
    then each remaining triangle of `got` to its own one of the remaining
    `want` in 9-D, the nearest of k not yet taken, with positions within
    1e-3 and colours within 0.5 (tests/test_meshing.py:171-181's bound).
    With budget_s, the remaining ones are queried in chunks of 200,000 in
    a seeded order until budget_s has passed.  Where one finds no match,
    the check fails and names a few.  Returns dict(n, exact, near,
    checked, max_pos, max_col, s)."""
    import numpy as np
    from scipy.spatial import cKDTree
    t0 = time.perf_counter()
    rows = [np.concatenate([p.reshape(-1, 9), c.reshape(-1, 9)], axis=1)
            .astype(np.float32) for p, c in (got, want)]
    n = rows[0].shape[0]
    assert rows[1].shape[0] == n and n > 0, (rows[0].shape, rows[1].shape)
    void = np.dtype((np.void, 18 * 4))
    both = np.concatenate([np.ascontiguousarray(r).view(void).ravel()
                           for r in rows])
    uniq, inv = np.unique(both, return_inverse=True)
    inv = inv.ravel()
    cg = np.bincount(inv[:n], minlength=uniq.size)
    cw = np.bincount(inv[n:], minlength=uniq.size)
    twins = np.minimum(cg, cw)
    vals = uniq.view(np.float32).reshape(-1, 18)
    rest_g = vals[np.repeat(np.arange(uniq.size), cg - twins)]
    rest_w = vals[np.repeat(np.arange(uniq.size), cw - twins)]
    out = dict(n=n, exact=int(twins.sum()), near=rest_g.shape[0], checked=n,
               max_pos=0.0, max_col=0.0)
    if rest_g.shape[0]:
        tree = cKDTree(rest_w[:, :9].astype(np.float64))
        order = np.random.default_rng(0).permutation(rest_g.shape[0])
        taken = np.zeros(rest_w.shape[0], bool)
        out["checked"] = out["exact"]
        for off in range(0, order.size, 200_000):
            sel = order[off:off + 200_000]
            kk = min(k, rest_w.shape[0])
            dist, idx = tree.query(rest_g[sel, :9].astype(np.float64), k=kk)
            dist, idx = dist.reshape(sel.size, kk), idx.reshape(sel.size, kk)
            assign = np.full(sel.size, -1)
            for j in range(kk):
                r = np.nonzero(assign < 0)[0]
                cand = idx[r, j]
                ok = ~taken[cand] & (dist[r, j] < 1e-3)
                cand, r = cand[ok], r[ok]
                _, first = np.unique(cand, return_index=True)
                assign[r[first]] = cand[first]
                taken[cand[first]] = True
            if (assign < 0).any():
                lost = rest_g[sel][assign < 0]
                raise AssertionError(
                    f"{name}: {lost.shape[0]} triangles without their own "
                    f"match within 1e-3 ({rest_g.shape[0]} not exact "
                    f"twins); the first, pos + col: {lost[:3].tolist()}; "
                    f"unmatched of the other sweep: "
                    f"{rest_w[~taken][:3].tolist()}")
            d = np.abs(rest_g[sel] - rest_w[assign])
            out["max_pos"] = max(out["max_pos"], float(d[:, :9].max()))
            out["max_col"] = max(out["max_col"], float(d[:, 9:].max()))
            out["checked"] += sel.size
            if budget_s is not None and time.perf_counter() - t0 > budget_s:
                break
    assert out["max_col"] < 0.5, out
    out["s"] = time.perf_counter() - t0
    return out


def device_sweep(gw, cuda=True):
    """extractMesh through the device sweep (MRHASH_HOST_MESH=0, the
    reference's switch): seconds, the sweep's figures (phases, windows,
    gated cells, batches, dropped blocks), peak device memory and the
    mesh's counts; and the raw triangles, as the sweep returned them."""
    import torch
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    os.environ["MRHASH_HOST_MESH"] = "0"
    try:
        with recording(gw, "_extract_resident") as parts, \
                tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            gw.extractMesh(os.path.join(tmp, "mesh.ply"))
            sweep_s = time.perf_counter() - t0
    finally:
        del os.environ["MRHASH_HOST_MESH"]
    tris = cat_tris(parts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return dict(s=sweep_s, peak_gib=peak / 2**30,
                triangles=tris[0].shape[0],
                vertices=gw.getVertices().shape[0],
                faces=gw.getFaces().shape[0], **gw.mesh_stats), tris


def compare_small_mesh(devices=("cpu", "cuda")):
    """Phase 3's small scenes (one resolution and multi-res), built on the
    CPU and copied to the card, meshed by the device sweep on both: the
    direct path, then after streamAllOut the chunk-batch path (a device
    budget of 480 blocks, so several batches); equal vertex and face
    counts, vertices within 1e-5.  Then the raycast of the multi-res
    scene from its first pose (96 steps of 2.4 cm) on both: hits equal,
    depth within 1e-4.  Returns the chunk batches of the multi-res
    scene."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.core.state import MapState, VoxelPool
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import hashtable as H
    from mrhash_tpu_torch.ops import raycast as R

    def to(st, dev):
        t = st.table
        table = H.HashTable(**{k: getattr(t, k).to(dev).clone() for k in (
            "pos", "ptr", "res", "fp", "heap_high", "heap_low")},
            high_count=t.high_count, low_count=t.low_count,
            num_buckets=t.num_buckets, num_blocks=t.num_blocks)
        return MapState(table=table, pool=VoxelPool(**{
            f: getattr(st.pool, f).to(dev).clone()
            for f in VoxelPool.FIELDS}), frame=st.frame)

    os.environ["MRHASH_HOST_MESH"] = "0"
    try:
        for multires in (False, True):
            cfg, st, _ = small_scene("cpu", multires)
            out = {}
            for dev in devices:
                gw = GeoWrapper(
                    sdf_truncation=cfg.sdf_truncation,
                    sdf_truncation_scale=0.0, integration_weight_sample=1,
                    virtual_voxel_size=cfg.virtual_voxel_size,
                    n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                    gs_optimization_param_path="",
                    sdf_var_threshold=cfg.sdf_var_threshold,
                    num_blocks=cfg.num_blocks, max_active_blocks=480,
                    profiling=False, device=dev)
                gw.state = to(st, dev)
                for path in ("direct", "batches"):
                    if path == "batches":
                        gw.streamAllOut()
                    with tempfile.TemporaryDirectory() as tmp:
                        gw.extractMesh(os.path.join(tmp, "m.ply"))
                    v = np.asarray(gw.getVertices(), np.float64)
                    out[dev, path] = (v[np.lexsort(v.T)],
                                      gw.getFaces().shape[0])
                batches = gw.mesh_stats
            err = 0.0
            for path in ("direct", "batches"):
                (c, cf), (g, gf) = out[devices[0], path], out[devices[1],
                                                              path]
                assert c.shape == g.shape and cf == gf, (path, c.shape,
                                                         g.shape, cf, gf)
                err = max(err, float(np.abs(c - g).max()))
                assert c.shape[0] > 10000 and err <= 1e-5, (path, err)
            assert batches["batches"] >= 2 and not batches["dropped"]
            assert not batches["over_budget"], batches
            log(f"compare device mesh cuda vs cpu (64x256 "
                f"{'multi-res' if multires else 'single-res'}, "
                f"{int((st.table.ptr != H.FREE).sum())} blocks): direct "
                f"{out['cpu', 'direct'][0].shape[0]} vertices, chunk-batch "
                f"({batches['batches']} batches) "
                f"{out['cpu', 'batches'][0].shape[0]} vertices, equal counts, "
                f"max |diff| {err}")
    finally:
        del os.environ["MRHASH_HOST_MESH"]
    depth = {}     # the multi-res scene, the last of the loop
    for dev in devices:
        s = to(st, dev)
        d, hit = R.raycast_depth(cfg, s.table, s.pool,
                                 C.make_camera(*SMALL_CAM, device=dev),
                                 step_scale=0.4, max_steps=96)
        depth[dev] = (d.cpu().numpy(), hit.cpu().numpy())
    (dc, hc), (dg, hg) = depth[devices[0]], depth[devices[-1]]
    err = float(np.abs(dc - dg).max())
    log(f"compare raycast cuda vs cpu (64x256 multi-res): {int(hc.sum())} "
        f"of {hc.size} rays hit, hits equal {np.array_equal(hc, hg)}, max "
        f"|depth diff| {err}")
    assert np.array_equal(hc, hg) and hc.mean() > 0.5, hc.mean()
    assert err <= 1e-4, err
    return batches["batches"]


def run_viewer(depths, rgb, n=ORBIT, device="cuda"):
    """Phase 4's wrapper with viewer_active over the first n frames of the
    orbit: frames/s with the background ticks, then one more frame whose
    tick must give the mesh of _extract_resident of the map that frame
    left; and the sweep of that map under torch.profiler: launches and
    host syncs per cell batch.  Returns the numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mrhash_tpu_torch.core import mesh_post

    cuda = device == "cuda"
    gw = make_wrapper(device, viewer=True)
    try:
        frame_ms = []
        with recording(gw, "_resident_snapshot") as ticks:
            for i in range(n):
                t0 = time.perf_counter()
                feed(gw, i, depths, rgb)
                if cuda:
                    torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            n_ticks = len(ticks)
            gw.getViewerMesh()
            feed(gw, n, depths, rgb)
            assert len(ticks) == n_ticks + 1
        t0 = time.perf_counter()
        want = gw._extract_resident()
        sweep_s = time.perf_counter() - t0
        mesh = gw.getViewerMesh()
        assert gw.viewer_mesh_frame == gw.state.frame
        ref = mesh_post.MeshAccumulator()
        ref.add_triangles(*want)
        assert mesh.vertices.shape[0] > 10000, mesh.vertices.shape
        assert np.array_equal(mesh.vertices, ref.vertices)
        assert np.array_equal(mesh.faces, ref.faces)
        assert np.array_equal(mesh.colors, ref.colors)
        stats = {}
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            again = gw._extract_resident(stats=stats)
            if cuda:
                torch.cuda.synchronize()
        assert np.array_equal(again[0], want[0])
        count = {e.key: e.count for e in prof.key_averages()}
        launches = sum(count.get(k, 0) for k in ("cudaLaunchKernel",
                                                 "cudaLaunchKernelExC"))
        syncs = sum(c for k, c in count.items() if "Synchronize" in k)
        blocks = int((gw.state.table.ptr != -2).sum())
    finally:
        gw.close()
    fps = n / (sum(frame_ms) / 1e3)
    steady = frame_ms[1:]
    out = dict(fps=fps, median_ms=statistics.median(steady), ticks=n_ticks,
               blocks=blocks, vertices=mesh.vertices.shape[0],
               sweep_s=sweep_s, windows=stats["windows"],
               cells=stats["cells"], cell_batches=stats["cell_batches"],
               launches_per_batch=launches / stats["cell_batches"],
               syncs_per_batch=syncs / stats["cell_batches"])
    log(f"viewer: {n} frames at {fps:.2f} FPS (median "
        f"{out['median_ms']:.3f} ms) with {n_ticks} background ticks; "
        f"frame {gw.state.frame}'s tick: {mesh.vertices.shape[0]} vertices "
        f"of {blocks} resident blocks, equal to _extract_resident of that "
        f"map ({sweep_s:.2f} s, {stats['cells']} gated cells in "
        f"{stats['cell_batches']} batches of {stats['windows']} windows; "
        f"profiled: {out['launches_per_batch']:.1f} launches and "
        f"{out['syncs_per_batch']:.1f} host syncs per batch)")
    return out


def run_device_mesh(cases, smi, cuda=True):
    """Phase 10 on phases 7's and 9's maps, whose host sweeps ran first and
    which then lay all in their host grids: each grid handed to a fresh
    wrapper of its phase (`make`, whose device map is empty, as the
    phase's own after streamAllOut), the device sweep (the chunk-batch
    path), its triangles against the host sweep's, and on the walk equal
    vertex, face and triangle counts, no block dropped, no batch over
    budget, and the on-wall share.  cases: (name, make, grid, the host
    sweep's recorded (tri_pos, tri_col) calls, the phase's numbers).
    Returns the figures per map."""
    import torch
    out = {}
    for name, make, grid, host, run in cases:
        gw = make()
        gw.streamer.grid = grid
        rec, tris = device_sweep(gw, cuda)
        if cuda:
            torch.cuda.empty_cache()
        host_tris = cat_tris(host)
        m = match_triangles(tris, host_tris, name, budget_s=MESH_MATCH_S)
        assert rec["dropped"] == 0 and rec["over_budget"] == 0, rec
        rec.update(host_sweep_s=run["extract_s" if name == "multires" else
                                     "mesh_s"],
                   host_triangles=host_tris[0].shape[0],
                   host_vertices=run["vertices"], host_faces=run["faces"],
                   match=m)
        if name == "walk":
            assert (rec["vertices"], rec["faces"]) == (
                run["vertices"], run["faces"]), rec
            on = float(on_tube_wall(gw.getVertices()).mean())
            assert on > 0.95, on
            rec["on_wall"] = on
        del gw
        out[name] = rec
        phases = " ".join(f"{k} {rec[k]:.2f} s" for k in (
            "out_s", "insert_s", "extract_s", "clear_s", "host_s"))
        log(f"device mesh {name}: {rec['s']:.1f} s against the host sweep's "
            f"{rec['host_sweep_s']:.1f} s; phases {phases}; {rec['batches']} "
            f"chunk batches, {rec['windows']} windows, {rec['cells']} gated "
            f"cells in {rec['cell_batches']} cell batches; "
            f"{rec['triangles']} triangles (host {rec['host_triangles']}), "
            f"{rec['vertices']} vertices, {rec['faces']} faces (host "
            f"{rec['host_vertices']}, {rec['host_faces']}); peak "
            f"{rec['peak_gib']:.3f} GiB [{smi}]")
        what = ("all" if m["checked"] == m["n"] else
                f"a seeded sample of the rest: the match stops after "
                f"{MESH_MATCH_S:.0f} s")
        log(f"device mesh {name}: {m['checked']} of {m['n']} triangles "
            f"matched to the host sweep's one to one ({m['exact']} exact "
            f"twins, bit for bit; {m['near']} others in 9-D, {what}; "
            f"{m['s']:.1f} s), max |pos| {m['max_pos']:.3g}, max |col| "
            f"{m['max_col']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 12: quality and the API
# ---------------------------------------------------------------------------

Q_FRAMES, Q_POINTS = 40, 2_000_000   # the quality protocol's Replica preset
Q_GATES = dict(box=dict(chamfer=0.010, fscore=0.99),
               clutter=dict(fscore=0.82, precision=0.95))
Q_STARVE = 10                        # (c): setNFramesInvalidateVoxels(10)


def compare_small_quality():
    """apps/quality_eval.py's small box preset (120x160, 5 cm voxels, 12
    frames, extractMesh's host sweep) on the card and on the CPU, where
    tests/test_torch_quality.py holds it against the JAX package: every
    metric row within 1e-4 and the vertex counts equal."""
    from mrhash_tpu_torch.apps import quality_eval as Q
    rows, stats = {}, {}
    for dev in ("cpu", "cuda"):
        stats[dev] = {}
        rows[dev] = Q.run_quality(frames=12, res="small",
                                  n_eval_points=100_000, device=dev,
                                  stats=stats[dev])
    vc, vg = stats["cpu"]["vertices"], stats["cuda"]["vertices"]
    assert vc == vg, (vc, vg)
    err = max(abs(c[k] - g[k]) for c, g in zip(rows["cpu"], rows["cuda"])
              for k in c)
    r5 = rows["cuda"][0]
    log(f"compare quality small box cuda vs cpu (120x160, 12 frames): "
        f"{vg} vertices on both, Chamfer-L1@5cm {r5['chamfer_l1']:.5f}, "
        f"F@5cm {r5['fscore']:.5f}, max |row diff| {err:.3g}")
    assert err <= 1e-4, err
    return dict(vertices=vg, max_row_diff=err, chamfer_l1=r5["chamfer_l1"],
                fscore=r5["fscore"])


def setter_scene(dev):
    """Phase 3's setter sequence on `dev`: a GeoWrapper at phase 3's small
    scene settings (64x256, 2 cm voxels, 2^11 blocks, starvation every 2
    frames) takes 3 frames of the relief, setVirtualVoxelSize(0.03), 3
    frames, setNumSdfBlocks(2^12), setVoxelExtentsScale(2) and
    setNFramesInvalidateVoxels(0), 3 frames.  Returns the map in the host
    layout after frame 5 and after frame 8, and each frame's stats.  With
    voxel extents of 2 the block transform maps a point to a block of
    twice the size (the JAX package's, ROADMAP C17), so no voxel of the
    last frames' blocks is observed near the surface and GC would free
    them all: starvation, and with it GC, is off for those frames."""
    import numpy as np

    from mrhash_tpu_torch.geowrapper import GeoWrapper
    rows, cols = SMALL_CAM[4], SMALL_CAM[5]
    gw = GeoWrapper(sdf_truncation=0.06, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.02,
                    n_frames_invalidate_voxels=2, voxel_extents_scale=1,
                    gs_optimization_param_path="", num_blocks=1 << 11,
                    max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
                    profiling=False, device=dev)
    gw.setCamera(*SMALL_CAM)
    rng = np.random.default_rng(0)
    r = np.arange(rows, dtype=np.float32)[:, None]
    c = np.arange(cols, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
    maps, stats = [], []
    for i in range(9):
        if i == 3:
            gw.setVirtualVoxelSize(0.03)
        if i == 6:
            maps.append(host_map(gw.state, gw.cfg))
            gw.setNumSdfBlocks(1 << 12)
            gw.setVoxelExtentsScale(2)
            gw.setNFramesInvalidateVoxels(0)
        gw.setCurrPose([0.03 * i, 0.01 * i, 0.0], [0.0, 0.0, 0.0, 1.0])
        gw.setDepthImage((base + rng.normal(0, 0.01, base.shape)
                          ).astype(np.float32))
        gw.setRGBImage(rgb)
        gw.compute()
        stats.append(dict(gw.last_stats))
    assert gw.state.frame == 3 and gw.cfg.num_blocks == 1 << 12
    maps.append(host_map(gw.state, gw.cfg))
    gw.close()
    return maps, stats


def compare_small_setters():
    """The setter sequence on the card against the same on the CPU (where
    tests/test_torch_api.py holds a rebuild against the JAX package): the
    same stats after every frame (host_syncs aside); after frame 5 and
    after frame 8 the same key set, weight and rgbp equal, sdf within
    2e-5, sumsq within 5e-4, over more than 10,000 weighted voxels."""
    import numpy as np
    (mc, sc), (mg, sg) = setter_scene("cpu"), setter_scene("cuda")
    # host_syncs and coarsen_syncs count the sync sites of each device's
    # own path: the card's allocation runs kernels K7-K9 with one host read
    # a round, its coarsening K10-K12 with two
    sc, sg = ([{k: v for k, v in st.items()
                if k not in ("host_syncs", "coarsen_syncs")}
               for st in stats] for stats in (sc, sg))
    assert sc == sg, (sc, sg)
    seen = []
    for (pc, rc, c), (pg, rg, g) in zip(mc, mg):
        assert np.array_equal(pc, pg), "block key sets differ"
        assert np.array_equal(rc, rg)
        assert np.array_equal(c["weight"], g["weight"])
        upd = c["weight"] > 0
        assert int(upd.sum()) > 10000, int(upd.sum())
        assert np.array_equal(c["rgbp"][upd], g["rgbp"][upd])
        err = {f: float(np.abs(c[f][upd] - g[f][upd]).max())
               for f in ("sdf", "sumsq")}
        seen.append((len(pc), int(upd.sum()), err))
    log(f"compare setter sequence cuda vs cpu (64x256, 3 + 3 + 3 frames "
        f"around setVirtualVoxelSize, setNumSdfBlocks, setVoxelExtentsScale "
        f"and setNFramesInvalidateVoxels): the same stats on all 9 frames "
        f"(window {[s['occupied_blocks'] for s in sg]}); after frames 5 and "
        f"8 (blocks, weighted voxels, max |diff|): {seen}")
    assert all(e[f] <= TOL[f] for *_, e in seen for f in e), seen


def quality_run(scene, multires, smi):
    """Phase 12 (a) or (b): apps/quality_eval.run_quality at the Replica
    preset on the card (40 frames, extractMesh's host sweep, 2M GT
    points), with K1's and K2's launches over the frames, extractMesh and
    the eval, and the peak device memory.  Returns its record."""
    import torch

    from mrhash_tpu_torch.apps import quality_eval as Q
    tag = f"quality {scene}{' multi-res' if multires else ''}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_launches(*K1_NAMES)
    rows = Q.run_quality(frames=Q_FRAMES, res="replica",
                         n_eval_points=Q_POINTS, scene=scene,
                         multires=multires, device="cuda", stats=stats)
    launches = launch_counts(*K1_NAMES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r5 = next(r for r in rows if r["threshold"] == 0.05)
    for what, key in (("frames", "frames_s"), ("scene (host)", "scene_s"),
                      ("mesh (extractMesh, host sweep)", "mesh_s"),
                      ("PLY read", "read_s"), ("eval", "eval_s")):
        log(f"{tag}: {what} {stats[key]:.2f} s [{smi}]")
    log(f"{tag}: {stats['vertices']} vertices, {stats['faces']} faces, "
        f"{stats['gt_points']} GT points observed, occupied "
        f"{stats['occupied']} blocks in the last window, launches "
        f"{launches}, peak {peak:.3f} GiB [{smi}]")
    log(f"{tag}: @5cm Chamfer-L1 {r5['chamfer_l1']:.5f} m, accuracy "
        f"{r5['accuracy_mae']:.5f}, completeness {r5['completeness_mae']:.5f}"
        f", P {r5['precision']:.5f}, R {r5['recall']:.5f}, F "
        f"{r5['fscore']:.5f} [{smi}]")
    assert launches["fused_integrate_rows"] >= 1, launches
    assert launches["sample_image"] == 0, launches
    gates = Q_GATES[scene]
    if scene == "box":
        assert launches["fused_integrate_rows"] == Q_FRAMES, launches
        assert launches["fused_integrate_rows_res1"] == 0, launches
        assert r5["chamfer_l1"] < gates["chamfer"], r5
        assert r5["fscore"] > gates["fscore"], r5
    else:
        diag = stats["recall_miss_diag"]
        log(f"{tag}: recall misses {diag} [{smi}]")
        assert launches["fused_integrate_rows_res1"] > 0, launches
        assert diag["res1_blocks"] > 0, diag
        assert r5["fscore"] >= gates["fscore"], r5
        assert r5["precision"] >= gates["precision"], r5
    return dict(metrics_5cm=r5, launches=launches, peak_gib=peak, **stats)


def run_starve_setter(depths, rgb, smi):
    """Phase 12 (c), first half: phase 4's wrapper built with
    n_frames_invalidate_voxels=0 takes one frame, then
    setNFramesInvalidateVoxels(Q_STARVE) and 30 frames of phase 4's orbit
    (frames 1-30): starvation fires on frames 10, 20 and 30, so K2
    launches exactly 3 times over those 30 frames."""
    import torch

    gw = make_wrapper("cuda", starve=0)
    feed(gw, 0, depths, rgb)
    gw.setNFramesInvalidateVoxels(Q_STARVE)
    torch.cuda.synchronize()
    reset_launches(*K1_NAMES)
    for i in range(1, 31):
        feed(gw, i, depths, rgb)
    torch.cuda.synchronize()
    launches = launch_counts("fused_integrate_rows", "sample_image")
    gw.close()
    log(f"setters: setNFramesInvalidateVoxels({Q_STARVE}) after frame 0, "
        f"30 more frames: launches {launches} [{smi}]")
    assert launches == {"fused_integrate_rows": 30, "sample_image": 3}, \
        launches
    return launches


def setter_walk(depths, rgb, at=None):
    """Phase 12 (c), second half: phase 9's walk until a stream-out is
    issued whose job is still in flight when compute() returns, then
    setMaxNumSdfBlockIntegrateFromGlobalHash (the old Streamer's grid
    handed over); on until the next such stream-out, then a rebuild
    (setNumSdfBlocks).  With `at` (the frame counts of such a run) the
    walk stops at those frames and joins the stream-out before each call:
    the run to compare with.  Returns the grid's blocks after each call,
    whether the job was in flight at it, and the frame counts."""
    import torch
    gw = make_walk_wrapper("cuda")
    grids, busy, frames, i = [], [], [], 0
    for step in range(2):
        while True:
            assert i < 1000, "no stream-out in flight within 1000 frames"
            n_ev = len(gw.streamer.out_events)
            walk_frame(gw, W_STEP * i, i, depths, rgb)
            i += 1
            event = (len(gw.streamer.out_events) > n_ev
                     and gw.streamer.out_events[-1]["blocks"] > 0)
            if at is not None:
                if i == at[step]:
                    break
            elif event and gw.streamer.busy():
                break
        busy.append(gw.streamer.busy())
        frames.append(i)
        if at is not None:
            gw.streamer.join()
        old = gw.streamer
        if step == 0:
            gw.setMaxNumSdfBlockIntegrateFromGlobalHash(old.staging)
            assert gw.streamer.grid is old.grid
        else:
            gw.setNumSdfBlocks(gw.cfg.num_blocks)
            assert gw.streamer.grid.num_blocks() == 0
        torch.cuda.synchronize()    # a CUDA error of the copy shows here
        grids.append(host_grid(old.grid.chunks))
    gw.close()
    return grids, busy, frames


def run_rebuild_in_flight(smi):
    """Phase 12 (c), second half: the walk with the setters called while
    a stream-out is in flight, against the walk that joined first at the
    same frames: the same grid content after each call, no CUDA error,
    and no thread left once both wrappers are closed."""
    import threading

    import numpy as np
    threads = threading.active_count()
    depths = walk_depths()
    rgb = np.random.default_rng(1).integers(0, 255, (ROWS, COLS, 3)
                                            ).astype(np.uint8)
    t0 = time.perf_counter()
    ga, busy, frames = setter_walk(depths, rgb)
    gb, _, frames_b = setter_walk(depths, rgb, frames)
    assert frames == frames_b, (frames, frames_b)
    for a, b in zip(ga, gb):
        for k in ("pos", "res", "w", "rgb", "sdf", "ssq"):
            assert np.array_equal(a[k], b[k]), k
    left = threading.active_count() - threads
    log(f"setters: the walk's stream-out in flight ({busy}) at "
        f"setMaxNumSdfBlockIntegrateFromGlobalHash and at setNumSdfBlocks "
        f"(after frames {frames}): grids of {[len(g['pos']) for g in ga]} "
        f"blocks equal to the run that joined first, threads left {left}, "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    assert all(busy), busy
    assert left == 0, left
    return dict(frames=frames, grid_blocks=[len(g["pos"]) for g in ga],
                in_flight=busy, threads_left=left)


def run_memory_report(smi):
    """Phase 12 (d): a GeoWrapper at the Replica preset (2^19 blocks)
    built in a temporary directory: its memory report's device total
    equals the state's tensors' nbytes, and torch.cuda.memory_allocated()
    rises by that within 1 %; then setHashNumBuckets(2^15), whose peak
    must stay near one state (the old one is released first)."""
    import torch

    from mrhash_tpu_torch.apps import quality_eval as Q
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    rows, cols, fx, vvs, trunc, num_blocks = Q.PRESETS["replica"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        gw = GeoWrapper(sdf_truncation=trunc, sdf_truncation_scale=0.0,
                        integration_weight_sample=1, virtual_voxel_size=vvs,
                        n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                        gs_optimization_param_path="", num_blocks=num_blocks,
                        profiling=False, device="cuda")
        with open("memory_allocation.txt") as f:
            report = f.read().splitlines()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    st = gw.state
    tensors = [st.table.pos, st.table.ptr, st.table.res, st.table.fp,
               st.table.heap_high, st.table.heap_low,
               *(getattr(st.pool, f) for f in st.pool.FIELDS)]
    nbytes = sum(t.nbytes for t in tensors)
    del st, tensors     # the rebuild must be free to release the old state
    total = int(next(line for line in report if line.startswith(
        "VoxelContainer | total d_size: ")).split()[4])
    torch.cuda.reset_peak_memory_stats()
    gw.setHashNumBuckets(1 << 15)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    after = torch.cuda.memory_allocated() - base
    gw.close()
    del gw
    torch.cuda.empty_cache()
    for line in report:
        log("memory report: " + line)
    log(f"memory: report {total} B, state nbytes {nbytes} B, "
        f"memory_allocated grew {grown} B ({grown / nbytes - 1:+.4%}); "
        f"setHashNumBuckets(2^15): peak {peak} B over the start, {after} B "
        f"after [{smi}]")
    assert total == nbytes, (total, nbytes)
    assert abs(grown - nbytes) <= 0.01 * nbytes, (grown, nbytes)
    assert peak <= 1.01 * grown, (peak, grown)
    return dict(report_bytes=total, nbytes=nbytes, allocated_growth=grown,
                rebuild_peak=peak, after_rebuild=after)


# ---------------------------------------------------------------------------
# phase 13: the sharded steps (mrhash_tpu_torch/parallel), one process per
# rank through the port's launcher
# ---------------------------------------------------------------------------

S_FRAMES = 40                   # frames (scans) per full-width run
S_STARVE, S_L_STARVE = 20, 10   # starve periods: K2 once / three times
S_TIMEOUT = 300                 # the launcher's deadline per call, seconds
S_TIMED = 10                    # frames/s over frames 10-39


def map_by_key(st):
    """A map's blocks sorted by key, on its device: (key codes i64[K], res
    i32[K], {field: [K,512]} in the host layout, a res-1 block's voxels at
    lanes [0, 64) and zeros beyond)."""
    import torch

    from mrhash_tpu_torch.core.streaming import gather_blocks
    t = st.table
    slots = torch.nonzero(t.ptr != -2).flatten()
    code = key_codes(t.pos[slots])
    order = torch.argsort(code)
    s = slots[order]
    fields = gather_blocks(st.pool, t.ptr[s], t.res[s])
    return code[order], t.res[s], dict(zip(("sdf", "sumsq", "weight",
                                            "rgbp"), fields))


def key_codes(pos):
    """One int64 per block key (each coordinate offset by 2^20, 21 bits)."""
    import torch
    p = pos.to(torch.int64) + (1 << 20)
    return (p[:, 0] << 42) | (p[:, 1] << 21) | p[:, 2]


def compare_maps(a, b, lidar=False):
    """Two map_by_key maps: keys and resolutions equal; RGB-D: weight and
    rgbp exact, sdf within 2e-5 and sumsq within 5e-4 where weighted;
    lidar: P15's bound, weight flips plus sdf differences beyond 2e-3
    within max(16, 1e-4 lanes).  Returns (blocks, weighted voxels,
    figures)."""
    import torch
    ka, ra, fa = a
    kb, rb = (t.to(ka.device) for t in b[:2])
    fb = {f: v.to(ka.device) for f, v in b[2].items()}
    assert torch.equal(ka, kb), (ka.numel(), kb.numel())
    assert torch.equal(ra, rb), "block resolutions differ"
    upd = fa["weight"] > 0
    n_w = int(upd.sum())
    if lidar:
        flips = int((fa["weight"] != fb["weight"]).sum())
        both = upd & (fb["weight"] > 0)
        far = int(((fa["sdf"] - fb["sdf"]).abs() > 2e-3)[both].sum())
        bound_n = max(16, int(fa["weight"].numel() * 1e-4))
        assert flips + far <= bound_n, (flips, far, bound_n)
        return ka.numel(), n_w, dict(flips=flips, sdf_far=far)
    assert torch.equal(fa["weight"], fb["weight"]), "weights differ"
    assert torch.equal(fa["rgbp"][upd], fb["rgbp"][upd]), "colours differ"
    err = {f: float((fa[f] - fb[f]).abs()[upd].max()) if n_w else 0.0
           for f in ("sdf", "sumsq")}
    assert all(err[f] <= TOL[f] for f in err), err
    return ka.numel(), n_w, err


def shard_small(group):
    """(a) card = CPU: phase 3's small multi-res RGB-D scene (starving every
    2 frames) and its small LiDAR scene (starving every 2 scans), each
    sharded on this rank's card and on the CPU; this rank's two maps
    compared by key."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.parallel import sharding as S

    eye = np.eye(3, dtype=np.float32)
    out = {}
    cfg, frames, rgb = small_inputs(multires=True)
    maps = []
    for dev in (group.device, torch.device("cpu")):
        st = S.make_sharded_state(cfg, group.rank, group.size, dev)
        step = S.sharded_integrate_rgbd(cfg, group)
        cam0 = C.make_camera(*SMALL_CAM, device=dev)
        for d, t in frames:
            st, _ = step(st, C.with_pose(cam0, eye, t),
                         torch.from_numpy(d).to(dev),
                         torch.from_numpy(rgb).to(dev))
        maps.append(map_by_key(st))
    n, n_w, err = compare_maps(maps[1], maps[0])
    n1 = int(maps[1][1].sum())
    out["rgbd"] = dict(blocks=n, res1=n1, weighted=n_w, **err)

    cfg, poses, scans, cam_args = small_lidar_inputs(n_starve=2)
    maps = []
    for dev in (group.device, torch.device("cpu")):
        st = S.make_sharded_state(cfg, group.rank, group.size, dev)
        step = S.sharded_integrate_points(cfg, group)
        cam0 = C.make_camera(*cam_args, device=dev)
        for t, pts in zip(poses, scans):
            st, _ = step(st, C.with_pose(cam0, eye, t),
                         torch.from_numpy(pts).to(dev))
        maps.append(map_by_key(st))
    n, n_w, figs = compare_maps(maps[1], maps[0], lidar=True)
    out["lidar"] = dict(blocks=n, weighted=n_w, **figs)
    return out


def rgbd_config():
    """make_wrapper("cuda", multires=True)'s MapConfig (phase 7), starving
    every S_STARVE frames."""
    from mrhash_tpu_torch.core.state import MapConfig
    return MapConfig(alloc_tile=4, virtual_voxel_size=0.01,
                     sdf_truncation=0.07, max_integration_distance=30.0,
                     n_frames_invalidate_voxels=S_STARVE,
                     sdf_var_threshold=MR_THRESHOLD, min_weight_threshold=5,
                     num_blocks=1 << 19, num_buckets=1 << 15,
                     max_active_blocks=1 << 17, max_alloc_per_frame=1 << 13)


def lidar_config():
    """make_lidar_wrapper(..., multires=True)'s MapConfig (phase 8),
    starving every S_L_STARVE scans."""
    from mrhash_tpu_torch.core.state import MapConfig
    return MapConfig(alloc_tile=4, virtual_voxel_size=0.20,
                     sdf_truncation=0.40, max_integration_distance=100.0,
                     n_frames_invalidate_voxels=S_L_STARVE,
                     sdf_var_threshold=MR_THRESHOLD, min_weight_threshold=5,
                     num_blocks=1 << 18, num_buckets=1 << 16,
                     max_active_blocks=1 << 17, max_alloc_per_frame=1 << 13,
                     max_coarsen_per_frame=1 << 9)


def shard_invariants(group, st, lcfg):
    """Every occupied key on owner_of(key) (this rank) and on no other
    rank; occupied + free = the local capacity (a res-1 block and a free
    low id an eighth of a block).  Returns (this rank's occupied, res-1
    blocks, every rank's key codes on rank 0 else None)."""
    import torch

    from mrhash_tpu_torch.parallel import sharding as S
    t = st.table
    occ = t.ptr != -2
    n0 = int((occ & (t.res == 0)).sum())
    n1 = int((occ & (t.res == 1)).sum())
    assert 8 * (t.high_count + n0) + t.low_count + n1 \
        == 8 * lcfg.num_blocks, (t.high_count, n0, t.low_count, n1)
    keys = t.pos[occ]
    assert bool((S.owner_of(keys, group.size) == group.rank).all()), \
        "a key on a rank that does not own it"
    codes = group.gather_object(key_codes(keys).cpu().numpy())
    if codes is not None:
        import numpy as np
        allc = np.concatenate(codes)
        assert np.unique(allc).size == allc.size, "a key on two ranks"
        codes = allc
    return n0 + n1, n1, codes


def shard_run(group, kind, inputs):
    """(b) or (c): S_FRAMES frames of phase 7's RGB-D orbit or phase 8's
    LiDAR drive through this rank's sharded step at full width, then the
    invariants, the launch counts and the sharded mesh.  At n = 1 the
    RGB-D map after frame S_STARVE - 1 is held against the single-process
    pipeline's (run first, its launches not counted)."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import make_state
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.parallel import sharding as S

    dev, n = group.device, group.size
    rgbd = kind == "rgbd"
    eye = np.eye(3, dtype=np.float32)
    if rgbd:
        cfg = rgbd_config()
        depths = np.load(inputs["depths"], mmap_mode="r")
        rgb = torch.from_numpy(np.load(inputs["rgb"])).to(dev)
        cam0 = C.make_camera(FX, FY, CX, CY, ROWS, COLS, 0.01, 30.0,
                             device=dev)

        def frame(i):
            rot, trans, _ = orbit_pose(i)
            return (C.with_pose(cam0, rot, trans),
                    torch.from_numpy(np.array(depths[i % ORBIT])).to(dev),
                    rgb)
    else:
        from mrhash_tpu_torch.apps.utils.camera import \
            calculate_spherical_intrinsics
        cfg = lidar_config()
        clouds = np.load(inputs["clouds"], mmap_mode="r")
        c0 = np.array(clouds[0])
        K = calculate_spherical_intrinsics(c0[(c0 != 0).any(axis=1)],
                                           L_ROWS, L_COLS)[0]
        cam0 = C.make_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], L_ROWS,
                             L_COLS, 0.2, 100.0, C.SPHERICAL, device=dev)

        def frame(i):
            return (C.with_pose(cam0, eye, lidar_pose(i)),
                    torch.from_numpy(np.array(clouds[i])).to(dev))
    lcfg = S.local_config(cfg, n)
    out = {}
    single = None
    if rgbd and n == 1:
        ref = make_state(cfg.num_blocks, device=dev)
        for i in range(S_STARVE):
            ref, _ = pipeline.integrate_rgbd(cfg, ref, *frame(i))
        single = map_by_key(ref)
        del ref

    st = S.make_sharded_state(cfg, group.rank, n, dev)
    step = (S.sharded_integrate_rgbd if rgbd
            else S.sharded_integrate_points)(cfg, group)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(*K1_NAMES, *K3_NAMES)
    group.timed, group.comm_s = True, 0.0
    ms, comm = [], []
    for i in range(S_FRAMES):
        args = frame(i)
        c0, t0 = group.comm_s, time.perf_counter()
        st, stats = step(st, *args)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append((group.comm_s - c0) * 1e3)
        if single is not None and i == S_STARVE - 1:
            blocks, n_w, err = compare_maps(map_by_key(st), single)
            out["single"] = dict(frame=i, blocks=blocks, weighted=n_w, **err)
            single = None
    group.timed = False
    launches = launch_counts(*K1_NAMES[:2], *K3_NAMES, "sample_image")
    k = ("fused_integrate_rows" if rgbd else "fused_integrate_points_rows")
    assert launches[k] >= 1 and launches[k + "_res1"] >= 1, launches
    assert launches["sample_image"] == (1 if rgbd else 3), launches
    occupied, n1, codes = shard_invariants(group, st, lcfg)
    steady = ms[S_TIMED:]
    out.update(launches=launches, occupied=occupied, res1=n1,
               capacity=lcfg.num_blocks, stats=stats,
               median_ms=statistics.median(steady),
               fps=1e3 / statistics.fmean(steady),
               comm_ms=statistics.fmean(comm[S_TIMED:]),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    if codes is not None:
        out["codes"] = codes

    geo = None
    if group.rank == 0:
        kw = dict(sdf_truncation=cfg.sdf_truncation, sdf_truncation_scale=0.0,
                  integration_weight_sample=1,
                  virtual_voxel_size=cfg.virtual_voxel_size,
                  n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                  min_weight_threshold=cfg.min_weight_threshold,
                  sdf_var_threshold=cfg.sdf_var_threshold,
                  gs_optimization_param_path="", num_blocks=1 << 10,
                  max_depth=cfg.max_integration_distance, profiling=False,
                  device=dev)
        geo = GeoWrapper(**kw)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        m = S.extract_mesh_sharded(cfg, st, geo, os.path.join(tmp, "m.ply"),
                                   group)
    if m is not None:
        v = m.vertices
        assert v.shape[0] > 10000 and np.isfinite(v).all(), v.shape
        if rgbd:
            on = float((np.abs(np.abs(v).max(axis=1) - HALF) < 0.03).mean())
        else:
            ground = np.abs(v[:, 2] - L_GROUND) < L_TOL
            wall = np.abs(np.hypot(v[:, 0], v[:, 1]) - L_WALL) < L_TOL
            on = float((ground | wall).mean())
        assert on > 0.95, on
        out.update(mesh_vertices=int(v.shape[0]), mesh_on_surface=on,
                   mesh_s=time.perf_counter() - t0)
    return out


def phase13_rank(group, parts, inputs):
    """Phase 13's rank program (parallel/launch.py::run_ranks): the parts
    in order ("small", "rgbd", "lidar"), the card's cached memory freed
    between them."""
    import torch
    out = {}
    for part in parts:
        out[part] = (shard_small(group) if part == "small"
                     else shard_run(group, part, inputs))
        torch.cuda.empty_cache()
    return out


def run_sharded(depths, rgb, clouds, smi):
    """Phase 13: the sharded steps through parallel/launch.py, two ranks
    sharing the card over gloo ((a) card = CPU on the small scenes, (b)
    RGB-D and (c) LiDAR at full width), then one rank over NCCL ((b) with
    the single-process gate, (c)).  Returns ({kernel: {"rgbd" | "lidar":
    {"n1" | "n2": [launches per rank]}}} for the kernels each run launched,
    the figures)."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.parallel import launch
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dict(depths=os.path.join(tmp, "depths.npy"),
                      rgb=os.path.join(tmp, "rgb.npy"),
                      clouds=os.path.join(tmp, "clouds.npy"))
        np.save(inputs["depths"], np.stack(depths))
        np.save(inputs["rgb"], rgb)
        np.save(inputs["clouds"], np.stack(clouds))
        for n, backend, parts in ((2, "gloo", ("small", "rgbd", "lidar")),
                                  (1, "nccl", ("rgbd", "lidar"))):
            t0 = time.perf_counter()
            res[n] = launch.run_ranks(phase13_rank, n, backend=backend,
                                      device="cuda", timeout_s=S_TIMEOUT,
                                      args=(parts, inputs))
            log(f"sharded: n = {n} over {backend} in "
                f"{time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(res[2]):
        log(f"sharded (a) rank {r} of 2, card = CPU: {out['small']}")
    figures = dict(card=smi, small=[o["small"] for o in res[2]])
    launches = {}
    for kind in ("rgbd", "lidar"):
        codes = {n: res[n][0][kind].pop("codes") for n in (1, 2)}
        both = np.intersect1d(codes[1], codes[2]).size
        overlap = both / np.union1d(codes[1], codes[2]).size
        figures[kind] = {"key_overlap": overlap}
        for n in (1, 2):
            per_rank = [o[kind] for o in res[n]]
            for k in per_rank[0]["launches"]:
                counts = [o["launches"][k] for o in per_rank]
                if any(counts):
                    launches.setdefault(k, {}).setdefault(kind, {})[
                        f"n{n}"] = counts
            for r, o in enumerate(per_rank):
                log(f"sharded ({'b' if kind == 'rgbd' else 'c'}) {kind} "
                    f"n = {n} rank {r}: {o['fps']:.2f} frames/s (median "
                    f"{o['median_ms']:.3f} ms), collectives "
                    f"{o['comm_ms']:.3f} ms/frame, {o['occupied']} blocks "
                    f"({o['res1']} at res 1) of {o['capacity']}, peak "
                    f"{o['peak_gib']:.3f} GiB, launches {o['launches']}"
                    + (f", mesh {o['mesh_vertices']} vertices "
                       f"{o['mesh_on_surface']:.4f} on the surface in "
                       f"{o['mesh_s']:.1f} s" if "mesh_s" in o else "")
                    + (f", = single-process at frame {o['single']['frame']}"
                       f": {o['single']}" if "single" in o else "") + f" [{smi}]")
            figures[kind][f"n{n}"] = per_rank
        log(f"sharded {kind}: key overlap n = 2 / n = 1 {overlap:.6f} "
            f"({both} keys in both)")
    assert "single" in res[1][0]["rgbd"], "the n = 1 gate did not run"
    figures["seconds"] = time.perf_counter() - t_phase
    log(f"sharded: phase 13 in {figures['seconds']:.1f} s")
    return launches, figures


def main():
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import numpy as np

    # 1. probe
    smi = nvidia_smi_line()
    log(f"probe: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA runtime {torch.version.cuda}, devices "
        f"{torch.cuda.device_count()}")
    log(f"probe: nvidia-smi: {smi}")
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True)
    log("probe: " + (nvcc.stdout.strip().splitlines() or ["nvcc missing"])[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from mrhash_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.library()
    log(f"build: {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")
    from mrhash_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    log(f"build: {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")

    # scenes
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    depths = []
    for i in range(ORBIT):
        rot, trans, _ = orbit_pose(i)
        depths.append(room_depth(rot, trans, rng))
    clouds = [lidar_cloud(lidar_pose(i), rng) for i in range(L_FRAMES)]
    train, holdout, more = gs_frames(np.random.default_rng(0))

    # 3. compare
    compare_small_scene()
    compare_small_scene(multires=True)
    compare_small_lidar()
    c14 = compare_c14_keys(depths, clouds)
    small_points = compare_small_points()
    compare_small_gs()
    compare_small_walk()
    small_quality = compare_small_quality()
    compare_small_setters()
    compare_qtree(train[0]["rgb"])
    k1, k2, k6 = compare_kernels(depths, rgb)
    torch.cuda.empty_cache()
    ka = compare_alloc_kernels(depths, rgb, clouds)
    torch.cuda.empty_cache()
    ka.update(compare_coarsen_kernels(clouds))
    torch.cuda.empty_cache()
    for name, k in ka.items():
        log(f"compare: {name} {k['ms']:.4f} ms (twin {k['plain_ms']:.4f} ms "
            f"eager, bound {k['bound_ms']:.4f} ms by {k['bound_by']}, "
            f"{k['bytes']} B) [{smi}]")
    log(f"compare: K1 {k1['ms']:.4f} ms (twin {k1['plain_ms']:.4f} ms, "
        f"bound {k1['bound_ms']:.4f} ms) over {k1['window_blocks']} blocks; "
        f"K2 {k2['ms']:.4f} ms (twin {k2['plain_ms']:.4f} ms, torch.take "
        f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms) [{smi}]")
    log(f"compare: K6 {k6['ms']:.4f} ms (twin {k6['plain_ms']:.4f} ms, "
        f"torch.take {k6['library_ms']:.4f} ms, bound {k6['bound_ms']:.4f} "
        f"ms, {k6['bytes']} B) over {k6['blocks']} blocks [{smi}]")
    k1r = compare_k1_res1(depths, rgb)
    torch.cuda.empty_cache()
    log(f"compare: K1 res-1 {k1r['ms']:.4f} ms (twin {k1r['plain_ms']:.4f} "
        f"ms, bound {k1r['bound_ms']:.4f} ms, {k1r['bytes']} B) over "
        f"{k1r['res1_blocks']} res-1 blocks of a {k1r['window_blocks']}-block "
        f"window [{smi}]")
    k3 = compare_lidar_kernel(clouds)
    torch.cuda.empty_cache()
    log(f"compare: K3 {k3['ms']:.4f} ms (twin {k3['plain_ms']:.4f} ms, "
        f"bound {k3['bound_ms']:.4f} ms, {k3['bytes']} B) over "
        f"{k3['window_blocks']} blocks [{smi}]")
    k3r = compare_lidar_kernel(clouds, multires=True)
    torch.cuda.empty_cache()
    log(f"compare: K3 res-1 {k3r['ms']:.4f} ms (twin {k3r['plain_ms']:.4f} "
        f"ms, bound {k3r['bound_ms']:.4f} ms, {k3r['bytes']} B, an empty "
        f"kernel over its grid {k3r['floor_ms']:.4f} ms) over "
        f"{k3r['res1_blocks']} res-1 blocks of a {k3r['window_blocks']}-block "
        f"window; the whole window in one launch {k3r['mixed_ms']:.4f} ms "
        f"(bound {k3r['mixed_bound_ms']:.4f} ms) [{smi}]")
    ks = compare_scan_raster_kernels(clouds)
    torch.cuda.empty_cache()
    for name, k in ks.items():
        log(f"compare: {'K13' if name == 'raster' else 'K14 ' + name} "
            f"{k['ms']:.4f} ms (twin {k['plain_ms']:.4f} ms eager, bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}, {k['bytes']} B; "
            f"{k['points']} points, window {k['window']}) [{smi}]")
    k2s = compare_k2_spherical(clouds)
    torch.cuda.empty_cache()
    log(f"compare: K2 spherical {k2s['ms']:.4f} ms (twin "
        f"{k2s['plain_ms']:.4f} ms, torch.take {k2s['library_ms']:.4f} ms, "
        f"bound {k2s['bound_ms']:.4f} ms, {k2s['bytes']} B) over "
        f"{k2s['window_blocks']} blocks [{smi}]")
    k4, k5, k5f = compare_blend_kernels(train)
    torch.cuda.empty_cache()
    for name, k in (("K4", k4), ("K5", k5), ("K5", k5f)):
        log(f"compare: {name} {k['ms']:.4f} ms (twin {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}, {k['bytes']} "
            f"B) over {k['tiles']} tiles x K {k['K']} [{smi}]")

    # 4. the RGB-D path (its mesh is left to phase 9, which meshes the
    # same single-res 1 cm path over the host grid and the device)
    launches, run = run_slice(depths, rgb, mesh=False)[:2]
    log(f"run: {run['fps']:.2f} FPS, median {run['median_ms']:.3f} ms/frame, "
        f"peak {run['peak_gib']:.3f} GiB [{smi}]")
    torch.cuda.empty_cache()

    # 5. the LiDAR path
    l_launches, lrun = run_lidar(clouds)
    launches.update(l_launches)
    log(f"lidar: {lrun['fps']:.2f} FPS, median {lrun['median_ms']:.3f} "
        f"ms/scan, mean {lrun['mean_ms']:.3f} ms/scan, window "
        f"{lrun['window']} blocks, peak {lrun['peak_gib']:.3f} GiB [{smi}]")
    torch.cuda.empty_cache()

    # 6. the GS path
    gs_launches, grun = run_gs_path(train, holdout, more)
    launches.update(gs_launches)
    log(f"gs: median {grun['median_ms']:.3f} ms per GS frame, "
        f"{grun['iter_ms']:.3f} ms per Adam iteration, PSNR "
        f"{grun['psnr']['train']:.2f} / {grun['psnr']['holdout']:.2f} dB, "
        f"{grun['gaussians']} Gaussians, peak {grun['peak_gib']:.3f} GiB "
        f"[{smi}]")
    torch.cuda.empty_cache()

    # 7. the multi-res RGB-D path (its host sweep's triangles kept for
    # phase 10)
    from mrhash_tpu_torch import native
    with recording(native, "extract_mesh_host") as host7:
        mr_launches, mrun, gw7 = run_slice(depths, rgb, multires=True)
    grid7 = gw7.streamer.grid      # the map, all of it after streamAllOut
    del gw7
    log(f"multires: {mrun['fps']:.2f} FPS, median {mrun['median_ms']:.3f} "
        f"ms/frame, {mrun['res1_blocks']} res-1 blocks, res-0 window "
        f"{mrun['res0_window']}, peak {mrun['peak_gib']:.3f} GiB, K1 "
        f"launches {mr_launches} [{smi}]")
    torch.cuda.empty_cache()

    # 8. the multi-res LiDAR path
    ml_launches, mlrun = run_lidar(clouds, multires=True)
    log(f"multires lidar: {mlrun['fps']:.2f} scans/s, median "
        f"{mlrun['median_ms']:.3f} ms/scan, {mlrun['res1_blocks']} res-1 "
        f"blocks, peak {mlrun['peak_gib']:.3f} GiB, K3 launches "
        f"{ml_launches} [{smi}]")
    torch.cuda.empty_cache()

    # 9. the streaming walk (its host sweep's triangles kept for phase 10)
    with recording(native, "extract_mesh_host") as host9:
        w_launches, wrun, gw9 = run_walk()
    grid9 = gw9.streamer.grid
    del gw9
    log(f"walk: {wrun['fps']:.2f} FPS with {wrun['timed_events']} stream "
        f"events in the timed window ({wrun['events']} in all), "
        f"{wrun['streamed_in']} blocks streamed in on the walk back, "
        f"duplicate ratio {wrun['dup']:.4f}, peak {wrun['peak_gib']:.3f} GiB, "
        f"mesh {wrun['on_wall']:.4f} on the walls, K1/K2 launches "
        f"{w_launches} [{smi}]")

    # 10. the device mesh sweep: card against CPU on phase 3's scenes, the
    # viewer, then phases 7's and 9's maps against their host sweeps
    small_batches = compare_small_mesh()
    vrun = run_viewer(depths, rgb)
    log(f"viewer: {vrun['fps']:.2f} FPS with the viewer on, phase 4 "
        f"{run['fps']:.2f} FPS without [{smi}]")
    torch.cuda.empty_cache()
    meshes = run_device_mesh(
        [("multires", lambda: make_wrapper("cuda", multires=True), grid7,
          host7, mrun),
         ("walk", lambda: make_walk_wrapper("cuda"), grid9, host9, wrun)],
        smi)
    del grid7, grid9, host7, host9
    torch.cuda.empty_cache()

    # 11. LiDAR, point-centric and starved: pass (a) the point-centric
    # update, pass (b) the projective one, both starving every L_STARVE
    p_launches, prun = {}, {}
    for name, projective in (("a", False), ("b", True)):
        p_launches[name], prun[name] = run_points(clouds, projective)
        torch.cuda.empty_cache()
        r = prun[name]
        log(f"points ({name}): {r['fps']:.2f} scans/s, median "
            f"{r['median_ms']:.3f} ms/scan, GC freed {r['gc_freed']}, peak "
            f"{r['peak_gib']:.3f} GiB, K2/K3 launches {p_launches[name]} "
            f"[{smi}]")

    # 12. quality and the API: the box and the cluttered room at the
    # Replica preset through extractMesh and eval_reconstruction's
    # metrics, the setters on the card, the memory report
    quality = {"small": small_quality}
    q_launches = {}
    for name, scene, multires in (("box", "box", False),
                                  ("clutter", "clutter", True)):
        quality[name] = quality_run(scene, multires, smi)
        q_launches[name] = quality[name]["launches"]
        torch.cuda.empty_cache()
    starve_launches = run_starve_setter(depths, rgb, smi)
    quality["rebuild_in_flight"] = run_rebuild_in_flight(smi)
    torch.cuda.empty_cache()
    quality["memory"] = run_memory_report(smi)

    # 13. the sharded steps, one process per rank
    s_launches, sharding = run_sharded(depths, rgb, clouds, smi)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "mrhash_tpu",
                                           "bench", "quality_eval"))
    assert not loaded, f"the port loaded {loaded}"

    # K1 and K3 carry their res-1 paths' figures beside the res-0 ones:
    # res-1 times from phase 3's multi-res windows, res-1 launches from
    # phases 7 and 8 (multires_launches: their res-0 launches there)
    res1 = {"fused_integrate_rows": (k1r, mr_launches, "fused_integrate_rows"),
            "fused_integrate_points_rows": (k3r, ml_launches,
                                            "fused_integrate_points_rows"),
            "sample_image": (None, mr_launches, "sample_image")}
    kernels = []
    for name, src, replaces, rec in (
            ("fused_integrate_rows", "fused_integrate.cu",
             "mrhash_tpu/ops/fused_integrate.py:115", k1),
            ("sample_image", "sample_image.cu",
             "mrhash_tpu/ops/pallas_kernels.py:121", k2),
            ("fused_integrate_points_rows", "fused_integrate_points.cu",
             "mrhash_tpu/ops/fused_integrate.py:539", k3),
            ("blend_forward", "blend_tiles.cu",
             "mrhash_tpu/gs/blend_pallas.py:70", k4),
            ("blend_backward", "blend_tiles.cu",
             "mrhash_tpu/gs/blend_pallas.py:110", k5),
            ("sample_image5", "sample_image.cu",
             "mrhash_tpu/ops/pallas_kernels.py:44", k6)):
        entry = dict(
            name=name, route="cuda", source="mrhash_tpu_torch/csrc/" + src,
            replaces=replaces, launches=launches.get(name, 0),
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
        if name in res1:
            r, ml, key = res1[name]
            entry["multires_launches"] = ml[key]
            if r is not None:
                entry.update(
                    res1_launches=ml[key + "_res1"],
                    **{"res1_" + k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")})
        if name == "sample_image5":
            entry["launches_note"] = (
                "no path launches K6: nothing in the JAX package calls "
                "B6 (sample_image_pallas_v2, marked EXPERIMENT, NOT USED)")
        if name in w_launches:
            entry["walk_launches"] = w_launches[name]
        if name == "fused_integrate_points_rows":
            entry.update(mixed_ms=k3r["mixed_ms"],
                         mixed_bound_ms=k3r["mixed_bound_ms"],
                         res1_floor_ms=k3r["floor_ms"])
            entry["launches_note"] = (
                "one launch serves both resolutions: a multi-res scan's "
                "launch counts in multires_launches (res 0) and "
                "res1_launches (res 1) alike")
        if name == "fused_integrate_rows":   # phase 12's rooms
            entry["quality_launches"] = {
                k: {p: v[p] for p in ("fused_integrate_rows",
                                      "fused_integrate_rows_res1")}
                for k, v in q_launches.items()}
        if name == "sample_image":     # phase 11's spherical readback
            entry["points_launches"] = {
                k: v["sample_image"] for k, v in p_launches.items()}
            entry["setter_launches"] = starve_launches["sample_image"]
            entry.update({"sph_" + k: k2s[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
        if name in s_launches:         # phase 13, per run and rank
            entry["sharded_launches"] = s_launches[name]
            if name + "_res1" in s_launches:
                entry["sharded_res1_launches"] = s_launches[name + "_res1"]
        if name == "blend_forward":
            entry.update({k: k4[k] for k in ("warp_steps", "exit_warp_steps")})
        if name == "blend_backward":   # at GSFinalOpt's cap, K = 128
            entry.update({"k128_" + k: k5f[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        kernels.append(entry)
    for name, rec in ka.items():     # allocation, coarsening: no TPU
        coarsen = name in COARSEN_NAMES   # kernel replaced
        entry = dict(
            name=name, route="cuda",
            source="mrhash_tpu_torch/csrc/" + (
                "coarsen_blocks.cu" if coarsen else "alloc_blocks.cu"),
            replaces="none: the JAX package {} with jnp ops".format(
                "coarsens" if coarsen else "allocates"),
            launches=(lrun["alloc_launches"]["alloc_walk"]
                      if name.endswith("_points") else launches.get(name, 0)),
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            plain_note="the twin timed eagerly, its host reads included")
        if coarsen:   # phases 4 and 5 (0: single-res), 7 and 8
            entry.update(launches=launches[name]
                         + lrun["coarsen_launches"][name],
                         multires_launches=dict(
                             rgbd=mr_launches[name],
                             lidar=mlrun["coarsen_launches"][name]))
        kernels.append(entry)
    for name, keys in (("raster_scan", ("raster",)),
                       ("project_window", ("loop", "drive"))):
        entry = dict(
            name=name, route="cuda",
            source="mrhash_tpu_torch/csrc/scan_raster.cu",
            replaces="none: the JAX package rasterizes and projects the "
                     "scan with jnp ops",
            launches=lrun["scan_launches"][name],
            multires_launches=mlrun["scan_launches"][name],
            plain_note="the twin timed eagerly")
        for key in keys:
            pre = "" if key in ("raster", "loop") else key + "_"
            entry.update({pre + k: ks[key][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "window")})
        kernels.append(entry)
    log(f"smoke: {time.perf_counter() - t_main:.1f} s in all")
    from mrhash_tpu_torch import geowrapper
    print(json.dumps({"mesh": dict(
        card=smi, max_cells=geowrapper.MESH_MAX_CELLS,
        chunk=geowrapper.MESH_CHUNK, small_chunk_batches=small_batches,
        viewer=vrun, rgbd_fps=run["fps"], **meshes)}))
    print(json.dumps({"points": dict(card=smi, c14=c14,
                                     small=small_points, **prun)}))
    print(json.dumps({"quality": dict(card=smi, **quality)}))
    print(json.dumps({"sharding": sharding}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
