#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (mrhash_tpu_torch) on one NVIDIA
card.

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no result line):
  1. probe   — CUDA present; device, CUDA runtime, nvidia-smi, nvcc;
  2. build   — compile the kernels K1 and K2 from mrhash_tpu_torch/csrc;
  3. compare — each kernel against its plain PyTorch twin on the inputs the
               main path gives it after 40 frames at 1200x680, then timed in
               turns (twin, kernel, kernel, twin) with CUDA events; and the
               whole slice on the card against the slice on the CPU on a
               small scene;
  4. run     — GeoWrapper(device="cuda") at replica.cfg's settings, 120
               frames of bench.py's box-room orbit (starvation fires on
               frame 100), with the kernels' launch counts taken over that
               run only; then streamAllOut + extractMesh to a temporary PLY,
               whose vertices must lie on the room's walls.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import tempfile
import time

ROWS, COLS = 680, 1200
FX = FY = 600.0
CX, CY = 599.5, 339.5
ORBIT = 40
N_FRAMES = 120
HALF = 3.0                      # box room half side, metres
TURNS, REPEAT = 20, 10          # per version: 20 turns of 10 calls
TOL = dict(sdf=2e-5, sumsq=5e-4)


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


def make_wrapper(device):
    """The port's GeoWrapper at configurations/replica.cfg's settings, with
    bench.py's capacities."""
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(sdf_truncation=0.07, sdf_truncation_scale=0.0,
                    integration_weight_sample=1, virtual_voxel_size=0.01,
                    n_frames_invalidate_voxels=100, voxel_extents_scale=1,
                    marching_cubes_threshold=1.5, min_weight_threshold=5,
                    min_depth=0.01, max_depth=30.0, num_blocks=1 << 19,
                    num_buckets=1 << 15, max_active_blocks=1 << 17,
                    profiling=False, device=device)
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

def time_in_turns(kernel, twin):
    """Median ms per call of each version, timed with CUDA events in turns
    (twin, kernel, kernel, twin) after one warm-up call of each.  A turn is
    REPEAT back-to-back calls between two events, so a kernel that runs
    shorter than its launch's host overhead is not timed as that overhead.
    `kernel` is the wrapper's launcher, past the wrapper's checks: the
    index-range check syncs with the device and would time the host."""
    import torch
    kernel()
    twin()
    ms = {"kernel": [], "twin": []}
    order = ["twin", "kernel", "kernel", "twin"]
    fns = {"kernel": kernel, "twin": twin}
    for k in range(TURNS * 2):
        name = order[k % 4]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPEAT):
            fns[name]()
        b.record()
        torch.cuda.synchronize()
        ms[name].append(a.elapsed_time(b) / REPEAT)
    return statistics.median(ms["kernel"]), statistics.median(ms["twin"])


def compare_kernels(depths, rgb):
    """Drive the slice 40 frames, then hold K1 and K2 against their twins
    on the window, frame and z-buffer of frame 41."""
    import torch

    from mrhash_tpu_torch.core.state import VoxelPool, pack_rgb
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
    rot, trans, _ = orbit_pose(ORBIT)
    cam = C.with_pose(gw.camera, rot, trans)
    depth = torch.from_numpy(depths[0]).to(dev)
    pc_depth = C.get_depth(cam, C.compute_cloud(cam, depth))
    keys, valid = I.alloc_candidates_depth(
        cfg, cam, pc_depth, cfg.dda_steps(cfg.max_integration_distance),
        frame=gw.state.frame)
    I.alloc_blocks(cfg, gw.state.table, keys, valid, gw.state.frame)
    _, bpos, bptr, _ = I.compact_active(cfg, gw.state.table, cam)
    A = bpos.shape[0]
    prow = I._block_rows(bptr).contiguous()
    rgbp = pack_rgb(torch.from_numpy(rgb).to(dev)).contiguous()
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale,
                              cfg.max_integration_distance,
                              cfg.integration_weight_sample,
                              cfg.integration_weight_max)
    pc_depth = pc_depth.contiguous()
    src = gw.state.pool
    pools = [VoxelPool(**{f: getattr(src, f).clone() for f in
                          VoxelPool.FIELDS}) for _ in range(2)]
    del gw
    fk = FI.fused_integrate_rows(pools[0], pc_depth, rgbp, cam_vec, bpos,
                                 prow)
    ft = FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp, cam_vec, bpos,
                                     prow)
    torch.cuda.synchronize()
    err = {}
    for f in VoxelPool.FIELDS:
        a = getattr(pools[0], f)[prow]
        b = getattr(pools[1], f)[prow]
        err[f] = float((a.double() - b.double()).abs().max())
    updated = int((pools[0].weight[prow] > src.weight[prow]).sum())
    log(f"compare K1: window {A} blocks, {updated} voxels updated, "
        f"max |diff| {err}")
    assert err["weight"] == 0 and err["rgbp"] == 0, err
    assert err["sdf"] <= TOL["sdf"] and err["sumsq"] <= TOL["sumsq"], err
    assert torch.equal(fk[:, :3], ft[:, :3]), "K1 GC flags differ"
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
    assert updated > 100000, "K1 integrated almost nothing"
    k1_ms, k1_plain = time_in_turns(
        lambda: FI._launch(pools[0], pc_depth, rgbp, cam_vec, bpos, prow),
        lambda: FI.fused_integrate_rows_ref(pools[1], pc_depth, rgbp,
                                            cam_vec, bpos, prow))
    k1 = dict(max_abs_err=max(err.values()), ms=k1_ms, plain_ms=k1_plain,
              window_blocks=A)
    del pools, src

    # K2 at the starvation readback's shapes: the frame-41 window's voxels
    # and their z-buffer (ops/integrate.py::starve_mask)
    pf = X.virtual_voxel_pos_to_world(cfg.virtual_voxel_size,
                                      I._block_voxel_grid(bpos))
    pcam = C.world_to_cam(cam, pf)
    row, col, ok = C.project_point(cam, pcam)
    z = C.get_depth(cam, pcam)
    ok = (ok & (z >= cam.min_depth)).contiguous()
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
    k2_ms, k2_plain = time_in_turns(
        lambda: SI._launch(zimg, row, col, ok),
        lambda: SI.sample_image_ref(zimg, row, col, ok))
    k2 = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain)
    return k1, k2


def compare_small_scene():
    """The whole slice on the card against the slice on the CPU (where the
    tests hold it against the JAX reference): 4 frames of a 64x256 scene
    with starvation + GC; same key set, weight and rgbp exact, sdf within
    2e-5, sumsq within 5e-4."""
    import numpy as np
    import torch

    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import MapConfig, make_state
    from mrhash_tpu_torch.ops import camera as C

    rows, cols = 64, 256
    cfg = MapConfig(virtual_voxel_size=0.02, sdf_truncation=0.06,
                    max_integration_distance=5.0,
                    n_frames_invalidate_voxels=2, num_blocks=1 << 11,
                    max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
                    alloc_tile=4)
    rng = np.random.default_rng(0)
    r = np.arange(rows, dtype=np.float32)[:, None]
    c = np.arange(cols, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
    frames = [((base + rng.normal(0, 0.01, base.shape)).astype(np.float32),
               np.array([0.03 * i, 0.01 * i, 0.0], np.float32))
              for i in range(4)]
    maps = {}
    for dev in ("cpu", "cuda"):
        st = make_state(cfg.num_blocks, device=dev)
        cam0 = C.make_camera(80.0, 80.0, 127.5, 31.5, rows, cols, 0.01, 5.0,
                             device=dev)
        for d, t in frames:
            cam = C.with_pose(cam0, np.eye(3, dtype=np.float32), t)
            st, _ = pipeline.integrate_rgbd(
                cfg, st, cam, torch.from_numpy(d).to(dev),
                torch.from_numpy(rgb).to(dev))
        occ = (st.table.ptr != -2).cpu().numpy()
        pos = st.table.pos.cpu().numpy()[occ]
        rows_ = st.table.ptr.cpu().numpy()[occ] // 512
        order = np.lexsort(pos.T)
        maps[dev] = (pos[order], {f: getattr(st.pool, f).cpu().numpy()
                                  [rows_[order]] for f in
                                  ("sdf", "sumsq", "weight", "rgbp")})
    (pc, mc), (pg, mg) = maps["cpu"], maps["cuda"]
    assert np.array_equal(pc, pg), "block key sets differ"
    assert np.array_equal(mc["weight"], mg["weight"])
    upd = mc["weight"] > 0
    assert int(upd.sum()) > 10000
    assert np.array_equal(mc["rgbp"][upd], mg["rgbp"][upd])
    err = {f: float(np.abs(mc[f][upd] - mg[f][upd]).max())
           for f in ("sdf", "sumsq")}
    assert all(err[f] <= TOL[f] for f in err), err
    log(f"compare slice cuda vs cpu (64x256, 4 frames): {len(pc)} blocks, "
        f"max |diff| {err}")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def run_slice(depths, rgb):
    import numpy as np
    import torch

    from mrhash_tpu_torch.ops import fused_integrate as FI
    from mrhash_tpu_torch.ops import sample_image as SI

    gw = make_wrapper("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FI.launch_count = 0
    SI.launch_count = 0
    frame_ms, occupied = [], []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        feed(gw, i, depths, rgb)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        occupied.append(gw.last_stats["occupied_blocks"])
    launches = {"fused_integrate_rows": FI.launch_count,
                "sample_image": SI.launch_count}
    peak = torch.cuda.max_memory_allocated()
    stats = gw.last_stats
    steady = frame_ms[ORBIT:]
    log(f"run: {N_FRAMES} frames, launches {launches}")
    log(f"run: window blocks last {occupied[-1]} max {max(occupied)}; "
        f"occupied total {stats['occupied_total']}, "
        f"high_free {stats['high_free']}")
    log(f"run: frames {ORBIT}-{N_FRAMES - 1}: median "
        f"{statistics.median(steady):.3f} ms, "
        f"mean {statistics.fmean(steady):.3f} ms, "
        f"FPS {1e3 / statistics.fmean(steady):.2f}; starve frame 100 "
        f"{frame_ms[100]:.3f} ms; first frame {frame_ms[0]:.1f} ms")
    log(f"run: peak device memory {peak / 2**30:.3f} GiB")
    assert launches["fused_integrate_rows"] == N_FRAMES, launches
    assert launches["sample_image"] >= 1, launches

    t0 = time.perf_counter()
    gw.streamAllOut()
    with tempfile.TemporaryDirectory() as tmp:
        gw.extractMesh(os.path.join(tmp, "mesh.ply"))
    mesh_s = time.perf_counter() - t0
    v, f = gw.getVertices(), gw.getFaces()
    log(f"mesh: {v.shape[0]} vertices, {f.shape[0]} faces "
        f"(streamAllOut + extractMesh {mesh_s:.1f} s)")
    assert v.shape[0] > 10000, v.shape
    assert np.isfinite(v).all()
    # the reconstruction lies on the box room's walls
    wall = np.abs(np.abs(v).max(axis=1) - HALF)
    on_wall = float((wall < 0.03).mean())
    log(f"mesh: {on_wall:.4f} of vertices within 3 cm of a wall")
    assert on_wall > 0.95, on_wall
    return launches, dict(median_ms=statistics.median(steady),
                          fps=1e3 / statistics.fmean(steady),
                          peak_gib=peak / 2**30)


def main():
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

    # scene
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    depths = []
    for i in range(ORBIT):
        rot, trans, _ = orbit_pose(i)
        depths.append(room_depth(rot, trans, rng))

    # 3. compare
    compare_small_scene()
    k1, k2 = compare_kernels(depths, rgb)
    torch.cuda.empty_cache()
    log(f"compare: K1 {k1['ms']:.4f} ms (twin {k1['plain_ms']:.4f} ms) over "
        f"{k1['window_blocks']} blocks; K2 {k2['ms']:.4f} ms "
        f"(twin {k2['plain_ms']:.4f} ms) [{smi}]")

    # 4. run
    launches, run = run_slice(depths, rgb)
    log(f"run: {run['fps']:.2f} FPS, median {run['median_ms']:.3f} ms/frame, "
        f"peak {run['peak_gib']:.3f} GiB [{smi}]")

    kernels = [
        dict(name="fused_integrate_rows", route="cuda",
             source="mrhash_tpu_torch/csrc/fused_integrate.cu",
             replaces="mrhash_tpu/ops/fused_integrate.py:115",
             launches=launches["fused_integrate_rows"],
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"]),
        dict(name="sample_image", route="cuda",
             source="mrhash_tpu_torch/csrc/sample_image.cu",
             replaces="mrhash_tpu/ops/pallas_kernels.py:121",
             launches=launches["sample_image"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
