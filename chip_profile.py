#!/usr/bin/env python3
"""Where the time of a LiDAR scan, an online-GS frame, the multi-res
frames and the streaming walk's frames goes, on one NVIDIA card; and an A/B
of the RGB-D frame time against another checkout of the port.

    python3 chip_profile.py
    python3 chip_profile.py --points
    python3 chip_profile.py --gs
    python3 chip_profile.py --multires
    python3 chip_profile.py --walk
    python3 chip_profile.py --mesh
    python3 chip_profile.py --rgbd-ab OTHER_ROOT
    python3 chip_profile.py --gs-ab OTHER_ROOT
    python3 chip_profile.py --kernels-ab OTHER_ROOT [OTHER_ROOT ...]
    python3 chip_profile.py --syncs [OTHER_ROOT]

The first form drives chip_smoke.py's LiDAR cell
(configurations/newer_college.cfg, 64x1024 scans of the synthetic ground +
wall scene, 0.5 m per scan) through GeoWrapper(device="cuda") and
reports:
  1. the unprofiled scan time, median over scans 10-39, and the host cost
     of a stage range (utils/profiler.py::stage) while no profiler runs;
  2. a torch.profiler trace of scans 10-19 through GeoWrapper.compute:
     device time per scan and its share of the unprofiled scan, kernel
     launches and host syncs per scan, kernel K3's device time per launch,
     and the host and device time of each stage, read from the points.*
     ranges of the frame step itself (core/pipeline.py::integrate_points);
  3. K3's host cost per launch (the wrapper's launcher, no sync) against its
     device time.
The --points form does 1 and 2 for chip_smoke.py's phase 11, both
passes: the same scans starving every 10 scans (so the profiled scans
10-19 hold one starve scan) with GC on every scan, (a) through the
point-centric update (projective_sdf=False, MADtree normals from
setPointCloud(points, True)), (b) through the projective one (K3); the
stage ranges add points.walk (integrate_points_sdf) and points.starve.
The --gs form drives chip_smoke.py's phase-6 scene (tools/bench_gs.py's
textured box room at 1200x680, configurations/params.json) through
GeoWrapper(device="cuda"): the two training frames, then frames 2-6 of the
pan unprofiled (the GS frame, run_gs, synchronized) and frames 7-11 under
torch.profiler: host ms per GS frame of each gs.* range of the container
(gs.seed = quad-tree + check_nodes, gs.insert, gs.steps, and inside the
steps gs.render, gs.backward, gs.adam), device ms per frame of K4, K5 and
all kernels, and launches and syncs per frame.
The --multires form drives chip_smoke.py's multi-res cells (phase 7:
the box-room orbit at bench_multires's settings; phase 8: the LiDAR scans
at bench_lidar(multires=True)'s): the unprofiled frame time, median over
20 steady frames, then 10 frames under torch.profiler: device ms per frame
and its share, launches and syncs per frame, the host and device ms of
each stage range of the frame step (rgbd.* or points.*), and the kernels
that take the most device time.
The --walk form drives chip_smoke.py's phase 9 (tools/bench_walk.py's
tube walk at 1200x680, 2^16 blocks): frames 0-149 to reach the stream
watermark, frames 150-209 unprofiled (the frame time of the frames with
a stream event, the trigger's own synchronized time, and the frame time
by frames since the last event), then frames 210-239 under
torch.profiler: device ms per frame and its share of the unprofiled
frame, launches and syncs per frame, the host and device ms of the frame
step's rgbd.* ranges per frame
and of the streamer's stream.* ranges per stream event, and the kernels
and copies that take the most device time.
The --mesh form times the device mesh sweep (extractMesh under
MRHASH_HOST_MESH=0, the chunk-batch path) at several sizes of its window
(MESH_CHUNK blocks gated at once) and its cell batches (MESH_MAX_CELLS),
results being the same at every size: on chip_smoke.py's phase-7 map
(the multi-res box room after 120 frames, streamed out) and on phase 9's
walk (the 270 frames down the tube, streamed out); seconds, the sweep's
phases, windows, gated cells and batches, peak device memory, and for
the default sizes, under torch.profiler, launches and host syncs per cell
batch.
The --rgbd-ab form times chip_smoke.py's RGB-D cell (120 frames of the
box-room orbit at 1200x680, no mesh), each run in a fresh process, with
the mrhash_tpu_torch of OTHER_ROOT (A) and of this checkout (B) in turns
A B B A A B B A, and prints each run's median frame time over frames
40-119.
The --gs-ab form runs chip_smoke.py's phase 6 (the GS path) in fresh
processes with OTHER_ROOT's mrhash_tpu_torch (A) and this checkout's (B)
in turns A B B A, and prints each run's peak device memory, PSNR and GS
frame time.
The --kernels-ab form builds the kernel library of each OTHER_ROOT (its
own ops/cuda_lib.py over its own csrc) beside this checkout's, prints
each one's K1, K3 and K4/K5 registers and spills (nvcc -Xptxas -v),
holds each one's K1 (res-0 and res-1 paths), K3 (res-0, res-1 and the
mixed multi-res window), K4 and K5 against this checkout's on
chip_smoke.py's phase-3 inputs (K4 at K = 64, K5 at K = 64 and K = 128),
and times them in turns by CUDA-graph replay, with the bound each is
held to.
The --syncs form runs each cell of the benchmark (benchmark/: the
configuration's GeoWrapper fed the traffic's frames from seed 1) through
its warm-up, then 12 frames under torch.profiler with
torch.cuda.set_sync_debug_mode("warn"), in a fresh process: per frame
the runtime's synchronizations (events named *Synchronize*) inside a
range around compute(), last_stats' host_syncs, and the sync sites (the
innermost frame of the package under each warning's stack, file:line);
with OTHER_ROOT, the same frames through OTHER_ROOT's mrhash_tpu_torch
in a fresh process too, for the count on both sides.
Prints the card's name and power limit beside the numbers.  Needs a card.
"""
import json
import os
import subprocess
import statistics
import sys
import time

import chip_smoke as S


def stage_times(prof, n, prefix="points."):
    """{range: (host ms, device ms)} per frame of the ranges named
    prefix* (the points.* or rgbd.* ranges that core/pipeline.py's frame
    steps and ops/integrate.py open, or the GS container's gs.*), from the
    host-side events of a torch.profiler run over n frames.  A range's
    device time is that of the kernels launched inside it from its own
    thread, nested ranges included."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix) and e.device_type == DeviceType.CPU:
            host, dev = out.get(e.name, (0.0, 0.0))
            out[e.name] = (host + e.cpu_time_total / 1e3 / n,
                           dev + _dev_us(e, "device_time_total") / 1e3 / n)
    return out


def _dev_us(e, name):
    """An event's device time in us under either name torch has used."""
    if hasattr(e, name):
        return getattr(e, name)
    return getattr(e, name.replace("device", "cuda"), 0.0)


def rgbd_run():
    """One RGB-D run with whichever mrhash_tpu_torch is first on sys.path;
    prints a JSON line with the median and mean frame ms of frames
    40-119."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (S.ROWS, S.COLS, 3)).astype(np.uint8)
    depths = [S.room_depth(*S.orbit_pose(i)[:2], rng) for i in range(S.ORBIT)]
    gw = S.make_wrapper("cuda")
    ms = []
    for i in range(S.N_FRAMES):
        t0 = time.perf_counter()
        S.feed(gw, i, depths, rgb)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    steady = ms[S.ORBIT:]
    import mrhash_tpu_torch
    print(json.dumps(dict(package=os.path.dirname(mrhash_tpu_torch.__file__),
                          median_ms=statistics.median(steady),
                          mean_ms=statistics.fmean(steady))), flush=True)


def _run_in(root, fn):
    """Runs chip_profile.<fn>() in a fresh process with the
    mrhash_tpu_torch of `root` first on sys.path; returns its last output
    line as JSON."""
    here = os.path.dirname(os.path.abspath(__file__))
    # chip_smoke / chip_profile from here, mrhash_tpu_torch from root
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            "import chip_profile; "
            f"sys.path.insert(0, {root!r}); "
            f"chip_profile.{fn}()")
    out = subprocess.run([sys.executable, "-c", code], cwd=here,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{fn} with {root} failed:\n{out.stderr}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["package"].startswith(root), rec
    return rec


def rgbd_ab(other_root):
    """Runs rgbd_run in fresh processes, A = other_root, B = this checkout,
    in turns A B B A A B B A."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"A": os.path.abspath(other_root), "B": here}
    got = {"A": [], "B": []}
    for name in "ABBAABBA":
        rec = _run_in(roots[name], "rgbd_run")
        got[name].append(rec["median_ms"])
        print(f"rgbd {name} ({roots[name]}): median {rec['median_ms']:.3f} "
              f"ms, mean {rec['mean_ms']:.3f} ms", flush=True)
    for name in "AB":
        print(f"rgbd {name}: per-run medians {sorted(got[name])}, median of "
              f"runs {statistics.median(got[name]):.3f} ms "
              f"[{S.nvidia_smi_line()}]")


def gs_run():
    """chip_smoke.py's phase 6 with whichever mrhash_tpu_torch is first on
    sys.path; prints a JSON line with its peak device memory, PSNR and GS
    frame ms."""
    import numpy as np
    train, holdout, more = S.gs_frames(np.random.default_rng(0))
    _, run = S.run_gs_path(train, holdout, more)
    import mrhash_tpu_torch
    print(json.dumps(dict(package=os.path.dirname(mrhash_tpu_torch.__file__),
                          peak_gib=run["peak_gib"], psnr=run["psnr"],
                          psnr_final=run["psnr_final"],
                          median_ms=run["median_ms"])), flush=True)


def gs_ab(other_root):
    """Runs gs_run in fresh processes, A = other_root, B = this checkout,
    in turns A B B A: phase 6's peak device memory and PSNR of each."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"A": os.path.abspath(other_root), "B": here}
    smi = S.nvidia_smi_line()
    for name in "ABBA":
        root = roots[name]
        rec = _run_in(root, "gs_run")
        print(f"gs {name} ({root}): peak {rec['peak_gib']:.4f} GiB "
              f"({rec['peak_gib'] * 2**30 / 1e6:.1f} MB), PSNR "
              f"{rec['psnr']['train']:.2f} / {rec['psnr']['holdout']:.2f} "
              f"dB, after GSFinalOpt {rec['psnr_final']['train']:.2f} / "
              f"{rec['psnr_final']['holdout']:.2f} dB, GS frame median "
              f"{rec['median_ms']:.3f} ms [{smi}]", flush=True)


def gs_profile(smi):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train, _, more = S.gs_frames(np.random.default_rng(0))
    gw = S.make_gs_wrapper("cuda")
    gc = gw.gs_container
    for f in train:
        S.feed_gs(gw, f)
    run_gs, gs_ms = gc.run_gs, []

    def timed_run_gs(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_gs(*a, **kw)
        torch.cuda.synchronize()
        gs_ms.append((time.perf_counter() - t0) * 1e3)
    gc.run_gs = timed_run_gs
    for f in more[:5]:
        S.feed_gs(gw, f)
    wall = statistics.median(gs_ms)
    print(f"GS frame (run_gs), median over frames 2-6: {wall:.3f} ms "
          f"({gc.model.count} Gaussians) [{smi}]", flush=True)
    gc.run_gs = run_gs

    n = len(more) - 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in more[5:]:
            S.feed_gs(gw, f)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    def dev_us(e):
        return _dev_us(e, "self_device_time_total")

    # kernels, copies and sets only: not the device spans of host ranges
    # (gs.*, and the optimizer's own Optimizer.step annotation)
    on_device = [e for e in ka if e.device_type != DeviceType.CPU
                 and not e.key.startswith(("gs.", "points.", "Optimizer."))]
    device_ms = sum(dev_us(e) for e in on_device) / 1e3 / n
    count = {e.key: e.count for e in ka}
    launches = sum(count.get(k, 0) for k in ("cudaLaunchKernel",
                                             "cuLaunchKernel",
                                             "cudaLaunchKernelExC"))
    syncs = sum(c for k, c in count.items() if "Synchronize" in k)
    print(f"profiler, frames 7-{6 + n} through compute() [{smi}]: device "
          f"{device_ms:.3f} ms/frame (RGB-D step included), "
          f"{launches / n:.1f} kernel launches and {syncs / n:.1f} host "
          f"syncs per frame")
    for name in ("blend_forward_kernel", "blend_backward_kernel"):
        k = [e for e in on_device if name in e.key]
        if k:
            print(f"  {name}: {dev_us(k[0]) / n / 1e3:.4f} ms/frame device, "
                  f"{k[0].count / n:.1f} launches/frame, "
                  f"{dev_us(k[0]) / k[0].count:.2f} us per launch")
    print("stages (host ms/frame under the profiler, device ms/frame of "
          "the kernels launched from the range's thread):")
    for name, (host, dev) in stage_times(prof, n, "gs.").items():
        print(f"  {name}: host {host:.3f}, device {dev:.3f}")
    top = sorted(on_device, key=dev_us, reverse=True)[:10]
    for e in top:
        print(f"  {dev_us(e) / n / 1e3:.4f} ms/frame  x{e.count / n:<6.1f} "
              f"{e.key[:90]}")


def multires_profile(smi):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # chip_smoke.py's scenes, drawn in its order from the same seed
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (S.ROWS, S.COLS, 3)).astype(np.uint8)
    depths = [S.room_depth(*S.orbit_pose(i)[:2], rng) for i in range(S.ORBIT)]
    clouds = [S.lidar_cloud(S.lidar_pose(i), rng) for i in range(S.L_FRAMES)]
    cells = (
        ("multi-res RGB-D", "rgbd.", S.ORBIT,
         lambda: S.make_wrapper("cuda", multires=True),
         lambda gw, i: S.feed(gw, i, depths, rgb)),
        ("multi-res LiDAR", "points.", S.L_STEADY,
         lambda: S.make_lidar_wrapper("cuda", clouds[0], multires=True),
         lambda gw, i: S.feed_lidar(gw, i, clouds)))
    n_steady, n = 20, 10
    for name, prefix, warm, make, step in cells:
        gw = make()
        ms = []
        for i in range(warm + n_steady):
            t0 = time.perf_counter()
            step(gw, i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(ms[warm:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(warm + n_steady, warm + n_steady + n):
                step(gw, i)
            torch.cuda.synchronize()
        ka = prof.key_averages()

        def dev_us(e):
            return _dev_us(e, "self_device_time_total")

        on_device = [e for e in ka if e.device_type != DeviceType.CPU
                     and not e.key.startswith(prefix)]
        device_ms = sum(dev_us(e) for e in on_device) / 1e3 / n
        count = {e.key: e.count for e in ka}
        launches = sum(count.get(k, 0) for k in ("cudaLaunchKernel",
                                                 "cuLaunchKernel",
                                                 "cudaLaunchKernelExC"))
        syncs = sum(c for k, c in count.items() if "Synchronize" in k)
        print(f"{name}: frame median {wall:.3f} ms over {n_steady} frames; "
              f"profiler, {n} frames: device {device_ms:.3f} ms/frame, busy "
              f"{device_ms / wall:.4f} of the unprofiled frame, "
              f"{launches / n:.1f} launches and {syncs / n:.1f} syncs per "
              f"frame; {S.res1_blocks(gw)} res-1 blocks [{smi}]")
        print("  stages (host ms/frame under the profiler, device ms/frame):")
        for rname, (host, dev) in stage_times(prof, n, prefix).items():
            print(f"    {rname}: host {host:.3f}, device {dev:.3f}")
        for e in sorted(on_device, key=dev_us, reverse=True)[:8]:
            print(f"    {dev_us(e) / n / 1e3:.4f} ms/frame  "
                  f"x{e.count / n:<6.1f} {e.key[:90]}")
        del gw
        torch.cuda.empty_cache()


def walk_profile(smi):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    depths = S.walk_depths()
    rgb = np.random.default_rng(0).integers(0, 255, (S.ROWS, S.COLS, 3)
                                            ).astype(np.uint8)
    gw = S.make_walk_wrapper("cuda")
    st = gw.streamer
    warm, n_un, n = S.W_WARM, 60, 30

    def frame(i):
        S.walk_frame(gw, S.W_STEP * i, i, depths, rgb)

    for i in range(warm):
        frame(i)
    # the trigger's own host time (synchronized), apart from the frame step
    trigger = gw._stream
    stream_ms = []

    def timed_trigger():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trigger()
        torch.cuda.synchronize()
        stream_ms.append((time.perf_counter() - t0) * 1e3)
    gw._stream = timed_trigger
    ms, since = [], []
    last = None
    for i in range(warm, warm + n_un):
        k = len(st.out_events)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(st.out_events) > k:
            last = i
        since.append(None if last is None else i - last)
    gw._stream = trigger
    wall = statistics.fmean(ms)
    ev_ms = [m for m, d in zip(ms, since) if d == 0]
    print(f"walk, frames {warm}-{warm + n_un - 1}: mean {wall:.3f} ms; "
          f"frames with a stream event {[round(m, 3) for m in ev_ms]} ms, "
          f"of which the trigger (stream out + in, synchronized) "
          f"{[round(m, 3) for m in stream_ms]} ms [{smi}]", flush=True)
    by = {}
    for m, d in zip(ms, since):
        if d is not None:
            by.setdefault(min(d, 6), []).append(m)
    print("  frame ms by frames since the last stream event (6 = 6 or "
          "more): " + ", ".join(f"{d}: median {statistics.median(v):.3f} "
                                f"({len(v)})" for d, v in sorted(by.items())),
          flush=True)

    k0 = len(st.out_events)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(warm + n_un, warm + n_un + n):
            frame(i)
        torch.cuda.synchronize()
        st.join()
    n_ev = len(st.out_events) - k0
    ka = prof.key_averages()

    def dev_us(e):
        return _dev_us(e, "self_device_time_total")

    on_device = [e for e in ka if e.device_type != DeviceType.CPU
                 and not e.key.startswith(("rgbd.", "stream."))]
    device_ms = sum(dev_us(e) for e in on_device) / 1e3 / n
    count = {e.key: e.count for e in ka}
    launches = sum(count.get(k, 0) for k in ("cudaLaunchKernel",
                                             "cuLaunchKernel",
                                             "cudaLaunchKernelExC"))
    syncs = sum(c for k, c in count.items() if "Synchronize" in k)
    print(f"profiler, frames {warm + n_un}-{warm + n_un + n - 1} ({n_ev} "
          f"stream events) [{smi}]: device {device_ms:.3f} ms/frame, busy "
          f"{device_ms / wall:.4f} of the unprofiled mean frame, "
          f"{launches / n:.1f} launches and {syncs / n:.1f} syncs per frame")
    print("  rgbd.* (host ms/frame under the profiler, device ms/frame):")
    for name, (host, dev) in stage_times(prof, n, "rgbd.").items():
        print(f"    {name}: host {host:.3f}, device {dev:.3f}")
    print("  stream.* (host ms/event under the profiler, device ms/event):")
    for name, (host, dev) in stage_times(prof, max(n_ev, 1),
                                         "stream.").items():
        print(f"    {name}: host {host:.3f}, device {dev:.3f}")
    for e in st.out_events[k0:]:
        print("  event: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in e.items()))
    for e in sorted(on_device, key=dev_us, reverse=True)[:10]:
        print(f"    {dev_us(e) / n / 1e3:.4f} ms/frame  x{e.count / n:<6.1f} "
              f"{e.key[:90]}")


def _root_library(root):
    """(module, library): ROOT's own ops/cuda_lib.py, loaded under another
    module name, and the kernel library it builds from ROOT's csrc into
    ROOT's _build, with ROOT's launch signatures."""
    import importlib.util
    path = os.path.join(root, "mrhash_tpu_torch", "ops", "cuda_lib.py")
    name = "cuda_lib_" + str(abs(hash(os.path.abspath(root))))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.library()


def _ptxas_lines(root):
    """nvcc -Xptxas -v over ROOT's K1, K3 and K4/K5 sources: each kernel's
    registers, spills and stack."""
    import tempfile
    mod, _ = _root_library(root)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("fused_integrate.cu", "fused_integrate_points.cu",
                    "blend_tiles.cu"):
            r = subprocess.run(
                [mod._nvcc(), *mod.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src + ".o"), os.path.join(mod.CSRC, src)],
                capture_output=True, text=True)
            out += [ln.strip() for ln in r.stderr.splitlines()
                    if "entry function" in ln or "spill" in ln
                    or "Used" in ln]
    return out


def _packed_mask(mod):
    """Whether ROOT's K4 writes the bit-packed mask (i32[T,K,8]) rather
    than the i8 [T,K,256] one that an earlier K5 packed itself."""
    with open(os.path.join(mod.CSRC, "blend_tiles.cu")) as f:
        return "pack_mask_row" not in f.read()


def _k3_one_launch(mod):
    """Whether ROOT's K3 serves both resolutions in one launch (n0, n1)
    rather than one launch per resolution (n, res)."""
    return "mrhash_fused_integrate_points_floor" in mod.SIGNATURES


def kernels_ab(roots):
    """K1's res-0 and res-1 paths, K3's res-0 and res-1 paths and the
    mixed multi-res window, K4 (K = 64) and K5 (K = 64 and 128) built from
    each of `roots` and from this checkout, on chip_smoke.py's phase-3
    inputs (K1: the frame-41 window of the RGB-D orbit, single-res for res
    0 and multi-res for res 1; K3: the scan-21 window of the LiDAR scans,
    single-res and multi-res; K4, K5: the training render of frame 1 of
    the GS scene), each held against this checkout's kernel once and then
    timed in turns (CUDA-graph replay of REPEAT calls, CUDA events), a
    version's pool updates on its own copy.  A K3 of one launch per
    resolution takes two launches for the mixed window."""
    import ctypes

    import torch

    from mrhash_tpu_torch.core.state import pack_rgb
    from mrhash_tpu_torch.gs import blend as B
    from mrhash_tpu_torch.gs import rasterizer as R
    from mrhash_tpu_torch.gs.container import _cam_dict
    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import cuda_lib
    from mrhash_tpu_torch.ops import fused_integrate as FI
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    roots = [os.path.abspath(r) for r in roots] + [here]
    libs = {r: _root_library(r) for r in roots}
    smi = S.nvidia_smi_line()
    for r in roots:
        print(f"ptxas {r}:", flush=True)
        for ln in _ptxas_lines(r):
            print("  " + ln, flush=True)
    p, dev = cuda_lib.ptr, torch.device("cuda")

    def in_turns(calls):
        replay = {r: S.graphed(f) for r, f in calls.items()}
        order = roots + roots[::-1]
        ms = {r: [] for r in roots}
        for k in range(S.TURNS * len(roots)):
            r = order[k % len(order)]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay[r]()
            b.record()
            torch.cuda.synchronize()
            ms[r].append(a.elapsed_time(b) / S.REPEAT)
        return {r: statistics.median(v) for r, v in ms.items()}

    result = {}
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (S.ROWS, S.COLS, 3)).astype(np.uint8)
    depths = [S.room_depth(*S.orbit_pose(i)[:2], rng) for i in range(S.ORBIT)]
    rgbp = pack_rgb(torch.from_numpy(rgb).to(dev)).contiguous()
    # K1 on the frame-41 window: res 0 over the single-res window, res 1
    # over the res-1 entries of the multi-res window
    for kind, multires in ((0, False), (1, True)):
        gw = S.make_wrapper("cuda", multires=multires)
        for i in range(S.ORBIT):
            S.feed(gw, i, depths, rgb)
        cfg = gw.cfg
        cam, pc_depth, (_, bpos, bptr, bres) = S.rgbd_window(gw, depths,
                                                             S.ORBIT)
        A = bpos.shape[0]
        cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size,
                                  cfg.sdf_truncation,
                                  cfg.sdf_truncation_scale,
                                  cfg.max_integration_distance,
                                  cfg.integration_weight_sample,
                                  cfg.integration_weight_max)
        src = gw.state.pool
        del gw
        entries = torch.nonzero(bres == kind).flatten()
        n = entries.numel()
        sub = tuple(t[entries].contiguous() for t in (bpos, bptr, bres))
        pools = dict(zip(roots, S.clone_pools(src, len(roots))))
        flags = {r: torch.empty((A, 4), device=dev) for r in roots}

        def k1(r):
            mod, lib = libs[r]
            q, f = pools[r], flags[r]
            return lambda: mod.check(lib.mrhash_fused_integrate_window(
                p(pc_depth), p(rgbp), pc_depth.shape[1], p(cam_vec), p(bpos),
                p(bptr), p(entries), n, kind, p(q.sdf), p(q.sumsq),
                p(q.weight), p(q.rgbp), p(f), cuda_lib.stream_of(pc_depth)),
                r)
        for r in roots:
            k1(r)()
        torch.cuda.synchronize()
        for r in roots:
            err = S.window_error([pools[r], pools[here]], *sub[1:])
            assert err["weight"] == 0 and err["rgbp"] == 0, (r, err)
            assert err["sdf"] <= S.TOL["sdf"], (r, err)
            assert torch.equal(flags[r][entries, :3],
                               flags[here][entries, :3]), r
        updated, _ = S.window_count(pools[here], src, *sub[1:])
        t = in_turns({r: k1(r) for r in roots})
        nvox = 512 if kind == 0 else 64
        nbytes = (n * nvox * 12 + updated * 20 + S.ROWS * S.COLS * 8
                  + n * (12 + 4 + 8) + 128 + n * 16)
        result[f"k1_res{kind}"] = dict(
            ms=t, entries=n, updated=updated,
            bound_ms=S.bound(nbytes, n * nvox * 60)[0])
        del pools, flags, src

    # K3 on the scan-21 window: res 0 over the single-res window, res 1
    # over the res-1 entries of the multi-res window, and that whole window
    from mrhash_tpu_torch.ops import alloc_blocks as AB
    from mrhash_tpu_torch.ops import integrate as I
    clouds = [S.lidar_cloud(S.lidar_pose(i), rng) for i in range(S.L_FRAMES)]
    for multires in (False, True):
        gw = S.make_lidar_wrapper("cuda", clouds[0], multires)
        for i in range(S.L_COMPARE_AT):
            S.feed_lidar(gw, i, clouds)
        cfg = gw.cfg
        cam = C.with_pose(gw.camera, gw.curr_rot,
                          S.lidar_pose(S.L_COMPARE_AT))
        points = torch.from_numpy(clouds[S.L_COMPARE_AT]).to(dev)
        keys, valid = AB.alloc_candidates_points(
            cfg, cam, points, cfg.dda_steps(cfg.max_integration_distance))
        I.alloc_blocks(cfg, gw.state.table, keys, valid, gw.state.frame)
        _, bpos, bptr, bres = I.compact_active(cfg, gw.state.table)
        img, pix, r_vox, ptr, res, consts = I.points_window(
            cfg, cam, points, bpos, bptr, bres)
        src = gw.state.pool
        del gw
        A = ptr.shape[0]
        e0 = torch.nonzero(res == 0).flatten()
        e1 = torch.nonzero(res == 1).flatten()
        order = torch.argsort(res, stable=True)
        cf = [ctypes.c_float(float(v)) for v in consts]
        cases = [("k3_mixed", order, e0.numel(), e1.numel())] if multires \
            else [("k3_res0", e0, e0.numel(), 0)]
        if multires:
            cases.insert(0, ("k3_res1", e1, 0, e1.numel()))
        for name, ent, n0, n1 in cases:
            pools = dict(zip(roots, S.clone_pools(src, len(roots))))
            flags = {r: torch.zeros((A, 4), device=dev) for r in roots}

            def k3(r):
                mod, lib = libs[r]
                q, f = pools[r], flags[r]
                tail = [*cf, p(q.sdf), p(q.sumsq), p(q.weight), p(f)]
                fn = lib.mrhash_fused_integrate_points_window
                if _k3_one_launch(mod):
                    return lambda: mod.check(fn(
                        p(img), p(pix), p(r_vox), p(ptr), p(ent), n0, n1,
                        *tail, cuda_lib.stream_of(img)), r)
                parts = [(ent[:n0], n0, 0), (ent[n0:], n1, 1)]

                def two():
                    for sub, n, kind in parts:
                        if n:
                            mod.check(fn(p(img), p(pix), p(r_vox), p(ptr),
                                         p(sub), n, kind, *tail,
                                         cuda_lib.stream_of(img)), r)
                return two
            for r in roots:
                k3(r)()
            torch.cuda.synchronize()
            sub = tuple(t[ent] for t in (ptr, res))
            for r in roots:
                err = S.window_error([pools[r], pools[here]], *sub,
                                     ("sdf", "sumsq", "weight"))
                assert all(v == 0 for v in err.values()), (r, err)
                assert torch.equal(flags[r][ent, :3], flags[here][ent, :3])
            upd, wgt = S.window_count(pools[here], src, *sub)
            nvox = (n0 * 512 + n1 * 64)
            t = in_turns({r: k3(r) for r in roots})
            result[name] = dict(
                ms=t, entries=[n0, n1], updated=upd,
                bound_ms=S.bound(S.k3_bytes(n0 + n1, nvox / (n0 + n1), wgt,
                                            upd), nvox * 15)[0])
            del pools, flags
        del src

    # K4 and K5 on the GS training render of frame 1
    train, _, _ = S.gs_frames(np.random.default_rng(0))
    gw = S.make_gs_wrapper("cuda")
    for f in train:
        S.feed_gs(gw, f)
    gc = gw.gs_container
    cam = C.with_pose(gw.camera, train[1]["rot"], train[1]["trans"])
    params, cd = gc.model.params(), _cam_dict(cam)
    bg = gc.model.background
    gt = torch.from_numpy(train[1]["rgb"]).to(dev).to(torch.float32)
    for K in (S.GS_K, S.GS_FINAL_K):
        with torch.no_grad():
            b = R.bin_and_gather(params, cd, gc.p.sh_degree, max_per_tile=K)
        attr, valid, gx = b["attr"].contiguous(), b["valid"], b["grid_x"]
        T = valid.shape[0]
        c = S.blend_case(attr, valid, gx, b["grid_y"], bg, gt, S.ROWS,
                         S.COLS)
        masks = {True: c["mk"], False: B.unpack_mask(c["mk"])}
        if K == S.GS_K:
            fwd = {r: (torch.empty((T, 256), device=dev),
                       torch.empty((T, 256, 3), device=dev),
                       torch.empty_like(masks[_packed_mask(libs[r][0])]))
                   for r in roots}

            def k4(r):
                mod, lib = libs[r]
                args = [p(attr), p(valid), T, K, gx,
                        *(p(x) for x in fwd[r])]
                return lambda: mod.check(lib.mrhash_blend_forward(
                    *args, cuda_lib.stream_of(attr)), r)
            for r in roots:
                k4(r)()
            torch.cuda.synchronize()
            for r in roots:
                tf, cf_, m = fwd[r]
                assert torch.equal(tf, fwd[here][0]), r
                assert torch.equal(cf_, fwd[here][1]), r
                bits = B.unpack_mask(m) if _packed_mask(libs[r][0]) else m
                assert torch.equal(bits, masks[False]), r
            t = in_turns({r: k4(r) for r in roots})
            result["k4_K64"] = dict(
                ms=t, tiles=T, valid_slots=c["slots"],
                warp_steps=c["walked4"],
                exit_warp_steps=c["walked"] - c["walked4"],
                bound_ms=S.bound(S.k4_bytes(T, K), c["slots"] * 256 * 30)[0])
            del fwd
        outs = {r: torch.empty((T, K, 9), device=dev) for r in roots}

        def k5(r):
            mod, lib = libs[r]
            head = [p(attr)]
            if len(mod.SIGNATURES["mrhash_blend_backward"]) == 11:
                head.append(p(valid))    # K5 that walks from the last valid
            args = [*head, T, K, gx, p(c["Tk"]),
                    p(masks[_packed_mask(mod)]), p(c["gT"]), p(c["gC"]),
                    p(outs[r])]
            # the stream is read at each call: a CUDA-graph capture runs
            # on a side stream
            return lambda: mod.check(lib.mrhash_blend_backward(
                *args, cuda_lib.stream_of(attr)), r)
        for r in roots:
            k5(r)()
        torch.cuda.synchronize()
        for r in roots:
            torch.testing.assert_close(outs[r], outs[here], atol=1e-4,
                                       rtol=1e-4)
            print(f"k5_K{K} {r}: max |diff| from this checkout's "
                  f"{float((outs[r] - outs[here]).abs().max())}", flush=True)
        t = in_turns({r: k5(r) for r in roots})
        result[f"k5_K{K}"] = dict(
            ms=t, tiles=T, valid_slots=c["slots"], warp_steps=c["walked"],
            busy_warp_steps=c["busy"],
            bound_ms=S.bound(S.k5_bytes(T, K, c["slots"]),
                             c["slots"] * 256 * 70)[0])
        del b, attr, valid, c, outs, masks
    for name, rec in result.items():
        for r in roots:
            print(f"{name} {r}: {rec['ms'][r]:.4f} ms (bound "
                  f"{rec['bound_ms']:.4f} ms) [{smi}]", flush=True)
    print(json.dumps(dict(card=smi, kernels=result)), flush=True)


def mesh_profile(smi):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mrhash_tpu_torch import geowrapper

    default = (geowrapper.MESH_MAX_CELLS, geowrapper.MESH_CHUNK)

    def sweep(gw, name, max_cells, chunk, profiled=False):
        geowrapper.MESH_MAX_CELLS, geowrapper.MESH_CHUNK = max_cells, chunk
        try:
            if not profiled:
                rec, tris = S.device_sweep(gw)
            else:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    rec, tris = S.device_sweep(gw)
                count = {e.key: e.count for e in prof.key_averages()}
                launches = sum(count.get(k, 0) for k in (
                    "cudaLaunchKernel", "cudaLaunchKernelExC"))
                syncs = sum(c for k, c in count.items()
                            if "Synchronize" in k)
                print(f"mesh {name} profiled: {launches} launches, {syncs} "
                      f"syncs: {launches / rec['cell_batches']:.1f} and "
                      f"{syncs / rec['cell_batches']:.1f} per cell batch, "
                      f"{launches / rec['windows']:.1f} and "
                      f"{syncs / rec['windows']:.1f} per window", flush=True)
        finally:
            geowrapper.MESH_MAX_CELLS, geowrapper.MESH_CHUNK = default
        print(f"mesh {name} max_cells 2^{max_cells.bit_length() - 1} chunk "
              f"2^{chunk.bit_length() - 1}{' (profiled)' if profiled else ''}"
              f": {rec['s']:.2f} s (insert {rec['insert_s']:.2f}, extract "
              f"{rec['extract_s']:.2f}, clear {rec['clear_s']:.2f}, host "
              f"{rec['host_s']:.2f}), {rec['batches']} chunk batches, "
              f"{rec['windows']} windows, {rec['cells']} gated cells in "
              f"{rec['cell_batches']} cell batches, {rec['triangles']} "
              f"triangles, peak {rec['peak_gib']:.3f} GiB [{smi}]",
              flush=True)
        torch.cuda.empty_cache()
        return tris[0].shape[0]

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (S.ROWS, S.COLS, 3)).astype(np.uint8)
    depths = [S.room_depth(*S.orbit_pose(i)[:2], rng)
              for i in range(S.ORBIT)]
    gw = S.make_wrapper("cuda", multires=True)
    for i in range(S.N_FRAMES):
        S.feed(gw, i, depths, rgb)
    gw.streamAllOut()
    sizes = [(1 << 16, 1 << 13), (1 << 18, 1 << 13), (1 << 20, 1 << 13),
             (1 << 21, 1 << 13), (1 << 20, 1 << 12), (1 << 20, 1 << 14),
             (1 << 20, 1 << 15)]
    # the first sweep pays the allocator's growth: it runs twice
    counts = {sweep(gw, "multires", *sz) for sz in [default] + sizes}
    sweep(gw, "multires", *default, profiled=True)
    assert len(counts) == 1, counts
    del gw
    torch.cuda.empty_cache()

    wd = S.walk_depths()
    wrgb = np.random.default_rng(0).integers(0, 255, (S.ROWS, S.COLS, 3)
                                             ).astype(np.uint8)
    gw = S.make_walk_wrapper("cuda")
    for i in range(S.W_WARM + S.W_TIMED):
        S.walk_frame(gw, S.W_STEP * i, i, wd, wrgb)
    gw.streamAllOut()
    counts = {sweep(gw, "walk", *sz) for sz in (
        default, (1 << 18, 1 << 13), (1 << 20, 1 << 13), (1 << 21, 1 << 13),
        (1 << 20, 1 << 15))}
    assert len(counts) == 1, counts


def scan_profile(smi, label, make, feed, stage_cost=False):
    """Steps 1 and 2 of the LiDAR forms for one wrapper: `make()` builds
    it, `feed(gw, i)` runs scan i.  Returns the profiled wrapper and the
    profiled scan count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mrhash_tpu_torch.utils.profiler import stage

    # 1. unprofiled scan time, as chip_smoke.py's phases take it
    gw = make()
    scan_ms = []
    for i in range(S.L_FRAMES):
        t0 = time.perf_counter()
        feed(gw, i)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(scan_ms[S.L_STEADY:])
    print(f"{label}: scan, median over scans {S.L_STEADY}-"
          f"{S.L_FRAMES - 1}: {wall:.3f} ms [{smi}]")

    if stage_cost:
        # host cost of a stage range while no profiler runs, and of an
        # idle record_function, which stage() skips
        for name, fn in (("stage()", stage),
                         ("record_function", record_function)):
            reps = 10000
            t0 = time.perf_counter()
            for _ in range(reps):
                with fn("points.idle"):
                    pass
            print(f"{name}, no profiler: "
                  f"{(time.perf_counter() - t0) / reps * 1e6:.2f} us per "
                  "range")

    # 2. profiler over 10 steady scans through GeoWrapper.compute
    gw = make()
    for i in range(S.L_STEADY):
        feed(gw, i)
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(S.L_STEADY, S.L_STEADY + n):
            feed(gw, i)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    def dev_us(e):
        return _dev_us(e, "self_device_time_total")

    # device-side events only: kernels, copies and sets, not the ranges'
    # device spans (a host op's own device time repeats its kernels')
    on_device = [e for e in ka if e.device_type != DeviceType.CPU
                 and not e.key.startswith("points.")]
    device_ms = sum(dev_us(e) for e in on_device) / 1e3 / n
    count = {e.key: e.count for e in ka}
    launches = sum(count.get(k, 0) for k in ("cudaLaunchKernel",
                                             "cuLaunchKernel",
                                             "cudaLaunchKernelExC"))
    syncs = sum(c for k, c in count.items() if "Synchronize" in k)
    k3 = [e for e in ka if "fused_integrate_points_kernel" in e.key]
    k3_us = (dev_us(k3[0]) / k3[0].count) if k3 else float("nan")
    print(f"{label}: profiler, {n} scans [{smi}]: device {device_ms:.3f} "
          f"ms/scan, busy {device_ms / wall:.4f} of the unprofiled scan, "
          f"{launches / n:.1f} kernel launches and {syncs / n:.1f} host "
          f"syncs per scan, K3 {k3_us:.2f} us device per launch")
    print(f"{label}: stages (torch.profiler ranges; host ms/scan under the "
          "profiler, device ms/scan):")
    for name, (host, dev) in stage_times(prof, n).items():
        print(f"  {name}: host {host:.3f}, device {dev:.3f}")
    top = sorted(on_device, key=dev_us, reverse=True)[:8]
    for e in top:
        print(f"  {dev_us(e) / n / 1e3:.4f} ms/scan  x{e.count // n:<4d} "
              f"{e.key[:90]}")
    return gw, n


SYNC_FRAMES = 12


def sync_sites_run():
    """The --syncs form's run with whichever mrhash_tpu_torch is first
    on sys.path; prints a JSON line {package, cells: {cell: [{prof,
    counted, sites}, ...]}}."""
    import traceback
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import mrhash_tpu_torch
    here = os.path.dirname(os.path.abspath(__file__))
    bench_dir = os.path.join(here, "benchmark")
    sys.path.insert(1, bench_dir)
    import harness
    import program
    import scenes
    pkg = os.path.dirname(mrhash_tpu_torch.__file__)
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        # the innermost frame of the package outside the counting helpers
        stack = traceback.extract_stack()[:-1]
        for fr in reversed(stack):
            if (fr.filename.startswith(pkg) and not fr.filename.endswith(
                    os.path.join("utils", "profiler.py"))):
                sites.append(f"{os.path.relpath(fr.filename, pkg)}:"
                             f"{fr.lineno}")
                return
        sites.append(" < ".join(f"{os.path.basename(fr.filename)}:"
                                f"{fr.lineno}" for fr in stack[::-1][:6]))

    out = {}
    for cell in ("replica_rgbd_mr.orbit", "newer_college_lidar_mr.loop"):
        _, _, conf, traffic, _ = harness.load_cell(
            os.path.join(here, "BENCHMARK.json"), cell, bench_dir)
        frames = scenes.make(traffic, conf["sensor"], 1, "cuda")
        gw = program.build(conf, frames, torch.device("cuda"))
        warm = traffic["warmup_frames"]
        for i in range(warm):
            program.feed(gw, frames, i)
        torch.cuda.synchronize()
        compute, rows = gw.compute, []

        def traced_compute():
            with record_function("probe.compute"):
                compute()
        gw.compute = traced_compute
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(warm, warm + SYNC_FRAMES):
                del sites[:]
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = show
                    torch.cuda.set_sync_debug_mode("warn")
                    st = program.feed(gw, frames, i)
                    torch.cuda.set_sync_debug_mode("default")
                by_site = {}
                for k in sites:
                    by_site[k] = by_site.get(k, 0) + 1
                rows.append(dict(counted=st.get("host_syncs"),
                                 sites=by_site))
            torch.cuda.synchronize()
        # host events only: a range also has a device-side twin
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CPU]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == "probe.compute")
        syncs = [e.time_range.start for e in events
                 if "Synchronize" in e.name]
        for row, (a, b) in zip(rows, spans):
            row["prof"] = sum(a <= t <= b for t in syncs)
        gw.compute = compute
        program.close(gw)
        out[cell] = rows
        del gw
        torch.cuda.empty_cache()
    print(json.dumps(dict(package=pkg, cells=out)), flush=True)


def sync_sites(other_root=None):
    """The --syncs form: sync_sites_run in a fresh process for this
    checkout (and OTHER_ROOT); prints per cell and frame the profiler's
    synchronizations, host_syncs and the other side's synchronizations,
    then each site's syncs per frame."""
    here = os.path.dirname(os.path.abspath(__file__))
    mine = _run_in(here, "sync_sites_run")["cells"]
    other = (_run_in(os.path.abspath(other_root), "sync_sites_run")["cells"]
             if other_root else None)
    print(f"--syncs [{S.nvidia_smi_line()}]: per frame (profiler, "
          "host_syncs" + (", OTHER_ROOT's profiler)" if other else ")"))
    for cell, rows in mine.items():
        per = [(r["prof"], r["counted"]) + (
            (other[cell][k]["prof"],) if other else ())
            for k, r in enumerate(rows)]
        print(f"  {cell}: {per}")
        total = {}
        for r in rows:
            for k, v in r["sites"].items():
                total[k] = total.get(k, 0) + v
        print(f"  {cell}: sites, syncs per frame over {len(rows)} frames "
              "(set_sync_debug_mode warnings):")
        for k, v in sorted(total.items(), key=lambda kv: -kv[1]):
            print(f"    {v / len(rows):6.2f}  {k}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is False")
    import numpy as np

    from mrhash_tpu_torch.ops import camera as C
    from mrhash_tpu_torch.ops import fused_integrate_points as FIP
    from mrhash_tpu_torch.ops import integrate as I

    if len(sys.argv) == 3 and sys.argv[1] == "--rgbd-ab":
        return rgbd_ab(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--gs-ab":
        return gs_ab(sys.argv[2])
    if len(sys.argv) >= 3 and sys.argv[1] == "--kernels-ab":
        return kernels_ab(sys.argv[2:])
    if sys.argv[1:2] == ["--syncs"] and len(sys.argv) <= 3:
        return sync_sites(*sys.argv[2:])
    smi = S.nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    if sys.argv[1:] == ["--gs"]:
        return gs_profile(smi)
    if sys.argv[1:] == ["--multires"]:
        return multires_profile(smi)
    if sys.argv[1:] == ["--walk"]:
        return walk_profile(smi)
    if sys.argv[1:] == ["--mesh"]:
        return mesh_profile(smi)
    rng = np.random.default_rng(0)
    clouds = [S.lidar_cloud(S.lidar_pose(i), rng) for i in range(S.L_FRAMES)]
    if sys.argv[1:] == ["--points"]:     # phase 11's passes (a) and (b)
        for label, projective in (("(a) point-centric", False),
                                  ("(b) projective", True)):
            scan_profile(smi, f"phase 11 {label}", lambda p=projective: (
                S.make_lidar_wrapper("cuda", clouds[0], n_starve=S.L_STARVE,
                                     projective=p)),
                lambda gw, i, p=projective: S.feed_lidar(gw, i, clouds,
                                                         not p))
        return
    gw, n = scan_profile(
        smi, "phase 5", lambda: S.make_lidar_wrapper("cuda", clouds[0]),
        lambda gw, i: S.feed_lidar(gw, i, clouds), stage_cost=True)

    # 3. K3's host cost per launch, no sync in between
    cfg, st = gw.cfg, gw.state
    cam = C.with_pose(gw.camera, gw.curr_rot, gw.curr_trans)
    points = torch.from_numpy(clouds[S.L_STEADY + n - 1]).to("cuda")
    _, bpos, bptr, bres = I.compact_active(cfg, st.table)
    img, pix, r_vox, ptr, res, consts = I.points_window(cfg, cam, points,
                                                        bpos, bptr, bres)
    entries = torch.arange(bpos.shape[0], device="cuda")
    flags = torch.empty((bpos.shape[0], FIP.N_FLAGS), device="cuda")
    n0 = bpos.shape[0]
    FIP._launch(st.pool, img, pix, r_vox, ptr, entries, n0, consts, flags)
    torch.cuda.synchronize()
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        FIP._launch(st.pool, img, pix, r_vox, ptr, entries, n0, consts,
                    flags)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    print(f"K3 host cost per launch {host_us:.2f} us over {bpos.shape[0]} "
          f"blocks [{smi}]")


if __name__ == "__main__":
    main()
