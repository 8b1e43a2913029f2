"""One run of one cell: set-up, warm-up, the timed window (or the traced
stretch), the comparison with the plain reference, one result.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name BENCHMARK.json
gives it, under the benchmark's folder:

  configs/<configuration>.json   sensor, map settings, capacities, source
                                 (the configuration's `file`)
  traffic/<mix>.json             the scene kind and its parameters, read by
                                 scenes.py, with the warm-up and traced
                                 frame counts
  scene_kinds/<kind>.py          make(traffic, sensor, gen, device), a
                                 scene kind scenes.py does not hold
  metrics/<per-layer metric>.py  read(trace) -> number or None
  limits/<cell>.json             the limit of each number compared

The program is built with profiling off and closed before the reference
runs, so its streamer thread has ended and its pool is freed.  Its map is
the union of its device map and the blocks it streamed to its host grid;
the reference never streams (reference/replay.py).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import torch

import compare
import program
import scenes
import tracing
from reference import replay
from reference.state import ReplayLimit

FORBIDDEN = ("jax", "jaxlib", "flax", "mrhash_tpu")
GIB = float(1 << 30)
HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_reader(base, name):
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench, kind, cell):
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports: those listing it under `workloads`, and those listing none."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def p95(values):
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(bench_path, cell, base=HERE):
    """(BENCHMARK.json's content, the cell's entry, its configuration, its
    traffic mix, its limits), each found by name."""
    bench = load_json(bench_path)
    w = find(bench["workloads"], cell, "workload")
    conf = load_json(os.path.join(os.path.dirname(bench_path), find(
        bench["configs"], w["config"], "configuration")["file"]))
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(base, "limits", f"{cell}.json"))
    return bench, w, conf, traffic, limits


def run_cell(bench_path, cell, seed, seconds, trace, device="cuda",
             t_start=None, base=HERE):
    """Run `cell` of the BENCHMARK.json at bench_path once, with the
    configurations, mixes, readers and limits under `base`; returns the
    result dict (the last line's object)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    bench, w, conf, traffic, limits = load_cell(bench_path, cell, base)
    readers = {m["name"]: load_reader(base, m["name"])
               for m in metrics_of(bench, "per_layer", cell)} if trace else {}

    # --- set-up: inputs, the program, the warm-up ---------------------------
    frames = scenes.make(traffic, conf["sensor"], seed, device, base)
    gw = program.build(conf, frames, device)
    warm = traffic["warmup_frames"]
    for i in range(warm):
        program.feed(gw, frames, i)
    sync(device)
    setup_s = time.perf_counter() - t_start

    # --- the timed window, or the traced stretch -----------------------------
    ms, stats = [], []
    if trace:
        t0 = time.perf_counter()
        events = tracing.profile_frames(
            lambda i: program.feed(gw, frames, i), warm,
            traffic["trace_frames"], stats, lambda: sync(device), cuda)
        window_s = time.perf_counter() - t0
        log(f"traced stretch: {len(stats)} frames, {window_s:.6f} s with "
            "the profiler's start, stop and export")
    else:
        i = warm
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            stats.append(program.feed(gw, frames, i))
            sync(device)
            b = time.perf_counter()
            ms.append((b - a) * 1e3)
            i += 1
            if b - t0 >= seconds:
                break
        window_s = b - t0
    n_frames = warm + len(stats)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    last = stats[-1]
    if ms:
        log(f"window: {len(ms)} frames in {window_s:.6f} s; frame ms median "
            f"{statistics.median(ms):.6f}, p95 {p95(ms):.6f}, max "
            f"{max(ms):.6f}")
        # a first fifth slower than the rest is warm-up inside the window
        k = max(1, len(ms) // 5)
        log("frame ms mean by fifths of the window: " + ", ".join(
            f"{statistics.mean(ms[j:j + k]):.3f}"
            for j in range(0, 5 * k, k) if ms[j:j + k]))
    log(f"set-up {setup_s:.6f} s ({warm} warm-up frames)")
    log(f"map at the window's end: {last['occupied_total']} blocks, window "
        f"{last['occupied_blocks']} ({last['res0_blocks']} at res 0), free "
        f"high blocks {last['high_free']} of {conf['map']['num_blocks']} "
        f"(streams at <= 15 %), free low {last['low_free']}; peak "
        f"{peak / GIB:.6f} GiB")

    # --- the program's map, then the reference's ------------------------------
    program.close(gw)
    prog_map, streams = program.read_map(gw)
    del gw
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"streams: {streams['events']} stream-out events, "
        f"{streams['blocks_out']} blocks out, {streams['blocks_in']} back "
        f"in; the host grid holds {streams['host_blocks']}; "
        f"{prog_map['dups']} further copies of a key (on the card and in "
        "the grid, or twice in the grid)")
    t_ref = time.perf_counter()
    info = {}
    try:
        ref_map = replay.replay(conf, frames, n_frames, device,
                                compare.map_content, info=info)
    except ReplayLimit as e:
        log(f"reference: {e}; the run is not correct")
        correct = False
        checks = {k: {"value": None, "limit": lim}
                  for k, lim in limits.items()}
    else:
        numbers = compare.compare(prog_map, ref_map)
        correct, checks = compare.judge(numbers, limits)
        log(f"reference: {n_frames} frames replayed in "
            f"{time.perf_counter() - t_ref:.6f} s; {numbers['ref_blocks']} "
            f"blocks, {numbers['matched_blocks']} matched, "
            f"{numbers['weighted_voxels']} weighted voxels compared; pool "
            f"{info['pool_blocks']} blocks (grew {info['grown']} times), "
            f"widest window {info['widest_window']} blocks (bound "
            f"{info['window_bound_m']} m); {info['full_window']} keys found "
            f"their probe window full, {info['lost_slot']} lost their slot to "
            "another of their batch (each waits for a later frame)")

    # --- the result -----------------------------------------------------------
    result = {"correct": bool(correct), "attempted": len(stats), "failed": 0}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(0) if cuda else device.type,
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        tr = tracing.Trace(events, len(stats), stats, conf)
        values = {name: read(tr) for name, read in readers.items()}
        dev.update(busy_s=tr.busy_us() / 1e6, window_s=tr.window_us / 1e6)
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    else:
        values = {"fps": len(stats) / window_s, "frame_ms_p95": p95(ms),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values = {m["name"]: values[m["name"]]
                  for m in metrics_of(bench, "end_to_end", cell)}
    result["metrics"] = {k: {"value": float(v), "unit": units[k]}
                         for k, v in values.items() if v is not None}
    result["device"] = dev
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
