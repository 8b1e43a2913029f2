"""The traced run: torch.profiler over a steady stretch of frames, its
Chrome trace read back into plain lists that the per-layer readers
(metrics/<name>.py) take their numbers from.

The stretch is one host range `bench.window`, each frame inside it one
`bench.frame`; the program's own stage ranges (`rgbd.*`, `points.*`)
exist only while a profiler runs.  A device operation belongs to the host
range its launch was issued in: the runtime call that launched it (same
correlation id) lies inside the range on the host's clock.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW, FRAME = "bench.window", "bench.frame"


class Trace:
    """What the readers see.  Times in microseconds on the trace's clock.

    ranges: {name: [(start, end), ...]} host ranges (record_function);
    device: [(name, cat, start, end, correlation)] device operations
      inside the traced window;
    launches: {correlation: host time of the runtime call};
    frames: frames traced; stats: the program's last_stats of each traced
    frame; conf, sensor: the configuration file's content."""

    def __init__(self, events, frames, stats, conf):
        self.frames, self.stats, self.conf = frames, stats, conf
        self.sensor = conf["sensor"]
        self.ranges, self.device, self.launches = {}, [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat", ""), float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat == "user_annotation":
                self.ranges.setdefault(e["name"], []).append((ts, end))
            elif cat in DEVICE_CATS:
                self.device.append((e["name"], cat, ts, end, corr))
            elif cat == "cuda_runtime" and corr is not None:
                self.launches[corr] = ts
        (self.t0, self.t1), = self.ranges[WINDOW]
        self.device = sorted((d for d in self.device
                              if d[3] > self.t0 and d[2] < self.t1),
                             key=lambda d: d[2])

    @property
    def window_us(self):
        return self.t1 - self.t0

    def host_ms_per_frame(self, *names):
        """Host ms per traced frame inside the named ranges (0 where the
        ranges never opened), or None where none of them opened."""
        spans = [s for n in names for s in self.ranges.get(n, [])]
        if not spans:
            return None
        return sum(b - a for a, b in spans) / 1e3 / self.frames

    def device_us_in(self, name):
        """Device microseconds of the operations launched inside the host
        range `name`, or None where it never opened."""
        spans = sorted(self.ranges.get(name, []))
        if not spans:
            return None
        starts = [a for a, _ in spans]
        total = 0.0
        for _, _, a, b, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                total += b - a
        return total

    def busy_intervals(self):
        """The union of device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        out = []
        for _, _, a, b, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_us(self):
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_launches(self):
        return sum(1 for d in self.device if d[1] == "kernel")

    def innermost_range(self, t):
        """The name of the shortest host range holding time t, or "host
        between frames"."""
        best, best_len = "host between frames", float("inf")
        for name, spans in self.ranges.items():
            if name == WINDOW:
                continue
            for a, b in spans:
                if a <= t <= b and b - a < best_len:
                    best, best_len = name, b - a
        return best

    def breakdown(self, top=10):
        """{"device_ops": the operations with the most device seconds,
        "idle_gaps": idle device seconds by the host range open when each
        gap began}."""
        ops = {}
        for name, _, a, b, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        gaps, prev = {}, self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:
                k = self.innermost_range(prev)
                gaps[k] = gaps.get(k, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in rank(ops)],
                "idle_gaps": [[n, s] for n, s in rank(gaps)]}


def profile_frames(step, first, n, frames_stats, sync, cuda=True):
    """Run step(i) and sync() for frames first..first+n-1 under
    torch.profiler (CPU and, with `cuda`, CUDA activity), each in a
    `bench.frame` range inside one `bench.window`; append each frame's
    stats to frames_stats.  Returns
    the trace's events, read back from a Chrome trace written to (and
    removed from) the temporary directory."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for i in range(first, first + n):
                with record_function(FRAME):
                    frames_stats.append(step(i))
                    sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
