"""The yardstick of the roofline shares: the H100's published peaks and
the work each traced step needs, counted from the window's shapes (the
program's last_stats of each traced frame and the sensor's size), not
from what its kernels do.  Each input byte is counted as read once and
each output byte as written once (chip_smoke.py::bound, ::k3_bytes).

What the counts leave out makes the least time smaller, never larger, so a
share can only read low: the voxels a frame updates (no counter gives
their number), and a block that coarsened in the frame, counted as one of
64 voxels (the window's res-0 count is taken after coarsening).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
LANES, LOW_LANES = 512, 64
VOXEL_STATE = 12              # sdf f32, sumsq f32, weight: read to update
#                               and to reduce the GC and coarsening flags
SLOT = 16                     # a hash slot's block position and pointer
BUCKET_SLOTS = 10             # hash slots per bucket
WINDOW_ENTRY = 28             # slot i64, position 3 x i32, pointer, res
FLAGS = 16                    # f32[4] per window entry
PROJECT_FLOPS = 30            # rotate, translate, project, divide a voxel


def least_s(nbytes, flops):
    """The least time for these bytes and f32 operations at the peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def window_voxels(stats):
    n0 = stats["res0_blocks"]
    n1 = stats["occupied_blocks"] - n0
    return n0 * LANES + n1 * LOW_LANES


def rgbd_integrate(stats, sensor, num_buckets):
    """rgbd.integrate: the compaction reads each hash slot once and writes
    the window; the fused update reads the depth (f32) and colour (3 x u8)
    images once and each window voxel's state once, and writes each
    entry's flags.  Returns (bytes, flops)."""
    n, vox = stats["occupied_blocks"], window_voxels(stats)
    pixels = sensor["rows"] * sensor["cols"]
    nbytes = (num_buckets * BUCKET_SLOTS * SLOT + n * WINDOW_ENTRY + pixels * 7
              + vox * VOXEL_STATE + n * FLAGS)
    return nbytes, vox * PROJECT_FLOPS


def points_k3(stats, sensor):
    """points.K3: the range image (f32) read once, each window voxel's
    state once, each entry's flags written.  Returns (bytes, flops)."""
    n, vox = stats["occupied_blocks"], window_voxels(stats)
    nbytes = (sensor["rows"] * sensor["cols"] * 4 + vox * VOXEL_STATE
              + n * FLAGS)
    return nbytes, vox * PROJECT_FLOPS


def roofline_pct(trace, range_name, work):
    """100 x the least time of the traced frames' work over the device time
    of everything launched inside `range_name`; None where the range never
    opened or launched nothing."""
    dev_us = trace.device_us_in(range_name)
    if not dev_us:
        return None
    least = sum(least_s(*work(s)) for s in trace.stats)
    return 100.0 * least / (dev_us / 1e6)
