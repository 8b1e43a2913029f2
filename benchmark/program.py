"""The system under test: mrhash_tpu_torch's GeoWrapper, built from a
configuration file and fed one frame at a time through its public API
(setCurrPose, setDepthImage + setRGBImage or setPointCloud, compute).

The map is read back once the window has closed, from the wrapper's
device state (hash table + voxel pool, the layout the port shares with
its checkpoint format), and handed to compare.py as host arrays.
"""
from __future__ import annotations

import dataclasses

import torch

from compare import map_content


def build(conf: dict, frames, device):
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    gw = GeoWrapper(**conf["map"], gs_optimization_param_path="",
                    profiling=False, device=device)
    if conf["map_config"]:
        gw.cfg = dataclasses.replace(gw.cfg, **conf["map_config"])
    s = conf["sensor"]
    if s["model"] == "spherical":
        fx, fy, cx, cy = frames.intrinsics
        gw.setCamera(fx, fy, cx, cy, s["rows"], s["cols"], s["min_depth"],
                     s["max_depth"], 1)
    else:
        gw.setCamera(s["fx"], s["fy"], s["cx"], s["cy"], s["rows"],
                     s["cols"], s["min_depth"], s["max_depth"])
    return gw


def feed(gw, frames, i):
    trans, quat = frames.pose(i)
    gw.setCurrPose(trans, quat)
    if frames.kind == "rgbd":
        depth, rgb = frames.inputs(i)
        gw.setDepthImage(depth)
        gw.setRGBImage(rgb)
    else:
        gw.setPointCloud(frames.inputs(i), False)
    gw.compute()
    return gw.last_stats


def read_map(gw):
    """The wrapper's map as host arrays (see compare.map_content), and the
    blocks it streamed out to host memory (0 unless the heap reached its
    watermark)."""
    st = gw.state
    return (map_content(st.table.pos, st.table.ptr, st.table.res,
                        st.pool.sdf, st.pool.sumsq, st.pool.weight,
                        st.pool.rgbp),
            gw.streamer.grid.num_blocks())


def close(gw):
    gw.close()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
