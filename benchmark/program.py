"""The system under test: mrhash_tpu_torch's GeoWrapper, built from a
configuration file and fed one frame at a time through its public API
(setCurrPose, setDepthImage + setRGBImage or setPointCloud, compute).

The map is read back once the window has closed and the wrapper is
closed (its stream-out worker joined): the wrapper's device state (hash
table + voxel pool, the layout the port shares with its checkpoint
format) together with every block its streamer moved to the host chunk
grid, handed to compare.py as host arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from compare import host_content, map_content, union


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
    """After close(): the union of the wrapper's device map and its host
    chunk grid as host arrays (compare.map_content's form, with "dups":
    the further copies of keys held twice), and the stream counts: the
    stream-out events, the blocks they moved out, and the blocks streamed
    back in."""
    st, streamer = gw.state, gw.streamer
    device = map_content(st.table.pos, st.table.ptr, st.table.res,
                         st.pool.sdf, st.pool.sumsq, st.pool.weight,
                         st.pool.rgbp)
    chunks = list(streamer.grid.chunks.values())
    maps = [device]
    if chunks:
        maps.append(host_content(*(
            np.concatenate([c[k] for c in chunks])
            for k in ("pos", "res", "sdf", "ssq", "w", "rgb"))))
    streams = dict(events=len(streamer.out_events),
                   blocks_out=sum(e["blocks"] for e in streamer.out_events),
                   blocks_in=sum(e["inserted"] for e in streamer.in_events),
                   host_blocks=sum(c["pos"].shape[0] for c in chunks))
    return union(*maps), streams


def close(gw):
    gw.close()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
