"""ROS1 bag LiDAR runner on the port (the VBR entry point; a copy of
mrhash_tpu/apps/rosbag_runner.py, after mrhash/apps/rosbag_runner.py):
PointCloud2 scans of a bag topic, ground-truth poses matched by nearest
timestamp from a TUM file, the camera-in-LiDAR extrinsic from the VBR
calibration YAML, then ply_runner's loop.  Reading a bag needs the
`rosbags` package, which is imported when a bag is opened: without it the
runner raises a clear ImportError.

    python -m mrhash_tpu_torch.apps.rosbag_runner configurations/vbr.cfg
"""
from __future__ import annotations

import argparse

import numpy as np

from mrhash_tpu_torch.apps.ply_runner import lidar_loop
from mrhash_tpu_torch.apps.runner_common import load_config
from mrhash_tpu_torch.apps.utils.parse_trajectory import (nearest_pose,
                                                          parse_tum_trajectory)
from mrhash_tpu_torch.apps.utils.point_cloud2 import read_points
from mrhash_tpu_torch.apps.utils.readers import _IterReader, rot_to_quat


class Ros1Reader(_IterReader):
    """AnyReader over a bag's PointCloud2 topic with TUM ground-truth pose
    matching by nearest timestamp (ros_reader.py:13-169)."""

    def __init__(self, bag_path, topic, gt_path, min_range=0.01,
                 max_range=100):
        try:
            from pathlib import Path

            from rosbags.highlevel import AnyReader
        except ImportError as e:
            raise ImportError(
                "rosbag_runner requires the 'rosbags' package, which is not "
                "installed in this environment") from e
        self.reader = AnyReader([Path(bag_path)])
        self.reader.open()
        self.connections = [c for c in self.reader.connections
                            if c.topic == topic]
        self.msgs = list(self.reader.messages(connections=self.connections))
        self.trajectory = parse_tum_trajectory(gt_path)
        self.min_range = min_range
        self.max_range = max_range
        self.file_index = 0

    def __len__(self):
        return len(self.msgs)

    def __getitem__(self, item):
        conn, timestamp, raw = self.msgs[item]
        msg = self.reader.deserialize(raw, conn.msgtype)
        pts = read_points(msg, field_names=("x", "y", "z"))
        pts = np.stack([pts["x"], pts["y"], pts["z"]], axis=1)
        pose = nearest_pose(self.trajectory, timestamp * 1e-9)
        quat = rot_to_quat(pose[:3, :3])
        norms = np.linalg.norm(pts, axis=1)
        mask = (norms >= self.min_range) & (norms <= self.max_range)
        return pose[:3, 3], quat, pts[mask].astype(np.float64)


def main(config_path, **kw):
    config, cfg = load_config(config_path)
    sensor = cfg["sensor"]
    topic = cfg.get("topic") or sensor.get("rosbag_topic")
    reader = Ros1Reader(cfg["data_path"], topic, cfg["gt_path"],
                        min_range=sensor["min_depth"],
                        max_range=sensor["max_depth"])
    # VBR datasets ship a camera<->LiDAR calibration YAML (vbr.cfg path);
    # parse it and hand the camera-in-LiDAR extrinsic to the wrapper
    # (setCameraInLidar, geowrapper.cpp:94-96)
    calib = cfg.get("calib_path")
    if calib:
        from mrhash_tpu_torch.apps.utils.parse_calib_file import (
            read_lidar_T_camera)
        kw.setdefault("camera_in_lidar", read_lidar_T_camera(calib))
    return lidar_loop(reader, cfg, config, **kw)


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config_path", nargs="?",
                    default="configurations/vbr.cfg")
    ap.add_argument("--end-frame", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.config_path, end_frame_override=args.end_frame,
         device=args.device)


if __name__ == "__main__":
    run()
