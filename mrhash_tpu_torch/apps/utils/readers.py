"""Dataset readers (a copy of mrhash_tpu/apps/utils/readers.py, after
mrhash/apps/utils/{depth_reader,ply_reader,kitti_reader,ros_reader}.py)
without the open3d/natsort/rosbags dependencies: natural sorting,
quaternion extraction and PLY loading are implemented inline.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(p))]
    return sorted(paths, key=key)


def rot_to_quat(rot):
    """Rotation matrix -> quaternion (x, y, z, w), scipy convention."""
    from scipy.spatial.transform import Rotation as R
    return R.from_matrix(rot).as_quat()


class _IterReader:
    def __len__(self):
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return

    def __iter__(self):
        self.file_index = 0
        return self

    def __next__(self):
        if self.file_index >= len(self):
            raise StopIteration
        out = self[self.file_index]
        self.file_index += 1
        return out


class DepthReader(_IterReader):
    """Replica/ScanNet layout: results/*.png depth + results/*.jpg rgb +
    traj.txt of row-major 4x4 poses (depth_reader.py:9-93)."""

    def __init__(self, data_dir, min_range=0.01, max_range=30,
                 depth_scaling=1000.0, **kw):
        data_dir = Path(data_dir)
        self.depth_file_names = natsorted(
            (data_dir / "results").glob("*.png"))
        self.rgb_file_names = natsorted((data_dir / "results").glob("*.jpg"))
        if len(self.depth_file_names) != len(self.rgb_file_names):
            raise RuntimeError(
                f"size mismatch depth: {len(self.depth_file_names)} != "
                f"{len(self.rgb_file_names)}")
        poses = np.loadtxt(data_dir / "traj.txt", delimiter=" ")
        self.gt_poses_list = poses.reshape((len(poses), 4, 4))
        self.min_range = min_range
        self.max_range = max_range
        self.depth_scaling = depth_scaling
        self.file_index = 0

    def __len__(self):
        return len(self.depth_file_names)

    def __getitem__(self, item):
        from PIL import Image
        pose = self.gt_poses_list[item]
        quat = rot_to_quat(pose[:3, :3])
        translation = pose[:3, 3]
        depth = (np.array(Image.open(self.depth_file_names[item]),
                          dtype=np.float32) / self.depth_scaling)
        rgb = np.array(Image.open(self.rgb_file_names[item]).convert("RGB"),
                       dtype=np.float32)
        return item + 1, translation, quat, depth, rgb


class PLYReader(_IterReader):
    """LiDAR clouds as ply/*.ply + poses.txt of 4x4 poses
    (ply_reader.py:9-81)."""

    def __init__(self, data_dir, min_range=0.01, max_range=100,
                 transform_pcd=False, **kw):
        data_dir = Path(data_dir)
        self.file_names = natsorted((data_dir / "ply").glob("*.ply"))
        poses = np.loadtxt(data_dir / "poses.txt", delimiter=" ")
        self.gt_poses_list = poses.reshape((len(poses), 4, 4))
        self.transform_pcd = transform_pcd
        self.min_range = min_range
        self.max_range = max_range
        self.file_index = 0

    def __len__(self):
        return len(self.file_names)

    def __getitem__(self, item):
        from mrhash_tpu_torch.utils.plyio import read_points_ply
        pose = self.gt_poses_list[item]
        quat = rot_to_quat(pose[:3, :3])
        translation = pose[:3, 3]
        pts, _ = read_points_ply(self.file_names[item])
        pts = pts.astype(np.float64)
        if self.transform_pcd:
            pts = pts @ pose[:3, :3].T + pose[:3, 3]
        norms = np.linalg.norm(pts, axis=1)
        mask = (norms >= self.min_range) & (norms <= self.max_range)
        return translation, quat, pts[mask]


class KittiReader(_IterReader):
    """KITTI layout: velodyne/*.bin (float32 x,y,z,intensity) + poses.txt of
    3x4 poses (kitti_reader.py:9-94)."""

    def __init__(self, data_dir, min_range=0.01, max_range=100,
                 transform_pcd=False, sensor_hz=10.0, **kw):
        data_dir = Path(data_dir)
        self.file_names = natsorted((data_dir / "velodyne").glob("*.bin"))
        poses = np.loadtxt(data_dir / "poses.txt", delimiter=" ")
        self.gt_poses_list = poses.reshape((len(poses), 3, 4))
        self.transform_pcd = transform_pcd
        self.min_range = min_range
        self.max_range = max_range
        self.time = 0.0
        self.time_inc = 1.0 / sensor_hz
        self.file_index = 0

    def __len__(self):
        return len(self.file_names)

    def __getitem__(self, item):
        pose34 = self.gt_poses_list[item]
        pose = np.eye(4)
        pose[:3, :4] = pose34
        quat = rot_to_quat(pose[:3, :3])
        translation = pose[:3, 3]
        pts = np.fromfile(self.file_names[item],
                          dtype=np.float32).reshape(-1, 4)[:, :3]
        if self.transform_pcd:
            pts = pts @ pose[:3, :3].T + pose[:3, 3]
        norms = np.linalg.norm(pts, axis=1)
        mask = (norms >= self.min_range) & (norms <= self.max_range)
        return translation, quat, pts[mask].astype(np.float64)
