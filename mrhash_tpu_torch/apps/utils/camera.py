"""Python-side camera helpers for the runners (a copy of
mrhash_tpu/apps/utils/camera.py, after mrhash/apps/utils/camera.py):
spherical <-> cartesian conversion and data-driven spherical (LiDAR
equirectangular) intrinsics estimation."""
from __future__ import annotations

from enum import Enum

import numpy as np


class CameraModel(int, Enum):
    Pinhole = 0
    Spherical = 1


def xyz_to_spherical(xyz):
    return np.stack([np.arctan2(xyz[:, 1], xyz[:, 0]),
                     np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1)),
                     np.linalg.norm(xyz, axis=1)], axis=1)


def spherical_to_xyz(sph):
    return np.stack([np.cos(sph[:, 0]) * np.cos(sph[:, 1]) * sph[:, 2],
                     np.sin(sph[:, 0]) * np.cos(sph[:, 1]) * sph[:, 2],
                     np.sin(sph[:, 1]) * sph[:, 2]], axis=1)


def calculate_spherical_intrinsics(points, image_rows, image_cols):
    """mrhash/apps/utils/camera.py:32-57 — fit az/el focal lengths to the
    point cloud's angular span."""
    azel = np.stack([np.arctan2(points[:, 1], points[:, 0]),
                     np.arctan2(points[:, 2],
                                np.linalg.norm(points[:, :2], axis=1)),
                     np.ones_like(points[:, 1], dtype=np.float32)], axis=1)
    vertical_fov = float(np.max(azel[:, 1]) - np.min(azel[:, 1]))
    horizontal_fov = float(np.max(azel[:, 0]) - np.min(azel[:, 0]))
    fx = -float(image_cols - 1) / horizontal_fov
    fy = -float(image_rows - 1) / vertical_fov
    cx = image_cols / 2
    cy = image_rows / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return K, azel, vertical_fov, horizontal_fov


class Camera:
    def __init__(self, rows, cols, K, min_depth=0.0, max_depth=1e30,
                 model=CameraModel.Pinhole):
        self.rows_ = int(rows)
        self.cols_ = int(cols)
        self.K_ = np.asarray(K, np.float32)
        self.fx_ = float(K[0, 0])
        self.fy_ = float(K[1, 1])
        self.cx_ = float(K[0, 2])
        self.cy_ = float(K[1, 2])
        self.min_depth_ = float(min_depth)
        self.max_depth_ = float(max_depth)
        self.model_ = int(model)
