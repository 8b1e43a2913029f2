"""Trajectory parsers (a copy of mrhash_tpu/apps/utils/parse_trajectory.py,
after mrhash/apps/utils/parse_tum_trajectory.py): TUM
(`t x y z qx qy qz qw`), KITTI (3x4 row-major), and KITTI-360
(`idx 4x4 row-major`) formats -> lists of (timestamp, 4x4 pose)."""
from __future__ import annotations

import numpy as np


def _quat_to_rot(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]])


def parse_tum_trajectory(path):
    rows = np.loadtxt(path, comments="#")
    out = []
    for r in rows:
        t, x, y, z, qx, qy, qz, qw = r[:8]
        m = np.eye(4)
        m[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
        m[:3, 3] = (x, y, z)
        out.append((float(t), m))
    return out


def parse_kitti_trajectory(path):
    rows = np.loadtxt(path)
    out = []
    for i, r in enumerate(rows):
        m = np.eye(4)
        m[:3, :4] = r.reshape(3, 4)
        out.append((float(i), m))
    return out


def parse_kitti360_trajectory(path):
    rows = np.loadtxt(path)
    out = []
    for r in rows:
        m = r[1:17].reshape(4, 4)
        out.append((float(r[0]), m))
    return out


def nearest_pose(trajectory, timestamp):
    """Nearest-timestamp pose match (ros_reader.py behavior)."""
    ts = np.asarray([t for t, _ in trajectory])
    i = int(np.argmin(np.abs(ts - timestamp)))
    return trajectory[i][1]
