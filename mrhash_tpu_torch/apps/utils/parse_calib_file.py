"""VBR calibration-file parsers (a copy of
mrhash_tpu/apps/utils/parse_calib_file.py, after mrhash/apps/utils/
parse_calib_file.py:1-101).

Same YAML / KITTI-style-txt schemas and return conventions as the
reference; the only implementation difference is a numpy Rodrigues
(rotation matrix -> rotation vector) instead of cv2.Rodrigues, so the
parser has no OpenCV dependency.  PyYAML is imported when a YAML file is
read, not with the module.
"""
from __future__ import annotations

import numpy as np


def _load_yaml(f: str):
    import yaml
    with open(f, "r") as fin:
        return yaml.safe_load(fin)


def rodrigues_from_matrix(R):
    """Rotation matrix -> Rodrigues rotation vector (axis * angle), the
    inverse convention of cv2.Rodrigues used by the reference (:26-31)."""
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.zeros(3, np.float32)
    if np.pi - theta < 1e-6:
        # near 180 deg: axis from the symmetric part, R = 2*a*a^T - I
        axis = np.sqrt(np.maximum(np.diag(R + np.eye(3)) / 2.0, 0.0))
        # fix signs from the off-diagonal terms
        i = int(np.argmax(axis))
        if axis[i] > 0:
            for j in range(3):
                if j != i and (R[i, j] + R[j, i]) < 0:
                    axis[j] = -axis[j]
        axis /= max(np.linalg.norm(axis), 1e-12)
        return (axis * theta).astype(np.float32)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return (axis * theta).astype(np.float32)


def read_extrinsics(f: str):
    """Camera-in-LiDAR extrinsics from a VBR calib YAML (ref :7-34).

    Returns (rvec_cTl, tvec_cTl, rvec_lTc, tvec_lTc): the Rodrigues vector
    + translation of camera_T_lidar and of lidar_T_camera (the YAML's
    cam_r/T_b block)."""
    ydict = _load_yaml(f)
    lidar_T_camera = np.asarray(ydict["cam_r"]["T_b"], np.float32)
    rvec_lTc = rodrigues_from_matrix(lidar_T_camera[:3, :3])
    camera_T_lidar = np.linalg.inv(lidar_T_camera)
    rvec_cTl = rodrigues_from_matrix(camera_T_lidar[:3, :3])
    return (rvec_cTl, camera_T_lidar[:3, 3].astype(np.float32),
            rvec_lTc, lidar_T_camera[:3, 3].astype(np.float32))


def read_lidar_T_camera(f: str):
    """The full 4x4 lidar_T_camera ("camera in LiDAR") matrix — what
    GeoWrapper.setCameraInLidar stores (geowrapper.cpp:94-96)."""
    ydict = _load_yaml(f)
    return np.asarray(ydict["cam_r"]["T_b"], np.float32)


def read_intrinsics(f: str):
    """3x3 K from the YAML sensor/intrinsics [fx, fy, cx, cy] (ref :37-56)."""
    ydict = _load_yaml(f)
    K = np.zeros((3, 3), np.float32)
    K[0, 0] = ydict["sensor"]["intrinsics"][0]
    K[1, 1] = ydict["sensor"]["intrinsics"][1]
    K[0, 2] = ydict["sensor"]["intrinsics"][2]
    K[1, 2] = ydict["sensor"]["intrinsics"][3]
    K[2, 2] = 1
    return K


def read_img_size(f: str):
    """(rows, cols) from the YAML sensor/resolution [W, H] (ref :59-65)."""
    ydict = _load_yaml(f)
    return (ydict["sensor"]["resolution"][1],
            ydict["sensor"]["resolution"][0])


def read_intrinsics_txt(f: str):
    """KITTI-style calib txt: K from P_rect_00, distortion from D_00
    (ref :68-91)."""
    K = np.zeros((3, 3), np.float32)
    dist_coeffs = 0
    with open(f, "r") as fh:
        for line in fh:
            if line.startswith("P_rect_00"):
                values = [float(v) for v in line.split()[1:]]
                P = np.array(values).reshape(3, 4)
                K = P[:3, :3]
                K /= K[2, 2]
            if line.startswith("D_00"):
                dist_coeffs = [float(v) for v in line.split()[1:]]
    return K, dist_coeffs


def read_img_size_txt(f: str):
    """(W, H) from S_rect_00 of a KITTI-style calib txt (ref :94-101)."""
    with open(f, "r") as fh:
        for line in fh:
            if line.startswith("S_rect_00"):
                parts = line.split()
                return int(float(parts[1])), int(float(parts[2]))
    return None
