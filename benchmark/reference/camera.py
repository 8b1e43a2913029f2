"""Pinhole + spherical (LiDAR equirectangular) camera model.

Port of mrhash_tpu/ops/camera.py.  `Camera` holds its intrinsics and the
cam->world SE3 as f32 tensors on the map's device; image shape and model
are plain ints.

The rigid transforms are written out as per-axis sums in a fixed order
instead of a 3x3 matmul, so that every caller (the gather integrate, the
starvation pass, the CUDA kernel in csrc/fused_integrate.cu) projects a
voxel to bit-identical camera coordinates: a BLAS matmul may contract or
reorder the sum and move voxels that sit on a pixel boundary.
"""
from __future__ import annotations

import dataclasses

import torch

PINHOLE = 0
SPHERICAL = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    min_depth: torch.Tensor
    max_depth: torch.Tensor
    rot: torch.Tensor     # f32[3,3] cam -> world
    trans: torch.Tensor   # f32[3]
    rows: int = 0
    cols: int = 0
    model: int = PINHOLE

    @property
    def device(self):
        return self.rot.device


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def make_camera(fx, fy, cx, cy, rows, cols, min_depth, max_depth,
                model=PINHOLE, device="cpu") -> Camera:
    return Camera(
        fx=_f32(fx, device), fy=_f32(fy, device),
        cx=_f32(cx, device), cy=_f32(cy, device),
        min_depth=_f32(min_depth, device), max_depth=_f32(max_depth, device),
        rot=torch.eye(3, dtype=torch.float32, device=device),
        trans=torch.zeros(3, dtype=torch.float32, device=device),
        rows=int(rows), cols=int(cols), model=int(model))


def with_pose(cam: Camera, rot, trans) -> Camera:
    """camera.cuh:72 setCamInWorld."""
    return dataclasses.replace(cam, rot=_f32(rot, cam.device).reshape(3, 3),
                               trans=_f32(trans, cam.device).reshape(3))


def cam_to_world(cam: Camera, pc):
    """Apply the cam-in-world SE3 to camera-frame points [...,3]."""
    r = cam.rot
    return (pc[..., 0:1] * r[:, 0] + pc[..., 1:2] * r[:, 1]
            + pc[..., 2:3] * r[:, 2]) + cam.trans


def world_to_cam(cam: Camera, pw):
    """Apply the inverse SE3: (pw - t) @ rot, summed over k = 0, 1, 2."""
    d = pw - cam.trans
    r = cam.rot
    return d[..., 0:1] * r[0] + d[..., 1:2] * r[1] + d[..., 2:3] * r[2]


def inverse_projection(cam: Camera, row, col, d):
    """camera.cuh:84-103 — pixel (row,col) at depth/range d -> camera-frame
    point."""
    row = row.to(torch.float32)
    col = col.to(torch.float32)
    d = d.to(torch.float32)
    if cam.model == PINHOLE:
        x = (col - cam.cx - 0.5) / cam.fx
        y = (row - cam.cy - 0.5) / cam.fy
        ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    else:
        az = (col - cam.cx - 0.5) / cam.fx
        el = (row - cam.cy - 0.5) / cam.fy
        c1 = torch.cos(el)
        ray = torch.stack([torch.cos(az) * c1, torch.sin(az) * c1,
                           torch.sin(el)], dim=-1)
    return d[..., None] * ray


def get_depth(cam: Camera, pc):
    """camera.cuh:120-129 — z for pinhole, range for spherical."""
    if cam.model == PINHOLE:
        return pc[..., 2]
    return torch.linalg.norm(pc, dim=-1)


def normalize_depth(cam: Camera, depth):
    """camera.cuh:105-107."""
    return (depth - cam.min_depth) / (cam.max_depth - cam.min_depth)


def _project_rowcol(cam: Camera, pc):
    """Shared row/col math of projectPoint{,Approx} (camera.cuh:131-203).
    The float result is truncated toward zero like the reference's C
    assignment to int (differs from floor only in (-1, 0))."""
    if cam.model == PINHOLE:
        z = pc[..., 2]
        depth_ok = (z > cam.min_depth) & (z <= cam.max_depth)
        zs = torch.where(z == 0, torch.ones_like(z), z)
        row = torch.trunc(cam.fy * pc[..., 1] / zs + cam.cy + 0.5)
        col = torch.trunc(cam.fx * pc[..., 0] / zs + cam.cx + 0.5)
    else:
        rng = torch.linalg.norm(pc, dim=-1)
        depth_ok = (rng >= cam.min_depth) & (rng <= cam.max_depth)
        safe = torch.where(rng == 0, torch.ones_like(rng), rng)
        px = torch.atan2(pc[..., 1], pc[..., 0])
        py = torch.asin(torch.clamp(pc[..., 2] / safe, -1.0, 1.0))
        row = torch.trunc(cam.fy * py + cam.cy + 0.5)
        col = torch.trunc(cam.fx * px + cam.cx + 0.5)
    # off-image projections may overflow int32; they fail every bounds
    # test below, so clamp before the cast instead of relying on the
    # platform's out-of-range conversion
    lim = float(1 << 30)
    row = torch.clamp(row, -lim, lim).to(torch.int32)
    col = torch.clamp(col, -lim, lim).to(torch.int32)
    return row, col, depth_ok


def project_point(cam: Camera, pc):
    """camera.cuh:131-165 — exact projection.  Returns (row, col, valid)."""
    row, col, depth_ok = _project_rowcol(cam, pc)
    inside = (row >= 0) & (col >= 0) & (row < cam.rows) & (col < cam.cols)
    return row, col, depth_ok & inside


def project_point_approx(cam: Camera, pc):
    """camera.cuh:167-203 — projection with +-50% image-border slack."""
    row, col, depth_ok = _project_rowcol(cam, pc)
    rt = int(cam.rows * 0.5)
    ct = int(cam.cols * 0.5)
    inside = ((row >= -rt) & (col >= -ct)
              & (row < cam.rows + rt) & (col < cam.cols + ct))
    return row, col, depth_ok & inside


def is_in_camera_frustum_approx(cam: Camera, pw):
    """camera.cuh:109-118 — world point inside the padded frustum."""
    _, _, ok = project_point_approx(cam, world_to_cam(cam, pw))
    return ok


def compute_cloud(cam: Camera, depth_img):
    """camera.cu:5-26 — back-project a depth image to a [rows,cols,3]
    cloud; depth outside (min_depth, max_depth] gives the zero point."""
    dev = depth_img.device
    r = torch.arange(cam.rows, dtype=torch.float32, device=dev)[:, None]
    c = torch.arange(cam.cols, dtype=torch.float32, device=dev)[None, :]
    r = r.expand(depth_img.shape)
    c = c.expand(depth_img.shape)
    pc = inverse_projection(cam, r, c, depth_img)
    valid = (depth_img > cam.min_depth) & (depth_img <= cam.max_depth)
    return torch.where(valid[..., None], pc, torch.zeros_like(pc))
