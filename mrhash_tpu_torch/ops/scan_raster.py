"""Kernels K13 and K14: a LiDAR scan's min-range raster and the spherical
projection of the block window, the operands of K3
(ops/fused_integrate_points.py).

The CUDA source is csrc/scan_raster.cu; its header comment gives the
design.  In short: K13 maps the scan's elevation span to the image rows
and rasterizes the min range of its returns, in three launches (clear +
elevation min/max per CTA; the mapping and an atomicMin per point; the
empty pixels to 0); K14 projects every lane of the window, a thread a
lane.  Neither reads anything back to the host: the mapping (el_lo,
s_el) stays on the card, f32[2], for K14.

Bit-equal to the twins run on the card (tests/test_torch_scan_raster.py):
the twins are the torch ops the port ran before the kernels, whose each
op rounds on its own, and the kernels round every operation alone in the
same order (PORT_NOTES.md P15).

Bound on the card: bytes, at a few microseconds a launch — K13 reads the
scan (12 B a point) and writes the range image (4 B a pixel); K14 reads
each entry's block and resolution and writes 8 B a lane.

`raster_scan` and `project_window` take their plain PyTorch twins
(`raster_scan_ref`, `project_window_ref`) for CPU tensors, the kernels for
CUDA tensors, and raise for any other device (cuda_lib.on_card).
utils/profiler.COUNTS counts K13's three launches under "raster_scan" and
K14's one under "project_window".
"""
from __future__ import annotations

import ctypes
import math

import torch

from mrhash_tpu_torch.core.state import LANES
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS

INF = float("inf")


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def scan_raster_mapping(cam: C.Camera, points):
    """The scan's own elevation mapping (mrhash_tpu: _scan_raster_mapping):
    the full azimuth circle maps to cam.cols columns, and the elevation
    span of the scan's returns to cam.rows rows.  Returns 0-d tensors
    (el_lo, s_el), row = floor((el - el_lo) * s_el + 0.5)."""
    if points.shape[0] == 0:      # maps like one point with no return
        points = torch.zeros((1, 3), dtype=torch.float32,
                             device=points.device)
    rng = X.norm3(points)[..., 0]
    ok = rng > 1e-6
    el = torch.asin(torch.clamp(points[..., 2] / torch.where(ok, rng, 1.0),
                                -1.0, 1.0))
    el_lo = torch.where(ok, el, INF).amin()
    el_hi = torch.where(ok, el, -INF).amax()
    el_lo = torch.where(torch.isfinite(el_lo), el_lo, -1.0)
    el_hi = torch.where(torch.isfinite(el_hi), el_hi, 1.0)
    return el_lo, (cam.rows - 1) / torch.clamp(el_hi - el_lo, min=1e-6)


def _sph_rowcol(cam: C.Camera, pc, el_lo, s_el):
    """Raster (row, col) of camera-frame points under the scan mapping.
    Returns (row i32, col i32, range f32, in_rows bool)."""
    rng = X.norm3(pc)[..., 0]
    safe = torch.where(rng == 0, 1.0, rng)
    az = torch.atan2(pc[..., 1], pc[..., 0])
    el = torch.asin(torch.clamp(pc[..., 2] / safe, -1.0, 1.0))
    colf = (az + math.pi) * (cam.cols / (2.0 * math.pi))
    col = torch.clamp(colf.to(torch.int32), 0, cam.cols - 1)
    row = torch.floor((el - el_lo) * s_el + 0.5).to(torch.int32)
    return row, col, rng, (row >= 0) & (row < cam.rows)


def _sph_ok(cam: C.Camera, rng, in_rows):
    return in_rows & (rng >= cam.min_depth) & (rng <= cam.max_depth)


def rasterize_scan(cam: C.Camera, points, el_lo, s_el):
    """Min-range rasterization of the scan onto an unpadded f32[rows, cols]
    image; empty cells hold 0.  The reference's azimuth-wrap pad columns
    and 8-aligned rows fed its VMEM patch windows (PORT_NOTES.md P14)."""
    row, col, rng, in_rows = _sph_rowcol(cam, points, el_lo, s_el)
    ok = _sph_ok(cam, rng, in_rows)
    HW = cam.rows * cam.cols
    flat = torch.where(ok, row.to(torch.int64) * cam.cols + col, HW)
    img = torch.full((HW + 1,), INF, dtype=torch.float32,
                     device=points.device)
    img.scatter_reduce_(0, flat, torch.where(ok, rng, INF), "amin")
    img = img[:HW].reshape(cam.rows, cam.cols)
    return torch.where(torch.isfinite(img), img, 0.0)


def project_window_sph(cfg, cam: C.Camera, bpos, bres, el_lo, s_el):
    """Per-lane spherical projection of the window's voxels, in window
    layout (the geometry of mrhash_tpu's _sph_proj_pack without its patch
    bookkeeping; outside kernel K3, PORT_NOTES.md P15).  Returns pix
    i32[A,512] = row * cols + col, or -1 where the lane is not a voxel of
    its block (lanes past 64 of a res-1 entry) or falls outside the image
    rows or the depth range, and r_vox f32[A,512], the voxel's camera
    range."""
    pi, valid = X.block_voxel_grid(bpos, bres)
    pw = X.virtual_voxel_pos_to_world(cfg.virtual_voxel_size, pi)
    row, col, rng, in_rows = _sph_rowcol(cam, C.world_to_cam(cam, pw),
                                         el_lo, s_el)
    ok = valid & _sph_ok(cam, rng, in_rows)
    pix = torch.where(ok, row.clamp(0, cam.rows - 1) * cam.cols + col, -1)
    return pix, rng


def raster_scan_ref(cam: C.Camera, points):
    """K13's twin: (img f32[rows, cols], mapping f32[2] = (el_lo, s_el))
    of scan_raster_mapping and rasterize_scan."""
    el_lo, s_el = scan_raster_mapping(cam, points)
    return (rasterize_scan(cam, points, el_lo, s_el),
            torch.stack([el_lo, s_el]))


def project_window_ref(cfg, cam: C.Camera, bpos, bres, mapping):
    """K14's twin: project_window_sph under K13's mapping f32[2]."""
    return project_window_sph(cfg, cam, bpos, bres, mapping[0], mapping[1])


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def _col_scale(cam: C.Camera):
    # torch takes the Python scalar cols / 2 pi as f32, so does c_float
    return ctypes.c_float(cam.cols / (2.0 * math.pi))


def _cam_operands(cam: C.Camera, dev):
    """The camera's rot, trans, min_depth and max_depth as the kernels
    read them on the card (f32, contiguous)."""
    if cam.model != C.SPHERICAL or cam.rows < 1 or cam.cols < 1:
        raise ValueError("cam: a spherical camera with rows and cols >= 1")
    out = []
    for name, shape in (("rot", (3, 3)), ("trans", (3,)),
                        ("min_depth", ()), ("max_depth", ())):
        t = getattr(cam, name).contiguous()
        cuda_lib.expect(t, f"cam.{name}", torch.float32, shape, dev)
        out.append(t)
    return out


def raster_scan(cam: C.Camera, points):
    """K13 wrapper.  points f32[N,3] in the camera frame.  Returns (img
    f32[rows, cols], the min range of the returns in each pixel, 0 where
    none; mapping f32[2] = (el_lo, s_el), the scan's elevation mapping,
    row = floor((el - el_lo) * s_el + 0.5)), both on points' device."""
    dev = points.device
    card = cuda_lib.on_card(dev)
    cuda_lib.expect(points, "points", torch.float32, (None, 3), dev)
    if not card:
        return raster_scan_ref(cam, points)
    _, _, min_d, max_d = _cam_operands(cam, dev)
    lib = cuda_lib.library()
    img = torch.empty((cam.rows, cam.cols), dtype=torch.float32, device=dev)
    aux = torch.empty((lib.mrhash_raster_scan_aux_words(),),
                      dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_raster_scan(
            p(points), points.shape[0], cam.rows, cam.cols, _col_scale(cam),
            p(min_d), p(max_d), p(img), p(aux),
            cuda_lib.stream_of(points))
    cuda_lib.check(rc, "raster_scan")
    COUNTS["raster_scan"] += 3
    return img, aux[:2].view(torch.float32)


def project_window(cfg, cam: C.Camera, bpos, bres, mapping):
    """K14 wrapper.  bpos i32[A,3] and bres i32[A] the window's blocks and
    resolutions, mapping f32[2] K13's.  Returns (pix i32[A,512], r_vox
    f32[A,512]) as project_window_sph's."""
    dev = bpos.device
    card = cuda_lib.on_card(dev)
    A = bpos.shape[0]
    e = cuda_lib.expect
    e(bpos, "bpos", torch.int32, (A, 3), dev)
    e(bres, "bres", torch.int32, (A,), dev)
    e(mapping, "mapping", torch.float32, (2,), dev)
    if not card:
        return project_window_ref(cfg, cam, bpos, bres, mapping)
    cam_ops = _cam_operands(cam, dev)
    pix = torch.empty((A, LANES), dtype=torch.int32, device=dev)
    r_vox = torch.empty((A, LANES), dtype=torch.float32, device=dev)
    if A == 0:
        return pix, r_vox
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = cuda_lib.library().mrhash_project_window(
            p(bpos), p(bres), A, *map(p, cam_ops), p(mapping),
            ctypes.c_float(cfg.virtual_voxel_size), cam.rows, cam.cols,
            _col_scale(cam), p(pix), p(r_vox), cuda_lib.stream_of(bpos))
    cuda_lib.check(rc, "project_window")
    COUNTS["project_window"] += 1
    return pix, r_vox
