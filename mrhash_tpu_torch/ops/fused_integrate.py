"""Kernel K1: fused TSDF integrate of the compacted block window.

Replaces mrhash_tpu/ops/fused_integrate.py::_kernel, both its res-0 branch
and its packed res-1 branch (the Pallas kernel behind
fused_integrate_pallas).  The CUDA source is csrc/fused_integrate.cu; its
header comment gives the design.  In short, the kernel works per window
entry and writes each entry's window in place: a res-0 entry is 128
threads of 4 x-consecutive voxels each (16-byte loads and stores of every
field), and a CTA walks 2 such entries with the next one's bpos and ptr
in flight; a res-1 entry is 64 threads of one voxel, 8 entries per
512-thread CTA.  Each thread projects its voxels, loads depth + RGB at
their own pixels, applies truncation, combineVoxel and the Welford update;
each entry then reduces its flags over its own window.  Entries own
disjoint windows (siblings of a shared row included), so no row packing
is needed.

Bound on the card: bytes — 12 B of pool read per voxel of the window, 4 B
of rgbp read and 16 B written per updated voxel, the frame read once.  The
res-0 path reads rgbp for every voxel and writes back the whole 4-voxel
group of any voxel that updates, so it moves more than that count; it
trades those bytes for fewer dependent round trips (PORT_NOTES.md P43).
The TPU kernel's patch + one-hot MXU sampling and the pack/scatter of pool
rows existed to keep the frame and the rows in VMEM; on Hopper a direct
load of each voxel's pixel (L2 resident) and an in-place window update
move the fewest bytes.

`fused_integrate_rows` takes the plain PyTorch twin
`fused_integrate_rows_ref` for CPU tensors, the kernel for CUDA tensors,
and raises for any other device (cuda_lib.on_card).
utils/profiler.COUNTS counts launches of the res-0 kernel under
"fused_integrate_rows", those of the res-1 kernel under
"fused_integrate_rows_res1".
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.core.state import (check_windows, put_windows,
                                         window_voxels)
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS, upload

LANES = 512
CAM_VEC_LEN = 32
FAR_F32 = 3e38


def make_cam_vec(cam, vvs, trunc0, trunc1, max_int, w_sample, w_max):
    """Pack camera + integration constants into the kernel's f32[32]:
    0 fx, 1 fy, 2 cx, 3 cy, 4 min_depth, 5 max_depth, 6..14 rot (row-major
    cam->world), 15..17 trans, 18 vvs, 19 trunc0, 20 trunc1,
    21 max_integration_distance, 22 w_sample, 23 w_max, 24 rows, 25 cols."""
    dev = cam.rot.device
    head = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.min_depth,
                        cam.max_depth])
    tail = upload([vvs, trunc0, trunc1, max_int, float(w_sample),
                   float(w_max), float(cam.rows), float(cam.cols)], dev,
                  torch.float32)
    pad = torch.zeros(CAM_VEC_LEN - 26, dtype=torch.float32, device=dev)
    return torch.cat([head, cam.rot.reshape(-1), cam.trans, tail, pad])


def _lattice_offsets(res):
    """Voxel-lattice offsets (x, y, z) f32[A,512] of each window lane: the
    8^3 lattice of a res-0 block, the 4^3 lattice at twice the spacing of a
    res-1 block (lanes past 64 repeat its last voxel)."""
    lane = torch.arange(LANES, device=res.device)
    l4 = torch.clamp(lane, max=63)
    low = (res == 1)[:, None]
    return tuple(torch.where(low, lo, hi).to(torch.float32) for lo, hi in (
        ((l4 % 4) * 2, lane % 8),
        (((l4 // 4) % 4) * 2, (lane // 8) % 8),
        ((l4 // 16) * 2, lane // 64)))


def fused_integrate_rows_ref(pool, depth_img, rgb_img, cam_vec, bpos, ptr,
                             res):
    """Plain PyTorch twin of the kernel: the same f32 operations in the
    same order, entry by entry.  Updates each entry's window in place and
    returns the flags f32[A,4] over its window (min |sdf| over weighted
    lanes, max weight, weight sum, sumsq sum over weighted lanes)."""
    c = cam_vec
    fx, fy, cx, cy, min_d, max_d = c[0], c[1], c[2], c[3], c[4], c[5]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = (c[6 + k] for k in range(9))
    tx, ty, tz = c[15], c[16], c[17]
    vvs, t0, t1, max_int = c[18], c[19], c[20], c[21]
    w_samp, w_max, rows_f, cols_f = c[22], c[23], c[24], c[25]

    offx, offy, offz = _lattice_offsets(res)
    bp = bpos.to(torch.float32)
    pwx = (bp[:, 0:1] * 8.0 + offx) * vvs - tx
    pwy = (bp[:, 1:2] * 8.0 + offy) * vvs - ty
    pwz = (bp[:, 2:3] * 8.0 + offz) * vvs - tz
    pcx = pwx * r00 + pwy * r10 + pwz * r20
    pcy = pwx * r01 + pwy * r11 + pwz * r21
    pcz = pwx * r02 + pwy * r12 + pwz * r22

    depth_ok = (pcz > min_d) & (pcz <= max_d)
    zs = torch.where(pcz == 0.0, torch.ones_like(pcz), pcz)
    lim = float(1 << 30)   # off-image values: any int that fails the bounds
    row = torch.clamp(torch.trunc(fy * pcy / zs + cy + 0.5), -lim, lim)
    col = torch.clamp(torch.trunc(fx * pcx / zs + cx + 0.5), -lim, lim)
    ok = (depth_ok & (row >= 0) & (col >= 0) & (row < rows_f)
          & (col < cols_f))
    W_ = depth_img.shape[1]
    flat = torch.where(ok, row.to(torch.int64) * W_ + col.to(torch.int64), 0)
    depth = torch.where(ok, depth_img.reshape(-1)[flat], 0.0)
    pk = torch.where(ok, rgb_img.reshape(-1)[flat], 0)

    vidx, valid = window_voxels(ptr, res)
    sdf0, ssq0 = pool.sdf.view(-1)[vidx], pool.sumsq.view(-1)[vidx]
    w0, rgbp0 = pool.weight.view(-1)[vidx], pool.rgbp.view(-1)[vidx]

    depth_ok2 = ok & (depth != 0.0) & (depth <= max_int)
    s = depth - pcz
    trunc = t0 + t1 * depth
    inside = s > -trunc
    s = torch.clamp(s, min=-trunc, max=trunc)
    update = valid & depth_ok2 & inside

    w0f = w0.to(torch.float32)
    half = vvs * 0.5
    curr_mean = torch.where(w0 > 0, sdf0, s)
    delta = (s - curr_mean) / half
    first = w0 == 0
    chans = []
    for sh in (0, 8, 16):
        new = ((pk >> sh) & 255).to(torch.float32)
        old = torch.where(first, new, ((rgbp0 >> sh) & 255).to(torch.float32))
        chans.append(torch.floor(0.5 * old + 0.5 * new + 0.5))
    rgbp_m = (chans[0] + chans[1] * 256.0 + chans[2] * 65536.0).to(
        torch.int32)
    m_sdf = (sdf0 * w0f + s * w_samp) / (w0f + w_samp)
    m_w = torch.minimum(w_max, w0f + w_samp).to(torch.int32)
    delta2 = (s - m_sdf) / half
    m_ssq = ssq0 + delta * delta2

    out_sdf = torch.where(update, m_sdf, sdf0)
    out_ssq = torch.where(update, m_ssq, ssq0)
    out_w = torch.where(update, m_w, w0)
    for field, vals in ((pool.sdf, out_sdf), (pool.sumsq, out_ssq),
                        (pool.weight, out_w),
                        (pool.rgbp, torch.where(update, rgbp_m, rgbp0))):
        put_windows(field, vidx, valid, vals)

    out_w = torch.where(valid, out_w, 0)
    weighted = out_w > 0
    return torch.stack([
        torch.where(weighted, torch.abs(out_sdf), FAR_F32).amin(dim=1),
        out_w.amax(dim=1).to(torch.float32),
        out_w.sum(dim=1).to(torch.float32),
        torch.where(weighted, out_ssq, 0.0).sum(dim=1)], dim=1)


def fused_integrate_rows(pool, depth_img, rgb_img, cam_vec, bpos, ptr, res):
    """K1 wrapper.  pool: VoxelPool of [N,512] rows; depth_img f32[H,W];
    rgb_img i32[H,W] packed r | g<<8 | b<<16; cam_vec f32[32]
    (make_cam_vec); window entries bpos i32[A,3], ptr i32[A] and res i32[A]
    with disjoint windows [ptr, ptr + 512) (res 0) or [ptr, ptr + 64)
    (res 1) inside the pool; the pool fields 16-byte aligned (the res-0
    kernel moves 4 voxels per access).  Updates the windows in place and
    returns flags f32[A,4]."""
    dev = depth_img.device
    card = cuda_lib.on_card(dev)
    H_, W_ = depth_img.shape
    N = pool.sdf.shape[0]
    A = bpos.shape[0]
    e = cuda_lib.expect
    e(depth_img, "depth_img", torch.float32, (H_, W_), dev)
    e(rgb_img, "rgb_img", torch.int32, (H_, W_), dev)
    e(cam_vec, "cam_vec", torch.float32, (CAM_VEC_LEN,), dev)
    e(bpos, "bpos", torch.int32, (A, 3), dev)
    e(ptr, "ptr", torch.int32, (A,), dev)
    e(res, "res", torch.int32, (A,), dev)
    for f, dt in (("sdf", torch.float32), ("sumsq", torch.float32),
                  ("weight", torch.int32), ("rgbp", torch.int32)):
        e(getattr(pool, f), f"pool.{f}", dt, (N, LANES), dev)
        if getattr(pool, f).data_ptr() % 16:
            raise ValueError(f"pool.{f}: not 16-byte aligned")
    n1 = check_windows(ptr, res, N) if A else 0
    if not card:
        return fused_integrate_rows_ref(pool, depth_img, rgb_img, cam_vec,
                                        bpos, ptr, res)
    flags = torch.empty((A, 4), dtype=torch.float32, device=dev)
    order = torch.argsort(res, stable=True)      # res-0 entries first
    for kind, entries in ((0, order[:A - n1]), (1, order[A - n1:])):
        _launch(pool, depth_img, rgb_img, cam_vec, bpos, ptr, entries, kind,
                flags)
    return flags


def _launch(pool, depth_img, rgb_img, cam_vec, bpos, ptr, entries, kind,
            flags):
    """Launch K1's res-`kind` kernel over the window entries `entries`
    (i64, all of that resolution) of CUDA operands that
    fused_integrate_rows has validated (the check syncs, so kernel timings
    call this directly); writes their rows of `flags`."""
    n = entries.shape[0]
    if n == 0:
        return
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(depth_img.device):
        rc = lib.mrhash_fused_integrate_window(
            p(depth_img), p(rgb_img), depth_img.shape[1], p(cam_vec),
            p(bpos), p(ptr), p(entries), n, kind, p(pool.sdf),
            p(pool.sumsq), p(pool.weight), p(pool.rgbp), p(flags),
            cuda_lib.stream_of(depth_img))
    cuda_lib.check(rc, "fused_integrate_rows")
    COUNTS["fused_integrate_rows_res1" if kind
           else "fused_integrate_rows"] += 1
