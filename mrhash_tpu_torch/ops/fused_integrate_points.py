"""Kernel K3: fused projective LiDAR update of the compacted block window.

Replaces mrhash_tpu/ops/fused_integrate.py::_kernel_sph, its plain branch
and its packed res-1 branch (the Pallas kernel behind
fused_integrate_points_pallas).  The CUDA source is
csrc/fused_integrate_points.cu; its header comment gives the design.  In
short, one launch serves the whole window, res-0 entries first: a res-0
entry is one 256-thread CTA of 2 consecutive voxels per thread (8-byte
accesses of pix, r_vox and the pool fields); a res-1 entry is 64
threads of one voxel, 4 entries per CTA.  Each thread loads the f32
range at its voxels' precomputed pixels, gates on the truncation band,
applies the Welford update and writes its voxels back in place where any
updated; each entry then reduces its flags over its own window.  The
range image and each lane's (pix, r_vox) come from the launches before it:
on the card kernels K13 and K14, on the CPU their torch twins
(ops/scan_raster.py).

Bound on the card: bytes — 16 B read per voxel of the window (pix, r_vox,
sdf, weight), 4 B read (sumsq) per weighted voxel and 12 B written per
updated voxel.  The kernel reads sumsq for every voxel and writes whole
voxel pairs at res 0, more than that count, for fewer dependent round trips
(PORT_NOTES.md P45).  The TPU kernel's 3-channel bf16 range split, one-hot
MXU sampling and VMEM patch windows existed to keep the range image in
VMEM; on Hopper the 256 KB image stays in L2 and each voxel loads its own
pixel.

`fused_integrate_points_rows` takes the plain PyTorch twin
`fused_integrate_points_rows_ref` for CPU tensors, the kernel for CUDA
tensors, and raises for any other device (cuda_lib.on_card).
utils/profiler.COUNTS counts launches that served res-0 entries under
"fused_integrate_points_rows", launches that served res-1 entries under
"fused_integrate_points_rows_res1" (a launch over a mixed window counts
in both).
"""
from __future__ import annotations

import ctypes

import torch

from mrhash_tpu_torch.core.state import (check_windows, put_windows,
                                         window_voxels)
from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS

LANES = 512
N_FLAGS = 4
FAR_F32 = 3e38


def fused_integrate_points_rows_ref(pool, img, pix, r_vox, ptr, res, consts):
    """Plain PyTorch twin of the kernel: the same f32 operations in the
    same order, entry by entry.  Updates the sdf / sumsq / weight lanes of
    each entry's window in place and returns the flags f32[A,4] over its
    window (min |sdf| over weighted lanes, max weight, weight sum, sumsq
    sum over weighted lanes).  consts: the wrapper's six floats, or the
    same as an f32[6] tensor on img's device (which a CUDA graph can
    capture)."""
    c = consts if torch.is_tensor(consts) else torch.tensor(
        consts, dtype=torch.float32, device=img.device)
    t0, t1, max_int, w_samp, w_max, vvs = (c[k] for k in range(6))
    vidx, valid = window_voxels(ptr, res)
    ok = valid & (pix >= 0)
    r_px = torch.where(ok, img.reshape(-1)[torch.where(ok, pix, 0)], 0.0)
    s = r_px - r_vox
    trunc = t0 + t1 * r_px
    update = ok & (r_px > 0.0) & (r_px <= max_int) & (s > -trunc) & (
        s < trunc)
    s = torch.minimum(torch.maximum(s, -trunc), trunc)

    sdf0 = pool.sdf.view(-1)[vidx]
    ssq0 = pool.sumsq.view(-1)[vidx]
    w0 = pool.weight.view(-1)[vidx]
    w0f = w0.to(torch.float32)
    half = vvs * 0.5
    curr_mean = torch.where(w0 > 0, sdf0, 0.0)
    delta = (s - curr_mean) / half
    m_sdf = (sdf0 * w0f + s * w_samp) / (w0f + w_samp)
    delta2 = (s - m_sdf) / half
    m_ssq = ssq0 + delta * delta2
    m_w = torch.minimum(w_max, w0f + w_samp).to(torch.int32)

    out_sdf = torch.where(update, m_sdf, sdf0)
    out_ssq = torch.where(update, m_ssq, ssq0)
    out_w = torch.where(update, m_w, w0)
    for field, vals in ((pool.sdf, out_sdf), (pool.sumsq, out_ssq),
                        (pool.weight, out_w)):
        put_windows(field, vidx, valid, vals)

    out_w = torch.where(valid, out_w, 0)
    weighted = out_w > 0
    return torch.stack([
        torch.where(weighted, torch.abs(out_sdf), FAR_F32).amin(dim=1),
        out_w.amax(dim=1).to(torch.float32),
        out_w.sum(dim=1).to(torch.float32),
        torch.where(weighted, out_ssq, 0.0).sum(dim=1)], dim=1)


def fused_integrate_points_rows(pool, img, pix, r_vox, ptr, res, consts):
    """K3 wrapper.  pool: VoxelPool of [N,512] rows; img f32[H,W] min-range
    image (0 = empty); pix i32[A,512] row * W + col of each window lane's
    pixel, -1 where the lane projects outside the image or the depth range
    (a res-1 entry uses lanes 0..63); r_vox f32[A,512] each voxel's camera
    range; ptr i32[A] and res i32[A] the entries' disjoint windows inside
    the pool; consts (t0, t1, max_integration_distance, w_sample, w_max,
    virtual_voxel_size).  Updates the windows in place and returns flags
    f32[A,4].  pix, r_vox and the pool fields must be 8-byte aligned (the
    kernel moves 2 voxels per access)."""
    dev = img.device
    card = cuda_lib.on_card(dev)
    H_, W_ = img.shape
    N = pool.sdf.shape[0]
    A = ptr.shape[0]
    e = cuda_lib.expect
    e(img, "img", torch.float32, (H_, W_), dev)
    e(pix, "pix", torch.int32, (A, LANES), dev)
    e(r_vox, "r_vox", torch.float32, (A, LANES), dev)
    e(ptr, "ptr", torch.int32, (A,), dev)
    e(res, "res", torch.int32, (A,), dev)
    for f, dt in (("sdf", torch.float32), ("sumsq", torch.float32),
                  ("weight", torch.int32)):
        e(getattr(pool, f), f"pool.{f}", dt, (N, LANES), dev)
    for name, t in (("pix", pix), ("r_vox", r_vox), ("pool.sdf", pool.sdf),
                    ("pool.sumsq", pool.sumsq),
                    ("pool.weight", pool.weight)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: not 8-byte aligned")
    if len(consts) != 6:
        raise ValueError("consts: expected (t0, t1, max_int, w_sample, "
                         "w_max, vvs)")
    n1 = check_windows(ptr, res, N, (
        f"pix: a pixel outside [-1, {H_ * W_})",
        (pix < -1) | (pix >= H_ * W_))) if A else 0
    if not card:
        return fused_integrate_points_rows_ref(pool, img, pix, r_vox, ptr,
                                               res, consts)
    flags = torch.empty((A, N_FLAGS), dtype=torch.float32, device=dev)
    order = torch.argsort(res, stable=True)      # res-0 entries first
    _launch(pool, img, pix, r_vox, ptr, order, A - n1, consts, flags)
    return flags


def _launch(pool, img, pix, r_vox, ptr, entries, n0, consts, flags):
    """Launch K3 once over the window entries `entries` (i64): the first
    n0 at res 0, the rest at res 1, of CUDA operands that
    fused_integrate_points_rows has validated (the checks sync, so kernel
    timings call this directly); writes their rows of `flags`."""
    n1 = entries.shape[0] - n0
    if n0 + n1 == 0:
        return
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(img.device):
        rc = lib.mrhash_fused_integrate_points_window(
            p(img), p(pix), p(r_vox), p(ptr), p(entries), n0, n1,
            *(ctypes.c_float(float(v)) for v in consts),
            p(pool.sdf), p(pool.sumsq), p(pool.weight), p(flags),
            cuda_lib.stream_of(img))
    cuda_lib.check(rc, "fused_integrate_points_rows")
    COUNTS["fused_integrate_points_rows"] += int(n0 > 0)
    COUNTS["fused_integrate_points_rows_res1"] += int(n1 > 0)
