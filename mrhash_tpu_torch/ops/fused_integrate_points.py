"""Kernel K3: fused projective LiDAR update of the compacted block window.

Replaces mrhash_tpu/ops/fused_integrate.py::_kernel_sph, plain branch (the
Pallas kernel behind fused_integrate_points_pallas).  The CUDA source is
csrc/fused_integrate_points.cu; its header comment gives the design.  In
short, one CTA per window block and one thread per voxel: load the f32
range at the voxel's precomputed pixel, gate on the truncation band, apply
the Welford update in place in the block's pool row, then a block
reduction of the GC flags.  The spherical projection that gives each lane
its (pix, r_vox) runs in torch before the launch
(ops/integrate.py::project_window_sph).

Bound on the card: bytes — 16 B read per voxel (pix, r_vox, sdf, weight),
4 B read (sumsq) and 12 B written per updated voxel.  The TPU kernel's
3-channel bf16 range split, one-hot MXU sampling and VMEM patch windows
existed to keep the range image in VMEM; on Hopper the 256 KB image stays
in L2 and each voxel loads its own pixel.

`fused_integrate_points_rows` takes the plain PyTorch twin
`fused_integrate_points_rows_ref` for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  `launch_count` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from mrhash_tpu_torch.ops import cuda_lib

LANES = 512
N_FLAGS = 2
FAR_F32 = 3e38

launch_count = 0


def fused_integrate_points_rows_ref(pool, img, pix, r_vox, prow, consts):
    """Plain PyTorch twin of the kernel: the same f32 operations in the
    same order.  Updates the sdf / sumsq / weight lanes of pool rows `prow`
    in place and returns the flags f32[A,2] (min |sdf| over weighted lanes,
    max weight).  consts: the wrapper's six floats, or the same as an f32[6]
    tensor on img's device (which a CUDA graph can capture)."""
    c = consts if torch.is_tensor(consts) else torch.tensor(
        consts, dtype=torch.float32, device=img.device)
    t0, t1, max_int, w_samp, w_max, vvs = (c[k] for k in range(6))
    ok = pix >= 0
    r_px = torch.where(ok, img.reshape(-1)[torch.where(ok, pix, 0)], 0.0)
    s = r_px - r_vox
    trunc = t0 + t1 * r_px
    update = ok & (r_px > 0.0) & (r_px <= max_int) & (s > -trunc) & (
        s < trunc)
    s = torch.minimum(torch.maximum(s, -trunc), trunc)

    row = prow.to(torch.int64)
    sdf0, ssq0, w0 = pool.sdf[row], pool.sumsq[row], pool.weight[row]
    w0f = w0.to(torch.float32)
    half = vvs * 0.5
    curr_mean = torch.where(w0 > 0, sdf0, 0.0)
    delta = (s - curr_mean) / half
    m_sdf = (sdf0 * w0f + s * w_samp) / (w0f + w_samp)
    delta2 = (s - m_sdf) / half
    out_sdf = torch.where(update, m_sdf, sdf0)
    out_w = torch.where(update, torch.minimum(w_max, w0f + w_samp).to(
        torch.int32), w0)
    pool.sdf[row] = out_sdf
    pool.sumsq[row] = torch.where(update, ssq0 + delta * delta2, ssq0)
    pool.weight[row] = out_w
    return torch.stack([
        torch.where(out_w > 0, torch.abs(out_sdf), FAR_F32).amin(dim=1),
        out_w.amax(dim=1).to(torch.float32)], dim=1)


def fused_integrate_points_rows(pool, img, pix, r_vox, prow, consts):
    """K3 wrapper.  pool: VoxelPool of [N,512] rows; img f32[H,W] min-range
    image (0 = empty); pix i32[A,512] row * W + col of each lane's pixel,
    -1 where the lane projects outside the image or the depth range;
    r_vox f32[A,512] each voxel's camera range; prow i32[A] distinct rows
    in [0, N); consts (t0, t1, max_integration_distance, w_sample, w_max,
    virtual_voxel_size).  Updates the rows in place and returns flags
    f32[A,2]."""
    dev = img.device
    H_, W_ = img.shape
    N = pool.sdf.shape[0]
    A = prow.shape[0]
    e = cuda_lib.expect
    e(img, "img", torch.float32, (H_, W_), dev)
    e(pix, "pix", torch.int32, (A, LANES), dev)
    e(r_vox, "r_vox", torch.float32, (A, LANES), dev)
    e(prow, "prow", torch.int32, (A,), dev)
    for f, dt in (("sdf", torch.float32), ("sumsq", torch.float32),
                  ("weight", torch.int32)):
        e(getattr(pool, f), f"pool.{f}", dt, (N, LANES), dev)
    if len(consts) != 6:
        raise ValueError("consts: expected (t0, t1, max_int, w_sample, "
                         "w_max, vvs)")
    if A and not bool(((prow >= 0) & (prow < N)).all()
                      & ((pix >= -1) & (pix < H_ * W_)).all()):
        raise ValueError(f"prow/pix: a row outside [0, {N}) or a pixel "
                         f"outside [-1, {H_ * W_})")
    if dev.type == "cpu":
        return fused_integrate_points_rows_ref(pool, img, pix, r_vox, prow,
                                               consts)
    if dev.type != "cuda":
        raise ValueError(f"fused_integrate_points_rows: no kernel for {dev}")
    return _launch(pool, img, pix, r_vox, prow, consts)


def _launch(pool, img, pix, r_vox, prow, consts):
    """Launch K3 on CUDA operands that fused_integrate_points_rows has
    validated (the index check syncs, so kernel timings call this
    directly)."""
    dev = img.device
    A = prow.shape[0]
    flags = torch.empty((A, N_FLAGS), dtype=torch.float32, device=dev)
    if A == 0:
        return flags
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_fused_integrate_points_rows(
            p(img), p(pix), p(r_vox), p(prow), A,
            *(ctypes.c_float(float(v)) for v in consts),
            p(pool.sdf), p(pool.sumsq), p(pool.weight), p(flags),
            cuda_lib.stream_of(img))
    cuda_lib.check(rc, "fused_integrate_points_rows")
    global launch_count
    launch_count += 1
    return flags
