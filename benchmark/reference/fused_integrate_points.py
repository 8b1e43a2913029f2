"""K3's plain twin (the LiDAR projective integrate of the block window,
both resolutions).
"""
from __future__ import annotations

import torch

from reference.state import (check_windows, put_windows,
                             window_voxels)

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
    """K3's plain twin on any device: updates each entry's window in place
    and returns flags f32[A,4]."""
    if ptr.shape[0]:
        check_windows(ptr, res, pool.sdf.shape[0])
    return fused_integrate_points_rows_ref(pool, img, pix, r_vox, ptr, res,
                                           consts)
