"""Kernel K2: per-voxel sampling of a 2-channel f32 image.

Counterpart of mrhash_tpu/ops/pallas_kernels.py::sample_image_pallas (the
Pallas kernel `_sample_kernel`), which the reference's fused path reaches
through starve_mask to read the starvation z-buffer back at each voxel's
pixel.  The CUDA source is csrc/sample_image.cu: one thread per
(block, lane) reads both channels at its own pixel where `ok` holds and
writes 0 elsewhere, into the reference's channel-middle f32[A,2,512]
layout.  The Pallas kernel's aligned patch origins, patch-local
coordinates and `bactive` step gate were VMEM artefacts and are gone: the
lanes carry absolute (row, col).

Bound on the card: bytes — 9 B of row/col/mask and up to 8 B of image read,
8 B written per lane; the image gathers of a block's lanes are neighbours
and hit L2.

`sample_image` takes the plain PyTorch twin `sample_image_ref` for CPU
tensors, the kernel for CUDA tensors, and raises for any other device
(cuda_lib.on_card); so does `sample_image5`.
utils/profiler.COUNTS counts its launches under "sample_image", and
K6's under "sample_image5".

Kernel K6, `sample_image5`, is the counterpart of
mrhash_tpu/ops/pallas_kernels.py::sample_image_pallas_v2 (the Pallas kernel
`_sample_kernel_v2`, an experiment the JAX package never calls), with its
contract: a bf16 5-channel image (depth hi/lo split, r, g, b), per block an
8- and 128-aligned patch origin, per lane patch-local (row, col).  Its
one-hot bf16 contraction selects one element, so it is a masked gather
(csrc/sample_image.cu); channels 5-7 are 0 (PORT_NOTES.md P41).
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS, host_bool

LANES = 512
PATCH_H, PATCH_W = 32, 256      # K6's patch (pallas_kernels.PATCH_H2, PATCH_W)
N_CH5, OUT_CH5 = 5, 8


def sample_image_ref(img, row, col, ok):
    """Plain PyTorch twin: out[a, c, l] = img[c, row, col] where ok, else
    0."""
    _, H_, W_ = img.shape
    flat = torch.where(ok, row.to(torch.int64) * W_ + col.to(torch.int64), 0)
    vals = img.reshape(2, H_ * W_)[:, flat]                 # [2, A, 512]
    return torch.where(ok, vals, 0.0).permute(1, 0, 2).contiguous()


def sample_image(img, row, col, ok):
    """K2 wrapper.  img f32[2,H,W] channel-first; row/col i32[A,512]
    absolute pixel coordinates, inside the image wherever ok; ok
    bool[A,512].  Returns f32[A,2,512]."""
    dev = img.device
    card = cuda_lib.on_card(dev)
    _, H_, W_ = img.shape
    A = row.shape[0]
    e = cuda_lib.expect
    e(img, "img", torch.float32, (2, H_, W_), dev)
    e(row, "row", torch.int32, (A, LANES), dev)
    e(col, "col", torch.int32, (A, LANES), dev)
    e(ok, "ok", torch.bool, (A, LANES), dev)
    off = (row < 0) | (row >= H_) | (col < 0) | (col >= W_)
    if host_bool((ok & off).any()):
        raise ValueError("row/col: an ok lane lies outside the image")
    if not card:
        return sample_image_ref(img, row, col, ok)
    return _launch(img, row, col, ok)


def _launch(img, row, col, ok):
    """Launch K2 on CUDA operands that sample_image has validated (the
    bounds check syncs, so kernel timings call this directly)."""
    dev = img.device
    _, H_, W_ = img.shape
    A = row.shape[0]
    out = torch.empty((A, 2, LANES), dtype=torch.float32, device=dev)
    if A == 0:
        return out
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_sample_image(p(img), H_, W_, p(row), p(col), p(ok),
                                     A, p(out), cuda_lib.stream_of(img))
    cuda_lib.check(rc, "sample_image")
    COUNTS["sample_image"] += 1
    return out


def sample_image5_ref(img5, r0, c0, lr, lc):
    """Plain PyTorch twin of K6: out[a, ch, l] = img5[ch, r0' + lr, c0' +
    lc] for ch < 5 where 0 <= lr < 32 and 0 <= lc < 256, else 0, with
    r0' = clamp(r0, 0, H - 32) and c0' = clamp(c0, 0, W - 256) (the patch
    slice clamps its origin like dynamic_slice); channels 5-7 are 0."""
    _, H_, W_ = img5.shape
    A = lr.shape[0]
    r0c = torch.clamp(r0.to(torch.int64), 0, H_ - PATCH_H)[:, None]
    c0c = torch.clamp(c0.to(torch.int64), 0, W_ - PATCH_W)[:, None]
    ok = (lr >= 0) & (lr < PATCH_H) & (lc >= 0) & (lc < PATCH_W)
    flat = torch.where(ok, (r0c + lr) * W_ + c0c + lc, 0)
    vals = img5.reshape(N_CH5, H_ * W_)[:, flat].to(torch.float32)
    out = torch.zeros((A, OUT_CH5, LANES), dtype=torch.float32,
                      device=img5.device)
    out[:, :N_CH5] = torch.where(ok, vals, 0.0).permute(1, 0, 2)
    return out


def sample_image5(img5, r0, c0, lr, lc):
    """K6 wrapper, sample_image_pallas_v2's contract.  img5 bf16[5,H,W]
    channel-first with H >= 32 and W >= 256; r0/c0 i32[A] patch origins;
    lr/lc i32[A,512] patch-local coordinates; A % 8 == 0.  Returns
    f32[A,8,512]."""
    dev = img5.device
    card = cuda_lib.on_card(dev)
    _, H_, W_ = img5.shape
    A = lr.shape[0]
    e = cuda_lib.expect
    e(img5, "img5", torch.bfloat16, (N_CH5, H_, W_), dev)
    e(r0, "r0", torch.int32, (A,), dev)
    e(c0, "c0", torch.int32, (A,), dev)
    e(lr, "lr", torch.int32, (A, LANES), dev)
    e(lc, "lc", torch.int32, (A, LANES), dev)
    if H_ < PATCH_H or W_ < PATCH_W or A % 8:
        raise ValueError(f"sample_image5: needs H >= {PATCH_H}, W >= "
                         f"{PATCH_W} and A % 8 == 0, got {H_}, {W_}, {A}")
    if not card:
        return sample_image5_ref(img5, r0, c0, lr, lc)
    return _launch5(img5, r0, c0, lr, lc)


def _launch5(img5, r0, c0, lr, lc):
    """Launch K6 on CUDA operands that sample_image5 has validated."""
    dev = img5.device
    _, H_, W_ = img5.shape
    A = lr.shape[0]
    out = torch.empty((A, OUT_CH5, LANES), dtype=torch.float32, device=dev)
    if A == 0:
        return out
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_sample_image5(p(img5), H_, W_, p(r0), p(c0), p(lr),
                                      p(lc), A, p(out),
                                      cuda_lib.stream_of(img5))
    cuda_lib.check(rc, "sample_image5")
    COUNTS["sample_image5"] += 1
    return out
