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
tensors only; for CUDA tensors it launches the kernel or raises.
`launch_count` counts kernel launches.
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.ops import cuda_lib

LANES = 512

launch_count = 0


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
    _, H_, W_ = img.shape
    A = row.shape[0]
    e = cuda_lib.expect
    e(img, "img", torch.float32, (2, H_, W_), dev)
    e(row, "row", torch.int32, (A, LANES), dev)
    e(col, "col", torch.int32, (A, LANES), dev)
    e(ok, "ok", torch.bool, (A, LANES), dev)
    off = (row < 0) | (row >= H_) | (col < 0) | (col >= W_)
    if bool((ok & off).any()):
        raise ValueError("row/col: an ok lane lies outside the image")
    if dev.type == "cpu":
        return sample_image_ref(img, row, col, ok)
    if dev.type != "cuda":
        raise ValueError(f"sample_image: no kernel for {dev}")
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
    global launch_count
    launch_count += 1
    return out
