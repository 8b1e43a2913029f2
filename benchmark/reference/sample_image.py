"""K2's plain twin (the starve z-buffer readback).
"""
from __future__ import annotations

import torch


LANES = 512


def sample_image_ref(img, row, col, ok):
    """Plain PyTorch twin: out[a, c, l] = img[c, row, col] where ok, else
    0."""
    _, H_, W_ = img.shape
    flat = torch.where(ok, row.to(torch.int64) * W_ + col.to(torch.int64), 0)
    vals = img.reshape(2, H_ * W_)[:, flat]                 # [2, A, 512]
    return torch.where(ok, vals, 0.0).permute(1, 0, 2).contiguous()


def sample_image(img, row, col, ok):
    """K2's plain twin on any device: f32[A,2,512]."""
    return sample_image_ref(img, row, col, ok)
