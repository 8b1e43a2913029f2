"""GS training losses (port of mrhash_tpu/gs/losses.py;
mrhash/src/gs/loss_utils.cuh:16-44): L1, L2, SSIM with an 11x11 Gaussian
window, and the PSNR metric (gaussian_utils.cuh:269-273)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW_SIZE = 11
SIGMA = 1.5


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def _gaussian_window(device):
    x = (torch.arange(WINDOW_SIZE, dtype=torch.float32, device=device)
         - WINDOW_SIZE // 2)
    g = torch.exp(-(x ** 2) / (2 * SIGMA ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def _filter2d(img, window):
    """Depthwise 11x11 convolution over [C,H,W] with same padding, in full
    f32 (cuDNN would take TF32 for a convolution by default)."""
    c = img.shape[0]
    k = window[None, None].expand(c, 1, WINDOW_SIZE, WINDOW_SIZE)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(img[None], k, padding=WINDOW_SIZE // 2, groups=c)[0]


def ssim(pred, gt):
    """Structural similarity over [C,H,W] in [0,1]."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    w = _gaussian_window(pred.device)
    mu1 = _filter2d(pred, w)
    mu2 = _filter2d(gt, w)
    mu1s, mu2s, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(pred * pred, w) - mu1s
    s2 = _filter2d(gt * gt, w) - mu2s
    s12 = _filter2d(pred * gt, w) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1s + mu2s + c1)
                                              * (s1 + s2 + c2))
    return torch.mean(m)


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
