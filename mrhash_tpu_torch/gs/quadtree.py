"""Image quad-tree seeding (port of mrhash_tpu/gs/quadtree.py;
gs/quad_tree.{cuh,cu}), level-synchronous.

Each node's luma-weighted colour variance is an O(1) lookup in one
integral image of six lanes (r, g, b and their squares), and each level
splits every node whose error exceeds the threshold into four children,
compacted in node order.  Leaves are appended level by level in node
order, which is the reference's leaf order.

Node error: luma-weighted per-channel variance * (W*H)/9e7; a node is a
leaf when its error <= threshold or a child side would drop to
min_pixel_size or below (quad_tree.cu:85-150).

The integral is exact (int64 sums of the u8 channels and their squares)
and the error is formed from it in float64 (PORT_NOTES.md P25).  The
reference sums an f32 integral, whose sums reach ~5e10 at 1200x680, where
an f32 ulp is 4096: small nodes' variances drown in rounding, which XLA
and torch, or the CPU and the card, do in different orders.  The CUDA
original sums each node's own pixels, as the exact integral does.

The reference holds each level in a buffer of min(4^l, max_leaves) slots
(a gather-count trick for the TPU); here a level holds exactly its live
nodes.  Children that would not fit in such a buffer are dropped and
counted as overflow the same way: a level keeps the children of its first
max_leaves // 4 split nodes.
"""
from __future__ import annotations

import torch

LUMA = (0.2989, 0.5870, 0.1140)


def _integral(img):
    """Zero-padded 2-D inclusive prefix sums: S[y, x] = sum img[:y, :x]."""
    s = torch.cumsum(torch.cumsum(img, dim=0), dim=1)
    return torch.nn.functional.pad(s, (0, 0, 1, 0, 1, 0))


def _luma_dot(v):
    """v[..., 0:3] . LUMA, summed in lane order."""
    return v[..., 0] * LUMA[0] + v[..., 1] * LUMA[1] + v[..., 2] * LUMA[2]


def build_qtree(rgb_img, threshold, min_pixel_size, max_leaves,
                max_levels=None):
    """rgb_img u8[H,W,3] -> (leaves f32[max_leaves,4] as (x, y, w, h),
    leaf_valid bool[max_leaves], n_leaves, n_overflow); the counts are
    Python ints."""
    H, W = rgb_img.shape[:2]
    dev = rgb_img.device
    if max_levels is None:
        max_levels = max(H, W).bit_length() + 1
    img = rgb_img.to(torch.int64)
    S = _integral(torch.cat([img, img * img], dim=-1)).reshape(-1, 6)
    W1 = W + 1
    norm = (H * W) / 90_000_000.0
    cap = int(max_leaves)

    def node_error(x, y, w, h):
        cnt = (w * h).to(torch.float64)
        cnt = torch.where(cnt == 0, 1.0, cnt)
        s = (S[(y + h) * W1 + x + w] - S[y * W1 + x + w]
             - S[(y + h) * W1 + x] + S[y * W1 + x]).to(torch.float64)
        m2l = _luma_dot(s[:, 3:6]) / cnt           # E[luma . c^2]
        m1 = s[:, :3] / cnt[:, None]               # E[c] per channel
        return (m2l - _luma_dot(m1 * m1)) * norm

    leaves = torch.zeros((cap, 4), dtype=torch.int64, device=dev)
    leaf_valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    n_leaves = 0
    n_overflow = 0
    nodes = torch.tensor([[0, 0, W, H]], dtype=torch.int64, device=dev)

    for _ in range(max_levels):
        if nodes.shape[0] == 0:
            break
        x, y, w, h = nodes.unbind(1)
        err = node_error(x, y, torch.clamp(w, min=0), torch.clamp(h, min=0))
        w1 = w // 2
        h1 = h // 2
        too_small = (w1 <= min_pixel_size) | (h1 <= min_pixel_size)
        is_leaf = (err <= threshold) | too_small

        new = nodes[is_leaf]
        kept = min(new.shape[0], cap - n_leaves)
        leaves[n_leaves:n_leaves + kept] = new[:kept]
        leaf_valid[n_leaves:n_leaves + kept] = True
        n_overflow += new.shape[0] - kept
        n_leaves += kept

        split = nodes[~is_leaf]
        fit = min(split.shape[0], cap // 4)
        n_overflow += 4 * (split.shape[0] - fit)
        x, y, w, h = split[:fit].unbind(1)
        w1, h1 = w // 2, h // 2
        w2, h2 = w - w1, h - h1
        nodes = torch.stack([
            torch.stack([x, y, w1, h1], -1),
            torch.stack([x, y + h1, w1, h2], -1),
            torch.stack([x + w1, y, w2, h1], -1),
            torch.stack([x + w1, y + h1, w2, h2], -1)], dim=1).reshape(-1, 4)

    return leaves.to(torch.float32), leaf_valid, n_leaves, n_overflow
