"""MADtree surface-normal estimator (numpy host code; a copy of
mrhash_tpu/ops/normals.py).

The port's GeoWrapper takes its normals from the host library
(`native.estimate_normals`, which raises when the library does not build);
this copy is not a fallback behind it but the port's own reference for it
in the tests.

Re-derivation of the reference's median-split covariance tree
(mrhash/src/sdf/surface_normal_estimator/mad_tree.{h,cpp}): recursive split
along the largest-covariance eigenvector through the mean; a node becomes a
leaf when its extent along that axis drops below b_max; leaf normal = the
smallest eigenvector (inherited from a plane predecessor or the nearest
ancestor with >= 3 points for degenerate leaves); per-leaf measurement weight
from a simulated LiDAR beam-divergence waveform (mad_tree.cpp:89-147).

One fix vs the reference: normals are returned in the ORIGINAL point order.
The reference partitions a copy of the cloud in place and then zips leaf
ranges against the unpermuted buffer (geowrapper.cpp:345-466), so its
normals/weights rows do not correspond to their points; harmless there only
because the projective-SDF default never reads them (DESIGN.md).
"""
from __future__ import annotations

import numpy as np

_BEAM_DIVERGENCE_DEG = 0.18       # os1 (mad_tree.cpp:91)
_ROOT_NUM_BEAMS = 11
_MEAS_SUCKS_STD = 0.25


def _leaf_weight(mean, normal):
    """Beam-divergence waveform simulation (mad_tree.cpp:89-147)."""
    beam_div = np.deg2rad(_BEAM_DIVERGENCE_DEG)
    delta = beam_div / (_ROOT_NUM_BEAMS - 1)
    rng = np.linalg.norm(mean)
    if rng < 1e-9:
        return 0.0
    az = np.arctan2(mean[1], mean[0])
    el = np.arcsin(np.clip(mean[2] / rng, -1, 1))
    mean_dir = mean / rng

    half = _ROOT_NUM_BEAMS // 2
    i = np.arange(-half, half + 1)
    azs = az + i * delta
    els = el + i * delta
    A, E = np.meshgrid(azs, els, indexing="ij")
    dirs = np.stack([np.cos(A) * np.cos(E), np.sin(A) * np.cos(E),
                     np.sin(E)], axis=-1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ang = np.arccos(np.clip(dirs @ mean_dir, -1, 1))
    inside = ang < beam_div / 2.0
    denom = dirs @ normal
    ok = inside & (np.abs(denom) >= 1e-6)
    if not ok.any():
        return 1.0  # std_dev 0
    d = (normal @ mean) / denom[ok]
    ranges = np.abs(d) * 1.0  # |d * dir| = |d|
    std = np.sqrt(np.mean((ranges - rng) ** 2))
    w = min(std, _MEAS_SUCKS_STD) / _MEAS_SUCKS_STD
    return 1.0 - w


class _Node:
    __slots__ = ("mean", "eigvecs", "num_points", "parent")

    def __init__(self, mean, eigvecs, num_points, parent):
        self.mean = mean
        self.eigvecs = eigvecs
        self.num_points = num_points
        self.parent = parent


def estimate_normals(points, b_max=0.4, b_min=0.4):
    """Returns (normals f32[N,3], eigvecs f32[N,3,3], weights f32[N]) in the
    original point order.  eigvecs columns are (normal, mid, split) like the
    reference's Eigen ascending-eigenvalue convention."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    normals = np.zeros((n, 3), np.float32)
    eigvecs_out = np.zeros((n, 3, 3), np.float32)
    weights = np.zeros((n,), np.float32)
    if n == 0:
        return normals, eigvecs_out, weights

    stack = [(np.arange(n), None, None, 0)]
    while stack:
        idx, parent, plane_pred, level = stack.pop()
        sub = pts[idx]
        mean = sub.mean(axis=0)
        centered = sub - mean
        cov = centered.T @ centered / max(len(idx), 1)
        _, eigvecs = np.linalg.eigh(cov)  # ascending eigenvalues
        # bbox extent in the eigenvector frame (computeBoundingBox)
        proj = centered @ eigvecs
        bbox = proj.max(axis=0) - proj.min(axis=0) if len(idx) else np.zeros(3)
        node = _Node(mean, eigvecs, len(idx), parent)

        if bbox[2] < b_max:
            # leaf: resolve the normal (mad_tree.cpp:66-76)
            if plane_pred is not None:
                normal = plane_pred.eigvecs[:, 0]
                node.eigvecs = node.eigvecs.copy()
                node.eigvecs[:, 0] = normal
            elif node.num_points < 3:
                anc = node
                while anc.parent is not None and anc.num_points < 3:
                    anc = anc.parent
                normal = anc.eigvecs[:, 0]
                node.eigvecs = node.eigvecs.copy()
                node.eigvecs[:, 0] = normal
            else:
                normal = node.eigvecs[:, 0]
            # leaf mean snaps to the nearest member point (:78-88)
            d = np.linalg.norm(sub - mean, axis=1)
            leaf_mean = sub[np.argmin(d)]
            # orient toward the sensor (geowrapper.cpp:420-421)
            if leaf_mean @ normal > 0:
                normal = -normal
                node.eigvecs = node.eigvecs.copy()
                node.eigvecs[:, 0] = normal
            w = _leaf_weight(leaf_mean, normal)
            normals[idx] = normal.astype(np.float32)
            eigvecs_out[idx] = node.eigvecs.astype(np.float32)
            weights[idx] = np.float32(w)
            continue

        if plane_pred is None and bbox[0] < b_min:
            plane_pred = node
        split_normal = eigvecs[:, 2]
        left_mask = centered @ split_normal < 0.0
        li, ri = idx[left_mask], idx[~left_mask]
        if len(li) == 0 or len(ri) == 0:
            # numerically degenerate split: force a leaf by halving
            half = len(idx) // 2
            li, ri = idx[:half], idx[half:]
        stack.append((li, node, plane_pred, level + 1))
        stack.append((ri, node, plane_pred, level + 1))
    return normals, eigvecs_out, weights
