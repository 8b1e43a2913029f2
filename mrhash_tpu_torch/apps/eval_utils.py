"""Reconstruction-quality metrics (a copy of mrhash_tpu/apps/eval_utils.py,
after mrhash/apps/utils/eval_utils.py without the open3d dependency): mesh
surface sampling, chunked nearest-neighbor distances via scipy cKDTree
(imported when `nn_distances` runs), and the Accuracy/Completeness MAE,
Chamfer-L1, Precision/Recall/F-score table the paper reports.  The PLY
writers are the port's (`mrhash_tpu_torch.utils.plyio`).
"""
from __future__ import annotations

import numpy as np

DEFAULT_THRESHOLDS = [0.05, 0.1, 0.2, 0.25, 0.5]
DEFAULT_TRUNCATIONS = [0.1, 0.2, 0.4, 0.5, 1.0]


def sample_mesh_points(vertices, faces, n_points=10_000_000, seed=0):
    """Uniform area-weighted surface sampling (the open3d
    sample_points_uniformly equivalent)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    if f.shape[0] == 0:
        return np.zeros((0, 3))
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        return np.zeros((0, 3))
    rng = np.random.default_rng(seed)
    tri = rng.choice(f.shape[0], size=n_points, p=areas / total)
    u = rng.random(n_points)
    w = rng.random(n_points)
    flip = u + w > 1
    u[flip] = 1 - u[flip]
    w[flip] = 1 - w[flip]
    return a[tri] + u[:, None] * (b[tri] - a[tri]) + w[:, None] * (c[tri] - a[tri])


def nn_distances(src, dst, chunk=1_000_000):
    """Chunked nearest-neighbor distances src -> dst."""
    from scipy.spatial import cKDTree
    if dst.shape[0] == 0:
        return np.full(src.shape[0], np.inf)
    tree = cKDTree(np.asarray(dst))
    out = np.empty(src.shape[0])
    for i in range(0, src.shape[0], chunk):
        out[i:i + chunk], _ = tree.query(src[i:i + chunk], workers=-1)
    return out


def crop_to_bbox(points, bbox_min, bbox_max):
    m = np.all((points >= bbox_min) & (points <= bbox_max), axis=1)
    return points[m]


def voxel_downsample(points, voxel):
    if points.shape[0] == 0 or voxel <= 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def evaluate_reconstruction(est_points, gt_points,
                            thresholds=DEFAULT_THRESHOLDS,
                            truncations=DEFAULT_TRUNCATIONS):
    """eval_utils.py:8-139: accuracy = est->gt distances, completeness =
    gt->est, F-score per (threshold, truncation) pair."""
    d_acc = nn_distances(est_points, gt_points)      # est -> gt (accuracy)
    d_comp = nn_distances(gt_points, est_points)     # gt -> est (completeness)

    rows = []
    for thr, trunc in zip(thresholds, truncations):
        acc = d_acc[d_acc <= trunc]
        comp = d_comp[d_comp <= trunc]
        accuracy_mae = float(acc.mean()) if acc.size else float("inf")
        completeness_mae = float(comp.mean()) if comp.size else float("inf")
        chamfer_l1 = 0.5 * (accuracy_mae + completeness_mae)
        precision = float((d_acc <= thr).mean()) if d_acc.size else 0.0
        recall = float((d_comp <= thr).mean()) if d_comp.size else 0.0
        fscore = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
        rows.append(dict(threshold=thr, truncation=trunc,
                         accuracy_mae=accuracy_mae,
                         completeness_mae=completeness_mae,
                         chamfer_l1=chamfer_l1, precision=precision,
                         recall=recall, fscore=fscore))
    return rows


def write_csv(rows, path):
    import csv
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def error_colormap(errors):
    """colormap (ref eval_utils.py:300-306): white at 0 error -> red at max;
    errors normalized to [0,1]."""
    colors = np.zeros((len(errors), 3))
    colors[:, 0] = 1.0
    colors[:, 1] = 1.0 - errors
    colors[:, 2] = 1.0 - errors
    return colors


def save_error_map(points, errors, path, clip=0.20):
    """Per-point error-colored cloud (generate_save_error_map, ref
    eval_utils.py:273-282): clip errors to [0, clip] m, normalize, colormap,
    write a PLY."""
    from mrhash_tpu_torch.utils import plyio
    e = np.clip(np.asarray(errors, np.float64), 0.0, clip) / clip
    colors = (error_colormap(e) * 255.0).astype(np.uint8)
    plyio.write_points_ply(path, np.asarray(points, np.float32),
                           colors=colors)
    return path


def save_mesh_error_map(vertices, faces, gt_points, path, clip=0.10):
    """Error-colored mesh (generate_mesh_error_map, ref eval_utils.py:
    285-297): vertex colors from the vertex->GT nearest distances."""
    from mrhash_tpu_torch.utils import plyio
    d = nn_distances(np.asarray(vertices, np.float64),
                     np.asarray(gt_points, np.float64))
    e = np.clip(d, 0.0, clip) / clip
    colors = (error_colormap(e) * 255.0).astype(np.uint8)
    plyio.write_mesh_ply(path, np.asarray(vertices, np.float32),
                         np.asarray(faces, np.int32), colors=colors)
    return path
