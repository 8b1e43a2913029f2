"""Reconstruction evaluation CLI (a copy of
mrhash_tpu/apps/eval_reconstruction.py, after
mrhash/apps/eval_reconstruction.py): `evaluate` samples the estimated mesh,
optionally crops to the GT bbox and voxel-downsamples, then reports
Accuracy/Completeness MAE, Chamfer-L1 and Precision/Recall/F-score to a
CSV.  It only reads files, so it runs on the host and takes no --device.

    python -m mrhash_tpu_torch.apps.eval_reconstruction evaluate \
        mesh.ply gt.ply --out-csv eval.csv
"""
from __future__ import annotations

import argparse

import numpy as np

from mrhash_tpu_torch.apps import eval_utils
from mrhash_tpu_torch.utils.plyio import read_points_ply


def read_mesh_ply(path):
    """ASCII mesh PLY (vertices + faces) reader."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    n_v = n_f = 0
    for line in header:
        p = line.split()
        if p[:2] == ["element", "vertex"]:
            n_v = int(p[2])
        elif p[:2] == ["element", "face"]:
            n_f = int(p[2])
    body = data[head_end:].decode().splitlines()
    verts = np.loadtxt(body[:n_v], ndmin=2)[:, :3]
    faces = np.loadtxt(body[n_v:n_v + n_f], ndmin=2)[:, 1:4].astype(np.int64)
    return verts, faces


def evaluate(est_mesh, gt_cloud, out_csv, n_points=10_000_000,
             crop=False, downsample_voxel=0.0, error_map=""):
    verts, faces = read_mesh_ply(est_mesh)
    est = eval_utils.sample_mesh_points(verts, faces, n_points)
    gt, _ = read_points_ply(gt_cloud)
    gt = gt.astype(np.float64)
    if crop:
        est = eval_utils.crop_to_bbox(est, gt.min(0), gt.max(0))
    if downsample_voxel > 0:
        est = eval_utils.voxel_downsample(est, downsample_voxel)
        gt = eval_utils.voxel_downsample(gt, downsample_voxel)
    rows = eval_utils.evaluate_reconstruction(est, gt)
    eval_utils.write_csv(rows, out_csv)
    if error_map:
        # completeness error map (GT points colored by distance to the
        # estimate, ref eval_utils.py:273-282, 309-352) + an error-colored
        # copy of the estimated mesh
        d_comp = eval_utils.nn_distances(gt, est)
        eval_utils.save_error_map(gt, d_comp, error_map + "_complete.ply")
        eval_utils.save_mesh_error_map(verts, faces, gt,
                                       error_map + "_accuracy.ply")
    for r in rows:
        print(r)
    return rows


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("evaluate")
    ev.add_argument("est_mesh")
    ev.add_argument("gt_cloud")
    ev.add_argument("--out-csv", default="eval.csv")
    ev.add_argument("--n-points", type=int, default=10_000_000)
    ev.add_argument("--crop", action="store_true")
    ev.add_argument("--downsample-voxel", type=float, default=0.0)
    ev.add_argument("--error-map", default="",
                    help="path prefix for error-colored PLY exports")
    args = ap.parse_args()
    evaluate(args.est_mesh, args.gt_cloud, args.out_csv, args.n_points,
             args.crop, args.downsample_voxel, args.error_map)


if __name__ == "__main__":
    run()
