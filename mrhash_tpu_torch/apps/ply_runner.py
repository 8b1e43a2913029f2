"""LiDAR PLY runner on the port (mrhash/apps/ply_runner.py): spherical
camera intrinsics fit from the first cloud, per-frame setPointCloud +
compute, then streamAllOut + extractMesh + serializeData.

    python -m mrhash_tpu_torch.apps.ply_runner configurations/newer_college.cfg
"""
from __future__ import annotations

import argparse

import numpy as np

from mrhash_tpu_torch.apps.runner_common import (build_geowrapper,
                                                 load_config,
                                                 prepare_results_dir,
                                                 progress)
from mrhash_tpu_torch.apps.utils.camera import (CameraModel,
                                                calculate_spherical_intrinsics)
from mrhash_tpu_torch.apps.utils.readers import PLYReader


def lidar_loop(reader, cfg, config, rows=64, cols=1024, compute_normals=False,
               end_frame_override=None, skip_outputs=False,
               camera_in_lidar=None, **wrapper_overrides):
    results_dir, timestamp = prepare_results_dir(config, cfg)
    sensor = cfg["sensor"]
    end_frame = cfg.get("end_frame", -1)
    if end_frame == -1:
        end_frame = len(reader) + 1
    if end_frame_override is not None:
        end_frame = end_frame_override

    gw = build_geowrapper(cfg, sensor["min_depth"], sensor["max_depth"],
                          **wrapper_overrides)
    if camera_in_lidar is not None:
        gw.setCameraInLidar(camera_in_lidar)
    camera_set = False
    for i, (pose, quat, points) in enumerate(progress(reader)):
        if i + 1 > end_frame:
            break
        if points.shape[0] == 0:
            continue
        if not camera_set:
            K, _, _, _ = calculate_spherical_intrinsics(points, rows, cols)
            gw.setCamera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], rows, cols,
                         sensor["min_depth"], sensor["max_depth"],
                         CameraModel.Spherical)
            camera_set = True
        gw.setCurrPose(pose, quat)
        gw.setPointCloud(points.astype(np.float32), compute_normals)
        gw.compute()

    if not skip_outputs:
        gw.streamAllOut()
        gw.extractMesh(f"{results_dir}/mesh_{timestamp}.ply")
        gw.serializeData(f"{results_dir}/hash_points_{timestamp}.ply",
                         f"{results_dir}/voxel_points_{timestamp}.ply")
        gw.clearBuffers()
    return gw


def main(config_path, **kw):
    config, cfg = load_config(config_path)
    sensor = cfg["sensor"]
    reader = PLYReader(cfg["data_path"], min_range=sensor["min_depth"],
                       max_range=sensor["max_depth"])
    return lidar_loop(reader, cfg, config, **kw)


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config_path", nargs="?",
                    default="configurations/newer_college.cfg")
    ap.add_argument("--end-frame", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.config_path, end_frame_override=args.end_frame,
         device=args.device)


if __name__ == "__main__":
    run()
