"""RGB-D dataset runner on the port (mrhash/apps/rgbd_runner.py): YAML
config -> DepthReader -> per-frame pose/depth/rgb -> compute ->
[GSFinalOpt + GSSavePointCloud with gs=True] -> streamAllOut +
extractMesh + serializeData.

    python -m mrhash_tpu_torch.apps.rgbd_runner configurations/replica.cfg
"""
from __future__ import annotations

import argparse

from mrhash_tpu_torch.apps.utils.camera import Camera, CameraModel
from mrhash_tpu_torch.apps.utils.readers import DepthReader
from mrhash_tpu_torch.apps.runner_common import (build_geowrapper,
                                                 load_config, pinhole_K,
                                                 prepare_results_dir,
                                                 progress)


def integrate_frames(gw, frames, end_frame):
    """Feed each (frame, pose, quat, depth, rgb) of `frames` to `gw` up to
    frame number `end_frame`."""
    for frame, pose, quat, depth_img, rgb_img in progress(frames):
        if frame > end_frame:
            break
        gw.setCurrPose(pose, quat)
        gw.setDepthImage(depth_img)
        gw.setRGBImage(rgb_img)
        gw.compute()


def main(config_path, gs=False, end_frame_override=None, skip_outputs=False,
         **wrapper_overrides):
    config, cfg = load_config(config_path)
    results_dir, timestamp = prepare_results_dir(config, cfg)

    sensor = cfg["sensor"]
    K = pinhole_K(cfg)
    reader = DepthReader(cfg["data_path"],
                         min_range=sensor["min_depth"],
                         max_range=sensor["max_depth"],
                         depth_scaling=sensor["depth_scaling"],
                         sensor_hz=sensor.get("hz", 30))
    end_frame = cfg.get("end_frame", -1)
    if end_frame == -1:
        end_frame = len(reader) + 1
    if end_frame_override is not None:
        end_frame = end_frame_override

    cam = Camera(rows=sensor["resolution"][1], cols=sensor["resolution"][0],
                 K=K, min_depth=sensor["min_depth"],
                 max_depth=sensor["max_depth"], model=CameraModel.Pinhole)
    gs_path = cfg.get("gs_optimization_param_path", "") if gs else ""
    gw = build_geowrapper(cfg, sensor["min_depth"], sensor["max_depth"],
                          gs_optimization_param_path=gs_path,
                          **wrapper_overrides)
    gw.setCamera(cam.fx_, cam.fy_, cam.cx_, cam.cy_, cam.rows_, cam.cols_,
                 cam.min_depth_, cam.max_depth_, cam.model_)

    integrate_frames(gw, reader, end_frame)

    if gs:
        gw.GSFinalOpt()
        gw.GSSavePointCloud(str(results_dir))
    if not skip_outputs:
        gw.streamAllOut()
        gw.extractMesh(f"{results_dir}/mesh_{timestamp}.ply")
        gw.serializeData(f"{results_dir}/hash_points_{timestamp}.ply",
                         f"{results_dir}/voxel_points_{timestamp}.ply")
        gw.clearBuffers()
    return gw


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config_path", nargs="?",
                    default="configurations/replica.cfg")
    ap.add_argument("--end-frame", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.config_path, end_frame_override=args.end_frame,
         device=args.device)


if __name__ == "__main__":
    run()
