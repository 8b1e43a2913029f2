"""KITTI LiDAR runner on the port (mrhash/apps/kitti_runner.py).

    python -m mrhash_tpu_torch.apps.kitti_runner configurations/maicity.cfg
"""
from __future__ import annotations

import argparse

from mrhash_tpu_torch.apps.ply_runner import lidar_loop
from mrhash_tpu_torch.apps.runner_common import load_config
from mrhash_tpu_torch.apps.utils.readers import KittiReader


def main(config_path, **kw):
    config, cfg = load_config(config_path)
    sensor = cfg["sensor"]
    reader = KittiReader(cfg["data_path"], min_range=sensor["min_depth"],
                         max_range=sensor["max_depth"],
                         sensor_hz=sensor.get("hz", 10))
    return lidar_loop(reader, cfg, config, **kw)


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config_path", nargs="?",
                    default="configurations/maicity.cfg")
    ap.add_argument("--end-frame", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.config_path, end_frame_override=args.end_frame,
         device=args.device)


if __name__ == "__main__":
    run()
