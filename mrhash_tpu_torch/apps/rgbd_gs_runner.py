"""RGB-D + online 3D Gaussian Splatting runner on the port
(mrhash/apps/rgbd_gs_runner.py): the rgbd_runner loop with the config's
gs_optimization_param_path, then GSFinalOpt and GSSavePointCloud into the
results directory.

    python -m mrhash_tpu_torch.apps.rgbd_gs_runner configurations/replica.cfg
"""
from __future__ import annotations

import argparse

from mrhash_tpu_torch.apps.rgbd_runner import main as rgbd_main


def main(config_path, **kw):
    return rgbd_main(config_path, gs=True, **kw)


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
