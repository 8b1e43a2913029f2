"""Synthetic streaming soak test on the port (mrhash/apps/streamer_example.cu:
41-176, a copy of mrhash_tpu/apps/streamer_example.py): a configured
straight or circular trajectory with noisy synthetic depth (zeroed
borders), the full stream/integrate loop, then streamAllOut and a
serializeGrid / deserializeGrid round trip, after which the duplicate ratio
must stay below 0.15.

    python -m mrhash_tpu_torch.apps.streamer_example \\
        [configurations/streamer_example.cfg] [--circular] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from mrhash_tpu_torch.apps.runner_common import load_config
from mrhash_tpu_torch.geowrapper import GeoWrapper


def synthetic_depth(rows, cols, default_depth, rng, noise=0.01, border=None):
    if border is None:
        border = max(1, min(20, rows // 8, cols // 8))
    depth = np.full((rows, cols), default_depth, np.float32)
    depth += rng.normal(0, noise, size=depth.shape).astype(np.float32)
    depth[:border] = 0.0
    depth[-border:] = 0.0
    depth[:, :border] = 0.0
    depth[:, -border:] = 0.0
    return depth


def main(config_path, circular=False, device="cuda"):
    _, cfg = load_config(config_path)
    rows, cols = cfg["rows"], cfg["cols"]
    steps = cfg["steps"]
    rng = np.random.default_rng(0)

    gw = GeoWrapper(
        sdf_truncation=cfg["sdf_truncation"],
        sdf_truncation_scale=cfg["sdf_truncation_scale"],
        integration_weight_sample=cfg["integration_weight_sample"],
        virtual_voxel_size=cfg["virtual_voxel_size"],
        n_frames_invalidate_voxels=cfg["n_frames_invalidate_voxels"],
        voxel_extents_scale=cfg["voxel_extents_scale"],
        marching_cubes_threshold=cfg["marching_cubes_threshold"],
        min_weight_threshold=cfg["min_weight_threshold"],
        min_depth=cfg["min_depth"],
        max_depth=cfg["max_depth"],
        sdf_var_threshold=cfg["sdf_var_threshold"],
        vertices_merging_threshold=cfg["vertices_merging_threshold"],
        num_blocks=cfg.get("num_sdf_blocks", 16384),
        device=device,
    )
    f = 0.8 * cols
    gw.setCamera(f, f, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols,
                 cfg["min_depth"], cfg["max_depth"], 0)

    ts = cfg.get("translation_step", 0.0)
    for i in range(steps):
        if circular:
            th = 2 * np.pi * i / steps
            quat = np.array([0, 0, np.sin(th / 2), np.cos(th / 2)])
            pos = np.array([np.cos(th), np.sin(th), 0.0])
        else:
            quat = np.array([0, 0, 0, 1.0])
            pos = np.array([ts * i, 0.0, 0.0])
        gw.setCurrPose(pos, quat)
        gw.setDepthImage(synthetic_depth(rows, cols, cfg["default_depth"],
                                         rng))
        gw.setRGBImage(np.full((rows, cols, 3), 120, np.uint8))
        gw.compute()

    gw.streamAllOut()
    gw.serializeGrid("./streamer_example_grid.npz")
    gw.deserializeGrid("./streamer_example_grid.npz")
    gw.streamer.print_statistics()
    dup = gw.streamer.duplicate_ratio(gw.state)
    print(f"streamer_example | duplicate ratio: {dup}")
    assert dup < 0.15
    return gw


def run():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config_path", nargs="?",
                    default="configurations/streamer_example.cfg")
    ap.add_argument("--circular", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain twins")
    args = ap.parse_args()
    main(args.config_path, args.circular, args.device)


if __name__ == "__main__":
    run()
