"""Config loading + GeoWrapper construction for the port's runners.

Thin copy of mrhash_tpu/apps/runner_common.py: that module imports the JAX
GeoWrapper at import time, so the port carries its own, building the
PyTorch GeoWrapper from the same YAML layout.
"""
from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

import numpy as np
import yaml

from mrhash_tpu_torch.geowrapper import GeoWrapper


def load_config(config_path):
    config = Path(config_path)
    if not config.exists():
        print(f"Error: Config file {config} does not exist!")
        sys.exit(1)
    with open(config) as f:
        cfg = yaml.safe_load(f)
    return config, cfg


def prepare_results_dir(config, cfg):
    results_dir = Path(cfg["results_path"])
    results_dir.mkdir(parents=True, exist_ok=True)
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    shutil.copy(config, results_dir / f"{timestamp}_{config.name}")
    return results_dir, timestamp


def build_geowrapper(cfg, min_depth, max_depth, **overrides):
    m, mesh, st = cfg["map"], cfg["mesh"], cfg["streamer"]
    return GeoWrapper(
        sdf_truncation=m["sdf_truncation"],
        sdf_truncation_scale=m["sdf_truncation_scale"],
        integration_weight_sample=m["integration_weight_sample"],
        virtual_voxel_size=m["virtual_voxel_size"],
        n_frames_invalidate_voxels=m["n_frames_invalidate_voxels"],
        voxel_extents_scale=st["voxel_extents_scale"],
        marching_cubes_threshold=mesh["marching_cubes_threshold"],
        min_weight_threshold=mesh.get("min_weight_threshold", 1),
        sdf_var_threshold=mesh.get("sdf_var_threshold", 0.0),
        vertices_merging_threshold=mesh.get("vertices_merging_threshold",
                                            0.0),
        projective_sdf=cfg.get("projective_sdf", True),
        min_depth=min_depth,
        max_depth=max_depth,
        **overrides,
    )


def pinhole_K(cfg):
    K = np.zeros((3, 3), np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cfg["sensor"]["intrinsics"]
    K[2, 2] = 1
    return K
