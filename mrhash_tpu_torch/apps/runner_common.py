"""Config loading + GeoWrapper construction for the port's runners.

Thin copy of mrhash_tpu/apps/runner_common.py: that module imports the JAX
GeoWrapper at import time, so the port carries its own, building the
PyTorch GeoWrapper from the same config layout.  The configs are read by
`parse_config`, a reader for the YAML subset that configurations/*.cfg use,
so the runners need no PyYAML.
"""
from __future__ import annotations

import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np

from mrhash_tpu_torch.geowrapper import GeoWrapper


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9]*\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")


def _strip_comment(line):
    """The line without a `#` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text):
    """A YAML plain or quoted scalar, or a flow list of them, as
    yaml.safe_load reads it: int, float, bool, null or str."""
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(v.strip()) for v in inner.split(",")] if inner else []
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE", "false", "False", "FALSE"):
        return text.lower() == "true"
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def parse_config(text):
    """Read the YAML subset of the repo's .cfg files: `key: value` lines,
    maps nested by indentation, `#` comments, and scalars or flow lists
    (`[600.0, 600.0, 599.5, 339.5]`) as values.  Anything else raises
    ValueError."""
    root: dict = {}
    stack = [(-1, root)]
    empty = []                      # keys whose value is a nested map
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        key, value = key.strip(), value.strip()
        if not sep or not key or line.lstrip(" ")[0] in "-[{\t":
            raise ValueError(f"config line {n}: not a `key: value` line")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value:
            parent[key] = _scalar(value)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
            empty.append((parent, key))
    for parent, key in empty:       # `key:` with nothing nested is null
        if parent[key] == {}:
            parent[key] = None
    return root


def load_config(config_path):
    config = Path(config_path)
    if not config.exists():
        print(f"Error: Config file {config} does not exist!")
        sys.exit(1)
    cfg = parse_config(config.read_text())
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


def progress(frames, desc="processing...", every=100):
    """`frames` under a tqdm bar, or, where tqdm is not installed, as they
    are with a line on stdout every `every` frames."""
    try:
        from tqdm import tqdm
    except ImportError:
        return _plain_progress(frames, desc, every)
    return tqdm(frames, desc=desc)


def _plain_progress(frames, desc, every):
    n = 0
    for n, item in enumerate(frames, 1):
        yield item
        if n % every == 0:
            print(f"{desc} {n} frames", flush=True)
    print(f"{desc} done, {n} frames", flush=True)


def pinhole_K(cfg):
    K = np.zeros((3, 3), np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cfg["sensor"]["intrinsics"]
    K[2, 2] = 1
    return K
