"""Semantic-label mapping utilities (a copy of
mrhash_tpu/apps/utils/semantic_segmentation.py, after mrhash/apps/utils/
semantic_segmentation.py): ADE20K class ids -> KITTI-360 label ids, with
instance/class color tables for visualization.  (Like the reference, these
are auxiliary utilities not used by the runner paths.)"""
from __future__ import annotations

import numpy as np

from mrhash_tpu_torch.apps.utils.labels import (ADE20K_CLASSES,
                                                KITTI_360_LABELS)


def _instance_colors(n=256, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    cols[0] = (0, 255, 0)
    return cols


instance_colors = _instance_colors()

_SPECIAL_CASES = {
    "tree": "vegetation",
    "plant": "vegetation",
    "grass": "terrain",
    "streetlight": ["pole", "lamp"],
    "signboard": "traffic sign",
}


def create_kitti360_lookup(labels=KITTI_360_LABELS):
    """semantic_segmentation.py:317-341: label-name -> KITTI-360 id map with
    the reference's ADE20K special-case aliases."""
    lookup = {lab.name: lab.id for lab in labels}
    for ade_name, target in _SPECIAL_CASES.items():
        if isinstance(target, list):
            for cand in target:
                if cand in lookup:
                    lookup[ade_name] = lookup[cand]
        elif target in lookup:
            lookup[ade_name] = lookup[target]
    return lookup


kitti360_lookup = create_kitti360_lookup()


def ade20k2kitti360(ade20k_id: int) -> int:
    """semantic_segmentation.py:344-346: unknown classes map to 255."""
    label = ADE20K_CLASSES.get(int(ade20k_id), "void")
    return kitti360_lookup.get(label, 255)


def class_color_mapping():
    return [(cid, name, tuple(int(v) for v in
                              reversed(instance_colors[cid % 256])))
            for cid, name in ADE20K_CLASSES.items()]


def class_color_mapping_kitti360():
    by_id = {lab.id: lab for lab in KITTI_360_LABELS}
    return [(cid, name, tuple(by_id[cid].color))
            for name, cid in kitti360_lookup.items() if cid in by_id]
