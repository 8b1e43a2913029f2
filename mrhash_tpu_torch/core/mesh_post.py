"""Host-side mesh accumulation + dedup.

A copy of mrhash_tpu/core/mesh_post.py (MeshExtractor's CPU
post-processing, mrhash/src/sdf/mesh_extractor.cpp:8-259): triangle-soup
-> indexed mesh, duplicate-vertex removal (exact or epsilon-quantized),
first-occurrence color assignment, degenerate-face filter, duplicate-face
removal.  Vertex and face dedup run in the host library (`native`), which
raises if it does not build; the reference's numpy fallback is not copied.
"""
from __future__ import annotations

import numpy as np

from mrhash_tpu_torch import native


class MeshAccumulator:
    """Accumulates triangle batches across chunk sweeps (processTriangles,
    mesh_extractor.cpp:8-76)."""

    def __init__(self, vertices_merging_threshold: float = 0.0):
        self.eps = float(vertices_merging_threshold)
        self.vertices = np.zeros((0, 3), np.float64)
        self.faces = np.zeros((0, 3), np.int64)
        self.colors = np.zeros((0, 3), np.float64)

    def reset(self):
        self.vertices = np.zeros((0, 3), np.float64)
        self.faces = np.zeros((0, 3), np.int64)
        self.colors = np.zeros((0, 3), np.float64)

    def add_triangles(self, tri_pos: np.ndarray, tri_col: np.ndarray):
        """tri_pos/tri_col: [T,3,3] (triangle, vertex, xyz / rgb 0-255)."""
        t = tri_pos.shape[0]
        if t == 0 and self.vertices.shape[0] == 0:
            return
        new_v = tri_pos.reshape(-1, 3).astype(np.float64)
        new_c = tri_col.reshape(-1, 3).astype(np.float64)
        new_f = np.arange(t * 3, dtype=np.int64).reshape(-1, 3)

        base = self.vertices.shape[0]
        self.vertices = np.concatenate([self.vertices, new_v], axis=0)
        self.colors = np.concatenate([self.colors, new_c], axis=0)
        self.faces = np.concatenate([self.faces, new_f + base], axis=0)
        self._dedup()

    def _dedup(self):
        v, f, c = self.vertices, self.faces, self.colors
        if v.shape[0] == 0:
            return
        # duplicate-vertex removal: exact rows or epsilon-quantized grid
        # (removeDuplicateVerticesTriangle, mesh_extractor.cpp:181-258)
        old_to_new, n_unique = native.dedup_vertices(v, self.eps)
        first_idx = np.zeros(n_unique, np.int64)
        # first occurrence per new index (remap is first-occurrence
        # ordered, so a reverse pass keeps the first)
        for_order = np.arange(v.shape[0])[::-1]
        first_idx[old_to_new[for_order]] = for_order
        self.vertices = v[first_idx]
        self.colors = c[first_idx]
        f = old_to_new[f]
        # degenerate + duplicate faces (mesh_extractor.cpp:61-72, 156-178)
        self.faces = f[native.dedup_faces(f)]
