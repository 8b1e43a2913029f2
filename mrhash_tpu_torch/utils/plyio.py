"""Minimal PLY mesh / point-cloud IO (ASCII + binary_little_endian).

A copy of mrhash_tpu/utils/plyio.py, which replaces the reference's
tinyply usage and hand-rolled ASCII writer (geowrapper.cpp:194-229,
utils/point_cloud_serializer.h:11-143).  The mesh writer is the host
library's (`native`); the reference's Python fallback writer is not copied.
"""
from __future__ import annotations

import numpy as np

from mrhash_tpu_torch import native


def write_mesh_ply(path, vertices, faces, colors=None):
    """ASCII PLY with per-vertex uchar colors, matching the output layout of
    GeoWrapper::extractMesh (geowrapper.cpp:194-229)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    if colors is None:
        colors = np.zeros_like(v)
    c = np.clip(np.asarray(colors, np.float64), 0, 255).astype(np.uint8)
    native.write_mesh_ply(path, v, c, f)


def write_points_ply(path, points, colors=None, extra_props=None,
                     binary=False):
    """Point cloud with optional uchar colors and extra float properties
    (utils/point_cloud_serializer.h)."""
    p = np.asarray(points, np.float32)
    n = p.shape[0]
    cols = None if colors is None else np.clip(
        np.asarray(colors), 0, 255).astype(np.uint8)
    extras = extra_props or {}

    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if cols is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    for name in extras:
        header += [f"property float {name}"]
    header += ["end_header"]

    if binary:
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if cols is not None:
            fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        for name in extras:
            fields += [(name, "<f4")]
        rec = np.zeros(n, dtype=fields)
        rec["x"], rec["y"], rec["z"] = p[:, 0], p[:, 1], p[:, 2]
        if cols is not None:
            rec["r"], rec["g"], rec["b"] = cols[:, 0], cols[:, 1], cols[:, 2]
        for name, vals in extras.items():
            rec[name] = np.asarray(vals, np.float32)
        with open(path, "wb") as fh:
            fh.write(("\n".join(header) + "\n").encode())
            rec.tofile(fh)
    else:
        with open(path, "w") as fh:
            fh.write("\n".join(header) + "\n")
            for i in range(n):
                row = [f"{p[i,0]:g}", f"{p[i,1]:g}", f"{p[i,2]:g}"]
                if cols is not None:
                    row += [str(cols[i, 0]), str(cols[i, 1]), str(cols[i, 2])]
                for name, vals in extras.items():
                    row.append(f"{float(vals[i]):g}")
                fh.write(" ".join(row) + "\n")


def read_points_ply(path):
    """Reads ASCII or binary_little_endian PLY point clouds (x,y,z + any
    float/uchar props).  Returns (points f32[N,3], props dict)."""
    with open(path, "rb") as fh:
        data = fh.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:head_end].decode().splitlines()
    body = data[head_end + len(b"end_header\n"):]

    n = 0
    fmt = "ascii"
    props = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex and parts[1] != "list":
            props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    if fmt.startswith("binary"):
        dtype = np.dtype([(name, type_map[t]) for name, t in props])
        rec = np.frombuffer(body[:n * dtype.itemsize], dtype=dtype, count=n)
        cols = {name: np.asarray(rec[name]) for name, _ in props}
    else:
        rows = np.loadtxt(body.decode().splitlines()[:n], ndmin=2)
        cols = {name: rows[:, i] for i, (name, _) in enumerate(props)}
    pts = np.stack([cols["x"], cols["y"], cols["z"]], 1).astype(np.float32)
    extra = {k: v for k, v in cols.items() if k not in ("x", "y", "z")}
    return pts, extra
