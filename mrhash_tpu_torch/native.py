"""ctypes loader for the host C++ runtime in the repo's `native/` directory.

`native/mrhash_host.cpp` (vertex/face dedup, the PLY writer, the MADtree
normal estimator) and `native/mrhash_mesh.cpp` (the Transvoxel sweep over
host block payloads, with the committed `native/transvoxel_tables.h`) are
framework-free C++, shared with the JAX package.  This module compiles them
with g++ into `mrhash_tpu_torch/_build/libmrhash_host_<hash>.so`, named by
a hash of the sources, the flags and the host's CPU target, at first use;
it reads `native/` and never writes there.  A library that fails to build
or load raises: the port has no numpy fallback.  Nothing here runs at
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
SOURCES = tuple(os.path.join(NATIVE_DIR, f) for f in
                ("mrhash_host.cpp", "mrhash_mesh.cpp", "transvoxel_tables.h"))
BUILD_DIR = os.path.join(_PKG, "_build")
# -ffp-contract=off: the mesh extractor mirrors the reference's f32
# semantics; FMA contraction would skew vertex positions
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17", "-pthread")

_lib = None

_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
SIGNATURES = {
    "mrhash_dedup_vertices": (_i64, [_f64p, _i64, ctypes.c_double, _i64p]),
    "mrhash_dedup_faces": (_i64, [_i64p, _i64, _u8p]),
    "mrhash_write_mesh_ply": (ctypes.c_int, [ctypes.c_char_p, _f64p, _i64,
                                             _u8p, _i64p, _i64]),
    "mrhash_estimate_normals": (None, [_f64p, _i64, ctypes.c_double,
                                       ctypes.c_double, _f32p, _f32p]),
    "mrhash_mesh_extract": (ctypes.c_void_p, [
        _i64, _i32p, _i32p, _f32p, _i32p, _i32p, ctypes.c_float, _f32p,
        ctypes.c_float, ctypes.c_int32, _i64p]),
    "mrhash_mesh_data": (None, [ctypes.c_void_p, _f32p, _f32p]),
    "mrhash_mesh_free": (None, [ctypes.c_void_p]),
}


def _host_target():
    """What -march=native means on this host: g++'s resolved target
    options.  Part of the library's name, so that a build for another CPU
    (a copied checkout) is never loaded here."""
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ -march=native failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    return proc.stdout


def library_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_target().encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmrhash_host_{h.hexdigest()[:16]}.so")


def build():
    """Compile the host library if no build of the current sources exists.
    Raises with g++'s stderr on failure.  Returns the path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-I", NATIVE_DIR, *SOURCES[:2], "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial
    return out


def load():
    """The loaded host library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dedup_vertices(verts: np.ndarray, eps: float):
    """Returns (remap int64[n] in first-occurrence order, n_unique)."""
    v = np.ascontiguousarray(verts, np.float64)
    remap = np.empty(v.shape[0], np.int64)
    n_unique = load().mrhash_dedup_vertices(
        _ptr(v, ctypes.c_double), v.shape[0], float(eps),
        _ptr(remap, ctypes.c_int64))
    return remap, int(n_unique)


def dedup_faces(faces: np.ndarray):
    """Returns the keep mask bool[n] (degenerate and duplicate faces
    dropped)."""
    f = np.ascontiguousarray(faces, np.int64)
    keep = np.empty(f.shape[0], np.uint8)
    load().mrhash_dedup_faces(_ptr(f, ctypes.c_int64), f.shape[0],
                              _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


def write_mesh_ply(path, verts, colors, faces):
    """ASCII mesh PLY; raises if the file cannot be written."""
    v = np.ascontiguousarray(verts, np.float64)
    c = np.ascontiguousarray(np.clip(colors, 0, 255), np.uint8)
    f = np.ascontiguousarray(faces, np.int64)
    rc = load().mrhash_write_mesh_ply(
        str(path).encode(), _ptr(v, ctypes.c_double), v.shape[0],
        _ptr(c, ctypes.c_uint8), _ptr(f, ctypes.c_int64), f.shape[0])
    if rc != 0:
        raise OSError(f"write_mesh_ply: could not write {path} (rc {rc})")


def estimate_normals(points, b_max=0.4, b_min=0.4):
    """MADtree normals.  Returns (normals f32[n,3], weights f32[n])."""
    p = np.ascontiguousarray(points, np.float64)
    normals = np.zeros((p.shape[0], 3), np.float32)
    weights = np.zeros((p.shape[0],), np.float32)
    load().mrhash_estimate_normals(_ptr(p, ctypes.c_double), p.shape[0],
                                   float(b_max), float(b_min),
                                   _ptr(normals, ctypes.c_float),
                                   _ptr(weights, ctypes.c_float))
    return normals, weights


def extract_mesh_host(pos, res, sdf, w, rgb, vvs, extents, mc_threshold,
                      min_weight):
    """Transvoxel sweep over host chunk-grid block payloads.

    pos i32[N,3] block coords, res i32[N], sdf f32[N,512], w i32[N,512],
    rgb i32[N,512] packed.  Returns (tri_pos f32[T,3,3],
    tri_col f32[T,3,3] 0-255)."""
    lib = load()
    p = np.ascontiguousarray(pos, np.int32)
    r = np.ascontiguousarray(res, np.int32)
    s = np.ascontiguousarray(sdf, np.float32)
    wi = np.ascontiguousarray(w, np.int32)
    rg = np.ascontiguousarray(rgb, np.int32)
    ext = np.ascontiguousarray(extents, np.float32)
    nt = np.zeros(1, np.int64)
    h = lib.mrhash_mesh_extract(
        p.shape[0], _ptr(p, ctypes.c_int32), _ptr(r, ctypes.c_int32),
        _ptr(s, ctypes.c_float), _ptr(wi, ctypes.c_int32),
        _ptr(rg, ctypes.c_int32), ctypes.c_float(float(vvs)),
        _ptr(ext, ctypes.c_float), ctypes.c_float(float(mc_threshold)),
        ctypes.c_int32(int(min_weight)), _ptr(nt, ctypes.c_int64))
    try:
        t = int(nt[0])
        tri_pos = np.empty((t, 3, 3), np.float32)
        tri_col = np.empty((t, 3, 3), np.float32)
        if t:
            lib.mrhash_mesh_data(h, _ptr(tri_pos, ctypes.c_float),
                                 _ptr(tri_col, ctypes.c_float))
    finally:
        lib.mrhash_mesh_free(h)
    return tri_pos, tri_col
