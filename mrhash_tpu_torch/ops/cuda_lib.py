"""Build and load the port's CUDA kernels (mrhash_tpu_torch/csrc/*.cu),
and the device policy that every kernel entry asks (on_card).

The kernels are compiled with nvcc, one process per source started
together, and linked into one shared library with a plain C interface,
loaded with ctypes.  The library lands in
mrhash_tpu_torch/_build/, named by a hash of the sources and flags, and is
built at first use, so a fresh checkout builds it on its first call and a
changed source never loads a stale binary.  Nothing here runs at import.

Flags: sm_90a (Hopper), -O3, no --use_fast_math, and -fmad=false — the
kernels truncate projected pixel coordinates to int, and a contracted FMA
or an approximate division would move voxels that sit on a pixel boundary
onto the next pixel, away from the plain PyTorch twins; and K5 divides by
the 1 - alpha of K4, which must be bit-identical in both.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None

_vp = ctypes.c_void_p
_i = ctypes.c_int
_i64 = ctypes.c_int64
_f = ctypes.c_float
_u32 = ctypes.c_uint32
SIGNATURES = {
    # depth, rgbp, cols, cam, bpos, ptr, entries, n_entries, res,
    # sdf, sumsq, weight, rgbp_pool, flags, stream
    "mrhash_fused_integrate_window": [_vp, _vp, _i, _vp, _vp, _vp, _vp,
                                      _i64, _i, _vp, _vp, _vp, _vp, _vp,
                                      _vp],
    # img, rows, cols, row, col, ok, n_blocks, out, stream
    "mrhash_sample_image": [_vp, _i, _i, _vp, _vp, _vp, _i64, _vp, _vp],
    # img5, rows, cols, r0, c0, lr, lc, n_blocks, out, stream
    "mrhash_sample_image5": [_vp, _i, _i, _vp, _vp, _vp, _vp, _i64, _vp,
                             _vp],
    # img, pix, r_vox, ptr, entries, n0, n1, t0, t1, max_int, w_sample,
    # w_max, vvs, sdf, sumsq, weight, flags, stream
    "mrhash_fused_integrate_points_window": [_vp, _vp, _vp, _vp, _vp, _i64,
                                             _i64, _f, _f, _f, _f, _f, _f,
                                             _vp, _vp, _vp, _vp, _vp],
    # n0, n1, stream
    "mrhash_fused_integrate_points_floor": [_i64, _i64, _vp],
    # attr, valid, n_tiles, K, grid_x, tfin, cfin, mask, stream
    "mrhash_blend_forward": [_vp, _vp, _i, _i, _i, _vp, _vp, _vp, _vp],
    # attr, valid, n_tiles, K, grid_x, tfin, mask, gt, gc, gout, stream
    "mrhash_blend_backward": [_vp, _vp, _i, _i, _i, _vp, _vp, _vp, _vp, _vp,
                              _vp],
    # mode, depth, rs, cs, s, py, px, ws, row0, h, w, far, points, normals,
    # fx, fy, cx, cy, rot, trans, t0, t1, mdist, vvs, ex, ey, ez, n_rays,
    # steps, keys, valid, scratch, n_cells, salt, stream
    "mrhash_alloc_walk": [_i, _vp, _i64, _i64, *[_i] * 8, *[_vp] * 8,
                          *[_f] * 7, _i64, _i, _vp, _vp, _vp, _i64, _u32,
                          _vp],
    # keys, valid, n, scratch, n_cells, salt, stream
    "mrhash_alloc_scatter": [_vp, _vp, _i64, _vp, _i64, _u32, _vp],
    # scratch, n_cells, keys, u_max, ukeys, stats, stream
    "mrhash_alloc_compact": [_vp, _i64, _vp, _i64, _vp, _vp, _vp],
    # keys, n_dev, n_host, n_max, res, res_const, n_buckets, capacity, pos,
    # ptr, res_tab, fp, heap_high, n_high, high_count, heap_low, n_low,
    # low_count, out_slot, out_ptr, out_res, out_new, out_present, sorted,
    # ws32, stats, stream
    "mrhash_alloc_insert": [_vp, _vp, _i64, _i64, _vp, _i, _i64, _i64,
                            *[_vp] * 5, _i64, _i64, _vp, _i64, _i64,
                            *[_vp] * 9],
    # decide, slots, bpos, n_window, cap, pos, ptr, res, fp, heap_high,
    # n_high, high_count, heap_low, n_low, low_count, split_chunk, freed,
    # keys, fptr, fres, stats, stream
    "mrhash_coarsen_select": [*[_vp] * 3, _i64, _i64, *[_vp] * 5, _i64,
                              _i64, _vp, _i64, _i64, _i64, *[_vp] * 6],
    # fptr, fres, n, sdf, sumsq, weight, rgbp, merge, half_voxel,
    # weight_max, staged sdf, sumsq, weight, rgbp, stream
    "mrhash_coarsen_merge": [_vp, _vp, _i64, *[_vp] * 4, _i, _f, _f,
                             *[_vp] * 5],
    # was_new, nptr, n, staged sdf, sumsq, weight, rgbp, sdf, sumsq,
    # weight, rgbp, stream
    "mrhash_coarsen_scatter": [_vp, _vp, _i64, *[_vp] * 9],
    "mrhash_raster_scan_aux_words": [],
    # pts, n, rows, cols, col_scale, min_d, max_d, img, aux, stream
    "mrhash_raster_scan": [_vp, _i64, _i, _i, _f, _vp, _vp, _vp, _vp, _vp],
    # bpos, bres, n_entries, rot, trans, min_d, max_d, mapping, vvs, rows,
    # cols, col_scale, pix, r_vox, stream
    "mrhash_project_window": [_vp, _vp, _i64, *[_vp] * 5, _f, _i, _i, _f,
                              _vp, _vp, _vp],
}


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mrhash_tpu_torch need the CUDA toolkit")
    return path


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmrhash_torch_{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernel library if no build of the current sources
    exists.  Raises with nvcc's stderr on failure.  Returns the path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all started together, then one link
        cu = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                for s, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stderr=subprocess.PIPE, text=True)
                 for c in jobs]
        for cmd, proc in zip(jobs, procs):
            _, err = proc.communicate()
            _check_nvcc(cmd, proc.returncode, err)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stderr)
        os.replace(lib, out)   # atomic: concurrent builders never see a
        #                        partial library
    return out


def _check_nvcc(cmd, rc, stderr):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{stderr}")


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mrhash_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mrhash_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str):
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        msg = library().mrhash_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_card(device) -> bool:
    """The port's one device policy: True for a CUDA device (the
    kernels), False for the CPU (their plain PyTorch twins); raises
    ValueError for any other device.  Every kernel entry asks it before
    it validates or reads its operands."""
    dev = torch.device(device)
    if dev.type in ("cuda", "cpu"):
        return dev.type == "cuda"
    raise ValueError(f"no kernel or twin for {dev}")


def stream_of(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def expect(t, name, dtype, shape, device):
    """Validate a kernel operand: device, dtype, shape (None = any extent)
    and contiguity.  Raises ValueError naming the operand."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
