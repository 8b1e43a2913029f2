"""mrhash_tpu_torch: the PyTorch + CUDA port of mrhash_tpu.

The single-resolution RGB-D path (allocation, fused integrate, starvation,
garbage collection), the single-resolution projective LiDAR path
(per-point allocation, the scan's range image, fused integrate) and online
3D Gaussian Splatting after each RGB-D frame (`gs/`), then host mesh
extraction, run on an NVIDIA card through five hand-written CUDA kernels
(`ops/fused_integrate.py`, `ops/sample_image.py`,
`ops/fused_integrate_points.py`, and the tile blend's forward and backward
in `gs/blend.py`).  The JAX package `mrhash_tpu` stays the
reference; this package imports neither jax nor anything of `mrhash_tpu`.
Deviations from the reference are listed in PORT_NOTES.md.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like mrhash_tpu: importing the package pulls in no torch module
    if name == "GeoWrapper":
        from mrhash_tpu_torch.geowrapper import GeoWrapper
        return GeoWrapper
    raise AttributeError(name)
