"""mrhash_tpu_torch: the PyTorch + CUDA port of mrhash_tpu.

The single-resolution RGB-D path (allocation, fused integrate, starvation,
garbage collection, host mesh extraction) runs on an NVIDIA card through
two hand-written CUDA kernels (`ops/fused_integrate.py`,
`ops/sample_image.py`).  The JAX package `mrhash_tpu` stays the reference;
this package never imports jax.  Deviations from the reference are listed in
PORT_NOTES.md.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like mrhash_tpu: importing the package pulls in no torch module
    if name == "GeoWrapper":
        from mrhash_tpu_torch.geowrapper import GeoWrapper
        return GeoWrapper
    raise AttributeError(name)
