"""The port imports nothing of the JAX package, and its host library
builds without writing into the repo's `native/` directory.

- In a fresh interpreter, importing mrhash_tpu_torch, its GeoWrapper, its
  native loader and all three runners leaves no `jax` and no `mrhash_tpu`
  module in sys.modules; so does importing every module of its Gaussian
  Splatting package and the GS runner.
- Building the port's host library puts it under the build directory it
  is given and leaves the committed Transvoxel header byte for byte as it
  was (the JAX package regenerates that header next to its own build).
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import mrhash_tpu_torch
import mrhash_tpu_torch.geowrapper
import mrhash_tpu_torch.native
import mrhash_tpu_torch.apps.rgbd_runner
import mrhash_tpu_torch.apps.ply_runner
import mrhash_tpu_torch.apps.kitti_runner
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mrhash_tpu"))
print(repr(bad))
"""


def test_port_imports_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_CHECK_GS = """
import sys
import mrhash_tpu_torch.gs
import mrhash_tpu_torch.gs.blend
import mrhash_tpu_torch.gs.container
import mrhash_tpu_torch.gs.losses
import mrhash_tpu_torch.gs.model
import mrhash_tpu_torch.gs.quadtree
import mrhash_tpu_torch.gs.rasterizer
import mrhash_tpu_torch.ops.meshing
import mrhash_tpu_torch.apps.rgbd_gs_runner
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mrhash_tpu"))
print(repr(bad))
"""


def test_gs_imports_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK_GS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_native_build_leaves_native_dir_alone(tmp_path, monkeypatch):
    from mrhash_tpu_torch import native
    header = os.path.join(native.NATIVE_DIR, "transvoxel_tables.h")
    with open(header, "rb") as f:
        before = f.read()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    lib = native.build()
    assert os.path.dirname(lib) == str(tmp_path) and os.path.exists(lib)
    assert not any(n.startswith("libmrhash_host_")
                   for n in os.listdir(native.NATIVE_DIR))
    with open(header, "rb") as f:
        assert f.read() == before
