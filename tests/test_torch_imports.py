"""The port imports nothing of the JAX package, and its host library
builds without writing into the repo's `native/` directory.

- In a fresh interpreter, importing mrhash_tpu_torch, its GeoWrapper, its
  native loader, the RGB-D and LiDAR runners (rosbag_runner and its
  readers point_cloud2, parse_trajectory, parse_calib_file too), the
  mesh sweep's modules (meshing, transvoxel, raycast) and the evaluation
  path (eval_utils, eval_reconstruction, quality_eval, the label tables,
  the numpy MADtree) and the sharded map's modules (parallel.sharding,
  parallel.launch; no process group is started) leaves no `jax` and no
  `mrhash_tpu` module in sys.modules, nor tools/quality_eval.py or
  bench.py, and neither
  `rosbags` nor `yaml`, which the VBR runner imports only when it opens a
  bag or a calibration file, nor `scipy`, which eval_utils imports when
  nn_distances first runs (it is loaded after that call); so does
  importing every module of its Gaussian Splatting package and the GS
  runner.
- With tqdm missing (the card's machine has none), all six runners
  import and rgbd_runner's frame loop runs: two in-memory frames through a
  CPU GeoWrapper, with the plain progress lines in place of the bar.
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
import mrhash_tpu_torch.apps.rosbag_runner
import mrhash_tpu_torch.apps.utils.parse_calib_file
import mrhash_tpu_torch.apps.utils.parse_trajectory
import mrhash_tpu_torch.apps.utils.point_cloud2
import mrhash_tpu_torch.ops.meshing
import mrhash_tpu_torch.ops.raycast
import mrhash_tpu_torch.ops.transvoxel
import mrhash_tpu_torch.ops.normals
import mrhash_tpu_torch.apps.eval_utils
import mrhash_tpu_torch.apps.eval_reconstruction
import mrhash_tpu_torch.apps.quality_eval
import mrhash_tpu_torch.apps.utils.labels
import mrhash_tpu_torch.apps.utils.semantic_segmentation
import mrhash_tpu_torch.parallel.launch
import mrhash_tpu_torch.parallel.sharding
import torch.distributed
assert not torch.distributed.is_initialized(), "an import started a group"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mrhash_tpu", "rosbags",
                                    "yaml", "scipy", "bench", "quality_eval"))
import numpy as np
from mrhash_tpu_torch.apps import eval_utils
eval_utils.nn_distances(np.zeros((2, 3)), np.ones((3, 3)))
print(repr(bad), "scipy" in sys.modules)
"""


def test_port_imports_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True", out.stdout


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


_CHECK_NO_TQDM = """
import sys
sys.modules["tqdm"] = None          # import tqdm now raises ImportError
import numpy as np
import mrhash_tpu_torch.apps.kitti_runner
import mrhash_tpu_torch.apps.ply_runner
import mrhash_tpu_torch.apps.rgbd_gs_runner
import mrhash_tpu_torch.apps.streamer_example
import mrhash_tpu_torch.apps.rosbag_runner
from mrhash_tpu_torch.apps.rgbd_runner import integrate_frames
from mrhash_tpu_torch.geowrapper import GeoWrapper

gw = GeoWrapper(sdf_truncation=0.06, sdf_truncation_scale=0.0,
                integration_weight_sample=1, virtual_voxel_size=0.02,
                n_frames_invalidate_voxels=0, voxel_extents_scale=1,
                gs_optimization_param_path="", num_blocks=1 << 10,
                max_active_blocks=1 << 10, max_alloc_per_frame=1 << 10,
                max_depth=5.0, profiling=False, device="cpu")
gw.setCamera(40.0, 40.0, 31.5, 15.5, 32, 64, 0.01, 5.0)
rng = np.random.default_rng(0)
depth = np.full((32, 64), 1.5, np.float32)
rgb = rng.integers(0, 255, (32, 64, 3)).astype(np.uint8)
frames = [(i, [0.01 * i, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0], depth, rgb)
          for i in range(2)]
integrate_frames(gw, frames, end_frame=5)
print("tqdm" in sys.modules and sys.modules["tqdm"] is None,
      gw.state.frame, int((gw.state.pool.weight > 0).sum()) > 0)
"""


def test_runners_import_and_loop_without_tqdm():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK_NO_TQDM], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "processing... done, 2 frames", out.stdout
    assert lines[-1] == "True 2 True", out.stdout


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
