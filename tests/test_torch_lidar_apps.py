"""The port's LiDAR entry point and its readers against the JAX package's,
on fixtures the tests write themselves (no dataset is in the repo):

- point_cloud2.read_points on a PointCloud2-shaped message built with
  numpy (NaN rows, a field with count > 1, padding in the point step);
- parse_trajectory's TUM, KITTI and KITTI-360 readers and nearest_pose on
  files in tmp_path;
- parse_calib_file on a VBR calibration YAML and a KITTI-style txt (the
  counterpart of tests/test_calib.py), and the extrinsic through the
  port's GeoWrapper.setCameraInLidar;
- rosbag_runner imports without the `rosbags` package and raises a clear
  ImportError when a bag is opened;
- GeoWrapper.getPointCloud / getNormals equal to the reference's on one
  cloud (the port keeps the cloud unpadded, PORT_NOTES.md P16).
"""
import os
import sys
import types

import numpy as np
import pytest

from mrhash_tpu_torch.apps.utils import parse_calib_file as PC
from mrhash_tpu_torch.apps.utils import parse_trajectory as PT
from mrhash_tpu_torch.apps.utils import point_cloud2 as PC2

CALIB_YAML = """
cam_r:
  T_b:
    - [0.0, 0.0, 1.0, 0.1]
    - [-1.0, 0.0, 0.0, 0.02]
    - [0.0, -1.0, 0.0, -0.05]
    - [0.0, 0.0, 0.0, 1.0]
sensor:
  intrinsics: [610.5, 611.2, 640.0, 360.0]
  resolution: [1280, 720]
"""

CALIB_TXT = """S_rect_00 1.408000e+03 3.760000e+02
D_00 -3.7e-01 1.7e-01 3.0e-04 2.0e-04 -6.7e-02
P_rect_00 7.188560e+02 0.000000e+00 6.071928e+02 0.000000e+00 0.000000e+00 7.188560e+02 1.852157e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00
"""


def _cloud_msg(rng, n=200):
    """A PointCloud2-shaped message: x, y, z f32, intensity f32, ring u2,
    a 3-count f4 field `n` and 2 bytes of padding per 32-byte point; rows
    5 and 17 have a NaN coordinate, row 40 a NaN normal."""
    field = types.SimpleNamespace
    fields = [field(name="x", offset=0, datatype=7, count=1),
              field(name="y", offset=4, datatype=7, count=1),
              field(name="z", offset=8, datatype=7, count=1),
              field(name="intensity", offset=12, datatype=7, count=1),
              field(name="ring", offset=16, datatype=4, count=1),
              field(name="n", offset=18, datatype=7, count=3)]
    step = 32
    buf = np.zeros((n, step), np.uint8)
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    xyz[5, 1] = np.nan
    xyz[17, 2] = np.nan
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    nrm[40, 0] = np.nan
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf[:, 12:16] = rng.random((n, 1)).astype(np.float32).view(
        np.uint8).reshape(n, 4)
    buf[:, 16:18] = (np.arange(n) % 64).astype(np.uint16).view(
        np.uint8).reshape(n, 2)
    buf[:, 18:30] = nrm.view(np.uint8).reshape(n, 12)
    return types.SimpleNamespace(fields=fields, point_step=step, width=n // 4,
                                 height=4, data=buf.tobytes()), xyz


def test_read_points_matches_reference():
    from mrhash_tpu.apps.utils import point_cloud2 as JPC2
    msg, xyz = _cloud_msg(np.random.default_rng(0))
    for kw in (dict(), dict(field_names=("x", "y", "z")),
               dict(skip_nans=False)):
        got, want = PC2.read_points(msg, **kw), JPC2.read_points(msg, **kw)
        assert got.dtype == want.dtype
        for name in got.dtype.names:     # NaNs compare equal per field
            np.testing.assert_array_equal(got[name], want[name])
    pts = PC2.read_points(msg, field_names=("x", "y", "z"))
    assert pts.shape[0] == xyz.shape[0] - 2          # the NaN rows dropped
    assert PC2.read_points(msg).shape[0] == xyz.shape[0] - 3
    assert "n_2" in PC2.read_points(msg).dtype.names


def _write_trajectory(path, kind, rng, n=12):
    """A trajectory file of `kind` with n poses; returns their times."""
    t = np.cumsum(rng.uniform(0.05, 0.15, n)) + 1.6e9
    if kind == "tum":
        q = rng.normal(size=(n, 4))
        rows = np.concatenate([t[:, None], rng.normal(0, 5, (n, 3)), q], 1)
        np.savetxt(path, rows, header="t x y z qx qy qz qw")
        return t
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :] += rng.normal(0, 0.1, (n, 3, 4))
    if kind == "kitti":
        np.savetxt(path, m[:, :3, :].reshape(n, 12))
        return np.arange(n, dtype=np.float64)
    idx = np.arange(n) * 3 + 1
    np.savetxt(path, np.concatenate([idx[:, None], m.reshape(n, 16)], 1))
    return idx.astype(np.float64)


@pytest.mark.parametrize("kind", ["tum", "kitti", "kitti360"])
def test_trajectory_readers_match_reference(tmp_path, kind):
    from mrhash_tpu.apps.utils import parse_trajectory as JPT
    path = tmp_path / f"{kind}.txt"
    times = _write_trajectory(path, kind, np.random.default_rng(1))
    name = dict(tum="parse_tum_trajectory", kitti="parse_kitti_trajectory",
                kitti360="parse_kitti360_trajectory")[kind]
    got, want = getattr(PT, name)(str(path)), getattr(JPT, name)(str(path))
    assert len(got) == len(want) == len(times)
    for (tg, mg), (tw, mw) in zip(got, want):
        assert tg == tw
        np.testing.assert_array_equal(mg, mw)
    for q in (times[0] - 1.0, times[3] + 0.01, times[-1] + 5.0,
              0.5 * (times[6] + times[7])):
        np.testing.assert_array_equal(PT.nearest_pose(got, q),
                                      JPT.nearest_pose(want, q))


@pytest.fixture
def calib_files(tmp_path):
    y, t = tmp_path / "calib.yaml", tmp_path / "calib.txt"
    y.write_text(CALIB_YAML)
    t.write_text(CALIB_TXT)
    return str(y), str(t)


def test_calib_yaml_matches_reference(calib_files):
    """tests/test_calib.py's YAML cases through the port's copy, equal to
    the reference's parser, and the extrinsic through the port's
    GeoWrapper.setCameraInLidar."""
    pytest.importorskip("yaml")
    from mrhash_tpu.apps.utils import parse_calib_file as JPC

    from mrhash_tpu_torch.geowrapper import GeoWrapper
    path, _ = calib_files
    for got, want in zip(PC.read_extrinsics(path),
                         JPC.read_extrinsics(path)):
        np.testing.assert_array_equal(got, want)
    lTc = PC.read_lidar_T_camera(path)
    np.testing.assert_array_equal(lTc, JPC.read_lidar_T_camera(path))
    np.testing.assert_array_equal(PC.read_intrinsics(path),
                                  JPC.read_intrinsics(path))
    assert PC.read_img_size(path) == JPC.read_img_size(path) == (720, 1280)
    gw = GeoWrapper(0.1, 0.0, 1, 0.05, 0, 1, num_blocks=512,
                    max_active_blocks=256, max_alloc_per_frame=128,
                    profiling=False, device="cpu")
    gw.setCameraInLidar(lTc)
    np.testing.assert_array_equal(gw.camera_in_lidar, lTc)


def test_calib_txt_and_rodrigues_match_reference(calib_files):
    from mrhash_tpu.apps.utils import parse_calib_file as JPC
    _, path = calib_files
    K, dist = PC.read_intrinsics_txt(path)
    JK, jdist = JPC.read_intrinsics_txt(path)
    np.testing.assert_array_equal(K, JK)
    assert dist == jdist and len(dist) == 5
    assert PC.read_img_size_txt(path) == JPC.read_img_size_txt(path) == (
        1408, 376)
    rng = np.random.default_rng(3)
    mats = [np.eye(3), np.diag([-1.0, -1.0, 1.0])]
    for _ in range(5):
        v = rng.normal(size=3)
        a = v / np.linalg.norm(v)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(v)
        mats.append(np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k)
    for R in mats:
        np.testing.assert_array_equal(PC.rodrigues_from_matrix(R),
                                      JPC.rodrigues_from_matrix(R))


def test_rosbag_runner_without_rosbags(monkeypatch, tmp_path):
    """The runner imports without `rosbags` and says what is missing when a
    bag is opened."""
    monkeypatch.setitem(sys.modules, "rosbags", None)
    monkeypatch.setitem(sys.modules, "rosbags.highlevel", None)
    from mrhash_tpu_torch.apps import rosbag_runner
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configurations", "vbr.cfg")) as f:
        cfg = tmp_path / "vbr.cfg"
        cfg.write_text(f.read())
    with pytest.raises(ImportError, match="requires the 'rosbags' package"):
        rosbag_runner.main(str(cfg))
    with pytest.raises(ImportError, match="rosbags"):
        rosbag_runner.Ros1Reader("bag", "/ouster/points", "gt.txt")


def test_get_point_cloud_and_normals_match_reference(tmp_path, monkeypatch):
    from mrhash_tpu.geowrapper import GeoWrapper as JGeoWrapper

    from mrhash_tpu_torch.geowrapper import GeoWrapper
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 5, (777, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (777, 3)).astype(np.float32)
    kw = dict(sdf_truncation=0.4, sdf_truncation_scale=0.0,
              integration_weight_sample=1, virtual_voxel_size=0.2,
              n_frames_invalidate_voxels=0, voxel_extents_scale=1,
              gs_optimization_param_path="", num_blocks=512,
              max_active_blocks=256, max_alloc_per_frame=128,
              profiling=False)
    monkeypatch.chdir(tmp_path)     # the reference writes reports here
    port, ref = GeoWrapper(device="cpu", **kw), JGeoWrapper(**kw)
    assert port.getPointCloud() is None and port.getNormals() is None
    for arg2 in (nrm, False):
        for gw in (port, ref):
            gw.setPointCloud(pts, arg2)
        np.testing.assert_array_equal(port.getPointCloud(),
                                      ref.getPointCloud())
        np.testing.assert_array_equal(port.getNormals(), ref.getNormals())
        assert port.getPointCloud().shape == (777, 3)
