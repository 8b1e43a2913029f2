"""The port's evaluation path and its table and numpy modules against the
JAX package's, on the same seeded numpy inputs.

- eval_utils: sample_mesh_points bit-equal at the same seed; nn_distances,
  evaluate_reconstruction's rows, crop_to_bbox and voxel_downsample equal;
  write_csv byte-equal; save_error_map's and save_mesh_error_map's PLYs
  equal (the same points, colours, faces);
- eval_reconstruction: read_mesh_ply on a mesh PLY the port wrote equal to
  the JAX package's reader, and `evaluate` on it (crop, downsample, error
  maps) giving the same rows and the same CSV;
- the label tables equal, and ade20k2kitti360 equal for every ADE20K id;
- the port's numpy MADtree equal to the JAX package's, and the host
  library's normals against it at tests/test_native_and_normals.py's
  tolerance;
- apps/quality_eval.py's depth images equal to the JAX side's on the 12
  poses of the small preset: the box room within 1e-6 of
  bench.synthetic_room_depth (the same noise draws), the cluttered room
  within 1e-6 of tools/quality_eval.clutter_scene_depth.
"""
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(seed=0, n_tri=300):
    """A bumpy open surface: vertices f64[V,3], faces i64[F,3]."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_tri / 2)) + 1
    u, v = np.meshgrid(np.linspace(0, 2, side), np.linspace(0, 1.5, side))
    z = 0.1 * np.sin(3 * u) + rng.normal(0, 0.005, u.shape)
    verts = np.stack([u, v, z], -1).reshape(-1, 3)
    i = np.arange(side - 1)
    a = (i[:, None] * side + i[None, :]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + side], 1),
                            np.stack([a + 1, a + side + 1, a + side], 1)])
    return verts, faces.astype(np.int64)


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    from mrhash_tpu.apps import eval_reconstruction as JR
    from mrhash_tpu.apps import eval_utils as JE
    return JE, JR


def test_sampling_distances_and_rows_match_reference(ref):
    JE, _ = ref
    from mrhash_tpu_torch.apps import eval_utils as E
    verts, faces = _mesh()
    got = E.sample_mesh_points(verts, faces, 20_000, seed=3)
    want = JE.sample_mesh_points(verts, faces, 20_000, seed=3)
    np.testing.assert_array_equal(got, want)
    assert E.sample_mesh_points(verts, faces[:0], 10).shape == (0, 3)
    rng = np.random.default_rng(1)
    gt = np.concatenate([want[::2] + rng.normal(0, 0.01, want[::2].shape),
                         rng.uniform(-1, 3, (500, 3))])
    np.testing.assert_array_equal(E.nn_distances(got, gt, chunk=7_000),
                                  JE.nn_distances(want, gt, chunk=7_000))
    assert np.isinf(E.nn_distances(got[:5], gt[:0])).all()
    assert E.evaluate_reconstruction(got, gt) == \
        JE.evaluate_reconstruction(want, gt)
    thr, trunc = [0.02, 0.3], [0.04, 0.6]
    assert E.evaluate_reconstruction(got, gt, thr, trunc) == \
        JE.evaluate_reconstruction(want, gt, thr, trunc)


def test_crop_downsample_and_csv_match_reference(ref, tmp_path):
    JE, _ = ref
    from mrhash_tpu_torch.apps import eval_utils as E
    pts = np.random.default_rng(2).uniform(-2, 2, (30_000, 3))
    lo, hi = np.array([-1.0, -0.5, 0.0]), np.array([1.5, 1.0, 2.0])
    np.testing.assert_array_equal(E.crop_to_bbox(pts, lo, hi),
                                  JE.crop_to_bbox(pts, lo, hi))
    for voxel in (0.0, 0.05, 0.3):
        np.testing.assert_array_equal(E.voxel_downsample(pts, voxel),
                                      JE.voxel_downsample(pts, voxel))
    rows = JE.evaluate_reconstruction(pts[:2000], pts[1000:3000])
    E.write_csv(rows, tmp_path / "port.csv")
    JE.write_csv(rows, tmp_path / "ref.csv")
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()


def test_error_maps_match_reference(ref, tmp_path):
    JE, _ = ref
    from mrhash_tpu.utils import plyio as JP

    from mrhash_tpu_torch.apps import eval_utils as E
    from mrhash_tpu_torch.utils import plyio
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (3000, 3))
    err = rng.uniform(0, 0.3, 3000)
    E.save_error_map(pts, err, str(tmp_path / "port.ply"))
    JE.save_error_map(pts, err, str(tmp_path / "ref.ply"))
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "ref.ply").read_bytes()
    got, gp = plyio.read_points_ply(str(tmp_path / "port.ply"))
    assert got.shape == (3000, 3) and gp["red"].min() == 255
    verts, faces = _mesh(5)
    E.save_mesh_error_map(verts, faces, pts, str(tmp_path / "pm.ply"))
    JE.save_mesh_error_map(verts, faces, pts, str(tmp_path / "rm.ply"))
    from mrhash_tpu_torch.apps.eval_reconstruction import read_mesh_ply
    pm, rm = str(tmp_path / "pm.ply"), str(tmp_path / "rm.ply")
    for a, b in zip(read_mesh_ply(pm), read_mesh_ply(rm)):
        np.testing.assert_array_equal(a, b)
    # the vertex colours, read as the vertex element of each file
    (gp, gc), (wp, wc) = JP.read_points_ply(pm), JP.read_points_ply(rm)
    np.testing.assert_array_equal(gp, wp)
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(gc[c], wc[c])
    assert gc["red"].min() == 255 and gc["green"].min() < 255


def test_read_mesh_and_evaluate_match_reference(ref, tmp_path):
    _, JR = ref
    from mrhash_tpu_torch.apps import eval_reconstruction as R
    from mrhash_tpu_torch.utils import plyio
    verts, faces = _mesh(6, 2000)
    colors = np.random.default_rng(6).integers(0, 255, verts.shape)
    mesh = str(tmp_path / "mesh.ply")
    plyio.write_mesh_ply(mesh, verts.astype(np.float32), faces, colors)
    got, want = R.read_mesh_ply(mesh), JR.read_mesh_ply(mesh)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == verts.shape and got[1].shape == faces.shape
    np.testing.assert_array_equal(got[1], faces)
    np.testing.assert_allclose(got[0], verts, atol=1e-5)
    gt = str(tmp_path / "gt.ply")
    plyio.write_points_ply(gt, (verts + [0.0, 0.0, 0.01])[::3])
    kw = dict(n_points=30_000, crop=True, downsample_voxel=0.02)
    rows = R.evaluate(mesh, gt, str(tmp_path / "port.csv"),
                      error_map=str(tmp_path / "port"), **kw)
    rows_ref = JR.evaluate(mesh, gt, str(tmp_path / "ref.csv"),
                           error_map=str(tmp_path / "ref"), **kw)
    assert rows == rows_ref
    assert 0.005 < rows[0]["chamfer_l1"] < 0.05, rows[0]
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    for suffix in ("_complete.ply", "_accuracy.ply"):
        assert (tmp_path / ("port" + suffix)).read_bytes() == \
            (tmp_path / ("ref" + suffix)).read_bytes()


def test_label_tables_match_reference():
    pytest.importorskip("jax")
    from mrhash_tpu.apps.utils import labels as JL
    from mrhash_tpu.apps.utils import semantic_segmentation as JS

    from mrhash_tpu_torch.apps.utils import labels as L
    from mrhash_tpu_torch.apps.utils import semantic_segmentation as S
    assert L.ADE20K_CLASSES == JL.ADE20K_CLASSES
    assert [tuple(x) for x in L.KITTI_360_LABELS] == \
        [tuple(x) for x in JL.KITTI_360_LABELS]
    assert S.kitti360_lookup == JS.kitti360_lookup
    for i in list(L.ADE20K_CLASSES) + [-1, 999]:
        assert S.ade20k2kitti360(i) == JS.ade20k2kitti360(i), i
    np.testing.assert_array_equal(S.instance_colors, JS.instance_colors)
    assert S.class_color_mapping() == JS.class_color_mapping()
    assert S.class_color_mapping_kitti360() == \
        JS.class_color_mapping_kitti360()
    assert S.kitti360_lookup["car"] == 26
    assert S.ade20k2kitti360(999) == 255


def test_madtree_matches_reference_and_native():
    pytest.importorskip("jax")
    from mrhash_tpu.ops.normals import estimate_normals as j_estimate

    from mrhash_tpu_torch import native
    from mrhash_tpu_torch.ops.normals import estimate_normals
    rng = np.random.default_rng(3)
    wall = np.stack([rng.uniform(3, 3.02, 2000), rng.uniform(-2, 2, 2000),
                     rng.uniform(-1, 1, 2000)], 1)
    ground = np.stack([rng.uniform(-5, 5, 1500), rng.uniform(-5, 5, 1500),
                       rng.normal(-1.5, 0.01, 1500)], 1)
    for pts in (wall, np.concatenate([wall, ground]), wall[:2]):
        for a, b in zip(estimate_normals(pts), j_estimate(pts)):
            np.testing.assert_array_equal(a, b)
    # the host library against the numpy MADtree, at the tolerance of
    # tests/test_native_and_normals.py::test_madtree_native_agrees_with_numpy
    n1, w1 = native.estimate_normals(wall)
    n2, _, w2 = estimate_normals(wall)
    assert abs(np.mean(n1[:, 0]) - np.mean(n2[:, 0])) < 0.1
    assert abs(np.mean(w1) - np.mean(w2)) < 0.15
    assert np.mean(n2[:, 0]) < -0.95


def test_scene_depth_matches_reference(monkeypatch):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import quality_eval as JQ
    from bench import synthetic_room_depth as j_room
    from mrhash_tpu.ops import camera as JC

    from mrhash_tpu_torch.apps import quality_eval as Q
    from mrhash_tpu_torch.ops import camera as C
    rows, cols, fx = Q.PRESETS["small"][:3]
    args = (fx, fx, cols / 2 - 0.5, rows / 2 - 0.5, rows, cols, 0.01, 30.0)
    cam0, jcam0 = C.make_camera(*args), JC.make_camera(*args)
    r_port, r_ref = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(12):
        rot, t = Q.orbit_pose(i, 12)
        cam = C.with_pose(cam0, rot, t)
        jcam = JC.with_pose(jcam0, jnp.asarray(rot), jnp.asarray(t))
        got = Q.synthetic_room_depth(rows, cols, cam, r_port)
        want = np.asarray(j_room(rows, cols, jcam, r_ref))
        assert got.dtype == np.float32 and got.shape == (rows, cols)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        got = Q.clutter_scene_depth(rows, cols, cam)
        want = JQ.clutter_scene_depth(rows, cols, jcam)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got < want.max() + 1).all() and got.min() > 0.5
