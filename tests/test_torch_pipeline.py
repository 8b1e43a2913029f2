"""The port's frame step and entry points against the JAX reference.

- 4 frames of `integrate_rgbd` in both packages with
  n_frames_invalidate_voxels=2, so starvation and GC fire on frame 2.  The
  reference runs in gather mode and un-jitted: jit lets XLA contract
  `voxel * vvs - t` into an FMA, which moves voxels on a pixel boundary
  (PORT_NOTES.md P4); op by op it computes the same f32 operations as the
  port.  The poses translate and turn by exact quarter turns, whose
  rotation entries are exact, so both packages project bit-identically.
  Per block key: same key set, weight and rgbp exact, sdf within 2e-5,
  sumsq within 5e-4; stats occupied_blocks and high_free equal.
- State carry: 2 reference frames, `core.convert` into the port, frame 3 in
  both, same comparison.
- The port's rgbd_runner end to end on test_geowrapper.py's synthetic wall
  (device="cpu"), with that test's assertions.
"""
import os

import numpy as np
import pytest
import torch

from mrhash_tpu import params as P
from mrhash_tpu_torch.core import convert, pipeline
from mrhash_tpu_torch.core.state import MapConfig, make_state
from mrhash_tpu_torch.ops import camera as C

torch.set_num_threads(1)

ROWS, COLS = 64, 256
N_FRAMES = 4
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)
QUARTER = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)


def _cfg_kw(alloc_tile):
    return dict(virtual_voxel_size=0.02, sdf_truncation=0.06,
                max_integration_distance=5.0, n_frames_invalidate_voxels=2,
                num_blocks=1 << 11, max_active_blocks=1 << 10,
                max_alloc_per_frame=1 << 10, alloc_tile=alloc_tile)


def _frames():
    rng = np.random.default_rng(0)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    frames = []
    for i in range(N_FRAMES):
        d = (base + rng.normal(0, 0.01, base.shape)).astype(np.float32)
        rot = np.linalg.matrix_power(QUARTER, i // 2)
        trans = np.array([0.03 * i, 0.01 * i, 0.0], np.float32)
        frames.append((d, rot.astype(np.float32), trans))
    return frames, rgb


def _port_step(cfg, state, frame, rgb):
    d, rot, trans = frame
    cam = C.with_pose(C.make_camera(*CAM), rot, trans)
    return pipeline.integrate_rgbd(cfg, state, cam, torch.from_numpy(d),
                                   torch.from_numpy(rgb))


@pytest.fixture(scope="module", params=[0, 4], ids=["pixel", "tile"])
def reference(request):
    """Reference states + stats after each frame (un-jitted gather mode)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core import pipeline as JP
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.ops import camera as JC

    kw = _cfg_kw(request.param)
    jcfg = JMapConfig(sample_mode="gather", **kw)
    frames, rgb = _frames()
    state = jmake_state(jcfg.num_blocks)
    states, stats = [], []
    with jax.disable_jit():
        for d, rot, trans in frames:
            cam = JC.with_pose(JC.make_camera(*CAM), jnp.asarray(rot),
                               jnp.asarray(trans))
            state, st = JP.integrate_rgbd(jcfg, state, cam, jnp.asarray(d),
                                          jnp.asarray(rgb))
            states.append(jax.device_get(state))
            stats.append({k: int(v) for k, v in st.items()})
    return MapConfig(**kw), frames, rgb, states, stats


def _by_key(table_pos, table_ptr):
    occ = table_ptr != P.FREE_ENTRY
    return {tuple(int(v) for v in k): int(p) // 512
            for k, p in zip(table_pos[occ], table_ptr[occ])}


def _assert_maps_match(port_state, ref_state):
    got = _by_key(port_state.table.pos.numpy(), port_state.table.ptr.numpy())
    ref = _by_key(np.asarray(ref_state.table.pos),
                  np.asarray(ref_state.table.ptr))
    assert set(got) == set(ref)
    keys = sorted(ref)
    gr = np.asarray([got[k] for k in keys])
    rr = np.asarray([ref[k] for k in keys])
    g = {f: getattr(port_state.pool, f).numpy()[gr] for f in
         ("sdf", "sumsq", "weight", "rgbp")}
    r = {f: np.asarray(getattr(ref_state.pool, f))[rr] for f in g}
    np.testing.assert_array_equal(g["weight"], r["weight"])
    upd = r["weight"] > 0
    assert int(upd.sum()) > 10000, "scene integrated nothing"
    np.testing.assert_array_equal(g["rgbp"][upd], r["rgbp"][upd])
    np.testing.assert_allclose(g["sdf"][upd], r["sdf"][upd], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(g["sumsq"][upd], r["sumsq"][upd], atol=5e-4,
                               rtol=0)


def test_frames_match_reference(reference):
    cfg, frames, rgb, ref_states, ref_stats = reference
    state = make_state(cfg.num_blocks)
    for i, frame in enumerate(frames):
        state, stats = _port_step(cfg, state, frame, rgb)
        for k in ("occupied_blocks", "occupied_total", "high_free", "frame"):
            assert stats[k] == ref_stats[i][k], (i, k)
        assert stats["unserved_blocks"] == 0
    _assert_maps_match(state, ref_states[-1])
    # GC freed blocks already on frame 0, where every block is in view
    assert ref_stats[0]["occupied_total"] < ref_stats[0]["occupied_blocks"]


def test_state_carry_from_reference(reference):
    cfg, frames, rgb, ref_states, ref_stats = reference
    state = convert.from_reference(ref_states[1])
    state, stats = _port_step(cfg, state, frames[2], rgb)
    assert stats["occupied_blocks"] == ref_stats[2]["occupied_blocks"]
    assert stats["high_free"] == ref_stats[2]["high_free"]
    _assert_maps_match(state, ref_states[2])
    back = convert.to_reference_arrays(state)
    np.testing.assert_array_equal(back["table"]["ptr"],
                                  np.asarray(ref_states[2].table.ptr))
    np.testing.assert_array_equal(back["table"]["heap_high"],
                                  np.asarray(ref_states[2].table.heap_high))
    assert back["frame"] == int(ref_states[2].frame)


# ---------------------------------------------------------------------------
# entry point: the rgbd runner on a synthetic dataset
# ---------------------------------------------------------------------------

WROWS, WCOLS, WALL_Z = 60, 80, 2.0


@pytest.fixture
def runner_config(tmp_path):
    from PIL import Image
    data = tmp_path / "replica_like"
    (data / "results").mkdir(parents=True)
    poses = []
    for i in range(4):
        depth = np.full((WROWS, WCOLS), WALL_Z, np.float32)
        Image.fromarray((depth * 6553.5).astype(np.uint16)).save(
            data / "results" / f"depth{i:06d}.png")
        rgb = np.full((WROWS, WCOLS, 3), 90, np.uint8)
        rgb[:, : WCOLS // 2, 0] = 200
        Image.fromarray(rgb).save(data / "results" / f"frame{i:06d}.jpg")
        pose = np.eye(4)
        pose[0, 3] = 0.02 * i
        poses.append(pose.reshape(-1))
    np.savetxt(data / "traj.txt", np.asarray(poses), delimiter=" ")
    out = tmp_path / "results"
    cfg = f"""
map:
    sdf_truncation            : 0.15
    sdf_truncation_scale      : 0.0
    integration_weight_sample : 1
    n_frames_invalidate_voxels: 0
    virtual_voxel_size        : 0.05
streamer:
    voxel_extents_scale       : 1
mesh:
    marching_cubes_threshold: 1.5
    min_weight_threshold : 1
    sdf_var_threshold : 0.0
    vertices_merging_threshold : 0.0
sensor:
    min_depth : 0.01
    max_depth : 5
    intrinsics: [50.0, 50.0, {WCOLS / 2 - 0.5}, {WROWS / 2 - 0.5}]
    resolution: [{WCOLS}, {WROWS}]
    depth_scaling: 6553.5
    hz: 30
data_path: {data}
results_path: {out}
end_frame: -1
"""
    path = tmp_path / "test.cfg"
    path.write_text(cfg)
    return path, out


@pytest.fixture
def native_lib():
    """The host mesh library, which the port's extractMesh requires.
    mrhash_tpu.native builds it at first use without a lock, so a first
    build racing in another test worker can fail this worker's load once
    (and native caches the failure); wait and load again."""
    import time

    from mrhash_tpu import native
    for _ in range(6):
        if native.load() is not None:
            return native
        native._tried = False
        time.sleep(10)
    pytest.fail("mrhash_tpu.native did not load")


def test_rgbd_runner_end_to_end(runner_config, tmp_path, monkeypatch,
                                native_lib):
    from mrhash_tpu.apps import eval_utils
    from mrhash_tpu.apps.eval_reconstruction import read_mesh_ply
    from mrhash_tpu_torch.apps.rgbd_runner import main

    monkeypatch.chdir(tmp_path)     # the profiler writes to the cwd
    path, out = runner_config
    gw = main(str(path), num_blocks=8192, max_active_blocks=8192,
              max_alloc_per_frame=2048, profiling=True, device="cpu")

    meshes = list(out.glob("mesh_*.ply"))
    assert len(meshes) == 1
    verts, faces = read_mesh_ply(meshes[0])
    assert verts.shape[0] > 100 and faces.shape[0] > 100

    est = eval_utils.sample_mesh_points(verts, faces, 20000)
    xs = np.linspace(verts[:, 0].min(), verts[:, 0].max(), 120)
    ys = np.linspace(verts[:, 1].min(), verts[:, 1].max(), 120)
    gx, gy = np.meshgrid(xs, ys)
    gt = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, WALL_Z)], 1)
    r = eval_utils.evaluate_reconstruction(est, gt)[1]
    assert r["accuracy_mae"] < 0.05
    assert r["fscore"] > 0.9

    assert os.path.exists("integration_profiler.txt")
    with open("integration_profiler.txt") as f:
        assert len(f.readline().split()) == 4
    assert list(out.glob("hash_points_*.ply"))
    assert list(out.glob("voxel_points_*.ply"))
    assert gw.getColors().shape[0] == gw.getVertices().shape[0]


def test_geowrapper_refuses_what_is_not_ported():
    from mrhash_tpu_torch.geowrapper import GeoWrapper
    kw = dict(sdf_truncation=0.1, sdf_truncation_scale=0.0,
              integration_weight_sample=1, virtual_voxel_size=0.05,
              n_frames_invalidate_voxels=0, voxel_extents_scale=1,
              num_blocks=16, device="cpu")
    # the point-centric LiDAR update is ported now: the option is taken
    # (tests/test_torch_lidar_points.py runs it); an unknown camera model
    # is refused
    gw = GeoWrapper(projective_sdf=False, **kw)
    gw.setCamera(16.0, 8.0, 64.0, 8.0, 16, 128, 0.2, 40.0, C.SPHERICAL)
    assert gw.cfg.projective_sdf is False
    with pytest.raises(ValueError, match="camera model"):
        gw.setCamera(16.0, 8.0, 64.0, 8.0, 16, 128, 0.2, 40.0, 2)
    gw = GeoWrapper(**kw)
    gw.setCamera(50.0, 50.0, 39.5, 29.5, WROWS, WCOLS, 0.01, 5.0)
    gw.setCurrPose([0, 0, 0], [0, 0, 0, 1])
    gw.setDepthImage(np.full((WROWS, WCOLS), 1.0, np.float32))
    gw.setRGBImage(np.zeros((WROWS, WCOLS, 3), np.uint8))
    # a 16-block pool fills up on the first frame: the stream-out watermark
    # is reached, and the next compute() streams before it integrates
    gw.compute()
    assert gw._high_free <= P.STREAM_THRESHOLD * 16
    assert gw.streamer.out_events == []
    gw.compute()
    assert len(gw.streamer.out_events) == 1
    assert gw.last_stats["frame"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GeoWrapper(**dict(kw, device="cuda"))
