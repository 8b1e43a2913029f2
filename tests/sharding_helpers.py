"""Shared cases of the tests/test_torch_sharding_*.py files: the JAX
package's sharded steps over a CPU mesh of the conftest's virtual devices,
the port's over n spawned ranks (gloo, CPU), and the comparisons by block
key.  jax is imported inside the functions only."""
import numpy as np

from mrhash_tpu_torch import params as P
from mrhash_tpu_torch.parallel import launch
from mrhash_tpu_torch.parallel import sharding as S

ROWS, COLS = 32, 64                     # tests/test_multichip.py's wall
CAM = (40.0, 40.0, COLS / 2 - 0.5, ROWS / 2 - 0.5, ROWS, COLS, 0.01, 5.0, 0)
TIMEOUT_S = 300
EYE = np.eye(3, dtype=np.float32)
ZERO = np.zeros(3, np.float32)
# tests/test_multichip.py::make_cfg
CFG = dict(virtual_voxel_size=0.05, sdf_truncation=0.15,
           max_integration_distance=5.0, num_blocks=8192,
           max_active_blocks=8192, max_alloc_per_frame=4096,
           n_frames_invalidate_voxels=50)


def lidar_cam(n_az):
    """tests/test_multichip.py's spherical camera with n_az columns."""
    return (n_az / (2 * np.pi), ROWS / (np.pi / 3), n_az / 2, ROWS / 2, ROWS,
            n_az, 0.2, 50.0, 1)


def ring(n=512):
    """tests/test_multichip.py's 512-point ring at 10 m, with its radial
    normals (unit, pointing away from the sensor)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                    0.3 * np.sin(3 * ang)], 1).astype(np.float32)
    nrm = np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1).astype(np.float32)
    return pts, nrm


def scan(rng, rows=16, cols=128):
    """tests/test_torch_lidar.py's scan from the origin: a ground plane at
    z = -1.5 m and a 12 m cylinder wall, beams half a column off the column
    edges, 1 cm range noise, ranges snapped to 1/2048 m (so the reference
    kernel's range quantisation is the identity, PORT_NOTES.md P13).
    Returns f32[rows*cols, 3] and that sensor's camera tuple."""
    el = np.linspace(-0.35, 0.25, rows)[:, None]
    az = (np.linspace(-np.pi, np.pi, cols, endpoint=False)
          + np.pi / cols)[None, :]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az) + 0 * el,
                  np.sin(el) + 0 * az], axis=-1)
    tz = np.where(d[..., 2] < -1e-4, -1.5 / d[..., 2], np.inf)
    tc = 12.0 / np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    t = np.minimum(tz, tc)
    t = np.round((t + rng.normal(0, 0.01, t.shape)) * 2048) / 2048
    cam = (cols / (2 * np.pi), rows / 0.65, cols / 2.0, rows / 2.0, rows,
           cols, 0.2, 40.0, 1)
    return (d * t[..., None]).reshape(-1, 3).astype(np.float32), cam


def run_reference(cfg_kw, kind, n, frames, camera=CAM, ref_state=None,
                  **jax_kw):
    """The JAX package's sharded step over a mesh of the first n CPU
    devices: `frames` as sharding.run_frames takes them.  Returns (the
    sharded state fetched to host arrays, [stats per frame as ints], the
    step's mesh, the reference's config and the sharded state itself)."""
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapConfig
    from mrhash_tpu.ops import camera as C
    from mrhash_tpu.parallel import sharding as JS

    cfg = MapConfig(**cfg_kw, **jax_kw)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), (JS.AXIS,))
    step = (JS.sharded_integrate_rgbd if kind == "rgbd"
            else JS.sharded_integrate_points)(cfg, mesh)
    state = JS.make_sharded_state(cfg, mesh) if ref_state is None \
        else ref_state
    cam0 = C.make_camera(*camera[:8], model=camera[8])
    stats = []
    for rot, trans, a, b in frames:
        cam = C.with_pose(cam0, jnp.asarray(rot), jnp.asarray(trans))
        if kind == "rgbd":
            state, st = step(state, cam, jnp.asarray(a), jnp.asarray(b))
        else:
            m = a.shape[0]
            nrm = np.zeros_like(a) if b is None else b
            state, st = step(state, cam, jnp.asarray(a), jnp.asarray(nrm),
                             jnp.ones((m,), jnp.float32),
                             jnp.ones((m,), bool))
        stats.append({k: int(v) for k, v in st.items()})
    return jax.device_get(state), stats, mesh, cfg, state


def run_port(cfg, kind, n, frames, camera=CAM, states=None, mesh=None):
    """The port's sharded step on n ranks (gloo, CPU); run_frames's
    results in rank order."""
    return launch.run_ranks(S.run_frames, n, backend="gloo", device="cpu",
                            timeout_s=TIMEOUT_S,
                            args=(cfg, kind, camera, frames, states, mesh))


def run_single(cfg, kind, frames, camera=CAM):
    """The port's single-process pipeline over the same frames: its map's
    arrays (core/convert.py)."""
    import torch
    from mrhash_tpu_torch.core import convert, pipeline
    from mrhash_tpu_torch.core.state import make_state
    from mrhash_tpu_torch.ops import camera as C

    st = make_state(cfg.num_blocks)
    cam0 = C.make_camera(*camera)
    for rot, trans, a, b in frames:
        cam = C.with_pose(cam0, rot, trans)
        if kind == "rgbd":
            st, _ = pipeline.integrate_rgbd(cfg, st, cam, torch.from_numpy(a),
                                            torch.from_numpy(b))
        else:
            st, _ = pipeline.integrate_points(
                cfg, st, cam, torch.from_numpy(a),
                None if b is None else torch.from_numpy(b))
    return convert.to_reference_arrays(st)


def reference_shards(ref, n):
    """The reference's sharded state as the n ranks' arrays."""
    from mrhash_tpu_torch.core import convert
    return [convert.to_reference_arrays(s)
            for s in convert.from_reference_sharded(ref, n)]


def blocks(arrays):
    """A map's blocks by key: {key: (res, {field: [512] host layout})}, a
    res-1 block's 64 voxels at lanes [0, 64) and zeros beyond."""
    t, pool = arrays["table"], arrays["pool"]
    occ = t["ptr"] != P.FREE_ENTRY
    keys, ptr, res = t["pos"][occ], t["ptr"][occ], t["res"][occ]
    lanes = np.arange(P.TOTAL_SDF_BLOCK_SIZE)
    nvox = np.where(res == 1, P.TOTAL_LOW_BLOCK_SIZE,
                    P.TOTAL_SDF_BLOCK_SIZE)[:, None]
    idx = ptr[:, None].astype(np.int64) + np.minimum(lanes, nvox - 1)
    out = {}
    vals = {f: np.where(lanes < nvox, pool[f].reshape(-1)[idx], 0)
            for f in ("sdf", "sumsq", "weight", "rgbp")}
    for i, k in enumerate(map(tuple, keys.tolist())):
        out[k] = (int(res[i]), {f: v[i] for f, v in vals.items()})
    return out


def union(maps):
    """One key -> block dict of several ranks' maps (keys never repeat)."""
    out = {}
    for m in maps:
        b = blocks(m)
        assert not set(b) & set(out), "a key on two ranks"
        out.update(b)
    return out


def stacked(got, want):
    """(res, fields) of two block dicts over their common sorted keys, after
    checking that the key sets are equal."""
    assert set(got) == set(want), (len(set(got) - set(want)),
                                   len(set(want) - set(got)))
    keys = sorted(want)
    assert keys, "no block"
    res = [np.asarray([m[k][0] for k in keys]) for m in (got, want)]
    f = [{n: np.stack([m[k][1][n] for k in keys])
          for n in ("sdf", "sumsq", "weight", "rgbp")} for m in (got, want)]
    return res, f


def assert_same_map(got, want, min_weighted=1000):
    """Block dicts equal: keys, resolutions, weight and rgbp exact, sdf
    within 2e-5 and sumsq within 5e-4 where weighted.  Returns the number
    of weighted voxels."""
    (rg, rw), (g, w) = stacked(got, want)
    np.testing.assert_array_equal(rg, rw)
    np.testing.assert_array_equal(g["weight"], w["weight"])
    upd = w["weight"] > 0
    n = int(upd.sum())
    assert n >= min_weighted, f"only {n} weighted voxels"
    np.testing.assert_array_equal(g["rgbp"][upd], w["rgbp"][upd])
    np.testing.assert_allclose(g["sdf"][upd], w["sdf"][upd], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(g["sumsq"][upd], w["sumsq"][upd], atol=5e-4,
                               rtol=0)
    return n


def assert_close_lidar(got, want, min_weighted=1000):
    """tests/test_torch_lidar.py's bounds for the projective update (XLA's
    and torch's atan2/asin may put a voxel on another pixel): same keys,
    weight flips <= max(16, 1e-4 lanes), sdf within 2e-3 where the weights
    agree and are non-zero.  Returns the flips."""
    (rg, rw), (g, w) = stacked(got, want)
    np.testing.assert_array_equal(rg, rw)
    n = int((w["weight"] > 0).sum())
    assert n >= min_weighted, f"only {n} weighted voxels"
    flips = int((g["weight"] != w["weight"]).sum())
    assert flips <= max(16, int(g["weight"].size * 1e-4)), flips
    agree = (g["weight"] == w["weight"]) & (w["weight"] > 0)
    assert float(np.abs(g["sdf"] - w["sdf"])[agree].max()) < 2e-3
    return flips


def assert_shards_match(results, ref, n, lidar=False):
    """Each rank's map equal to the reference's shard of the same rank
    (key routing included), and every rank's stats equal to the
    reference's."""
    shards = reference_shards(ref, n)
    for r in range(n):
        got, want = blocks(results[r]["state"]), blocks(shards[r])
        if lidar:
            assert_close_lidar(got, want, min_weighted=0)
        else:
            assert_same_map(got, want, min_weighted=0)


def assert_owned(results, n):
    """Every occupied key lives on owner_of(key) and on no other rank."""
    import torch
    seen = set()
    for r, res in enumerate(results):
        t = res["state"]["table"]
        keys = t["pos"][t["ptr"] != P.FREE_ENTRY]
        own = S.owner_of(torch.from_numpy(keys), n).numpy()
        assert (own == r).all(), f"rank {r} holds keys it does not own"
        ks = set(map(tuple, keys.tolist()))
        assert not ks & seen, "a key on two ranks"
        seen |= ks
    return len(seen)
