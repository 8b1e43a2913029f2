"""Parity of the PyTorch port's elementary ops with the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: integer results exact; float results within 1e-6 relative
(both packages run the same f32 operations in the same order, so most are
bit-equal; the bound absorbs last-ulp differences of XLA's fused
elementwise code).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhash_tpu import params as P
from mrhash_tpu.core.state import MapConfig as JMapConfig
from mrhash_tpu.ops import camera as JC
from mrhash_tpu.ops import coords as JX
from mrhash_tpu.ops import hashtable as JH
from mrhash_tpu.ops import integrate as JI
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import coords as X
from mrhash_tpu_torch.ops import hashtable as H

torch.set_num_threads(1)

REL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(got, ref, rtol=REL, atol=0)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      ref.astype(np.int64))


# ---------------------------------------------------------------------------
# coords
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(0)
VOX = _rng.integers(-5000, 5000, (4096, 3)).astype(np.int32)
PTS = _rng.uniform(-40.0, 40.0, (4096, 3)).astype(np.float32)
VVS, EXT = 0.01, (1.0, 1.0, 1.0)

COORD_CASES = {
    "voxel_to_world": lambda M, a: M.virtual_voxel_pos_to_world(VVS, a(VOX)),
    "voxel_to_block": lambda M, a: M.virtual_voxel_pos_to_sdf_block(
        a(VOX), VVS, EXT),
    "point_to_voxel": lambda M, a: M.world_point_to_virtual_voxel_pos(
        VVS, a(PTS)),
    "point_to_block": lambda M, a: M.world_point_to_sdf_block(VVS, EXT,
                                                             a(PTS)),
    "block_index": lambda M, a: M.virtual_voxel_pos_to_block_index(a(VOX)),
    "block_index_res1": lambda M, a: M.virtual_voxel_pos_to_block_index(
        a(VOX), P.LOW_BLOCK_SIZE),
    "delinearize": lambda M, a: M.delinearize_voxel_pos(
        a(np.arange(512, dtype=np.int32))),
    "linearize": lambda M, a: M.linearize_voxel_pos(a(VOX % 8)),
    "block_to_world": lambda M, a: M.sdf_block_to_world_point(VVS, a(VOX)),
    "world_to_chunks": lambda M, a: M.world_to_chunks(a(PTS), (2.0, 2.0,
                                                               2.0)),
    "truncation": lambda M, a: M.get_truncation(a(PTS[:, 2]), 0.07, 0.01),
}


@pytest.mark.parametrize("case", sorted(COORD_CASES))
def test_coords_match_reference(case):
    fn = COORD_CASES[case]
    _same(fn(X, torch.from_numpy), fn(JX, jnp.asarray))


def test_combine_voxel_matches_reference():
    rng = np.random.default_rng(1)
    n = 5000
    sdf0, sdf1 = (rng.uniform(-0.1, 0.1, n).astype(np.float32)
                  for _ in range(2))
    w0 = rng.integers(0, 256, n).astype(np.int32)
    w1 = rng.integers(1, 4, n).astype(np.int32)
    rgb0, rgb1 = (rng.integers(0, 256, (n, 3)).astype(np.uint8)
                  for _ in range(2))
    args = (sdf0, w0, rgb0, sdf1, w1, rgb1)
    got = X.combine_voxel(*map(torch.from_numpy, args))
    ref = JX.combine_voxel(*map(jnp.asarray, args))
    for g, r in zip(got, ref):
        _same(g, r)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

def _cams(model):
    if model == C.PINHOLE:
        args = (600.0, 600.0, 599.5, 339.5, 680, 1200, 0.01, 30.0)
    else:
        args = (128 / (2 * np.pi), 16 / 0.65, 64.0, 8.0, 16, 128, 0.2, 40.0)
    return C.make_camera(*args, model=model), JC.make_camera(*args,
                                                             model=model)


@pytest.mark.parametrize("model", [C.PINHOLE, C.SPHERICAL])
def test_camera_projection_matches_reference(model):
    cam, jcam = _cams(model)
    rng = np.random.default_rng(2)
    pc = rng.uniform(-6.0, 6.0, (20000, 3)).astype(np.float32)
    pc[:, 2] = np.abs(pc[:, 2])
    pc[:50, 2] = 0.0                                  # the z == 0 guard
    tpc, jpc = torch.from_numpy(pc), jnp.asarray(pc)
    for name in ("project_point", "project_point_approx"):
        for g, r in zip(getattr(C, name)(cam, tpc), getattr(JC, name)(jcam,
                                                                      jpc)):
            _same(g, r)
    _same(C.get_depth(cam, tpc), JC.get_depth(jcam, jpc))
    rows = rng.integers(0, cam.rows, 5000)
    cols = rng.integers(0, cam.cols, 5000)
    d = rng.uniform(0.1, 20.0, 5000).astype(np.float32)
    _same(C.inverse_projection(cam, *map(torch.from_numpy, (rows, cols, d))),
          JC.inverse_projection(jcam, *map(jnp.asarray, (rows, cols, d))))


def test_camera_pose_and_cloud_match_reference():
    cam, jcam = _cams(C.PINHOLE)
    rng = np.random.default_rng(3)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)],
                    [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)],
                    [2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]], np.float32)
    trans = np.array([0.4, -1.2, 2.5], np.float32)
    cam = C.with_pose(cam, rot, trans)
    jcam = JC.with_pose(jcam, rot, trans)
    pw = rng.uniform(-10.0, 10.0, (10000, 3)).astype(np.float32)
    # a 3-term dot in another summation order: compare at the f32
    # rounding of the terms' magnitude, not of the (cancelling) result
    scale = np.abs(pw).sum(1, keepdims=True) + np.abs(trans).sum()
    for got, ref in ((C.world_to_cam(cam, torch.from_numpy(pw)),
                      JC.world_to_cam(jcam, jnp.asarray(pw))),
                     (C.cam_to_world(cam, torch.from_numpy(pw)),
                      JC.cam_to_world(jcam, jnp.asarray(pw)))):
        assert np.all(np.abs(_np(got) - _np(ref)) <= REL * scale)
    depth = rng.uniform(0.0, 35.0, (68, 120)).astype(np.float32)
    cam_s = C.make_camera(60.0, 60.0, 59.5, 33.5, 68, 120, 0.01, 30.0)
    jcam_s = JC.make_camera(60.0, 60.0, 59.5, 33.5, 68, 120, 0.01, 30.0)
    _same(C.compute_cloud(cam_s, torch.from_numpy(depth)),
          JC.compute_cloud(jcam_s, jnp.asarray(depth)))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _keys(n, seed, lo=-3000, hi=3000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, (n, 3)).astype(np.int32)
    keys[:4] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1, -2 ** 31, 7],
                [-2 ** 31, 2 ** 31 - 1, -7]]
    return keys


def test_hash_functions_match_reference():
    """uint32 mixing over negative and positive coordinates, exact."""
    keys = _keys(20000, 4)
    tk, jk = torch.from_numpy(keys), jnp.asarray(keys)
    h = np.random.default_rng(5).integers(0, 2 ** 32, 20000,
                                          dtype=np.uint64)
    _same(H._avalanche(torch.from_numpy(h.astype(np.int64))),
          np.asarray(JH._avalanche(jnp.asarray(h.astype(np.uint32))))
          .astype(np.int64))
    _same(H.fingerprint(tk), JH.fingerprint(jk))
    for nb in (1 << 15, 1000, 7):
        _same(H.calculate_hash(tk, nb), JH.calculate_hash(jk, nb))


def test_dedup_candidates_matches_reference():
    """Salted dedup picks the same representatives (PORT_NOTES.md: the
    reference's duplicate-index .set and the port's scatter "amax" agree
    on XLA:CPU)."""
    rng = np.random.default_rng(6)
    base = rng.integers(-60, 60, (3000, 3)).astype(np.int32)
    keys = base[rng.integers(0, 3000, 40000)]
    valid = rng.random(40000) < 0.9
    cfg = MapConfig(max_alloc_per_frame=4096, dedup_scratch_factor=4)
    for salt in (0, 1, 17):
        got, stats = AB.dedup(cfg, torch.from_numpy(keys),
                              torch.from_numpy(valid), salt)
        rk, rv = JI.dedup_candidates(jnp.asarray(keys), jnp.asarray(valid),
                                     jnp.int32(salt), 4096 * 4, 4096)
        _same(got, np.asarray(rk)[np.asarray(rv)])
        assert int(stats[0]) == got.shape[0]


def test_insert_lookup_free_match_reference():
    """One key stream with collisions, overflow probes, a dry heap and
    frees: equal key sets, equal ptr multisets, equal heap counts."""
    nb, nbk = 512, 24            # capacity 240 < blocks: windows overflow
    t = H.make_table(nb, nbk)
    jt = JH.make_table(nb, nbk)
    rng = np.random.default_rng(7)
    U, M = 160, 600              # fixed reference shapes: one compile each
    j_insert, j_lookup = jax.jit(JH.insert), jax.jit(JH.lookup)

    def pad(a, n):
        return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:],
                                           a.dtype)])

    def insert(keys):
        nonlocal jt
        n = len(keys)
        t_info = H.insert(t, torch.from_numpy(keys),
                          torch.zeros(n, dtype=torch.int32))
        jt, j_info = j_insert(jt, jnp.asarray(pad(keys, U)),
                              jnp.arange(U) < n, jnp.zeros(U, jnp.int32))
        _same(t_info["present"], np.asarray(j_info["present"])[:n])

    def check():
        occ, jocc = _np(t.ptr) != P.FREE_ENTRY, np.asarray(jt.ptr) != -2
        keys = {tuple(k) for k in _np(t.pos)[occ]}
        assert keys == {tuple(k) for k in np.asarray(jt.pos)[jocc]}
        assert sorted(_np(t.ptr)[occ]) == sorted(np.asarray(jt.ptr)[jocc])
        assert t.high_count == int(jt.high_count)
        assert t.low_count == int(jt.low_count)
        probe = np.concatenate([_np(t.pos)[occ], _keys(300, 9, -50, 50)])
        n = len(probe)
        got = H.lookup(t, torch.from_numpy(probe))
        ref = j_lookup(jt, jnp.asarray(pad(probe, M)))
        _same(got[0], np.asarray(ref[0])[:n])          # found
        _same(got[2], np.asarray(ref[2])[:n])          # ptr
        return occ.sum()

    for i in range(4):
        keys = np.unique(rng.integers(-20, 20, (120, 3)), axis=0)
        insert(keys.astype(np.int32))
        n_occ = check()
    assert n_occ > 150
    occ_slots = np.nonzero(_np(t.ptr) != P.FREE_ENTRY)[0]
    kill = rng.choice(occ_slots, 60, replace=False)
    H.free_slots(t, torch.from_numpy(kill))
    jt, _, _, _ = JH.free_slots(jt, jnp.asarray(kill.astype(np.int32)),
                                jnp.ones(60, bool))
    check()
    insert(np.unique(rng.integers(-20, 20, (150, 3)), axis=0)
           .astype(np.int32))
    check()


# ---------------------------------------------------------------------------
# configuration + import hygiene
# ---------------------------------------------------------------------------

def test_map_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JMapConfig)}
    for f in dataclasses.fields(MapConfig):
        assert f.name in ref, f.name
        assert f.default == ref[f.name], (f.name, f.default, ref[f.name])
    cfg, jcfg = MapConfig(sdf_truncation=0.07), JMapConfig(sdf_truncation=0.07)
    assert cfg.dda_steps(30.0) == jcfg.dda_steps(30.0)


def test_port_imports_no_jax():
    """Every module of mrhash_tpu_torch imports with jax made
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import mrhash_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'mrhash_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'mrhash_tpu_torch.geowrapper' in names, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12
