"""Kernel K1 (ops/fused_integrate.py) against the JAX reference.

The port's fused integrate (its plain PyTorch twin on CPU) is held against
the reference's fused Pallas kernel in interpret mode and against the
reference's gather-mode integrate_depth, on the 64x256 scene of
tests/test_fused_integrate.py with depth snapped to the reference kernel's
1/2048 m grid (so its quantisation is the identity, PORT_NOTES.md P1).
Per block key: weight and rgbp exact, sdf within 2e-5, sumsq within 5e-4
(the reference test's bounds), GC flags min|sdf| and max weight equal.

The card-only case compares the CUDA kernel with its twin on the same
inputs (same tolerances; run on a machine with a card with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""
import numpy as np
import pytest
import torch

from mrhash_tpu_torch.core.state import MapConfig, make_state, pack_rgb
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import fused_integrate as FI
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.utils.profiler import COUNTS

torch.set_num_threads(1)

ROWS, COLS = 64, 256
N_FRAMES = 3
CFG = dict(virtual_voxel_size=0.02, sdf_truncation=0.06,
           sdf_truncation_scale=0.0, integration_weight_sample=1,
           max_integration_distance=5.0, n_frames_invalidate_voxels=0,
           num_blocks=1 << 11, max_active_blocks=1 << 10,
           max_alloc_per_frame=1 << 10, alloc_pixel_stride=1)
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)


def _frames():
    """Per-frame depth (snapped to 1/2048 m) + one rgb image; per-frame
    noise keeps the Welford sumsq non-trivial."""
    rng = np.random.default_rng(0)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    depths = [(np.round((base + rng.normal(0, 0.01, base.shape)) * 2048.0)
               / 2048.0).astype(np.float32) for _ in range(N_FRAMES)]
    rgb = rng.integers(0, 255, (ROWS, COLS, 3)).astype(np.uint8)
    return depths, rgb


def _window(device):
    """Allocate the scene's blocks and compact the window (port alloc;
    tests/test_torch_pipeline.py holds it equal to the reference's)."""
    cfg = MapConfig(**CFG)
    cam = C.make_camera(*CAM, device=device)
    depths, rgb = _frames()
    st = make_state(cfg.num_blocks, device=device)
    for i, d in enumerate(depths):
        pc_depth = C.get_depth(cam, C.compute_cloud(
            cam, torch.from_numpy(d).to(device)))
        keys, valid = AB.alloc_candidates_depth(
            cfg, cam, pc_depth, cfg.dda_steps(5.0), frame=i)
        I.alloc_blocks(cfg, st.table, keys, valid, i)
    _, bpos, bptr, bres = I.compact_active(cfg, st.table, cam)
    return cfg, cam, st, depths, rgb, bpos, bptr, bres


@pytest.fixture(scope="module")
def scene():
    return _window(torch.device("cpu"))


@pytest.fixture(scope="module")
def port_run(scene):
    """The port's fused integrate over the frames: pool rows + last flags."""
    cfg, cam, st, depths, rgb, bpos, bptr, bres = scene
    pool = make_state(cfg.num_blocks).pool
    for d in depths:
        aux = I.fused_integrate_depth(cfg, pool, cam, torch.from_numpy(d),
                                      torch.from_numpy(rgb), bpos, bptr, bres)
    rows = I._block_rows(bptr)[0].numpy()
    return {f: getattr(pool, f).numpy()[rows] for f in
            ("sdf", "sumsq", "weight", "rgbp")}, aux


def _reference(scene, mode):
    """Reference rows after the frames: JAX fused_integrate_depth (Pallas
    interpret) or integrate_depth (gather), on the window padded to the
    reference's 16-row kernel steps."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import make_state as jmake_state
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import integrate as JI

    cfg, _, _, depths, rgb, bpos, bptr, _ = scene
    jcfg = JMapConfig(sample_mode="fused", pallas_interpret=True, **CFG)
    jcam = JC.make_camera(*CAM)
    A = bpos.shape[0]
    Ap = -(-A // 16) * 16
    pos = np.zeros((Ap, 3), np.int32)
    pos[:A] = bpos.numpy()
    ptr = np.zeros(Ap, np.int32)
    ptr[:A] = bptr.numpy()
    args = (jnp.asarray(pos), jnp.asarray(ptr), jnp.zeros(Ap, jnp.int32),
            jnp.arange(Ap) < A)
    if mode == "fused":
        step = jax.jit(lambda p, d: JI.fused_integrate_depth(
            jcfg, p, jcam, _ref_pc_depth(jcam, d), jnp.asarray(rgb), *args))
    else:
        step = jax.jit(lambda p, d: (JI.integrate_depth(
            jcfg, p, jcam, _ref_pc_depth(jcam, d), jnp.asarray(rgb),
            *args), None))
    pool = jmake_state(cfg.num_blocks).pool
    for d in depths:
        pool, aux = step(pool, jnp.asarray(d))
    rows = bptr.numpy() // 512
    out = {f: np.asarray(getattr(pool, f))[rows] for f in
           ("sdf", "sumsq", "weight", "rgbp")}
    return out, (None if aux is None else
                 {k: np.asarray(v)[:A] for k, v in aux.items()
                  if k.startswith("gc_")})


def _ref_pc_depth(jcam, depth):
    from mrhash_tpu.ops import camera as JC
    return JC.get_depth(jcam, JC.compute_cloud(jcam, depth))


def _assert_rows_match(got, ref):
    np.testing.assert_array_equal(got["weight"], ref["weight"])
    assert int((ref["weight"] > 0).sum()) > 5000, "scene integrated nothing"
    upd = ref["weight"] > 0
    np.testing.assert_array_equal(got["rgbp"][upd], ref["rgbp"][upd])
    np.testing.assert_allclose(got["sdf"][upd], ref["sdf"][upd], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got["sumsq"][upd], ref["sumsq"][upd],
                               atol=5e-4, rtol=0)
    assert float(np.abs(ref["sumsq"]).max()) > 0.1, "sumsq never moved"


def test_fused_matches_reference_kernel(scene, port_run):
    got, aux = port_run
    ref, ref_aux = _reference(scene, "fused")
    _assert_rows_match(got, ref)
    np.testing.assert_array_equal(aux["gc_min_s"].numpy(),
                                  ref_aux["gc_min_s"])
    np.testing.assert_array_equal(aux["gc_max_w"].numpy().astype(np.int32),
                                  ref_aux["gc_max_w"])
    assert aux["unserved_blocks"] == 0


def test_fused_matches_reference_gather(scene, port_run):
    got, _ = port_run
    ref, _ = _reference(scene, "gather")
    _assert_rows_match(got, ref)


def test_port_gather_matches_port_fused(scene, port_run):
    """The port's own gather integrate (the plain reference form) agrees
    with its fused path bit for bit."""
    cfg, cam, _, depths, rgb, bpos, bptr, bres = scene
    pool = make_state(cfg.num_blocks).pool
    for d in depths:
        I.integrate_depth(cfg, pool, cam, torch.from_numpy(d),
                          torch.from_numpy(rgb), bpos, bptr, bres)
    rows = I._block_rows(bptr)[0].numpy()
    got, _ = port_run
    for f in ("sdf", "sumsq", "weight", "rgbp"):
        np.testing.assert_array_equal(getattr(pool, f).numpy()[rows], got[f])


def test_wrapper_rejects_bad_operands(scene):
    cfg, cam, st, depths, rgb, bpos, bptr, bres = scene
    cam_vec = FI.make_cam_vec(cam, 0.02, 0.06, 0.0, 5.0, 1, 255)
    depth = torch.from_numpy(depths[0])
    rgbp = torch.zeros((ROWS, COLS), dtype=torch.int32)
    with pytest.raises(ValueError, match="ptr"):
        FI.fused_integrate_rows(st.pool, depth, rgbp, cam_vec, bpos,
                                bptr.long(), bres)
    with pytest.raises(ValueError, match="depth_img"):
        FI.fused_integrate_rows(st.pool, depth.t(), rgbp.t(), cam_vec, bpos,
                                bptr, bres)
    with pytest.raises(ValueError, match="rgb_img"):
        FI.fused_integrate_rows(st.pool, depth, rgbp.float(), cam_vec, bpos,
                                bptr, bres)
    # a negative window would wrap, one past the pool would write out of
    # it; a res-0 window must start on a row, a res-1 window on 64 lanes
    for bad, res in ((-512, 0), (cfg.num_blocks * 512, 0), (64, 0),
                     (cfg.num_blocks * 512 - 32, 1), (0, 2)):
        ptr_bad, res_bad = bptr.clone(), bres.clone()
        ptr_bad[-1], res_bad[-1] = bad, res
        with pytest.raises(ValueError, match="outside"):
            FI.fused_integrate_rows(st.pool, depth, rgbp, cam_vec, bpos,
                                    ptr_bad, res_bad)


def test_wrapper_rejects_misaligned_pool(scene):
    """The res-0 kernel moves 4 voxels per 16-byte access: a pool field
    that does not start on 16 bytes is refused before any launch."""
    from mrhash_tpu_torch.core.state import VoxelPool
    cfg, cam, st, depths, rgb, bpos, bptr, bres = scene
    cam_vec = FI.make_cam_vec(cam, 0.02, 0.06, 0.0, 5.0, 1, 255)
    depth = torch.from_numpy(depths[0])
    rgbp = torch.zeros((ROWS, COLS), dtype=torch.int32)
    pool = st.pool
    flat = torch.zeros(pool.sdf.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(pool.sdf.shape)
    bad = VoxelPool(sdf=shifted, sumsq=pool.sumsq, weight=pool.weight,
                    rgbp=pool.rgbp)
    with pytest.raises(ValueError, match="pool.sdf: not 16-byte aligned"):
        FI.fused_integrate_rows(bad, depth, rgbp, cam_vec, bpos, bptr, bres)


# ---------------------------------------------------------------------------
# on the card: kernel vs twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_twin_on_card(cuda):
    cfg, cam, st, depths, rgb, bpos, bptr, bres = _window(cuda)
    rgbp = pack_rgb(torch.from_numpy(rgb).to(cuda)).contiguous()
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale, 5.0, 1, 255)
    pk = make_state(cfg.num_blocks, device=cuda).pool
    pt = make_state(cfg.num_blocks, device=cuda).pool
    n0 = COUNTS["fused_integrate_rows"]
    for d in depths:
        dd = torch.from_numpy(d).to(cuda)
        fk = FI.fused_integrate_rows(pk, dd, rgbp, cam_vec, bpos, bptr, bres)
        ft = FI.fused_integrate_rows_ref(pt, dd, rgbp, cam_vec, bpos, bptr,
                                         bres)
    torch.cuda.synchronize()
    assert COUNTS["fused_integrate_rows"] == n0 + N_FRAMES
    for f in ("weight", "rgbp"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight > 0).sum()) > 5000
    assert float((pk.sdf - pt.sdf).abs().max()) <= 2e-5
    assert float((pk.sumsq - pt.sumsq).abs().max()) <= 5e-4
    assert torch.equal(fk[:, :3], ft[:, :3])
    # the sumsq flag is a 512-term sum taken in another order
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("subset", ["odd", "even", "one", "every-third"])
def test_kernel_on_entry_subsets_on_card(cuda, subset):
    """The res-0 kernel walks 2 entries per CTA: an odd entry count (the
    last CTA has one), an even one, a single entry, and a non-contiguous
    subset (every third entry of the window) equal the twin run over the
    same entries."""
    cfg, cam, st, depths, rgb, bpos, bptr, bres = _window(cuda)
    A = bpos.shape[0]
    n = {"odd": A - 1 + A % 2, "even": A - A % 2, "one": 1,
         "every-third": None}[subset]
    sel = (torch.arange(0, A, 3, device=cuda) if n is None
           else torch.arange(n, device=cuda))
    bpos, bptr, bres = (x[sel].contiguous() for x in (bpos, bptr, bres))
    rgbp = pack_rgb(torch.from_numpy(rgb).to(cuda)).contiguous()
    cam_vec = FI.make_cam_vec(cam, cfg.virtual_voxel_size, cfg.sdf_truncation,
                              cfg.sdf_truncation_scale, 5.0, 1, 255)
    pk = make_state(cfg.num_blocks, device=cuda).pool
    pt = make_state(cfg.num_blocks, device=cuda).pool
    for d in depths:
        dd = torch.from_numpy(d).to(cuda)
        fk = FI.fused_integrate_rows(pk, dd, rgbp, cam_vec, bpos, bptr, bres)
        ft = FI.fused_integrate_rows_ref(pt, dd, rgbp, cam_vec, bpos, bptr,
                                         bres)
    torch.cuda.synchronize()
    for f in ("weight", "rgbp"):
        assert torch.equal(getattr(pk, f), getattr(pt, f)), f
    assert int((pk.weight > 0).sum()) > 0
    assert float((pk.sdf - pt.sdf).abs().max()) <= 2e-5
    assert float((pk.sumsq - pt.sumsq).abs().max()) <= 5e-4
    assert torch.equal(fk[:, :3], ft[:, :3])
    torch.testing.assert_close(fk[:, 3], ft[:, 3], rtol=1e-4, atol=1e-6)
