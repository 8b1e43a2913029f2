"""Kernel K2 (ops/sample_image.py) and the starvation pass against the JAX
reference.

- The K2 twin against the reference's Pallas sampler
  (`sample_image_pallas`, interpret mode) on in-patch lanes: exact (both
  return the stored f32 pixel).
- `starve_voxels` (one-shot z-buffer + K2 readback) against the
  reference's `starve_voxels` in its fused configuration (Pallas sampler,
  interpret mode) and in gather mode: equal weights after the starve.
- Garbage collection after a starve frees the same blocks.

The card-only case compares the CUDA kernel with its twin (exact).
"""
import numpy as np
import pytest
import torch

from mrhash_tpu_torch.core.state import MapConfig, make_state
from mrhash_tpu_torch.ops import alloc_blocks as AB
from mrhash_tpu_torch.ops import camera as C
from mrhash_tpu_torch.ops import integrate as I
from mrhash_tpu_torch.ops import sample_image as SI
from mrhash_tpu_torch.utils.profiler import COUNTS

torch.set_num_threads(1)

ROWS, COLS = 64, 256
CFG = dict(virtual_voxel_size=0.02, sdf_truncation=0.06,
           sdf_truncation_scale=0.0, integration_weight_sample=1,
           max_integration_distance=5.0, n_frames_invalidate_voxels=0,
           num_blocks=1 << 11, max_active_blocks=1 << 10,
           max_alloc_per_frame=1 << 10, alloc_pixel_stride=1)
CAM = (80.0, 80.0, 127.5, 31.5, ROWS, COLS, 0.01, 5.0)


def _sampler_inputs(seed=0, A=24):
    """A 2-channel image, per-block aligned patch origins (the reference's
    8-row / 128-col alignment) and random in-patch lanes."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 30.0, (2, ROWS, COLS)).astype(np.float32)
    img[1] = rng.integers(0, 1 << 24, (ROWS, COLS)).astype(np.float32)
    r0 = (rng.integers(0, (ROWS - 24) // 8 + 1, A) * 8).astype(np.int32)
    c0 = np.zeros(A, np.int32)
    lr = rng.integers(0, 24, (A, 512)).astype(np.int32)
    lc = rng.integers(0, 256, (A, 512)).astype(np.int32)
    ok = rng.random((A, 512)) < 0.8
    return img, r0, c0, lr, lc, ok


def test_sample_image_twin_matches_reference_sampler():
    from mrhash_tpu.ops import pallas_kernels as PK
    jnp = pytest.importorskip("jax.numpy")
    img, r0, c0, lr, lc, ok = _sampler_inputs()
    ref = np.asarray(PK.sample_image_pallas(
        jnp.asarray(img), jnp.asarray(r0), jnp.asarray(c0), jnp.asarray(lr),
        jnp.asarray(lc), interpret=True))
    got = SI.sample_image(torch.from_numpy(img),
                          torch.from_numpy(r0[:, None] + lr),
                          torch.from_numpy(c0[:, None] + lc),
                          torch.from_numpy(ok)).numpy()
    assert got.shape == ref.shape == (len(r0), 2, 512)
    okc = np.broadcast_to(ok[:, None, :], got.shape)
    np.testing.assert_array_equal(got[okc], ref[okc])
    assert not got[~okc].any()


def test_sample_image_rejects_lanes_off_the_image():
    """An ok lane outside the image raises (the kernel would read out of
    bounds, the twin would wrap a negative index); off-image lanes that
    are not ok are fine."""
    img, r0, c0, lr, lc, ok = _sampler_inputs(A=4)
    args = [torch.from_numpy(a) for a in (img, r0[:, None] + lr,
                                          c0[:, None] + lc, ok)]
    assert SI.sample_image(*args).shape == (4, 2, 512)
    for k, bad in ((1, -1), (1, ROWS), (2, -1), (2, COLS)):
        a = [t.clone() for t in args]
        a[k][0, 0], a[3][0, 0] = bad, True
        with pytest.raises(ValueError, match="outside the image"):
            SI.sample_image(*a)
        a[3][0, 0] = False
        assert SI.sample_image(*a)[0, :, 0].eq(0).all()


def _integrated_window(frames=3):
    """The port's map after a few frames of the test scene, and its window."""
    cfg = MapConfig(**CFG)
    cam = C.make_camera(*CAM)
    rng = np.random.default_rng(0)
    r = np.arange(ROWS, dtype=np.float32)[:, None]
    c = np.arange(COLS, dtype=np.float32)[None, :]
    base = 1.6 + 0.3 * np.sin(c / 37.0) + 0.2 * np.cos(r / 17.0)
    rgb = torch.from_numpy(rng.integers(0, 255, (ROWS, COLS, 3))
                           .astype(np.uint8))
    st = make_state(cfg.num_blocks)
    for i in range(frames):
        d = np.round((base + rng.normal(0, 0.01, base.shape)) * 2048) / 2048
        pc_depth = C.get_depth(cam, C.compute_cloud(
            cam, torch.from_numpy(d.astype(np.float32))))
        keys, valid = AB.alloc_candidates_depth(cfg, cam, pc_depth,
                                               cfg.dda_steps(5.0), frame=i)
        I.alloc_blocks(cfg, st.table, keys, valid, i)
        slots, bpos, bptr, bres = I.compact_active(cfg, st.table, cam)
        I.fused_integrate_depth(cfg, st.pool, cam, pc_depth, rgb, bpos, bptr,
                                bres)
    return cfg, cam, st, slots, bpos, bptr, bres


@pytest.fixture(scope="module")
def window():
    return _integrated_window()


@pytest.mark.parametrize("mode", ["fused", "gather"])
def test_starve_matches_reference(window, mode):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapConfig as JMapConfig
    from mrhash_tpu.core.state import VoxelPool
    from mrhash_tpu.ops import camera as JC
    from mrhash_tpu.ops import integrate as JI

    cfg, cam, st, slots, bpos, bptr, bres = window
    pool0 = {f: getattr(st.pool, f).clone() for f in
             ("sdf", "sumsq", "weight", "rgbp")}
    starved = I.starve_mask(cfg, cam, bpos, bres)
    assert int(starved.sum()) > 1000, "starvation hit nothing"
    I.starve_voxels(cfg, st.pool, cam, bpos, bptr, bres)
    got_w = st.pool.weight.numpy().copy()
    for f, v in pool0.items():                     # restore for the next mode
        getattr(st.pool, f).copy_(v)

    jcfg = JMapConfig(sample_mode=mode, pallas_interpret=True, **CFG)
    jcam = JC.make_camera(*CAM)
    A = bpos.shape[0]
    Ap = -(-A // 8) * 8
    pos = np.zeros((Ap, 3), np.int32)
    pos[:A] = bpos.numpy()
    ptr = np.zeros(Ap, np.int32)
    ptr[:A] = bptr.numpy()
    jpool = VoxelPool(**{f: jnp.asarray(v.numpy()) for f, v in pool0.items()})
    jpool = jax.jit(lambda p: JI.starve_voxels(
        jcfg, p, jcam, jnp.asarray(pos), jnp.asarray(ptr),
        jnp.zeros(Ap, jnp.int32), jnp.arange(Ap) < A))(jpool)
    ref_w = np.asarray(jpool.weight)
    np.testing.assert_array_equal(got_w, ref_w)
    # every starved voxel that had weight lost one unit, and nothing else
    rows = I._block_rows(bptr)[0]
    lost = starved & (pool0["weight"][rows] > 0)
    assert int((got_w != pool0["weight"].numpy()).sum()) == int(lost.sum())


def test_gc_after_starve_matches_flagless_decision(window):
    """GC flags recomputed from the pool rows (as K1 emits them) drive a
    sweep that frees the blocks it decides, at most max_gc_free_per_frame
    in window order, returns their heap ids and zeroes their rows."""
    cfg, cam, st, slots, bpos, bptr, bres = window
    rows = I._block_rows(bptr)[0]
    w = st.pool.weight[rows]
    s = torch.where(w > 0, st.pool.sdf[rows].abs(), float("inf"))
    flags = torch.stack([s.amin(1), w.amax(1).to(torch.float32),
                         w.sum(1).to(torch.float32),
                         st.pool.sumsq[rows].sum(1)], dim=1)
    free0 = st.table.high_count
    gcfg = MapConfig(**dict(CFG, sdf_truncation=0.0))   # frees every block
    decision, _ = I.window_decisions(gcfg, cam, flags, bres)
    I.garbage_collect_sweep(gcfg, st.table, st.pool, slots, decision)
    n = min(len(slots), gcfg.max_gc_free_per_frame)
    assert st.table.high_count == free0 + n
    assert int(st.pool.weight[rows[:n]].abs().sum()) == 0


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
    img, r0, c0, lr, lc, ok = _sampler_inputs(seed=1, A=4096)
    args = [torch.from_numpy(a).to(cuda) for a in
            (img, r0[:, None] + lr, c0[:, None] + lc, ok)]
    n0 = COUNTS["sample_image"]
    got = SI.sample_image(*args)
    ref = SI.sample_image_ref(*args)
    torch.cuda.synchronize()
    assert COUNTS["sample_image"] == n0 + 1
    assert torch.equal(got, ref)
