"""The port's online 3D Gaussian Splatting (mrhash_tpu_torch/gs) against the
JAX reference (mrhash_tpu/gs), on the CPU at small sizes; inputs are made
with numpy from a seed and handed to both packages.

Tolerances, each with its reason:
- blend twins (K4/K5's plain versions) against the XLA custom_vjp and the
  Pallas kernels in interpret mode: Tfin and Cfin within 1e-6 absolute,
  the blended mask equal, the gradients of xy, conic, opacity and rgb
  within 1e-4 absolute and relative (the reference's own bound between
  its two blends, tests/test_gs.py); the 256-pixel sums run in another
  order;
- build_qtree: leaves, counts and overflow equal;
- losses: within 1e-6 (SSIM's depthwise convolution sums in another
  order);
- render, dense and compact pairs: image within 1e-5, radii equal,
  parameter gradients within 1e-4 absolute and relative (XLA's einsum and
  dot sum the 3x3 products in its own order; the port in index order);
- one Adam step against optax's: the parameters within 1e-6 relative
  plus 1e-5 of the group's learning rate (same algebra; optax forms the
  bias correction 1 - 0.999^t in f32, whose cancellation moves its update
  by ~6e-6 of the step, where torch forms it in double);
- check_nodes on the same map: the ok mask equal, centres and scales
  within 1e-6;
- the container end to end, both packages' containers on the same maps
  (the port's RGB-D step, rebuilt for the reference through core.convert;
  the RGB-D step's own parity is tests/test_torch_pipeline.py's): the
  same Gaussian count after every frame;
  after frame 1 (6 Adam steps) 95 % of each parameter's elements within
  1e-5 and all within 2e-3: Adam's first steps move a parameter by about
  its learning rate whatever the gradient's size, so where a gradient is
  rounding noise (the scale and rotation of near-isotropic Gaussians) the
  two packages step apart by up to the learning rate; PSNR rising,
  optimize_final and save_ply running;
- the GS runner on a synthetic dataset with --device cpu.
The kernels themselves are held against the twins on the card only
(`gpu` marker; `python -m pytest --noconftest -m gpu
tests/test_torch_gs.py`).
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mrhash_tpu_torch.gs import blend as B
from mrhash_tpu_torch.gs import losses as L
from mrhash_tpu_torch.gs import rasterizer as R
from mrhash_tpu_torch.gs.model import GaussianModel, OptimizationParams
from mrhash_tpu_torch.gs.quadtree import build_qtree
from mrhash_tpu_torch.utils.profiler import COUNTS

NAMES = ("xyz", "scaling", "rotation", "opacity", "f_dc", "f_rest")


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the blend twins
# ---------------------------------------------------------------------------

def blend_inputs(seed, T, K, grid_x):
    """Per-tile attributes around each tile's own pixels, some large
    alphas to reach the 0.99 clamp, ~20 % invalid slots."""
    rng = np.random.default_rng(seed)
    tid = np.arange(T)
    origin = np.stack([(tid % grid_x) * 16, (tid // grid_x) * 16], -1)
    xy = origin[:, None, :] + rng.uniform(0, 16, (T, K, 2))
    a = rng.uniform(0.05, 0.6, (T, K))
    c = rng.uniform(0.05, 0.6, (T, K))
    b = rng.uniform(-0.1, 0.1, (T, K))
    op = rng.uniform(0.2, 1.2, (T, K))
    rgb = rng.uniform(0, 1, (T, K, 3))
    attr = np.concatenate([xy, np.stack([a, b, c, op], -1), rgb],
                          -1).astype(np.float32)
    valid = rng.uniform(0, 1, (T, K)) > 0.2
    pin = np.arange(256)
    pixf = np.stack([origin[:, 0:1] + pin % 16, origin[:, 1:2] + pin // 16],
                    -1).astype(np.float32)
    return attr, valid, pixf


def _port_blend(attr, valid, grid_x):
    a = torch.from_numpy(attr).requires_grad_()
    Tf, Cf, mask = B.BlendTiles.apply(a, torch.from_numpy(valid), grid_x)
    (torch.sum(Cf * Cf) + 2.0 * torch.sum(Tf)).backward()
    # the reference's i8 [T,K,256] layout, for the comparisons
    return Tf.detach().numpy(), Cf.detach().numpy(), \
        B.unpack_mask(mask).numpy(), a.grad.numpy()


def _jax_split(attr, valid):
    import jax.numpy as jnp
    return (jnp.asarray(attr[..., 0:2]), jnp.asarray(attr[..., 2:5]),
            jnp.asarray(attr[..., 5]), jnp.asarray(attr[..., 6:9]),
            jnp.asarray(valid, jnp.float32))


def _check_blend(port, ref_T, ref_C, ref_grads, ref_mask=None):
    Tf, Cf, mask, g = port
    np.testing.assert_allclose(Tf, ref_T, atol=1e-6, rtol=0)
    np.testing.assert_allclose(Cf, ref_C, atol=1e-6, rtol=0)
    if ref_mask is not None:
        np.testing.assert_array_equal(mask, ref_mask)
    for name, sl, ref in zip(("xy", "conic", "opac", "rgb"),
                             (slice(0, 2), slice(2, 5), 5, slice(6, 9)),
                             ref_grads):
        np.testing.assert_allclose(g[..., sl], _np(ref), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("K", [7, 16])
def test_blend_twins_match_xla(K):
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.gs import rasterizer as RJ

    T, grid_x = 11, 4
    attr, valid, pixf = blend_inputs(K, T, K, grid_x)
    xy, con, op, rgb, lv = _jax_split(attr, valid)
    pixf = jnp.asarray(pixf)

    def loss(xy, con, op, rgb):
        Tf, Cf = RJ.blend_tiles(xy, con, op, rgb, lv, pixf)
        return jnp.sum(Cf * Cf) + 2.0 * jnp.sum(Tf)

    (Tf, Cf), blended = RJ._blend_forward(xy, con, op, rgb, lv, pixf)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(xy, con, op, rgb)
    ref_mask = np.moveaxis(_np(blended), 0, 1).astype(np.int8)
    assert ref_mask.any() and not ref_mask.all()
    _check_blend(_port_blend(attr, valid, grid_x), _np(Tf), _np(Cf), grads,
                 ref_mask)


def test_blend_twins_match_pallas_interpret():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.gs import blend_pallas as BP

    T, K, grid_x = 11, 16, 4
    attr, valid, pixf = blend_inputs(3, T, K, grid_x)
    xy, con, op, rgb, lv = _jax_split(attr, valid)
    pixf = jnp.asarray(pixf)
    Tf, Cf, mask = BP.blend_forward_pallas(xy, con, op, rgb, lv, pixf,
                                           interpret=True)

    def loss(xy, con, op, rgb):
        Tf, Cf = BP.blend_tiles(True, xy, con, op, rgb, lv, pixf)
        return jnp.sum(Cf * Cf) + 2.0 * jnp.sum(Tf)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(xy, con, op, rgb)
    _check_blend(_port_blend(attr, valid, grid_x), _np(Tf), _np(Cf), grads,
                 _np(mask))


def test_blend_wrappers_check_operands():
    attr, valid, _ = blend_inputs(0, 3, 4, 2)
    a, v = torch.from_numpy(attr), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="attr"):
        B.blend_forward(a[..., :8].contiguous(), v, 2)
    with pytest.raises(ValueError, match="valid"):
        B.blend_forward(a, v.to(torch.uint8), 2)
    with pytest.raises(ValueError, match="contiguous"):
        B.blend_forward(a.transpose(0, 1).contiguous().transpose(0, 1), v, 2)
    Tf, Cf, mask = B.blend_forward(a, v, 2)
    with pytest.raises(ValueError, match="mask"):
        B.blend_backward(a, v, 2, Tf, mask.to(torch.uint8), Tf, Cf)
    with pytest.raises(ValueError, match="gC"):
        B.blend_backward(a, v, 2, Tf, mask, Tf, Cf[..., :2].contiguous())


def test_blend_backward_checks_valid_and_mask_alignment():
    """K5 takes K4's validity (it walks each tile from its last valid
    slot) and reads the mask words 16 bytes per access: both are checked
    before any launch, and the CPU path ignores valid."""
    attr, valid, _ = blend_inputs(0, 3, 4, 2)
    a, v = torch.from_numpy(attr), torch.from_numpy(valid)
    Tf, Cf, mask = B.blend_forward(a, v, 2)
    with pytest.raises(ValueError, match="valid"):
        B.blend_backward(a, v.to(torch.uint8), 2, Tf, mask, Tf, Cf)
    with pytest.raises(ValueError, match="valid"):
        B.blend_backward(a, v[:, :3].contiguous(), 2, Tf, mask, Tf, Cf)
    flat = torch.zeros(mask.numel() + 1, dtype=torch.int32)
    shifted = flat[1:].view(mask.shape)
    shifted.copy_(mask)
    with pytest.raises(ValueError, match="aligned"):
        B.blend_backward(a, v, 2, Tf, shifted, Tf, Cf)
    g = B.blend_backward(a, torch.zeros_like(v), 2, Tf, mask, Tf, Cf)
    torch.testing.assert_close(
        g, B.blend_backward_ref(a, 2, Tf, mask, Tf, Cf), atol=0, rtol=0)


def test_pack_unpack_mask_round_trip():
    """The bit-packed mask (bit i of word w is pixel 32 w + i) round-trips
    through the reference's i8 layout, bit 31 (an int32's sign bit)
    included: a word with only pixel 31 set is -2^31, a full word -1."""
    rng = np.random.default_rng(0)
    m = torch.from_numpy(rng.uniform(0, 1, (5, 7, 256)) < 0.5)
    m[0, 0] = False
    m[0, 0, 31] = True
    m[0, 1] = True
    m[1, 2, 32 * np.arange(8) + 31] = True
    words = B.pack_mask(m)
    assert words.dtype == torch.int32 and words.shape == (5, 7, 8)
    assert int(words[0, 0, 0]) == -2 ** 31 and int(words[0, 0, 1:].abs().sum()) == 0
    assert bool((words[0, 1] == -1).all())
    assert bool((words[1, 2] < 0).all())
    back = B.unpack_mask(words)
    assert back.dtype == torch.int8 and back.shape == m.shape
    assert torch.equal(back != 0, m)
    assert torch.equal(B.pack_mask(back), words)


@settings(max_examples=300, deadline=None, database=None)
@given(T=st.floats(min_value=float(np.float32(9.9e-5)),
                  max_value=float(np.float32(1.02e-4)), width=32),
       alpha=st.one_of(
           st.sampled_from([float(np.float32(1.0 / 255.0)), 0.99,
                            float(np.nextafter(np.float32(1.0 / 255.0),
                                               np.float32(1.0)))]),
           st.floats(min_value=float(np.float32(1.0 / 255.0)),
                     max_value=float(np.float32(0.99)), width=32)))
def test_k4_exit_condition_is_exact(T, alpha):
    """K4 leaves a warp's walk once fl(T * fl(1 - 1/255)) < 1e-4 holds for
    its pixels.  Then no alpha the gate admits (1/255 <= alpha <= 0.99)
    gives fl(T * fl(1 - alpha)) >= 1e-4, in f32 as the kernel and the
    twin compute it, so the pixel can never blend again."""
    T32, a32 = torch.tensor(T, dtype=torch.float32), torch.tensor(
        alpha, dtype=torch.float32)
    if not bool(a32 >= B.ALPHA_THRESHOLD) or not bool(a32 <= 0.99):
        return
    assert B.EXIT_FACTOR == float(np.float32(1.0) - np.float32(1.0 / 255.0))
    if bool(T32 * B.EXIT_FACTOR < B.ALPHA_MIN):
        assert bool(T32 * (1.0 - a32) < B.ALPHA_MIN)
    # the same in numpy's f32
    t, a = np.float32(T), np.float32(alpha)
    if t * np.float32(B.EXIT_FACTOR) < np.float32(B.ALPHA_MIN):
        assert t * (np.float32(1.0) - a) < np.float32(B.ALPHA_MIN)


def saturating_inputs(seed, T, K, grid_x):
    """blend_inputs with opacities near 0.99, and tile 1 made of flat
    Gaussians (conic 0: every pixel gets alpha = opacity) whose first two
    opacities put T into [1e-4, 1e-4 / fl(1 - 1/255)), where K4's exit
    condition holds for all its pixels (K >= 2)."""
    attr, valid, pixf = blend_inputs(seed, T, K, grid_x)
    rng = np.random.default_rng(seed + 1)
    attr[..., 5] = rng.uniform(0.9, 1.2, (T, K))
    valid[1] = True
    attr[1, :, 2:5] = 0.0
    attr[1, :, 5] = 0.99
    one = np.float32(1.0)
    t1 = one * (one - np.float32(0.99))
    for op in np.arange(0.98, 0.9905, 1e-6, dtype=np.float32):
        t2 = np.float32(t1 * (one - op))
        if t2 >= np.float32(1e-4) and (
                np.float32(t2 * np.float32(B.EXIT_FACTOR)) < np.float32(1e-4)):
            break
    else:
        raise AssertionError("no opacity puts T into the exit window")
    if K > 1:
        attr[1, 1, 5] = op
    return attr, valid, pixf


def test_twin_mask_is_silent_after_exit():
    """On opacities near 0.99, no pixel of the twin's mask blends after
    K4's exit condition first holds for it, so a warp that leaves its
    walk there loses no bit; tile 1's pixels all reach the condition
    after two steps."""
    T, K, grid_x = 8, 24, 4
    attr, valid, _ = saturating_inputs(2, T, K, grid_x)
    a, v = torch.from_numpy(attr), torch.from_numpy(valid)
    _, _, mask = B.blend_forward_ref(a, v, grid_x)
    steps = B.exit_steps(a, v, grid_x)
    bits = B.unpack_mask(mask) != 0                    # [T, K, 256]
    after = torch.arange(K)[None, :, None] >= steps[:, None, :]
    assert int((steps < K).sum()) >= 256
    assert bool((steps[1] == 2).all())
    assert not bool((bits & after).any())
    assert int(bits[1, :2].sum()) == 512 and not bool(bits[1, 2:].any())


# ---------------------------------------------------------------------------
# quad-tree, losses
# ---------------------------------------------------------------------------

def _qtree_cases():
    rng = np.random.default_rng(0)
    flat = np.full((64, 64, 3), 100, np.uint8)
    tex = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
    r = np.arange(48)[:, None, None]
    c = np.arange(80)[None, :, None]
    smooth = (127 + 60 * np.sin(c / 7.0 + r / 11.0 + np.arange(3))
              + rng.normal(0, 4, (48, 80, 3))).clip(0, 255).astype(np.uint8)
    return [(flat, 0.1, 1, 4096), (tex, 0.1, 1, 4096),
            (smooth, 3.0, 2, 8192), (tex, 0.1, 1, 64)]


def test_qtree_matches_reference():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.gs.quadtree import build_qtree as build_ref

    for img, thr, mps, cap in _qtree_cases():
        f = jax.jit(build_ref, static_argnums=(1, 2, 3))
        lj, vj, nj, oj = f(jnp.asarray(img), thr, mps, cap)
        lp, vp, n_p, op_ = build_qtree(torch.from_numpy(img), thr, mps, cap)
        assert (n_p, op_) == (int(nj), int(oj)), (thr, cap)
        np.testing.assert_array_equal(vp.numpy(), _np(vj))
        np.testing.assert_array_equal(lp.numpy(), _np(lj))
        if op_ == 0:      # leaves tile the image
            lv = lp.numpy()[:n_p]
            assert np.sum(lv[:, 2] * lv[:, 3]) == img.shape[0] * img.shape[1]


def test_losses_match_reference():
    import jax.numpy as jnp
    from mrhash_tpu.gs import losses as LJ

    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (3, 32, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for name in ("l1_loss", "l2_loss", "ssim", "psnr"):
        ref = float(getattr(LJ, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(L, name)(torch.from_numpy(a),
                                     torch.from_numpy(b)))
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (name, got, ref)
    assert float(L.ssim(torch.from_numpy(a), torch.from_numpy(a))) == \
        pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------

def scene_params(n, seed, sh_degree=3):
    """make_model-style scene (tests/test_gs.py:45-68): n Gaussians in
    front of the camera, 0.08 m isotropic scales perturbed per axis, and
    small rotation and SH-rest perturbations so that every parameter gets
    a gradient."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pos[:, 2] += 3.0
    cols = rng.integers(0, 255, (n, 3)).astype(np.float32)
    n_rest = (sh_degree + 1) ** 2 - 1
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    return dict(
        xyz=pos,
        scaling=(np.log(np.float32(0.08)) + 0.3 * rng.normal(0, 1, (n, 3))
                 ).astype(np.float32),
        rotation=(rot + 0.2 * rng.normal(0, 1, (n, 4))).astype(np.float32),
        opacity=rng.normal(0, 1, (n, 1)).astype(np.float32),
        f_dc=((cols / 255.0 - 0.5) / R.SH_C0)[:, None, :].astype(np.float32),
        f_rest=(0.05 * rng.normal(0, 1, (n, n_rest, 3))).astype(np.float32))


def cam_np(H=64, W=64, f=60.0, rot=None, t=None):
    return dict(rot_w2c=np.eye(3, dtype=np.float32) if rot is None else rot,
                t_w2c=np.zeros(3, np.float32) if t is None else t,
                fx=np.float32(f), fy=np.float32(f),
                cx=np.float32(W / 2 - 0.5), cy=np.float32(H / 2 - 0.5),
                W=W, H=H)


def cam_torch(c):
    return {k: (v if k in ("W", "H") else torch.as_tensor(v))
            for k, v in c.items()}


@pytest.mark.parametrize("pairs", ["dense", "compact"])
def test_render_matches_reference(pairs):
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.gs import rasterizer as RJ

    n, size = 96, 128
    params = scene_params(n, 3)
    th = 0.1
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    cam = cam_np(rot=rot, t=np.array([0.05, -0.02, 0.1], np.float32))
    gt = np.random.default_rng(9).uniform(0, 1, (3, 64, 64)).astype(
        np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    # the reference holds `size` rows of which the first n are live
    pj = {k: jnp.asarray(np.concatenate(
        [v, np.zeros((size - n,) + v.shape[1:], np.float32)])) for k, v in
        params.items()}
    active = jnp.arange(size) < n
    cj = {k: (v if k in ("W", "H") else jnp.asarray(v))
          for k, v in cam.items()}

    def loss_ref(p):
        img, radii = RJ.render(p, active, cj, jnp.asarray(bg), 3,
                               max_per_tile=32, blend_impl="xla",
                               pairs=pairs)
        return jnp.mean(jnp.abs(img - gt)), (img, radii)

    (_, (img_r, radii_r)), g_r = jax.jit(
        jax.value_and_grad(loss_ref, has_aux=True))(pj)

    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    img, radii, overflow = R.render(pt, cam_torch(cam), torch.from_numpy(bg),
                                    3, max_per_tile=32, pairs=pairs)
    L.l1_loss(img, torch.from_numpy(gt)).backward()

    assert int(overflow) == 0
    assert float(img.detach().max()) > 0.2
    np.testing.assert_allclose(img.detach().numpy(), _np(img_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(radii.detach().numpy(), _np(radii_r)[:n])
    for k in NAMES:
        gr = _np(g_r[k])[:n]
        assert np.abs(gr).sum() > 0, k
        np.testing.assert_allclose(pt[k].grad.numpy(), gr, atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_compact_pairs_report_overflow():
    """A pair cap below the pair count drops the tail and says how many."""
    params = {k: torch.from_numpy(v) for k, v in scene_params(40, 4).items()}
    attrs = R.preprocess(params, cam_torch(cam_np()), 3)
    _, _, _, ok, overflow = R._tile_pairs_compact(attrs, 4, 4, 16)
    dense_ok = R._tile_pairs(attrs, 4, 4)[3]
    total = int(dense_ok.sum())
    assert total > 16
    assert int(ok.sum()) == 16 and int(overflow) == total - 16


def test_sort_key_orders_ties_by_index():
    """Equal depths within a tile keep the Gaussians' index order, as the
    reference's stable (tile, depth) sort does."""
    tile = torch.tensor([2, 1, 2, 1, 2, 0], dtype=torch.int32)
    depth = torch.tensor([1.5, 3.0, 0.5, 3.0, 1.5, 9.0])
    ok = torch.tensor([True, True, True, True, True, False])
    _, order = torch.sort(R._depth_key(tile, depth, ok, 3), stable=True)
    assert order.tolist() == [1, 3, 2, 0, 4, 5]


# ---------------------------------------------------------------------------
# Adam, weights carried across
# ---------------------------------------------------------------------------

def test_adam_step_matches_optax():
    import jax
    import jax.numpy as jnp
    from mrhash_tpu.gs.model import GaussianModel as ModelJ
    from mrhash_tpu.gs.model import OptimizationParams as ParamsJ

    n = 50
    params = scene_params(n, 1)
    rng = np.random.default_rng(2)
    grads = [{k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]

    mj = ModelJ(ParamsJ(), capacity=n, initial_size=n)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = mj.tx.init(pj)

    def step_ref(p, s, g):
        up, s = mj.tx.update({k: jnp.asarray(v) for k, v in g.items()}, s, p)
        return jax.tree.map(lambda a, u: a + u, p, up), s

    p1, s1 = step_ref(pj, sj, grads[0])
    p2, s2 = step_ref(p1, s1, grads[1])

    m = GaussianModel(OptimizationParams(), capacity=n + 6)

    def step_port(g):
        m.optimizer.zero_grad(set_to_none=True)
        for k in NAMES:
            p = getattr(m, k)
            p.grad = torch.zeros_like(p)
            p.grad[:n] = torch.from_numpy(g[k])
        m.optimizer.step()

    def check(pref):
        for k in NAMES:
            got = getattr(m, k).detach().numpy()
            ref = _np(pref[k])
            lr = m.optimizer.param_groups[NAMES.index(k)]["lr"]
            err = np.abs(got[:n].astype(np.float64) - ref)
            assert np.all(err <= 1e-6 * np.abs(ref) + 1e-5 * lr), \
                (k, err.max())
            # rows past count: zero gradients, zero moments, no update
            assert np.array_equal(got[n:], rest[k]), k

    rest = {k: getattr(m, k).detach().numpy()[n:].copy() for k in NAMES}
    m.load_reference(params, n)
    step_port(grads[0])
    check(p1)

    # continue from the reference's state after step 1
    inner = s1.inner_states
    opt = {k: dict(mu=_np(inner[k].inner_state[0].mu[k]),
                   nu=_np(inner[k].inner_state[0].nu[k]),
                   count=int(inner[k].inner_state[0].count)) for k in NAMES}
    p1_np = {k: _np(v) for k, v in p1.items()}
    m.load_reference(p1_np, n, opt)
    step_port(grads[1])
    check(p2)
    assert m.count == n


def test_model_insert_and_save_ply(tmp_path):
    m = GaussianModel(OptimizationParams(), capacity=20)
    rng = np.random.default_rng(0)
    m.add_gaussians(rng.uniform(-1, 1, (16, 3)),
                    rng.integers(0, 255, (16, 3)), np.full(16, 0.05))
    assert m.count == 16
    np.testing.assert_allclose(m.scaling[:16].detach().numpy(),
                               np.log(np.float32(0.05)), rtol=1e-7)
    assert float(m.opacity[:16].detach().abs().max()) == 0.0
    assert torch.equal(m.rotation[:16, 0], torch.ones(16))
    m.add_gaussians(np.zeros((10, 3)), np.zeros((10, 3)), np.ones(10))
    assert m.count == 20           # capacity bound
    f = m.save_ply(str(tmp_path), 7)
    m.wait_ply()
    data = open(f, "rb").read()
    assert b"element vertex 20" in data and b"f_rest_44" in data


# ---------------------------------------------------------------------------
# seeding and the container end to end
# ---------------------------------------------------------------------------

ROWS, COLS = 48, 64


@pytest.fixture(scope="module")
def gs_params_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("gs") / "params.json"
    p.write_text(json.dumps(dict(
        sh_degree=1, position_lr=0.002, feature_lr=0.02, opacity_lr=0.05,
        scaling_lr=0.005, rotation_lr=0.001, lambda_dssim=0.2,
        qtree_thresh=0.002, qtree_min_pixel_size=2, kf_thresh=20,
        kf_iters=6, non_kf_iters=3, random_kf_num=1, global_iters=2,
        keep_all_frames=False, train_max_per_tile=32)))
    return str(p)


def _wall_frame():
    """A wall 2 m away, seen at 48x64 (fx = 40), with a smooth texture of
    the wall point (chip_smoke.py::texture_rgb) so that the quad tree splits
    it into a few hundred leaves."""
    depth = np.full((ROWS, COLS), 2.0, np.float32)
    y = (np.arange(ROWS, dtype=np.float32)[:, None] - ROWS / 2) / 20.0
    x = (np.arange(COLS, dtype=np.float32)[None, :] - COLS / 2) / 20.0
    rgb = np.stack(np.broadcast_arrays(
        0.5 + 0.45 * np.sin(2.1 * x) * np.cos(1.3 * y),
        0.5 + 0.45 * np.sin(1.7 * y + 0.8) * np.cos(4.6 + 0 * x),
        0.5 + 0.45 * np.sin(4.1 + 0 * x) * np.cos(1.9 * x)), -1)
    return depth, (rgb * 255.0).astype(np.uint8)


def _port_cfg_cam():
    from mrhash_tpu_torch.core.state import MapConfig
    from mrhash_tpu_torch.ops import camera as C
    cfg = MapConfig(virtual_voxel_size=0.05, sdf_truncation=0.15,
                    max_integration_distance=5.0, num_blocks=4096,
                    max_active_blocks=4096, max_alloc_per_frame=2048)
    cam = C.make_camera(40.0, 40.0, COLS / 2 - 0.5, ROWS / 2 - 0.5, ROWS,
                        COLS, 0.01, 5.0)
    return cfg, cam


def _reference_state(port_state):
    """The JAX MapState of a port map (core.convert's arrays; the
    reference rebuilds its presence cache)."""
    import jax.numpy as jnp
    from mrhash_tpu.core.state import MapState, VoxelPool
    from mrhash_tpu.ops import hashtable as HJ
    from mrhash_tpu_torch.core import convert

    a = convert.to_reference_arrays(port_state)
    t = a["table"]
    table = HJ.make_table(t["num_blocks"], t["num_buckets"]).replace(
        **{k: jnp.asarray(t[k]) for k in convert.TABLE_ARRAYS},
        high_count=jnp.int32(t["high_count"]),
        low_count=jnp.int32(t["low_count"]))
    return MapState(table=HJ.rebuild_pcache(table),
                    pool=VoxelPool(**{k: jnp.asarray(v)
                                      for k, v in a["pool"].items()}),
                    frame=jnp.int32(a["frame"]))


@pytest.fixture(scope="module")
def reference_run(gs_params_file):
    """3 frames of the wall: the port's map after each frame (the RGB-D
    path's own parity is tests/test_torch_pipeline.py's), and the JAX
    container run on the same maps: per-frame Gaussian counts and the
    parameters after frame 1."""
    import jax
    from mrhash_tpu.core.state import MapConfig as CfgJ
    from mrhash_tpu.gs.container import GaussianContainer as ContainerJ
    from mrhash_tpu.ops import camera as CJ
    from mrhash_tpu_torch.core import pipeline
    from mrhash_tpu_torch.core.state import make_state

    cfg, cam = _port_cfg_cam()
    cfg_j = CfgJ(virtual_voxel_size=0.05, sdf_truncation=0.15,
                 max_integration_distance=5.0, num_blocks=4096,
                 max_active_blocks=4096, max_alloc_per_frame=2048)
    cam_j = CJ.make_camera(fx=40.0, fy=40.0, cx=COLS / 2 - 0.5,
                           cy=ROWS / 2 - 0.5, rows=ROWS, cols=COLS,
                           min_depth=0.01, max_depth=5.0)
    depth, rgb = _wall_frame()
    state = make_state(cfg.num_blocks)
    gs = ContainerJ(gs_params_file, capacity=1 << 12, qtree_capacity=1 << 12)
    counts, states, params1 = [], [], None
    for i in range(3):
        state, _ = pipeline.integrate_rgbd(cfg, state, cam,
                                           torch.from_numpy(depth),
                                           torch.from_numpy(rgb))
        states.append(_reference_state(state))
        gs.run_gs(cfg_j, cam_j, states[-1], rgb, depth)
        counts.append(gs.model.count)
        if i == 0:
            params1 = {k: _np(jax.device_get(v))
                       for k, v in gs.model.params.items()}
    return dict(counts=counts, states=states, params1=params1, cfg_j=cfg_j,
                cam_j=cam_j)


def test_check_nodes_matches_reference(reference_run):
    import jax.numpy as jnp
    from mrhash_tpu.gs.container import check_nodes as check_ref
    from mrhash_tpu_torch.core import convert
    from mrhash_tpu_torch.gs.container import check_nodes

    cfg, cam = _port_cfg_cam()
    cfg_j, cam_j = reference_run["cfg_j"], reference_run["cam_j"]
    depth, rgb = _wall_frame()
    depth = depth.copy()
    depth[:, :6] = 0.0                  # below min_depth
    leaves, lvalid, _, _ = build_qtree(torch.from_numpy(rgb), 0.002, 2, 1024)
    leaves_j, lvalid_j = jnp.asarray(leaves.numpy()), jnp.asarray(
        lvalid.numpy())
    for i, want_some in ((0, True), (1, False)):
        st = reference_run["states"][i]
        ref = check_ref(cfg_j, st.table, st.pool, cam_j, leaves_j, lvalid_j,
                        jnp.asarray(depth), jnp.asarray(rgb))
        port_state = convert.from_reference(st)
        got = check_nodes(cfg, port_state.table, port_state.pool, cam,
                          leaves, lvalid, torch.from_numpy(depth),
                          torch.from_numpy(rgb))
        ok = got[3].numpy()
        np.testing.assert_array_equal(ok, _np(ref[3]))
        assert ok.any() == want_some     # weight 2 after frame 2: none
        np.testing.assert_allclose(got[0].numpy()[ok], _np(ref[0])[ok],
                                   atol=1e-6)
        np.testing.assert_allclose(got[2].numpy()[ok], _np(ref[2])[ok],
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[1].numpy()[ok], _np(ref[1])[ok])


def test_container_matches_reference(reference_run, gs_params_file,
                                     tmp_path):
    from mrhash_tpu_torch.core import convert
    from mrhash_tpu_torch.gs.container import GaussianContainer

    cfg, cam = _port_cfg_cam()
    depth, rgb = _wall_frame()
    gs = GaussianContainer(gs_params_file, capacity=1 << 12,
                           qtree_capacity=1 << 12)
    gt = torch.from_numpy(rgb).to(torch.float32).permute(2, 0, 1) / 255.0
    psnr = []
    for i, st in enumerate(reference_run["states"]):
        state = convert.from_reference(st)
        gs.run_gs(cfg, cam, state, torch.from_numpy(rgb),
                  torch.from_numpy(depth))
        assert gs.model.count == reference_run["counts"][i], i
        if i == 0:
            assert gs.model.count > 0
            for k, v in gs.model.params().items():
                d = np.abs(v.detach().numpy()
                           - reference_run["params1"][k][:gs.model.count])
                assert np.quantile(d, 0.95) <= 1e-5 and d.max() <= 2e-3, \
                    (k, np.quantile(d, 0.95), d.max())
        psnr.append(float(L.psnr(gs.render_view(cam), gt)))
    assert psnr[-1] > psnr[0] and psnr[-1] > 10.0, psnr
    assert len(gs.keyframes) == (reference_run["counts"][0] > 20)

    gs.optimize_final()
    assert np.isfinite(float(L.psnr(gs.render_view(cam), gt)))
    out = gs.save_ply(str(tmp_path), 5, blocking=True)
    assert b"element vertex" in open(out, "rb").read(200)


def test_rgbd_gs_runner_cpu(tmp_path, monkeypatch, gs_params_file):
    from PIL import Image

    data = tmp_path / "replica_like"
    (data / "results").mkdir(parents=True)
    depth, rgb = _wall_frame()
    poses = []
    for i in range(3):
        Image.fromarray((depth * 6553.5).astype(np.uint16)).save(
            data / "results" / f"depth{i:06d}.png")
        Image.fromarray(rgb).save(data / "results" / f"frame{i:06d}.jpg")
        pose = np.eye(4)
        pose[0, 3] = 0.02 * i
        poses.append(pose.reshape(-1))
    np.savetxt(data / "traj.txt", np.asarray(poses), delimiter=" ")
    out = tmp_path / "results"
    cfg = tmp_path / "wall.cfg"
    cfg.write_text(f"""
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
    max_depth : 5.0
    intrinsics: [40.0, 40.0, {COLS / 2 - 0.5}, {ROWS / 2 - 0.5}]
    resolution: [{COLS}, {ROWS}]
    depth_scaling: 6553.5
    hz: 30
data_path: {data}
results_path: {out}
gs_optimization_param_path: {gs_params_file}
end_frame: -1
""")
    monkeypatch.chdir(tmp_path)     # the profiler writes to the cwd
    monkeypatch.setattr("sys.argv", ["rgbd_gs_runner", str(cfg),
                                     "--device", "cpu"])
    from mrhash_tpu_torch.apps import rgbd_gs_runner
    rgbd_gs_runner.run()
    plys = list(out.glob("point_cloud_*.ply"))
    assert [p.name for p in plys] == ["point_cloud_3.ply"]
    head = open(plys[0], "rb").read(300)
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    assert n > 0
    assert list(out.glob("mesh_*.ply"))


# ---------------------------------------------------------------------------
# on the card: K4 and K5 against their twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 7, 64, 128])
def test_kernels_match_twins_on_card(cuda, K):
    T, grid_x = 75, 15
    attr, valid, _ = blend_inputs(K, T, K, grid_x)
    a = torch.from_numpy(attr).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    n4, n5 = COUNTS["blend_forward"], COUNTS["blend_backward"]
    Tk, Ck, mk = B.blend_forward(a, v, grid_x)
    Tt, Ct, mt = B.blend_forward_ref(a, v, grid_x)
    rng = np.random.default_rng(1)
    gT = torch.from_numpy(rng.normal(0, 1, (T, 256)).astype(
        np.float32)).to(cuda)
    gC = torch.from_numpy(rng.normal(0, 1, (T, 256, 3)).astype(
        np.float32)).to(cuda)
    gk = B.blend_backward(a, v, grid_x, Tk, mk, gT, gC)
    gt = B.blend_backward_ref(a, grid_x, Tk, mk, gT, gC)
    torch.cuda.synchronize()
    assert COUNTS["blend_forward"] == n4 + 1
    assert COUNTS["blend_backward"] == n5 + 1
    assert torch.equal(mk, mt)
    torch.testing.assert_close(Tk, Tt, atol=1e-6, rtol=0)
    torch.testing.assert_close(Ck, Ct, atol=1e-6, rtol=0)
    torch.testing.assert_close(gk, gt, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 7, 64, 128])
def test_k5_walk_bounds_and_idle_warps_on_card(cuda, K):
    """K5's walk starts at each tile's last valid slot and skips the steps
    in which a warp blended nothing: on prefix validity (the rasterizer's)
    with random counts, a tile with no valid slot and a tile whose
    Gaussians stay in its top rows, so that warps 3-7 never blend, the
    gradients equal the twin's within its bound and the rows past a
    tile's count are zero."""
    T, grid_x = 30, 6
    attr, _, _ = blend_inputs(K + 100, T, K, grid_x)
    rng = np.random.default_rng(K)
    count = rng.integers(0, K + 1, T)
    count[0], count[1] = 0, K
    valid = np.arange(K)[None, :] < count[:, None]
    attr[1, :, 1] = rng.uniform(0, 3, K)     # tile 1: rows 0-2 only
    attr[1, :, 4] = 2.0                      # tight in y
    a = torch.from_numpy(attr).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    Tk, _, mk = B.blend_forward(a, v, grid_x)
    gT = torch.from_numpy(rng.normal(0, 1, (T, 256)).astype(
        np.float32)).to(cuda)
    gC = torch.from_numpy(rng.normal(0, 1, (T, 256, 3)).astype(
        np.float32)).to(cuda)
    gk = B.blend_backward(a, v, grid_x, Tk, mk, gT, gC)
    gt = B.blend_backward_ref(a, grid_x, Tk, mk, gT, gC)
    torch.cuda.synchronize()
    bits = B.unpack_mask(mk)
    assert int(bits[1].sum()) > 0 and int(bits[1, :, 96:].sum()) == 0
    torch.testing.assert_close(gk, gt, atol=1e-4, rtol=1e-4)
    past = ~torch.from_numpy(valid).to(cuda)
    assert torch.equal(gk[past], torch.zeros_like(gk[past]))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 7, 64, 128])
def test_k4_exit_and_empty_tiles_on_card(cuda, K):
    """K4 against its twin where warps leave their walk early (opacities
    near 0.99, and tile 1's pixels all reach the exit condition after two
    steps) and where tiles have no valid slot or a prefix of them: the
    mask words equal, Tfin and Cfin within 1e-6, words past each tile's
    last valid slot zero; K5 on that mask within its bound."""
    T, grid_x = 40, 8
    attr, valid, _ = saturating_inputs(K + 7, T, K, grid_x)
    rng = np.random.default_rng(K)
    count = rng.integers(0, K + 1, T)
    count[0], count[1], count[2] = 0, K, 0
    valid[2:] = np.arange(K)[None, :] < count[2:, None]
    valid[0] = False
    a = torch.from_numpy(attr).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    Tk, Ck, mk = B.blend_forward(a, v, grid_x)
    Tt, Ct, mt = B.blend_forward_ref(a, v, grid_x)
    steps = B.exit_steps(a, v, grid_x)
    gT = torch.from_numpy(rng.normal(0, 1, (T, 256)).astype(
        np.float32)).to(cuda)
    gC = torch.from_numpy(rng.normal(0, 1, (T, 256, 3)).astype(
        np.float32)).to(cuda)
    gk = B.blend_backward(a, v, grid_x, Tk, mk, gT, gC)
    gt = B.blend_backward_ref(a, grid_x, Tk, mk, gT, gC)
    torch.cuda.synchronize()
    if K >= 2:
        assert bool((steps[1] == 2).all())
    assert torch.equal(mk, mt)
    torch.testing.assert_close(Tk, Tt, atol=1e-6, rtol=0)
    torch.testing.assert_close(Ck, Ct, atol=1e-6, rtol=0)
    past = ~torch.from_numpy(np.cumsum(valid[:, ::-1], 1)[:, ::-1] > 0).to(
        cuda)
    assert int(mk[past].abs().sum()) == 0
    assert int(mk[0].abs().sum()) == 0 and bool((Tk[0] == 1).all())
    torch.testing.assert_close(gk, gt, atol=1e-4, rtol=1e-4)
