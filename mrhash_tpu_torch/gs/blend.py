"""Kernels K4 and K5: the tile blend of the Gaussian rasterizer, forward
and backward, joined by one autograd Function.

Counterpart of mrhash_tpu/gs/blend_pallas.py (the Pallas kernels
`_fwd_kernel` and `_bwd_kernel`) and of the XLA scan it mirrors
(mrhash_tpu/gs/rasterizer.py::_blend_forward, ::_blend_bwd).  The CUDA
source is csrc/blend_tiles.cu; its header comment gives the design.  In
short, one CTA per 16x16 tile walks the tile's depth-sorted Gaussians up
to its last valid slot: K4 front to back with two pixels per thread (one
column, 8 rows apart), writing the final transmittance, the colour and a
bit-packed mask of the blended steps (one word per step and 32 pixels, a
warp's ballot), and leaving a warp's walk once none of its pixels can
blend again (exact, PORT_NOTES.md P44); K5 back to front, one pixel per
thread, recovering each step's transmittance from the final one and the
mask, and reducing per-(tile, k) gradients over the tile's pixels.  K5
skips a step for a warp that blended none of its pixels there (exact: the
step changes nothing and adds zeros) and sums the 9 gradients of a warp
with a 12-shuffle transpose butterfly; its sums over the 256 pixels are
taken in another order than the twin's (P42).

Layouts are tile-major: attributes f32[T,K,9] (x, y, conic a/b/c,
opacity, r, g, b), validity bool[T,K], the mask i32[T,K,8] (bit i of word
w of row (t, k) is pixel 32 w + i; `pack_mask` and `unpack_mask` convert
from and to the reference's i8[T,K,256]); tile t covers the pixels
x = (t % grid_x) * 16 + p % 16, y = (t // grid_x) * 16 + p // 16.

Bound on the card: f32 operations (~30 per pixel and valid step forward,
~70 backward); the bytes (attributes, 32 B of mask per (tile, k), T and
C) take less; see the source.

`blend_forward` and `blend_backward` take their plain PyTorch twins
(`blend_forward_ref`, `blend_backward_ref`, K-step loops over [T,256]
tensors in the reference's order) for CPU tensors, the kernels for CUDA
tensors, and raise for any other device (cuda_lib.on_card).  Each
launch counts in utils/profiler.COUNTS under the kernel's name
("blend_forward", "blend_backward").
"""
from __future__ import annotations

import torch

from mrhash_tpu_torch.ops import cuda_lib
from mrhash_tpu_torch.utils.profiler import COUNTS

BLOCK = 16
PIX = BLOCK * BLOCK
N_ATTR = 9
ALPHA_THRESHOLD = 1.0 / 255.0
ALPHA_MIN = 1e-4
WORDS = PIX // 32               # mask words per (tile, k): one per warp
# fl(1 - fl(1/255)) in f32: a pixel whose fl(T * EXIT_FACTOR) < ALPHA_MIN
# can never blend again (K4's early exit)
EXIT_FACTOR = float(torch.tensor(1.0) - torch.tensor(ALPHA_THRESHOLD))


def pixel_coords(n_tiles, grid_x, device):
    """(px, py) f32[T,256]: the pixel centres of each tile."""
    tid = torch.arange(n_tiles, device=device)[:, None]
    pin = torch.arange(PIX, device=device)[None, :]
    px = (tid % grid_x) * BLOCK + pin % BLOCK
    py = (tid // grid_x) * BLOCK + pin // BLOCK
    return px.to(torch.float32), py.to(torch.float32)


def _alpha_terms(a, px, py):
    """Falloff and alpha of step k for every pixel (forward.cu:300-318);
    a: f32[T,9] attribute rows of the step.  Same order as the kernels."""
    dx = a[:, 0:1] - px
    dy = a[:, 1:2] - py
    power = (-0.5 * a[:, 2:3] * dx * dx - 0.5 * a[:, 4:5] * dy * dy
             - a[:, 3:4] * dx * dy)
    e = torch.exp(power)
    alpha = torch.clamp(a[:, 5:6] * e, max=0.99)
    return dx, dy, power, e, alpha


def pack_mask(blended):
    """bool or int [..., 256] blended pixels -> i32 [..., 8] words: bit i
    of word w is pixel 32 w + i (K4's ballot words)."""
    bits = (blended != 0).reshape(*blended.shape[:-1], WORDS, 32)
    shift = torch.arange(32, dtype=torch.int64, device=blended.device)
    words = (bits.to(torch.int64) << shift).sum(-1)
    # bit 31 is the sign bit of an int32: wrap in int64 before the cast
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_mask(words):
    """i32 [..., 8] mask words -> i8 [..., 256] blended pixels (0 or 1),
    the reference's layout."""
    shift = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shift) & 1
    return bits.reshape(*words.shape[:-1], PIX).to(torch.int8)


def _forward_steps(attr, valid, grid_x):
    """The front-to-back walk of the twin (forward.cu:249-356), step by
    step: yields (k, blended bool[T,256], T, C) after each step k."""
    n_tiles, K = valid.shape
    px, py = pixel_coords(n_tiles, grid_x, attr.device)
    T = torch.ones((n_tiles, PIX), dtype=torch.float32, device=attr.device)
    C = torch.zeros((n_tiles, PIX, 3), dtype=torch.float32,
                    device=attr.device)
    for k in range(K):
        a = attr[:, k]
        _, _, power, _, alpha = _alpha_terms(a, px, py)
        use = (valid[:, k:k + 1] & (power <= 0.0)
               & (alpha >= ALPHA_THRESHOLD) & (T >= ALPHA_MIN))
        test_T = T * (1.0 - alpha)
        # a Gaussian that would push T below ALPHA_MIN is not blended
        blended = use & (test_T >= ALPHA_MIN)
        w = torch.where(blended, alpha * T, 0.0)
        C = C + w[..., None] * a[:, None, 6:9]
        T = torch.where(blended, test_T, T)
        yield k, blended, T, C


def blend_forward_ref(attr, valid, grid_x):
    """Plain twin of K4: front-to-back compositing over every step.
    Returns (Tfin f32[T,256], Cfin f32[T,256,3], mask i32[T,K,8])."""
    n_tiles, K = valid.shape
    T = torch.ones((n_tiles, PIX), dtype=torch.float32, device=attr.device)
    C = torch.zeros((n_tiles, PIX, 3), dtype=torch.float32,
                    device=attr.device)
    mask = torch.empty((n_tiles, K, WORDS), dtype=torch.int32,
                       device=attr.device)
    for k, blended, T, C in _forward_steps(attr, valid, grid_x):
        mask[:, k] = pack_mask(blended)
    return T, C, mask


def exit_steps(attr, valid, grid_x):
    """i64[T,256]: for each pixel, the number of steps after which K4's
    exit condition fl(T * EXIT_FACTOR) < ALPHA_MIN first holds (K where
    it never does).  From then on the pixel blends nothing.  A warp of
    K4 (pixels 32 w + i and 128 + 32 w + i) walks min(count, the largest
    of its 64 pixels' steps) steps, count being the tile's last valid
    slot + 1."""
    n_tiles, K = valid.shape
    out = torch.full((n_tiles, PIX), K, dtype=torch.int64,
                     device=attr.device)
    for k, _, T, _ in _forward_steps(attr, valid, grid_x):
        done = (T * EXIT_FACTOR < ALPHA_MIN) & (out == K)
        out = torch.where(done, k + 1, out)
    return out


def blend_backward_ref(attr, grid_x, Tfin, mask, gT, gC):
    """Plain twin of K5: the back-to-front re-walk (backward.cu:386-594)
    that recovers T before each blended step as T_after / (1 - alpha).
    Returns the gradient of attr, f32[T,K,9]."""
    n_tiles, K = mask.shape[:2]
    px, py = pixel_coords(n_tiles, grid_x, attr.device)
    blended = unpack_mask(mask) != 0
    gr, gg, gb = gC[..., 0], gC[..., 1], gC[..., 2]
    T_after = Tfin
    S = torch.zeros((n_tiles, PIX, 3), dtype=torch.float32,
                    device=attr.device)
    out = torch.empty((n_tiles, K, N_ATTR), dtype=torch.float32,
                      device=attr.device)
    for k in range(K - 1, -1, -1):
        a = attr[:, k]
        dx, dy, _, e, alpha = _alpha_terms(a, px, py)
        b = blended[:, k]
        one_m = torch.where(b, 1.0 - alpha, 1.0)
        T_before = T_after / one_m
        w = torch.where(b, alpha * T_before, 0.0)

        gdot_rgb = gr * a[:, 6:7] + gg * a[:, 7:8] + gb * a[:, 8:9]
        gdot_S = gr * S[..., 0] + gg * S[..., 1] + gb * S[..., 2]
        d_alpha = torch.where(
            b, gdot_rgb * T_before - (gdot_S + gT * Tfin) / one_m, 0.0)
        # alpha = min(0.99, opacity * e^power): clamped pixels get no grad
        live = (a[:, 5:6] * e) < 0.99
        d_op = torch.where(live, d_alpha * e, 0.0)
        d_power = torch.where(live, d_alpha * alpha, 0.0)

        out[:, k] = torch.stack([
            (d_power * (-a[:, 2:3] * dx - a[:, 3:4] * dy)).sum(1),
            (d_power * (-a[:, 4:5] * dy - a[:, 3:4] * dx)).sum(1),
            (d_power * (-0.5 * dx * dx)).sum(1),
            (d_power * (-dx * dy)).sum(1),
            (d_power * (-0.5 * dy * dy)).sum(1),
            d_op.sum(1),
            (gr * w).sum(1), (gg * w).sum(1), (gb * w).sum(1)], dim=1)

        S = S + w[..., None] * a[:, None, 6:9]
        T_after = T_before
    return out


def blend_forward(attr, valid, grid_x: int):
    """K4 wrapper.  attr f32[T,K,9]; valid bool[T,K]; grid_x tiles per
    image row.  Returns (Tfin f32[T,256], Cfin f32[T,256,3], mask
    i32[T,K,8])."""
    dev = attr.device
    card = cuda_lib.on_card(dev)
    n_tiles, K = valid.shape
    cuda_lib.expect(attr, "attr", torch.float32, (n_tiles, K, N_ATTR), dev)
    cuda_lib.expect(valid, "valid", torch.bool, (n_tiles, K), dev)
    if grid_x < 1:
        raise ValueError(f"grid_x: {grid_x}, expected >= 1")
    if not card:
        return blend_forward_ref(attr, valid, grid_x)
    return _launch_forward(attr, valid, grid_x)


def _launch_forward(attr, valid, grid_x):
    dev = attr.device
    n_tiles, K = valid.shape
    tfin = torch.empty((n_tiles, PIX), dtype=torch.float32, device=dev)
    cfin = torch.empty((n_tiles, PIX, 3), dtype=torch.float32, device=dev)
    mask = torch.empty((n_tiles, K, WORDS), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_blend_forward(p(attr), p(valid), n_tiles, K, grid_x,
                                      p(tfin), p(cfin), p(mask),
                                      cuda_lib.stream_of(attr))
    cuda_lib.check(rc, "blend_forward")
    COUNTS["blend_forward"] += 1
    return tfin, cfin, mask


def blend_backward(attr, valid, grid_x: int, Tfin, mask, gT, gC):
    """K5 wrapper.  attr f32[T,K,9] and valid bool[T,K] as given to K4;
    Tfin f32[T,256] and mask i32[T,K,8] from K4; gT f32[T,256], gC
    f32[T,256,3] the cotangents of Tfin and Cfin.  Returns the gradient of
    attr, f32[T,K,9].  The kernel walks each tile from its last valid slot
    (K4 blends no invalid one); the twin needs only the mask."""
    dev = attr.device
    card = cuda_lib.on_card(dev)
    n_tiles, K = mask.shape[:2]
    e = cuda_lib.expect
    e(attr, "attr", torch.float32, (n_tiles, K, N_ATTR), dev)
    e(valid, "valid", torch.bool, (n_tiles, K), dev)
    e(mask, "mask", torch.int32, (n_tiles, K, WORDS), dev)
    e(Tfin, "Tfin", torch.float32, (n_tiles, PIX), dev)
    e(gT, "gT", torch.float32, (n_tiles, PIX), dev)
    e(gC, "gC", torch.float32, (n_tiles, PIX, 3), dev)
    if grid_x < 1:
        raise ValueError(f"grid_x: {grid_x}, expected >= 1")
    if mask.data_ptr() % 16:
        raise ValueError("mask: not 16-byte aligned (the kernel reads 16 B "
                         "per access)")
    if not card:
        return blend_backward_ref(attr, grid_x, Tfin, mask, gT, gC)
    return _launch_backward(attr, valid, grid_x, Tfin, mask, gT, gC)


def _launch_backward(attr, valid, grid_x, Tfin, mask, gT, gC):
    dev = attr.device
    n_tiles, K = mask.shape[:2]
    gout = torch.empty((n_tiles, K, N_ATTR), dtype=torch.float32, device=dev)
    lib = cuda_lib.library()
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        rc = lib.mrhash_blend_backward(p(attr), p(valid), n_tiles, K, grid_x,
                                       p(Tfin), p(mask), p(gT), p(gC),
                                       p(gout), cuda_lib.stream_of(attr))
    cuda_lib.check(rc, "blend_backward")
    COUNTS["blend_backward"] += 1
    return gout


class BlendTiles(torch.autograd.Function):
    """Differentiable tile compositing with an O(1)-state backward: the
    residuals are the inputs, the final T and the bit-packed mask (13 MB
    at 1200x680 and K = 128), never the per-step (T, C) of the walk."""

    @staticmethod
    def forward(ctx, attr, valid, grid_x):
        Tfin, Cfin, mask = blend_forward(attr, valid, grid_x)
        ctx.save_for_backward(attr, valid, Tfin, mask)
        ctx.grid_x = grid_x
        ctx.mark_non_differentiable(mask)
        return Tfin, Cfin, mask

    @staticmethod
    def backward(ctx, gT, gC, _gmask):
        attr, valid, Tfin, mask = ctx.saved_tensors
        gT = torch.zeros_like(Tfin) if gT is None else gT.contiguous()
        gC = (torch.zeros((*Tfin.shape, 3), dtype=Tfin.dtype,
                          device=Tfin.device)
              if gC is None else gC.contiguous())
        g = blend_backward(attr, valid, ctx.grid_x, Tfin, mask, gT, gC)
        return g, None, None


def blend_tiles(attr, valid, grid_x: int):
    """(Tfin f32[T,256], Cfin f32[T,256,3]), differentiable w.r.t. attr."""
    Tfin, Cfin, _ = BlendTiles.apply(attr, valid, grid_x)
    return Tfin, Cfin
